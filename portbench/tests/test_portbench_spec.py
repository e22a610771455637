"""The benchmark's definition: every cell's files found by name, names and
units within the contract's characters, the work counted from the layer
shapes, and no JAX in what a run loads.

    python -m pytest portbench/tests -q
"""
import json
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.configs import resnet, resnet_ref

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def config(name):
    c = next(c for c in SPEC["configs"] if c["name"] == name)
    with open(harness.CHECKOUT / c["file"]) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.cell(SPEC, cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
    assert set(c.readers) == names | {m["name"] for m in c.per_layer}
    assert c.family.__name__ == f"portbench.configs.{c.cfg['family']}"
    assert c.generator.__name__ == \
        f"portbench.generators.{c.traffic['generator']}"


@pytest.mark.parametrize("broken", ["workload", "config", "traffic",
                                    "metric", "family", "generator"])
def test_a_name_it_cannot_find_is_refused(broken, monkeypatch, tmp_path):
    spec = json.loads(json.dumps(SPEC))
    w = spec["workloads"][0]
    name = w["name"]
    if broken == "workload":
        name = "no-such-cell"
    elif broken == "config":
        w["config"] = "no-such-config"
    elif broken == "traffic":
        w["traffic"] = "no-such-traffic"
    elif broken == "metric":
        spec["per_layer"].append({**spec["per_layer"][0],
                                  "name": "no_such_metric",
                                  "workloads": [name]})
    elif broken == "family":
        conf = next(c for c in spec["configs"] if c["name"] == w["config"])
        with open(harness.CHECKOUT / conf["file"]) as f:
            cfg = {**json.load(f), "family": "no_such_family"}
        (tmp_path / "c.json").write_text(json.dumps(cfg))
        conf["file"] = str(tmp_path / "c.json")
    else:
        with open(harness.ROOT / "traffic" / f"{w['traffic']}.json") as f:
            traffic = {**json.load(f), "generator": "no_such_generator"}
        (tmp_path / "traffic").mkdir()
        (tmp_path / "traffic" / "t.json").write_text(json.dumps(traffic))
        w["traffic"] = "t"
        monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(KeyError):
        harness.cell(spec, name)


def test_names_units_and_keys_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert NAME.match(x["name"]) and 1 <= len(x["why"]) <= 200
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for group in (metrics, SPEC["configs"], SPEC["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cfg, macs", [("resnet18-int8-224", 1.814e9),
                                       ("resnet50-int8-fuseall-224", 4.089e9)])
def test_work_matches_the_published_multiply_adds(cfg, macs):
    w = resnet.work(config(cfg), 1)
    assert abs((w["int8_ops"] + w["bf16_ops"]) / 2 - macs) < 0.01 * macs


def test_fused_stages_and_routes_follow_the_program_gates():
    r18, r50 = config("resnet18-int8-224"), config("resnet50-int8-fuseall-224")
    w18 = resnet.work(r18, 64)
    assert w18["stagen"] is None and w18["stage64"][0] > 0
    rt = resnet_ref.routes(r18, 224, 64)
    assert rt["layer1.1.conv2"][0] == "stage64"
    assert rt["layer2.0.conv1"][0] == rt["layer2.0.down"][0] == "float"
    assert rt["layer2.0.conv2"][0] == rt["layer4.1.conv1"][0] == "s8"
    b64, b1 = (resnet_ref.routes(r50, 224, b) for b in (64, 1))
    assert b64["layer2.3.conv3"][0] == "stagen"
    assert b64["layer3.0.conv1"][0] == "w8a8" and b1["layer3.0.conv1"][0] \
        == "float"
    assert b64["layer4.2.conv3"][0] == "float"


def test_no_jax_in_a_run_and_no_port_in_the_reference():
    code = ("import sys; import portbench.harness, portbench.run, "
            "portbench.control; "
            "from portbench.harness import cell, load_spec, forbidden_modules;"
            " [cell(load_spec(), w['name']) for w in load_spec()['workloads']];"
            " import planer_tpu_torch; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; import portbench.configs.resnet_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'planer_tpu_torch', 'planer_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"
