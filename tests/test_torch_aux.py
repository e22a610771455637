"""The port's auxiliary modules, case by case against tests/test_aux.py:
the profiler (cost report, op histogram, trace scopes), the executor's
per-op timer, ``Config``, the DOT plot, the zoo (on ``tmp_path`` and
``file://`` URLs, no network) and the real-weight hook."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.runtime import profiler as jprof
from planer_tpu.utils import config as jconfig
from planer_tpu.utils import plot as jplot
from planer_tpu.utils import zoo as jzoo

import planer_tpu_torch as pt
from planer_tpu_torch import Config, get_config, models, set_config
from planer_tpu_torch.models import eval as ev
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.runtime import profiler
from planer_tpu_torch.utils import zoo
from planer_tpu_torch.utils.plot import plot_net, to_dot


def _x(side=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, 3, side, side)).astype(np.float32)


def test_cost_report():
    """The roofline report on the H100's data-sheet peaks, from the
    program's count (its ratio to XLA's: test_torch_net_api.py)."""
    net = models.resnet18(num_classes=8, device="cpu")
    rep = profiler.cost_report(net, _x(), chip="h100")
    ca = net.cost_analysis(_x())
    assert rep["flops"] == ca["flops"] > 1e6
    assert rep["bytes_accessed"] == ca["bytes accessed"]
    assert rep["bound"] in ("compute", "memory")
    assert rep["peak_flops"] == 989e12 and rep["peak_bandwidth"] == 3.35e12
    assert rep["ideal_time_s"] == max(rep["flops"] / 989e12,
                                      rep["bytes_accessed"] / 3.35e12) > 0
    assert set(rep) == set(jprof.cost_report(jm.resnet18(num_classes=8),
                                             _x()))
    with pytest.raises(ValueError, match="unknown chip"):
        profiler.cost_report(net, _x(), chip="v5e")


def test_op_histogram():
    net = models.resnet18(num_classes=8, device="cpu")
    h = profiler.op_histogram(net.graph)
    assert h == jprof.op_histogram(jm.resnet18(num_classes=8).graph)
    assert h["conv"] == 20 and h["relu"] > 0 and h["dense"] == 1


def test_interpreter_timer():
    net = models.resnet18(num_classes=8, device="cpu")
    net.timeit("start")
    net.forward(_x(), engine="numpy")
    assert "conv" in net.timer and net.timer["conv"] > 0


def test_trace_scopes_layer_names_only_while_tracing(tmp_path, monkeypatch):
    """Inside ``trace`` the program runs each op under its IR layer name;
    outside it enters no ``record_function``.  Neither moves a kernel
    counter."""
    net = models.resnet18(num_classes=8, device="cpu")
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    st.LAUNCHES.clear()
    net(_x())
    assert entered == [] and not profiler.TRACING
    with profiler.trace(str(tmp_path)) as prof:
        net(_x())
    assert not profiler.TRACING
    names = {e.name for e in prof.events()}
    assert {"stem", "layer2.0.conv1", "fc"} <= names
    assert "layer2.0.conv1" in entered
    assert os.path.exists(tmp_path / "trace.json")
    assert not st.LAUNCHES


def test_config_env_override(monkeypatch):
    monkeypatch.setenv("PLANER_TILE_WINDOW", "256")
    monkeypatch.setenv("PLANER_SERVE_BUCKETS", "1,4,16")
    cfg = Config.from_env()
    assert cfg.tile_window == 256
    assert cfg.serve_buckets == (1, 4, 16)
    assert vars(cfg) == vars(jconfig.Config.from_env())
    prev = get_config()
    try:
        set_config(cfg)
        assert get_config().tile_window == 256
    finally:
        set_config(prev)


def test_config_apply_points_the_kernel_build_at_the_cache_dir(
        tmp_path, monkeypatch):
    from planer_tpu_torch.ops.kernels import build
    monkeypatch.delenv("PLANER_TORCH_BUILD_DIR", raising=False)
    Config(compile_cache_dir=str(tmp_path / "kernels")).apply()
    assert os.environ["PLANER_TORCH_BUILD_DIR"] == str(tmp_path / "kernels")
    assert build._build_dir() == tmp_path / "kernels"
    monkeypatch.delenv("PLANER_TORCH_BUILD_DIR")


def test_plot_dot(capsys, tmp_path):
    net = models.unet(in_ch=1, out_ch=1, base=4, depth=1, device="cpu")
    p = str(tmp_path / "net.dot")
    dot = plot_net(net.graph, p)
    assert dot.startswith("digraph") and os.path.exists(p)
    assert "conv" in capsys.readouterr().out
    assert dot.count("->") >= len(net.graph.flow) - 1
    jg = jm.unet(in_ch=1, out_ch=1, base=4, depth=1).graph
    assert dot == to_dot(net.graph) == jplot.to_dot(jg)


def test_zoo_manifest_parsing(tmp_path):
    md = tmp_path / "readme.md"
    md.write_text(
        "# model\n\n"
        "|File|Required|Description|\n|---|---|---|\n"
        "|[weights.pla](http://example.com/w.pla)|yes|weights|\n"
        "|[extra.npy](http://example.com/e.npy)||optional|\n")
    files = zoo.get_source(str(md))
    assert files == jzoo.get_source(str(md)) == [
        ["weights.pla", True, "http://example.com/w.pla"],
        ["extra.npy", False, "http://example.com/e.npy"]]


def test_zoo_source_annotation(tmp_path):
    lst = [["a.pla", True, "http://x/a"], ["b.pla", False, "http://x/b"]]
    (tmp_path / "a.pla").write_bytes(b"x")
    out = zoo.source(str(tmp_path), [list(i) for i in lst])
    assert out == jzoo.source(str(tmp_path), [list(i) for i in lst])
    assert out[0][2] is True and out[1][2] is False


_PKG = '''
import os
import numpy as np
root = None
source = [["resnet18_tiny.pla", True, "{url}"]]
_net = None


def load():
    global _net
    from planer_tpu_torch import read_net
    _net = read_net(os.path.join(root, "resnet18_tiny"), device="cpu")
    return _net


def predict(x):
    return _net(x)
'''


def test_zoo_model_package(tmp_path, monkeypatch):
    """The whole zoo flow on a package whose manifest points at a
    ``file://`` URL: decoration, download into the cache dir (created by
    the download, not at import), auto-load, predict."""
    remote = tmp_path / "remote"
    remote.mkdir()
    src = models.resnet18(num_classes=10, device="cpu")
    pt.save_pla(str(remote / "resnet18_tiny"), src.graph, src.weights)
    pkg_dir = tmp_path / "pkgs" / "planer_zoo_torch_example"
    pkg_dir.mkdir(parents=True)
    (pkg_dir / "__init__.py").write_text(_PKG.format(
        url=(remote / "resnet18_tiny.pla").as_uri()))
    monkeypatch.syspath_prepend(str(tmp_path / "pkgs"))
    cache = tmp_path / "cache"
    monkeypatch.setattr(zoo, "root", str(cache))
    import planer_zoo_torch_example as pkg
    try:
        mod = zoo.Model(pkg, auto=True)
        assert callable(mod.list_source) and callable(mod.download)
        src_rows = mod.source()
        assert src_rows[0][0] == "resnet18_tiny.pla" and src_rows[0][2]
        assert (cache / "planer_zoo_torch_example" / "resnet18_tiny.pla"
                ).exists()
        out = mod.predict(_x())
        assert out.shape == (1, 10)
        np.testing.assert_array_equal(out, src(_x()))
    finally:
        sys.modules.pop("planer_zoo_torch_example", None)


def test_zoo_bare_name_names_the_cache_dir(tmp_path):
    """A manifest row without a URL scheme is not looked up anywhere: the
    download raises, naming the file and the cache dir it belongs in, and
    writes nothing; a file already there is taken as installed."""
    rows = [["w.pla", True, "planer_zoo/example/w.pla"]]
    mroot = tmp_path / "cache"
    with pytest.raises(FileNotFoundError, match="w.pla") as e:
        zoo.downloads(str(mroot), [list(r) for r in rows])
    assert str(mroot) in str(e.value) and not mroot.exists()
    mroot.mkdir()
    (mroot / "w.pla").write_bytes(b"x")
    zoo.downloads(str(mroot), [list(r) for r in rows])
    assert zoo.source(str(mroot), [list(r) for r in rows])[0][2] is True


def test_planer_catlog_reads_the_catalog_url(tmp_path, monkeypatch):
    """``planer_catlog()`` reads the JSON catalog at ``CATALOG_URL`` as the
    JAX package's does (here a ``file://`` URL: no network), and
    ``downloads`` still does not resolve a bare name through it."""
    cat = {"resnet18": "file:///models/resnet18.pla", "unet": "x"}
    path = tmp_path / "catlog.txt"
    path.write_text(json.dumps(cat))
    monkeypatch.setattr(zoo, "CATALOG_URL", path.as_uri())
    monkeypatch.setattr(jzoo, "CATALOG_URL", path.as_uri())
    assert zoo.planer_catlog() == jzoo.planer_catlog() == cat
    assert "planer_catlog" in zoo.__all__
    monkeypatch.setattr(zoo, "planer_catlog", lambda: pytest.fail(
        "downloads read the catalog"))
    with pytest.raises(FileNotFoundError):
        zoo.downloads(str(tmp_path / "cache"), [["w.pla", True, "resnet18"]])


def test_load_state_and_real_weight_hook(tmp_path, monkeypatch):
    """A checkpoint in the zoo cache dir as <name>.npz (and as a .pla) is
    found by load_real_weights and installed by Net.load_state, as in the
    JAX package; none there gives None."""
    net = models.resnet18(num_classes=10, device="cpu")
    monkeypatch.setenv("PLANER_ZOO_DIR", str(tmp_path))
    assert ev.load_real_weights("resnet18") is None
    assert jev.load_real_weights("resnet18") is None
    idx = net.graph.init_index()
    state = {"stem.w": net.weights[idx["stem.w"]] * 2.0 + 1.0,
             "fc.b": net.weights[idx["fc.b"]] + 3.0,
             "not.a.weight": np.zeros(3, np.float32)}
    np.savez(tmp_path / "resnet18.npz", **state)
    loaded = ev.load_real_weights("resnet18")
    jloaded = jev.load_real_weights("resnet18")
    assert loaded.keys() == jloaded.keys()
    assert net.load_state(loaded) == 2
    np.testing.assert_allclose(net.weights[idx["stem.w"]], state["stem.w"])
    with pytest.raises(KeyError):
        net.load_state({"nope": np.zeros(1, np.float32)}, strict=True)
    with pytest.raises(ValueError):
        net.load_state({"fc.b": np.zeros((3, 3), np.float32)})
    out = net.program(_x()).numpy()
    assert np.isfinite(out).all() and out.shape == (1, 10)
    pt.save_pla(str(tmp_path / "r18pla"), net.graph, net.weights)
    got = ev.load_real_weights("r18pla")
    ref = jev.load_real_weights("r18pla")
    assert got.keys() == ref.keys()
    assert all(np.array_equal(got[k], ref[k]) for k in got)
