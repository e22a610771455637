"""Guards of the PyTorch port's boundaries: it never imports the JAX package
(or jax / ml_dtypes), its entry points default to the CUDA card and refuse
to fall back quietly, and its kernel wrappers run a plain version only for
CPU tensors."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import planer_tpu_torch as pt
from planer_tpu_torch import models
from planer_tpu_torch.ops import fp8
from planer_tpu_torch.ops.kernels import build
from planer_tpu_torch.ops.kernels import gemm as tg
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.ops.kernels import stagen as sg
from planer_tpu_torch.ops.qtypes import QTensor
from planer_tpu_torch.registry import get_op
from planer_tpu_torch.ops.kernels.stage64 import _fxp_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "planer_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(ROOT, "examples", f)
            for f in ("torch_shard_multichip.py", "torch_serve_sharded.py",
                      "torch_classify_resnet.py", "torch_detect_yolov3.py",
                      "torch_segment_unet_tiled.py",
                      "torch_serve_continuous.py",
                      os.path.join("torch_planer_zoo_example",
                                   "__init__.py"))]
    for d, _, files in os.walk(os.path.join(ROOT, "planer_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


def test_no_jax_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 15 and all(os.path.exists(f) for f in files)
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and _forbidden(node.module):
                bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and _forbidden(str(node.args[0].value)):
                bad.append((path, node.args[0].value))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, planer_tpu_torch, chip_smoke\n"
            "import planer_tpu_torch.ops.kernels.stage64\n"
            "import planer_tpu_torch.ops.kernels.stagen\n"
            "import planer_tpu_torch.ops.kernels.gemm\n"
            "import planer_tpu_torch.ops.kernels.build\n"
            "import planer_tpu_torch.native, planer_tpu_torch.utils.tile\n"
            "import planer_tpu_torch.models.yolo_post\n"
            "import planer_tpu_torch.models.eval\n"
            "import planer_tpu_torch.runtime.serving\n"
            "import planer_tpu_torch.runtime.http_server\n"
            "import planer_tpu_torch.runtime.profiler\n"
            "import planer_tpu_torch.parallel.multihost\n"
            "import planer_tpu_torch.parallel.sharding\n"
            "import planer_tpu_torch.parallel.spatial\n"
            "import planer_tpu_torch.parallel.dispatcher\n"
            "import planer_tpu_torch.parallel.multichip\n"
            "import planer_tpu_torch.utils.config\n"
            "import planer_tpu_torch.utils.zoo, planer_tpu_torch.utils.plot\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# the JAX package's public names whose port counterpart has another name
RENAMED = {"NumpyExecutor": "Executor", "TracedProgram": "Program"}


def test_public_names_of_the_jax_package_exist_in_the_port():
    """Every public name ``planer_tpu/__init__.py`` binds (imports,
    functions, aliases) exists in ``planer_tpu_torch``, under its port
    name where the two differ."""
    path = os.path.join(ROOT, "planer_tpu", "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.FunctionDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    names = {n for n in names if not n.startswith("_")}
    assert {"ServingEngine", "profiler", "Config", "Model", "core",
            "GraphBuilder", "OPS"} <= names
    missing = [n for n in sorted(names) if not hasattr(pt, RENAMED.get(n, n))]
    assert not missing, missing
    assert pt.core() is torch
    assert isinstance(pt.asnumpy(torch.ones(2)), np.ndarray)
    t = pt.asarray(np.ones(2), device="cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    # dtypes as the JAX package takes them: numpy types, dtype objects and
    # names; a bfloat16 tensor comes back as float32 numpy
    for dt, want in ((np.float16, torch.float16),
                     ("float32", torch.float32),
                     (np.dtype("int8"), torch.int8), (np.int32, torch.int32),
                     ("bfloat16", torch.bfloat16), (bool, torch.bool),
                     (torch.float64, torch.float64)):
        assert pt.asarray([1, 0], dtype=dt, device="cpu").dtype == want
    b = pt.asnumpy(torch.ones(2, dtype=torch.bfloat16))
    assert b.dtype == np.float32 and (b == 1).all()
    assert pt.asnumpy(torch.ones(2), dtype=np.float16).dtype == np.float16
    if torch.cuda.is_available():
        assert pt.asarray(np.ones(2)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.asarray(np.ones(2))


def test_entry_points_default_to_cuda():
    """Without device='cpu' the entry points want the card; on a machine
    without one they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert pt.Net().device.type == "cuda"
        return
    for make in (lambda: pt.Net(), lambda: models.resnet18(),
                 lambda: models.yolov3(), lambda: models.unet(),
                 lambda: pt.read_net("missing-model-path")):
        with pytest.raises((RuntimeError, FileNotFoundError)) as e:
            make()
        if e.type is RuntimeError:
            assert "device='cpu'" in str(e.value)
    with pytest.raises(RuntimeError):
        models.resnet18()
    assert models.resnet18(device="cpu").device.type == "cpu"
    assert models.unet(base=8, depth=2, device="cpu").device.type == "cpu"


def _block_args(device="cpu", n=1, r=16):
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=device)
    y = t(rng.integers(0, 128, (n, 64, r, r), dtype=np.int8))
    w1 = t(rng.integers(-127, 128, (64, 64, 3, 3), dtype=np.int8))
    w2 = t(rng.integers(-127, 128, (64, 64, 3, 3), dtype=np.int8))
    f = (0.5 + rng.random(64)).astype(np.float32) / 256.0
    b = (rng.standard_normal(64) * 3.0).astype(np.float32)
    q1 = t(_fxp_pack(f, b + 0.5))
    q2 = t(_fxp_pack(f, b + 0.5, sx=0.9))
    e2 = t(np.stack([f, b]))
    return y, w1, q1, w2, q2, e2


def test_wrappers_run_plain_versions_on_cpu_only():
    st.LAUNCHES.clear()
    y, w1, q1, w2, q2, e2 = _block_args()
    for last, e in ((False, q2), (True, e2)):
        out = st.basic_block(y, w1, q1, w2, e, 0.9, last)
        ref = st.basic_block_plain(y, w1, q1, w2, e, 0.9, last)
        assert torch.equal(out, ref)
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.integers(-127, 128, (1, 3, 64, 64), dtype=np.int8))
    ws = torch.as_tensor(rng.integers(-127, 128, (64, 3, 7, 7), dtype=np.int8))
    out = st.stem_pool_requant(xq, ws, q1)
    assert torch.equal(out, st.stem_pool_requant_plain(xq, ws, q1))
    assert out.shape == (1, 64, 16, 16) and out.dtype == torch.int8
    assert sum(st.LAUNCHES.values()) == 0


def test_wrappers_check_their_arguments():
    y, w1, q1, w2, q2, e2 = _block_args()
    with pytest.raises(TypeError):                      # dtype
        st.basic_block(y.float(), w1, q1, w2, q2, 0.9)
    with pytest.raises(TypeError):                      # fxp table wanted
        st.basic_block(y, w1, q1, w2, e2, 0.9, last=False)
    with pytest.raises(ValueError):                     # contiguity
        st.basic_block(y.transpose(2, 3), w1, q1, w2, q2, 0.9)
    with pytest.raises(ValueError):                     # shape
        st.basic_block(y, w1[:32], q1, w2, q2, 0.9)
    # a device without a kernel raises rather than falling back
    meta = [a.to("meta") for a in (y, w1, q1, w2, q2)]
    with pytest.raises(ValueError, match="no kernel"):
        st.basic_block(*meta, 0.9)
    with pytest.raises(ValueError):                     # mixed devices
        st.basic_block(meta[0], w1, q1, w2, q2, 0.9)


def _stagen_args(device="cpu", n=1, h=48):
    """A two-block basic stage 16 -> 32 with a stride-2 entry (R = 24)."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.as_tensor(a, device=device)

    def q(o, c, k, act):
        w = rng.integers(-127, 128, (o, c, k, k), dtype=np.int8)
        s = ((0.5 + rng.random((o, 1, 1, 1))) / 256.0).astype(np.float32)
        return QTensor(t(w), t(s), True, act)

    def vec(c):
        return t((rng.standard_normal(c) * 0.1).astype(np.float32))

    w = [q(32, 16, 3, 0.2), vec(32), q(32, 32, 3, 0.9), vec(32),
         q(32, 16, 1, 0.2), vec(32),
         q(32, 32, 3, 0.8), vec(32), q(32, 32, 3, 0.7), vec(32)]
    blocks = [{"kind": "basic", "stride": 2, "down": True},
              {"kind": "basic", "stride": 1, "down": False}]
    x = t((rng.standard_normal((n, 16, h, h)) * 10).astype(np.float32))
    return x, w, blocks


def test_stagen_wrapper_runs_plain_version_on_cpu_only():
    sg.LAUNCHES.clear()
    x, w, blocks = _stagen_args()
    plan = sg._fold(w, blocks, x.device)
    xq = sg.stagen_prologue(x, plan.s_in)
    out = sg.stagen_stage(xq, plan)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 32, 24, 24)
    assert torch.equal(out, sg.stagen_plain(xq, plan))
    y = sg.stagen(x, *w, blocks=blocks, cache={})
    assert torch.equal(y, out.float())
    assert sum(sg.LAUNCHES.values()) == 0
    # the wrapper checks its input and refuses a device without a kernel
    with pytest.raises(TypeError):
        sg.stagen_stage(xq.float(), plan)
    with pytest.raises(ValueError):
        sg.stagen_stage(xq[:, :8].contiguous(), plan)
    with pytest.raises(ValueError):
        sg.stagen_stage(xq.transpose(2, 3), plan)
    with pytest.raises(ValueError):
        sg.stagen_stage(xq[..., :28, :28].contiguous(), plan)
    with pytest.raises(ValueError, match="weights on"):
        sg.stagen_stage(xq.to("meta"), plan)
    mplan = sg._fold(w, blocks, torch.device("meta"))
    for b in mplan.blocks:
        for c in b.convs + [b.proj] if b.proj else b.convs:
            c.w = c.w.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        sg.stagen_stage(xq.to("meta"), mplan)


def test_stagen_opcode_oracle_runs_decomposed_chain():
    """The registry's stagen: the program runs the fused op, the float32
    executor the decomposed chain on dequantized weights."""
    spec = get_op("stagen")
    assert spec.cached and spec.fn is not spec.oracle_fn
    x, w, blocks = _stagen_args()
    deq = [v.dequant() if isinstance(v, QTensor) else v for v in w]
    y = spec.oracle_fn(x, *deq, blocks=blocks, out_scale=None)
    ref = sg.decomposed(x, *deq, blocks=blocks)
    assert torch.equal(y, ref) and y.shape == (1, 32, 24, 24)
    sg.FALLOFF.clear()
    fused = spec.fn(x, *w, blocks=blocks, cache={})
    assert not sg.FALLOFF and fused.shape == y.shape


def _gemm_args(device="cpu", m=8, n=128, kd=128):
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, device=device)
    x = t(rng.standard_normal((m, kd)).astype(np.float32)).to(torch.bfloat16)
    q = t(rng.integers(-127, 128, (n, kd), dtype=np.int8))
    s = t(((0.5 + rng.random((n, 1))) / 256.0).astype(np.float32))
    return x, q, s


def test_gemm_wrapper_runs_plain_version_on_cpu_only():
    tg.LAUNCHES.clear()
    x, q, s = _gemm_args()
    out = tg.dense_q_kernel(x, q, s)
    assert torch.equal(out, tg.dense_q_plain(x, q, s))
    assert out.dtype == torch.bfloat16 and not tg.LAUNCHES
    with pytest.raises(TypeError):                      # int8 weights only
        tg.dense_q_kernel(x, q.float(), s)
    with pytest.raises(ValueError):                     # not a kernel shape
        tg.dense_q_kernel(x[:7], q, s)
    with pytest.raises(ValueError, match="no kernel"):
        tg.dense_q_kernel(*(a.to("meta") for a in (x, q, s)))
    with pytest.raises(ValueError):                     # mixed devices
        tg.dense_q_kernel(x.to("meta"), q, s)


def test_gemm_fp8_wrapper_runs_plain_version_on_cpu_only():
    """The fp8 weight form: the plain version on CPU tensors, no launch
    counted; weights that are neither int8 nor float8_e4m3fn (their uint8
    bytes, float16, the other fp8 format) are refused."""
    tg.LAUNCHES.clear()
    x, q, s = _gemm_args()
    q8 = fp8.to_tensor(fp8.encode(q.float().numpy() * 3.0))
    out = tg.dense_q_kernel(x, q8, s)
    assert torch.equal(out, tg.dense_q_plain(x, q8, s))
    assert out.dtype == torch.bfloat16 and not tg.LAUNCHES
    for bad in (q8.view(torch.uint8), q8.to(torch.float16),
                q8.to(torch.float8_e5m2)):
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            tg.dense_q_kernel(x, bad, s)
    with pytest.raises(ValueError, match="no kernel"):
        tg.dense_q_kernel(*(a.to("meta") for a in (x, q8, s)))


def test_gemm_fp8_launch_failure_raises(monkeypatch):
    """The fp8 form passes the kernel its weight code (1) and raises on a
    CUDA error, counting nothing."""
    tg.LAUNCHES.clear()
    x, q, s = _gemm_args()
    q8 = fp8.to_tensor(fp8.encode(q.float().numpy()))
    seen = []

    class Lib:
        class dense_q:                                  # noqa: N801
            def __new__(cls, *a):
                seen.append(a)
                return 700                              # illegal address
    monkeypatch.setattr(tg, "_lib", lambda: Lib)
    monkeypatch.setattr(tg, "_stream", lambda device: 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tg._launch(x, q8, s.reshape(-1), None)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tg._launch(x, q, s.reshape(-1), None)
    assert [a[8:10] for a in seen] == [(1, 1), (1, 0)]    # xdtype, wdtype
    assert not tg.LAUNCHES


def test_gemm_f32_x_reaches_the_kernel_as_bf16(monkeypatch):
    """f32 x goes to the kernel rounded to bf16 (a new tensor), with the
    output-dtype code 0 and an f32 output; bf16 x goes as it is, code 1."""
    x, q, s = _gemm_args()
    seen = []

    class Lib:
        class dense_q:                                  # noqa: N801
            def __new__(cls, *a):
                seen.append(a)
                return 0
    monkeypatch.setattr(tg, "_lib", lambda: Lib)
    monkeypatch.setattr(tg, "_stream", lambda device: 0)
    xf = x.float()
    out = tg._launch(xf, q, s.reshape(-1), None)
    assert out.dtype == torch.float32 and seen[-1][8:10] == (0, 0)
    assert seen[-1][0] != xf.data_ptr()
    out = tg._launch(x, q, s.reshape(-1), None)
    assert out.dtype == torch.bfloat16 and seen[-1][8:10] == (1, 0)
    assert seen[-1][0] == x.data_ptr()
    tg.LAUNCHES.clear()


def test_gemm_kernel_failures_raise_instead_of_falling_back(monkeypatch):
    """The CUDA branch has no fallback: a build that fails (no nvcc here)
    and a launch that returns a CUDA error both raise, and neither counts a
    launch; the gate alone picks the fallback numerics."""
    tg.LAUNCHES.clear()
    x, q, s = _gemm_args()
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_lib_path", lambda name: build._build_dir()
                        / f"lib{name}-missing-for-test.so")
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        tg._launch(x, q, s.reshape(-1), None)

    class Lib:
        class dense_q:                                  # noqa: N801
            def __new__(cls, *a):
                return 700                              # illegal address
    monkeypatch.setattr(tg, "_lib", lambda: Lib)
    monkeypatch.setattr(tg, "_stream", lambda device: 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tg._launch(x, q, s.reshape(-1), None)
    assert not tg.LAUNCHES
    src = open(tg.__file__).read()
    assert "try:" not in src and "except" not in src


def test_frontend_imports_no_jax():
    """The frontends (codec, ONNX converter, torch.fx lowering) run with the
    JAX package, jax and ml_dtypes blocked from import."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import torch\n"
            "from planer_tpu_torch.frontend import onnx_proto, onnx_convert\n"
            "from planer_tpu_torch.frontend.torch2planer import fx_to_graph\n"
            "g, blob = fx_to_graph(torch.nn.Sequential(torch.nn.Conv2d(3, 4,"
            " 3), torch.nn.ReLU()))\n"
            "m = onnx_proto.ModelProto.parse(onnx_proto.ModelProto(graph="
            "onnx_proto.GraphProto(node=[onnx_proto.NodeProto(input=['x'], "
            "output=['y'], name='r', op_type='Relu')], input=[onnx_proto."
            "ValueInfoProto('x')], output=[onnx_proto.ValueInfoProto('y')]))"
            ".dump())\n"
            "onnx_convert.convert_model(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_read_net_onnx_defaults_to_cuda(tmp_path):
    """read_net("x.onnx") builds its net on the card unless asked for the
    CPU, and raises where there is no card rather than falling back."""
    import inspect
    from planer_tpu_torch.frontend import onnx_proto as P
    assert inspect.signature(pt.read_net).parameters["device"].default \
        == "cuda"
    model = P.ModelProto(graph=P.GraphProto(
        node=[P.NodeProto(input=["x"], output=["y"], name="r",
                          op_type="Relu")],
        input=[P.ValueInfoProto("x", 1, [2])],
        output=[P.ValueInfoProto("y", 1, [2])]))
    p = str(tmp_path / "x.onnx")
    P.save_model(model, p)
    if torch.cuda.is_available():
        assert pt.read_net(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.read_net(p)
    net = pt.read_net(p, device="cpu")
    assert net.device.type == "cpu"
    np.testing.assert_array_equal(net(np.array([-1.0, 2.0], np.float32)),
                                  [0.0, 2.0])


def _all_of(path):
    """The ``__all__`` list a module file assigns (read, not imported)."""
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [c.value for c in node.value.elts]
    raise AssertionError(f"{path} has no __all__")


def test_public_names_of_the_jax_parallel_package_exist_in_the_port():
    """``planer_tpu.parallel``'s names and its ``spatial``, ``multihost``,
    ``dispatcher`` and ``sharding`` modules' ``__all__`` are the port's."""
    import importlib
    jdir = os.path.join(ROOT, "planer_tpu", "parallel")
    par = importlib.import_module("planer_tpu_torch.parallel")
    assert par.__all__ == _all_of(os.path.join(jdir, "__init__.py"))
    assert all(hasattr(par, n) for n in par.__all__)
    for mod in ("sharding", "spatial", "multihost", "dispatcher"):
        m = importlib.import_module(f"planer_tpu_torch.parallel.{mod}")
        assert m.__all__ == _all_of(os.path.join(jdir, f"{mod}.py")), mod
        assert all(callable(getattr(m, n)) for n in m.__all__), mod
    from planer_tpu_torch.parallel import dispatcher, sharding, spatial
    assert callable(dispatcher.spawn_toy_worker)
    assert callable(spatial.spatial_conv)
    assert sharding.FUSED_OVERRIDES == {
        "stage64": {"force_decomposed": True},
        "stagen": {"force_decomposed": True}}


def test_dryrun_multichip_and_examples_on_a_cpu_mesh():
    """``dryrun_multichip(8, device="cpu")`` and both parallel examples with
    ``--device cpu`` run on a mesh of 8 repeated ``cpu`` devices; without
    the argument each asks for the card, which is not here."""
    from planer_tpu_torch.parallel.multichip import dryrun_multichip
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(8)
    rep = dryrun_multichip(8, device="cpu")
    assert rep["mesh"] == {"data": 2, "model": 4}
    assert rep["dispatcher"]["dp_size_after"] == 1
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for ex, want in (("torch_shard_multichip.py", "out: (8, 64)"),
                     ("torch_serve_sharded.py", "served 24 requests")):
        r = subprocess.run([sys.executable, os.path.join("examples", ex),
                            "--device", "cpu"],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        assert want in r.stdout, r.stdout


def _public_defs(path):
    """The module-level public functions and classes a file defines."""
    return {n.name for n in ast.parse(open(path).read()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _params(fn) -> set:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return set(names) - {"self", "cls"}


def _surface(path) -> dict:
    """{name: parameter names} of a file's public functions and of each
    public class's public methods (``Class.method``, ``__init__`` and
    ``__call__`` included); a class itself maps to None."""
    out = {}
    for n in ast.parse(open(path).read()).body:
        if n.__class__ is ast.FunctionDef and not n.name.startswith("_"):
            out[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out[n.name] = None
            for m in n.body:
                if isinstance(m, ast.FunctionDef) and (
                        not m.name.startswith("_")
                        or m.name in ("__init__", "__call__")):
                    out[f"{n.name}.{m.name}"] = _params(m)
    return out


# JAX modules whose port counterpart sits in another file, as
# (port file, {JAX name: port name} where a name differs)
STAND_INS = {
    # one op library serves the program and the float32 executor: the
    # port's Executor runs torch_ops where NumpyExecutor runs numpy_ops
    "ops/jax_ops.py": ("ops/torch_ops.py", {}),
    "ops/numpy_ops.py": ("ops/torch_ops.py", {}),
    "runtime/executor.py": ("runtime/executor.py",
                            {"NumpyExecutor": "Executor"}),
    # the program runs eagerly: no tracer
    "runtime/tracer.py": ("runtime/program.py",
                          {"TracedProgram": "Program"}),
    # the Pallas kernels' wrappers; their kernels are csrc/*.cu
    "ops/pallas/__init__.py": ("ops/kernels/__init__.py", {}),
    "ops/pallas/gemm.py": ("ops/kernels/gemm.py", {}),
    "ops/pallas/stage64.py": ("ops/kernels/stage64.py", {}),
    "ops/pallas/stagen.py": ("ops/kernels/stagen.py", {}),
}

# names whose port counterpart behaves otherwise by choice (ROADMAP §3),
# each with the test that pins the difference
DIFFERENCES = {
    "utils/zoo.py:downloads": "test_torch_aux.py::"
    "test_zoo_bare_name_names_the_cache_dir",       # no online catalog
    "utils/zoo.py:load": "test_torch_aux.py::test_zoo_model_package",
    "native/__init__.py:nms": "test_torch_yolo.py::"
    "test_failed_nms_build_raises",                 # no numpy fallback
    "native/__init__.py:available": "test_torch_yolo.py::"
    "test_available_reports_the_build",
    "runtime/profiler.py:cost_report": "test_torch_aux.py::test_cost_report",
    "runtime/serving.py:ServingStats": "test_torch_serving.py::"
    "test_throughput_stats",                       # a latency per request
    "parallel/spatial.py:halo_exchange": "test_torch_spatial.py::"
    "test_halo_exchange_rows",                      # a list of shards
    "parallel/multihost.py:initialize": "test_torch_dispatcher.py::"
    "test_initialize_forms_a_gloo_world_of_one",
    # methods and parameters (``Class.method``, ``function(parameter)``),
    # named by the JAX module's path
    "runtime/tracer.py:TracedProgram.__init__(jit_kwargs)":
    "test_torch_compile.py::test_program_takes_no_jit_kwargs_or_device_params",
    "runtime/tracer.py:TracedProgram.__init__(device_params)":
    "test_torch_compile.py::test_program_takes_no_jit_kwargs_or_device_params",
    "quant.py:make_quant_program(jit_kwargs)":
    "test_torch_compile.py::test_program_takes_no_jit_kwargs_or_device_params",
    "ops/qtypes.py:QTensor.tree_flatten":           # JAX pytree hooks
    "test_torch_compile.py::test_qtensor_is_no_pytree",
    "ops/qtypes.py:QTensor.tree_unflatten":
    "test_torch_compile.py::test_qtensor_is_no_pytree",
    # a CUDA kernel has no interpret mode: CPU tensors run the plain
    # version, and ``plain`` asks for it on any device
    "ops/jax_ops.py:stage64(interpret)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    "ops/pallas/stage64.py:stage64(interpret)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    "ops/pallas/stage64.py:stage64(blocks)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    "ops/pallas/gemm.py:dense_q(interpret)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    "ops/pallas/gemm.py:matmul_q(interpret)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    "ops/pallas/stagen.py:stagen(interpret)": "test_torch_guard.py::"
    "test_kernel_entry_points_take_plain_in_place_of_interpret",
    # one op library serves the program and the float32 executor
    "ops/pallas/stage64.py:decomposed(jops)": "test_torch_guard.py::"
    "test_one_op_library_serves_both_engines",
    "ops/pallas/stagen.py:decomposed(jops)": "test_torch_guard.py::"
    "test_one_op_library_serves_both_engines",
    "parallel/spatial.py:halo_exchange(x)": "test_torch_spatial.py::"
    "test_halo_exchange_rows",                      # a list of shards
    "parallel/spatial.py:halo_exchange(axis_name)": "test_torch_spatial.py::"
    "test_halo_exchange_rows",
}


def test_every_jax_module_and_example_has_its_counterpart():
    """Every ``planer_tpu/**/*.py`` has a port file (its own path under
    ``planer_tpu_torch/``, or its stand-in) defining each of its public
    functions and classes, and every JAX example (a script or a package in
    ``examples/``) has a ``torch_`` counterpart defining the same; each
    chosen difference names a test that exists."""
    jroot, troot = (os.path.join(ROOT, p) for p in ("planer_tpu",
                                                    "planer_tpu_torch"))
    pairs = []
    for d, _, files in os.walk(jroot):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), jroot)
                port, renamed = STAND_INS.get(rel.replace(os.sep, "/"),
                                              (rel, {}))
                pairs.append((os.path.join(jroot, rel),
                              os.path.join(troot, port), renamed))
    ex = os.path.join(ROOT, "examples")
    for name in os.listdir(ex):
        if name.startswith(("torch_", "_", ".")):
            continue
        if name.endswith(".py"):
            pairs.append((os.path.join(ex, name),
                          os.path.join(ex, "torch_" + name), {}))
        elif os.path.exists(os.path.join(ex, name, "__init__.py")):
            for f in os.listdir(os.path.join(ex, name)):
                if f.endswith((".py", ".md")):
                    pairs.append((os.path.join(ex, name, f), os.path.join(
                        ex, "torch_" + name, f), {}))
    assert len(pairs) > 50
    missing = []
    for jpath, tpath, renamed in pairs:
        if not os.path.exists(tpath):
            missing.append((os.path.relpath(jpath, ROOT), "no counterpart"))
        elif jpath.endswith(".py"):
            want = {renamed.get(n, n) for n in _public_defs(jpath)}
            lost = sorted(want - _public_defs(tpath))
            if lost:
                missing.append((os.path.relpath(tpath, ROOT), lost))
    assert not missing, missing
    for where, pin in DIFFERENCES.items():
        module, name = where.split(":")
        tfile, tname = pin.split("::")
        assert tname in _public_defs(os.path.join(ROOT, "tests", tfile)), pin
        if "(" in name or "." in name:
            continue
        assert name in _public_defs(os.path.join(troot, module)), where


def test_every_jax_method_and_parameter_has_its_counterpart():
    """Each public method of a JAX class (renamed through ``STAND_INS``)
    exists on its port class, and each parameter of a JAX function or
    method on its port counterpart, unless a chosen difference lists it
    with its pinning test (which exists, as the test above checks)."""
    jroot, troot = (os.path.join(ROOT, p) for p in ("planer_tpu",
                                                    "planer_tpu_torch"))
    gaps = set()
    for d, _, files in os.walk(jroot):
        for f in (f for f in files if f.endswith(".py")):
            rel = os.path.relpath(os.path.join(d, f), jroot).replace(
                os.sep, "/")
            port, renamed = STAND_INS.get(rel, (rel, {}))
            theirs = _surface(os.path.join(troot, port))
            for name, params in _surface(os.path.join(jroot, rel)).items():
                cls, _, meth = name.partition(".")
                tname = renamed.get(cls, cls) + ("." + meth if meth else "")
                if tname not in theirs:
                    if meth:           # module-level names: the test above
                        gaps.add(f"{rel}:{name}")
                    continue
                if params is not None and theirs[tname] is not None:
                    gaps.update(f"{rel}:{name}({p})"
                                for p in params - theirs[tname])
    chosen = {k for k in DIFFERENCES if "(" in k or "." in k.split(":")[1]}
    assert gaps == chosen, (sorted(gaps - chosen), sorted(chosen - gaps))


def test_kernel_entry_points_take_plain_in_place_of_interpret():
    """Where a JAX kernel entry point takes ``interpret`` (run the Pallas
    kernel in the interpreter), the port's takes ``plain`` (its kernels'
    plain PyTorch versions on any device; CPU tensors run them anyway),
    and the fused stage's informational ``blocks`` stops at the op."""
    import inspect
    from planer_tpu_torch.ops import torch_ops as tops
    for fn in (tops.stage64, st.stage64, tg.dense_q, tg.matmul_q,
               sg.stagen):
        ps = inspect.signature(fn).parameters
        assert "plain" in ps and "interpret" not in ps, fn
    assert "blocks" in inspect.signature(tops.stage64).parameters
    assert "blocks" not in inspect.signature(st.stage64).parameters
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((64, 128)).astype(np.float32))
    K = QTensor(torch.as_tensor(rng.integers(-127, 128, (128, 128),
                                             dtype=np.int8)),
                torch.full((128, 1), 0.01))
    torch.testing.assert_close(tg.dense_q(x, K, plain=True), tg.dense_q(x, K),
                               rtol=0, atol=0)


def test_one_op_library_serves_both_engines():
    """The JAX package's fused-stage chains take ``jops`` (jax_ops for the
    program, numpy_ops for the oracle); the port has one op library, so
    its chains take none and the float32 executor runs the same functions
    as the program wherever no quantized fast path differs."""
    import inspect
    for fn in (st.decomposed, sg.decomposed):
        assert "jops" not in inspect.signature(fn).parameters
    for op in ("relu", "maxpool", "reshape", "concat", "gather"):
        assert get_op(op).fn is get_op(op).oracle_fn
