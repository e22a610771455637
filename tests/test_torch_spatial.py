"""The port's H-axis spatial sharding (``planer_tpu_torch.parallel.spatial``)
held against the JAX package's on the same nets and inputs: the 4 cases of
tests/test_spatial.py on a mesh of 8 repeated ``cpu`` devices beside the JAX
package's 8 virtual CPU devices, and each windowed op's row mapping against
the unsharded op."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from planer_tpu import models as jm
from planer_tpu.ops import numpy_ops as nops
from planer_tpu.parallel import make_mesh as j_make_mesh
from planer_tpu.parallel.spatial import halo_exchange as j_halo_exchange
from planer_tpu.parallel.spatial import shard_spatial as j_shard_spatial
from planer_tpu.parallel.spatial import spatial_conv as j_spatial_conv

from planer_tpu_torch import models as tm
from planer_tpu_torch.models.builder import GraphBuilder
from planer_tpu_torch.parallel import make_mesh
from planer_tpu_torch.parallel import spatial as sp
from planer_tpu_torch.parallel.spatial import (halo_exchange, shard_spatial,
                                               spatial_conv)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jdevices():
    d = jax.devices("cpu")
    if len(d) < 8:
        pytest.skip("needs 8 virtual cpu devices")
    return d[:8]


def _both(jnet, tnet, x, shape, jdevices, tol):
    ref = tnet(x)
    j_shard_spatial(jnet, j_make_mesh(shape, ("data", "model"),
                                      devices=jdevices))
    jout = np.asarray(jnet.forward(x))
    prog = shard_spatial(tnet, make_mesh(shape, ("data", "model"),
                                         devices=CPU8))
    assert isinstance(tnet.program, sp.SpatialProgram)
    out = tnet(x)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(out, jout, rtol=tol, atol=tol)
    return prog


@pytest.mark.parametrize("mode", ["convtranspose", "nearest"])
def test_shard_spatial_parity(rng, jdevices, mode):
    """H-sharded UNet equals the unsharded program (and the JAX package's
    GSPMD-partitioned one) within 1e-5."""
    x = rng.standard_normal((1, 1, 64, 64)).astype(np.float32)
    kw = dict(in_ch=1, out_ch=1, base=8, depth=2, upsample_mode=mode)
    _both(jm.unet(**kw), tm.unet(**kw, device="cpu"), x, (1, 8), jdevices,
          1e-5)


def test_shard_spatial_resnet(rng, jdevices):
    """ResNet-18 at 64 on a (2, 4) mesh: batch over data, H over model;
    layer4's 2 rows are fewer than 4 shards and continue gathered."""
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    prog = _both(jm.resnet18(num_classes=8), tm.resnet18(num_classes=8,
                                                         device="cpu"),
                 x, (2, 4), jdevices, 1e-4)
    assert prog.n_data == 2 and prog.n_model == 4


def test_halo_exchange_rows(jdevices):
    """Each shard sees its neighbours' edge rows, zeros at the outer edges:
    the same 24 rows as the JAX package's shard_map exchange."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    x = np.arange(8 * 8, dtype=np.float32).reshape(1, 1, 8, 8)
    shards = list(torch.tensor_split(torch.as_tensor(x), 8, dim=2))
    out = torch.cat(halo_exchange(shards, 1), dim=2).numpy()
    assert out.shape == (1, 1, 24, 8)
    np.testing.assert_array_equal(out[0, 0, 0], np.zeros(8))
    np.testing.assert_array_equal(out[0, 0, 1], x[0, 0, 0])
    np.testing.assert_array_equal(out[0, 0, 2], x[0, 0, 1])
    np.testing.assert_array_equal(out[0, 0, 9], x[0, 0, 2])
    np.testing.assert_array_equal(out[0, 0, 10], x[0, 0, 3])
    np.testing.assert_array_equal(out[0, 0, 11], x[0, 0, 4])
    np.testing.assert_array_equal(out[0, 0, 23], np.zeros(8))
    jmesh = j_make_mesh((1, 8), ("data", "model"), devices=jdevices)
    fn = shard_map(lambda xl: j_halo_exchange(xl, 1, "model"), mesh=jmesh,
                   in_specs=(P(None, None, "model", None),),
                   out_specs=P(None, None, "model", None))
    np.testing.assert_array_equal(out, np.asarray(fn(jnp.asarray(x))))


def test_spatial_conv_matches_dense(rng, jdevices):
    """The explicit halo-exchanged conv equals one same-padded conv of the
    whole image (and the JAX package's shard_map form)."""
    x = rng.standard_normal((1, 4, 32, 16)).astype(np.float32)
    K = (rng.standard_normal((6, 4, 3, 3)) * 0.3).astype(np.float32)
    B = rng.standard_normal(6).astype(np.float32)
    ref = nops.conv2d(x, K, B, pads=(1, 1, 1, 1))
    mesh = make_mesh((1, 8), ("data", "model"), devices=CPU8)
    out = spatial_conv(*(torch.as_tensor(a) for a in (x, K, B)), mesh).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    jmesh = j_make_mesh((1, 8), ("data", "model"), devices=jdevices)
    jout = np.asarray(j_spatial_conv(jnp.asarray(x), jnp.asarray(K),
                                     jnp.asarray(B), jmesh))
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-4)


# one op with a window over H, then a relu: (opcode, weight shape, kwargs)
WINDOWS = [
    ("conv", (5, 3, 3, 3), dict(strides=[2, 2], pads=[1, 1, 1, 1])),
    ("conv", (5, 3, 5, 5), dict(strides=[1, 1], pads=[2, 1, 2, 1])),
    ("conv", (5, 3, 3, 3), dict(strides=[1, 1], pads=[2, 1, 2, 1],
                                dilations=[2, 2])),
    ("conv", (5, 3, 3, 3), dict(strides=[3, 1], pads=[0, 1, 2, 1])),
    ("conv", (5, 3, 3, 3), dict(strides=[2, 2], auto_pad="SAME_UPPER")),
    ("convtranspose", (3, 5, 3, 3), dict(strides=[2, 2], pads=[1, 1, 1, 1],
                                         output_padding=[1, 1])),
    ("convtranspose", (3, 5, 4, 4), dict(strides=[3, 3], pads=[0, 0, 2, 2])),
    ("convtranspose", (3, 5, 2, 2), dict(strides=[3, 3], pads=[0, 0, 0, 0])),
    ("maxpool", None, dict(w=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
    ("maxpool", None, dict(w=[3, 3], strides=[2, 2], pads=[0, 0, 0, 0],
                           ceil_mode=1)),
    ("averagepool", None, dict(w=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                               count_include_pad=0)),
    ("averagepool", None, dict(w=[3, 3], strides=[1, 1], pads=[1, 1, 1, 1],
                               count_include_pad=1)),
]


@pytest.mark.parametrize("case", range(len(WINDOWS)),
                         ids=[f"{w[0]}{i}" for i, w in enumerate(WINDOWS)])
def test_window_rows_map_exactly(case, monkeypatch):
    """Each windowed op, split into output-row shards that fetch their
    input rows (odd heights, strides, dilations, asymmetric pads, ceil
    mode, transposed windows), equals the unsharded op on (1, 8), (2, 4)
    and (4, 2) meshes: the pools bit for bit, the convs within the 1e-5 of
    tests/test_spatial.py (a float conv's summation order may change with
    the shard's shape)."""
    opcode, wshape, kw = WINDOWS[case]
    rng = np.random.default_rng(case)
    b = GraphBuilder(["x"])
    if wshape:
        bias = wshape[1] if opcode == "convtranspose" else wshape[0]
        W = b.weight("w", (rng.standard_normal(wshape) * 0.3).astype(
            np.float32))
        Bv = b.weight("b", rng.standard_normal(bias).astype(np.float32))
        y = getattr(b, opcode)("x", W, Bv, **kw)
    else:
        y = getattr(b, opcode)("x", **kw)
    b.ret(b.relu(y))
    net = b.build_net("cpu")
    windows = []
    orig = sp.SpatialProgram._window

    def window(self, *a):
        out = orig(self, *a)
        windows.append(out is not None)
        return out
    monkeypatch.setattr(sp.SpatialProgram, "_window", window)
    for h in (17, 40):
        windows.clear()
        x = rng.standard_normal((3, 3, h, 11)).astype(np.float32)
        ref = net(x)
        for shape in ((1, 8), (2, 4), (4, 2)):
            shard_spatial(net, make_mesh(shape, devices=CPU8))
            if wshape:
                np.testing.assert_allclose(net(x), ref, rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(net(x), ref)
            net._program = None
    # at 40 rows every op has an output row for each of 8 shards
    assert len(windows) == 3 and all(windows)
