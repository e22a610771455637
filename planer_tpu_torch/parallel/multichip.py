"""``dryrun_multichip`` — one sharded forward step of each multi-device
mechanism at small shapes, held against the unsharded program: the port's
counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``.

    python -m planer_tpu_torch.parallel.multichip [N] [--device cpu]

runs on a mesh of N repeated ``cuda:0`` devices (8 by default), or of the
CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int = 8, device="cuda") -> dict:
    """DP x TP (the widest TP <= 4 that divides ``n_devices``) on a
    weight-only INT8 ResNet-18, H-axis spatial sharding on a small UNet, and
    the two-process dispatcher with one worker killed; each checked, and
    summarized in the returned dict.  The mesh repeats ``device``: the
    card (raising where there is none) unless the caller asks for
    ``"cpu"``."""
    from .. import models
    from ..device import resolve_device
    from . import dispatcher, make_mesh, shard_program
    from .spatial import shard_spatial

    device = resolve_device(device)
    devices = [device] * n_devices
    tp = next((c for c in (4, 2) if n_devices % c == 0), 1)
    dp = n_devices // tp
    mesh = make_mesh((dp, tp), ("data", "model"), devices=devices)

    net = models.resnet18(num_classes=64, device=device)
    net.quantize("int8")            # the quantized sharded path
    batch = max(dp * 2, 2)
    x = np.random.default_rng(0).standard_normal(
        (batch, 3, 64, 64)).astype(np.float32)
    ref = net(x)
    shard_program(net, mesh)
    out = net(x)
    assert out.shape == (batch, 64), out.shape
    assert np.isfinite(out).all()
    assert np.allclose(out, ref, rtol=1e-3, atol=1e-3), (
        "DP x TP sharded output diverged from the unsharded program: "
        f"max abs diff {np.abs(out - ref).max():.3e}")

    # spatial parallelism: H over the model axis, halos fetched per op
    unet = models.unet(in_ch=1, out_ch=1, base=8, depth=2, device=device)
    xs = np.random.default_rng(1).standard_normal(
        (dp, 1, 8 * tp, 32)).astype(np.float32)
    sref = unet(xs)
    shard_spatial(unet, mesh)
    souts = unet(xs)
    assert np.allclose(souts, sref, rtol=1e-4, atol=1e-4)

    # the request plane: 2 worker processes form the DP group, requests
    # flow, one is killed by exact PID and must be evicted while the
    # survivor absorbs its work
    rep = dispatcher.dryrun(n_workers=2, n_requests=8)
    assert rep["ok"], rep
    assert rep["dp_size_after"] == 1 and len(rep["evictions"]) == 1

    print(f"dryrun_multichip OK: mesh=(data={dp}, model={tp}) of "
          f"{device}, dp+tp out={out.shape}, spatial out={souts.shape}, "
          f"devices={n_devices}, multihost evictions={rep['evictions']}")
    return {"mesh": {"data": dp, "model": tp}, "out": out.shape,
            "spatial": souts.shape, "dispatcher": rep}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the device the mesh repeats (cuda or cpu)")
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
