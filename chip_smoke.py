"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds the port's
   CUDA kernels from ``planer_tpu_torch/csrc`` with nvcc (sm_90a);
2. kernel phase: at the main path's 224 shapes, batch 1 and 64, calls each
   kernel wrapper on card tensors and holds the result against its plain
   PyTorch version on the same inputs (int8 planes bit-exact, bf16 planes
   within one bf16 ulp), and times kernel, plain version and a cuDNN
   neighbour with CUDA events;
3. main path: INT8 ResNet-18 at 224 (random weights from a seed), optimized,
   calibrated on 4 synthetic images, quantized with static activation
   scales, bf16 compute; answers requests through ``Net.__call__`` and
   ``InferenceSession``-style ``run`` at batch 1, 8 and 64 with the launch
   counters reset just before, and checks that every kernel ran, nothing
   fell off the fused path, the outputs agree with the same program on the
   kernels' plain versions and with the float32 executor; then times the
   step at batch 1 and 64.

``python3 chip_smoke.py --profile DIR`` adds a torch.profiler pass over the
main path's steps: the device's busy share and time by kernel, with the full
tables written to ``DIR/profile_b<batch>.txt``.

Every failure raises and exits non-zero.  The line before the last is one
JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
MARGIN = 0.02                # decisive-logit filter of the agreement checks


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of fn over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, ops):
    """Least time for the work: bytes over HBM rate vs ops over int8 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def agreement(pairs, label, max_p99, need_margin_agree=True):
    """bench.py-style leg: p99 over images of max|d|/max|ref| and argmax
    agreement on decisive (margin-filtered) images."""
    rels, agree, decisive = [], [], 0
    for y, r in pairs:
        if not np.isfinite(y).all():
            raise SystemExit(f"{label}: non-finite outputs")
        rels.append(np.abs(y - r).max(1) / (np.abs(r).max(1) + 1e-9))
        srt = np.sort(r, axis=1)
        keep = (srt[:, -1] - srt[:, -2]) / (np.abs(r).max(1) + 1e-9) >= MARGIN
        agree.append((y.argmax(1) == r.argmax(1))[keep])
        decisive += int(keep.sum())
    p99 = float(np.percentile(np.concatenate(rels), 99))
    agree = np.concatenate(agree)
    frac = float(agree.mean()) if agree.size else float("nan")
    log(f"{label}: p99 rel {p99:.6g}, margin-filtered argmax agreement "
        f"{frac} over {decisive} decisive images")
    if p99 > max_p99:
        raise SystemExit(f"{label}: p99 rel {p99} > {max_p99}")
    if need_margin_agree and (decisive == 0 or not agree.all()):
        raise SystemExit(f"{label}: margin-filtered argmax agreement {frac}")
    return p99, frac


def profile_steps(torch, prog, requests, card, out_dir):
    """Device time by kernel and the device's busy share over main-path
    steps at batch 1 and 64 (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    for b, reps in ((1, 20), (64, 5)):
        xd = torch.as_tensor(requests[b], device="cuda")
        for _ in range(3):
            prog(xd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                prog(xd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kern.setdefault(e.name, [0.0, 0])
                k[0] += e.device_time_total      # microseconds
                k[1] += 1
        busy = sum(v[0] for v in kern.values()) * 1e-6
        log(f"profile b{b}: {reps} steps, wall {1e3 * wall / reps:.4f} ms/step,"
            f" device busy {1e3 * busy / reps:.4f} ms/step "
            f"({100 * busy / wall:.1f}% of wall), {sum(v[1] for v in kern.values()) // reps}"
            f" kernels/step ({card})")
        for name, (us, cnt) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"  {100e-6 * us / busy:5.1f}%  {us / reps:9.1f} us/step  "
                f"x{cnt // reps:<3d} {name[:110]}")
        with open(os.path.join(out_dir, f"profile_b{b}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))


def kernel_phase(torch, st, F):
    """Each kernel against its plain version at 224, batch 1 and 64."""
    from planer_tpu_torch.ops.qtypes import QTensor
    from planer_tpu_torch.models.eval import synthetic_images
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def q(shape, act):
        w = rng.integers(-127, 128, size=shape, dtype=np.int8)
        s = ((0.5 + rng.random((shape[0], 1, 1, 1))) / 256.0).astype(np.float32)
        return QTensor(torch.as_tensor(w, device=dev),
                       torch.as_tensor(s, device=dev), True, act)

    def vec():
        return torch.as_tensor((rng.standard_normal(64) * 0.1).astype(
            np.float32), device=dev).to(torch.bfloat16)

    Ws, Bs = q((64, 3, 7, 7), 0.03), vec()
    blocks = [(q((64, 64, 3, 3), 0.9), vec(), q((64, 64, 3, 3), 0.8), vec()),
              (q((64, 64, 3, 3), 0.7), vec(), q((64, 64, 3, 3), 0.6), vec())]
    plan = st._fold(Ws, Bs, blocks, None, dev)           # last block bf16
    plan_q = st._fold(Ws, Bs, blocks, 0.11, dev)         # out_scale: int8
    # the stem-only forms (ResNet-50's stem): bf16 out, or truncated int8
    stem_bf16 = st._fold(Ws, Bs, [], None, dev)
    stem_trunc = st._fold(Ws, Bs, [], 0.05, dev)
    timed = ("stem_pool_requant", "basic_block", "basic_block_last")
    stats, errs = {}, {}
    for n in (1, 64):
        x = torch.as_tensor(next(synthetic_images(n, (3, 224, 224), seed=n,
                                                  batch=n)), device=dev)
        xq = st.stem_prologue(x, plan.s_in)
        y0 = st.stem_pool_requant_plain(xq, plan.ws, plan.stem_table)
        b0, b1, b1q = plan.blocks[0], plan.blocks[1], plan_q.blocks[1]
        y1 = st.basic_block_plain(y0, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx)
        stem, block = st.stem_pool_requant, st.basic_block
        cases = {
            "stem_pool_requant": (stem, (xq, plan.ws, plan.stem_table, "fxp")),
            "basic_block": (block, (y0, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx,
                                    False)),
            "basic_block_last": (block, (y1, b1.w1, b1.q1, b1.w2, b1.e2,
                                         b1.sx, True)),
            "basic_block[out_scale]": (block, (y1, b1q.w1, b1q.q1, b1q.w2,
                                               b1q.e2, b1q.sx, False)),
            "stem_pool_requant[bf16]": (
                stem, (xq, plan.ws, stem_bf16.stem_table, "bf16")),
            "stem_pool_requant[trunc]": (
                stem, (xq, plan.ws, stem_trunc.stem_table, "trunc")),
        }
        plains = {stem: st.stem_pool_requant_plain,
                  block: st.basic_block_plain}
        for name, (kern, args) in cases.items():
            plain = plains[kern]
            out = kern(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            if out.dtype != ref.dtype or out.shape != ref.shape:
                raise SystemExit(f"{name} b{n}: {out.dtype}{tuple(out.shape)}"
                                 f" vs plain {ref.dtype}{tuple(ref.shape)}")
            d = (out.float() - ref.float()).abs()
            if out.dtype == torch.int8:
                ok = torch.equal(out, ref)
            else:   # within one bf16 ulp
                r = ref.float().abs().clamp_min(1e-30)
                ok = bool((d <= torch.exp2(torch.floor(torch.log2(r)) - 7)
                           ).all())
            errs[name] = max(errs.get(name, 0.0), float(d.max()))
            log(f"kernel {name} b{n}: {out.dtype}{tuple(out.shape)} "
                f"max_abs_err {float(d.max())} nonzero "
                f"{float((ref != 0).float().mean()):.3f} -> "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version")
            if n == 64 and name in timed:
                stats[name] = {"ms": cuda_ms(lambda: kern(*args), 20),
                               "plain_ms": cuda_ms(lambda: plain(*args), 5)}
    for name in timed:
        stats[name]["err"] = errs[name]
    # cuDNN bf16 convs of the same shapes as neighbours (the port never
    # calls them; no single PyTorch call computes either fused function)
    xs = torch.randn(64, 3, 224, 224, device=dev, dtype=torch.bfloat16)
    ws = torch.randn(64, 3, 7, 7, device=dev, dtype=torch.bfloat16)
    xb = torch.randn(64, 64, 56, 56, device=dev, dtype=torch.bfloat16)
    wb = torch.randn(64, 64, 3, 3, device=dev, dtype=torch.bfloat16)
    lib_stem = cuda_ms(lambda: F.conv2d(xs, ws, stride=2, padding=3), 20)
    lib_block = cuda_ms(lambda: F.conv2d(xb, wb, padding=1), 20)
    return stats, lib_stem, lib_block


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / "
                                 "CUDA port on one NVIDIA card.")
    ap.add_argument("--profile", metavar="DIR",
                    help="add a torch.profiler pass over the main path's "
                    "steps and write its tables to DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    import torch.nn.functional as F
    from planer_tpu_torch import models
    from planer_tpu_torch.models.eval import synthetic_images
    from planer_tpu_torch.ops.kernels import build
    from planer_tpu_torch.ops.kernels import stage64 as st
    from planer_tpu_torch.quant import calibrate_act_scales

    t_all = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    took = build.build()
    log(f"kernel build (nvcc sm_90a, parallel): {took}")
    for name in took:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- kernels
    stats, lib_stem, lib_block = kernel_phase(torch, st, F)

    # -------------------------------------------------------- main path
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    net = models.resnet18(seed=SEED, device="cuda")
    net.optimize()
    calibrate_act_scales(net, synthetic_images(4, (3, 224, 224), seed=11,
                                               batch=2))
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    log(f"main path built (optimize, calibrate on 4 images, quantize): "
        f"{time.perf_counter() - t0:.1f} s")
    if sum(l.op == "stage64" for l in net.graph.layers) != 1:
        raise SystemExit("main path: the entry stage was not fused")

    requests = {b: next(synthetic_images(b, (3, 224, 224), seed=100 + b,
                                         batch=b)) for b in (1, 8, 64)}
    st.FALLOFF.clear()
    st.LAUNCHES.clear()
    answers, forwards = {}, 0
    for b, x in requests.items():
        answers[b] = net(x)                        # Net.__call__
        (again,) = net.run(None, {"x": x})         # InferenceSession.run
        forwards += 2
        if answers[b].shape != (b, 1000) or not np.isfinite(answers[b]).all():
            raise SystemExit(f"batch {b}: bad output {answers[b].shape}")
        if not np.array_equal(again, answers[b]):
            raise SystemExit(f"batch {b}: run() and __call__ disagree")
    launches = dict(st.LAUNCHES)
    log(f"main path: {forwards} forwards, launches {launches}, "
        f"falloff {dict(st.FALLOFF)}")
    want = {"stem_pool_requant": forwards, "basic_block": forwards,
            "basic_block_last": forwards}
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    if st.FALLOFF:
        raise SystemExit(f"stage64 fell off the fused path: {dict(st.FALLOFF)}")

    # leg 1: the same program with stage64 on the kernels' plain versions
    prog = net.program
    prog.op_overrides = {"stage64": {"plain": True}}
    pairs = [(answers[b], prog(requests[b]).cpu().numpy()) for b in requests]
    prog.op_overrides = {}
    leg1 = agreement(pairs, "kernels vs plain stage64 (same program)", 0.02,
                     need_margin_agree=False)
    if any(not np.array_equal(a, r) for a, r in pairs):
        log("note: kernel and plain programs are not bit-identical")
    # leg 3: against the float32 executor (TF32 off), 32 images
    imgs = list(synthetic_images(32, (3, 224, 224), seed=29, batch=16))
    pairs = [(net(x), net(x, engine="oracle")) for x in imgs]
    leg3 = agreement(pairs, "quantized program vs float32 executor", 0.05)

    # step time: device tensors in and out, after warm-up
    step = {}
    for b in (1, 64):
        xd = torch.as_tensor(requests[b], device="cuda")
        ms = cuda_ms(lambda: prog(xd), 50 if b == 1 else 20, warmup=5)
        step[b] = ms
        log(f"step b{b}: {ms:.4f} ms, {1e3 * b / ms:.1f} img/s "
            f"(program on device tensors; CUDA events; {card})")
    if args.profile:
        profile_steps(torch, prog, requests, card, args.profile)

    # ---------------------------------------------------- kernel table
    n = 64
    stem_bytes = n * 3 * 224 * 224 + 64 * 147 + 64 * 4 * 4 + n * 64 * 56 * 56
    stem_ops = 2 * n * 112 * 112 * 64 * 147
    blk_ops = 2 * 2 * n * 56 * 56 * 64 * 576
    rows = []
    for name, src_line, nbytes, ops, lib, lib_call in (
            ("stem_pool_requant", 303, stem_bytes, stem_ops, lib_stem,
             "cuDNN bf16 conv 7x7/2 3->64 at b64 (neighbour: no pool, no requant)"),
            ("basic_block", 469,
             n * 64 * 56 * 56 * 2 + 2 * 64 * 576 + 2 * 64 * 16, blk_ops,
             lib_block, "cuDNN bf16 conv 3x3 64->64 at b64 (neighbour: one of "
             "the block's two convs)"),
            ("basic_block_last", 469,
             n * 64 * 56 * 56 * 3 + 2 * 64 * 576 + 64 * 16 + 2 * 64 * 4,
             blk_ops, lib_block, "cuDNN bf16 conv 3x3 64->64 at b64 "
             "(neighbour: one of the block's two convs)")):
        s = stats[name]
        b_ms, by = bound_ms(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "planer_tpu_torch/csrc/stage64.cu",
            "replaces": f"planer_tpu/ops/pallas/stage64.py:{src_line}",
            "launches": launches[name], "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib, "library_call": lib_call,
            "batch": n})
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
            f"neighbour {r['library_ms']:.4f}) at b{n}")
    log(f"legs: plain-stage p99 {leg1[0]:.6g}; executor p99 {leg3[0]:.6g}; "
        f"total {time.perf_counter() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
