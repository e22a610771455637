"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), builds the port's
   CUDA kernels from ``planer_tpu_torch/csrc`` with nvcc (sm_90a) and
   prints each kernel's registers and spill bytes from ``-Xptxas=-v``
   (a kernel that spills fails the run);
2. kernel phase: at the main path's 224 shapes, batch 1 and 64, and at the
   ragged 200 (R = 50, a multiple of no tile side), batch 2, calls each
   stage64 wrapper in every form on card tensors, with the packed weights
   the program hands it, and holds the result against its plain PyTorch
   version on the same inputs (int8 planes bit-exact, bf16 planes within
   one bf16 ulp); times kernel, plain version and a cuDNN neighbour with
   CUDA events at batch 64 and reports the achieved int8 TOP/s;
3. main path: INT8 ResNet-18 at 224 (random weights from a seed), optimized,
   calibrated on 4 synthetic images, quantized with static activation
   scales, bf16 compute; answers requests through ``Net.__call__`` and
   ``InferenceSession``-style ``run`` at batch 1, 8 and 64 with the launch
   counters reset just before, and checks that every kernel ran, nothing
   fell off the fused path, the outputs agree with the same program on the
   kernels' plain versions and with the float32 executor; then times the
   step at batch 1 and 64.

4. stagen kernel phase: the ``fuse="all"`` body-stage kernel (one block
   kernel launch per residual block, every block in the geometry the
   wrapper picks: a resident form, or a wide form that streams the input
   in 64-channel slabs at shorter tiles) against its plain version
   (bit-exact) on the real folded tables and activations of built nets,
   at the three fused 224 geometries (ResNet-18 ``stagen_0``, ResNet-50
   ``stagen_0`` and ``stagen_1``) and batch 1 and 64, on ResNet-50's
   ``stagen_0`` of a 200 image (R = 50, which no 14-pixel tile divides) at
   batch 2, on ResNet-18's and ResNet-50's two fused stages at 448 (R = 56
   and 28; layer3 in the wide forms) at batch 1 and 64, and on two narrow
   stages whose channels the wrapper pads; checks each block's
   shared-memory size as the wrapper computes it against the library's;
   at batch 64 times the
   stage on the device (CUDA graph replay) and as wrapper calls, the plain
   version and, as a labelled neighbour that is not the same function, the
   port's decomposed chain of the same stage, with the achieved int8 TOP/s;
5. path 2: INT8 ResNet-50 at 224, ``quantize(fuse="all")``: answers at
   batch 1, 8 and 64 with the counters reset just before, checks 1 stem and,
   for each of the 2 fused stages, one launch per block per forward
   (counted where the block kernel launches), stagen's ``FALLOFF`` of exactly 2
   geometry fall-offs per forward (layers 3-4), the program against itself
   on the plain versions, and prints (without a gate: the fused-stage
   arithmetic is far from the float model) the gap to the float32
   executor; the same model with the default fuse (the bf16 stem kernel)
   is held to the float32 executor; step times of both programs;
6. path 3: INT8 ResNet-18 at 224, ``quantize(fuse="all")`` (the basic-block
   stage): batch 1 and 64, launches, ``FALLOFF``, the plain-version leg and
   step times;
7. path 7: INT8 ResNet-18 at 448, ``quantize(fuse="all")``: batch 1 and 64,
   one ``stagen_block`` launch per block of both fused stages (layer3's
   entry in a wide form) and no other stagen launch, ``FALLOFF`` of the
   stem stage and layer4 by geometry, the plain-version leg and step times;
7b. path 19: INT8 ResNet-50 at 448, ``quantize(fuse="all")`` (calibrated
   on 4 synthetic 448 images): batch 1 and 64, exactly one ``stagen_block``
   launch per block per forward of ``stagen_0`` (layer2, R = 56, the
   resident forms) and ``stagen_1`` (layer3, R = 28: six wide blocks) and
   no other stagen launch, ``FALLOFF`` of the stem stage and of layers 1
   and 4 by geometry, the replay and the program on the plain versions
   bit-identical, the gap to the float32 executor printed (not gated, as
   path 2's), step times;
8. dense_q kernel phase: the weight-only GEMM kernel against its plain
   version (f32 outputs max|d|/max|y| <= 1e-5; bf16 outputs within one bf16
   ulp plus the f32 sum-order term, see ``gemm_bound``) at the nine GEMM
   shapes of path 4 at batch 1 and 64, a dense-shaped call, an f32-x call
   and a ``matmul_q`` call, each with the kernel's tile plan (the card's,
   which must equal ``kernel_plan``'s); at batch 64 times the kernel on the
   device (CUDA graph replay) and as a wrapper call, the plain version and,
   as a labelled neighbour, cuBLAS ``torch.mm`` of bf16 x and
   pre-dequantized bf16 weights (no scale, no bias), with the achieved
   GB/s or TFLOP/s;
9. path 4: weight-only INT8 ResNet-50 at 224 (``quantize("int8")``, bf16
   compute) with ``torch_ops._PALLAS_CONV1X1`` on: batch 1, 8 and 64, exactly
   26 dense_q launches per forward and none of stage64 or stagen, the
   program against itself on the plain versions and against the float32
   executor; printed, not gated: the gap to the unquantized float model
   (the int8 quantization error) and the step times with the route on and
   off, in turns;
10. path 5: the main path's ResNet-18 under ``stage64.REQUANT = "trunc"``
   and under ``stage64.SPLIT = False``: batch 1 and 64, 1 stem and 2 block
   launches per forward in the trunc forms, ``FALLOFF`` empty, the plain leg
   bit-identical and the float32-executor leg.  The trunc block kernel is
   held against its plain version in phase 2;
11. the dense_q kernel phase again with float8_e4m3fn weights (the calls
   and bounds of phase 8), plus one call whose weight bytes enumerate all
   254 finite e4m3 codes against an identity x, which must give the
   decoded weights exactly; then path 6: weight-only FP8 ResNet-50 at 224
   (``quantize("fp8")``, bf16 compute) with the 1x1 route on: batch 1, 8
   and 64, exactly 26
   ``dense_q[fp8]`` launches per forward and no other hand-kernel launch,
   the program against itself on the plain versions (p99 <= 0.02) and
   against the float32 executor on the same decoded weights (p99 <= 0.05,
   argmax 1.0); printed, not gated: the gap to the unquantized float model
   (the fp8 quantization error itself) and the step times;
12. the dense_q kernel phase at YOLO-v3's seven routed 1x1 GEMM shapes at
   416 (Kd 256-1024, M = 169-2,704 at batch 1), batch 1 and 16, each
   against its plain version, with its tile plan and times at both
   batches;
13. path 8: YOLO-v3 at 416, 80 classes, static W8A8 (optimize, calibrated
   on 4 synthetic images, bf16; detection heads tamed so the untrained net
   gives boxes): batch 1, 8 and 16, no hand-kernel launch, the three raw
   heads against the float32 executor (p99 <= ``LEG3_YOLO_W8A8``),
   ``detect`` (host decode, native score filter and NMS) at batch 8, step
   times;
14. path 9: weight-only INT8 YOLO-v3 at 416 with the 1x1 route: batch 1
   and 8, exactly 31 dense_q launches per forward, the plain leg (p99 <=
   0.02) and the executor leg (p99 <= 0.05), step times with the route on
   and off in turns, and the detection-agreement gate of the JAX package's
   accuracy test (8 classes at 256, f1 >= 0.95), the f1 at 416 with 80
   classes printed;
15. path 10: UNet (base 32, depth 4) at 512, weight-only INT8, bf16: the
   whole image at batch 1, the executor leg (p99 <= ``LEG3_UNET_BF16``),
   the tiled run (windows of 256, margin 64) timed, tiled against whole as
   tests/test_models.py bounds it on that test's net and image, step
   times;
16. path 11: a torchvision-layout ResNet-18 ``nn.Module`` (seeded weights
   and BatchNorm statistics, on the card) through ``torch2planer`` ->
   ``read_net`` on the card -> optimize -> calibrate on 4 synthetic images
   -> static INT8 -> bf16: first the unquantized import in float32 against
   the module's own forward (under ``float32_exact``, as the port's calls
   run; max|d|/max|y| <= 1e-4); then one
   stage64 and the same opcodes as ``models.resnet18()`` through the same
   pipeline, batch 1, 8 and 64 with the stem and both block kernels
   launched once per forward, the plain leg bit-identical, the float32
   executor leg (p99 <= 0.05, margin-filtered argmax 1.0), step times;
17. path 12: the same module written as opset-13 ONNX bytes by this
   script's writer (the port's protobuf codec) and read by ``read_net``:
   the same checks, its quantized weights array-equal to path 11's and its
   logits bit-identical to path 11's on the same requests;
18. path 13: one ONNX op zoo applying the op library's opcodes (``erf`` in
   both modes), a GraphBuilder graph with ``const``, bidirectional ONNX
   LSTM and GRU (seq 16, batch 8, hidden 128, with and without
   ``sequence_lens``) and a graph cut at ``nonzero`` whose tail runs
   ``topk`` and ``reducesum`` in the float32 executor, each on the card
   against the same graph on the port's CPU path: integer, boolean and
   index outputs equal, floats within the CPU tests' classes (bit-equal,
   4 ulps of the largest magnitude for transcendental ops, 1e-6 of it for
   sum-order ops, 1e-5 for the GEMM ones), each opcode's largest gap
   printed;
19. path 14: the main path's net served by a ``ServingEngine`` (batch
   buckets 1-32, 5 ms delay, the 224 spatial bucket, warm-up) and its HTTP
   front end: 8 closed-loop clients x 12 requests alternating 224 x 224 and
   200 x 210 images, a burst of 32, 4 singles 20 ms apart, 16 POST /predict
   from 4 threads, then /stats and /health.  Warm-up must leave a
   captured entry for every bucket (printed with the peak device memory
   since the engine's start).  Every answer against
   ``Net.__call__`` at b1 on the same padded image (p99 <= 0.02, argmax
   equal on decisive answers), the stats adding up to 148 requests, 1 stem
   and 2 block launches per executed batch (warm-up included), no
   fall-off, /health naming the card; a second engine at the 220 bucket
   (off the kernels' geometry) shows its fall-off in ``stats()``; p50 and
   p99 latency, occupancy, pad fraction and the burst's rate printed;
20. path 15: the tools: ``profiler.cost_report`` at b64 beside the measured
   b64 step, ``profiler.trace`` with the IR layer names in its events,
   ``Net.timeit`` over the float32 executor, ``layer_quant_errors`` on a
   float ResNet-18 at 224 with one corrupted layer (which must rank first)
   and ``quantize_auto`` on a 16-class ResNet-18 at 224 (returns or raises
   its RuntimeError);
21. path 16: the main path's net written by ``save_pla`` and read back by
   ``read_net`` (bit-equal at b1) in two worker processes on the card,
   each serving a ``parallel.dispatcher.Dispatcher`` (buckets 1-32)
   through ``run_worker``: 64 requests in waves of 8, then 48 more with
   worker 0 killed by its PID after the first answer.  Every answer
   against the parent's ``Net.__call__`` on the batch it was served in
   (p99 <= 0.02, argmax on decisive logits; the bit-identical count
   printed), 1 stem + 2 block launches and no fall-off in every batch a
   worker served, worker 0 evicted and every request answered; the
   group's rate printed without a claim.  Then the main path's net under
   ``shard_program`` on a (2, 4) mesh of cuda:0 at b8 and b64: each entry
   captured as a CUDA graph (kernel nodes printed), its first call and
   replay bit-identical to the sharded ``Program._run``, an answer handed
   out unchanged by a later replay, against the unsharded program with no
   stage64 or stagen launch, the replay, ``_run`` and unsharded steps
   printed without a claim; UNet (base 32, depth 4, float32) at 512 under
   (2, 4) ``shard_program`` and (1, 4) ``shard_spatial``, each captured
   and replaying bit-identical to its ``_run``, against the unsharded
   UNet; ``spatial_conv`` against one conv; and ``multihost.initialize``
   forming an nccl world of one;
22. path 17: the user examples.  The four ``examples/torch_*.py`` scripts
   run as a user runs them, started together, each in its own process on
   cuda:0: each exits 0 and prints its JAX original's lines.  Then each
   example's ``main(device="cuda")`` in this process, as a user calls it
   (the harness sets no TF32 flag):
   weight-only INT8 ResNet-18's bf16 logits against the float32 executor on
   the same dequantized weights (max|d|/max|y| <= 0.05, the top-5 ids equal
   at every rank the difference cannot swap); float32 YOLO-v3 at 416 with
   raw heads through ``detect`` against ``main(device="cpu")`` (heads within
   1e-4 of max|y|, the score filter's survivors and the detections equal
   away from the thresholds); UNet (base 16, depth 3) tiled over 700 x 900
   with an integer margin against the CPU run (1e-4); 32 requests served
   by a ``ServingEngine`` over a float ResNet-18 at 64 px, each answer
   within 1e-4 of ``net(x)`` at b1, ``stats()`` adding up and no spatial
   probe; the zoo package's ``.pla`` round trip and one forward.  No
   stage64, stagen or dense_q launch over the path (the JAX package runs
   no Pallas kernel on these configurations); wall times on the host clock
   printed.

23. path 18, right after the main path: first float32 precision, with
   both TF32 flags set on by the caller: a fresh float32 ResNet-18 answers
   bit-identically before and after its float32 executor is first built,
   within 1e-4 of that executor; a program with a cut compiles one entry
   at its first signature; the flags read on after every program,
   executor and ``lowered_text`` call.  Then the compile step.  The main
   path's net gets a fresh program; at batch 1, 8 and 64 the first call
   takes a new entry, warms up (1 stem + 2 block launches) and captures a
   CUDA graph; two later calls replay (their launches added from the
   capture's delta) and, with the first, are bit-identical to the eager
   loop ``Program._run``.  Under torch.profiler one call launches 1
   stem_kernel and 2 block_kernel, as its ``LAUNCHES`` delta says, and a
   bare replay as many kernels as the graph has kernel nodes.  With the
   plain overrides the program takes a new entry that launches no stage64
   kernel and whose text names the plain versions; back on ``{}`` it
   reuses its entry.  A float64 batch (numpy, and a card tensor) returns
   float32 from the float32 entry, bit-identical to the float32 batch's
   answer.  An answer handed out is unchanged by a later replay with
   other images.  Printed, not claimed: capture ms and kernel nodes
   per batch, the b1 and b64 steps of the replay against ``_run`` (CUDA
   events and the host clock).

Every path, path 16's one-card mesh included, runs through the program's
compiled entries: the first call at a signature warms up and captures,
later calls replay.  Where a path's
answers are driven through ``Net.__call__`` and ``run``, each replay is
held against ``Program._run`` on the same batch: bit-identical on the
integer paths (the main path, paths 3, 5, 11 and 12), elsewhere printed and
held to leg 1's bound.

``python3 chip_smoke.py --profile DIR`` adds a torch.profiler pass over the
steps of the main path, of both ResNet-50 programs of path 2 and of paths
3, 4, 6, 8, 9 and 10: the device's busy share and time by kernel, with the
full tables written to ``DIR/profile_<program>_b<batch>.txt``, and keeps
path 15's trace as ``DIR/trace.json``.

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
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
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


def bound_ms(nbytes, ops, peak=PEAK_INT8_OPS):
    """Least time for the work: bytes over HBM rate vs ops over the peak of
    their type (int8 by default)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def agreement(pairs, label, max_p99, need_margin_agree=True, logits=True):
    """bench.py-style leg: p99 over images of max|d|/max|ref| and, where the
    outputs are logits, argmax agreement on decisive (margin-filtered)
    images."""
    rels, agree, decisive = [], [], 0
    for y, r in pairs:
        if not np.isfinite(y).all():
            raise SystemExit(f"{label}: non-finite outputs")
        rels.append(np.abs(y - r).max(1) / (np.abs(r).max(1) + 1e-9))
        if not logits:
            continue
        srt = np.sort(r, axis=1)
        keep = (srt[:, -1] - srt[:, -2]) / (np.abs(r).max(1) + 1e-9) >= MARGIN
        agree.append((y.argmax(1) == r.argmax(1))[keep])
        decisive += int(keep.sum())
    rels = np.concatenate(rels)
    p99 = float(np.percentile(rels, 99))
    if not logits:
        log(f"{label}: p99 rel {p99:.6g} over {len(rels)} images (max "
            f"{float(rels.max()):.6g})")
        if p99 > max_p99:
            raise SystemExit(f"{label}: p99 rel {p99} > {max_p99}")
        return p99, float("nan")
    agree = np.concatenate(agree)
    frac = float(agree.mean()) if agree.size else float("nan")
    log(f"{label}: p99 rel {p99:.6g}, margin-filtered argmax agreement "
        f"{frac} over {decisive} decisive images")
    if p99 > max_p99:
        raise SystemExit(f"{label}: p99 rel {p99} > {max_p99}")
    if need_margin_agree and (decisive == 0 or not agree.all()):
        raise SystemExit(f"{label}: margin-filtered argmax agreement {frac}")
    return p99, frac


def profile_steps(torch, prog, requests, card, out_dir, name="main",
                  batches=(1, 64)):
    """Device time by kernel and the device's busy share over a program's
    steps at each batch (1 and 64 unless given; torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    for b in batches:
        reps = 20 if b == 1 else 5
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
        log(f"profile {name} b{b}: {reps} steps, wall {1e3 * wall / reps:.4f} ms/step,"
            f" device busy {1e3 * busy / reps:.4f} ms/step "
            f"({100 * busy / wall:.1f}% of wall), {sum(v[1] for v in kern.values()) // reps}"
            f" kernels/step ({card})")
        for kname, (us, cnt) in sorted(kern.items(),
                                       key=lambda kv: -kv[1][0])[:12]:
            log(f"  {100e-6 * us / busy:5.1f}%  {us / reps:9.1f} us/step  "
                f"x{cnt // reps:<3d} {kname[:110]}")
        with open(os.path.join(out_dir, f"profile_{name}_b{b}.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))


def ptxas_report(log):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function in nvcc's ``-Xptxas=-v`` output."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([A-Za-z_]+_kernel)I(.*?)EE", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def kernel_phase(torch, st, F):
    """Each kernel against its plain version at 224, batch 1 and 64, and
    at the ragged 200 (R = 50, a multiple of no tile side), batch 2."""
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
    # REQUANT = "trunc" (path 5): trunc stem and blocks, bf16 or int8 last
    plan_t = st._fold(Ws, Bs, blocks, None, dev, "trunc", True)
    plan_tq = st._fold(Ws, Bs, blocks, 0.11, dev, "trunc", True)
    timed = ("stem_pool_requant", "basic_block", "basic_block_last",
             "stem_pool_requant[trunc]", "basic_block[trunc]",
             "basic_block_last[trunc]")
    stats, errs = {}, {}
    for n, h in ((1, 224), (64, 224), (2, 200)):
        x = torch.as_tensor(next(synthetic_images(n, (3, h, h), seed=n,
                                                  batch=n)), device=dev)
        xq = st.stem_prologue(x, plan.s_in)
        y0 = st.stem_pool_requant_plain(xq, plan.ws, plan.stem_table)
        b0, b1, b1q = plan.blocks[0], plan.blocks[1], plan_q.blocks[1]
        y1 = st.basic_block_plain(y0, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx)
        t0, t1, t1q = plan_t.blocks[0], plan_t.blocks[1], plan_tq.blocks[1]
        yt0 = st.stem_pool_requant_plain(xq, plan_t.ws, plan_t.stem_table,
                                         "trunc")
        yt1 = st.basic_block_plain(yt0, t0.w1, t0.q1, t0.w2, t0.e2, t0.sx,
                                   False, True)
        stem, block = st.stem_pool_requant, st.basic_block
        # the kernels get the packed weights the program hands them
        sp = {"wpack": plan.ws_pack}

        def bp(b):
            return {"w1p": b.w1p, "w2p": b.w2p}
        cases = {
            "stem_pool_requant": (stem, (xq, plan.ws, plan.stem_table, "fxp"),
                                  sp),
            "basic_block": (block, (y0, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx,
                                    False), bp(b0)),
            "basic_block_last": (block, (y1, b1.w1, b1.q1, b1.w2, b1.e2,
                                         b1.sx, True), bp(b1)),
            "basic_block[out_scale]": (block, (y1, b1q.w1, b1q.q1, b1q.w2,
                                               b1q.e2, b1q.sx, False),
                                       bp(b1q)),
            "stem_pool_requant[bf16]": (
                stem, (xq, plan.ws, stem_bf16.stem_table, "bf16"), sp),
            "stem_pool_requant[trunc, stem-only]": (
                stem, (xq, plan.ws, stem_trunc.stem_table, "trunc"), sp),
            "stem_pool_requant[trunc]": (
                stem, (xq, plan.ws, plan_t.stem_table, "trunc"), sp),
            "basic_block[trunc]": (block, (yt0, t0.w1, t0.q1, t0.w2, t0.e2,
                                           t0.sx, False, True), bp(t0)),
            "basic_block_last[trunc]": (block, (yt1, t1.w1, t1.q1, t1.w2,
                                                t1.e2, t1.sx, True, True),
                                        bp(t1)),
            "basic_block[trunc, out_scale]": (
                block, (yt1, t1q.w1, t1q.q1, t1q.w2, t1q.e2, t1q.sx, False,
                        True), bp(t1q)),
        }
        plains = {stem: st.stem_pool_requant_plain,
                  block: st.basic_block_plain}
        for name, (kern, args, packed) in cases.items():
            plain = plains[kern]
            out = kern(*args, **packed)
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
            log(f"kernel {name} b{n} H{h}: {out.dtype}{tuple(out.shape)} "
                f"max_abs_err {float(d.max())} nonzero "
                f"{float((ref != 0).float().mean()):.3f} -> "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version")
            if n == 64 and name in timed:
                stats[name] = {"ms": cuda_ms(lambda: kern(*args, **packed),
                                             20),
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


# --------------------------------------------------------------------------
# weight-only GEMM (dense_q)
# --------------------------------------------------------------------------

# path 4's routed 1x1 convs at 224: (Kd, N, side, convs per forward)
R50_GEMMS = [(256, 128, 56, 1), (512, 128, 28, 3), (128, 512, 28, 4),
             (512, 256, 28, 1), (1024, 256, 14, 5), (256, 1024, 14, 6),
             (1024, 512, 14, 1), (2048, 512, 7, 2), (512, 2048, 7, 3)]
# path 9's routed 1x1 convs of YOLO-v3 at 416 (the other 6 of its 37 1x1
# convs, N = 32, 64 and the 255-channel heads, take the fallback GEMM)
YOLO_GEMMS = [(256, 128, 52, 10), (512, 256, 26, 10), (1024, 512, 13, 7),
              (512, 256, 13, 1), (768, 256, 26, 1), (256, 128, 26, 1),
              (384, 128, 52, 1)]


def gemm_bound(out, ref, bias):
    """Kernel vs plain version.  f32: max|d|/max|y| <= 1e-5 (the f32 sums in
    another order).  bf16: one bf16 ulp of the product before the bias plus
    1e-5 of the largest product (that sum-order difference carried across a
    rounding boundary), plus one ulp of the result where a bias is added
    after the cast.  Returns (ok, max_abs_err, share of differing elements,
    a note on the elements more than one ulp of the pre-bias product
    apart)."""
    import torch
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    if out.dtype == torch.float32:
        ok = float(d.max()) <= 1e-5 * float(r.abs().max())
        return ok, float(d.max()), float((d > 0).float().mean()), "f32"

    def ulp(a):
        return torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(
            2.0 ** -126))) - 7)
    pre = r if bias is None else r - bias.float().reshape(1, -1)
    post = 0.0 if bias is None else ulp(r)
    ok = bool((d <= ulp(pre) + 1e-5 * pre.abs().max() + post).all())
    over = d > ulp(pre) + post
    note = f"{int(over.sum())} over one ulp"
    if over.any():
        note += (f" (largest |product| among them "
                 f"{float(pre.abs()[over].max() / pre.abs().max()):.3g} of "
                 f"the largest)")
    return ok, float(d.max()), float((d > 0).float().mean()), note


def gemm_phase(torch, tg, form="int8", gemms=R50_GEMMS, batches=(1, 64),
               timed=(64,), extra=True):
    """dense_q against its plain version at a path's shapes (path 4's at
    batch 1 and 64 unless given) and, with ``extra``, three more calls,
    with int8 or (``form="fp8"``) float8_e4m3fn weights; times the batches
    in ``timed``.  Returns per-shape rows."""
    from planer_tpu_torch.ops import fp8
    from planer_tpu_torch.ops.kernels.gemm_study import graph_ms
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: the plain version would round")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    key = "dense_q" if form == "int8" else f"dense_q[{form}]"

    def weights(n, kd):
        if form == "int8":
            q = torch.as_tensor(rng.integers(-127, 128, (n, kd),
                                             dtype=np.int8), device=dev)
            s = torch.as_tensor(((0.5 + rng.random((n, 1))) * 0.05 / 127.0
                                 ).astype(np.float32), device=dev)
        else:      # as quantize_net makes them: absmax / 448 per row
            w = (rng.standard_normal((n, kd)) * (0.5 + rng.random((n, 1)))
                 * 0.05).astype(np.float32)
            s = (np.abs(w).max(1, keepdims=True) / fp8.MAX).astype(np.float32)
            q = fp8.to_tensor(fp8.encode(w / s)).to(dev)
            s = torch.as_tensor(s, device=dev)
        b = torch.as_tensor((rng.standard_normal(n) * 0.1).astype(np.float32),
                            device=dev)
        return q, s, b

    cases = []
    for b in batches:
        for kd, n, side, cnt in gemms:
            cases.append((f"{kd}->{n} M={b * side * side}", b * side * side,
                          kd, n, torch.bfloat16, "dense",
                          cnt if b in timed else 0, b))
    if extra:
        cases += [("dense-shaped M=64 2048->1024", 64, 2048, 1024,
                   torch.bfloat16, "dense", 0, 0),
                  ("f32 x M=6272 512->128", 6272, 512, 128, torch.float32,
                   "dense", 0, 0),
                  ("matmul_q M=64 512->1024", 64, 512, 1024, torch.bfloat16,
                   "matmul_q", 0, 0)]
    rows = []
    for name, m, kd, n, dt, how, cnt, batch in cases:
        plan = tg.kernel_plan(m, n, kd)
        if tg.device_plan(m, n, kd) != plan:
            raise SystemExit(f"{key}[{name}]: the kernel's plan "
                             f"{tg.device_plan(m, n, kd)} is not kernel_plan's "
                             f"{plan}")
        q, s, bias = weights(n, kd)
        x = torch.randn(m, kd, device=dev).to(dt)
        B = bias.to(dt) if how == "dense" else None
        if how == "matmul_q":
            from planer_tpu_torch.ops.qtypes import QTensor
            kt = QTensor(q.t().contiguous(), s.reshape(1, -1))
            run = lambda: tg.matmul_q(x, kt)                # noqa: E731
            plain = lambda: tg.matmul_q(x, kt, plain=True)  # noqa: E731
        else:
            run = lambda: tg.dense_q_kernel(x, q, s, B)      # noqa: E731
            plain = lambda: tg.dense_q_plain(x, q, s, B)     # noqa: E731
        before = tg.LAUNCHES[key]
        out = run()
        torch.cuda.synchronize()
        if tg.LAUNCHES[key] != before + 1:
            raise SystemExit(f"{key} {name}: the kernel did not launch")
        ref = plain()
        ok, err, share, over = gemm_bound(out, ref, B)
        log(f"kernel {key}[{name}] {dt}: max_abs_err {err} differing "
            f"{share:.3g}, {over} -> {'ok' if ok else 'MISMATCH'}")
        if not ok or out.shape != ref.shape or out.dtype != ref.dtype:
            raise SystemExit(f"kernel {key}[{name}] disagrees with its "
                             f"plain version")
        if not cnt:
            continue
        wdq = (q.float() * s).to(torch.bfloat16)
        nbytes = m * kd * 2 + n * kd + n * 4 + n * 2 + m * n * 2
        ops = 2 * m * n * kd
        b_ms, by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
        row = {"shape": name, "batch": batch, "per_forward": cnt,
               "max_abs_err": err,
               "plan": {"pixels": plan[0], "channels": tg.KERNEL_BC,
                        "tiles": plan[1], "blocks": plan[2]},
               "ms": graph_ms(run), "call_ms": cuda_ms(run, 20),
               "plain_ms": cuda_ms(plain, 5),
               "neighbour_ms": graph_ms(lambda: torch.mm(x, wdq.t())),
               "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "ops": ops}
        rows.append(row)
        rate = (f"{nbytes / row['ms'] / 1e6:.0f} GB/s" if by == "bytes" else
                f"{ops / row['ms'] / 1e9:.1f} TFLOP/s")
        log(f"  {key}[{name}] b{batch}: tiles {plan[0]} px x {tg.KERNEL_BC} ch, "
            f"{plan[1]} tiles on {plan[2]} blocks; kernel {row['ms']:.4f} ms "
            f"on the device ({rate}; {row['call_ms']:.4f} ms a wrapper call "
            f"with the host's launch work), plain {row['plain_ms']:.4f}, "
            f"bound {b_ms:.4f} by {by} ({ops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), neighbour (cuBLAS torch.mm, no scale "
            f"or bias) {row['neighbour_ms']:.4f} ms")
    if form == "fp8":
        all_codes(torch, tg, fp8, dev)
    tg.LAUNCHES.clear()
    return rows


def all_codes(torch, tg, fp8, dev):
    """The e4m3 decode, exactly: weight bytes that enumerate the 254 finite
    codes, unit scales and an f32 identity x, so the kernel's output is its
    decoded weights (one exact product per sum), against the host codec's
    table, and against the plain version."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    qb = np.resize(codes, (128, 256))
    q = fp8.to_tensor(qb).to(dev)
    s = torch.ones(128, 1, device=dev)
    x = torch.eye(256, device=dev)
    out = tg.dense_q_kernel(x, q, s)
    torch.cuda.synchronize()
    want = torch.as_tensor(fp8.decode(qb), device=dev).t()
    exact = torch.equal(out, want)
    ok, err, _, _ = gemm_bound(out, tg.dense_q_plain(x, q, s), None)
    log(f"kernel dense_q[fp8][all 254 finite codes, identity x]: "
        f"{'equal to the decoded codes' if exact else 'MISMATCH'}, "
        f"max_abs_err vs plain {err}")
    if not (exact and ok):
        raise SystemExit("kernel dense_q[fp8] decodes e4m3 wrongly")


def gemm_row(name, grows, launches, forwards, path, batch=64):
    """The kernels-line row of a dense_q form: the launches of one forward
    of a path at ``batch`` (path 4's or 6's 26 at b64, path 9's 31),
    summed over the shapes."""
    grows = [r for r in grows if r["batch"] == batch]
    per = sum(r["per_forward"] for r in grows)
    per_fwd = {k: sum(r[k] * r["per_forward"] for r in grows)
               for k in ("ms", "call_ms", "plain_ms", "neighbour_ms",
                         "bound_ms")}
    log(f"{name} per b{batch} forward ({per} launches): {per_fwd['ms']:.4f} ms on "
        f"the device ({per_fwd['call_ms']:.4f} ms of wrapper calls), plain "
        f"{per_fwd['plain_ms']:.4f}, bound {per_fwd['bound_ms']:.4f}, "
        f"torch.mm neighbour {per_fwd['neighbour_ms']:.4f}; "
        f"{sum(r['ops'] * r['per_forward'] for r in grows) / 1e9:.1f} GFLOP")
    return {
        "name": name, "route": "cuda",
        "source": "planer_tpu_torch/csrc/gemm.cu",
        "replaces": "planer_tpu/ops/pallas/gemm.py:56",
        "launches": launches, "forwards": forwards,
        "max_abs_err": max(r["max_abs_err"] for r in grows),
        "ms": per_fwd["ms"], "call_ms": per_fwd["call_ms"],
        "plain_ms": per_fwd["plain_ms"], "bound_ms": per_fwd["bound_ms"],
        "bound_by": "bytes" if sum(r["bound_by"] == "bytes" for r in grows)
        * 2 > len(grows) else "operations",
        "library_ms": None, "neighbour_ms": per_fwd["neighbour_ms"],
        "neighbour": "not the same function: cuBLAS torch.mm of bf16 x and "
                     "pre-dequantized bf16 weights, without the scale and "
                     "the bias",
        "batch": batch, "per": f"the {per} launches of one b{batch} forward "
                               f"of {path}, summed over the shapes; ms and "
                               f"neighbour_ms device time (CUDA graph "
                               f"replay), call_ms the wrapper calls with the "
                               f"host's launch work",
        "shapes": grows}


# --------------------------------------------------------------------------
# fused body stages (stagen)
# --------------------------------------------------------------------------

PLAIN = {op: {"plain": True} for op in ("stage64", "stagen", "conv", "dense")}


def build_net(models, calibrate, synthetic_images, model, fuse, side=224):
    """An INT8 model as a user builds it: optimize, calibrate on 4 synthetic
    images of the side it will serve, quantize with static scales, bf16
    compute."""
    t0 = time.perf_counter()
    net = getattr(models, model)(seed=SEED, device="cuda")
    net.optimize()
    calibrate(net, synthetic_images(4, (3, side, side), seed=11, batch=2))
    net.quantize("int8", activations="static", fuse=fuse)
    net.astype_compute("bfloat16")
    log(f"{model} fuse={fuse!r} at {side} built: "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(l.op == 'stagen' for l in net.graph.layers)} stagen ops")
    return net


def capture_stages(sg, net, x):
    """One forward on the plain versions; returns each stage that ran fused
    as (input, weights, blocks, folded plan) — the program's own tables."""
    seen, orig = [], sg.stagen

    def spy(xs, *w, blocks=None, cache=None, **kw):
        fell = sum(sg.FALLOFF.values())
        y = orig(xs, *w, blocks=blocks, cache=cache, **kw)
        plan = cache.get(xs.device) if cache is not None else None
        # the cache outlives the call: a stage that fell off this time
        # (another input side) keeps an earlier side's plan
        if plan is not None and sum(sg.FALLOFF.values()) == fell:
            seen.append((xs, w, blocks, plan))
        return y

    prog = net.program
    sg.stagen, prog.op_overrides = spy, PLAIN
    prog._run(x)             # eager: the spy sees each stage once
    sg.stagen, prog.op_overrides = orig, {}
    return seen


def stage_launches(plan):
    """{launch key: launches} of one stagen_stage call: one block kernel
    launch per block, whatever its width."""
    return {f"stagen_block:{plan.tag}": len(plan.blocks)}


def path_launches(stage_rows, forwards):
    """{launch key: launches} a path's driven run must count: each stage's
    launches per call, per forward."""
    want = {}
    for r in stage_rows:
        for k, v in r["per_call"].items():
            want[k] = want.get(k, 0) + v * forwards
    return want


def stage_work(plan, n, h):
    """(bytes, ops) of one stage call: the int8 input, weights and tables
    read once, the bf16 output written once; 2 ops per int8 MAC."""
    nbytes, ops = n * plan.cin * h * h, 0
    for blk in plan.blocks:
        ho = h // blk.stride
        if blk.kind == "basic":
            sides = [ho, ho]
        else:
            sides = [h, ho, ho]
        convs = list(zip(blk.convs, sides))
        if blk.proj is not None:
            convs.append((blk.proj, ho))
        for c, side in convs:
            o, ci, k, _ = c.w.shape
            nbytes += o * ci * k * k + 8 * o
            ops += 2 * n * side * side * o * ci * k * k
        h = ho
    return nbytes + n * plan.cout * h * h * 2, ops


def narrow_stages(torch, sg):
    """Two narrow stages (16 -> 32 channels) with random weights: the
    kernel wrapper pads their channels to 64."""
    from planer_tpu_torch.ops.qtypes import QTensor
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def q(o, c, k, act):
        w = rng.integers(-127, 128, (o, c, k, k), dtype=np.int8)
        s = ((0.5 + rng.random((o, 1, 1, 1))) / 256.0).astype(np.float32)
        return QTensor(torch.as_tensor(w, device=dev),
                       torch.as_tensor(s, device=dev), True, act)

    def vec(c):
        return torch.as_tensor((rng.standard_normal(c) * 0.1).astype(
            np.float32), device=dev).to(torch.bfloat16)

    out = []
    for kind, h in (("basic", 48), ("bottleneck", 56)):
        if kind == "basic":
            w = [q(32, 16, 3, 0.2), vec(32), q(32, 32, 3, 0.9), vec(32),
                 q(32, 16, 1, 0.2), vec(32),
                 q(32, 32, 3, 0.8), vec(32), q(32, 32, 3, 0.7), vec(32)]
        else:
            w = [q(8, 16, 1, 0.2), vec(8), q(8, 8, 3, 0.9), vec(8),
                 q(32, 8, 1, 0.8), vec(32), q(32, 16, 1, 0.2), vec(32),
                 q(8, 32, 1, 0.7), vec(8), q(8, 8, 3, 0.6), vec(8),
                 q(32, 8, 1, 0.9), vec(32)]
        blocks = [{"kind": kind, "stride": 2, "down": True},
                  {"kind": kind, "stride": 1, "down": False}]
        x = torch.as_tensor((rng.standard_normal((2, 16, h, h)) * 10).astype(
            np.float32), device=dev).to(torch.bfloat16)
        out.append((f"narrow {kind} 16->32 s2 at {h}", x, w, blocks,
                    sg._fold(w, blocks, dev)))
    return out


def stagen_phase(torch, sg, nets, synthetic_images):
    """The stagen block kernel against its plain version, bit for bit, on
    every fused stage of the built nets (the program's own folded tables
    and the stage's real input): ResNet-18 and ResNet-50 at 224, batch 1
    and 64, ResNet-50's stagen_0 of a 200 image at batch 2 (R = 50: ragged
    tiles), ResNet-18 and ResNet-50 at 448 (layer3's blocks in the wide
    forms: the input streamed in slabs, shorter tiles) at batch 1 and 64,
    and two narrow stages; each call with one block kernel launch per block,
    and every block's shared-memory layout as the wrapper computes it
    against the library's; times at batch 64."""
    from planer_tpu_torch.ops.kernels.gemm_study import graph_ms
    rows = {}
    for b, h, models in ((1, 224, ("resnet18", "resnet50")),
                         (64, 224, ("resnet18", "resnet50")),
                         (2, 200, ("resnet50",)),
                         (1, 448, ("resnet18@448", "resnet50@448")),
                         (64, 448, ("resnet18@448", "resnet50@448"))):
        x = next(synthetic_images(b, (3, h, h), seed=200 + b, batch=b))
        x = torch.as_tensor(x, device="cuda")
        cases = []
        for model in models:
            for i, (xs, w, blocks, plan) in enumerate(
                    capture_stages(sg, nets[model], x)):
                name = (f"stagen[{model} stagen_{i}: {plan.tag}, "
                        f"R{xs.shape[2] // plan.blocks[0].stride}]")
                cases.append((name, xs, w, blocks, plan))
        if h == 200 and [c[0].endswith(", R50]") for c in cases] != [True]:
            raise SystemExit(f"the ragged case fused {[c[0] for c in cases]}")
        if b == 1:
            cases += narrow_stages(torch, sg)
        for name, xs, w, blocks, plan in cases:
            for blk in plan.blocks:
                args = (blk.form, blk.th, blk.xr, *blk.widths(),
                        blk.proj is not None, blk.last)
                if sg._lib().stagen_block_smem(*args) != sg._block_smem(*args):
                    raise SystemExit(f"{name}: the wrapper's layout size "
                                     f"{sg._block_smem(*args)} is not the "
                                     f"kernel's for {args}")
            xq = sg.stagen_prologue(xs, plan.s_in)
            sg.LAUNCHES.clear()
            out = sg.stagen_stage(xq, plan)
            torch.cuda.synchronize()
            if dict(sg.LAUNCHES) != stage_launches(plan):
                raise SystemExit(f"{name}: launches {dict(sg.LAUNCHES)}, "
                                 f"want {stage_launches(plan)}")
            ref = sg.stagen_plain(xq, plan)
            d = float((out.float() - ref.float()).abs().max())
            ok = out.dtype == ref.dtype == torch.bfloat16 \
                and out.shape == ref.shape and torch.equal(out, ref)
            log(f"kernel {name} b{b}: {out.dtype}{tuple(out.shape)} "
                f"max_abs_err {d} positive {float((ref > 0).float().mean()):.3f}"
                f" -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version")
            if name.startswith("narrow") or h == 200:
                continue
            geos = [(blk.th, blk.xr) for blk in plan.blocks]
            r = rows.setdefault(name, {"tag": plan.tag, "err": 0.0,
                                       "per_call": stage_launches(plan),
                                       "geometries": geos})
            r["err"] = max(r["err"], d)
            if b == 64:
                nbytes, ops = stage_work(plan, b, xs.shape[2])
                r.update(
                    ms=graph_ms(lambda: sg.stagen_stage(xq, plan)),
                    call_ms=cuda_ms(lambda: sg.stagen_stage(xq, plan), 20),
                    plain_ms=cuda_ms(lambda: sg.stagen_plain(xq, plan), 5),
                    neighbour_ms=cuda_ms(
                        lambda: sg.decomposed(xs, *w, blocks=blocks), 10),
                    bytes=nbytes, ops=ops)
                bms, by = bound_ms(nbytes, ops)
                r["tops"] = ops / r["ms"] / 1e9
                log(f"  {name} b64 (block geometries (tile rows, input "
                    f"slab slots; 0 resident) {geos}): kernel "
                    f"{r['ms']:.4f} ms on the device "
                    f"({r['tops']:.1f} TOP/s, bound / time "
                    f"{bms / r['ms']:.3f}; {r['call_ms']:.4f} ms as wrapper "
                    f"calls), plain {r['plain_ms']:.4f} ms, bound {bms:.4f} "
                    f"ms by {by} ({ops / 1e9:.1f} GOP, {nbytes / 1e6:.1f} "
                    f"MB); neighbour, not the same function: the port's "
                    f"decomposed chain of the stage {r['neighbour_ms']:.4f} ms")
    sg.LAUNCHES.clear()
    return rows


def outputs(y):
    """A net's answer as a tuple of arrays (one per graph output)."""
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def flat(y):
    """A batch's outputs as one (batch, values) array: the three YOLO heads
    of an image side by side, a segmentation map as one row."""
    return np.concatenate([np.asarray(h).reshape(h.shape[0], -1)
                           for h in outputs(y)], 1)


def drive(net, requests, counters, shapes=lambda b: [(b, 1000)],
          label="", same=False):
    """Answer every request through Net.__call__ and run(), with the launch
    and fall-off counters set to 0 just before; returns the answers, the
    number of forwards and a copy of each counter just after.  ``shapes(b)``
    lists the output shapes a batch of b must give.  The second call at a
    batch replays the program's compiled entry; after the counters are
    read, each replay is held against the eager loop (``Program._run``) on
    the same batch: bit-identical where ``same`` (the integer paths), else
    printed and held to leg 1's bound (p99 <= 0.02)."""
    for c in counters:
        c.clear()
    answers, replays, forwards = {}, {}, 0
    for b, x in requests.items():
        answers[b] = net(x)                        # Net.__call__
        again = net.run(None, {"x": x})            # InferenceSession.run
        replays[b] = again
        forwards += 2
        outs = outputs(answers[b])
        if [o.shape for o in outs] != list(shapes(b)) \
                or not all(np.isfinite(o).all() for o in outs):
            raise SystemExit(f"batch {b}: bad output "
                             f"{[o.shape for o in outs]}")
        if len(again) != len(outs) or not all(
                np.array_equal(a, o) for a, o in zip(again, outs)):
            raise SystemExit(f"batch {b}: run() and __call__ disagree")
    counts = [dict(c) for c in counters]
    prog = net.program
    pairs = [(flat(replays[b]), flat([t.cpu().numpy() for t in
                                      outputs(prog._run(x))]))
             for b, x in requests.items()]
    identical = all(np.array_equal(a, r) for a, r in pairs)
    log(f"{label or 'main path'} replay vs _run: "
        f"{'bit-identical' if identical else 'NOT bit-identical'} at "
        f"b{list(requests)}")
    if not identical:
        if same:
            raise SystemExit(f"{label}: the replay is not bit-identical to "
                             f"the eager loop")
        agreement(pairs, f"{label} replay vs _run (cuDNN under capture)",
                  0.02, need_margin_agree=False, logits=False)
    return answers, forwards, counts


def check_counts(label, got, want):
    log(f"{label}: {got}")
    if got != want:
        raise SystemExit(f"{label}: {got} != {want}")


def plain_leg(net, requests, answers, label, need_same=False,
              logits=True):
    """Leg 1: the program with the kernels against the same program with
    its kernels' plain versions (stage64, stagen, dense_q)."""
    prog = net.program
    prog.op_overrides = PLAIN
    pairs = [(flat(answers[b]),
              flat([t.cpu().numpy() for t in outputs(prog(requests[b]))]))
             for b in requests]
    prog.op_overrides = {}
    leg = agreement(pairs, label, 0.02, need_margin_agree=False,
                    logits=logits)
    same = all(np.array_equal(a, r) for a, r in pairs)
    log(f"{label}: {'bit-identical' if same else 'NOT bit-identical'}")
    if need_same and not same:
        raise SystemExit(f"{label}: not bit-identical")
    return leg


def step_times(torch, net, requests, label, card, batches=(1, 64)):
    """Step time at each batch (1 and 64 unless given): device tensors in
    and out, after warm-up, CUDA events."""
    prog, out = net.program, {}
    for b in batches:
        xd = torch.as_tensor(requests[b], device="cuda")
        out[b] = cuda_ms(lambda: prog(xd), 50 if b == 1 else 20, warmup=5)
        log(f"{label} step b{b}: {out[b]:.4f} ms, {1e3 * b / out[b]:.1f} "
            f"img/s (program on device tensors; CUDA events; {card})")
    return out


def resnet50_448_path(torch, net, srows, counters, synthetic_images, card):
    """Path 19: INT8 ResNet-50 at 448, fuse="all", batch 1 and 64 through
    ``Net.__call__`` and ``run`` (replays bit-identical to ``_run``): one
    ``stagen_block`` launch per block per forward of both fused stages
    (layer3's six blocks in the wide forms) and no other stagen launch, no
    stage64 launch and the stem stage, layer1 and layer4 off by geometry;
    the program against itself on the plain versions (bit-identical: the
    kernels are integer); the gap to the float32 executor on 32 images
    printed, not gated (the reference's fused-stage arithmetic, as path 2);
    step times."""
    req = {b: next(synthetic_images(b, (3, 448, 448), seed=400 + b,
                                    batch=b)) for b in (1, 64)}
    answers, fwd, (l64, f64, lgn, fgn) = drive(net, req, counters,
                                               label="path 19", same=True)
    rows = [r for name, r in srows.items()
            if name.startswith("stagen[resnet50@448 ")]
    if [r["tag"] for r in rows] != ["bottleneck/s2/256-128-512x4",
                                    "bottleneck/s2/512-256-1024x6"]:
        raise SystemExit(f"path 19: fused stages {[r['tag'] for r in rows]}")
    if not any(xr for r in rows for _, xr in r["geometries"]):
        raise SystemExit("path 19: no block ran in a wide form")
    check_counts("path 19 stage64 launches", l64, {})
    check_counts("path 19 stage64 falloff", f64, {"geometry": fwd})
    check_counts("path 19 stagen launches (one per block per forward)", lgn,
                 path_launches(rows, fwd))
    if any(not k.startswith("stagen_block:") for k in lgn):
        raise SystemExit(f"path 19: a launch other than stagen_block: {lgn}")
    check_counts("path 19 stagen falloff", fgn, {"geometry": 2 * fwd})
    leg1 = plain_leg(net, req, answers, "path 19 kernels vs plain stagen "
                     "(same program)", need_same=True)
    imgs = list(synthetic_images(32, (3, 448, 448), seed=29, batch=16))
    gap = agreement([(net(x), net(x, engine="oracle")) for x in imgs],
                    "path 19 fuse='all' vs float32 executor (printed, not "
                    "gated: the fused-stage arithmetic)", float("inf"),
                    need_margin_agree=False)
    steps = step_times(torch, net, req, "path 19 resnet50 fuse='all' at 448",
                       card)
    return {"launches": lgn, "forwards": fwd, "leg1": leg1, "gap": gap,
            "steps": steps}


# --------------------------------------------------------------------------
# path 18: the compile step (per-signature entries replayed as CUDA graphs)
# --------------------------------------------------------------------------

STAGE64_ONE = {"stem_pool_requant": 1, "basic_block": 1,
               "basic_block_last": 1}


def kernel_events(torch, prof):
    """(kernel names, stem_kernel count, block_kernel count) of a profile's
    device kernels: copies and fills left out, those a graph's memcpy and
    memset nodes run as driver kernels (``memcpy32_post``) too."""
    import re
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.lower().startswith(("memcpy", "memset"))]
    count = lambda k: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
    return names, count("stem_kernel"), count("block_kernel")


def host_ms(torch, fn, reps, warmup=3):
    """Mean milliseconds per call of fn on the host clock, the device
    drained before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def cut_graph():
    """x -> 3x3 conv 3 -> 16 (float32) -> relu -> nonzero (the cut): a
    program whose relu output comes from the card and whose nonzero runs
    in the float32 executor's tail."""
    from planer_tpu_torch.models.builder import GraphBuilder
    rng = np.random.default_rng(SEED)
    b = GraphBuilder(["x"])
    w = b.weight("w", (rng.standard_normal((16, 3, 3, 3))
                       * np.sqrt(2 / 27)).astype(np.float32))
    bias = b.weight("b", (0.1 * rng.standard_normal(16)).astype(np.float32))
    y = b.relu(b.conv("x", w, bias, pads=(1, 1, 1, 1)))
    b.ret([y, b.nonzero(y)])
    return b.build()


def precision_phase(torch, models, requests, card):
    """Path 18 (1): float32 precision is the program's, scoped to its
    calls.  With both TF32 flags set on by the caller: a fresh float32
    ResNet-18's answer at b8 is bit-identical before and after its float32
    executor (``net.oracle``) is first built and run, and within 1e-4 of
    that executor (TF32 would put it near 1e-3); a fresh program with a cut
    compiles one entry at its first signature, and its first call, its
    replay and ``_run`` agree bit for bit; after every program, executor
    and ``lowered_text`` call the flags read on, as the caller left
    them."""
    from planer_tpu_torch.runtime.program import Program
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True

    def left(what):
        got = (cudnn.allow_tf32, matmul.allow_tf32)
        if got != (True, True):
            raise SystemExit(f"path 18 precision: after {what} the TF32 "
                             f"flags read {got}, not as the caller left "
                             f"them")
    try:
        net = models.resnet18(seed=SEED, device="cuda")
        x = requests[8]
        before = net(x)
        left("the first call")
        again = net(x)
        left("a replay")
        oracle = net(x, engine="oracle")
        left("the float32 executor's build and run")
        after = net(x)
        left("a replay after the executor")
        same = np.array_equal(before, after) and np.array_equal(before, again)
        rel = float(np.abs(after - oracle).max() / np.abs(oracle).max())
        log(f"path 18 precision: float32 resnet18 b8 with TF32 on in the "
            f"caller: answers before and after net.oracle "
            f"{'bit-identical' if same else 'DIFFER'}; program vs executor "
            f"max|d|/max|y| {rel:.3g} (<= 1e-4); "
            f"{len(net.program._cache)} entry ({card})")
        if not same or rel > 1e-4 or len(net.program._cache) != 1:
            raise SystemExit("path 18 precision: the float32 program's "
                             "answer depends on the caller's TF32 flags")
        prog = Program(*cut_graph(), device="cuda")
        xc = requests[1][:, :, :64, :64]
        y0 = prog(xc)
        left("a program with a cut (first call)")
        y1 = prog(xc)
        left("a program with a cut (replay)")
        yr = prog._run(xc)
        left("_run")
        text = prog.lowered_text(xc)
        left("lowered_text")
        n = len(prog._cache)
        cut_same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(y0, y1, yr))
        log(f"path 18 precision: a program with a cut at flow "
            f"[{prog.plan.cut}] of {len(prog.graph.flow)}: {n} entry after "
            f"its first two calls at one signature; first call, replay and "
            f"_run {'bit-identical' if cut_same else 'DIFFER'}; "
            f"{text.splitlines()[-1]}")
        if n != 1 or not cut_same:
            raise SystemExit("path 18 precision: the program with a cut "
                             f"holds {n} entries, or its answers differ")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    return {"oracle_rel": rel, "cut_entries": n}


def compile_path(torch, net, requests, st, card):
    """Path 18: the main path's compile step.  On a fresh program, the
    first call at each of b1, b8 and b64 takes a new entry, warms up (1
    stem + 2 block launches) and captures; later calls replay (1 + 2 each,
    added from the capture's delta), and every answer is bit-identical to
    the eager loop (``Program._run``).  Under torch.profiler one call
    launches 1 stem_kernel and 2 block_kernel, as its LAUNCHES delta says,
    and one bare replay launches as many kernels as the graph holds
    kernel nodes.  With ``op_overrides = PLAIN`` the program takes a new
    entry that launches no stage64 kernel; back on ``{}`` it reuses its
    entry.  A replay with other images leaves an earlier answer (a device
    tensor) unchanged.  Printed, not claimed: capture ms, b1 and b64 step
    times of the replay against the eager loop (CUDA events and the host
    clock)."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    net._invalidate()                      # a fresh program, no entries
    prog = net.program
    res = {"capture_ms": {}, "kernel_nodes": {}, "launches": Counter()}
    for b, x in requests.items():
        n0 = len(prog._cache)
        st.LAUNCHES.clear()
        first = net(x)                     # compiles: warm run + capture
        entry = prog._entry(x)
        if len(prog._cache) != n0 + 1 or entry.graph is None:
            raise SystemExit(f"path 18 b{b}: no captured entry "
                             f"({len(prog._cache)} entries)")
        check_counts(f"path 18 b{b} first call (warm run) launches",
                     dict(st.LAUNCHES), STAGE64_ONE)
        res["launches"].update(st.LAUNCHES)
        st.LAUNCHES.clear()
        again = net(x)                     # replays
        (ran,) = net.run(None, {"x": x})
        check_counts(f"path 18 b{b} two replays' launches",
                     dict(st.LAUNCHES), {k: 2 for k in STAGE64_ONE})
        res["launches"].update(st.LAUNCHES)
        if len(prog._cache) != n0 + 1:
            raise SystemExit(f"path 18 b{b}: a replay took a new entry")
        eager = prog._run(x).cpu().numpy()
        for what, y in (("first call", first), ("replay", again),
                        ("run() replay", ran)):
            if not np.array_equal(y, eager):
                raise SystemExit(f"path 18 b{b}: the {what} is not "
                                 f"bit-identical to _run")
        res["capture_ms"][b] = entry.capture_ms
        res["kernel_nodes"][b] = entry.kernel_nodes
        log(f"path 18 b{b}: captured in {entry.capture_ms:.3f} ms, "
            f"{entry.kernel_nodes} kernel nodes; first call, replay and "
            f"run() bit-identical to _run ({card})")
    # a float64 batch narrows as jnp.asarray narrows it: the float32 entry
    # (a card tensor takes its own entry, the device being in the key)
    x8 = requests[8]
    x64 = x8 + 1e-3 * np.random.default_rng(SEED).standard_normal(x8.shape)
    x32 = x64.astype(np.float32)
    n0 = len(prog._cache)
    y64, y32 = net(x64), net(x32)
    n1 = len(prog._cache)
    yd32 = prog(torch.as_tensor(x32, device="cuda"))
    n2 = len(prog._cache)
    yd64 = prog(torch.as_tensor(x64, device="cuda"))
    n3 = len(prog._cache)
    narrow = (y64.dtype == np.float32 and yd64.dtype == torch.float32
              and np.array_equal(y64, y32) and torch.equal(yd64, yd32))
    log(f"path 18 float64 b8 (numpy, card tensor): {y64.dtype}, "
        f"{yd64.dtype}, {'bit-identical' if narrow else 'NOT bit-identical'}"
        f" to the float32 batch's answers; entries {n0} -> {n1} (numpy "
        f"float32 and float64), {n2} -> {n3} (card float32 and float64)")
    if not narrow or n1 != n0 or n3 != n2:
        raise SystemExit("path 18: a float64 batch did not take the float32 "
                         "entry")
    x1 = requests[1]
    entry = prog._entry(x1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st.LAUNCHES.clear()
        prog(x1)
        torch.cuda.synchronize()
    delta = dict(st.LAUNCHES)
    _, stems, blocks = kernel_events(torch, prof)
    log(f"path 18 one call under torch.profiler: {stems} stem_kernel, "
        f"{blocks} block_kernel; LAUNCHES delta {delta}")
    if (stems, blocks) != (1, 2) or delta != STAGE64_ONE:
        raise SystemExit("path 18: a replay's launches are not 1 stem + 2 "
                         "blocks, or not its LAUNCHES delta")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entry.graph.replay()
        torch.cuda.synchronize()
    names, stems, blocks = kernel_events(torch, prof)
    log(f"path 18 one bare replay: {len(names)} kernels ({stems} "
        f"stem_kernel, {blocks} block_kernel), the graph's kernel nodes "
        f"{entry.kernel_nodes}")
    if (len(names), stems, blocks) != (entry.kernel_nodes, 1, 2):
        raise SystemExit("path 18: a bare replay did not launch the "
                         "captured kernels")
    res["profiled_kernels"] = len(names)
    # leg 1's programs: PLAIN takes a new entry with no stage64 launch
    x8 = requests[8]
    n0 = len(prog._cache)
    prog.op_overrides = PLAIN
    try:
        st.LAUNCHES.clear()
        yp = [prog(x8).cpu().numpy() for _ in range(2)]
        plain_text = prog.lowered_text(x8)
        check_counts("path 18 PLAIN entry stage64 launches",
                     dict(st.LAUNCHES), {})
        if len(prog._cache) != n0 + 1:
            raise SystemExit("path 18: PLAIN did not take a new entry")
    finally:
        prog.op_overrides = {}
    yk = prog(x8).cpu().numpy()
    if len(prog._cache) != n0 + 1:
        raise SystemExit("path 18: back on {} the program took a new entry")
    stage_line = [ln for ln in plain_text.splitlines()
                  if ": stage64 [" in ln]
    log(f"path 18 PLAIN entry: {stage_line}; kernels vs plain "
        f"{'bit-identical' if np.array_equal(yp[0], yk) else 'differ'}")
    if not (stage_line and "plain[stem_kernel x1 + block_kernel x2]"
            in stage_line[0]) or not np.array_equal(yp[0], yp[1]):
        raise SystemExit("path 18: the PLAIN entry does not run the plain "
                         "versions")
    # fresh outputs: a later replay at the same signature with other images
    xa = requests[64]
    xb = np.ascontiguousarray(requests[64][::-1])
    ya = net.forward(xa)
    keep = ya.clone()
    yb = net.forward(xb)
    torch.cuda.synchronize()
    if not torch.equal(ya, keep) or torch.equal(ya, yb):
        raise SystemExit("path 18: a later replay changed an earlier answer")
    log("path 18: an answer handed out is unchanged by a later replay")
    res["steps"] = {}
    for b in (1, 64):
        xd = torch.as_tensor(requests[b], device="cuda")
        reps = 50 if b == 1 else 20
        row = {"replay_ms": cuda_ms(lambda: prog(xd), reps, warmup=5),
               "eager_ms": cuda_ms(lambda: prog._run(xd), reps, warmup=5),
               "replay_host_ms": host_ms(torch, lambda: prog(xd), reps),
               "eager_host_ms": host_ms(torch, lambda: prog._run(xd), reps)}
        res["steps"][b] = row
        log(f"path 18 step b{b}: replay {row['replay_ms']:.4f} ms, eager "
            f"{row['eager_ms']:.4f} ms (CUDA events); host clock replay "
            f"{row['replay_host_ms']:.4f} ms, eager "
            f"{row['eager_host_ms']:.4f} ms (printed, no claim; {card})")
    return res


# --------------------------------------------------------------------------
# YOLO-v3 (paths 8 and 9) and UNet (path 10)
# --------------------------------------------------------------------------

YOLO_SIDE, UNET_SIDE = 416, 512
# the leg-3 bounds of paths 8 and 10 (ResNet's paths: 0.05).  On these
# random-weight nets the JAX package's own programs sit as far from the
# float32 executor as the port's (tests/test_torch_yolo.py and
# test_torch_unet.py hold the two gaps together at 128 on the CPU), and
# farther than 0.05 at the chip's sides: static W8A8 YOLO-v3 at 416, b8,
# read p99 0.19 (its s8 convs quantize activations the 4 calibration
# images do not cover), bf16 UNet at 512 0.08.
LEG3_YOLO_W8A8 = 0.25
LEG3_UNET_BF16 = 0.1


def yolo_shapes(b, classes=80):
    return [(b, 3 * (5 + classes), YOLO_SIDE // s, YOLO_SIDE // s)
            for s in (32, 16, 8)]


def tame(net, f=0.02):
    """The detection heads scaled by f, so an untrained YOLO-v3 emits
    anchor-sized boxes (tests/test_accuracy.py's _tame_heads)."""
    idx = net.graph.init_index()
    for name, i in idx.items():
        if name.startswith("det") and name.endswith((".w", ".b")):
            net.weights[i] = (net.weights[i] * f).astype(np.float32)
    net._invalidate()
    return net


def check_detections(dets, n, size, conf):
    """detect's answers: one (k, 6) array per image of [x1, y1, x2, y2,
    score, class] inside the image, scores at the threshold or above."""
    if len(dets) != n:
        raise SystemExit(f"detect: {len(dets)} answers for {n} images")
    for d in dets:
        if d.ndim != 2 or d.shape[1] != 6 or not np.isfinite(d).all():
            raise SystemExit(f"detect: bad answer {d.shape}")
        x1, y1, x2, y2, sc, cls = d.T
        if len(d) and not ((0 <= x1).all() and (x1 <= x2).all()
                           and (x2 <= size).all() and (0 <= y1).all()
                           and (y1 <= y2).all() and (y2 <= size).all()
                           and (sc >= conf).all()
                           and (cls == np.round(cls)).all()):
            raise SystemExit("detect: a box outside the image or the "
                             "threshold")
    return sum(len(d) for d in dets)


def yolo_static_path(torch, models, calibrate, synthetic_images, card,
                     counters, profile):
    """Path 8: YOLO-v3 at 416, 80 classes, static W8A8 (the JAX package's
    model_bench recipe: optimize, calibrate on synthetic images from seed
    11, quantize("int8", activations="static"), bf16), its detection heads
    tamed x0.02 so the untrained net gives boxes that survive the filters,
    answering b1, b8 and b16 through __call__ and run.  No hand kernel is
    on this path: it runs the port's torch ops (the s8 convs as
    torch._int_mm).  Leg 3 holds the three raw heads to the float32
    executor on 8 images: p99 over images of max|d|/max|y| at most
    LEG3_YOLO_W8A8, with no argmax term.  Then detect (host decode,
    native score filter and NMS) on the b8 requests, and step times."""
    from planer_tpu_torch.models import yolo_post
    t0 = time.perf_counter()
    net = tame(models.yolov3(seed=SEED, device="cuda"))
    net.optimize()
    calibrate(net, synthetic_images(4, (3, YOLO_SIDE, YOLO_SIDE), seed=11,
                                    batch=2))
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    log(f"yolov3 W8A8 static at {YOLO_SIDE} built: "
        f"{time.perf_counter() - t0:.1f} s")
    requests = {b: next(synthetic_images(b, (3, YOLO_SIDE, YOLO_SIDE),
                                         seed=400 + b, batch=b))
                for b in (1, 8, 16)}
    _, fwd, counts = drive(net, requests, counters, yolo_shapes, "path 8")
    check_counts("path 8 hand-kernel launches and fall-offs",
                 {k: v for c in counts for k, v in c.items()}, {})
    imgs = list(synthetic_images(8, (3, YOLO_SIDE, YOLO_SIDE), seed=29,
                                 batch=8))
    leg3 = agreement([(flat(net(x)), flat(net(x, engine="oracle")))
                      for x in imgs],
                     "path 8 yolov3 W8A8 static vs float32 executor (three "
                     "raw heads)", LEG3_YOLO_W8A8, logits=False)
    t0 = time.perf_counter()
    dets = yolo_post.detect(net, requests[8], conf_thresh=0.25)
    boxes = check_detections(dets, 8, YOLO_SIDE, 0.25)
    if not boxes:
        raise SystemExit("path 8: detect found no box, so NMS did not run")
    log(f"path 8 detect (b8: forward, host decode, native score filter and "
        f"NMS): {boxes} boxes in {1e3 * (time.perf_counter() - t0):.1f} ms")
    steps = step_times(torch, net, requests, "path 8 yolov3 W8A8 static",
                       card, (1, 8, 16))
    if profile:
        profile_steps(torch, net.program, requests, card, profile,
                      "yolov3_w8a8", (1, 16))
    return {"forwards": fwd, "leg3": leg3, "boxes": boxes, "steps": steps,
            "requests": requests, "imgs": imgs}


def yolo_route_path(torch, models, tops, ev, card, counters, p8, profile):
    """Path 9: weight-only INT8 YOLO-v3 at 416 (bf16) with the 1x1 route:
    31 dense_q launches per forward at b1 and b8, the plain-version leg
    (p99 <= 0.02) and the float32-executor leg (p99 <= 0.05), the route-off
    step beside the route-on one in turns; then the detection-agreement
    gate at tests/test_accuracy.py's settings (8 classes, 256, 4 images,
    heads tamed x0.02, conf 0.25, min_margin 0.05, hysteresis 0.7): f1 >=
    0.95 over more than 200 reference boxes, self-agreement 1.0; and,
    printed only, the f1 at 416 with 80 classes."""
    from planer_tpu_torch.device import float32_exact
    t0 = time.perf_counter()
    net = models.yolov3(seed=SEED, device="cuda")
    net.optimize()
    net.quantize("int8")
    net.astype_compute("bfloat16")
    log(f"yolov3 weight-only int8 built: {time.perf_counter() - t0:.1f} s")
    req = {b: p8["requests"][b] for b in (1, 8)}
    kw = dict(conf_thresh=0.25, min_margin=0.05, hysteresis=0.7,
              iou_hysteresis=0.7)
    tops._PALLAS_CONV1X1 = True
    try:
        answers, fwd, (lq, *others) = drive(net, req, counters, yolo_shapes,
                                            "path 9")
        check_counts("path 9 dense_q launches", lq, {"dense_q": 31 * fwd})
        check_counts("path 9 other hand-kernel launches",
                     {k: v for c in others for k, v in c.items()}, {})
        leg1 = plain_leg(net, req, answers,
                         "path 9 kernels vs plain dense_q (same program)",
                         logits=False)
        leg3 = agreement([(flat(net(x)), flat(net(x, engine="oracle")))
                          for x in p8["imgs"]],
                         "path 9 yolov3 weight-only int8 vs float32 executor "
                         "(three raw heads)", 0.05, logits=False)
        t0 = time.perf_counter()
        fp = tame(models.yolov3(num_classes=8, seed=SEED, device="cuda"))
        q = tame(models.yolov3(num_classes=8, seed=SEED, device="cuda"))
        q.optimize()
        q.quantize("int8")
        # float means float32 in the agreement nets (as in the executor)
        with float32_exact():
            det = ev.detection_agreement(fp, q, n=4, size=256, **kw)
            self_det = ev.detection_agreement(fp, fp, n=2, size=256, **kw)
        log(f"path 9 detection agreement (8 classes, 256, float vs "
            f"weight-only int8 with the route): {det}; self-agreement "
            f"{self_det['f1']} ({time.perf_counter() - t0:.1f} s)")
        if det["tp"] + det["fn"] <= 200 or det["f1"] < 0.95 \
                or self_det["f1"] != 1.0:
            raise SystemExit(f"path 9 detection agreement: {det}, self "
                             f"{self_det}")
        fp = tame(models.yolov3(seed=SEED, device="cuda"))
        q = tame(models.yolov3(seed=SEED, device="cuda"))
        q.optimize()
        q.quantize("int8")
        with float32_exact():
            det416 = ev.detection_agreement(fp, q, n=4, size=YOLO_SIDE,
                                            **kw)
        log(f"path 9 detection agreement at {YOLO_SIDE}, 80 classes "
            f"(printed, not gated): {det416}")
        del fp, q
    finally:
        tops._PALLAS_CONV1X1 = False
    steps = {"on": [], "off": []}
    for route in ("on", "off", "off", "on"):
        tops._PALLAS_CONV1X1 = route == "on"
        try:
            steps[route].append(step_times(
                torch, net, req, f"path 9 yolov3 weight-only, 1x1 route "
                f"{route}", card, (1, 8)))
            if profile and route == "on" and not steps["off"]:
                profile_steps(torch, net.program, req, card, profile,
                              "yolov3_weight_only_route", (1, 8))
        finally:
            tops._PALLAS_CONV1X1 = False
    return {"forwards": fwd, "launches": lq["dense_q"], "leg1": leg1,
            "leg3": leg3, "f1": det["f1"], "f1_416": det416["f1"],
            "steps": steps}


def unet_path(torch, models, synthetic_images, card, counters, profile):
    """Path 10: UNet (base 32, depth 4, 1 -> 1 channels) at 512,
    weight-only INT8, bf16 (the JAX package's model_bench recipe): the
    whole image at b1 through __call__ and run (convtranspose decoder), the
    float32-executor leg on 8 images (p99 <= LEG3_UNET_BF16), the tiled run
    (window 256, margin 64, glob 16, 9 windows) timed and its gap to the
    whole image printed, and step times.  The tiled-vs-whole gate runs as
    tests/test_models.py:227-248 runs it, on its net (UNet base 16, 1 -> 2
    channels, float32) and its white-noise 512 image: median err / scale <
    2e-3, mean < 2e-2.  Path 10's own net is printed, not gated, in bf16
    and in float32 compute: its seams (the depth-4 receptive field cut at
    the window edges, relative to one sigmoid channel) exceed those bounds
    in both, with the reference's blend (tests/test_torch_unet.py holds the
    two tiles equal)."""
    from planer_tpu_torch.utils.tile import tile
    t0 = time.perf_counter()
    net = models.unet(in_ch=1, out_ch=1, base=32, depth=4, seed=SEED,
                      device="cuda")
    net.optimize()
    net.quantize("int8")
    net.astype_compute("bfloat16")
    log(f"unet weight-only int8 built: {time.perf_counter() - t0:.1f} s")
    shape = (1, UNET_SIDE, UNET_SIDE)
    req = {1: next(synthetic_images(1, shape, seed=501, batch=1))}
    answers, fwd, counts = drive(net, req, counters,
                                 lambda b: [(b, *shape)], "path 10")
    check_counts("path 10 hand-kernel launches and fall-offs",
                 {k: v for c in counts for k, v in c.items()}, {})
    imgs = list(synthetic_images(8, shape, seed=29, batch=4))
    leg3 = agreement([(flat(net(x)), flat(net(x, engine="oracle")))
                      for x in imgs],
                     "path 10 unet weight-only int8 vs float32 executor",
                     LEG3_UNET_BF16, logits=False)

    def tiled_vs_whole(unet, img):
        def run(win2d):     # tile blends (H, W[, C]) images: channels last
            return np.asarray(unet(win2d[None, None]))[0].transpose(1, 2, 0)
        whole = run(img)
        t0 = time.perf_counter()
        tiled = tile(window=256, margin=64, glob=16)(run)(img)
        ms = 1e3 * (time.perf_counter() - t0)
        if tiled.shape != whole.shape or not np.isfinite(tiled).all():
            raise SystemExit(f"path 10: tiled {tiled.shape}, whole "
                             f"{whole.shape}")
        err, scale = np.abs(tiled - whole), np.abs(whole).max() + 1e-9
        return float(np.median(err) / scale), float(err.mean() / scale), ms

    med, mean, tiled_ms = tiled_vs_whole(net, req[1][0, 0])
    net.astype_compute(None)
    fmed, fmean, _ = tiled_vs_whole(net, req[1][0, 0])
    net.astype_compute("bfloat16")
    log(f"path 10 tiled (9 windows of 256, margin 64) vs whole at "
        f"{UNET_SIDE}: median err/scale {med:.6g}, mean {mean:.6g}; in "
        f"float32 compute {fmed:.6g}, {fmean:.6g} (printed, not gated); "
        f"tiled run {tiled_ms:.1f} ms on the host clock ({card})")
    ref = models.unet(in_ch=1, out_ch=2, base=16, depth=4, seed=SEED,
                      device="cuda")
    noise = np.random.default_rng(42).standard_normal(
        (UNET_SIDE, UNET_SIDE)).astype(np.float32)
    gmed, gmean, _ = tiled_vs_whole(ref, noise)
    log(f"path 10 tiled vs whole, tests/test_models.py's net and image "
        f"(UNet base 16, 1 -> 2, float32, white noise): median err/scale "
        f"{gmed:.6g} (< 2e-3), mean {gmean:.6g} (< 2e-2)")
    if not gmed < 2e-3 or not gmean < 2e-2:
        raise SystemExit("path 10: tiled and whole images disagree")
    steps = step_times(torch, net, req, "path 10 unet weight-only", card,
                       (1,))
    if profile:
        profile_steps(torch, net.program, req, card, profile,
                      "unet_weight_only", (1,))
    return {"forwards": fwd, "leg3": leg3, "tiled": (med, mean),
            "tiled_f32": (fmed, fmean), "tiled_gate": (gmed, gmean),
            "tiled_ms": tiled_ms, "steps": steps}


# --------------------------------------------------------------------------
# the frontends (paths 11 and 12) and the op library (path 13)
# --------------------------------------------------------------------------

def resnet18_module(seed=SEED):
    """A torchvision-layout ResNet-18 ``nn.Module`` (BasicBlocks with a
    conv + BatchNorm downsample, the shortcut added after the second BN)
    with weights and BatchNorm running statistics from a seeded
    ``torch.Generator``: He-scaled convs, BN gains near 1, running means
    and variances away from their defaults, so the fold does real work."""
    import torch
    from torch import nn

    class BasicBlock(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            identity = x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            if self.downsample is not None:
                identity = self.downsample(x)
            out += identity
            return self.relu(out)

    class ResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            cin = 64
            for i, c in enumerate((64, 128, 256, 512)):
                s = 1 if i == 0 else 2
                setattr(self, f"layer{i + 1}", nn.Sequential(
                    BasicBlock(cin, c, s), BasicBlock(c, c, 1)))
                cin = c
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
            self.fc = nn.Linear(512, 1000)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            return self.fc(torch.flatten(self.avgpool(x), 1))

    g = torch.Generator().manual_seed(seed)

    def randn(shape, scale, shift=0.0):
        return torch.randn(shape, generator=g) * scale + shift

    m = ResNet18().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] ** 2
                mod.weight.copy_(randn(mod.weight.shape,
                                       (2.0 / fan_in) ** 0.5))
            elif isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.copy_(randn(c, 0.1, 1.0))
                mod.bias.copy_(randn(c, 0.1))
                mod.running_mean.copy_(randn(c, 0.1))
                mod.running_var.copy_(
                    0.8 + 0.4 * torch.rand(c, generator=g))
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(randn(mod.weight.shape, 512 ** -0.5))
                mod.bias.copy_(randn(1000, 0.1))
    return m


def _attrs(P, **attrs):
    """ONNX attributes from Python values (int, float, str, int list)."""
    out = []
    for k, v in attrs.items():
        if isinstance(v, bool) or isinstance(v, int):
            out.append(P.AttributeProto(name=k, i=int(v), type=P.ATTR.INT))
        elif isinstance(v, float):
            out.append(P.AttributeProto(name=k, f=v, type=P.ATTR.FLOAT))
        elif isinstance(v, str):
            out.append(P.AttributeProto(name=k, s=v.encode(),
                                        type=P.ATTR.STRING))
        elif isinstance(v, np.ndarray):
            out.append(P.AttributeProto(name=k, t=P.from_array(v),
                                        type=P.ATTR.TENSOR))
        else:
            out.append(P.AttributeProto(name=k, ints=[int(i) for i in v],
                                        type=P.ATTR.INTS))
    return out


class OnnxWriter:
    """A node-by-node ONNX graph written with the port's protobuf codec
    (``planer_tpu_torch.frontend.onnx_proto``): no ``onnx`` package."""

    def __init__(self):
        from planer_tpu_torch.frontend import onnx_proto as P
        self.P, self.nodes, self.inits = P, [], []

    def init(self, name, array):
        self.inits.append(self.P.from_array(np.asarray(array), name))
        return name

    def node(self, op, ins, n_out=1, out=None, **attrs):
        name = f"{op.lower()}_{len(self.nodes)}"
        outs = ([out] if out else
                [f"{name}_{i}" for i in range(n_out)])
        self.nodes.append(self.P.NodeProto(
            input=list(ins), output=outs, name=name, op_type=op,
            attribute=_attrs(self.P, **attrs)))
        return outs[0] if len(outs) == 1 else tuple(outs)

    def model(self, inputs, outputs, opset=13):
        """``inputs`` and ``outputs``: (name, shape) pairs (f32)."""
        P = self.P
        g = P.GraphProto(
            node=self.nodes, name="g", initializer=self.inits,
            input=[P.ValueInfoProto(n, 1, list(s)) for n, s in inputs],
            output=[P.ValueInfoProto(n, 1, list(s)) for n, s in outputs])
        return P.ModelProto(graph=g, opset=opset, producer_name="chip_smoke")


def resnet18_onnx(module, path):
    """Write ``resnet18_module``'s weights as an opset-13 ONNX model, node
    by node: Conv, BatchNormalization, Relu, MaxPool, Add,
    GlobalAveragePool, Flatten, Gemm (transB = 1, torch's (O, I) weight)."""
    w = OnnxWriter()

    def t(name, p):
        return w.init(name, p.detach().cpu().numpy())

    def conv(x, m, name):
        k, s, p = m.kernel_size, m.stride, m.padding
        return w.node("Conv", [x, t(f"{name}.weight", m.weight)],
                      kernel_shape=k, strides=s, pads=[p[0], p[1]] * 2,
                      dilations=[1, 1], group=1)

    def bn(x, m, name):
        return w.node("BatchNormalization", [x] + [
            t(f"{name}.{k}", getattr(m, k))
            for k in ("weight", "bias", "running_mean", "running_var")],
            epsilon=float(m.eps))

    x = w.node("Relu", [bn(conv("x", module.conv1, "conv1"), module.bn1,
                           "bn1")])
    x = w.node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2],
               pads=[1, 1, 1, 1])
    for li in range(1, 5):
        for bi, blk in enumerate(getattr(module, f"layer{li}")):
            pre = f"layer{li}.{bi}"
            y = w.node("Relu", [bn(conv(x, blk.conv1, f"{pre}.conv1"),
                                   blk.bn1, f"{pre}.bn1")])
            y = bn(conv(y, blk.conv2, f"{pre}.conv2"), blk.bn2, f"{pre}.bn2")
            if blk.downsample is not None:
                x = bn(conv(x, blk.downsample[0], f"{pre}.downsample.0"),
                       blk.downsample[1], f"{pre}.downsample.1")
            x = w.node("Relu", [w.node("Add", [y, x])])
    x = w.node("Flatten", [w.node("GlobalAveragePool", [x])], axis=1)
    w.node("Gemm", [x, t("fc.weight", module.fc.weight),
                    t("fc.bias", module.fc.bias)], out="y", transB=1)
    w.P.save_model(w.model([("x", ["N", 3, 224, 224])],
                           [("y", ["N", 1000])]), path)
    return path


def op_weights(net):
    """The weight arrays each conv, dense and fused-stage application reads,
    in flow order: what two imports of one model must agree on."""
    g, lm = net.graph, net.graph.layer_map()
    idx = g.init_index()
    out = []
    for e in g.flow:
        for li, lname in enumerate(e.layers):
            if lm[lname].op in ("conv", "dense", "stage64", "stagen"):
                src = e.src if li == 0 else e.dst
                for s in src[1:]:
                    if s in idx:
                        out.append(net.weights[idx[s]])
                        info = g.quant.get(s)
                        if info:
                            out.append(net.weights[idx[info["scale"]]])
    return out


def frontend_path(torch, pt, calibrate, synthetic_images, label, path,
                  requests, imgs, counters, card, module):
    """Paths 11 and 12: read_net on the card -> optimize -> calibrate on 4
    synthetic images -> quantize("int8", activations="static") -> bf16;
    one stage64, the stem and block launches per forward, leg 1
    bit-identical, leg 3 against the float32 executor, and the unquantized
    import in float32 against the module's own forward (TF32 off: the
    module runs outside the port, under ``float32_exact``)."""
    from planer_tpu_torch.device import float32_exact
    t0 = time.perf_counter()
    fnet = pt.read_net(path)                   # device="cuda" by default
    with torch.no_grad(), float32_exact():
        rels = []
        for x in imgs[:2]:
            ref = module(torch.as_tensor(x, device="cuda")).cpu().numpy()
            rels.append(float(np.abs(fnet(x) - ref).max()
                              / np.abs(ref).max()))
    log(f"{label} import: the unquantized net in float32 vs the module's "
        f"own forward on the card (TF32 off), max|d|/max|y| per batch of "
        f"16: {rels}")
    if max(rels) > 1e-4:
        raise SystemExit(f"{label}: the imported net is {max(rels)} away "
                         f"from the module")
    net = pt.read_net(path)
    net.optimize()
    calibrate(net, synthetic_images(4, (3, 224, 224), seed=11, batch=2))
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    log(f"{label} built: {time.perf_counter() - t0:.1f} s")
    if sum(l.op == "stage64" for l in net.graph.layers) != 1:
        raise SystemExit(f"{label}: the entry stage was not fused")
    answers, fwd, (launches, falloff) = drive(net, requests, counters,
                                              label=label, same=True)
    check_counts(f"{label} stage64 launches", launches, {
        "stem_pool_requant": fwd, "basic_block": fwd,
        "basic_block_last": fwd})
    check_counts(f"{label} stage64 falloff", falloff, {})
    leg1 = plain_leg(net, requests, answers, f"{label} kernels vs plain "
                     f"stage64 (same program)", need_same=True)
    leg3 = agreement([(net(x), net(x, engine="oracle")) for x in imgs],
                     f"{label} vs float32 executor", 0.05)
    steps = step_times(torch, net, requests, label, card)
    return {"net": net, "answers": answers, "launches": launches,
            "forwards": fwd, "import": max(rels), "leg1": leg1,
            "leg3": leg3, "steps": steps}


def frontend_paths(torch, pt, models_net, calibrate, synthetic_images,
                   requests, imgs, counters, card, work):
    """Path 11 (torch2planer) and path 12 (the same module as ONNX bytes)."""
    from collections import Counter
    t0 = time.perf_counter()
    module = resnet18_module().cuda()          # read through .cpu()
    pla = pt.torch2planer(module, os.path.join(work, "r18_fx"))
    onnx = resnet18_onnx(module, os.path.join(work, "r18_onnx.onnx"))
    p11 = frontend_path(torch, pt, calibrate, synthetic_images, "path 11 "
                        "torch2planer resnet18", pla, requests, imgs,
                        counters, card, module)
    ops = Counter(l.op for l in p11["net"].graph.layers)
    want = Counter(l.op for l in models_net.graph.layers)
    log(f"path 11 opcodes {dict(ops)}")
    if ops != want:
        raise SystemExit(f"path 11: opcodes {dict(ops)} are not "
                         f"models.resnet18()'s {dict(want)}")
    p12 = frontend_path(torch, pt, calibrate, synthetic_images, "path 12 "
                        "onnx resnet18", onnx, requests, imgs, counters,
                        card, module)
    a, b = op_weights(p11["net"]), op_weights(p12["net"])
    if len(a) != len(b) or not all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("path 12: the quantized weights are not path 11's")
    same = all(np.array_equal(p11["answers"][k], p12["answers"][k])
               for k in requests)
    log(f"path 12 vs path 11: {len(a)} weight arrays array-equal, logits "
        f"{'bit-identical' if same else 'NOT bit-identical'} on the same "
        f"requests")
    if not same:
        raise SystemExit("path 12: logits differ from path 11's")
    for p in (p11, p12):
        del p["net"]
    log(f"paths 11-12: {time.perf_counter() - t0:.1f} s")
    return p11, p12


# path 13's tolerance classes, by opcode (tests/test_torch_ops_lib.py
# states the CPU tests' own): bit-equal unless listed; transcendental ops
# within 4 f32 ulps of the output's largest magnitude; sum-order ops within
# 1e-6 of it; the GEMM ops within 1e-5
# the op library's opcodes (every opcode of the JAX registry that no model
# builder of the port emits), each of which path 13 must apply
OP_LIBRARY = {
    "abs", "argmax", "argmin", "averagepool", "ceil", "const",
    "constantofshape", "depthtospace", "div", "elu", "equal", "erf", "floor",
    "gelu", "gmp", "greater", "greaterorequal", "gru", "hardsigmoid",
    "identity", "instancenormalization", "log", "logsoftmax", "lstm",
    "matmul", "max", "mean", "min", "neg", "nonzero", "pad", "pow", "prelu",
    "reciprocal", "reducemax", "reducemean", "reducemin", "reduceprod",
    "reducesum", "resize", "round", "scatternd", "sign", "softmax",
    "softplus", "spacetodepth", "split", "sqrt", "squeeze", "sub", "sum",
    "tanh", "tile", "topk", "where"}
TRANSCENDENTAL = {"tanh", "erf", "sqrt", "log", "pow", "elu", "softplus",
                  "gelu"}
SUM_ORDER = {"softmax", "logsoftmax", "instancenormalization", "reducesum",
             "reducemean", "reduceprod"}
GEMM_ORDER = {"matmul", "lstm", "gru"}


def op_zoo(rng):
    """One ONNX graph applying the op library's opcodes (all but ``const``,
    ``lstm``, ``gru`` and ``nonzero``, which have graphs of their own) to
    x (2, 8, 12, 12); returns (model, [(output, opcode)])."""
    w, outs = OnnxWriter(), []

    def f32(a):
        return np.asarray(a, np.float32)

    def i64(a):
        return np.asarray(a, np.int64)

    def out(opcode, name):
        for n in (name if isinstance(name, tuple) else (name,)):
            outs.append((n, opcode))
        return name

    def op(opcode, onnx_op, ins, n_out=1, **attrs):
        return out(opcode, w.node(onnx_op, ins, n_out, **attrs))

    x = "x"
    a = op("abs", "Abs", [x])
    xp = w.node("Add", [a, w.init("c01", f32(0.1))])
    ng = op("neg", "Neg", [x])
    fl = op("floor", "Floor", [x])
    ce = op("ceil", "Ceil", [x])
    rd = op("round", "Round", [x])
    op("sign", "Sign", [x])
    op("sub", "Sub", [x, ng])
    op("div", "Div", [x, xp])
    op("reciprocal", "Reciprocal", [xp])
    op("pow", "Pow", [xp, w.init("c17", f32(1.7))])
    op("equal", "Equal", [fl, ce])
    gt = op("greater", "Greater", [x, ng])
    op("greaterorequal", "GreaterOrEqual", [fl, rd])
    op("where", "Where", [gt, x, ng])
    op("min", "Min", [x, ng, fl])
    op("max", "Max", [x, ng])
    op("sum", "Sum", [x, ng, a])
    op("mean", "Mean", [x, a, xp])
    op("prelu", "PRelu", [x, w.init("slope", f32(rng.random(8) * 0.3))])
    op("hardsigmoid", "HardSigmoid", [x], alpha=0.2, beta=0.5)
    op("tanh", "Tanh", [x])
    op("erf", "Erf", [x])
    op("sqrt", "Sqrt", [xp])
    op("log", "Log", [xp])
    op("elu", "Elu", [x], alpha=0.7)
    op("softplus", "Softplus", [x])
    op("gelu", "Gelu", [x])
    op("gelu", "Gelu", [x], approximate="tanh")
    op("softmax", "Softmax", [x], axis=1)
    op("logsoftmax", "LogSoftmax", [x], axis=-1)
    op("instancenormalization", "InstanceNormalization",
       [x, w.init("in_s", f32(0.5 + rng.random(8))),
        w.init("in_b", f32(rng.standard_normal(8)))], epsilon=1e-5)
    op("reducesum", "ReduceSum", [a], axes=[2, 3])
    op("reducemean", "ReduceMean", [a], axes=[1], keepdims=0)
    op("reducemax", "ReduceMax", [x], axes=[3])
    op("reducemin", "ReduceMin", [x], axes=[0, 2])
    q = w.node("Add", [w.node("Mul", [a, w.init("c03", f32(0.05))]),
                       w.init("c09", f32(0.9))])
    op("reduceprod", "ReduceProd", [q], axes=[3])
    gm = op("gmp", "GlobalMaxPool", [x])
    op("matmul", "MatMul", [x, w.init("mm_w", f32(
        rng.standard_normal((12, 7)) * 0.3))])
    op("averagepool", "AveragePool", [x], kernel_shape=[3, 3],
       strides=[2, 2], pads=[1, 1, 1, 1])
    op("averagepool", "AveragePool", [x], kernel_shape=[3, 3],
       strides=[2, 2], ceil_mode=1, count_include_pad=1)
    op("split", "Split", [x, w.init("split", i64([3, 5]))], 2, axis=1)
    op("tile", "Tile", [x, w.init("reps", i64([1, 1, 2, 1]))])
    op("pad", "Pad", [x, w.init("pads", i64([0, 0, 1, 2, 0, 0, 2, 1])),
                      w.init("padv", f32(0.5))])
    op("pad", "Pad", [x, w.init("pads2", i64([0, 0, 2, 1, 0, 0, 1, 2]))],
       mode="reflect")
    op("squeeze", "Squeeze", [gm, w.init("sq_axes", i64([2, 3]))])
    op("constantofshape", "ConstantOfShape", [w.init("cs_shape",
                                                     i64([2, 3]))],
       value=f32([2.5]))
    op("scatternd", "ScatterND", [
        x, w.init("sc_idx", i64([[0, 1], [1, 7], [0, 3]])),
        w.init("sc_upd", f32(rng.standard_normal((3, 12, 12))))])
    op("spacetodepth", "SpaceToDepth", [x], blocksize=2)
    op("depthtospace", "DepthToSpace", [x], blocksize=2)
    op("depthtospace", "DepthToSpace", [x], blocksize=2, mode="CRD")
    op("topk", "TopK", [x, w.init("k", i64([3]))], 2, axis=-1)
    op("argmax", "ArgMax", [x], axis=1)
    op("argmin", "ArgMin", [x], axis=2, keepdims=0, select_last_index=1)
    op("resize", "Resize", [x, "", w.init("rs_scales", f32(
        [1, 1, 1.5, 2.0]))], mode="linear")
    op("resize", "Resize", [x, "", "", w.init("rs_sizes", i64(
        [2, 8, 17, 7]))], mode="nearest",
       coordinate_transformation_mode="asymmetric", nearest_mode="floor")
    op("identity", "Identity", [x])
    op("identity", "Dropout", [x])
    names = [n for n, _ in outs]
    return w.model([("x", [2, 8, 12, 12])], [(n, []) for n in names]), outs


def const_graph():
    """``const`` has no ONNX op (the converter folds Constant nodes into
    the weight table): a GraphBuilder graph x * const + const."""
    from planer_tpu_torch.models.builder import GraphBuilder
    b = GraphBuilder(["x"])
    c = b.const(value=np.linspace(0.5, 1.5, 8).reshape(8, 1, 1).tolist(),
                dtype="float32")
    k = b.const(value=3, dtype="int64")
    b.ret([b.mul("x", c), k])
    g, w = b.build()
    return g, w, [("mul", "mul"), ("const", "const")]


def rnn_onnx(op, rng, lens, L=16, N=8, D=64, H=128):
    """A bidirectional ONNX LSTM or GRU at seq L, batch N, hidden H, with
    ``sequence_lens`` or without."""
    w = OnnxWriter()
    g = {"LSTM": 4, "GRU": 3}[op]

    def p(shape, s):
        return np.asarray(rng.standard_normal(shape) * s, np.float32)

    ins = ["x", w.init("W", p((2, g * H, D), D ** -0.5)),
           w.init("R", p((2, g * H, H), H ** -0.5)),
           w.init("B", p((2, 2 * g * H), 0.1)),
           w.init("lens", np.asarray(rng.integers(1, L + 1, N), np.int32))
           if lens else "",
           w.init("h0", p((2, N, H), 0.5))]
    kw = {"hidden_size": H, "direction": "bidirectional"}
    if op == "GRU":
        kw["linear_before_reset"] = 1
    outs = w.node(op, ins, 3 if op == "LSTM" else 2, **kw)
    opcode = op.lower()
    return (w.model([("x", [L, N, D])], [(n, []) for n in outs]),
            [(n, opcode) for n in outs])


def tail_onnx():
    """x -> Relu -> NonZero (the cut) -> Cast -> ReduceSum -> TopK: the
    program runs the relu on the card and the rest in the float32
    executor (the host tail)."""
    w = OnnxWriter()
    nz = w.node("NonZero", [w.node("Relu", ["x"])])
    rs = w.node("ReduceSum", [w.node("Cast", [nz], to=1)], axes=[0],
                keepdims=0)
    vals, idx = w.node("TopK", [rs, w.init("k", np.asarray([5], np.int64))],
                       2)
    outs = [(nz, "nonzero"), (rs, "reducesum"), (vals, "topk"),
            (idx, "topk")]
    return w.model([("x", [2, 8, 12, 12])], [(n, []) for n, _ in outs]), outs


def zoo_gap(out, ref, opcode):
    """(gap, bound) of one output, card against CPU, by the opcode's
    tolerance class; integer, boolean and bit-equal classes need gap 0."""
    a, b = np.asarray(out), np.asarray(ref)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise SystemExit(f"path 13 {opcode}: {a.dtype}{a.shape} on the card, "
                         f"{b.dtype}{b.shape} on the CPU")
    if a.dtype.kind != "f":
        return float((a != b).sum()), 0.0
    big = float(np.abs(b).max()) if b.size else 0.0
    gap = float(np.abs(a.astype(np.float64) - b).max()) if b.size else 0.0
    if opcode in TRANSCENDENTAL:
        return gap, 4 * float(np.spacing(np.float32(big)))
    if opcode in SUM_ORDER:
        return gap, 1e-6 * big
    if opcode in GEMM_ORDER:
        return gap, 1e-5 * big
    return gap, 0.0


def op_library_path(torch, pt, card):
    """Path 13: the op zoo (in both erf modes), a GraphBuilder graph with
    ``const``, bidirectional ONNX LSTM and GRU (seq 16, batch 8, hidden 128,
    one with sequence_lens) and a graph cut at nonzero with topk and
    reducesum in the tail, each on the card against the same graph on the
    port's CPU path.  Prints each opcode's largest gap."""
    from planer_tpu_torch.frontend.onnx_convert import convert_model
    from planer_tpu_torch.ops import modes
    from planer_tpu_torch.runtime.net import Net
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    x = np.asarray(rng.standard_normal((2, 8, 12, 12)) * 2, np.float32)
    cases = []
    model, outs = op_zoo(rng)
    cases.append(("zoo", *convert_model(model), outs, x, ("exact", "lut")))
    g, w, outs = const_graph()
    cases.append(("const", g, w, outs, x, ("exact",)))
    for op, lens in (("LSTM", True), ("GRU", False), ("LSTM", False),
                     ("GRU", True)):
        model, outs = rnn_onnx(op, rng, lens)
        xs = np.asarray(rng.standard_normal((16, 8, 64)), np.float32)
        cases.append((f"{op.lower()}{' lens' if lens else ''}",
                      *convert_model(model), outs, xs, ("exact",)))
    model, outs = tail_onnx()
    cases.append(("tail", *convert_model(model), outs, x, ("exact",)))
    gaps, cut = {}, None
    for name, graph, weights, outs, xin, erf_modes in cases:
        if not isinstance(weights, list):
            from planer_tpu_torch.ir import unpack_weights
            weights = unpack_weights(graph, weights)
        card_net = Net(graph, weights, device="cuda")
        cpu_net = Net(graph, weights, device="cpu")
        if name == "tail":
            cut = card_net.program.plan.cut
            if cut != 1:
                raise SystemExit(f"path 13: the tail graph cuts at {cut}")
        for mode in erf_modes:
            modes.set_erf_mode(mode)
            try:
                got, ref = outputs(card_net(xin)), outputs(cpu_net(xin))
            finally:
                modes.set_erf_mode("exact")
            if len(got) != len(outs) or len(ref) != len(outs):
                raise SystemExit(f"path 13 {name}: {len(got)} outputs, "
                                 f"want {len(outs)}")
            for (oname, opcode), a, b in zip(outs, got, ref):
                key = opcode + ("[lut]" if opcode == "erf" and
                                mode == "lut" else "")
                gap, bound = zoo_gap(a, b, opcode)
                if gap > bound:
                    raise SystemExit(f"path 13 {name} {oname} ({opcode}, erf "
                                     f"{mode}): gap {gap} > {bound}")
                old = gaps.get(key, (0.0, 0.0))
                gaps[key] = (max(old[0], gap), max(old[1], bound))
    covered = {k.split("[")[0] for k in gaps}
    if not OP_LIBRARY <= covered or "erf[lut]" not in gaps:
        raise SystemExit(f"path 13 did not apply "
                         f"{sorted(OP_LIBRARY - covered)}")
    log(f"path 13 card vs CPU path, largest gap (bound) per opcode over "
        f"{len(covered)} opcodes: " + ", ".join(
            f"{k} {g:.3g} ({b:.3g})" for k, (g, b) in sorted(gaps.items())))
    log(f"path 13: {time.perf_counter() - t0:.1f} s (host tail cut at flow "
        f"edge {cut}; {card})")
    return {"gaps": gaps, "opcodes": sorted(covered)}


# --------------------------------------------------------------------------
# paths 14 and 15: the main path served, and the tools
# --------------------------------------------------------------------------

SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)     # Config's serving defaults


def post_npy(url, x):
    """POST one example as .npy bytes; (status, answer)."""
    import io
    import urllib.request
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, np.load(io.BytesIO(resp.read()))


def get_json(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def serve_path(torch, net, st, synthetic_images, card):
    """Path 14: the main path's net behind a ServingEngine (Config's
    serving defaults, the 224 spatial bucket, warm-up) and its HTTP front
    end.  Traffic: (a) 8 client threads x 12 requests in a closed loop,
    alternating 224 x 224 and 200 x 210 images (edge-padded to 224); (b) a
    burst of 32; (c) 4 singles 20 ms apart; (d) 16 POST /predict from 4
    threads, then GET /stats and /health.  Every answer must resolve and
    agree with ``Net.__call__`` on the same padded image at b1 (p99 of
    max|d|/max|y| <= 0.02, margin-filtered argmax equal); the stats must
    add up; stage64 must launch 1 stem and 2 blocks per executed batch,
    warm-up included, and fall off nowhere; /health must report the card.
    Then a second engine at the 220 bucket, off the kernel geometry, must
    show its fall-off in stats()."""
    from concurrent.futures import ThreadPoolExecutor
    from planer_tpu_torch.runtime.http_server import PlanerHTTPServer
    from planer_tpu_torch.runtime.serving import ServingEngine
    sq = list(synthetic_images(48, (3, 224, 224), seed=400, batch=16))
    rect = list(synthetic_images(48, (3, 200, 210), seed=401, batch=16))
    sq, rect = np.concatenate(sq), np.concatenate(rect)
    loop = [sq[i // 2] if i % 2 == 0 else rect[i // 2] for i in range(96)]
    burst = np.concatenate(list(synthetic_images(32, (3, 224, 224),
                                                 seed=402, batch=16)))
    singles = next(synthetic_images(4, (3, 224, 224), seed=403, batch=4))
    web = np.concatenate(list(synthetic_images(16, (3, 224, 224), seed=404,
                                               batch=16)))
    st.LAUNCHES.clear()
    st.FALLOFF.clear()
    served = []                                   # (request, answer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(net, buckets=SERVE_BUCKETS, max_delay_ms=5,
                        hw_buckets=(224,), warmup=True,
                        example_shape=(3, 224, 224))
    try:
        warm_s = time.perf_counter() - t0
        prog = net.program
        warm = [prog._cache.get(prog._key(prog._inputs(
            [np.zeros((b, 3, 224, 224), np.float32)])))
            for b in SERVE_BUCKETS]
        caps = [f"{e.kernel_nodes} kernel nodes in {e.capture_ms:.3f} ms"
                for e in warm if e is not None and e.graph is not None]
        log(f"path 14 warm-up: {warm_s:.3f} s, an entry captured for "
            f"{len(caps)} of buckets {SERVE_BUCKETS} ({', '.join(caps)}), "
            f"{len(prog._cache)} entries in all; "
            f"torch.cuda.max_memory_allocated since the engine's start "
            f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, "
            f"memory_allocated {torch.cuda.memory_allocated() / 2 ** 20:.1f}"
            f" MiB ({card})")
        if not all(e is not None and e.graph is not None for e in warm):
            raise SystemExit("path 14: warm-up left a bucket uncaptured")

        def client(t):                            # (a) closed loop
            return [(x, eng.submit(x).result(timeout=120))
                    for x in loop[t * 12:(t + 1) * 12]]
        with ThreadPoolExecutor(8) as pool:
            for got in pool.map(client, range(8)):
                served += got
        t1 = time.perf_counter()                  # (b) burst
        futs = [eng.submit(x) for x in burst]
        served += [(x, f.result(timeout=120)) for x, f in zip(burst, futs)]
        burst_s = time.perf_counter() - t1
        futs = []                                 # (c) singles
        for x in singles:
            futs.append(eng.submit(x))
            time.sleep(0.02)
        served += [(x, f.result(timeout=120)) for x, f in zip(singles, futs)]
        with PlanerHTTPServer(eng, "127.0.0.1", 0) as srv:   # (d) HTTP
            url = f"http://127.0.0.1:{srv.port}"
            with ThreadPoolExecutor(4) as pool:
                answers = list(pool.map(
                    lambda x: post_npy(f"{url}/predict", x), web))
            code_s, stats_http = get_json(f"{url}/stats")
            code_h, health = get_json(f"{url}/health")
        codes = [c for c, _ in answers] + [code_s, code_h]
        if codes != [200] * len(codes):
            raise SystemExit(f"path 14: HTTP status {codes}")
        served += [(x, a) for x, (_, a) in zip(web, answers)]
        stats = eng.stats()
        launches, falloff = dict(st.LAUNCHES), dict(st.FALLOFF)
    finally:
        eng.close()
    batches = stats["batches"] + len(SERVE_BUCKETS)       # warm-up batches
    log(f"path 14 stats: {stats}")
    if stats["requests"] != 148 or stats_http["requests"] != 148:
        raise SystemExit(f"path 14: {stats['requests']} requests served "
                         f"({stats_http['requests']} by /stats), want 148")
    if not stats["batches"] < stats["requests"] \
            or not 0 < stats["avg_occupancy"] <= 1 \
            or len(eng.stats_data.latencies_ms) != 148:
        raise SystemExit(f"path 14: stats do not add up: {stats}")
    if "fused_stage_falloff" in stats or falloff:
        raise SystemExit(f"path 14: stage64 fell off: {falloff}")
    check_counts("path 14 stage64 launches (1 + 2 per executed batch, "
                 f"{batches} batches with {len(SERVE_BUCKETS)} warm-up)",
                 launches, {"stem_pool_requant": batches,
                            "basic_block": batches,
                            "basic_block_last": batches})
    want = "cuda:0" if net.device.type == "cuda" else str(net.device)
    if not health["healthy"] or not health["devices"].get(want, {}).get("ok"):
        raise SystemExit(f"path 14: /health {health}")
    log(f"path 14 /health: {health}")
    if len(served) != 148:
        raise SystemExit(f"path 14: {len(served)} answers for 148 requests")
    ys, refs = [], []
    for x, y in served:
        pad = [(0, 0), (0, 224 - x.shape[1]), (0, 224 - x.shape[2])]
        refs.append(net(np.pad(x, pad, mode="edge")[None])[0])
        ys.append(y)
    leg = agreement([(np.stack(ys), np.stack(refs))], "path 14 served "
                    "answers vs Net.__call__ at b1 on the padded image", 0.02)

    # the control: a bucket off the stage64 geometry falls off, visibly
    st.FALLOFF.clear()
    x220 = next(synthetic_images(1, (3, 220, 220), seed=405, batch=1))[0]
    with ServingEngine(net, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(220,)) as eng220:
        y = eng220.infer(x220)
        stats220 = eng220.stats()
    st.FALLOFF.clear()
    if y.shape != (1000,) or stats220.get("fused_stage_falloff", {}).get(
            "geometry", 0) < 1:
        raise SystemExit(f"path 14: the 220 bucket's fall-off is not in "
                         f"stats(): {stats220}")
    log(f"path 14 control: the 220 bucket reports "
        f"{stats220['fused_stage_falloff']}")
    out = {"p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "occupancy": stats["avg_occupancy"],
           "pad_fraction": stats["pad_fraction"],
           "batches": stats["batches"], "warmup_s": warm_s,
           "burst_img_s": len(burst) / burst_s, "leg": leg,
           "launches": launches}
    log(f"path 14: p50 {out['p50_ms']:.4f} ms, p99 {out['p99_ms']:.4f} ms "
        f"(per request, 148 samples: submit "
        f"to the future's result, the spatial probe included), average "
        f"occupancy {out['occupancy']:.4f}, pad "
        f"fraction {out['pad_fraction']:.4f}, {stats['batches']} batches for "
        f"148 requests, burst of 32 at {out['burst_img_s']:.1f} img/s, "
        f"warm-up {warm_s:.2f} s ({card})")
    return out


def tools_path(torch, pt, net, requests, step64_ms, synthetic_images, card,
               profile_dir):
    """Path 15: the profiling and quantization tools on the card.
    (1) ``profiler.cost_report`` of the main path at b64 beside the
    measured b64 step: flops > 0, ideal time below the step; (2)
    ``profiler.trace`` around two main-path steps: the IR layer names in
    the profiler's events (trace written under ``profile_dir`` with
    ``--profile``); (3) ``Net.timeit`` over ``forward(engine="oracle")`` at
    b8: conv timed; (4) ``layer_quant_errors`` on a float ResNet-18 at 224
    with tests/test_accuracy.py's corrupted layer: it ranks first; (5)
    ``quantize_auto`` on the JAX test's ResNet-18 (16 classes) at 224
    with that test's settings: it returns or raises its RuntimeError, and
    the script says which."""
    import tempfile
    from planer_tpu_torch.quant import layer_quant_errors, quantize_auto
    from planer_tpu_torch.runtime import profiler
    dev = net.device
    x64 = torch.as_tensor(requests[64], device=dev)
    rep = profiler.cost_report(net, x64, chip="h100")
    log(f"path 15 cost_report b64: {rep}; measured b64 step "
        f"{step64_ms:.4f} ms, ideal / step "
        f"{1e3 * rep['ideal_time_s'] / step64_ms:.4f} ({card})")
    if not rep["flops"] > 0 or not 1e3 * rep["ideal_time_s"] < step64_ms:
        raise SystemExit(f"path 15: cost_report {rep} against a "
                         f"{step64_ms} ms step")

    x1 = torch.as_tensor(requests[1], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.trace(profile_dir or tmp) as prof:
            for _ in range(2):
                net.program(x1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    scopes = sorted(n for n in names if n.startswith("layer2.0."))
    log(f"path 15 trace: {len(names)} event names, layer2.0 scopes {scopes}")
    if "layer2.0.conv1" not in names:
        raise SystemExit("path 15: no IR layer name in the trace")

    net.timeit("start")
    net.forward(requests[8], engine="oracle")
    timer = dict(net.timer)
    net.timeit("end")
    log(f"path 15 timeit b8 (float32 executor, device time per op type, "
        f"s): {timer}")
    if not timer.get("conv", 0) > 0:
        raise SystemExit(f"path 15: no conv time in {timer}")

    fnet = pt.models.resnet18(seed=SEED, device=dev)
    fnet.optimize()
    wname = "layer2.0.conv1.w"
    w = fnet.weights[fnet.graph.init_index()[wname]]
    w[0, 0, 0, 0], w[0, 0, 0, 2] = 60.0, -60.0
    fnet._invalidate()
    cal = list(synthetic_images(4, (3, 224, 224), seed=7, batch=2))
    errs = layer_quant_errors(fnet, cal, mode="int8")
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    log(f"path 15 layer_quant_errors: {len(errs)} convs, top {top}")
    if top[0][0] != wname:
        raise SystemExit(f"path 15: {wname} does not rank first: {top}")
    del fnet

    # the JAX test's 16-class head: with 1000 random classes no synthetic
    # image has a top-1 margin of 0.05, and top1_agreement refuses to score
    qnet = pt.models.resnet18(num_classes=16, seed=SEED, device=dev)
    qnet.optimize()
    t0 = time.perf_counter()
    try:
        rep_q = quantize_auto(qnet, mode="int8", budget_top1=0.99,
                              budget_rel=0.05, eval_n=64,
                              eval_shape=(3, 224, 224), min_margin=0.05,
                              max_fallbacks=2)
        outcome = (f"returned: top1 {rep_q['top1']:.4f}, max_rel "
                   f"{rep_q['delta']['max_rel']:.6g}, skip {rep_q['skip']}")
    except RuntimeError as e:
        outcome = f"raised its RuntimeError: {e}"
    log(f"path 15 quantize_auto at 224: {outcome} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"cost_report": rep, "trace_scopes": len(scopes),
            "timer": timer, "top_layer": top[0], "quantize_auto": outcome}


# --------------------------------------------------------------------------
# path 16: the main path served from two worker processes, and the mesh
# --------------------------------------------------------------------------

# a DP worker: loads the main path's .pla, warms up, then serves the
# dispatcher's batches through Net.__call__, logging each batch's rows and
# its stage64 launches and fall-offs
DP_WORKER = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import planer_tpu_torch as pt
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.parallel.dispatcher import run_worker
pla, port, host, logf = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
net = pt.read_net(pla, device="cuda")
net.astype_compute("bfloat16")
net(np.zeros((1, 3, 224, 224), np.float32))           # warm-up, not logged

def serve(x):
    before = dict(st.LAUNCHES)
    y = net(x)
    launches = {k: v - before.get(k, 0) for k, v in st.LAUNCHES.items()
                if v != before.get(k, 0)}
    with open(logf, "a") as f:
        f.write(json.dumps({
            "t": time.time(), "n": int(x.shape[0]),
            "rows": [hashlib.sha1(r.tobytes()).hexdigest() for r in x],
            "launches": launches, "falloff": dict(st.FALLOFF)}) + "\n")
    return y

run_worker(("127.0.0.1", port), serve, host_id=host)
"""


def _row_hash(x):
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()


def dp_serving(torch, pt, net, synthetic_images, card, work):
    """Path 16 (1): the main path's net written with ``save_pla`` and read
    back by ``read_net`` in two worker processes on the card, each behind
    ``run_worker`` against a ``Dispatcher`` (buckets 1-32).  64 requests in
    waves of 8, then 6 batches of 8 queued at once with worker 0 killed by
    its PID after the first of them is answered.  Every answer is held against the parent's
    ``Net.__call__`` on the batch it was served in, rebuilt from the
    worker's log (p99 of max|d|/max|y| <= 0.02, argmax equal on decisive
    logits; the bit-identical count printed); every batch a worker served
    launched 1 stem and 2 block kernels and fell off nowhere; the killed
    worker was evicted and its requests answered by the survivor."""
    from planer_tpu_torch.parallel.dispatcher import Dispatcher
    t0 = time.perf_counter()
    pla = pt.save_pla(os.path.join(work, "main_path"), net.graph,
                      net.weights)
    back = pt.read_net(pla, device="cuda")
    back.astype_compute("bfloat16")
    x1 = next(synthetic_images(1, (3, 224, 224), seed=101, batch=1))
    if not np.array_equal(back(x1), net(x1)):
        raise SystemExit("path 16: the .pla round trip changed the program")
    del back
    imgs = np.concatenate(list(synthetic_images(112, (3, 224, 224),
                                                seed=600, batch=16)))
    index = {_row_hash(x): i for i, x in enumerate(imgs)}
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [os.path.join(work, f"worker{i}.jsonl") for i in range(2)]
    errs = [open(os.path.join(work, f"worker{i}.err"), "w") for i in range(2)]
    procs, answers = [], {}
    disp = Dispatcher(buckets=SERVE_BUCKETS, max_delay_ms=5.0,
                      ping_interval_s=0.5, ping_timeout_s=10.0)
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DP_WORKER, root, pla,
                 str(disp.address[1]), f"worker{i}", logs[i]],
                cwd=root, stdout=errs[i], stderr=subprocess.STDOUT))
        try:
            disp.wait_for_workers(2, timeout_s=180)
        except TimeoutError:
            for i, p in enumerate(procs):
                errs[i].flush()
                log(f"worker{i} (exit {p.poll()}):\n" + open(
                    errs[i].name).read()[-3000:])
            raise
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for w in range(0, 64, 8):               # waves of 8
            futs = {i: disp.submit(imgs[i]) for i in range(w, w + 8)}
            answers.update({i: f.result(timeout=120)
                            for i, f in futs.items()})
        wave_s = time.perf_counter() - t1
        spread = {h: s["batches"] for h, s in disp.stats()["workers"].items()}
        futs = {}
        for w in range(64, 112, 8):     # 6 batches queued at once
            futs.update({i: disp.submit(imgs[i]) for i in range(w, w + 8)})
            time.sleep(0.02)
        futs[64].result(timeout=120)
        procs[0].kill()                  # exact child PID, mid-stream
        procs[0].wait(timeout=30)
        answers.update({i: f.result(timeout=120) for i, f in futs.items()})
        deadline = time.monotonic() + 30
        while "worker0" in disp.workers() and time.monotonic() < deadline:
            time.sleep(0.05)
        st_ = disp.stats()
        report = {"requests_before_kill": 64, "requests_after_kill": 48,
                  "batch_spread": spread, "evictions": st_["evictions"],
                  "dp_size_after": st_["dp_size"]}
    finally:
        disp.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in errs:
            f.close()
    log(f"path 16 dispatcher report: {json.dumps(report, default=str)}")
    if report["dp_size_after"] != 1 or len(report["evictions"]) != 1 \
            or report["evictions"][0]["host"] != "worker0":
        raise SystemExit(f"path 16: worker 0 was not evicted alone: {report}")
    if sorted(spread) != ["worker0", "worker1"] or min(spread.values()) < 1:
        raise SystemExit(f"path 16: both workers must serve batches: "
                         f"{spread}")
    if sorted(answers) != list(range(112)):
        raise SystemExit(f"path 16: {len(answers)} answers for 112 requests")
    # every batch a worker served: its rows, launches and fall-offs
    zero = _row_hash(np.zeros_like(imgs[0]))
    batches, per_worker = [], {}
    for i, path in enumerate(logs):
        entries = [json.loads(l) for l in open(path)] \
            if os.path.exists(path) else []
        per_worker[f"worker{i}"] = len(entries)
        for e in entries:
            rows = [index.get(h, -1) if h != zero else None
                    for h in e["rows"]]
            if -1 in rows or e["n"] not in SERVE_BUCKETS:
                raise SystemExit(f"path 16: worker{i} served an unknown "
                                 f"batch of {e['n']}")
            want = {"stem_pool_requant": 1, "basic_block": 1,
                    "basic_block_last": 1}
            if e["launches"] != want or e["falloff"]:
                raise SystemExit(f"path 16: worker{i} batch of {e['n']}: "
                                 f"launches {e['launches']}, fall-off "
                                 f"{e['falloff']}")
            batches.append(rows)
    launches = {k: len(batches) for k in ("stem_pool_requant", "basic_block",
                                          "basic_block_last")}
    log(f"path 16 batches logged per worker {per_worker} ({len(batches)} "
        f"batches, stage64 launches {launches}, 1 stem + 2 blocks each, no "
        f"fall-off)")
    # the parent's Net.__call__ on each served batch, padded as served
    cands = {}
    for rows in batches:
        x = np.stack([imgs[r] if r is not None else np.zeros_like(imgs[0])
                      for r in rows])
        y = net(x)
        for k, r in enumerate(rows):
            if r is not None:
                cands.setdefault(r, []).append(y[k])
    pairs, same = [], 0
    for i in range(112):
        if i not in cands:
            raise SystemExit(f"path 16: request {i} is in no logged batch")
        got = answers[i]
        best = min(cands[i], key=lambda r: float(np.abs(got - r).max()))
        same += int(np.array_equal(got, best))
        pairs.append((got[None], best[None]))
    leg = agreement([(np.concatenate([a for a, _ in pairs]),
                      np.concatenate([b for _, b in pairs]))],
                    "path 16 DP answers vs the parent's Net.__call__ on "
                    "the same padded batch", 0.02)
    rate = 64 / wave_s
    log(f"path 16: {same} of 112 answers bit-identical to the parent's; "
        f"group rate {rate:.1f} img/s over the 64 requests in waves of 8 "
        f"({wave_s:.3f} s, host clock; no claim: two processes sharing "
        f"one card give no scaling figure); workers up in {up_s:.1f} s "
        f"({card})")
    return {"launches": launches, "batches": len(batches), "report": report,
            "bit_identical": same, "leg": leg, "img_s": rate}


def captured_like_run(prog, x, first, again, label):
    """A sharded program's entry at ``x``: captured (a graph with kernel
    nodes), its first call (the warm run) and its replay bit-identical to
    its own eager loop (``Program._run``).  Returns the entry."""
    entry = prog._entry(x)
    eager = prog._run(x).cpu().numpy()
    same = np.array_equal(first, eager) and np.array_equal(again, eager)
    log(f"{label}: captured {entry.graph is not None}, "
        f"{entry.kernel_nodes} kernel nodes in {entry.capture_ms} ms; first "
        f"call and replay {'' if same else 'NOT '}bit-identical to _run")
    if entry.graph is None or not entry.kernel_nodes or not same:
        raise SystemExit(f"{label}: not captured, or a replay is not "
                         f"bit-identical to its _run")
    return entry


def mesh_paths(torch, pt, models, net, requests, st, sg, card):
    """Path 16 (2-4): the main path's net under ``shard_program`` on a
    (2, 4) mesh of cuda:0 at b8 and b64: each entry captured (its first
    call the warm run, the second a replay), both bit-identical to the
    sharded ``_run``, an answer handed out unchanged by a later replay,
    against the unsharded program (p99 <= 0.02, argmax on decisive
    logits), with no stage64 or stagen launch over the sharded calls;
    replay, ``_run`` and unsharded steps printed without a claim.  UNet
    (base 32, depth 4, float32) under (2, 4) ``shard_program`` at b2 of 512
    and under (1, 4) ``shard_spatial`` at b1 of 512, each captured and its
    replay bit-identical to its ``_run``, within 1e-4 and 1e-5 of the
    unsharded program, and ``spatial_conv`` within 1e-4 of one conv of the
    whole image (that conv under ``float32_exact``, as the port's own
    calls run); ``multihost.initialize`` forming an nccl world of one."""
    import socket
    import torch.distributed as dist
    import torch.nn.functional as F
    from planer_tpu_torch.device import float32_exact
    from planer_tpu_torch.parallel import make_mesh, shard_program
    from planer_tpu_torch.parallel.multihost import initialize
    from planer_tpu_torch.parallel.spatial import shard_spatial, spatial_conv
    out = {}
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cuda:0"] * 8)
    snet = pt.Net(net.graph, net.weights, compute_dtype=net.compute_dtype,
                  device="cuda")
    prog = shard_program(snet, mesh)
    reqs = {b: requests[b] for b in (8, 64)}
    st.LAUNCHES.clear()
    sg.LAUNCHES.clear()
    first = {b: snet(x) for b, x in reqs.items()}       # warm run, capture
    sharded = {b: snet(x) for b, x in reqs.items()}     # replays
    check_counts("path 16 stage64 and stagen launches under the (2, 4) "
                 "mesh", {**st.LAUNCHES, **sg.LAUNCHES}, {})
    out["graphs"] = {}
    for b, x in reqs.items():
        entry = captured_like_run(prog, x, first[b], sharded[b],
                                  f"path 16 DP x TP (2, 4) b{b}")
        out["graphs"][b] = (entry.kernel_nodes, entry.capture_ms)
    if len(prog._cache) != len(reqs):
        raise SystemExit(f"path 16: {len(prog._cache)} entries for "
                         f"{len(reqs)} signatures")
    xa = torch.as_tensor(reqs[8], device="cuda")
    ya = prog(xa)
    keep = ya.clone()
    yb = prog(torch.as_tensor(np.ascontiguousarray(reqs[8][::-1]),
                              device="cuda"))
    torch.cuda.synchronize()
    if not torch.equal(ya, keep) or torch.equal(ya, yb):
        raise SystemExit("path 16: a later replay changed an earlier answer")
    log("path 16 DP x TP: an answer handed out is unchanged by a later "
        "replay")
    ref = {b: net(x) for b, x in reqs.items()}
    out["leg"] = agreement([(sharded[b], ref[b]) for b in reqs],
                           "path 16 DP x TP (2, 4) of cuda:0 (replayed) vs "
                           "the unsharded program", 0.02)
    steps = {}
    for b, x in reqs.items():
        xd = torch.as_tensor(x, device="cuda")
        steps[b] = {"replay": cuda_ms(lambda: prog(xd), 10, warmup=2),
                    "run": cuda_ms(lambda: prog._run(xd), 3, warmup=1),
                    "unsharded": cuda_ms(lambda: net.program(xd), 10,
                                         warmup=2)}
        log(f"path 16 DP x TP step b{b}: replay {steps[b]['replay']:.4f} ms,"
            f" _run {steps[b]['run']:.4f} ms, unsharded replay "
            f"{steps[b]['unsharded']:.4f} ms (CUDA events; no claim: 8 "
            f"shards of one card; {card})")
    out["steps"] = steps
    del snet, prog

    rng = np.random.default_rng(7)
    unet = models.unet(in_ch=1, out_ch=1, base=32, depth=4, seed=SEED,
                       device="cuda")
    x2 = rng.standard_normal((2, 1, UNET_SIDE, UNET_SIDE)).astype(np.float32)
    ref2 = unet(x2)
    tp = shard_program(unet, mesh)
    first2 = unet(x2)
    got2 = unet(x2)
    e_tp = captured_like_run(tp, x2, first2, got2,
                             "path 16 UNet shard_program (2, 4) b2")
    d_tp = float(np.abs(got2 - ref2).max())
    unet = models.unet(in_ch=1, out_ch=1, base=32, depth=4, seed=SEED,
                       device="cuda")
    x1 = x2[:1]
    ref1 = unet(x1)
    sp = shard_spatial(unet, make_mesh((1, 4), ("data", "model"),
                                       devices=["cuda:0"] * 4))
    first1 = unet(x1)
    got1 = unet(x1)
    e_sp = captured_like_run(sp, x1, first1, got1,
                             "path 16 UNet shard_spatial (1, 4) b1")
    d_sp = float(np.abs(got1 - ref1).max())
    xc = torch.as_tensor(rng.standard_normal(
        (1, 64, UNET_SIDE, UNET_SIDE)), dtype=torch.float32, device="cuda")
    K = torch.as_tensor(rng.standard_normal((64, 64, 3, 3))
                        * np.sqrt(2 / 576), dtype=torch.float32,
                        device="cuda")
    B = torch.as_tensor(0.1 * rng.standard_normal(64), dtype=torch.float32,
                        device="cuda")
    sc = spatial_conv(xc, K, B, make_mesh((1, 4), ("data", "model"),
                                          devices=["cuda:0"] * 4))
    with float32_exact():
        d_sc = float((sc - F.conv2d(xc, K, B, padding=1)).abs().max())
    log(f"path 16 UNet base 32 depth 4 float32 at {UNET_SIDE}, replayed: "
        f"(2, 4) shard_program b2 max|d| {d_tp:.3g} (<= 1e-4), (1, 4) "
        f"shard_spatial b1 max|d| {d_sp:.3g} (<= 1e-5); spatial_conv 64 -> "
        f"64 3x3 max|d| {d_sc:.3g} (<= 1e-4) ({card})")
    if not (np.allclose(got2, ref2, rtol=1e-4, atol=1e-4)
            and np.allclose(got1, ref1, rtol=1e-5, atol=1e-5)
            and d_sc <= 1e-4):
        raise SystemExit("path 16: a sharded UNet or spatial_conv is off "
                         "its bound")
    out["unet"] = {"tp": d_tp, "spatial": d_sp, "spatial_conv": d_sc,
                   "graphs": {"tp": e_tp.kernel_nodes,
                              "spatial": e_sp.kernel_nodes}}

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    world = initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=60)
    try:
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        log(f"path 16 initialize: {world}, backend {dist.get_backend()}, "
            f"all_reduce of ones {t.tolist()}")
        if world != {"process_index": 0, "process_count": 1,
                     "local_devices": 1} or dist.get_backend() != "nccl" \
                or t.tolist() != [1.0] * 4:
            raise SystemExit(f"path 16: initialize gave {world}")
    finally:
        dist.destroy_process_group()
    out["world"] = world
    return out


# --------------------------------------------------------------------------
# path 17: the user examples
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))

# each example script and the starts of the lines its output must hold
EXAMPLES = {
    "torch_classify_resnet.py": ("top-5 class ids: [", "top-5 scores  : ["),
    "torch_detect_yolov3.py": ("native NMS: True",
                               " detections: [x1 y1 x2 y2 score class]"),
    "torch_segment_unet_tiled.py": ("input  (700, 900) -> mask (700, 900) "
                                    "range [",),
    "torch_serve_continuous.py": ("served 32 requests; stats: {",),
}
DETECT_CONF, DETECT_IOU = 0.3, 0.45     # the detect example's thresholds
DETECT_SIZE = 416                       # and its side


def load_example(name):
    """An example script of ``examples/`` (or the zoo package's directory)
    imported as a module of that name, its ``__main__`` block not run."""
    import importlib.util
    path = os.path.join(ROOT, "examples", name)
    if os.path.isdir(path):
        path = os.path.join(path, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(name)[0], path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def top5_decided(got, ref):
    """The ranks 0-4 of ``ref``'s top-5 whose scores lie further than
    max|got - ref| (the largest difference over all scores) from both
    neighbours', and those of them where ``got``'s top-5 id differs."""
    d = float(np.abs(got - ref).max())
    order = np.argsort(-ref, kind="stable")
    srt = ref[order]
    gtop = np.argsort(-got, kind="stable")[:5]
    decided = [i for i in range(5) if srt[i] - srt[i + 1] > d
               and (i == 0 or srt[i - 1] - srt[i] > d)]
    return decided, [i for i in decided if gtop[i] != order[i]]


def _iou(box, boxes):
    """IoU of one [x1 y1 x2 y2] box with each row of ``boxes``."""
    ix = np.clip(np.minimum(box[2], boxes[:, 2])
                 - np.maximum(box[0], boxes[:, 0]), 0, None)
    iy = np.clip(np.minimum(box[3], boxes[:, 3])
                 - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = ix * iy
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area(box) + area(boxes) - inter + 1e-9)


def detections_agree(got, want, cands, conf=DETECT_CONF, iou=DETECT_IOU,
                     tol=1e-4, box_tol=1e-3):
    """Two ``detect`` answers for one image, (k, 6) rows [x1 y1 x2 y2
    score class], compared away from the thresholds: a row whose score
    lies within ``tol`` of ``conf``, or which overlaps a same-class row of
    ``cands`` (the reference's pre-NMS candidates) that could suppress it
    (a score not below its own, less ``tol``) at an IoU within ``tol`` of
    ``iou``, is left out of both.  The rest must be equal in number and,
    sorted by score, equal in class and within ``box_tol`` of the largest
    coordinate.  Returns (rows compared, rows left out, problems)."""
    def stable(rows):
        keep = np.abs(rows[:, 4] - conf) > tol
        for k, r in enumerate(rows):
            same = cands[(cands[:, 5] == r[5])
                         & (cands[:, 4] >= r[4] - tol)]
            if len(same) and (np.abs(_iou(r, same) - iou) <= tol).any():
                keep[k] = False
        rows = rows[keep]
        return rows[np.argsort(-rows[:, 4], kind="stable")], int(
            (~keep).sum())
    g, g_out = stable(np.asarray(got, np.float32).reshape(-1, 6))
    w, w_out = stable(np.asarray(want, np.float32).reshape(-1, 6))
    if len(g) != len(w):
        return 0, g_out + w_out, [f"{len(g)} detections against {len(w)}"]
    problems = []
    if len(w):
        scale = float(np.abs(w[:, :4]).max()) or 1.0
        d = float(np.abs(g[:, :5] - w[:, :5]).max()) / scale
        if d > box_tol:
            problems.append(f"boxes max|d|/max|y| {d:.3g} > {box_tol}")
        if not (g[:, 5] == w[:, 5]).all():
            problems.append("classes differ")
    return len(w), g_out + w_out, problems


def filtered_agree(dec_got, dec_want, conf=DETECT_CONF, tol=1e-4):
    """The score filter's survivors (before the size filter) of two decoded
    head sets of one image, equal away from ``conf``: returns (survivors
    of the reference, problems)."""
    from planer_tpu_torch import native
    (ig, _, sg_), (iw, _, sw) = (native.score_filter(d, conf)
                                 for d in (dec_got, dec_want))
    near = set(ig[np.abs(sg_ - conf) <= tol]) | set(iw[np.abs(sw - conf)
                                                        <= tol])
    a, b = set(ig) - near, set(iw) - near
    return len(iw), ([] if a == b else
                     [f"score filter: {len(a ^ b)} rows differ"])


def run_examples(card):
    """Path 17 (1): the four example scripts as a user runs them,
    ``python3 examples/torch_*.py``, started together, each in its own
    process on cuda:0; each must exit 0 and print its lines."""
    procs, out = {}, {}
    try:
        for name in EXAMPLES:
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, os.path.join("examples", name)], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, (t0, p) in procs.items():
            so, se = p.communicate(timeout=600)
            out[name] = time.perf_counter() - t0
            lines = so.splitlines()
            log(f"path 17 python3 examples/{name}: exit {p.returncode}, "
                f"{out[name]:.1f} s wall ({card}):")
            for line in lines[:12]:
                log(f"    {line}")
            if p.returncode != 0:
                raise SystemExit(f"path 17: examples/{name} exited "
                                 f"{p.returncode}:\n{se[-3000:]}")
            for want in EXAMPLES[name]:
                if not any(want in line for line in lines):
                    raise SystemExit(f"path 17: examples/{name} printed no "
                                     f"line with {want!r}")
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def examples_path(torch, models, counters, card):
    """Path 17 (2-4): each example's ``main(device="cuda")`` in this
    process, as a user calls it (the harness sets no TF32 flag: the port's
    programs and executor hold float32 themselves), held against a
    reference on the same inputs:
    classify's logits against the float32 executor on the same dequantized
    weights (max|d|/max|y| <= 0.05, the top-5 ids equal where the gap
    decides them); detect's heads (1e-4 of each head's max|y|), score
    filter and detections against ``main(device="cpu")``; the tiled mask
    against ``main(device="cpu")`` (1e-4); 32 served answers against
    ``net(x)`` at b1 (1e-4 each), with ``stats()`` adding up and no
    spatial probe; the zoo package's ``.pla`` round trip and one forward.
    No stage64, stagen or dense_q launch over the whole path: the JAX
    package runs no Pallas kernel on these configurations."""
    from planer_tpu_torch.models import yolo_post
    from planer_tpu_torch.models.eval import synthetic_images
    from planer_tpu_torch.runtime.serving import ServingEngine
    from planer_tpu_torch.utils import zoo
    from planer_tpu_torch.utils.tile import grid_slice
    for c in counters:
        c.clear()
    out = {}
    # classify: weight-only int8, bf16, against the float32 executor
    ex = load_example("torch_classify_resnet.py")
    t0 = time.perf_counter()
    logits = ex.main("cuda")
    t_main = time.perf_counter() - t0
    net = models.resnet18(device="cuda")
    net.quantize("int8").astype_compute("bfloat16")
    x = next(synthetic_images(1, (3, 224, 224), seed=7, batch=1))
    net(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net(x)
    t_fwd = time.perf_counter() - t0
    ref = net(x, engine="oracle")[0]
    rel = float(np.abs(logits - ref).max() / np.abs(ref).max())
    decided, bad = top5_decided(logits, ref)
    log(f"path 17 classify: logits vs float32 executor max|d|/max|y| "
        f"{rel:.6g} (<= 0.05), top-5 {np.argsort(-logits)[:5].tolist()}"
        f", ranks decided {decided}; main() {1e3 * t_main:.1f} ms, "
        f"warm forward {1e3 * t_fwd:.2f} ms on the host clock ({card})")
    if not np.isfinite(logits).all() or logits.shape != (1000,) \
            or rel > 0.05 or bad:
        raise SystemExit(f"path 17 classify: rel {rel}, top-5 ranks "
                         f"{bad} differ")
    out["classify"] = {"rel": rel, "decided": decided,
                       "main_ms": 1e3 * t_main, "fwd_ms": 1e3 * t_fwd}
    del net

    # detect: raw heads at 416, against the CPU run
    ex = load_example("torch_detect_yolov3.py")
    t0 = time.perf_counter()
    dets = ex.main("cuda", DETECT_SIZE)
    t_main = time.perf_counter() - t0
    dets_cpu = ex.main("cpu", DETECT_SIZE)
    img = next(synthetic_images(1, (3, DETECT_SIZE, DETECT_SIZE), seed=3,
                                batch=1))
    heads = models.yolov3(device="cuda")(img)
    heads_cpu = models.yolov3(device="cpu")(img)
    hrel = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(heads, heads_cpu)]
    t0 = time.perf_counter()
    _, cands = yolo_post.detect(lambda _: heads, img,
                                conf_thresh=DETECT_CONF,
                                return_candidates=True)
    t_host = time.perf_counter() - t0
    _, cands_cpu = yolo_post.detect(lambda _: heads_cpu, img,
                                    conf_thresh=DETECT_CONF,
                                    return_candidates=True)
    n_filtered, fprob = filtered_agree(
        yolo_post.decode_heads(heads)[0],
        yolo_post.decode_heads(heads_cpu)[0])
    n_cmp, n_out, dprob = detections_agree(dets[0], dets_cpu[0],
                                           cands_cpu[0])
    log(f"path 17 detect: heads max|d|/max|y| vs the CPU run "
        f"{[f'{v:.3g}' for v in hrel]} (<= 1e-4), max|y| "
        f"{[f'{float(np.abs(h).max()):.4g}' for h in heads_cpu]}; "
        f"{n_filtered} of {yolo_post.decode_heads(heads_cpu).shape[1]} "
        f"boxes pass the score filter, {len(cands_cpu[0])} the size "
        f"filter; {len(dets[0])} detections on the card, "
        f"{len(dets_cpu[0])} on the CPU, {n_cmp} compared, {n_out} left "
        f"out near a threshold; main() {1e3 * t_main:.1f} ms, detect's "
        f"host part {1e3 * t_host:.2f} ms over {len(cands[0])} "
        f"candidates on the host clock ({card})")
    if max(hrel) > 1e-4 or fprob or dprob or len(dets) != 1:
        raise SystemExit(f"path 17 detect: heads {hrel}, {fprob + dprob}")
    out["detect"] = {"heads": hrel, "filtered": n_filtered,
                     "dets": len(dets[0]), "main_ms": 1e3 * t_main,
                     "host_ms": 1e3 * t_host}

    # segment: UNet tiled over 700 x 900, against the CPU run
    ex = load_example("torch_segment_unet_tiled.py")
    t0 = time.perf_counter()
    mask = ex.main("cuda")
    t_main = time.perf_counter() - t0
    mask_cpu = ex.main("cpu")
    wins = len(grid_slice(700, 900, 256, 256, 24))
    mrel = float(np.abs(mask - mask_cpu).max() / np.abs(mask_cpu).max())
    log(f"path 17 segment: mask {mask.shape}, max|d|/max|y| vs the CPU "
        f"run {mrel:.3g} (<= 1e-4); main() {1e3 * t_main:.1f} ms for "
        f"{wins} windows of 256 on the host clock ({card})")
    if mask.shape != (700, 900) or not np.isfinite(mask).all() \
            or mrel > 1e-4:
        raise SystemExit(f"path 17 segment: {mask.shape}, rel {mrel}")
    out["segment"] = {"rel": mrel, "windows": wins,
                      "main_ms": 1e3 * t_main}

    # serve: 32 requests, answers against net(x) at b1
    ex = load_example("torch_serve_continuous.py")
    rng = np.random.default_rng(17)
    imgs = [rng.standard_normal((3, 64, 64)).astype(np.float32)
            for _ in range(32)]
    probes = []
    probe = ServingEngine._spatial_signature
    ServingEngine._spatial_signature = \
        lambda self, shape: probes.append(shape) or probe(self, shape)
    try:
        t0 = time.perf_counter()
        answers, stats = ex.main("cuda", imgs)
        t_main = time.perf_counter() - t0
    finally:
        ServingEngine._spatial_signature = probe
    net = models.resnet18(num_classes=100, device="cuda")
    srel = [float(np.abs(a - r).max() / np.abs(r).max())
            for a, r in zip(answers, (net(im[None])[0] for im in imgs))]
    rows = stats["requests"] / max(1e-9, 1 - stats["pad_fraction"])
    log(f"path 17 serve: {len(answers)} answers, max|d|/max|y| vs net(x)"
        f" at b1 max {max(srel):.3g} (<= 1e-4); stats {stats}; "
        f"{len(probes)} spatial probes; main() {1e3 * t_main:.1f} ms on "
        f"the host clock ({card})")
    if len(answers) != 32 or max(srel) > 1e-4 or probes \
            or stats["requests"] != 32 \
            or not 32 <= round(rows) <= 8 * stats["batches"]:
        raise SystemExit(f"path 17 serve: {len(answers)} answers, rel "
                         f"{max(srel)}, {len(probes)} probes, {stats}")
    out["serve"] = {"rel": max(srel), "stats": stats,
                    "main_ms": 1e3 * t_main}
    del net

    # the zoo package: the .pla round trip in a cache dir of its own
    import tempfile
    old_root = zoo.root
    with tempfile.TemporaryDirectory() as work:
        zoo.root = work
        try:
            pkg = load_example("torch_planer_zoo_example")
            zoo_net = pkg.main("cuda")
            pla = os.path.join(work, "torch_planer_zoo_example",
                               "resnet18_tiny.pla")
            ref_w = models.resnet18(num_classes=10, device="cpu").weights
            same = len(ref_w) == len(zoo_net.weights) and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(zoo_net.weights, ref_w))
            y = pkg.predict(next(synthetic_images(1, (3, 64, 64), seed=5,
                                                  batch=1)))
        finally:
            zoo.root = old_root
    log(f"path 17 zoo: {pla} read back on {zoo_net.device}, "
        f"{len(ref_w)} weight arrays array-equal to resnet18(num_classes="
        f"10): {same}; one forward {y.shape}")
    if not same or y.shape != (1, 10) or not np.isfinite(y).all() \
            or zoo_net.device.type != "cuda":
        raise SystemExit("path 17 zoo: the round trip or the forward failed")
    launches = {k: v for c in counters for k, v in c.items()}
    check_counts("path 17 stage64, stagen and dense_q launches", launches, {})
    return out


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / "
                                 "CUDA port on one NVIDIA card.")
    ap.add_argument("--profile", metavar="DIR",
                    help="add a torch.profiler pass over the steps of the "
                    "main path, of both ResNet-50 programs of path 2 and of "
                    "paths 3, 4, 6, 8, 9 and 10, and write their tables "
                    "(and path 15's trace) to DIR")
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
        for kern, regs, st_b, ld_b in ptxas_report(build.build_log(name)):
            log(f"  ptxas {name} {kern}: {regs} registers, {st_b} bytes "
                f"spill stores, {ld_b} bytes spill loads")
            if st_b or ld_b:
                raise SystemExit(f"{name} {kern} spills registers")

    # ---------------------------------------------------------- kernels
    stats, lib_stem, lib_block = kernel_phase(torch, st, F)

    # -------------------------------------------------------- main path
    torch.manual_seed(SEED)
    net = build_net(models, calibrate_act_scales, synthetic_images,
                    "resnet18", None)
    if sum(l.op == "stage64" for l in net.graph.layers) != 1:
        raise SystemExit("main path: the entry stage was not fused")
    requests = {b: next(synthetic_images(b, (3, 224, 224), seed=100 + b,
                                         batch=b)) for b in (1, 8, 64)}
    answers, forwards, (launches, falloff) = drive(
        net, requests, [st.LAUNCHES, st.FALLOFF], label="main path",
        same=True)
    check_counts("main path stage64 launches", launches, {
        "stem_pool_requant": forwards, "basic_block": forwards,
        "basic_block_last": forwards})
    check_counts("main path stage64 falloff", falloff, {})
    leg1 = plain_leg(net, requests, answers,
                     "kernels vs plain stage64 (same program)")
    # leg 3: against the float32 executor (TF32 off), 32 images
    imgs = list(synthetic_images(32, (3, 224, 224), seed=29, batch=16))
    pairs = [(net(x), net(x, engine="oracle")) for x in imgs]
    leg3 = agreement(pairs, "quantized program vs float32 executor", 0.05)
    steps_main = step_times(torch, net, requests, "main path", card)
    if args.profile:
        profile_steps(torch, net.program, requests, card, args.profile)

    # ------------------------------------- path 18: the compile step
    p18 = precision_phase(torch, models, requests, card)
    p18.update(compile_path(torch, net, requests, st, card))

    # -------------------------------------- stagen kernel, paths 2 and 3
    from planer_tpu_torch.ops.kernels import stagen as sg
    nets = {m: build_net(models, calibrate_act_scales, synthetic_images, m,
                         "all") for m in ("resnet18", "resnet50")}
    for m in ("resnet18", "resnet50"):
        nets[f"{m}@448"] = build_net(models, calibrate_act_scales,
                                     synthetic_images, m, "all", 448)
    net50d = build_net(models, calibrate_act_scales, synthetic_images,
                       "resnet50", None)
    srows = stagen_phase(torch, sg, nets, synthetic_images)
    counters = [st.LAUNCHES, st.FALLOFF, sg.LAUNCHES, sg.FALLOFF]

    # path 2: ResNet-50, fuse="all", batch 1, 8 and 64
    net50 = nets["resnet50"]
    answers, fwd2, (l64, f64, lgn2, fgn) = drive(net50, requests, counters,
                                                 label="path 2")
    r50 = [r for name, r in srows.items()
           if name.startswith("stagen[resnet50 ")]
    check_counts("path 2 stage64 launches", l64,
                 {"stem_pool_requant[bf16]": fwd2})
    check_counts("path 2 stage64 falloff", f64, {})
    # each of the 2 fused stages launches once per block per forward
    check_counts("path 2 stagen block launches", lgn2, path_launches(r50, fwd2))
    check_counts("path 2 stagen falloff", fgn, {"geometry": 2 * fwd2})
    leg1_50 = plain_leg(net50, requests, answers,
                        "path 2 kernels vs plain stage64/stagen (same program)")
    gap50 = agreement([(net50(x), net50(x, engine="oracle")) for x in imgs],
                      "path 2 fuse='all' vs float32 executor (printed, not "
                      "gated: the fused-stage arithmetic)", float("inf"),
                      need_margin_agree=False)
    _, fwd2d, (l64d, f64d) = drive(net50d, requests, counters[:2],
                                   label="path 2 default fuse")
    check_counts("path 2 default-fuse stage64 launches", l64d,
                 {"stem_pool_requant[bf16]": fwd2d})
    check_counts("path 2 default-fuse stage64 falloff", f64d, {})
    leg3_50 = agreement(
        [(net50d(x), net50d(x, engine="oracle")) for x in imgs],
        "path 2 default fuse vs float32 executor", 0.05)
    steps50 = step_times(torch, net50, requests, "path 2 resnet50 fuse='all'",
                         card)
    steps50d = step_times(torch, net50d, requests,
                          "path 2 resnet50 default fuse", card)
    if args.profile:
        profile_steps(torch, net50.program, requests, card, args.profile,
                      "resnet50_fuse_all")
        profile_steps(torch, net50d.program, requests, card, args.profile,
                      "resnet50_default")

    # path 3: ResNet-18, fuse="all", batch 1 and 64
    net18 = nets["resnet18"]
    req3 = {b: requests[b] for b in (1, 64)}
    answers3, fwd3, (l64, f64, lgn3, fgn) = drive(net18, req3, counters,
                                                  label="path 3", same=True)
    r18 = [r for name, r in srows.items()
           if name.startswith("stagen[resnet18 ")]
    check_counts("path 3 stage64 launches", l64, {
        "stem_pool_requant": fwd3, "basic_block": fwd3,
        "basic_block_last": fwd3})
    check_counts("path 3 stage64 falloff", f64, {})
    check_counts("path 3 stagen block launches", lgn3, path_launches(r18, fwd3))
    check_counts("path 3 stagen falloff", fgn, {"geometry": 2 * fwd3})
    leg1_18 = plain_leg(net18, req3, answers3,
                        "path 3 kernels vs plain stage64/stagen (same program)")
    gap18 = agreement([(net18(x), net18(x, engine="oracle")) for x in imgs],
                      "path 3 fuse='all' vs float32 executor (printed, not "
                      "gated)", float("inf"), need_margin_agree=False)
    steps18 = step_times(torch, net18, req3, "path 3 resnet18 fuse='all'",
                         card)
    if args.profile:
        profile_steps(torch, net18.program, req3, card, args.profile,
                      "resnet18_fuse_all")

    # path 7: ResNet-18 at 448, fuse="all": layer2 (R=56) and layer3 (R=28)
    # one launch per block, layer3's entry in a wide form (its input
    # streamed in slabs at 7-row tiles); the stem stage and layer4 fall off
    # by geometry
    net448 = nets["resnet18@448"]
    req7 = {b: next(synthetic_images(b, (3, 448, 448), seed=300 + b,
                                     batch=b)) for b in (1, 64)}
    answers7, fwd7, (l64, f64, lgn7, fgn) = drive(net448, req7, counters,
                                                  label="path 7")
    r448 = [r for name, r in srows.items()
            if name.startswith("stagen[resnet18@448 ")]
    check_counts("path 7 stage64 launches", l64, {})
    check_counts("path 7 stage64 falloff", f64, {"geometry": fwd7})
    check_counts("path 7 stagen launches", lgn7, path_launches(r448, fwd7))
    if any(not k.startswith("stagen_block:") for k in lgn7):
        raise SystemExit(f"path 7: a launch other than stagen_block: {lgn7}")
    check_counts("path 7 stagen falloff", fgn, {"geometry": fwd7})
    leg1_7 = plain_leg(net448, req7, answers7,
                       "path 7 kernels vs plain stagen (same program)")
    steps7 = step_times(torch, net448, req7, "path 7 resnet18 fuse='all' "
                        "at 448", card)

    # path 19: ResNet-50 at 448, fuse="all": layer2 (R=56, resident forms)
    # and layer3 (R=28, six wide blocks) one launch per block; the stem
    # stage, layer1 (R=112) and layer4 (R=14) fall off by geometry
    p19 = resnet50_448_path(torch, nets["resnet50@448"], srows, counters,
                            synthetic_images, card)

    # ------------------------------------- dense_q kernel and path 4
    from planer_tpu_torch.ops import torch_ops as tops
    from planer_tpu_torch.ops.kernels import gemm as tg
    grows = gemm_phase(torch, tg)
    t0 = time.perf_counter()
    net4 = models.resnet50(seed=SEED, device="cuda")
    net4.optimize()
    net4.quantize("int8")                      # weight-only: no act scales
    net4.astype_compute("bfloat16")
    log(f"resnet50 weight-only int8 built: {time.perf_counter() - t0:.1f} s")
    counters4 = [tg.LAUNCHES, st.LAUNCHES, sg.LAUNCHES]
    tops._PALLAS_CONV1X1 = True
    try:
        answers4, fwd4, (lq4, l64_4, lgn4) = drive(net4, requests, counters4,
                                                   label="path 4")
        check_counts("path 4 dense_q launches", lq4, {"dense_q": 26 * fwd4})
        check_counts("path 4 stage64 and stagen launches", {**l64_4, **lgn4},
                     {})
        leg1_4 = plain_leg(net4, requests, answers4,
                           "path 4 kernels vs plain dense_q (same program)")
        leg3_4 = agreement([(net4(x), net4(x, engine="oracle")) for x in imgs],
                           "path 4 weight-only int8 vs float32 executor", 0.05)
        # the unquantized model's logits, for the quantization error of the
        # int8 (path 4) and fp8 (path 6) weights, printed and not gated
        float50 = models.resnet50(seed=SEED, device="cuda")
        float50.optimize()
        float_ref = [float50(x, engine="oracle") for x in imgs]
        del float50
        gap4 = agreement(
            [(net4(x), r) for x, r in zip(imgs, float_ref)],
            "path 4 weight-only int8 vs the unquantized float model (printed,"
            " not gated: the int8 quantization error)", float("inf"),
            need_margin_agree=False)
    finally:
        tops._PALLAS_CONV1X1 = False
    # the reference's own A/B (experiments/resnet50_bench.py), on the card,
    # in turns: route on, off, off, on
    steps4 = {"on": [], "off": []}
    for route in ("on", "off", "off", "on"):
        tops._PALLAS_CONV1X1 = route == "on"
        try:
            steps4[route].append(step_times(
                torch, net4, requests, f"path 4 resnet50 weight-only, 1x1 "
                f"route {route}", card))
        finally:
            tops._PALLAS_CONV1X1 = False
    if args.profile:
        tops._PALLAS_CONV1X1 = True
        try:
            profile_steps(torch, net4.program, requests, card, args.profile,
                          "resnet50_weight_only_route")
        finally:
            tops._PALLAS_CONV1X1 = False

    # ---------------- path 5: the main path under the stage64 A/B flags
    req5 = {b: requests[b] for b in (1, 64)}
    trunc_keys = ("stem_pool_requant[trunc]", "basic_block[trunc]",
                  "basic_block_last[trunc]")
    l5, legs5 = {}, {}
    for form, split, requant in (("trunc", True, "trunc"),
                                 ("one-call", False, "fxp")):
        st.SPLIT, st.REQUANT = split, requant
        try:
            answers5, fwd5, (l5[form], f5) = drive(
                net, req5, [st.LAUNCHES, st.FALLOFF],
                label=f"path 5 ({form})", same=True)
            check_counts(f"path 5 ({form}) stage64 launches", l5[form],
                         {k: fwd5 for k in trunc_keys})
            check_counts(f"path 5 ({form}) stage64 falloff", f5, {})
            legs5[form] = (
                plain_leg(net, req5, answers5, f"path 5 ({form}) kernels vs "
                          f"plain stage64 (same program)", need_same=True),
                agreement([(net(x), net(x, engine="oracle")) for x in imgs],
                          f"path 5 ({form}) vs float32 executor", 0.05))
        finally:
            st.SPLIT, st.REQUANT = True, "fxp"

    # ------------------- path 6: weight-only FP8 ResNet-50, the fp8 dense_q
    grows8 = gemm_phase(torch, tg, "fp8")
    t0 = time.perf_counter()
    net6 = models.resnet50(seed=SEED, device="cuda")
    net6.optimize()
    net6.quantize("fp8")                       # weight-only float8_e4m3fn
    net6.astype_compute("bfloat16")
    log(f"resnet50 weight-only fp8 built: {time.perf_counter() - t0:.1f} s")
    tops._PALLAS_CONV1X1 = True
    try:
        answers6, fwd6, (lq6, l64_6, lgn6) = drive(net6, requests, counters4,
                                                   label="path 6")
        check_counts("path 6 dense_q launches", lq6,
                     {"dense_q[fp8]": 26 * fwd6})
        check_counts("path 6 stage64 and stagen launches", {**l64_6, **lgn6},
                     {})
        leg1_6 = plain_leg(net6, requests, answers6,
                           "path 6 kernels vs plain dense_q[fp8] (same "
                           "program)")
        leg3_6 = agreement([(net6(x), net6(x, engine="oracle")) for x in imgs],
                           "path 6 weight-only fp8 vs float32 executor", 0.05)
        gap6 = agreement(
            [(net6(x), r) for x, r in zip(imgs, float_ref)],
            "path 6 weight-only fp8 vs the unquantized float model (printed, "
            "not gated: the fp8 quantization error)", float("inf"),
            need_margin_agree=False)
        steps6 = step_times(torch, net6, requests, "path 6 resnet50 "
                            "weight-only fp8, 1x1 route on", card)
        if args.profile:
            profile_steps(torch, net6.program, requests, card, args.profile,
                          "resnet50_weight_only_fp8_route")
    finally:
        tops._PALLAS_CONV1X1 = False

    # -------- dense_q at YOLO-v3's shapes; paths 8-10: YOLO-v3 and UNet
    from planer_tpu_torch.models import eval as ev
    yrows = gemm_phase(torch, tg, gemms=YOLO_GEMMS, batches=(1, 16),
                       timed=(1, 16), extra=False)
    counters_all = [st.LAUNCHES, st.FALLOFF, sg.LAUNCHES, sg.FALLOFF,
                    tg.LAUNCHES]
    p8 = yolo_static_path(torch, models, calibrate_act_scales,
                          synthetic_images, card, counters_all, args.profile)
    p9 = yolo_route_path(torch, models, tops, ev, card, counters4, p8,
                         args.profile)
    p10 = unet_path(torch, models, synthetic_images, card, counters_all,
                    args.profile)

    # ------------- paths 11-13: the frontends, the op library, the tail
    import tempfile
    import planer_tpu_torch as pt
    with tempfile.TemporaryDirectory() as work:
        p11, p12 = frontend_paths(torch, pt, net, calibrate_act_scales,
                                  synthetic_images, requests, imgs,
                                  [st.LAUNCHES, st.FALLOFF], card, work)
    p13 = op_library_path(torch, pt, card)

    # ----------------------- paths 14-15: the main path served, the tools
    p14 = serve_path(torch, net, st, synthetic_images, card)
    p15 = tools_path(torch, pt, net, requests, steps_main[64],
                     synthetic_images, card, args.profile)

    # --------- path 16: two DP worker processes, the mesh, the world of one
    with tempfile.TemporaryDirectory() as work:
        p16 = dp_serving(torch, pt, net, synthetic_images, card, work)
    p16m = mesh_paths(torch, pt, models, net, requests, st, sg, card)

    # ----------------------------------------- path 17: the user examples
    p17 = {"scripts_s": run_examples(card)}
    p17.update(examples_path(torch, models, [st.LAUNCHES, sg.LAUNCHES,
                                             tg.LAUNCHES], card))

    # ---------------------------------------------------- kernel table
    n = 64
    stem_bytes = n * 3 * 224 * 224 + 64 * 147 + 64 * 4 * 4 + n * 64 * 56 * 56
    stem_ops = 2 * n * 112 * 112 * 64 * 147
    blk_ops = 2 * 2 * n * 56 * 56 * 64 * 576
    trunc_tables = 2 * 64 * 4
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
             "(neighbour: one of the block's two convs)"),
            ("stem_pool_requant[trunc]", 303,
             stem_bytes - 64 * 4 * 4 + trunc_tables, stem_ops, lib_stem,
             "cuDNN bf16 conv 7x7/2 3->64 at b64 (neighbour: no pool, no "
             "requant)"),
            ("basic_block[trunc]", 469,
             n * 64 * 56 * 56 * 2 + 2 * 64 * 576 + 2 * trunc_tables, blk_ops,
             lib_block, "cuDNN bf16 conv 3x3 64->64 at b64 (neighbour: one of "
             "the block's two convs)"),
            ("basic_block_last[trunc]", 469,
             n * 64 * 56 * 56 * 3 + 2 * 64 * 576 + 2 * trunc_tables, blk_ops,
             lib_block, "cuDNN bf16 conv 3x3 64->64 at b64 (neighbour: one of "
             "the block's two convs)")):
        s = stats[name]
        b_ms, by = bound_ms(nbytes, ops)
        row = {
            "name": name, "route": "cuda",
            "source": "planer_tpu_torch/csrc/stage64.cu",
            "replaces": f"planer_tpu/ops/pallas/stage64.py:{src_line}",
            "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib, "library_call": lib_call,
            "tops": ops / (s["ms"] * 1e-3) / 1e12, "batch": n}
        if name in trunc_keys:     # path 5: REQUANT="trunc" and SPLIT=False
            row.update(launches=l5["trunc"][name],
                       launches_one_call=l5["one-call"][name])
        else:
            row["launches"] = launches[name]
            row["launches_path11"] = p11["launches"][name]
            row["launches_path12"] = p12["launches"][name]
            row["launches_path14"] = p14["launches"][name]
            row["launches_path16"] = p16["launches"][name]
            row["launches_path18"] = p18["launches"][name]
        rows.append(row)
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
            f"neighbour {r['library_ms']:.4f}), {r['tops']:.1f} TOP/s "
            f"achieved at b{n}")
    for name, r in srows.items():
        b_ms, by = bound_ms(r["bytes"], r["ops"])
        lgn, fwd = ((p19["launches"], p19["forwards"])
                    if "resnet50@448" in name else
                    (lgn2, fwd2) if "resnet50" in name else
                    (lgn7, fwd7) if "@448" in name else (lgn3, fwd3))
        keys = {k: lgn[k] for k in r["per_call"]}
        rows.append({
            "name": name, "route": "cuda",
            "source": "planer_tpu_torch/csrc/stagen.cu",
            "replaces": "planer_tpu/ops/pallas/stagen.py:157",
            "launch_keys": keys, "launches": sum(keys.values()),
            "forwards": fwd,
            "max_abs_err": r["err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": by,
            "tops": r["tops"], "bound_over_time": b_ms / r["ms"],
            "geometries": r["geometries"],
            "library_ms": None, "neighbour_ms": r["neighbour_ms"],
            "neighbour": "not the same function: the port's decomposed chain "
                         "of the stage (torch._int_mm W8A8 convs where "
                         "C_in >= 128, cuDNN bf16 convs below)",
            "batch": n, "per": "one stage call at b64; ms device time (CUDA "
                                "graph replay), call_ms wrapper calls"})
        log(f"{name}: {r['ms']:.4f} ms on the device ({r['call_ms']:.4f} "
            f"as wrapper calls; plain {r['plain_ms']:.4f}, bound "
            f"{b_ms:.4f} by {by}, decomposed neighbour "
            f"{r['neighbour_ms']:.4f}) at b{n}, {r['tops']:.1f} TOP/s")
    rows.append(gemm_row("dense_q", grows, lq4["dense_q"], fwd4, "path 4"))
    rows.append(gemm_row("dense_q[fp8]", grows8, lq6["dense_q[fp8]"], fwd6,
                         "path 6"))
    b1 = gemm_row("dense_q[yolov3]", yrows, p9["launches"], p9["forwards"],
                  "path 9", batch=1)
    rows.append(gemm_row("dense_q[yolov3]", yrows, p9["launches"],
                         p9["forwards"], "path 9", batch=16))
    rows[-1]["b1"] = {k: b1[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "neighbour_ms")}
    rows[-1]["shapes"] = yrows
    log(f"path 6: plain p99 {leg1_6[0]:.6g}, executor p99 {leg3_6[0]:.6g}, "
        f"gap to the float model p99 {gap6[0]:.6g}; steps {steps6} ms "
        f"(printed, no claim)")
    log(f"path 4: plain p99 {leg1_4[0]:.6g}, executor p99 {leg3_4[0]:.6g}, "
        f"gap to the float model p99 {gap4[0]:.6g}; "
        f"steps route on {steps4['on']}, off {steps4['off']} ms (printed, no "
        f"claim); path 5: " + "; ".join(
            f"{k} plain p99 {v[0][0]:.6g}, executor p99 {v[1][0]:.6g}"
            for k, v in legs5.items()))
    log(f"path 8: executor p99 {p8['leg3'][0]:.6g}, {p8['boxes']} boxes, "
        f"steps {p8['steps']} ms; path 9: plain p99 {p9['leg1'][0]:.6g}, "
        f"executor p99 {p9['leg3'][0]:.6g}, detection f1 {p9['f1']:.4g} (at "
        f"416, 80 classes: {p9['f1_416']:.4g}), steps route on "
        f"{p9['steps']['on']}, off {p9['steps']['off']} ms; path 10: "
        f"executor p99 {p10['leg3'][0]:.6g}, tiled median/mean "
        f"{p10['tiled'][0]:.6g}/{p10['tiled'][1]:.6g} (gate net "
        f"{p10['tiled_gate'][0]:.6g}/{p10['tiled_gate'][1]:.6g}), step "
        f"{p10['steps']} ms, tiled {p10['tiled_ms']:.1f} ms (printed, no "
        f"claim)")
    log(f"path 11 (torch2planer): import max|d|/max|y| {p11['import']:.3g}, "
        f"plain p99 {p11['leg1'][0]:.6g}, executor p99 {p11['leg3'][0]:.6g}, "
        f"steps {p11['steps']} ms; path 12 (onnx): import "
        f"{p12['import']:.3g}, executor p99 {p12['leg3'][0]:.6g}, steps "
        f"{p12['steps']} ms; path 13: {len(p13['opcodes'])} opcodes on the "
        f"card within their bounds (printed, no claim)")
    log(f"path 14 (served): p50 {p14['p50_ms']:.4f} ms, p99 "
        f"{p14['p99_ms']:.4f} ms, occupancy {p14['occupancy']:.4f}, pad "
        f"fraction {p14['pad_fraction']:.4f}, burst {p14['burst_img_s']:.1f} "
        f"img/s, answers p99 {p14['leg'][0]:.6g}; path 15: ideal "
        f"{1e3 * p15['cost_report']['ideal_time_s']:.4f} ms of a "
        f"{steps_main[64]:.4f} ms b64 step, quantize_auto "
        f"{p15['quantize_auto']} (printed, no claim)")
    log(f"path 16 (DP workers): {p16['batches']} batches, answers p99 "
        f"{p16['leg'][0]:.6g}, {p16['bit_identical']} of 112 bit-identical, "
        f"{p16['img_s']:.1f} img/s, dp_size after the kill "
        f"{p16['report']['dp_size_after']}; DP x TP p99 "
        f"{p16m['leg'][0]:.6g}, kernel nodes and capture ms "
        f"{p16m['graphs']}, steps {p16m['steps']} ms; UNet {p16m['unet']} "
        f"(printed, no claim)")
    log(f"path 18 (compile step): float32 program vs executor with TF32 "
        f"on in the caller {p18['oracle_rel']:.3g}; capture ms "
        f"{p18['capture_ms']}, kernel nodes {p18['kernel_nodes']}; steps replay / eager (CUDA events) "
        + "; ".join(f"b{b} {r['replay_ms']:.4f} / {r['eager_ms']:.4f} ms"
                    for b, r in p18["steps"].items())
        + " (printed, no claim)")
    log(f"path 17 (examples): scripts {p17['scripts_s']} s; classify rel "
        f"{p17['classify']['rel']:.6g}, detect heads {p17['detect']['heads']}"
        f" ({p17['detect']['dets']} detections, {p17['detect']['filtered']} "
        f"past the score filter), segment rel {p17['segment']['rel']:.3g}, "
        f"serve rel {p17['serve']['rel']:.3g} in "
        f"{p17['serve']['stats']['batches']} batches (printed, no claim)")
    log(f"legs: plain-stage p99 {leg1[0]:.6g}; executor p99 {leg3[0]:.6g}; "
        f"path 2 plain p99 {leg1_50[0]:.6g}, fuse='all' executor gap p99 "
        f"{gap50[0]:.6g}, default-fuse executor p99 {leg3_50[0]:.6g}; "
        f"path 3 plain p99 {leg1_18[0]:.6g}, executor gap p99 "
        f"{gap18[0]:.6g}, steps {steps18} ms; path 7 plain p99 "
        f"{leg1_7[0]:.6g}, steps {steps7} ms; path 19 plain p99 "
        f"{p19['leg1'][0]:.6g}, executor gap p99 {p19['gap'][0]:.6g}, steps "
        f"{p19['steps']} ms; resnet50 steps fuse='all' {steps50}, default "
        f"{steps50d} ms; total {time.perf_counter() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
