"""Where the stagen block kernel's time goes, on the card.

    python3 -m planer_tpu_torch.ops.kernels.stagen_study [--other DIR]

Builds ``csrc/stagen.cu`` as it is and in copies with one part cut out or
changed (see ``CUTS``), and times each at the three fused stages of
ResNet-18 and ResNet-50 at 224, batch 64 (random int8 weights from a seed,
the stages' real widths), as device time (20 stage calls captured in a CUDA
graph and replayed).  A cut copy computes garbage: only its time means
something.  Prints one line per stage and the achieved int8 TOP/s of the
uncut kernel.  ``--other DIR`` also times ``stagen_stage`` of another
checkout of the port (its wrapper, the same way) in a subprocess, for a
before/after in one run.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from planer_tpu_torch.ops.kernels import build
from planer_tpu_torch.ops.kernels import stagen as sg
from planer_tpu_torch.ops.kernels.gemm_study import graph_ms
from planer_tpu_torch.ops.qtypes import QTensor

# (name, kind, cin, cmid, cout, blocks, entry stride, input side)
STAGES = [("resnet18 stagen_0", "basic", 64, 128, 128, 2, 2, 56),
          ("resnet50 stagen_0", "bottleneck", 64, 64, 256, 3, 1, 56),
          ("resnet50 stagen_1", "bottleneck", 256, 128, 512, 4, 2, 56)]
MMA = ('"mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
       '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"')
PLANE_EPI = ("pair = (uint32_t)trunc_code(affine(acc[mi][ni][2 * h], fa, ba)) |\n"
             "                     (uint32_t)trunc_code(affine(acc[mi][ni][2 * h + 1], "
             "fb, bb)) << 8;")
CUTS = {
    "kernel": [],
    "no MMA": [(MMA, '"xor.b32 %0, %0, %4; xor.b32 %1, %1, %5; '
                     'xor.b32 %2, %2, %8; xor.b32 %3, %3, %9;"')],
    "no X load": [("      cp_async16(X + s * XSLAB",
                   "      if (cin < 0) cp_async16(X + s * XSLAB"),
                  ("        if (dst[u] >= 0) X[dst[u]]",
                   "        if (cin < 0) X[dst[u]]")],
    "no X prefetch": [("else if (PROJ || tile == (int)blockIdx.x)", "else"),
                      ("if (!PROJ && !nchw_c && has_next) load_nhwc(",
                       "if (false) load_nhwc(")],
    "no stores": [("if (oy >= R || ox >= R) continue;",
                   "if (oy >= 0) continue;")],
    "no plane epilogue": [(PLANE_EPI, "pair = acc[mi][ni][2 * h] ^ "
                                      "acc[mi][ni][2 * h + 1];")],
}


def _build_cuts(out_dir: Path):
    src = (build.SRC_DIR / "stagen.cu").read_text()
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for a, b in cuts:
            if a not in text:
                raise SystemExit(f"cut {name!r}: the kernel source changed")
            text = text.replace(a, b)
        tag = name.replace(" ", "_")
        path = out_dir / f"stagen_{tag}.cu"
        path.write_text(text)
        so = out_dir / f"libstagen_{tag}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("stagen_block", "stagen_block_smem", "stagen_conv"):
            getattr(lib, fn).argtypes = getattr(sg._lib(), fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def random_stage(kind, cin, cm, co, nb, st, side, n, seed=0):
    """A stage's input and int8 weights as a calibrated net would hand
    them (each conv's act scale its input's), on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.standard_normal((n, cin, side, side)) * 20
                         ).astype(np.float32), device=dev)
    scales = iter([0.9, 0.8, 0.7, 0.6] * 8)

    def q(shape, act):
        w = rng.integers(-127, 128, size=shape, dtype=np.int8)
        s = (0.5 + rng.random((shape[0], 1, 1, 1))).astype(np.float32) / 256
        return QTensor(torch.as_tensor(w, device=dev),
                       torch.as_tensor(s, device=dev), True, float(act))

    def vec(c):
        return torch.as_tensor((rng.standard_normal(c) * 0.1).astype(
            np.float32), device=dev)

    blocks, w, cur = [], [], float(x.abs().max()) / 127.0
    for b in range(nb):
        s_ = st if b == 0 else 1
        ci = cin if b == 0 else co
        down = b == 0 and (s_ != 1 or cin != co)
        blocks.append({"kind": kind, "stride": s_, "down": down})
        if kind == "basic":
            w += [q((co, ci, 3, 3), cur), vec(co),
                  q((co, co, 3, 3), next(scales)), vec(co)]
        else:
            w += [q((cm, ci, 1, 1), cur), vec(cm),
                  q((cm, cm, 3, 3), next(scales)), vec(cm),
                  q((co, cm, 1, 1), next(scales)), vec(co)]
        if down:
            w += [q((co, ci, 1, 1), cur), vec(co)]
        cur = next(scales)
    return x, w, blocks


@contextlib.contextmanager
def _using(lib):
    """stagen_stage (its launches, layouts and checks) through another
    build of the kernel library."""
    orig = sg._lib
    sg._lib = lambda: lib
    try:
        yield
    finally:
        sg._lib = orig


def study():
    libs = _build_cuts(build._build_dir())
    for name, *shape in STAGES:
        x, w, blocks = random_stage(*shape, n=64)
        plan = sg._fold(w, blocks, x.device)
        xq = sg.stagen_prologue(x, plan.s_in)
        ref = sg.stagen_stage(xq, plan)
        with _using(libs["kernel"]):
            if not torch.equal(sg.stagen_stage(xq, plan), ref):
                raise SystemExit(f"{name}: the study's kernel build disagrees")
        ops = 64 * stage_ops(plan, xq.shape[2])
        row = {}
        for k, lib in libs.items():
            with _using(lib):
                row[k] = graph_ms(lambda: sg.stagen_stage(xq, plan))
        print(f"{name} b64: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          row.items())
              + f" ms; kernel {ops / row['kernel'] / 1e9:.1f} TOP/s",
              flush=True)
    sg.LAUNCHES.clear()


def stage_ops(plan, h):
    """int8 operations (2 per MAC) of one image through the stage whose
    input side is h: every conv at its output side."""
    ops = 0
    for blk in plan.blocks:
        ho = h // blk.stride
        sides = [ho, ho] if blk.kind == "basic" else [h, ho, ho]
        convs = list(zip(blk.convs, sides))
        if blk.proj is not None:
            convs.append((blk.proj, ho))
        for c, side in convs:
            o, ci, k, _ = c.w.shape
            ops += 2 * side * side * o * ci * k * k
        h = ho
    return ops


def time_checkout():
    """The imported checkout's stagen_stage at the three stages, b64,
    device time."""
    for name, *shape in STAGES:
        x, w, blocks = random_stage(*shape, n=64)
        plan = sg._fold(w, blocks, x.device)
        xq = sg.stagen_prologue(x, plan.s_in)
        ms = graph_ms(lambda: sg.stagen_stage(xq, plan))
        print(f"{Path(sg.__file__).parents[3]} {name} b64: stagen_stage "
              f"{ms:.4f} ms (device)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", metavar="DIR",
                    help="also time the stagen_stage of the checkout at DIR")
    ap.add_argument("--checkout", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stagen_study: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.checkout:
        time_checkout()
        return
    if args.other:       # this file, run against the other checkout's port
        root = str(Path(args.other).resolve())
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--checkout"], cwd=root, check=True,
                       env={**os.environ, "PYTHONPATH": root})
    time_checkout()
    study()


if __name__ == "__main__":
    main()
