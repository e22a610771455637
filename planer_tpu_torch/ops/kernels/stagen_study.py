"""Where the stagen block kernel's time goes, on the card.

    python3 -m planer_tpu_torch.ops.kernels.stagen_study [--other DIR]

Builds ``csrc/stagen.cu`` as it is and in copies with one part cut out or
changed (see ``CUTS``), and times each at the three fused stages of
ResNet-18 and ResNet-50 at 224 and the two wide stages at 448 (ResNet-18
and ResNet-50 ``stagen_1``, whose blocks run in the kernel's wide forms),
batch 64 (random int8 weights from a seed, the stages' real widths), as
device time (20 stage calls captured in a CUDA graph and replayed).  A cut
copy computes garbage: only its time means something.  Prints one line per
stage with the achieved int8 TOP/s of the uncut kernel and its bound (the
stage's int8 operations at 1979 TOP/s) over its time, then each block
launched alone (for a stage with wide blocks also under the cuts in
``WIDE_CUTS``), and a stage with wide blocks at every wide geometry its
blocks fit, each checked bit for bit against the plain version first.
``--other DIR`` also times ``stagen_stage`` of another checkout of the port
(its wrapper, the same way) in a subprocess, for a before/after in one run.
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
          ("resnet50 stagen_1", "bottleneck", 256, 128, 512, 4, 2, 56),
          ("resnet18@448 stagen_1", "basic", 128, 256, 256, 2, 2, 56),
          ("resnet50@448 stagen_1", "bottleneck", 512, 256, 1024, 6, 2, 56)]
PEAK_INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core rate
# cuts whose per-block times are printed for the stages with wide blocks
WIDE_CUTS = ("kernel", "no MMA", "no X load", "no ldmatrix or MMA", "wide")
MMA = ('"mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
       '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"')
PLANE_EPI = ("pair = (uint32_t)trunc_code(affine(acc[mi][ni][2 * h], fa, ba)) |\n"
             "                     (uint32_t)trunc_code(affine(acc[mi][ni][2 * h + 1], "
             "fb, bb)) << 8;")
CUTS = {
    "kernel": [],
    "no MMA": [(MMA, '"xor.b32 %0, %0, %4; xor.b32 %1, %1, %5; '
                     'xor.b32 %2, %2, %8; xor.b32 %3, %3, %9;"')],
    "no X load": [("      cp_async16(dst + s * (pj ? OUT * 64 : XSLAB)",
                   "      if (cin < 0) cp_async16(dst + s * (pj ? OUT * 64 : XSLAB)"),
                  ("            w[k >> 2] |= (uint32_t)(uint8_t)__ldg(src + k * hh) << (8 * (k & 3));",
                   "            w[k >> 2] |= 0u;")],
    "no X prefetch": [("else if (PROJ || tile == (int)blockIdx.x)", "else"),
                      ("if (!WIDE && !PROJ && !nchw_c && has_next)",
                       "if (false)"),
                      ("    if (xr == 2 && (!PROJ || (xj + 1) % nsteps)) x_load(xj + 1);",
                       "    if (false) x_load(xj + 1);"),
                      ("    if (xr == 1) {\n      __syncthreads();",
                       "    if (xr >= 1) {\n      __syncthreads();")],
    "no weight copies": [("      bulk_load(buf + slot * SLICE, w + (size_t)k * SLICE, SLICE, "
                          "bars() + 8 * slot);",
                          "      mbar_arrive(bars() + 8 * slot);")],
    "no ldmatrix or MMA": [("if (one) mma_slice(", "if (one && slabs < 0) mma_slice(")],
    "wide: no NCHW slab loads": [("        load_nchw_slab(dst, tl, s, false, kept);",
                                  "        (void)kept;"),
                                 ("        load_kept(dst, kept);", "        (void)kept;")],
    "wide: no slab barriers": [
        ("      __syncthreads();             // every thread is done with the slot\n",
         "\n"),
        ("    cp_async_wait_all();\n    __syncthreads();\n    if (xr == 2 &&",
         "    cp_async_wait_all();\n    if (xr == 2 &&")],
    "no residual read": [("            else if (WIDE)\n              res = res_global(m, co);",
                          "            else if (WIDE)\n              res = co;")],
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
            text = text.replace(a, b)       # every occurrence
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
        for fn in ("stagen_block", "stagen_block_smem"):
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
                try:
                    row[k] = graph_ms(lambda: sg.stagen_stage(xq, plan))
                except RuntimeError:      # a layout the cut does not fit
                    row[k] = float("nan")
        geos = sorted({(b.th, b.xr) for b in plan.blocks})
        print(f"{name} b64 (geometries {geos}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f" ms; kernel {ops / row['kernel'] / 1e9:.1f} TOP/s, bound "
              f"{bound_ms(ops):.4f} ms, bound / time "
              f"{bound_ms(ops) / row['kernel']:.3f}", flush=True)
        for k, lib in libs.items():
            if k == "kernel" or (any(b.xr for b in plan.blocks)
                                 and k.split(":")[0] in WIDE_CUTS):
                with _using(lib):
                    block_times(f"{name} [{k}]", xq, plan)
        if any(b.xr for b in plan.blocks):
            geometry_times(name, x, w, blocks)
    sg.LAUNCHES.clear()


def geometry_times(name, x, w, blocks):
    """A stage with wide blocks at every wide geometry its blocks fit,
    one form at a time (the form's blocks all forced to it): device time of
    the stage and of each block."""
    plan = sg._fold(w, blocks, x.device)
    for form in sorted({b.form for b in plan.blocks if b.xr}):
        tried = sg._GEOMETRIES[form]
        for g in (g for g in tried if g[1]):
            sg._GEOMETRIES[form] = (g,)
            try:
                alt = sg._fold(w, blocks, x.device)
            finally:
                sg._GEOMETRIES[form] = tried
            if any(b.th is None for b in alt.blocks):
                continue
            xq = sg.stagen_prologue(x, alt.s_in)
            if not torch.equal(sg.stagen_stage(xq, alt),
                               sg.stagen_plain(xq, alt)):
                raise SystemExit(f"{name}: form {form} at {g} disagrees "
                                 f"with the plain version")
            ms = graph_ms(lambda: sg.stagen_stage(xq, alt))
            print(f"  {name} form {form} at (th, xr) {g}: stage {ms:.4f} ms "
                  f"(bit-exact)", flush=True)
            block_times(f"{name} form {form} at {g}", xq, alt)


def block_times(name, xq, plan):
    """Each block of the stage launched alone (device time), the first on
    the stage's NCHW codes, the others on random int8 NHWC planes of their
    input's shape, with its share of the stage's operations."""
    gen = torch.Generator(device=xq.device).manual_seed(1)
    h, out = xq.shape[2], []
    for i, blk in enumerate(plan.blocks):
        cin = blk.widths()[0]
        x = xq if i == 0 else torch.randint(
            0, 64, (xq.shape[0], h, h, cin), generator=gen,
            device=xq.device, dtype=torch.int8)
        ms = graph_ms(lambda: sg._launch_block(x, h, blk, "study",
                                               nchw=i == 0))
        one = sg._Plan(plan.s_in, [blk], cin, blk.widths()[2])
        ops = xq.shape[0] * stage_ops(one, h)
        out.append(f"{i}: {blk.kind} s{blk.stride} (th {blk.th}, xr "
                   f"{blk.xr}) {ms:.4f} ms, {ops / ms / 1e9:.1f} TOP/s")
        h //= blk.stride
    print(f"  {name} blocks: " + "; ".join(out), flush=True)


def bound_ms(ops):
    """The least time of ops int8 operations at the card's peak rate."""
    return ops / PEAK_INT8_OPS * 1e3


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
        ops = 64 * stage_ops(plan, xq.shape[2])
        print(f"{Path(sg.__file__).parents[3]} {name} b64: stagen_stage "
              f"{ms:.4f} ms (device), bound / time {bound_ms(ops) / ms:.3f}",
              flush=True)


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
