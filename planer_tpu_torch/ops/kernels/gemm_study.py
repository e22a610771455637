"""Where the dense_q kernel's time goes, on the card.

    python3 -m planer_tpu_torch.ops.kernels.gemm_study [--other DIR]

Builds ``csrc/gemm.cu`` as it is and in copies with one part cut out (the
MMAs, the weight decode, both, or the TMA stores of the output), and times
each at path 4's nine GEMM shapes of batch 64, int8 and fp8 weights, as
device time (20 launches captured in a CUDA graph and replayed), beside
cuBLAS ``torch.mm`` of the dequantized weights.  A cut copy computes
garbage: only its time means something.  ``--other DIR`` also times the
``dense_q`` of another checkout of the port (its wrapper, the same way) in
a subprocess, for a before/after in one run.  Prints one line per shape and
the sums over one b64 forward (26 launches).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from planer_tpu_torch.ops.kernels import build

# path 4's routed 1x1 convs at 224: (Kd, N, side, convs per forward)
SHAPES = [(256, 128, 56, 1), (512, 128, 28, 3), (128, 512, 28, 4),
          (512, 256, 28, 1), (1024, 256, 14, 5), (256, 1024, 14, 6),
          (1024, 512, 14, 1), (2048, 512, 7, 2), (512, 2048, 7, 3)]
MMA = "for (int s = 0; s < 4; ++s) wgmma_rs<BP>(acc, a[s], desc + 2 * s);"
DECODE = "  if constexpr (WT == W_INT8) {\n    // byte"
CUTS = {
    "kernel": [],
    "no MMA": [(MMA, "for (int s = 0; s < 4; ++s) acc[s] += __uint_as_float("
                     "a[s][0] ^ a[s][3] ^ (uint32_t)desc);")],
    "no decode": [(DECODE, "  if constexpr (true) return v * 0x00010001u;\n"
                   + DECODE)],
    "no store": [("        tma_store_2d(&omap,",
                  "        if (M < 0) tma_store_2d(&omap,")],
}
CUTS["no MMA, no decode"] = CUTS["no MMA"] + CUTS["no decode"]


def graph_ms(fn, reps=20, rounds=5):
    """Mean device milliseconds per call of fn: ``reps`` calls captured in
    a CUDA graph, replayed ``rounds`` times between CUDA events, so the
    host's launch work is not in the time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(rounds):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * rounds)


def _inputs(form, kd, n, m, rng):
    dev = torch.device("cuda")
    q = torch.as_tensor(rng.integers(-100, 100, (n, kd), dtype=np.int8),
                        device=dev)
    if form == "fp8":        # finite e4m3 codes
        q = q.view(torch.uint8).bitwise_and(0x77).view(torch.float8_e4m3fn)
    s = torch.full((n,), 0.01, device=dev)
    b = torch.zeros(n, device=dev, dtype=torch.bfloat16)
    x = torch.randn(m, kd, device=dev).to(torch.bfloat16)
    return x, q, s, b


def build_cuts(source: str, cuts: dict, argtypes: dict) -> dict:
    """{cut name: library}: ``csrc/<source>.cu`` built once per entry of
    ``cuts`` (name -> [(text, its replacement everywhere)]) into the build
    directory, the nvcc processes in parallel; each library's functions
    take ``argtypes`` ({name: argument types}) and return an int."""
    out_dir = build._build_dir()
    src = (build.SRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for name, pairs in cuts.items():
        text = src
        for a, b in pairs:
            if a not in text:
                raise SystemExit(f"cut {name!r}: the kernel source changed")
            text = text.replace(a, b)
        tag = f"{source}_" + name.replace(" ", "_").replace(",", "")
        path = out_dir / f"{tag}.cu"
        path.write_text(text)
        so = out_dir / f"lib{tag}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(so))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    return libs


def study():
    libs = build_cuts("gemm", CUTS, {"dense_q": [ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p]})
    rng = np.random.default_rng(0)
    total = {}
    for form, code in (("int8", 0), ("fp8", 1)):
        for kd, n, side, cnt in SHAPES:
            m = 64 * side * side
            x, q, s, b = _inputs(form, kd, n, m, rng)
            out = torch.empty(m, n, device=x.device, dtype=torch.bfloat16)
            ptrs = [t.data_ptr() for t in (x, q, s, b, out)]
            row = {}
            for name, lib in libs.items():
                def run(lib=lib, name=name):
                    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
                    err = lib.dense_q(*ptrs, m, n, kd, 1, code, stream)
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")
                row[name] = graph_ms(run)
            wdq = (q.float() * s[:, None]).to(torch.bfloat16)
            row["torch.mm"] = graph_ms(lambda: torch.mm(x, wdq.t()))
            for k, v in row.items():
                total[(form, k)] = total.get((form, k), 0.0) + cnt * v
            print(f"{form} {kd}->{n} M={m}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    for form in ("int8", "fp8"):
        print(f"{form} per b64 forward (ms): " + ", ".join(
            f"{k} {v:.4f}" for (f, k), v in total.items() if f == form),
            flush=True)


def time_checkout():
    """The imported checkout's dense_q through its wrapper, device time."""
    from planer_tpu_torch.ops.kernels import gemm as tg
    rng = np.random.default_rng(0)
    for form in ("int8", "fp8"):
        tot = 0.0
        for kd, n, side, cnt in SHAPES:
            x, q, s, b = _inputs(form, kd, n, 64 * side * side, rng)
            tot += cnt * graph_ms(lambda: tg.dense_q_kernel(x, q, s, b))
        print(f"{Path(tg.__file__).parents[3]} {form} dense_q per b64 "
              f"forward: {tot:.4f} ms (device)", flush=True)


def main(script=__file__, doc=__doc__, what="dense_q",
         time_checkout=time_checkout, study=study):
    """This study's command line, or another ``script``'s."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--other", metavar="DIR",
                    help=f"also time the {what} of the checkout at DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit(f"{Path(script).stem}: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.other:       # the script's timing on the other checkout's port
        root = str(Path(args.other).resolve())
        subprocess.run([sys.executable, "-c", "import runpy, sys; runpy."
                        "run_path(sys.argv[1])['time_checkout']()",
                        str(Path(script).resolve())], cwd=root, check=True,
                       env={**os.environ, "PYTHONPATH": root})
    time_checkout()
    study()


if __name__ == "__main__":
    main()
