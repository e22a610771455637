"""Build and load the port's CUDA sources (``planer_tpu_torch/csrc/*.cu``).

Each source compiles on first use, with ``nvcc`` for Hopper (``sm_90a``),
into its own shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so a build takes seconds).  A library's file
name carries a digest of its source, the headers beside it and the flags, so
a changed source rebuilds and an unchanged one loads from disk.  Sources are
compiled in parallel, one ``nvcc`` process each.

The build directory is ``build/planer_tpu_torch`` at the repository root
(listed in ``.gitignore``), or ``$PLANER_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SRC_DIR", "build", "load", "build_log"]

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    env = os.environ.get("PLANER_TORCH_BUILD_DIR")
    d = Path(env) if env else SRC_DIR.parents[1] / "build" / "planer_tpu_torch"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit (set CUDACXX)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) of
    the current build of ``name``, or '' when it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing library among ``names`` (default: every
    ``csrc/*.cu``) in parallel.  Returns {name: seconds spent building},
    0.0 for a library already on disk.  Raises with nvcc's output if a
    build fails."""
    names = names or sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    nvcc = _nvcc() if any(not _lib_path(n).exists() for n in names) else None
    procs, took = {}, {}
    t0 = time.perf_counter()
    for n in names:
        out = _lib_path(n)
        if out.exists():
            took[n] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for n, (p, tmp, out, log) in procs.items():
        rc = p.wait()
        log.close()
        took[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(build_log(n) for n in failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
