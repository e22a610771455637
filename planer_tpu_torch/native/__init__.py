"""Native host-side kernels (C++ through ctypes): greedy NMS and the YOLO
score filter, a copy of ``planer_tpu/native``, and the staging copy of a
program's host inputs into its pinned buffers (``stage_copy``).

``nms.cpp`` compiles with ``g++`` on first use into the port's build
directory (``build/planer_tpu_torch`` at the repository root, or
``$PLANER_TORCH_BUILD_DIR``), under a file name that carries a digest of the
source and the flags, so a changed source rebuilds and an unchanged one
loads from disk.  There is no fallback: a failed build raises with the
compiler's output (the JAX package falls back to numpy quietly), and
``available()`` only reports whether the library builds and loads.  The numpy
versions, ``models.yolo_post._nms_numpy`` and ``score_filter_numpy`` here,
are what the tests hold the native code against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["nms", "score_filter", "score_filter_numpy", "stage_copy", "load",
           "available"]

SRC = Path(__file__).resolve().with_name("nms.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    from ..ops.kernels.build import _build_dir
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _build_dir() / f"libnms-{h.hexdigest()[:16]}.so"


def _build(out: Path):
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if not cxx:
        raise RuntimeError(f"{name} not found: planer_tpu_torch.native "
                           f"builds nms.cpp on first use (set CXX)")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is not on disk."""
    global _lib
    if _lib is None:
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        fp, ip = (ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int64))
        lib.planer_nms.restype = ctypes.c_int64
        lib.planer_nms.argtypes = [fp, fp, ctypes.c_int64,
                                   ctypes.c_float, ctypes.c_int64, ip]
        lib.planer_score_filter.restype = ctypes.c_int64
        lib.planer_score_filter.argtypes = [
            fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ip,
            ip, fp]
        lib.planer_stage_copy.restype = None
        lib.planer_stage_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads (False where ``g++`` is missing
    or fails).  A query only: ``nms`` and ``score_filter`` raise instead of
    falling back."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.45,
        top_k: int = 300) -> np.ndarray:
    """Greedy NMS on (n, 4) [cx, cy, w, h] float32 boxes; returns the kept
    indices in descending score order (equal scores by index)."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = scores.shape[0]
    if boxes.shape != (n, 4):
        raise ValueError(f"nms: boxes {boxes.shape} for {n} scores")
    keep = np.empty(max(min(n, top_k), 0), np.int64)
    cnt = load().planer_nms(_fptr(boxes), _fptr(scores), n,
                            ctypes.c_float(iou_thresh), keep.shape[0],
                            _iptr(keep))
    return keep[:cnt].copy()


def score_filter(dec: np.ndarray, conf_thresh: float):
    """(idx, cls_id, score) of the rows of ``dec`` (n, 5 + C) whose
    obj * max(cls) reaches ``conf_thresh``."""
    dec = np.ascontiguousarray(dec, np.float32)
    if dec.ndim != 2 or dec.shape[1] < 6:
        raise ValueError(f"score_filter: rows of 5 + C, got {dec.shape}")
    n, w = dec.shape
    idx = np.empty(n, np.int64)
    cls = np.empty(n, np.int64)
    sc = np.empty(n, np.float32)
    cnt = load().planer_score_filter(_fptr(dec), n, w - 5,
                                     ctypes.c_float(conf_thresh),
                                     _iptr(idx), _iptr(cls), _fptr(sc))
    return idx[:cnt].copy(), cls[:cnt].copy(), sc[:cnt].copy()


def score_filter_numpy(dec: np.ndarray, conf_thresh: float):
    """The plain version of :func:`score_filter`."""
    scores = dec[:, 4:5] * dec[:, 5:]
    cls_id = scores.argmax(1)
    cls_sc = scores.max(1)
    m = cls_sc >= conf_thresh
    return np.nonzero(m)[0], cls_id[m], cls_sc[m]


def stage_copy(dst, src):
    """Copy the host tensor ``src`` into ``dst``, a contiguous host tensor
    of its dtype and shape (a pinned staging buffer), with non-temporal
    stores; a non-contiguous ``src`` is copied by torch."""
    if dst.shape != src.shape or dst.dtype != src.dtype \
            or not (dst.is_cpu and src.is_cpu and dst.is_contiguous()):
        raise ValueError(f"stage_copy: {src.dtype}{list(src.shape)} on "
                         f"{src.device} into {dst.dtype}{list(dst.shape)} "
                         f"on {dst.device}")
    if not src.is_contiguous():
        dst.copy_(src)
        return
    load().planer_stage_copy(dst.data_ptr(), src.data_ptr(), src.nbytes)
