"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions and the wrappers that choose between them by device.

The package is also the kernels' inventory, through which the runtime
counts, names and keys them.  A kernel module is a loaded module under it
that defines ``LAUNCHES`` (the benchmark's rule) and declares beside it
``KERNEL_NAMES`` ((launch-key prefix, CUDA kernel name) pairs) and, where
it has them, ``FALLOFF`` (merged under ``FALLOFF_PREFIX``, by default
``<module>_``) and ``SWITCHES`` (the names of its flags read at call time).
"""
from __future__ import annotations

import importlib
import pkgutil
import sys

_PKG = __name__ + "."
_switched = None        # (module, its SWITCHES) as the last scan found them


def modules() -> dict:
    """{name: module} of every loaded kernel module, in name order (the
    first call imports the package's own)."""
    global _switched
    if _switched is None:
        for info in pkgutil.iter_modules(__path__):
            importlib.import_module(_PKG + info.name)
    found = dict(sorted((k[len(_PKG):], m) for k, m in list(
        sys.modules.items()) if k.startswith(_PKG) and hasattr(m, "LAUNCHES")))
    _switched = [(m, m.SWITCHES) for m in found.values()
                 if hasattr(m, "SWITCHES")]
    return found


def counters() -> dict:
    """{(module, "LAUNCHES" or "FALLOFF"): its Counter}."""
    return {(n, c): getattr(m, c) for n, m in modules().items()
            for c in ("LAUNCHES", "FALLOFF") if hasattr(m, c)}


def kernel_names(delta) -> dict:
    """{CUDA kernel name: launches} of a delta of ``counters()`` (a launch
    key that no ``KERNEL_NAMES`` prefix matches names itself)."""
    out: dict[str, int] = {}
    for (mod, c), launched in delta.items():
        if c != "LAUNCHES":
            continue
        table = getattr(sys.modules[_PKG + mod], "KERNEL_NAMES", ())
        for key, n in launched.items():
            name = next((k for p, k in table if key.startswith(p)), key)
            out[name] = out.get(name, 0) + n
    return out


def switches() -> tuple:
    """The values of the ``SWITCHES`` of the modules the last ``modules()``
    found, in order: a call reads flags and scans nothing."""
    if _switched is None:
        modules()
    return tuple(getattr(m, s) for m, names in _switched for s in names)


def falloff() -> dict:
    """Every kernel module's ``FALLOFF`` reasons, merged."""
    return {getattr(m, "FALLOFF_PREFIX", n + "_") + k: v
            for n, m in modules().items()
            for k, v in getattr(m, "FALLOFF", {}).items()}
