"""planer_tpu_torch — the PyTorch / CUDA port of planer_tpu for NVIDIA Hopper.

Loads the same JSON flow IR and ``.pla`` files as the JAX package
(``planer_tpu``), reads ``.onnx`` files (``read_net``, ``onnx2pla``, its own
protobuf codec) and torch modules (``torch2planer``, through ``torch.fx``),
runs every opcode of the JAX package's registry (a graph whose shapes
depend on its values runs its tail in the float32 executor), quantizes
the same way (int8 or float8_e4m3fn per-output-channel weights, calibrated
static activation scales, int8 codes chained across convs and residual
adds) and runs the JAX package's model configurations on one CUDA card: INT8 ResNet-18 and ResNet-50, weight-only
FP8 ResNet-50, YOLO-v3 (raw heads or the in-graph box decode, with host
score filter and NMS in ``models.yolo_post``) and UNet (whole or tiled,
``utils.tile``).  The fused entry stage, under ``quantize(fuse="all")`` the
fused body stages, and the weight-only GEMM run as hand-written ``sm_90a``
kernels; NMS is native C++ on the host (``native``).  Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.

Serving: ``ServingEngine`` (continuous batching into batch and spatial
buckets) and ``runtime.http_server`` (``/predict``, ``/stats``,
``/health``); profiling: ``runtime.profiler`` (``cost_report``, ``trace``)
and ``Net.timeit``; ``quant.quantize_auto`` quantizes with per-layer
fallback until an accuracy budget holds.

The package imports torch and numpy only, never jax, ml_dtypes or
planer_tpu.
"""
from .ir import Graph, Layer, FlowEdge, pack_weights, unpack_weights
from .registry import OPS, get_op
from .io import read_net, InferenceSession, save_pla, load_graph, onnx2pla
from .runtime.net import Net
from .runtime.executor import Executor
from .runtime.program import Program, analyze
from .runtime.serving import ServingEngine
from .runtime import profiler
from .quant import (calibrate_act_scales, quantize_net, layer_quant_errors,
                    quantize_auto)
from .convert import net_from_arrays
from . import frontend, models
from .models.builder import GraphBuilder
from .frontend.torch2planer import torch2planer
from .utils.config import Config, get_config, set_config
from .utils.tile import tile, grid_slice, make_slice
from .utils.image import resize, mapcoord, uniform_filter, gaussian_filter
from .utils.zoo import (Model, load, download, downloads, source,
                        list_source, get_source)

__all__ = ["Graph", "Layer", "FlowEdge", "pack_weights", "unpack_weights",
           "OPS", "get_op", "read_net", "InferenceSession", "save_pla",
           "load_graph", "onnx2pla", "torch2planer", "frontend", "Net",
           "Executor", "Program", "analyze", "ServingEngine", "profiler",
           "calibrate_act_scales", "quantize_net", "layer_quant_errors",
           "quantize_auto", "net_from_arrays", "models", "GraphBuilder",
           "Config", "get_config", "set_config", "tile", "grid_slice",
           "make_slice", "resize", "mapcoord", "uniform_filter",
           "gaussian_filter", "Model", "load", "download", "downloads",
           "source", "list_source", "get_source", "core", "asnumpy",
           "asarray"]


def core(obj=None, silent: bool = True):
    """The reference's backend switch, kept for its callers: the port has
    one backend, so this does nothing and returns ``torch``."""
    import torch
    if not silent:
        print("planer_tpu_torch: single torch backend; core() is a no-op")
    return torch


def asnumpy(arr, **kw):
    """A numpy array of ``arr`` (a torch tensor on any device, or an
    array-like).  A bfloat16 tensor widens to float32, exactly: numpy has
    no bfloat16 without ``ml_dtypes``, which the port does not import."""
    import numpy as np
    import torch
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
    return np.asarray(arr, **kw)


def _torch_dtype(dtype):
    """The torch dtype of a torch dtype, a numpy dtype or scalar type
    (``np.float16``, ``np.dtype("int8")``) or a dtype name (``"float32"``,
    ``"bfloat16"``); None stays None."""
    import numpy as np
    import torch
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return out


def asarray(arr, dtype=None, device="cuda", **kw):
    """A torch tensor of ``arr`` (``torch.as_tensor``) on the CUDA card, or
    on ``device`` where the caller names one (``device="cpu"``).  ``dtype``
    may be a torch dtype, a numpy one or a dtype name, and is kept as
    given; without one, the dtype is ``jnp.asarray``'s with 64-bit mode
    off: float64 becomes float32, and int64 (a Python int list among them)
    int32.  Raises where no card is available and none was named."""
    import torch
    from .device import narrow_64bit, resolve_device
    dev = resolve_device(device)
    t = torch.as_tensor(arr, dtype=_torch_dtype(dtype), **kw)
    if dtype is None:
        t = narrow_64bit(t)
    return t.to(dev)
