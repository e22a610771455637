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

The package imports torch and numpy only, never jax, ml_dtypes or
planer_tpu.
"""
from .ir import Graph, Layer, FlowEdge, pack_weights, unpack_weights
from .io import read_net, InferenceSession, save_pla, load_graph, onnx2pla
from .runtime.net import Net
from .quant import calibrate_act_scales, quantize_net
from .convert import net_from_arrays
from . import frontend, models
from .frontend.torch2planer import torch2planer
from .utils import tile

__all__ = ["Graph", "Layer", "FlowEdge", "pack_weights", "unpack_weights",
           "read_net", "InferenceSession", "save_pla", "load_graph",
           "onnx2pla", "torch2planer", "frontend", "Net",
           "calibrate_act_scales", "quantize_net", "net_from_arrays",
           "models", "tile"]
