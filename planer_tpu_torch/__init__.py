"""planer_tpu_torch — the PyTorch / CUDA port of planer_tpu for NVIDIA Hopper.

Loads the same JSON flow IR and ``.pla`` files as the JAX package
(``planer_tpu``), quantizes the same way (int8 or float8_e4m3fn
per-output-channel weights, calibrated static activation scales, int8 codes
chained across convs and residual adds) and runs INT8 ResNet-18 and
ResNet-50 and weight-only FP8 ResNet-50 on one CUDA card, with the fused
entry stage, under ``quantize(fuse="all")`` the fused body stages, and the
weight-only GEMM as hand-written ``sm_90a`` kernels.  Entry points run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.

The package imports torch and numpy only, never jax, ml_dtypes or
planer_tpu.
"""
from .ir import Graph, Layer, FlowEdge, pack_weights, unpack_weights
from .io import read_net, InferenceSession, save_pla, load_graph
from .runtime.net import Net
from .quant import calibrate_act_scales, quantize_net
from .convert import net_from_arrays
from . import models

__all__ = ["Graph", "Layer", "FlowEdge", "pack_weights", "unpack_weights",
           "read_net", "InferenceSession", "save_pla", "load_graph", "Net",
           "calibrate_act_scales", "quantize_net", "net_from_arrays",
           "models"]
