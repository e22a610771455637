"""Opcode registry: IR opcode -> torch fn + float32-executor fn + metadata.

The port's counterpart of ``planer_tpu/registry.py``, holding the opcodes of
the ResNets (with the fused stages ``stage64`` and ``stagen``), of YOLO-v3
(its backbone, FPN heads and in-graph box decode) and of UNet, and
``return``.  Each opcode has two functions:

  * ``fn`` — what the program runs: the quantized fast paths (int8 codes,
    ``out_scale``/``qadd``, the fused stage kernels);
  * ``oracle_fn`` — what the float32 executor runs on dequantized weights.
    It ignores the quantization annotations, as the JAX package's numpy
    oracle does: the elided quantization is part of the quantized
    program's accuracy budget, not the oracle's.

``static_args`` and ``data_dependent`` mean what they mean in the JAX
package: shape operands that must be host values, ops whose output shape
depends on values.  ``cached`` ops get a per-application ``cache`` dict
from the program.  ``conv``, ``dense``, ``stage64`` and ``stagen`` take
``plain=True`` as an op override (``Program.op_overrides``): the program
then runs their kernels' plain versions on any device, the reference the
kernels are held against.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .ops import torch_ops as tops

__all__ = ["OpSpec", "OPS", "get_op"]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    fn: Callable
    oracle_fn: Callable
    static_args: tuple[int, ...] = ()
    data_dependent: bool = False
    cached: bool = False


OPS: dict[str, OpSpec] = {}


def _reg(name, fn, oracle_fn=None, static_args=(), **kw):
    OPS[name] = OpSpec(name, fn, oracle_fn or fn, tuple(static_args), **kw)


def _conv_f32(x, K, B=None, out_scale=None, compute_dtype=None, **kw):
    return tops.conv2d(x, K, B, **kw)


def _add_f32(a, b, qadd=None, compute_dtype=None):
    return a + b


def _stage64_f32(x, Ws, Bs, *bw, blocks=None, out_scale=None, **kw):
    from .ops.kernels.stage64 import decomposed
    return decomposed(x, Ws, Bs, *bw)


def _stagen_f32(x, *w, blocks=None, **kw):
    from .ops.kernels.stagen import decomposed
    return decomposed(x, *w, blocks=blocks)


# compute
_reg("conv", tops.conv2d, _conv_f32)
_reg("convtranspose", tops.conv_transpose2d)
_reg("dense", tops.dense)
_reg("maxpool", tops.maxpool)
_reg("gap", tops.global_average_pool)
# fused ResNet entry stage (emitted by optimize.fuse_stage64)
_reg("stage64", tops.stage64, _stage64_f32, cached=True)
# fused ResNet body stage (emitted by optimize.fuse_stagen)
_reg("stagen", tops.stagen, _stagen_f32, cached=True)

# elementwise
_reg("relu", tops.relu)
_reg("leakyrelu", tops.leakyrelu)
_reg("sigmoid", tops.sigmoid)
_reg("clip", tops.clip)
_reg("exp", tops.exp)
_reg("add", tops.add, _add_f32)
_reg("mul", tops.mul)
_reg("batchnorm", tops.batchnorm)

# shape
_reg("reshape", tops.reshape, static_args=(1,))
_reg("flatten", tops.flatten)
_reg("transpose", tops.transpose)
_reg("concat", tops.concat)
_reg("gather", tops.gather)
_reg("slice", tops.slice_, static_args=(1, 2, 3, 4))
_reg("expand", tops.expand, static_args=(1,))
_reg("unsqueeze", tops.unsqueeze, static_args=(1,))
# the int64 shape as a host value; the program records it as a 'shape'
# application, so it never reaches the device
_reg("shape", tops.shape_of)
_reg("cast", tops.cast)
# an int64 host value from integer bounds (the decode's grid)
_reg("range", tops.arange, static_args=(0, 1, 2))

# resize
_reg("upsample", tops.upsample, static_args=(1,))

# control
_reg("return", tops.return_)


def get_op(name: str) -> OpSpec:
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"opcode {name!r} is not ported yet; ported: "
                       f"{sorted(OPS)}") from None
