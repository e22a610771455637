"""Opcode registry: IR opcode -> torch fn + float32-executor fn + metadata.

The port's counterpart of ``planer_tpu/registry.py``, with every opcode it
registers (the fused ResNet stages ``stage64`` and ``stagen`` among them).
Each opcode has two functions:

  * ``fn`` — what the program runs: the quantized fast paths (int8 codes,
    ``out_scale``/``qadd``, the fused stage kernels);
  * ``oracle_fn`` — what the float32 executor runs on dequantized weights.
    It ignores the quantization annotations, as the JAX package's numpy
    oracle does: the elided quantization is part of the quantized
    program's accuracy budget, not the oracle's.

``static_args`` and ``data_dependent`` mean what they mean in the JAX
package: shape operands that must be host values, ops whose output shape
depends on values.  ``host_args`` are operands an op reads on the host
when they are static (a pad's constant value): the program hands them over
as host values, as the JAX tracer hands every static operand, so no op
reads the device for one (a CUDA graph capture forbids it).  ``cached``
ops get a per-application ``cache`` dict from the program.  ``conv``,
``dense``, ``stage64`` and ``stagen`` take ``plain=True`` as an op
override (``Program.op_overrides``): the program then runs their kernels'
plain versions on any device, the reference the kernels are held against.
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
    host_args: tuple[int, ...] = ()


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
_reg("matmul", tops.matmul)
_reg("maxpool", tops.maxpool)
_reg("averagepool", tops.averagepool)
_reg("gap", tops.global_average_pool)
_reg("lstm", tops.lstm)
_reg("gru", tops.gru)
# fused ResNet entry stage (emitted by optimize.fuse_stage64)
_reg("stage64", tops.stage64, _stage64_f32, cached=True)
# fused ResNet body stage (emitted by optimize.fuse_stagen)
_reg("stagen", tops.stagen, _stagen_f32, cached=True)

# activations / elementwise
_reg("relu", tops.relu)
_reg("leakyrelu", tops.leakyrelu)
_reg("sigmoid", tops.sigmoid)
_reg("hardsigmoid", tops.hardsigmoid)
_reg("tanh", tops.tanh)
_reg("softmax", tops.softmax)
_reg("logsoftmax", tops.logsoftmax)
_reg("clip", tops.clip)
_reg("erf", tops.erf)
_reg("sqrt", tops.sqrt)
_reg("exp", tops.exp)
_reg("log", tops.log)
_reg("reciprocal", tops.reciprocal)
_reg("pow", tops.power)
_reg("add", tops.add, _add_f32)
_reg("sub", tops.sub)
_reg("mul", tops.mul)
_reg("div", tops.div)
_reg("equal", tops.equal)
_reg("greater", tops.greater)
_reg("greaterorequal", tops.greater_or_equal)
_reg("where", tops.where)
_reg("identity", tops.identity)

# normalization
_reg("batchnorm", tops.batchnorm)
_reg("instancenormalization", tops.instance_normalization)
# the port's own (ConvNeXt); the JAX registry has no LayerNorm
_reg("layernorm", tops.layernorm)

# shape / index / tensor (shape operands are host values)
_reg("reshape", tops.reshape, static_args=(1,))
_reg("flatten", tops.flatten)
_reg("transpose", tops.transpose)
_reg("concat", tops.concat)
_reg("split", tops.split, static_args=(1,))
_reg("gather", tops.gather)
_reg("slice", tops.slice_, static_args=(1, 2, 3, 4))
_reg("expand", tops.expand, static_args=(1,))
_reg("tile", tops.tile, static_args=(1,))
_reg("pad", tops.pad, static_args=(1,), host_args=(2,))
_reg("squeeze", tops.squeeze, static_args=(1,))
_reg("unsqueeze", tops.unsqueeze, static_args=(1,))
# the int64 shape as a host value; the program records it as a 'shape'
# application, so it never reaches the device
_reg("shape", tops.shape_of)
_reg("cast", tops.cast)
_reg("const", tops.const)
_reg("constantofshape", tops.constant_of_shape, static_args=(0,))
# an int64 host value from integer bounds (the decode's grid)
_reg("range", tops.arange, static_args=(0, 1, 2))
_reg("scatternd", tops.scatternd)
# its output's shape depends on its input's values: a program cuts there
# and runs the rest in the float32 executor (the host tail)
_reg("nonzero", tops.nonzero, data_dependent=True)
_reg("topk", tops.topk, static_args=(1,))

# reductions
_reg("reducesum", tops.reduce_sum)
_reg("reducemean", tops.reduce_mean)
_reg("reducemax", tops.reduce_max)
_reg("reducemin", tops.reduce_min)

# resize / upsample
_reg("upsample", tops.upsample, static_args=(1,))
_reg("resize", tops.resize_op, static_args=(1, 2, 3))

# extended set (modern ONNX exporters)
_reg("abs", tops.absolute)
_reg("neg", tops.negative)
_reg("min", tops.minimum)
_reg("max", tops.maximum)
_reg("floor", tops.floor)
_reg("ceil", tops.ceil)
_reg("round", tops.round_)
_reg("sign", tops.sign)
_reg("prelu", tops.prelu)
_reg("elu", tops.elu)
_reg("softplus", tops.softplus)
_reg("gelu", tops.gelu)
_reg("argmax", tops.argmax)
_reg("argmin", tops.argmin)
_reg("reduceprod", tops.reduce_prod)
_reg("gmp", tops.global_max_pool)
_reg("spacetodepth", tops.space_to_depth)
_reg("depthtospace", tops.depth_to_space)
_reg("mean", tops.mean_variadic)
_reg("sum", tops.sum_variadic)

# control
_reg("return", tops.return_)


def get_op(name: str) -> OpSpec:
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"unknown opcode {name!r}; known: "
                       f"{sorted(OPS)}") from None
