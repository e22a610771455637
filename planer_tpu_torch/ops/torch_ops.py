"""PyTorch op library — the port's counterpart of ``planer_tpu/ops/jax_ops.py``:
one function per opcode of the JAX package's registry.

Each function takes and returns NCHW tensors on one device.  The precision
branches of ``conv2d`` and the code-domain ``add`` reproduce the JAX
package's numerics, not just its math:

  * quantize to codes rounding half to even (``torch.round``).  A static
    scale s quantizes as ``x * f32(1 / f32(s))``: the JAX source divides,
    but in the compiled program s is a constant and XLA's algebraic
    simplifier rewrites ``x / const`` into ``x * (1 / const)`` with the
    reciprocal rounded to float32 — that product is what the reference
    computes (``quantize``).  A scale computed at run time (dynamic
    activation quantization) stays a true division by a device tensor;
  * s8 x s8 convs accumulate exactly in int32 (``torch._int_mm`` over a
    patch matrix, ``conv_s8``): |acc| reaches 127^2 * 4608 > 2^24, past
    float32's exact range;
  * dequant is ``acc.float() * (sx * w_scale)`` with the scale product taken
    first, cast to the output dtype, and the bias added after the cast;
  * a quantized ``dense``, and with ``_PALLAS_CONV1X1`` a weight-only 1x1
    conv, go through ``ops/kernels/gemm.dense_q``, which picks the numerics
    of the reference's kernel branch or of its fallback by shape.

The ops YOLO-v3 and UNet add copy the reference's arithmetic where torch
would round otherwise: ``leakyrelu`` multiplies by alpha rounded to x's
dtype, and the binary ops and ``concat`` promote by dtype alone, as
``jnp.result_type`` does (torch lets a 0-dim operand lose to a dimensioned
one of the same kind).

The rest of the op library computes what the JAX function computes as
XLA compiles it, not what the ONNX spec says: a Python scalar in an
expression is rounded to x's dtype first (JAX's weak typing; ``scalar``),
``softplus`` is ``logaddexp(x, 0)``, ``gelu`` is ``0.5 * x * erfc(-x *
sqrt(0.5))``, bf16 sums, means and products run in float32 and round once,
``topk`` orders ties by index as ``lax.top_k`` does (a stable sort), and
``div`` of integers is true division.  Index results (``topk``, ``argmax``,
``argmin``, ``nonzero``) are int64, as ONNX has them; the JAX package
without x64 gives int32 with the same values.

Shape-like operands (reshape targets, slice bounds, upsample scales) may
arrive as numpy arrays or as host or device tensors: the program folds them
on the host, the float32 executor hands them over as it holds them.
``const``, ``constantofshape`` and ``range`` return host values.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..runtime import profiler as _prof
from . import kernels as _kernels
from . import modes as _modes
from . import resize as _rs
from .padding import resolve_conv_pads, resolve_pool_pads
from .qtypes import QTensor

__all__ = ["conv2d", "conv_transpose2d", "dense", "matmul", "maxpool",
           "averagepool", "global_average_pool", "global_max_pool", "lstm",
           "gru", "relu", "leakyrelu", "sigmoid", "hardsigmoid", "tanh",
           "softmax", "logsoftmax", "exp", "log", "sqrt", "erf",
           "reciprocal", "power", "clip", "add", "sub", "mul", "div",
           "equal", "greater", "greater_or_equal", "where", "identity",
           "absolute", "negative", "minimum", "maximum", "floor", "ceil",
           "round_", "sign", "prelu", "elu", "softplus", "gelu",
           "mean_variadic", "sum_variadic", "batchnorm",
           "instance_normalization", "flatten", "reshape", "transpose",
           "concat", "split", "gather", "slice_", "expand", "tile", "pad",
           "squeeze", "unsqueeze", "shape_of", "cast", "const",
           "constant_of_shape", "arange", "scatternd", "nonzero", "topk",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "argmax", "argmin", "space_to_depth",
           "depth_to_space", "upsample", "resize_op", "stage64", "stagen",
           "return_", "conv_s8", "quantize", "scalar", "to_dtype",
           "conv_route", "logical_batch", "logical_rows"]


# opt-in, as in the JAX package (jax_ops._PALLAS_CONV1X1): route quantized
# 1x1 stride-1 ungrouped convs that reach no s8 path to the dense_q GEMM
_PALLAS_CONV1X1 = False

# as in the JAX package (jax_ops._STACK_CONV), read at call time: off, a
# quantized 3x3 conv with at most 64 outputs and C < 128 takes dequant +
# float conv in place of the stacked s8 form
_STACK_CONV = True


def switches() -> tuple:
    """The flags the ops and the hand kernels read at call time: part of
    every program entry's key.  (Not TF32: a program call holds it off.)"""
    return (_PALLAS_CONV1X1, _STACK_CONV, *_kernels.switches(),
            _modes.get_erf_mode())


# the logical batch of ``logical_batch`` (None: the tensors' own)
_LOGICAL_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "logical_batch", default=None)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def to_dtype(name) -> torch.dtype | None:
    """'bfloat16' / 'float32' / torch.dtype / None -> torch.dtype or None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


# device constants made once and kept (0-dim scalars, lookup tables,
# index vectors); a CUDA graph replays them, so none may be made during a
# capture, which would record the fill and never run it
_CONSTS: dict = {}


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _kept(key, device, make):
    t = _CONSTS.get(key)
    if t is None:
        if _capturing(device):
            raise RuntimeError(
                f"device constant {key[:2]} first needed inside a CUDA "
                f"graph capture; the warm run makes every constant the "
                f"program uses")
        t = _CONSTS[key] = make()
    return t


def _scalar_cached(v: float, dtype: torch.dtype, device: torch.device):
    # keyed by the float's bits: -0.0 and nan are values of their own
    return _kept(("scalar", v.hex(), dtype, device), device,
                 lambda: torch.full((), v, dtype=dtype, device=device))


def _const(a, device) -> torch.Tensor:
    """The host array ``a`` on ``device``, made once and kept."""
    a = np.ascontiguousarray(a)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return _kept(("array", a.dtype.str, a.shape, a.tobytes(), device), device,
                 lambda: torch.as_tensor(a, device=device))


def scalar(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A 0-dim ``dtype`` tensor holding the Python float ``v`` on ``like``'s
    device: the float is rounded to ``dtype`` once, as JAX rounds a weakly
    typed Python scalar, and the op stays a true tensor-tensor op."""
    return _scalar_cached(float(v), dtype, like.device)


def _promote(a, b):
    """a and b in their common dtype as ``jnp.result_type`` picks it: by
    dtype alone, where torch would let a 0-dim tensor take the dimensioned
    operand's dtype of the same kind."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a, b


# each s8 conv weight as the GEMM's B operand: (O, kh*kw*C) in (ky, kx, c)
# order, zero-padded to _int_mm's multiples of 8.  Made once per weight
# tensor, on its first call (the warm run, before a capture), and dropped
# with the tensor; keyed by the tensor object, not its storage, so a freed
# weight's address can never name another.  Weights are constants: a
# tensor written in place keeps its old matrix, as stage64's and stagen's
# packed copies do.
_WMATS = WeakIdKeyDictionary()


def _weight_matrix(wq):
    b = _WMATS.get(wq)
    if b is None:
        if _capturing(wq.device):
            raise RuntimeError(
                f"s8 conv weight {tuple(wq.shape)} first needed inside a "
                f"CUDA graph capture; the warm run makes every weight "
                f"matrix the program uses")
        o, c, kh, kw = wq.shape
        k = c * kh * kw
        b = F.pad(wq.permute(0, 2, 3, 1).reshape(o, k),
                  (0, (-k) % 8, 0, (-o) % 8)).contiguous()
        _WMATS[wq] = b
    return b


def _words(x, c):
    """The int8 tensor ``x`` (last dimension ``c`` channels, stride 1) seen
    as int64 words where c % 8 == 0, int32 where c % 4 == 0, else bytes."""
    return (x.view(torch.int64) if c % 8 == 0
            else x.view(torch.int32) if c % 4 == 0 else x)


def conv_s8(q, wq, strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1)):
    """Exact s8 x s8 -> s32 NCHW conv: ``torch._int_mm`` over a patch
    matrix gathered from the codes as they lie in memory.

    The input is read as NHWC: the W8A8 chain's codes are channels-last
    (this conv's output is an NHWC buffer seen as NCHW), so they are read
    in place; an NCHW input is copied to NHWC once, into the padded
    buffer where the conv pads.  The (N*Ho*Wo, kh*kw*C) patch matrix is
    gathered in (ky, kx, c) order, each pixel's channels moved as 8- or
    4-byte words (``_words``); a 1x1 stride-1 conv's NHWC input is the
    matrix itself.  The weight is reordered to match once (``_weight_
    matrix``); integer sums do not depend on the order of K, so the
    accumulators are those of any other order.

    cuBLAS's int8 GEMM needs M > 16 and K, N multiples of 8, so the operands
    are zero-padded up to those minimums (zeros add nothing to the sums).  It
    also needs the patch matrix row-major (cuBLASLt refuses a column-major
    one with a leading dimension of 49 at ResNet-50's layer4, batch 1),
    which every form here is."""
    o, c, kh, kw = wq.shape
    rec = _prof.RECORDING
    x = q.permute(0, 2, 3, 1)
    n, h, w, _ = x.shape
    nhwc = x.is_contiguous()
    pt, pl, pb, pr = pads
    if pt or pl or pb or pr:
        xp = x.new_zeros((n, h + pt + pb, w + pl + pr, c))
        dst = xp[:, pt:pt + h, pl:pl + w]
        if nhwc:
            dst, x = _words(dst, c), _words(x, c)
        dst.copy_(x)
        x = xp
    elif not nhwc:
        x = x.contiguous()
    sh, sw = strides
    dh, dw = dilations
    ho = (x.shape[1] - (kh - 1) * dh - 1) // sh + 1
    wo = (x.shape[2] - (kw - 1) * dw - 1) // sw + 1
    m = n * ho * wo
    if kh == kw == 1 and sh == sw == 1:
        a, path = x.reshape(m, c), "conv_s8.in_place"
    else:
        xw = _words(x, c)
        sn, sy, sx, sc = xw.stride()
        a = xw.as_strided((n, ho, wo, kh, kw, xw.shape[3]),
                          (sn, sy * sh, sx * sw, sy * dh, sx * dw, sc))
        a = a.reshape(m, -1).view(torch.int8)
        path = "conv_s8.bytes" if xw is x else "conv_s8.words"
    if rec is not None:
        rec.count(path)
        if not nhwc:
            rec.count("conv_s8.relayout")
    b = _weight_matrix(wq)
    k = a.shape[1]
    kpad = b.shape[1] - k
    mpad = max(17 - m, 0) if a.is_cuda else 0
    if kpad or mpad:
        a = F.pad(a, (0, kpad, 0, mpad))
    acc = torch._int_mm(a, b.t())[:m, :o]
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def _window_max(x, kh, kw, sh, sw, pads, fill):
    """Reduce-window max over explicitly padded input (fill = the seed)."""
    pt, pl, pb, pr = pads
    xp = F.pad(x, (pl, pr, pt, pb), value=fill)
    ho = (xp.shape[2] - kh) // sh + 1
    wo = (xp.shape[3] - kw) // sw + 1
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = xp[:, :, dy:dy + (ho - 1) * sh + 1:sh,
                   dx:dx + (wo - 1) * sw + 1:sw]
            out = v if out is None else torch.maximum(out, v)
    return out


# --------------------------------------------------------------------------
# conv
# --------------------------------------------------------------------------

def quantize(x, s: float):
    """int8 codes of x at the static scale s: clamp(round(x / s)), with the
    division compiled as the reference compiles it — a multiply by the
    float32 reciprocal of the float32 constant."""
    r = np.float32(1.0) / np.float32(s)
    return torch.clamp(torch.round(x.float() * scalar(r, x)),
                       -127, 127).to(torch.int8)


def _act_quant(x, K):
    """Per-tensor activation quantization: the calibrated constant when
    available, else a dynamic absmax reduction."""
    if K.act_scale is not None:
        return quantize(x, K.act_scale), scalar(K.act_scale, x)
    sx = torch.clamp_min(x.abs().amax(), 1e-6).float() / 127.0
    q = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return q, sx


def _conv_w8a8(x, K, B, strides, dilations, pads, pre_quantized=False,
               compute_dtype=None):
    """Per-tensor activation quant + s8 x s8 -> s32 conv + dequant.

    ``pre_quantized``: x already holds int8 codes at K.act_scale; skip the
    quantize pass and emit the program compute dtype."""
    if pre_quantized:
        odt = to_dtype(compute_dtype) or torch.float32
        q, sx = x, scalar(K.act_scale, x)
    else:
        (q, sx), odt = _act_quant(x, K), x.dtype
    acc = conv_s8(q, K.q, strides, pads, dilations)
    w_scale = K.scale.reshape(1, -1, 1, 1)
    out = (acc.float() * (sx * w_scale)).to(odt)
    if B is not None:
        out = out + B.reshape(1, -1, 1, 1).to(odt)
    return out


@contextlib.contextmanager
def logical_batch(n):
    """Context in which every shape gate reads a leading (batch) dimension
    as ``n``.  A sharded program (``parallel``) runs an op on one shard of
    its batch, but the JAX program it mirrors is traced at the logical
    (unsharded) shapes, so the gates must take their decisions there."""
    token = _LOGICAL_BATCH.set(n)
    try:
        yield
    finally:
        _LOGICAL_BATCH.reset(token)


def logical_rows(rows: int, lead: int) -> int:
    """``rows`` of a tensor whose leading dimension is ``lead``, counted at
    the logical batch of ``logical_batch`` (unchanged outside one)."""
    n = _LOGICAL_BATCH.get()
    return rows if n is None or not lead else rows * n // lead


def _int8_codes(xshape, xdtype, K, group) -> bool:
    """Whether a conv's int8 input holds activation codes at K.act_scale
    (the contract of int8 activations)."""
    return (xdtype == torch.int8 and K.q.dtype == torch.int8
            and K.act_scale is not None and len(xshape) == 4
            and int(group or 1) == 1)


def conv_route(xshape, xdtype, K, group=1, strides=None, dilations=None,
               pads=None, auto_pad=None) -> str:
    """The arithmetic a conv with weight ``K`` takes on an input of shape
    ``xshape`` and dtype ``xdtype``: ``"s8"`` (int8 codes with C >= 128
    straight into the s8 conv), ``"w8a8"`` (per-tensor activation quant and
    an exact s8 conv), ``"gemm"`` or ``"gemm_fallback"`` (the opt-in 1x1
    route through ``dense_q``'s kernel branch or its fallback), or
    ``"float"`` (dequant and a float conv; int8 codes with C < 128 are
    decoded to the compute dtype first).  The gates are the JAX package's
    and read the shapes given, the batch counted at ``logical_batch``: a
    program that runs an op in pieces (``parallel``) asks for the route of
    the logical (unsharded) op and forces it on each piece."""
    if not isinstance(K, QTensor):
        return "float"
    kshape = tuple(K.shape)
    group = int(group or 1)
    strides = (1, 1) if strides is None else tuple(int(s) for s in strides)
    dilations = ((1, 1) if dilations is None
                 else tuple(int(d) for d in dilations))
    if auto_pad:
        pads = resolve_conv_pads(tuple(xshape[2:]), kshape[2:], strides,
                                 dilations, pads, auto_pad)
    pads = (0, 0, 0, 0) if pads is None else tuple(int(p) for p in pads)
    floating = xdtype.is_floating_point
    if _int8_codes(xshape, xdtype, K, group):
        if xshape[1] >= 128:
            return "s8"
        floating = True
    x4 = len(xshape) == 4
    rows = logical_rows(int(np.prod(xshape[:1] + tuple(xshape[2:]),
                                    dtype=np.int64)), xshape[0] if x4 else 0)
    quantized = (K.act_dynamic or K.act_scale is not None) \
        and K.q.dtype == torch.int8
    if (quantized and x4 and xshape[1] >= 128 and group == 1
            and rows >= 4096 and floating):
        return "w8a8"
    # the JAX package's output-row stacking gate (jax_ops._conv2d): the
    # same exact int32 sums and per-channel dequant in another TPU layout
    stackable = (
        _STACK_CONV and len(kshape) == 4 and kshape[2:] == (3, 3)
        and kshape[0] <= 64 and group == 1
        and strides == (1, 1) and dilations == (1, 1)
        and pads == (1, 1, 1, 1) and x4
        and xshape[2] % 2 == 0 and xshape[2] >= 4
        and rows >= 100_000 and xshape[3] <= 128)
    if stackable and quantized and floating:
        return "w8a8"
    # the JAX package's opt-in 1x1 route: a 1x1 stride-1 ungrouped conv is
    # a GEMM over (N*H*W, C), handed to dense_q (kernel branch where the
    # shape tiles, its fallback's numerics elsewhere)
    if (_PALLAS_CONV1X1 and len(kshape) == 4 and kshape[2:] == (1, 1)
            and group == 1 and strides == (1, 1)
            and pads == (0, 0, 0, 0)):
        from .kernels import gemm
        plan = gemm.tile_plan(rows, kshape[0], kshape[1])
        return "gemm" if plan is not None else "gemm_fallback"
    return "float"


def conv2d(x, K, B=None, group=1, strides=(1, 1), dilations=(1, 1),
           pads=(0, 0, 0, 0), auto_pad=None, out_scale=None,
           compute_dtype=None, plain=False, route=None):
    """2-D convolution with optional int8 activation-code emission
    (``out_scale``: re-emit the output as codes at that scale).  ``plain``
    (an op override) runs the dense_q GEMM of the 1x1 route on its plain
    version on any device.  ``route`` forces a ``conv_route``: a program
    that runs the op in pieces (``parallel``) gives the logical op's."""
    out = _conv2d(x, K, B, group=group, strides=strides, dilations=dilations,
                  pads=pads, auto_pad=auto_pad, compute_dtype=compute_dtype,
                  plain=plain, route=route)
    if out_scale is None:
        return out
    return quantize(out, out_scale)


def _conv2d(x, K, B=None, group=1, strides=(1, 1), dilations=(1, 1),
            pads=(0, 0, 0, 0), auto_pad=None, compute_dtype=None,
            plain=False, route=None):
    kshape = tuple(K.shape)
    strides = (1, 1) if strides is None else tuple(int(s) for s in strides)
    dilations = (1, 1) if dilations is None else tuple(int(d) for d in dilations)
    if auto_pad:
        pads = resolve_conv_pads(x.shape[2:], kshape[2:], strides, dilations,
                                 pads, auto_pad)
    pads = (0, 0, 0, 0) if pads is None else tuple(int(p) for p in pads)
    if isinstance(K, QTensor):
        if route is None:
            route = conv_route(tuple(x.shape), x.dtype, K, group, strides,
                               dilations, pads)
        rec = _prof.RECORDING
        if rec is not None:     # where the list runs on the host, not a replay
            rec.count("conv.route." + route)
        if route == "s8":                  # int8 codes, no quantize pass
            return _conv_w8a8(x, K, B, strides, dilations, pads,
                              pre_quantized=True,
                              compute_dtype=compute_dtype)
        if _int8_codes(x.shape, x.dtype, K, group):
            # C < 128: decode the codes to the compute dtype
            odt = to_dtype(compute_dtype) or torch.float32
            x = x.to(odt) * scalar(K.act_scale, x, odt)
        if route == "w8a8":
            return _conv_w8a8(x, K, B, strides, dilations, pads)
        if route in ("gemm", "gemm_fallback"):
            from .kernels import gemm
            n, c, h, w = x.shape
            o = K.q.shape[0]
            xm = x.permute(0, 2, 3, 1).reshape(-1, c)      # (NHW, C)
            kq = QTensor(K.q.reshape(o, c), K.scale.reshape(o, 1))
            y = gemm.dense_q(xm, kq, B, plain=plain,
                             branch="kernel" if route == "gemm"
                             else "fallback")
            return y.reshape(n, h, w, o).permute(0, 3, 1, 2)
        K = K.dequant(x.dtype)
    pt, pl, pb, pr = pads
    if (pt, pl) == (pb, pr):
        out = F.conv2d(x, K.to(x.dtype), None, strides, (pt, pl), dilations,
                       int(group))
    else:
        out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), K.to(x.dtype), None,
                       strides, 0, dilations, int(group))
    if B is not None:
        out = out + B.reshape(1, -1, 1, 1).to(out.dtype)
    return out


def conv_transpose2d(x, K, B=None, strides=(2, 2), dilations=(1, 1),
                     pads=(0, 0, 0, 0), output_padding=(0, 0), group=1):
    """ONNX ConvTranspose.  Its weight layout, (C_in, C_out/g, kh, kw), is
    ``F.conv_transpose2d``'s; a QTensor weight dequantizes (scales on axis
    1) to x's dtype, as in the reference.  ONNX pads may differ per side, so
    the transposed conv runs unpadded and the result is cropped by the pads
    (a negative ``F.pad``), with ``output_padding`` rows and columns added
    at the far end: those lie past every input tap, so they hold the bias
    alone, as in the reference's input-dilated conv with the IO-transposed,
    flipped kernel (jax_ops.conv_transpose2d)."""
    strides = (2, 2) if strides is None else tuple(int(s) for s in strides)
    dilations = (1, 1) if dilations is None else tuple(int(d) for d in dilations)
    pt, pl, pb, pr = (0, 0, 0, 0) if pads is None else (int(p) for p in pads)
    oph, opw = (0, 0) if output_padding is None else (
        int(p) for p in output_padding)
    if isinstance(K, QTensor):
        K = K.dequant(x.dtype)
    out = F.conv_transpose2d(x, K.to(x.dtype), None, strides, 0, 0,
                             int(group), dilations)
    crop = (-pl, opw - pr, -pt, oph - pb)
    if any(crop):
        out = F.pad(out, crop)
    if B is not None:
        out = out + B.reshape(1, -1, 1, 1).to(out.dtype)
    return out


# --------------------------------------------------------------------------
# dense / pool
# --------------------------------------------------------------------------

def dense(x, K, B=None, shp=None, plain=False, branch=None):
    """y = x @ K.T + B.  A quantized K goes through ``gemm.dense_q``, as in
    the JAX package: its kernel branch where the shape tiles, its fallback's
    numerics elsewhere (the ResNet fc).  ``plain`` (an op override) runs the
    kernel branch's plain version on any device; ``branch`` (a sharded
    program's) forces the branch the unsharded GEMM takes."""
    if isinstance(K, QTensor):
        from .kernels import gemm
        return gemm.dense_q(x, K, B, plain=plain, branch=branch)
    # bf16 operands are exact in f32, so an f32 product is the f32-accumulated
    # bf16 dot (TF32 is off inside every program and executor call)
    y = torch.matmul(x.float(), K.to(x.dtype).float().t()).to(x.dtype)
    if B is not None:
        y = y + B.reshape(1, -1).to(y.dtype)
    return y


def matmul(x, y):
    """``jnp.matmul`` with float32 accumulation, cast to x's dtype; a
    QTensor operand dequantizes to the other's dtype first."""
    if isinstance(y, QTensor):
        y = y.dequant(x.dtype)
    if isinstance(x, QTensor):
        x = x.dequant(y.dtype)
    odt = x.dtype
    x, y = _promote(x, y)
    return torch.matmul(x.float(), y.float()).to(odt)


def maxpool(x, w=(2, 2), pads=(0, 0, 0, 0), strides=(2, 2), auto_pad=None,
            ceil_mode=0, impl=None):
    """MaxPool with reduce-window semantics (-inf seed for floats, the
    dtype's minimum for integers).  ``impl`` is a TPU lowering hint of the
    JAX package with identical values; ignored."""
    del impl
    w = (2, 2) if w is None else w
    (pt, pl, pb, pr), (eh, ew) = resolve_pool_pads(
        x.shape[2:], w, strides, pads, auto_pad, ceil_mode)
    kh, kw = (int(v) for v in w)
    sh, sw = (2, 2) if strides is None else (int(strides[0]), int(strides[1]))
    fill = (float("-inf") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    return _window_max(x, kh, kw, sh, sw, (pt, pl, pb + eh, pr + ew), fill)


def _window_sum(x, kh, kw, sh, sw, pads):
    """Reduce-window sum over zero-padded input, taps added in row-major
    window order in x's dtype."""
    pt, pl, pb, pr = pads
    xp = F.pad(x, (pl, pr, pt, pb))
    ho = (xp.shape[2] - kh) // sh + 1
    wo = (xp.shape[3] - kw) // sw + 1
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = xp[:, :, dy:dy + (ho - 1) * sh + 1:sh,
                   dx:dx + (wo - 1) * sw + 1:sw]
            out = v if out is None else out + v
    return out


def averagepool(x, w=(2, 2), pads=(0, 0, 0, 0), strides=(2, 2),
                count_include_pad=1, auto_pad=None, ceil_mode=0):
    """ONNX AveragePool as the reference computes it: a window sum over the
    padded (and ceil-mode extended) input, divided by the window's overlap
    with the padded extent (``count_include_pad``) or with the input; ceil
    mode's virtual extension never enters the divisor."""
    w = (2, 2) if w is None else w
    (pt, pl, pb, pr), (eh, ew) = resolve_pool_pads(
        x.shape[2:], w, strides, pads, auto_pad, ceil_mode)
    kh, kw = (int(v) for v in w)
    sh, sw = (2, 2) if strides is None else (int(strides[0]), int(strides[1]))
    pad4 = (pt, pl, pb + eh, pr + ew)
    s = _window_sum(x, kh, kw, sh, sw, pad4)
    # the divisor is a constant: the compiled division is a float32
    # multiply by its reciprocal
    if count_include_pad and (eh, ew) == (0, 0):
        return (s.float() * scalar(_recip(kh * kw), s)).to(x.dtype)
    if count_include_pad:
        ones = torch.ones((1, 1, x.shape[2] + pt + pb, x.shape[3] + pl + pr),
                          device=x.device)
        cpad = (0, 0, eh, ew)
    else:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), device=x.device)
        cpad = pad4
    recip = 1.0 / _window_sum(ones, kh, kw, sh, sw, cpad)
    return (s.float() * recip).to(x.dtype)


def global_average_pool(x):
    return x.mean(dim=(-2, -1), keepdim=True)


def global_max_pool(x):
    return x.amax(dim=(-2, -1), keepdim=True)


# --------------------------------------------------------------------------
# recurrent (ONNX LSTM and GRU, a Python loop over time steps)
# --------------------------------------------------------------------------

def _mm(a, b, dtype):
    """a @ b.T accumulated in float32, cast to ``dtype``."""
    return torch.matmul(a.float(), b.float().t()).to(dtype)


def _seq_plan(L, d, sequence_lens, device):
    """Per-direction ragged-sequence plan (``jax_ops._seq_plan``): state
    frozen past each sequence's length, padded outputs zero, the reverse
    direction reversed within each sequence's valid region.

    Returns ``(reorder, mask)``: ``reorder(xs)`` maps the padded batch into
    scan order (an involution: applied again it restores output order);
    ``mask`` is the (L, N) validity of each step, or None."""
    if sequence_lens is None:
        if d == 1:
            return (lambda a: a), None
        return (lambda a: a.flip(0)), None
    lens = _tensor(sequence_lens).to(device=device,
                                     dtype=torch.long).reshape(-1)
    steps = torch.arange(L, device=device)
    mask = steps[:, None] < lens[None, :]                        # (L, N)
    if d == 1:
        return (lambda a: a), mask
    idx = torch.clamp(lens[None, :] - 1 - steps[:, None], min=0)  # (L, N)

    def reorder(a):
        return torch.take_along_dim(a, idx[:, :, None], dim=0)
    return reorder, mask


def _rnn(xw, sequence_lens, direction, step, states0):
    """Run ``step(di, x_t, states) -> states`` (states[0] is h) over each
    direction's input projection ``xw[di]`` (L, N, G); returns (Y, the
    final states per direction)."""
    dirs = {"forward": [1], "reverse": [-1],
            "bidirectional": [1, -1]}[direction]
    L, dev = xw[0].shape[0], xw[0].device
    ys_all, finals = [], []
    for di, d in enumerate(dirs):
        reorder, mask = _seq_plan(L, d, sequence_lens, dev)
        xs, states, ys = reorder(xw[di]), states0(di), []
        for t in range(L):
            new = step(di, xs[t], states)
            if mask is not None:      # freeze state past each length
                m = mask[t][:, None]
                new = tuple(torch.where(m, n, s) for n, s in zip(new, states))
            states = new
            ys.append(states[0])
        ys = reorder(torch.stack(ys, 0))
        if mask is not None:          # padded steps emit zeros (ONNX)
            _, valid = _seq_plan(L, 1, sequence_lens, dev)
            ys = torch.where(valid[:, :, None], ys,
                             torch.zeros((), dtype=ys.dtype, device=dev))
        ys_all.append(ys)
        finals.append(states)
    return torch.stack(ys_all, 1), finals


def lstm(X, W, R, B=None, sequence_lens=None, initial_h=None, initial_c=None,
         hidden_size=None, direction="forward"):
    """ONNX LSTM (iofc gate order) as ``jax_ops.lstm`` computes it: the input
    projection for the whole sequence first, then per step ``x_t + h @ R.T
    + (Wb + Rb)``, each product accumulated in float32 and cast to X's
    dtype.  Returns (Y, Y_h, Y_c)."""
    N, H = X.shape[1], R.shape[-1]
    xw = [torch.einsum("lnd,gd->lng", X.float(), W[di].float()).to(X.dtype)
          for di in range(W.shape[0])]
    bias = [(B[di][:4 * H] + B[di][4 * H:]) if B is not None else 0.0
            for di in range(W.shape[0])]

    def zeros():
        return torch.zeros((N, H), dtype=X.dtype, device=X.device)

    def states0(di):
        return (initial_h[di] if initial_h is not None else zeros(),
                initial_c[di] if initial_c is not None else zeros())

    def step(di, t, states):
        ht, ct = states
        gates = t + _mm(ht, R[di], X.dtype) + bias[di]
        i, o, f, c = gates.chunk(4, -1)
        i, o, f = sigmoid(i), sigmoid(o), sigmoid(f)
        cn = f * ct + i * torch.tanh(c)
        return o * torch.tanh(cn), cn

    Y, finals = _rnn(xw, sequence_lens, direction, step, states0)
    return (Y, torch.stack([s[0] for s in finals], 0),
            torch.stack([s[1] for s in finals], 0))


def gru(X, W, R, B=None, sequence_lens=None, initial_h=None,
        hidden_size=None, direction="forward", linear_before_reset=0):
    """ONNX GRU (zrh gate order) as ``jax_ops.gru`` computes it: the input
    projection plus Wb for the whole sequence first, then per step the
    recurrent products (float32 accumulation, cast to X's dtype) plus Rb,
    with ``linear_before_reset`` choosing where the reset gate applies.
    Returns (Y, Y_h)."""
    N, H = X.shape[1], R.shape[-1]

    def bias(di, k):
        if B is None:
            return torch.zeros(3 * H, dtype=X.dtype, device=X.device)
        return B[di][3 * H * k:3 * H * (k + 1)]

    xw = [torch.einsum("lnd,gd->lng", X.float(), W[di].float()).to(X.dtype)
          + bias(di, 0) for di in range(W.shape[0])]

    def states0(di):
        return (initial_h[di] if initial_h is not None else
                torch.zeros((N, H), dtype=X.dtype, device=X.device),)

    def step(di, t, states):
        (ht,) = states
        rz, rr, rh = R[di].chunk(3, 0)
        rbz, rbr, rbh = bias(di, 1).chunk(3, 0)
        xz, xr, xh = t.chunk(3, -1)
        z = sigmoid(xz + _mm(ht, rz, X.dtype) + rbz)
        rg = sigmoid(xr + _mm(ht, rr, X.dtype) + rbr)
        if linear_before_reset:
            h = torch.tanh(xh + rg * (_mm(ht, rh, X.dtype) + rbh))
        else:
            h = torch.tanh(xh + _mm(rg * ht, rh, X.dtype) + rbh)
        return ((1 - z) * h + z * ht,)

    Y, finals = _rnn(xw, sequence_lens, direction, step, states0)
    return Y, torch.stack([s[0] for s in finals], 0)


# --------------------------------------------------------------------------
# elementwise
# --------------------------------------------------------------------------

def relu(x):
    return torch.clamp_min(x, 0)   # exact on int8 codes


def leakyrelu(x, alpha=0.2):
    """where(x > 0, x, x * alpha) with alpha rounded to x's dtype first, as
    the reference computes it: in bf16, 0.1 becomes 0.10009765625, where
    ``F.leaky_relu`` would multiply by the double 0.1 and round once."""
    return torch.where(x > 0, x, x * scalar(alpha, x, x.dtype))


def sigmoid(x):
    """1 / (1 + exp(-x)), each step rounded to x's dtype: the reference's
    ``jax.nn.sigmoid`` compiles to these four ops, so in bf16 it rounds
    three times where ``torch.sigmoid`` rounds once (a third of bf16 outputs
    one ulp apart)."""
    return 1 / (1 + torch.exp(-x))


def exp(x):
    return torch.exp(x)


def clip(x, min_t=None, max_t=None, min=None, max=None):
    """Clip to [min, max] (attributes) or [min_t, max_t] (operands); no
    bound is the identity.  A number bound is rounded to x's dtype, as JAX
    takes a weakly typed scalar; a tensor bound promotes with x."""
    lo = min if min is not None else min_t
    hi = max if max is not None else max_t
    for v, f in ((lo, torch.maximum), (hi, torch.minimum)):
        if v is None:
            continue
        if not isinstance(v, torch.Tensor):
            v = scalar(v, x, x.dtype)
        x = f(*_promote(x, v.to(x.device)))
    return x


def add(a, b, qadd=None, compute_dtype=None):
    """Elementwise add, optionally in the quantized-activation domain.

    ``qadd = (sa, sb, so)``: an operand whose scale is non-None AND whose
    dtype is int8 is codes at that scale; ``so`` non-None re-emits the sum
    as codes at that scale, else the sum comes out in float."""
    if qadd is None:
        a, b = _promote(a, b)
        return a + b
    sa, sb, so = qadd
    sa = sa if (sa is not None and a.dtype == torch.int8) else None
    sb = sb if (sb is not None and b.dtype == torch.int8) else None
    if so is not None:
        # scale ratios fold on the host in double; a same-scale operand
        # contributes its codes exactly (ratio == 1.0)
        def term(x, s):
            r = (1.0 / so) if s is None else (s / so)
            x = x.float()
            return x if r == 1.0 else x * scalar(r, x)
        v = term(a, sa) + term(b, sb)
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    af = a.float() if sa is None else a.float() * scalar(sa, a)
    bf = b.float() if sb is None else b.float() * scalar(sb, b)
    v = af + bf
    # out dtype: the non-code operand's, else the program compute dtype
    for x, s in ((a, sa), (b, sb)):
        if s is None:
            return v.to(x.dtype)
    return v.to(to_dtype(compute_dtype) or torch.float32)


def mul(a, b):
    a, b = _promote(a, b)
    return a * b


def sub(a, b):
    a, b = _promote(a, b)
    return a - b


def div(a, b):
    """True division, integers included (``jnp.true_divide``)."""
    a, b = _promote(a, b)
    return a / b


def power(x, p):
    x, p = _promote(x, _tensor(p, x))
    return torch.pow(x, p)


def equal(a, b):
    return torch.eq(*_promote(a, _tensor(b, a)))


def greater(a, b):
    return torch.gt(*_promote(a, _tensor(b, a)))


def greater_or_equal(a, b):
    return torch.ge(*_promote(a, _tensor(b, a)))


def where(mask, a, b):
    a, b = _promote(_tensor(a), _tensor(b, a))
    return torch.where(_tensor(mask, a).bool(), a, b)


def identity(x):
    return x


def minimum(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(*_promote(out, x))
    return out


def maximum(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(*_promote(out, x))
    return out


def sum_variadic(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = add(out, x)
    return out


def _recip(v):
    """f32(1 / f32(v)): XLA compiles a division by a constant into a
    multiply by its float32 reciprocal."""
    return np.float32(1.0) / np.float32(v)


def mean_variadic(*xs):
    """The sum of the inputs times the float32 reciprocal of their count
    (the compiled ``sum / len(xs)``), rounded to the sum's dtype."""
    out = sum_variadic(*xs)
    return (out.float() * scalar(_recip(len(xs)), out)).to(out.dtype)


def absolute(x):
    return torch.abs(x)


def negative(x):
    return -x


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def round_(x):
    """Round half to even (ONNX Round, ``jnp.rint``)."""
    return torch.round(x)


def sign(x):
    return torch.sign(x)


def tanh(x):
    return torch.tanh(x)


def sqrt(x):
    return torch.sqrt(x)


def log(x):
    return torch.log(x)


def reciprocal(x):
    """``1.0 / x``: integers divide into float32 as in JAX."""
    if not x.is_floating_point():
        x = x.float()
    return scalar(1.0, x, x.dtype) / x


def erf(x):
    """Exact erf, or in ``modes`` "lut" mode the original planer's table,
    indexed by the int16 truncation of ``lut_index_f`` (bit-equal to the
    reference)."""
    if _modes.get_erf_mode() == "lut":
        idx = _modes.lut_index_f(x.float()).to(torch.int16).long()
        lut = _const(_modes.ERF_LUT, x.device).to(x.dtype)
        return lut[idx]
    return torch.erf(x)


def hardsigmoid(x, alpha=0.2, beta=0.5):
    """clip(x * alpha + beta, 0, 1), alpha and beta rounded to x's dtype."""
    y = x * scalar(alpha, x, x.dtype) + scalar(beta, x, x.dtype)
    return torch.clamp(y, 0, 1).to(x.dtype)


def _sum_exp(shifted, axis):
    """sum(exp(shifted)) along ``axis`` as XLA compiles it for a 16-bit
    float: the exponentials enter the float32 sum unrounded (excess
    precision), the sum is rounded once."""
    return torch.exp(shifted.float()).sum(axis, keepdim=True).to(
        shifted.dtype)


def softmax(x, axis=-1):
    """``jax.nn.softmax``: exp(x - max) over the sum of the exponentials
    along ``axis`` (``_sum_exp``)."""
    shifted = x - x.amax(int(axis), keepdim=True)
    return torch.exp(shifted) / _sum_exp(shifted, int(axis))


def logsoftmax(x, axis=-1):
    """``jax.nn.log_softmax``: (x - max) - log(sum(exp(x - max)))."""
    shifted = x - x.amax(int(axis), keepdim=True)
    return shifted - torch.log(_sum_exp(shifted, int(axis)))


def prelu(x, slope):
    slope = _tensor(slope, x)
    if slope.ndim == 1 and x.ndim == 4:
        slope = slope.reshape(1, -1, 1, 1)
    x, slope = _promote(x, slope)
    return torch.where(x > 0, x, x * slope)


def elu(x, alpha=1.0):
    """``jax.nn.elu``: where(x > 0, x, alpha * expm1(where(x > 0, 0, x)))."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    neg = torch.expm1(torch.where(x > 0, zero, x))
    return torch.where(x > 0, x, scalar(alpha, x, x.dtype) * neg)


def softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)),
    with no switch to x at large x (``F.softplus`` has one at 20)."""
    y = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, y)


def gelu(x, approximate="none"):
    """``jax.nn.gelu``: exact as (0.5 * x) * erfc(-x * sqrt(0.5)); with
    ``approximate="tanh"`` x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 *
    x**3))); every constant rounded to x's dtype."""
    if approximate == "tanh":
        c = scalar(np.sqrt(2 / np.pi).astype(np.float32), x, x.dtype)
        inner = x + scalar(0.044715, x, x.dtype) * (x * x * x)
        cdf = scalar(0.5, x, x.dtype) * (
            scalar(1.0, x, x.dtype) + torch.tanh(c * inner))
        return x * cdf
    # erfc's argument and result stay float32 between the rounded 0.5 * x
    # and the final product, as XLA compiles it for a 16-bit float
    sqrt_half = scalar(np.sqrt(0.5).astype(np.float32), x, x.dtype)
    h = scalar(0.5, x, x.dtype) * x
    return (h.float() * torch.erfc(-x.float() * sqrt_half.float())).to(
        x.dtype)


def batchnorm(x, K, B):
    return x * K + B


def instance_normalization(x, s, bias, epsilon=1e-5):
    """(x - mean) * rsqrt(var + eps) * s + bias over the spatial axes, the
    variance biased (a mean of squared deviations), each step rounded to
    x's dtype as the compiled reference rounds it."""
    axes = tuple(range(2, x.ndim))
    d = x - _mean(x, axes, True)
    # the squares enter the float32 sum unrounded (XLA's excess precision)
    var = _mean(torch.square(d.float()), axes, True).to(x.dtype)
    shp = (1, -1) + (1,) * (x.ndim - 2)
    # rsqrt as 1 / sqrt in float32, rounded once to x's dtype: torch's
    # bf16 and CUDA rsqrt are approximations
    v = (var + scalar(epsilon, var, var.dtype)).float()
    inv = (1.0 / torch.sqrt(v)).to(x.dtype)
    return d * inv * s.reshape(shp) + bias.reshape(shp)


# --------------------------------------------------------------------------
# shape ops (shape operands are host values)
# --------------------------------------------------------------------------

def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.cpu()
        v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _host_ints(v) -> list[int]:
    return _host_array(v).astype(np.int64).reshape(-1).tolist()


def _tensor(v, like=None) -> torch.Tensor:
    """A shape-chain value (numpy array or tensor) as a tensor, on
    ``like``'s device when given."""
    dev = None if like is None else like.device
    if isinstance(v, torch.Tensor):
        return v if dev is None else v.to(dev)
    return torch.as_tensor(np.asarray(v), device=dev)


def reshape(x, shp):
    shp = _host_ints(shp)
    for i, v in enumerate(shp):
        if v == 0:
            shp[i] = x.shape[i]
    return x.reshape(shp)


def shape_of(x):
    """The int64 shape of x as a host (numpy) value, as the reference's
    ``numpy_ops.shape_of``."""
    return np.asarray(tuple(x.shape), dtype=np.int64)


def cast(x, dtype="float32"):
    if dtype == "flaot32":      # the original planer's typo, accepted
        dtype = "float32"
    return _tensor(x).to(to_dtype(dtype))


def arange(start, end, delta):
    """The int64 range as a host value, from integer bounds (floats
    truncate, as ``int`` does)."""
    start, end, delta = (int(_host_array(v)) for v in (start, end, delta))
    return torch.arange(start, end, delta, dtype=torch.int64)


def transpose(x, axis=None):
    if axis is None:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*_host_ints(axis))


def concat(*xs, axis=0):
    """Join along ``axis`` in the inputs' common dtype (jnp.result_type):
    the decode's f32 ``xy`` and bf16 ``wh`` join as f32."""
    xs = [_tensor(v) for v in xs]
    dt = functools.reduce(torch.promote_types, [v.dtype for v in xs])
    return torch.cat([v.to(dt) for v in xs], dim=int(axis))


def gather(x, idx, axis=0):
    """``jnp.take`` along ``axis``: negative indices count from the end; a
    0-dim index drops the axis."""
    x = _tensor(x)
    axis = int(axis) % x.ndim
    idx = _tensor(idx, x).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def slice_(x, starts, ends, axes=None, steps=None):
    """ONNX Slice with Python's slice semantics per axis (negative starts
    and ends count from the end, out-of-range ones clamp), negative steps
    included."""
    starts, ends = _host_ints(starts), _host_ints(ends)
    axes = (list(range(len(starts))) if axes is None else _host_ints(axes))
    steps = [1] * len(starts) if steps is None else _host_ints(steps)
    for s, e, a, st in zip(starts, ends, axes, steps):
        a %= x.ndim
        start, stop, step = slice(s, e, st).indices(x.shape[a])
        if step > 0:
            x = x[(slice(None),) * a + (slice(start, stop, step),)]
        else:
            idx = torch.arange(start, stop, step, device=x.device)
            x = torch.index_select(x, a, idx)
    return x


def expand(x, shp):
    """Broadcast x to ``np.broadcast_shapes(x.shape, shp)`` (ONNX Expand)."""
    x = _tensor(x)
    return x.broadcast_to(torch.broadcast_shapes(tuple(x.shape),
                                                 tuple(_host_ints(shp))))


def unsqueeze(x, axes=None):
    """``jnp.expand_dims``: axes index the output, negative ones from its
    end."""
    x = _tensor(x)
    axes = _host_ints(axes)
    nd = x.ndim + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, axis=1):
    lead = int(np.prod(x.shape[:axis], dtype=np.int64)) if axis else 1
    return x.reshape(lead, -1)


def split(x, split=None, axis=0):
    """Pieces of the given sizes along ``axis`` (a tuple), past the last
    piece dropped, as ``jnp.split`` at the cumulative offsets."""
    if split is None:
        raise ValueError("split sizes required")
    sizes = _host_ints(split)
    axis = int(axis) % x.ndim
    return tuple(torch.split(x.narrow(axis, 0, sum(sizes)), sizes, axis))


def tile(x, repeats):
    return _tensor(x).tile(tuple(_host_ints(repeats)))


def pad(x, pads, constant_value=0.0, mode="constant"):
    """ONNX Pad: ``pads`` lists every axis's start pads, then its end pads;
    ``mode`` "constant" (the value rounded to x's dtype), "reflect" or
    "edge" (as ``np.pad``, built as an index gather per axis)."""
    p = np.asarray(_host_ints(pads)).reshape(2, -1).T.tolist()
    if mode == "constant":
        v = 0.0 if constant_value is None else \
            _host_array(constant_value).reshape(-1)[0].item()
        flat = [n for lo, hi in reversed(p) for n in (lo, hi)]
        return F.pad(x, flat, value=v)
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for a, (lo, hi) in enumerate(p):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, a, _const(idx, x.device))
    return x


def squeeze(x, axes=None):
    if axes is None:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in _host_ints(axes)))


def const(value=0, dtype="float32"):
    """A host value (the reference's ``np.asarray(value, dtype)``)."""
    return torch.as_tensor(np.asarray(value, dtype=dtype))


def constant_of_shape(x, value=0, dtype="float32"):
    """A host tensor of the shape ``x`` holds, filled with ``value``."""
    return torch.full(tuple(_host_ints(x)), value, dtype=to_dtype(dtype))


def scatternd(data, indices, updates):
    """ONNX ScatterND: a copy of ``data`` with ``updates`` written at the
    index tuples of ``indices``' last axis."""
    data = _tensor(data)
    indices = _tensor(indices, data).long()
    r = indices.shape[-1]
    idx = indices.reshape(-1, r)
    upd = _tensor(updates, data).reshape((-1,) + tuple(data.shape[r:]))
    out = data.clone()
    out[tuple(idx[:, i] for i in range(r))] = upd.to(out.dtype)
    return out


def nonzero(x):
    """(ndim, count) int64 indices of the nonzero elements, as
    ``np.nonzero``.  Data-dependent: a program runs it past its cut."""
    return torch.nonzero(_tensor(x)).t().contiguous()


def topk(x, k, axis=-1, largest=1, sorted=1):
    """The k largest (or smallest) values along ``axis`` with their int64
    indices, ties ordered by index as ``lax.top_k`` orders them: a stable
    sort (``torch.topk`` on CUDA leaves ties in no fixed order).  The
    result is always sorted, as in the reference."""
    k = _host_ints(k)[0]
    axis = int(axis) % x.ndim
    idx = torch.sort(x, dim=axis, descending=bool(largest),
                     stable=True).indices.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx


def space_to_depth(x, blocksize=2):
    n, c, h, w = x.shape
    b = int(blocksize)
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


def depth_to_space(x, blocksize=2, mode="DCR"):
    n, c, h, w = x.shape
    b = int(blocksize)
    if mode == "DCR":
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (b * b), h * b, w * b)


# --------------------------------------------------------------------------
# reductions (bf16 and f16 sums, means and products in float32, as
# jnp's reductions upcast them)
# --------------------------------------------------------------------------

def _axes(axes, ndim):
    if axes is None:
        return tuple(range(ndim))
    return tuple(int(a) % ndim for a in _host_ints(axes))


def _low(x):
    return x.dtype in (torch.bfloat16, torch.float16)


def _sum(x, axes, keepdim):
    if _low(x):
        return x.float().sum(axes, keepdim=keepdim).to(x.dtype)
    return x.sum(axes, keepdim=keepdim)


def _mean(x, axes, keepdim):
    """``jnp.mean`` as compiled: the float32 sum (integers too) times the
    float32 reciprocal of the count, cast back for a 16-bit float."""
    y = x.float().sum(axes, keepdim=keepdim)
    n = int(np.prod([x.shape[a] for a in axes], dtype=np.int64))
    y = y * scalar(_recip(n), y)
    return y.to(x.dtype) if x.is_floating_point() else y


def reduce_sum(x, axes=None, keepdims=1):
    return _sum(x, _axes(axes, x.ndim), bool(keepdims))


def reduce_mean(x, axes=None, keepdims=1):
    return _mean(x, _axes(axes, x.ndim), bool(keepdims))


def reduce_max(x, axes=None, keepdims=1):
    return x.amax(_axes(axes, x.ndim), keepdim=bool(keepdims))


def reduce_min(x, axes=None, keepdims=1):
    return x.amin(_axes(axes, x.ndim), keepdim=bool(keepdims))


def reduce_prod(x, axes=None, keepdims=1):
    y = x.float() if _low(x) else x
    for a in sorted(_axes(axes, x.ndim), reverse=True):
        y = y.prod(a, keepdim=bool(keepdims))
    return y.to(x.dtype)


def _arg_reduce(x, axis, keepdims, select_last_index, fn):
    axis = int(axis) % x.ndim
    if select_last_index:
        out = x.shape[axis] - 1 - fn(x.flip(axis), axis)
    else:
        out = fn(x, axis)
    return out.unsqueeze(axis) if keepdims else out


def argmax(x, axis=0, keepdims=1, select_last_index=0):
    """int64 index of the first maximum along ``axis`` (of the last with
    ``select_last_index``, through a flip, as the reference)."""
    return _arg_reduce(x, axis, keepdims, select_last_index, torch.argmax)


def argmin(x, axis=0, keepdims=1, select_last_index=0):
    return _arg_reduce(x, axis, keepdims, select_last_index, torch.argmin)


def return_(*xs):
    return xs


# --------------------------------------------------------------------------
# upsample (index plans on the host, ops/resize.py)
# --------------------------------------------------------------------------

def _is_repeat(idx: np.ndarray, in_size: int) -> int:
    """k where idx == repeat(arange(in_size), k), else 0."""
    if idx.size % max(in_size, 1):
        return 0
    k = idx.size // in_size
    if k and np.array_equal(idx, np.repeat(np.arange(in_size), k)):
        return k
    return 0


def _resize_nchw(x, out_hw, scales, mode, coord_mode, nearest_mode):
    h, w = x.shape[-2:]
    oh, ow = out_hw
    kh, kw = scales
    if mode == "nearest":
        ri = _rs.nearest_plan(h, oh, kh, coord_mode, nearest_mode)
        ci = _rs.nearest_plan(w, ow, kw, coord_mode, nearest_mode)
        rk, ck = _is_repeat(ri, h), _is_repeat(ci, w)
        if rk and ck:       # integer-factor stamping: one broadcast copy
            n, c = x.shape[:2]
            y = x[:, :, :, None, :, None].expand(n, c, h, rk, w, ck)
            return y.reshape(n, c, oh, ow)
        ri, ci = (_const(np.asarray(i, np.int64), x.device)
                  for i in (ri, ci))
        return x[..., ri[:, None], ci[None, :]]
    if mode in ("linear", "bilinear"):
        # the lerp weights in x's dtype, as the reference takes them
        rlo, rhi, rf = _rs.linear_plan(h, oh, kh, coord_mode)
        clo, chi, cf = _rs.linear_plan(w, ow, kw, coord_mode)
        rlo, rhi, clo, chi = (_const(np.asarray(i, np.int64), x.device)
                              for i in (rlo, rhi, clo, chi))
        rf = _const(rf.reshape(-1, 1), x.device).to(x.dtype)
        cf = _const(cf, x.device).to(x.dtype)
        rows = x[..., rlo, :] * (1 - rf) + x[..., rhi, :] * rf
        return rows[..., clo] * (1 - cf) + rows[..., chi] * cf
    raise ValueError(f"unsupported resize mode {mode!r}")


def upsample(x, k, mode="nearest", size=None):
    """ONNX Upsample: scales ``k`` (the last two are H and W) or, with empty
    scales, an explicit ``size``; asymmetric coordinates, floor rounding."""
    k = _host_array(k).astype(np.float64).ravel()
    if k.size == 0:
        if size is None or np.size(size) == 0:
            raise ValueError("Upsample with empty scales needs a size")
        ss = _host_ints(size)
        out_hw, sc = _rs.resize_shape(x.shape[-2:], sizes=(ss[-2], ss[-1]))
        return _resize_nchw(x, out_hw, sc, mode, "asymmetric", "floor")
    out_hw, sc = _rs.resize_shape(x.shape[-2:],
                                  scales=(float(k[-2]), float(k[-1])))
    return _resize_nchw(x, out_hw, sc, mode, "asymmetric", "floor")


def resize_op(x, roi=None, k=None, size=None, mode="nearest",
              coordinate_transformation_mode="half_pixel",
              nearest_mode="round_prefer_floor"):
    """ONNX Resize on the last two axes: scales ``k`` or sizes ``size`` (the
    last two entries), ``roi`` ignored as in the reference, the spec's
    coordinate transformations and nearest roundings (``ops/resize.py``)."""
    scales = sizes = None
    if k is not None and np.size(_host_array(k)) > 0:
        kk = _host_array(k).astype(np.float64).ravel()
        scales = (float(kk[-2]), float(kk[-1]))
    if size is not None and np.size(_host_array(size)) > 0:
        ss = _host_ints(size)
        sizes = (ss[-2], ss[-1])
    out_hw, sc = _rs.resize_shape(x.shape[-2:], scales=scales, sizes=sizes)
    return _resize_nchw(x, out_hw, sc, mode, coordinate_transformation_mode,
                        nearest_mode)


# --------------------------------------------------------------------------
# fused entry stage
# --------------------------------------------------------------------------

def stage64(x, Ws, Bs, *bw, blocks=None, out_scale=None,
            force_decomposed=False, cache=None, plain=False):
    """Fused ResNet entry stage (stem + maxpool + C=64 basic blocks): the
    hand-written Hopper kernels on CUDA tensors, their plain PyTorch
    versions on CPU tensors (ops/kernels/stage64.py).  ``blocks`` is
    informational; ``cache`` is the program's per-application dict that
    holds the host-folded requant tables; ``plain`` (an op override, like
    ``force_decomposed``) runs the plain versions on any device."""
    from .kernels import stage64 as _st
    return _st.stage64(x, Ws, Bs, *bw, out_scale=out_scale,
                       force_decomposed=force_decomposed, cache=cache,
                       plain=plain)


def stagen(x, *w, blocks=None, force_decomposed=False, cache=None,
           plain=False):
    """Fused ResNet body stage (basic or bottleneck blocks): the
    hand-written Hopper conv kernel on CUDA tensors, its plain PyTorch
    version on CPU tensors (ops/kernels/stagen.py).  ``cache`` is the
    program's per-application dict that holds the host-folded tables;
    ``plain`` (an op override, like ``force_decomposed``) runs the plain
    version on any device."""
    from .kernels import stagen as _st
    return _st.stagen(x, *w, blocks=blocks, force_decomposed=force_decomposed,
                      cache=cache, plain=plain)
