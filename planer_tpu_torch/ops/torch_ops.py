"""PyTorch op library — the port's counterpart of ``planer_tpu/ops/jax_ops.py``
for the ops on the INT8 ResNet-18 main path and the weight-only ResNet-50.

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
  * s8 x s8 convs accumulate exactly in int32 (``torch._int_mm`` over an
    im2col): |acc| reaches 127^2 * 4608 > 2^24, past float32's exact range;
  * dequant is ``acc.float() * (sx * w_scale)`` with the scale product taken
    first, cast to the output dtype, and the bias added after the cast;
  * a quantized ``dense``, and with ``_PALLAS_CONV1X1`` a weight-only 1x1
    conv, go through ``ops/kernels/gemm.dense_q``, which picks the numerics
    of the reference's kernel branch or of its fallback by shape.

Shape-like operands (reshape targets) may arrive as numpy arrays or host
tensors folded by the program's static pass.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .padding import resolve_conv_pads, resolve_pool_pads
from .qtypes import QTensor

__all__ = ["conv2d", "dense", "maxpool", "global_average_pool", "relu",
           "add", "batchnorm", "flatten", "reshape", "shape_of", "stage64",
           "stagen", "return_",
           "conv_s8", "quantize", "scalar", "to_dtype"]


# opt-in, as in the JAX package (jax_ops._PALLAS_CONV1X1): route quantized
# 1x1 stride-1 ungrouped convs that reach no s8 path to the dense_q GEMM
_PALLAS_CONV1X1 = False

# as in the JAX package (jax_ops._STACK_CONV), read at call time: off, a
# quantized 3x3 conv with at most 64 outputs and C < 128 takes dequant +
# float conv in place of the stacked s8 form
_STACK_CONV = True


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def to_dtype(name) -> torch.dtype | None:
    """'bfloat16' / 'float32' / torch.dtype / None -> torch.dtype or None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


@functools.lru_cache(maxsize=4096)
def _scalar_cached(v: float, dtype: torch.dtype, device: torch.device):
    return torch.full((), v, dtype=dtype, device=device)


def scalar(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A 0-dim ``dtype`` tensor holding the Python float ``v`` on ``like``'s
    device: the float is rounded to ``dtype`` once, as JAX rounds a weakly
    typed Python scalar, and the op stays a true tensor-tensor op."""
    return _scalar_cached(float(v), dtype, like.device)


def _im2col(x, kh, kw, strides, pads, dilations):
    """(N, C, H, W) -> ((N*Ho*Wo, C*kh*kw) patches in (c, ky, kx) order,
    (N, Ho, Wo)); any dtype, zero padding."""
    pt, pl, pb, pr = pads
    x = F.pad(x, (pl, pr, pt, pb)).contiguous()
    n, c, h, w = x.shape
    sh, sw = strides
    dh, dw = dilations
    ho = (h - (kh - 1) * dh - 1) // sh + 1
    wo = (w - (kw - 1) * dw - 1) // sw + 1
    sn, sc, sy, sx = x.stride()
    v = x.as_strided((n, ho, wo, c, kh, kw),
                     (sn, sy * sh, sx * sw, sc, sy * dh, sx * dw))
    return v.reshape(n * ho * wo, c * kh * kw), (n, ho, wo)


def conv_s8(q, wq, strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1)):
    """Exact s8 x s8 -> s32 NCHW conv: ``torch._int_mm`` over an im2col.

    cuBLAS's int8 GEMM needs M > 16 and K, N multiples of 8, so the operands
    are zero-padded up to those minimums (zeros add nothing to the sums).  It
    also needs the patch matrix row-major: a 1x1 conv's im2col is a
    column-major view of the NCHW input (cuBLASLt refuses a leading
    dimension of H*W = 49 at ResNet-50's layer4, batch 1), so it is made
    contiguous."""
    o, c, kh, kw = wq.shape
    a, (n, ho, wo) = _im2col(q, kh, kw, strides, pads, dilations)
    a = a.contiguous()
    b = wq.reshape(o, c * kh * kw)
    m, k = a.shape
    kpad, opad = (-k) % 8, (-o) % 8
    mpad = max(17 - m, 0) if a.is_cuda else 0
    if kpad or mpad:
        a = F.pad(a, (0, kpad, 0, mpad))
    if kpad or opad:
        b = F.pad(b, (0, kpad, 0, opad))
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


def conv2d(x, K, B=None, group=1, strides=(1, 1), dilations=(1, 1),
           pads=(0, 0, 0, 0), auto_pad=None, out_scale=None,
           compute_dtype=None, plain=False):
    """2-D convolution with optional int8 activation-code emission
    (``out_scale``: re-emit the output as codes at that scale).  ``plain``
    (an op override) runs the dense_q GEMM of the 1x1 route on its plain
    version on any device."""
    out = _conv2d(x, K, B, group=group, strides=strides, dilations=dilations,
                  pads=pads, auto_pad=auto_pad, compute_dtype=compute_dtype,
                  plain=plain)
    if out_scale is None:
        return out
    return quantize(out, out_scale)


def _conv2d(x, K, B=None, group=1, strides=(1, 1), dilations=(1, 1),
            pads=(0, 0, 0, 0), auto_pad=None, compute_dtype=None,
            plain=False):
    kshape = tuple(K.shape)
    strides = (1, 1) if strides is None else tuple(int(s) for s in strides)
    dilations = (1, 1) if dilations is None else tuple(int(d) for d in dilations)
    if auto_pad:
        pads = resolve_conv_pads(x.shape[2:], kshape[2:], strides, dilations,
                                 pads, auto_pad)
    pads = (0, 0, 0, 0) if pads is None else tuple(int(p) for p in pads)
    # the JAX package's output-row stacking gate (jax_ops._conv2d): only the
    # s8 branch below depends on it, since stacking a float conv changes its
    # TPU layout and not its sums
    stackable = (
        _STACK_CONV and len(kshape) == 4 and kshape[2:] == (3, 3)
        and kshape[0] <= 64 and int(group) == 1
        and strides == (1, 1) and dilations == (1, 1)
        and pads == (1, 1, 1, 1) and x.ndim == 4
        and x.shape[2] % 2 == 0 and x.shape[2] >= 4
        and x.shape[0] * x.shape[2] * x.shape[3] >= 100_000
        and x.shape[3] <= 128)
    if isinstance(K, QTensor):
        quantized = (K.act_dynamic or K.act_scale is not None) \
            and K.q.dtype == torch.int8
        # int8 activations are by contract CODES at K.act_scale
        if (x.dtype == torch.int8 and K.q.dtype == torch.int8
                and K.act_scale is not None and x.ndim == 4
                and int(group) == 1):
            if x.shape[1] >= 128:          # s8 path, no quantize pass
                return _conv_w8a8(x, K, B, strides, dilations, pads,
                                  pre_quantized=True,
                                  compute_dtype=compute_dtype)
            # C < 128: decode the codes to the compute dtype
            odt = to_dtype(compute_dtype) or torch.float32
            x = x.to(odt) * scalar(K.act_scale, x, odt)
        if (quantized and x.ndim == 4 and x.shape[1] >= 128
                and int(group) == 1
                and x.shape[0] * x.shape[2] * x.shape[3] >= 4096
                and x.is_floating_point()):
            return _conv_w8a8(x, K, B, strides, dilations, pads)
        if stackable and quantized and x.is_floating_point():
            # the JAX package's output-row-stacked W8A8 form: the same exact
            # int32 sums and per-channel dequant in another TPU lane layout
            return _conv_w8a8(x, K, B, strides, dilations, pads)
        # the JAX package's opt-in 1x1 route: a 1x1 stride-1 ungrouped conv
        # is a GEMM over (N*H*W, C), handed to dense_q (kernel branch where
        # the shape tiles, its fallback's numerics elsewhere)
        if (_PALLAS_CONV1X1 and K.q.ndim == 4
                and tuple(K.q.shape[2:]) == (1, 1) and int(group) == 1
                and strides == (1, 1) and pads == (0, 0, 0, 0)):
            from .kernels import gemm
            n, c, h, w = x.shape
            o = K.q.shape[0]
            xm = x.permute(0, 2, 3, 1).reshape(-1, c)      # (NHW, C)
            kq = QTensor(K.q.reshape(o, c), K.scale.reshape(o, 1))
            y = gemm.dense_q(xm, kq, B, plain=plain)
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


# --------------------------------------------------------------------------
# dense / pool
# --------------------------------------------------------------------------

def dense(x, K, B=None, shp=None, plain=False):
    """y = x @ K.T + B.  A quantized K goes through ``gemm.dense_q``, as in
    the JAX package: its kernel branch where the shape tiles, its fallback's
    numerics elsewhere (the ResNet fc).  ``plain`` (an op override) runs the
    kernel branch's plain version on any device."""
    if isinstance(K, QTensor):
        from .kernels import gemm
        return gemm.dense_q(x, K, B, plain=plain)
    # bf16 operands are exact in f32, so an f32 product is the f32-accumulated
    # bf16 dot (TF32 is off for matmuls by default and in the executor)
    y = torch.matmul(x.float(), K.to(x.dtype).float().t()).to(x.dtype)
    if B is not None:
        y = y + B.reshape(1, -1).to(y.dtype)
    return y


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


def global_average_pool(x):
    return x.mean(dim=(-2, -1), keepdim=True)


# --------------------------------------------------------------------------
# elementwise
# --------------------------------------------------------------------------

def relu(x):
    return torch.clamp_min(x, 0)   # exact on int8 codes


def add(a, b, qadd=None, compute_dtype=None):
    """Elementwise add, optionally in the quantized-activation domain.

    ``qadd = (sa, sb, so)``: an operand whose scale is non-None AND whose
    dtype is int8 is codes at that scale; ``so`` non-None re-emits the sum
    as codes at that scale, else the sum comes out in float."""
    if qadd is None:
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


def batchnorm(x, K, B):
    return x * K + B


# --------------------------------------------------------------------------
# shape ops (shape operands are host values)
# --------------------------------------------------------------------------

def _host_ints(v) -> list[int]:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).astype(np.int64).reshape(-1).tolist()


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


def flatten(x, axis=1):
    lead = int(np.prod(x.shape[:axis], dtype=np.int64)) if axis else 1
    return x.reshape(lead, -1)


def return_(*xs):
    return xs


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
