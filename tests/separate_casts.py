"""The W8A8 chain's dtype conversions as separate passes: the expressions
the op library ran before each conversion rode inside the arithmetic pass
beside it (``torch_ops.quantize``, ``_act_quant``, ``_dequant``,
``_decode``, ``add(qadd=)``).  They are the reference the library's forms
are held against bit for bit, on the CPU (``test_torch_cast_fused.py``)
and on the card (``test_torch_cuda.py``); ``use`` puts them in the
library's place for a whole program.  Imports neither jax nor
``planer_tpu``."""
import dataclasses

import numpy as np
import torch

from planer_tpu_torch import registry
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.ops.kernels import stagen as sg
from planer_tpu_torch.ops.qtypes import QTensor
from planer_tpu_torch.runtime import profiler

BF16, F32 = torch.bfloat16, torch.float32
COUNTER = "w8a8.cast_fused"


def quantize(x, s):
    r = np.float32(1.0) / np.float32(s)
    return torch.clamp(torch.round(x.float() * tops.scalar(r, x)),
                       -127, 127).to(torch.int8)


def act_quant(x, K):
    if K.act_scale is not None:
        return quantize(x, K.act_scale), tops.scalar(K.act_scale, x)
    sx = torch.clamp_min(x.abs().amax(), 1e-6).float() / 127.0
    q = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return q, sx


def dequant(acc, sx, K, B, odt):
    out = (acc.float() * (sx * K.scale.reshape(1, -1, 1, 1))).to(odt)
    if B is not None:
        out = out + B.reshape(1, -1, 1, 1).to(odt)
    return out


def decode(x, K, compute_dtype):
    odt = tops.to_dtype(compute_dtype) or F32
    return x.to(odt) * tops.scalar(K.act_scale, x, odt)


def add(a, b, qadd=None, compute_dtype=None):
    if qadd is None:
        a, b = tops._promote(a, b)
        return a + b
    sa, sb, so = qadd
    sa = sa if (sa is not None and a.dtype == torch.int8) else None
    sb = sb if (sb is not None and b.dtype == torch.int8) else None
    if so is not None:
        def term(x, s):
            r = (1.0 / so) if s is None else (s / so)
            x = x.float()
            return x if r == 1.0 else x * tops.scalar(r, x)
        v = term(a, sa) + term(b, sb)
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    af = a.float() if sa is None else a.float() * tops.scalar(sa, a)
    bf = b.float() if sb is None else b.float() * tops.scalar(sb, b)
    v = af + bf
    for x, s in ((a, sa), (b, sb)):
        if s is None:
            return v.to(x.dtype)
    return v.to(tops.to_dtype(compute_dtype) or F32)


def planned_casts(net, routes):
    """``w8a8.cast_fused`` a walk, from the route plan and the graph's code
    plan at bfloat16 compute: a W8A8 conv's quantize and dequant, an s8
    conv's dequant, the requant of a conv that emits codes (``out_scale``),
    a fused entry stage's prologue, and for a residual add ``qadd = (sa,
    sb, so)`` each operand's rescale (codes whose scale is not the
    output's, or a bfloat16 operand into codes) and the sum where an
    operand enters it unconverted or it rounds to bfloat16."""
    n = 2 * routes.get("w8a8", 0) + routes.get("s8", 0)
    for layer in net.graph.layers:
        kw = layer.kwargs
        if layer.op == "stage64":
            n += 1
        elif layer.op == "conv" and kw.get("out_scale") is not None:
            n += 1
        elif layer.op == "add" and kw.get("qadd"):
            sa, sb, so = kw["qadd"]
            if so is None:
                n += (sa is not None) + (sb is not None) + 1
            else:
                r = [1.0 / so if s is None else s / so for s in (sa, sb)]
                n += sum(v != 1.0 for v in r) + (1.0 in r)
    return n


def use(monkeypatch):
    """Run the separate casts in the library's place: programs walked
    after this (``_run``, a new entry) take them."""
    for mod, name, fn in ((tops, "quantize", quantize),
                          (tops, "_act_quant", act_quant),
                          (tops, "_dequant", dequant),
                          (tops, "_decode", decode),
                          (tops, "add", add),
                          (st, "quantize", quantize),
                          (sg, "quantize", quantize)):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setitem(registry.OPS, "add",
                        dataclasses.replace(registry.OPS["add"], fn=add))


def same_bits(got, want):
    """Equal dtype, shape, strides and bits (-0.0 is not 0.0)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    bits = {BF16: torch.int16, torch.float16: torch.int16,
            F32: torch.int32}.get(got.dtype)
    g, w = got.contiguous(), want.contiguous()
    if bits is not None:
        g, w = g.view(bits), w.view(bits)
    assert torch.equal(g, w)


def _codes(rng, shape, device, channels_last=True):
    x = torch.as_tensor(rng.integers(-127, 128, size=shape, dtype=np.int8),
                        device=device)
    return x.contiguous(memory_format=torch.channels_last) \
        if channels_last else x


def _values(rng, shape, dtype, device, scale=1.0):
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                        * scale, device=device).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _qtensor(rng, o, c, device, act_scale=0.0371):
    q = torch.as_tensor(rng.integers(-127, 128, size=(o, c, 3, 3),
                                     dtype=np.int8), device=device)
    s = torch.as_tensor(rng.uniform(1e-3, 2e-2, size=o).astype(np.float32),
                        device=device)
    return QTensor(q, s, act_scale=act_scale)


def _accumulator(rng, device):
    """An int32 accumulator as ``conv_s8`` hands it on: an (M, 24) GEMM
    result sliced to o = 20 (o % 8 != 0) and seen as NCHW, so it is
    channels-last and not dense; |acc| from 0 to 2**31 - 1, past float32's
    exact 2**24, and channels whose values come out near the bias's size,
    where the bias's own rounding to the output dtype shows."""
    m = 2 * 5 * 7
    a = rng.integers(-2 ** 31 + 1, 2 ** 31, size=(m, 24), dtype=np.int64)
    a[:, 0] = rng.integers(-2 ** 24, 2 ** 24, size=m)
    a[:, 2:8] = rng.integers(-2 ** 12, 2 ** 12, size=(m, 6))
    a[:, 8:14] = rng.integers(-2 ** 17, 2 ** 17, size=(m, 6))
    a[:8, 1] = [2 ** 24 + 1, -(2 ** 24 + 1), 2 ** 24 + 3, 2 ** 31 - 1,
                -(2 ** 31 - 1), 0, 1, -1]
    acc = torch.as_tensor(a.astype(np.int32), device=device)[:, :20]
    return acc.reshape(2, 5, 7, 20).permute(0, 3, 1, 2)


def _ties(dtype, device):
    """x at scale 0.5 (an exact reciprocal, 2.0): x / s = k + 0.5 for every
    k in [-130, 129], the clamp's edges, -0.0 and values that round to it,
    in a channels-last tensor."""
    k = np.arange(-130, 130, dtype=np.float32)
    v = np.concatenate([(k + 0.5) / 2, [-0.0, 0.0, -0.2, 0.2, -0.25, 0.25,
                                        63.5, 63.75, -63.5, -63.75, 64.0,
                                        -64.0, 500.0, -500.0]]).astype(
        np.float32)
    v = np.resize(v, 2 * 8 * 6 * 6).reshape(2, 6, 6, 8).transpose(0, 3, 1, 2)
    x = torch.as_tensor(np.ascontiguousarray(v), device=device).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


QADD = {            # (sa, sb, so), operand kinds, count in bf16 / in f32
    "code_out_same_scale": ((0.05, 0.05, 0.05), ("i8", "i8"), (1, 1)),
    "code_out_rescaled": ((0.05, 0.03, 0.07), ("i8", "i8"), (2, 2)),
    "code_out_float_and_codes": ((None, 0.05, 0.05), ("f", "i8"), (2, 1)),
    "float_out_float_and_codes": ((None, 0.05, None), ("f", "i8"), (2, 1)),
    "float_out_both_codes": ((0.05, 0.02, None), ("i8", "i8"), (3, 2)),
}

FORMS = (
    [f"dequant-{b}-{d}" for b in ("bias", "nobias") for d in ("bf16", "f32")]
    + [f"quantize-{c}-{d}" for c in ("ties", "random")
       for d in ("bf16", "f32")]
    + ["act_quant-dynamic-bf16", "act_quant-dynamic-f32"]
    + [f"add-{n}-{d}" for n in QADD for d in ("bf16", "f32")]
    + ["decode-bf16", "decode-f32"])


def form(case, device):
    """(the library's result, the separate casts' result, the passes the
    library counts as ``w8a8.cast_fused``) for one ``FORMS`` case."""
    kind, *rest = case.split("-")
    dt = {"bf16": BF16, "f32": F32}[rest[-1]]
    rng = np.random.default_rng(len(case) * 7919 + sum(map(ord, case)))
    if kind == "dequant":
        acc, K = _accumulator(rng, device), _qtensor(rng, 20, 16, device)
        B = (torch.as_tensor(rng.standard_normal(20).astype(np.float32),
                             device=device) if rest[0] == "bias" else None)
        sx = tops.scalar(K.act_scale, acc)
        return (lambda: tops._dequant(acc, sx, K, B, dt),
                lambda: dequant(acc, sx, K, B, dt), 1)
    if kind == "quantize":
        if rest[0] == "ties":
            x, s = _ties(dt, device), 0.5
        else:
            x, s = _values(rng, (2, 16, 5, 6), dt, device, 3.0), 0.0371
        return (lambda: tops.quantize(x, s), lambda: quantize(x, s),
                int(dt != F32))
    if kind == "act_quant":
        x = _values(rng, (2, 16, 5, 6), dt, device, 3.0)
        K = dataclasses.replace(_qtensor(rng, 8, 16, device, None),
                                act_dynamic=True)
        return (lambda: tops._act_quant(x, K), lambda: act_quant(x, K),
                int(dt != F32))
    if kind == "add":
        qadd, kinds, counts = QADD[rest[0]]
        a, b = (_codes(rng, (2, 8, 6, 6), device) if k == "i8"
                else _values(rng, (2, 8, 6, 6), dt, device, 2.0)
                for k in kinds)
        cd = None if dt == F32 else "bfloat16"
        return (lambda: tops.add(a, b, qadd=qadd, compute_dtype=cd),
                lambda: add(a, b, qadd=qadd, compute_dtype=cd),
                counts[dt == F32])
    if kind == "decode":
        x, K = _codes(rng, (2, 16, 6, 6), device), _qtensor(rng, 8, 16,
                                                            device)
        cd = None if dt == F32 else "bfloat16"
        return (lambda: tops._decode(x, K, cd), lambda: decode(x, K, cd), 1)
    raise ValueError(case)


def check_form(case, device):
    """The library's form of ``case`` equals the separate casts bit for
    bit, in the same layout, and counts its fused passes."""
    new, old, want = form(case, device)
    with profiler.record() as rec:
        got = new()
    assert rec.counters.get(COUNTER, 0) == want
    ref = old()
    if isinstance(got, tuple):                  # (codes, scale)
        for g, w in zip(got, ref, strict=True):
            same_bits(g, w)
    else:
        same_bits(got, ref)
