"""Plain reference of the int8 ConvNeXt configuration (ConvNeXt-Base at 224:
int8 per-output-channel weights, static int8 activation scales for the
downsampling convs, the Linears weight-only int8, bfloat16 compute).

It starts from the float arrays and calibration images the benchmark made
and works out again everything the program derives from them: the int8
weights and their scales, the activation scales (percentile of |input| per
conv over the calibration batches, in a float32 forward with TF32 off), the
route each conv and each Linear takes at the program's batch, and the
bfloat16 roundings of every tensor the program holds in bfloat16:

  * a conv on the float route (the stem, C = 3; every depthwise conv, which
    is grouped; a downsampling conv under 4,096 rows): the weights
    dequantized to bfloat16, exact products of the bfloat16 operands summed
    in float64 (the stem) or float32 (the 49 taps of a depthwise conv, the
    accumulator the program's bfloat16 conv sums in), rounded to bfloat16,
    the bias added in bfloat16;
  * a downsampling conv of >= 128 input channels and >= 4,096 rows (W8A8):
    the input quantized at its calibrated scale, an exact integer conv,
    ``acc * (sx * w_scale)`` in float32 rounded to bfloat16, the bias added
    in bfloat16;
  * a Linear on ``dense_q``'s kernel branch (N and Kd multiples of 128):
    bf16(x) times the exact int8 weight, float32 sums, times the
    per-channel scale, cast to bfloat16, the bias added in bfloat16; on its
    fallback (the classifier, N = 1000): the weights dequantized to
    bfloat16, float32 sums, cast, the bias added;
  * a LayerNorm: statistics, normalisation and affine in float32 on the
    bfloat16 input with its bfloat16 scale and bias, rounded once;
  * GELU: ``(0.5 x) * erfc(-x * sqrt(0.5))`` with both constants rounded to
    bfloat16 first (0.5 exact, sqrt(0.5) -> 0.70703125), the product taken
    in float32 and rounded once, as the program's op takes its constants;
  * the layer scale, the residual add and the global average pool in
    float32, rounded once.

No conv hands on int8 codes: every conv's output is read by a LayerNorm, a
depthwise conv or a residual add, so every residual add sums two bfloat16
maps.

Departures from the published model (Liu et al., arXiv:2201.03545;
torchvision's ``convnext_base``): weights are random; the layer scale
``gamma`` is drawn (0.5 + 0.1 N) where the published initialisation is
1e-6, which would leave every block's branch under the residual's bfloat16
rounding; GELU's sqrt(0.5) is rounded to bfloat16, as above.

Nothing here imports the program or its kernels: torch and numpy only.
``bits`` sets the integer width of weights and activation codes; the
benchmark's control is this reference at ``bits=4``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import resnet_ref as rr

BF16 = torch.bfloat16
EPS = 1e-6
# the dense_q kernel branch's gate: its reference's VMEM budget
_VMEM_BUDGET = 12 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str          # weights "<name>.w", "<name>.b"
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    group: int = 1


def weight_shapes(cfg) -> list[tuple[str, tuple]]:
    """(name, shape) of every weight, in the graph's order."""
    d, w = cfg["depths"], cfg["widths"]
    out = []

    def ln(p, c):
        out.extend([(f"{p}.s", (c,)), (f"{p}.b", (c,))])

    out += [("stem.w", (w[0], 3, 4, 4)), ("stem.b", (w[0],))]
    ln("stem.ln", w[0])
    for i, c in enumerate(w):
        if i:
            ln(f"down{i}.ln", w[i - 1])
            out += [(f"down{i}.w", (c, w[i - 1], 2, 2)), (f"down{i}.b", (c,))]
        for j in range(d[i]):
            p = f"s{i}.{j}"
            out += [(f"{p}.dw.w", (c, 1, 7, 7)), (f"{p}.dw.b", (c,))]
            ln(f"{p}.ln", c)
            out += [(f"{p}.fc1.w", (4 * c, c)), (f"{p}.fc1.b", (4 * c,)),
                    (f"{p}.fc2.w", (c, 4 * c)), (f"{p}.fc2.b", (c,)),
                    (f"{p}.gamma", (c,))]
    ln("head.ln", w[-1])
    out += [("fc.w", (cfg["num_classes"], w[-1])),
            ("fc.b", (cfg["num_classes"],))]
    return out


def convs(cfg) -> list[Conv]:
    """Every conv in flow order."""
    d, w = cfg["depths"], cfg["widths"]
    out = [Conv("stem", 3, w[0], 4, 4, 0)]
    for i, c in enumerate(w):
        if i:
            out.append(Conv(f"down{i}", w[i - 1], c, 2, 2, 0))
        out += [Conv(f"s{i}.{j}.dw", c, c, 7, 1, 3, group=c)
                for j in range(d[i])]
    return out


def linears(cfg) -> list[tuple[str, int, int]]:
    """(name, N, Kd) of every Linear in flow order."""
    d, w = cfg["depths"], cfg["widths"]
    out = []
    for i, c in enumerate(w):
        for j in range(d[i]):
            out += [(f"s{i}.{j}.fc1", 4 * c, c), (f"s{i}.{j}.fc2", c, 4 * c)]
    return out + [("fc", cfg["num_classes"], w[-1])]


def layernorms(cfg) -> int:
    """LayerNorms a walk applies: the stem's, each downsampling's, each
    block's and the head's."""
    return 1 + len(cfg["widths"]) - 1 + sum(cfg["depths"]) + 1


def conv_route(c: Conv, h, batch) -> str:
    """"w8a8" (>= 128 input channels, ungrouped, >= 4,096 rows at the
    program's ``batch``) or "float"."""
    return ("w8a8" if c.group == 1 and c.cin >= 128 and batch * h * h >= 4096
            else "float")


def dense_route(rows, n, kd) -> str:
    """"kernel" where dense_q's gate admits the (rows, N, Kd) GEMM, else
    "fallback"."""
    if n % 128 or kd % 128 or rows < 8:
        return "fallback"
    bm = 256 if rows >= 256 else 1 << int(np.floor(np.log2(rows)))
    bn = min(256, n)
    fits = bm * kd * 4 + kd * bn + bm * bn * 4 <= _VMEM_BUDGET
    return "kernel" if fits else "fallback"


def _out(c: Conv, h):
    return (h + 2 * c.pad - c.k) // c.stride + 1


def routes(cfg, side, batch) -> dict[str, tuple[str, int]]:
    """conv or Linear name -> (route, input side) at the program's
    ``batch``: a conv's ``conv_route``, a Linear's ``dense_route`` over the
    rows of its block's map (the classifier's side is 1)."""
    out, h, block_side = {}, side, {}
    for c in convs(cfg):
        out[c.name] = (conv_route(c, h, batch), h)
        h = _out(c, h)
        if c.group > 1:
            block_side[c.name[:-len(".dw")]] = h
    for name, n, kd in linears(cfg):
        hb = block_side.get(name.rsplit(".", 1)[0], 1)
        out[name] = (dense_route(batch * hb * hb, n, kd), hb)
    return out


def plan(cfg, side, batch) -> dict[str, int]:
    """The counters one walk of the program counts at ``batch``:
    ``conv.route.*``, ``dense.route.*`` and ``layernorm``."""
    cnt = collections.Counter()
    for route, _ in routes(cfg, side, batch).values():
        kind = "dense" if route in ("kernel", "fallback") else "conv"
        cnt[f"{kind}.route.{route}"] += 1
    cnt["layernorm"] = layernorms(cfg)
    return dict(cnt)


def dwconv(x, w, pad):
    """A depthwise bfloat16 conv: float32 sums of the exact products of the
    bfloat16 operands, rounded once to bfloat16."""
    return F.conv2d(x.float(), w.float(), None, 1, pad, 1,
                    x.shape[1]).to(BF16)


def _ln(t, s, b):
    """LayerNorm over the last axis in float32 (TF32 plays no part)."""
    return F.layer_norm(t.float(), (t.shape[-1],), s.float(), b.float(), EPS)


def _channel_ln(t, s, b):
    return _ln(t.permute(0, 2, 3, 1), s, b).permute(0, 3, 1, 2)


class Int8ConvNeXt:
    """The reference network.  ``arrays``: name -> float32 array (as
    ``weight_shapes`` names them); ``calib``: the calibration batches
    (float32 NCHW tensors on ``device``)."""

    def __init__(self, cfg, arrays, calib, device, bits=8):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.q = 2 ** (bits - 1) - 1
        self.a = {n: np.asarray(arrays[n], np.float32)
                  for n, _ in weight_shapes(cfg)}
        self.convs = {c.name: c for c in convs(cfg)}
        self.act = self._calibrate(calib)
        self._quantize()

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.dev)

    def _walk(self, x, conv, ln, channel_ln, linear, gelu, scale, add, pool):
        """The logits of ``x`` by the given steps."""
        y = channel_ln(conv(x, "stem"), "stem.ln")
        for i, _ in enumerate(self.cfg["widths"]):
            if i:
                y = conv(channel_ln(y, f"down{i}.ln"), f"down{i}")
            for j in range(self.cfg["depths"][i]):
                p = f"s{i}.{j}"
                t = ln(conv(y, f"{p}.dw").permute(0, 2, 3, 1), f"{p}.ln")
                t = linear(gelu(linear(t, f"{p}.fc1")), f"{p}.fc2")
                y = add(y, scale(t, f"{p}.gamma").permute(0, 3, 1, 2))
        g = channel_ln(pool(y), "head.ln")
        return linear(g.flatten(1), "fc")

    # ------------------------------------------------------ float32 model
    def float_forward(self, x, record=None):
        """The float32 model, TF32 off: the logits of images ``x``;
        ``record(name, t)`` sees each conv's input."""
        t = self._t

        def conv(v, n):
            c = self.convs[n]
            if record is not None:
                record(n, v)
            y = F.conv2d(v, t(self.a[f"{n}.w"]), None, c.stride, c.pad, 1,
                         c.group)
            return y + t(self.a[f"{n}.b"]).reshape(1, -1, 1, 1)

        def ln(v, p):
            return _ln(v, t(self.a[f"{p}.s"]), t(self.a[f"{p}.b"]))

        def channel_ln(v, p):
            return _channel_ln(v, t(self.a[f"{p}.s"]), t(self.a[f"{p}.b"]))

        def linear(v, n):
            return v @ t(self.a[f"{n}.w"]).t() + t(self.a[f"{n}.b"])

        def gelu(v):
            # the exact GELU, in its erfc form
            return (0.5 * v) * torch.erfc(-v * rr._f32(np.sqrt(0.5), v))

        with rr._no_tf32(), torch.no_grad():
            return self._walk(x.float(), conv, ln, channel_ln, linear, gelu,
                              lambda v, n: v * t(self.a[n]), torch.add,
                              lambda v: v.mean((-2, -1), keepdim=True))

    def _calibrate(self, calib):
        """Activation scales: per conv, the percentile of |input| of each
        calibration batch, the largest over the batches, over the largest
        code."""
        pct = float(self.cfg["calibration"]["percentile"])
        maxima = {}

        def record(n, v):
            a = np.abs(v.detach().float().cpu().numpy()).ravel()
            m = float(np.percentile(a, pct)) if pct < 100 else float(a.max())
            maxima[n] = max(maxima.get(n, 0.0), m)

        for x in calib:
            self.float_forward(x, record)
        return {n: max(m, 1e-6) / float(self.q) for n, m in maxima.items()}

    # --------------------------------------------------- derived weights
    def _wq(self, w):
        red = tuple(range(1, w.ndim))
        absmax = np.maximum(np.abs(w).max(axis=red, keepdims=True), 1e-12)
        scale = (absmax / float(self.q)).astype(np.float32)
        q = np.clip(np.round(w / scale), -self.q, self.q).astype(np.int8)
        return q, scale

    def _quantize(self):
        """The int8 weights and per-channel scales of every conv and
        Linear, and every float parameter in bfloat16, as the program
        hands it over."""
        self.wq, self.ws = {}, {}
        names = list(self.convs) + [n for n, _, _ in linears(self.cfg)]
        for n in names:
            q, s = self._wq(self.a[f"{n}.w"])
            self.wq[n] = self._t(q, torch.float64 if n in self.convs
                                 else torch.float32)
            self.ws[n] = self._t(s.reshape(-1))
        quantized = {f"{n}.w" for n in names}
        self.bf = {n: self._t(v).to(BF16) for n, v in self.a.items()
                   if n not in quantized}

    def _deq(self, n):
        """The dequantized weight in bfloat16: (q * scale) in float32."""
        w = self.wq[n].float()
        return (w * self.ws[n].reshape((-1,) + (1,) * (w.ndim - 1))).to(BF16)

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, x, batch=None):
        """Logits (float32) of images ``x`` (float32 NCHW on the device) as
        the program computes them at batch ``batch`` (default: x's)."""
        batch = x.shape[0] if batch is None else batch
        bf = self.bf

        def conv(v, n):
            c = self.convs[n]
            if conv_route(c, v.shape[2], batch) == "w8a8":
                acc = rr.iconv(self._codes(v, self.act[n]), self.wq[n],
                               c.stride, c.pad)
                sc = rr._f32(self.act[n], acc) * self.ws[n]
                y = (acc.float() * sc.reshape(1, -1, 1, 1)).to(BF16)
            elif c.group == 1:
                y = rr.fconv(v, self._deq(n), c.stride, c.pad)
            else:
                y = dwconv(v, self._deq(n), c.pad)
            return y + bf[f"{n}.b"].reshape(1, -1, 1, 1)

        def ln(v, p):
            return _ln(v, bf[f"{p}.s"], bf[f"{p}.b"]).to(BF16)

        def channel_ln(v, p):
            return _channel_ln(v, bf[f"{p}.s"], bf[f"{p}.b"]).to(BF16)

        def linear(v, n):
            kd = v.shape[-1]
            rows = v.numel() // kd
            if dense_route(rows, self.wq[n].shape[0], kd) == "kernel":
                acc = v.float() @ self.wq[n].t()
                y = (acc * self.ws[n]).to(BF16)
            else:
                y = (v.float() @ self._deq(n).float().t()).to(BF16)
            return y + bf[f"{n}.b"]

        half = float(torch.tensor(0.5, dtype=BF16))
        root = float(torch.tensor(float(np.float32(np.sqrt(0.5))),
                                  dtype=BF16))

        def gelu(v):
            h = (v.float() * half).to(BF16)
            return (h.float() * torch.erfc(-v.float() * root)).to(BF16)

        with rr._no_tf32():
            z = self._walk(
                x.to(BF16), conv, ln, channel_ln, linear, gelu,
                lambda v, n: v * bf[n], torch.add,
                lambda v: v.float().mean((-2, -1), keepdim=True).to(BF16))
        return z.float()

    def _codes(self, v, s):
        """Codes of v at scale s: round(v * f32(1 / f32(s))), clipped."""
        r = np.float32(1.0) / np.float32(s)
        return torch.clamp(torch.round(v.float() * rr._f32(r, v)), -self.q,
                           self.q).double()
