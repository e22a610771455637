"""Plain reference of the INT8 ResNet configurations (ResNet-18 and -50 with
static int8 activation scales and bfloat16 compute).

It starts from the float arrays and calibration images the benchmark made
and works out again everything the program derives from them: the
BatchNorm fold, the activation scales (percentile of |input| per conv over
the calibration batches, in a float32 forward with TF32 off), the int8
per-output-channel weights, which convs emit int8 codes and at which scale,
the route each conv takes at the program's batch, the folded tables of the
fused entry stage (stem, maxpool and the C=64 basic blocks: int32
fixed-point epilogues) and of the fused body stages (truncating requants,
the projection residual requantized once), and the bfloat16 roundings of
the decomposed ops.

Integer convolutions run as float64 convolutions of integer-valued
tensors, exact since every partial sum stays below 2**53; a bfloat16 conv
runs in float64 on the bfloat16-rounded operands and rounds once.  Nothing
here imports the program or its kernels: torch and numpy only.

``bits`` sets the integer width of weights and activation codes; the
benchmark's control is this reference at ``bits=4``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = np.float32

# fixed-point budget of the entry stage's int32 epilogues
_FXP_MMAX = 115
# the lane-layout limits that decide where the stages fuse
_HALO = 128
_S_MAX = 5760


# --------------------------------------------------------------------------
# shapes (shared with resnet.py, which builds the program's graph)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Conv:
    name: str          # weight prefix: "<name>.w", "<name>.bn.k", "<name>.bn.b"
    cin: int
    cout: int
    k: int
    stride: int
    pad: int


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    kind: str          # "basic" | "bottleneck"
    layer: int         # 0-based stage index
    stride: int
    cin: int
    cout: int
    convs: tuple       # main chain, in order
    down: Conv | None  # the 1x1 projection of an entry block


STEM = Conv("stem", 3, 64, 7, 2, 3)


def blocks_of(cfg) -> list[Block]:
    """The residual blocks of a torchvision-layout ResNet: ``cfg["block"]``
    is "basic" or "bottleneck", ``cfg["layers"]`` the blocks per stage,
    ``cfg["widths"]`` each stage's width (a bottleneck's output is 4x)."""
    kind = cfg["block"]
    exp = 1 if kind == "basic" else 4
    out, cin = [], 64
    for si, (n, w) in enumerate(zip(cfg["layers"], cfg["widths"])):
        for bi in range(n):
            st = 2 if (si > 0 and bi == 0) else 1
            cout = w * exp
            p = f"layer{si + 1}.{bi}"
            if kind == "basic":
                convs = (Conv(f"{p}.conv1", cin, w, 3, st, 1),
                         Conv(f"{p}.conv2", w, w, 3, 1, 1))
            else:
                convs = (Conv(f"{p}.conv1", cin, w, 1, 1, 0),
                         Conv(f"{p}.conv2", w, w, 3, st, 1),
                         Conv(f"{p}.conv3", w, cout, 1, 1, 0))
            down = (Conv(f"{p}.down", cin, cout, 1, st, 0)
                    if (st != 1 or cin != cout) else None)
            out.append(Block(p, kind, si, st, cin, cout, convs, down))
            cin = cout
    return out


def all_convs(cfg) -> list[Conv]:
    """Every conv in the order the flow runs them (main chain, then the
    projection)."""
    out = [STEM]
    for b in blocks_of(cfg):
        out += list(b.convs) + ([b.down] if b.down else [])
    return out


def stage64_geometry(h):
    """The entry stage's side R = h // 4, or None where it runs decomposed."""
    if h % 4:
        return None
    r = h // 4
    rs = next(v for v in range(r + 2, r + 130) if (r * v) % 128 == 0)
    if r < 16 or r * rs > _S_MAX or rs + 1 > _HALO:
        return None
    return r


def stagen_geometry(r):
    """A body stage's output side R, or None where it runs decomposed."""
    if r < 7:
        return None
    rs = next(v for v in range(r + 2, r + 130) if (r * v) % 128 == 0)
    if r * rs > _S_MAX or rs + 1 > _HALO or rs > 1.35 * r:
        return None
    return r


def stage64_blocks(cfg) -> list[Block]:
    """The blocks the entry stage takes beside the stem: the leading
    64 -> 64 basic identity blocks."""
    out = []
    for b in blocks_of(cfg):
        if not (b.kind == "basic" and b.cin == 64 and b.cout == 64
                and b.stride == 1 and b.down is None):
            break
        out.append(b)
    return out


def plan(cfg, side):
    """(stage64 blocks, [(stage blocks, fused?)] of ``fuse="all"``, the
    unfused blocks of the default fuse) at input side ``side``."""
    if cfg["fuse"] not in ("default", "all"):
        raise ValueError(f"fuse {cfg['fuse']!r}")
    if stage64_geometry(side) is None:
        raise NotImplementedError(f"a decomposed entry stage (side {side})")
    s64 = stage64_blocks(cfg)
    rest = blocks_of(cfg)[len(s64):]
    if cfg["fuse"] == "default":
        if cfg["block"] != "basic":
            raise NotImplementedError("default fuse of bottleneck blocks")
        return s64, [], rest
    stages, h = [], side // 4
    for li in sorted({b.layer for b in rest}):
        blks = [b for b in rest if b.layer == li]
        st = blks[0].stride
        fused = h % st == 0 and stagen_geometry(h // st) is not None
        stages.append((blks, fused))
        h //= st
    return s64, stages, []


def conv_route(c: Conv, h, w, codes, batch):
    """The arithmetic the program's decomposed conv ``c`` takes on an
    (h, w) input at the program's ``batch``: "s8" (int8 codes straight into
    the integer conv), "w8a8" (quantize, integer conv) or "float" (the
    dequantized bfloat16 conv)."""
    if codes and c.cin >= 128:
        return "s8"
    rows = batch * h * w
    if c.cin >= 128 and rows >= 4096:
        return "w8a8"
    if (c.k == 3 and c.cout <= 64 and c.stride == 1 and c.pad == 1
            and h % 2 == 0 and h >= 4 and rows >= 100_000 and w <= 128):
        return "w8a8"
    return "float"


def _out_side(c: Conv, h):
    return (h + 2 * c.pad - c.k) // c.stride + 1


def routes(cfg, side, batch):
    """conv name -> (route, input side): "stage64" or "stagen" for the
    convs of a fused stage, else ``conv_route``'s, as ``forward`` takes
    them."""
    s64, stages, rest = plan(cfg, side)
    out = {"stem": ("stage64", side)}
    h = side // 4
    for b in s64:
        for c in b.convs:
            out[c.name] = ("stage64", h)
    codes = False
    for i, b in enumerate(rest):            # the default fuse's blocks
        nxt = i + 1 < len(rest)
        c1, c2 = b.convs
        out[c1.name] = (conv_route(c1, h, h, codes, batch), h)
        h2 = _out_side(c1, h)
        out[c2.name] = (conv_route(c2, h2, h2, c2.cin >= 128, batch), h2)
        if b.down:
            out[b.down.name] = (conv_route(b.down, h, h, codes, batch), h)
        h, codes = h2, nxt
    for blks, fused in stages:              # fuse="all"
        for b in blks:
            t = h
            for c in b.convs:
                out[c.name] = ("stagen" if fused
                               else conv_route(c, t, t, False, batch), t)
                t = _out_side(c, t)
            if b.down:
                out[b.down.name] = ("stagen" if fused
                                    else conv_route(b.down, h, h, False,
                                                    batch), h)
            h = t
    return out


# --------------------------------------------------------------------------
# arithmetic helpers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _no_tf32():
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def _f32(v, like):
    """A 0-dim float32 tensor of ``v`` (rounded to float32 once)."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


def iconv(x, w, stride, pad):
    """Exact integer convolution of integer-valued tensors (float64)."""
    return F.conv2d(x.double(), w.double(), None, stride, pad)


def fconv(x, w, stride, pad):
    """A bfloat16 conv: float64 sums of the bfloat16 operands, rounded once
    to float32 and then to bfloat16."""
    return F.conv2d(x.double(), w.double(), None, stride,
                    pad).float().to(BF16)


def _fxp_pack(f, b_half, sx=0.0):
    """Per-channel (m, B, s, mr) int32 with clamp((acc*m + res*mr + B) >> s)
    == clamp(floor(acc*f + res*sx + b + 0.5)) up to rounding of m and mr;
    int32 headroom |acc*m| <= 2^30, |res*mr| <= 2^29, |B| <= 2^28."""
    f = np.asarray(f, np.float64).reshape(-1)
    bh = np.asarray(b_half, np.float64).reshape(-1)
    s = np.floor(np.log2(_FXP_MMAX / np.maximum(f, 1e-30)))
    if sx:
        s = np.minimum(s, np.floor(np.log2(2.0 ** 29 / (127.0 * abs(sx)))))
    s = np.minimum(s, np.floor(np.log2(2.0 ** 28
                                       / np.maximum(np.abs(bh), 1.0))))
    s = np.clip(s, 0, 30)
    p = 2.0 ** s
    return np.stack([np.round(f * p), np.round(bh * p), s,
                     np.round(sx * p)], axis=1).astype(np.int64)


class Int8ResNet:
    """The reference network.  ``arrays``: name -> float32 array (conv
    weights OIHW, BatchNorm affine ``.bn.k`` / ``.bn.b`` of shape (1, C, 1,
    1), ``fc.w`` (classes, C), ``fc.b``); ``calib``: the calibration
    batches (float32 NCHW tensors on ``device``)."""

    def __init__(self, cfg, arrays, calib, device, bits=8):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.q = 2 ** (bits - 1) - 1         # largest code, weights and acts
        self.clip = self.q + 0.99            # the truncating requants' clip
        self.convs = {c.name: c for c in all_convs(cfg)}
        self._fold_bn(arrays)
        self.act = self._calibrate(calib)
        self._quantize()

    # ------------------------------------------------------ derived values
    def _fold_bn(self, arrays):
        self.fw, self.fb = {}, {}
        for n in self.convs:
            w = np.asarray(arrays[f"{n}.w"], np.float32)
            k = np.asarray(arrays[f"{n}.bn.k"], np.float32).reshape(-1)
            self.fw[n] = (w * k.reshape(-1, 1, 1, 1)).astype(np.float32)
            self.fb[n] = np.asarray(arrays[f"{n}.bn.b"],
                                    np.float32).reshape(-1)
        self.fc_w = np.asarray(arrays["fc.w"], np.float32)
        self.fc_b32 = np.asarray(arrays["fc.b"], np.float32)

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.dev)

    def float_forward(self, x, record=None):
        """The float32 model on the folded weights, TF32 off: the logits of
        images ``x``; ``record(name, t)`` sees each conv's input."""
        def conv(n, t):
            c = self.convs[n]
            if record is not None:
                record(n, t)
            y = F.conv2d(t, self._t(self.fw[n]), None, c.stride, c.pad)
            return y + self._t(self.fb[n]).reshape(1, -1, 1, 1)

        with _no_tf32(), torch.no_grad():
            y = F.max_pool2d(torch.relu(conv("stem", x.float())), 3, 2, 1)
            for b in blocks_of(self.cfg):
                t = y
                for i, c in enumerate(b.convs):
                    t = conv(c.name, t)
                    if i < len(b.convs) - 1:
                        t = torch.relu(t)
                res = conv(b.down.name, y) if b.down else y
                y = torch.relu(t + res)
            g = y.mean((-2, -1))
            return g @ self._t(self.fc_w).t() + self._t(self.fc_b32)

    def _calibrate(self, calib):
        """Activation scales: per conv, the percentile of |input| of each
        calibration batch, the largest over the batches, over the largest
        code."""
        pct = float(self.cfg["calibration"]["percentile"])
        maxima = {}

        def record(n, t):
            a = np.abs(t.detach().float().cpu().numpy()).ravel()
            m = float(np.percentile(a, pct)) if pct < 100 else float(a.max())
            maxima[n] = max(maxima.get(n, 0.0), m)

        for x in calib:
            self.float_forward(x, record)
        return {n: max(m, 1e-6) / float(self.q) for n, m in maxima.items()}

    def _wq(self, w):
        red = tuple(range(1, w.ndim))
        absmax = np.maximum(np.abs(w).max(axis=red, keepdims=True), 1e-12)
        scale = (absmax / float(self.q)).astype(np.float32)
        q = np.clip(np.round(w / scale), -self.q, self.q).astype(np.int8)
        return q, scale

    def _quantize(self):
        self.ws, self.wq_t, self.ws_t, self.b_bf = {}, {}, {}, {}
        for n in self.convs:
            q, s = self._wq(self.fw[n])
            self.ws[n] = s.reshape(-1)
            self.wq_t[n] = self._t(q, torch.float64)
            self.ws_t[n] = self._t(s.reshape(-1))
            # the program hands every float parameter over in bfloat16
            self.b_bf[n] = self._t(self.fb[n]).to(BF16)
        fq, fs = self._wq(self.fc_w)
        self.fc_deq = (self._t(fq) * self._t(fs)).to(BF16)
        self.fc_b = self._t(self.fc_b32).to(BF16)

    def _bias32(self, n):
        """The bias as the fused stages fold it: the bfloat16 value, widened."""
        return self.b_bf[n].float().cpu().numpy().reshape(-1, 1)

    def quantize(self, x, s):
        """Codes of x at scale s: round(x * f32(1 / f32(s))), clipped."""
        r = F32(1.0) / F32(s)
        return torch.clamp(torch.round(x.float() * _f32(r, x)),
                           -self.q, self.q)

    # ----------------------------------------------------- the entry stage
    def _stage64(self, x, blocks):
        f32 = F32
        s_in = self.act["stem"]
        inv0 = 1.0 / self.act[blocks[0].convs[0].name] if blocks else 1.0
        f_s = self.ws["stem"].reshape(64, 1) * f32(s_in * inv0)
        b_s = self._bias32("stem") * f32(inv0) + f32(0.5 if blocks else 0.0)
        xq = self.quantize(x, s_in)
        acc = F.max_pool2d(iconv(xq, self.wq_t["stem"], 2, 3), 3, 2, 1)
        if not blocks:
            return torch.relu(self._affine(acc, f_s, b_s)).to(BF16)
        y = self._fxp(acc, _fxp_pack(f_s, b_s))
        for bi, b in enumerate(blocks):
            c1, c2 = b.convs
            sx_in, s_mid = self.act[c1.name], self.act[c2.name]
            last = bi == len(blocks) - 1
            inv_out = 1.0 if last else 1.0 / self.act[blocks[bi + 1]
                                                     .convs[0].name]
            f1 = self.ws[c1.name].reshape(64, 1) * f32(sx_in / s_mid)
            b1 = self._bias32(c1.name) / f32(s_mid) + f32(0.5)
            f2 = self.ws[c2.name].reshape(64, 1) * f32(s_mid * inv_out)
            b2 = self._bias32(c2.name) * f32(inv_out) + f32(
                0.0 if last else 0.5)
            sx = sx_in * inv_out
            a1 = iconv(y, self.wq_t[c1.name], 1, 1)
            y1 = self._fxp(a1, _fxp_pack(f1, b1))
            a2 = iconv(y1, self.wq_t[c2.name], 1, 1)
            if not last:
                y = self._fxp(a2, _fxp_pack(f2, b2, sx=sx), res=y)
            else:
                v = self._affine(a2, f2, b2) + y.float() * _f32(sx, y)
                y = torch.relu(v).to(BF16)
        return y

    def _fxp(self, acc, tab, res=None):
        t = torch.as_tensor(tab, device=self.dev)
        m, B, s, mr = (t[:, i].reshape(1, -1, 1, 1) for i in range(4))
        v = acc.to(torch.int64) * m + B
        if res is not None:
            v = v + res.to(torch.int64) * mr
        return torch.clamp(v >> s, 0, self.q).double()

    def _affine(self, acc, f, b):
        """acc*f + b in float32, the product and the sum each rounded."""
        f = self._t(np.asarray(f, np.float32).reshape(-1))
        b = self._t(np.asarray(b, np.float32).reshape(-1))
        return acc.float() * f.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)

    # ----------------------------------------------------- the body stages
    def _stagen(self, x, blocks):
        f32 = F32

        def fold_scale(n, num, den=1.0):
            return self.ws[n] * f32(num / den)

        def fold_bias(n, scale, half):
            return self._bias32(n).reshape(-1) * f32(scale) + f32(half)

        s_in = self.act[blocks[0].convs[0].name]
        cur_s = s_in
        cur = self.quantize(x, s_in).double()
        for bi, b in enumerate(blocks):
            last = bi == len(blocks) - 1
            nxt = 1.0 if last else 1.0 / self.act[blocks[bi + 1]
                                                  .convs[0].name]
            hf = 0.0 if last else 0.5
            names = [c.name for c in b.convs]
            if b.kind == "basic":
                s_m = self.act[names[1]]
                tabs = [(fold_scale(names[0], cur_s, s_m),
                         fold_bias(names[0], 1.0 / s_m, 0.5)),
                        (fold_scale(names[1], s_m * nxt),
                         fold_bias(names[1], nxt, hf))]
            else:
                s1, s2 = self.act[names[1]], self.act[names[2]]
                tabs = [(fold_scale(names[0], cur_s, s1),
                         fold_bias(names[0], 1.0 / s1, 0.5)),
                        (fold_scale(names[1], s1, s2),
                         fold_bias(names[1], 1.0 / s2, 0.5)),
                        (fold_scale(names[2], s2 * nxt),
                         fold_bias(names[2], nxt, hf))]
            res = cur
            if b.down:
                d = b.down.name
                # the residual is requantized once, at 127 x the largest
                # per-channel weight scale x the input scale as its max|v|
                s_res = float(self.ws[d].max()) * cur_s
                v = self._affine(iconv(cur, self.wq_t[d], b.stride, 0),
                                 fold_scale(d, cur_s, s_res),
                                 fold_bias(d, 1.0 / s_res, 0.5))
                res = torch.clamp(torch.floor(v), -self.q, self.q).double()
                sx_res = s_res * nxt
            else:
                sx_res = cur_s * nxt
            t = cur
            for i, c in enumerate(b.convs):
                acc = iconv(t, self.wq_t[c.name], c.stride, c.pad)
                if i < len(b.convs) - 1:
                    v = self._affine(acc, *tabs[i])
                    t = torch.floor(torch.clamp(v, 0.0, self.clip)).double()
            v = self._affine(acc, *tabs[-1]) + res.float() * _f32(sx_res, res)
            if last:
                return torch.relu(v).to(BF16)
            cur = torch.floor(torch.clamp(v, 0.0, self.clip)).double()
            cur_s = self.act[blocks[bi + 1].convs[0].name]

    # ------------------------------------------------- decomposed convs
    def conv(self, x, n, batch, out_scale=None):
        """A decomposed conv.  ``x`` is (tensor, code scale or None)."""
        t, cs = x
        c = self.convs[n]
        rt = conv_route(c, t.shape[2], t.shape[3], cs is not None, batch)
        if cs is not None and rt != "s8":
            raise NotImplementedError(f"{n}: int8 codes into a conv of "
                                      f"{c.cin} < 128 input channels")
        if rt == "float":
            wd = (self.wq_t[n].float() * self.ws_t[n].reshape(-1, 1, 1, 1))
            y = fconv(t.to(BF16), wd.to(BF16), c.stride, c.pad)
        else:
            q = t if rt == "s8" else self.quantize(t, self.act[n])
            acc = iconv(q, self.wq_t[n], c.stride, c.pad)
            scale = _f32(self.act[n], acc) * self.ws_t[n]
            y = (acc.float() * scale.reshape(1, -1, 1, 1)).to(BF16)
        y = y + self.b_bf[n].reshape(1, -1, 1, 1)
        if out_scale is None:
            return (y, None)
        return (self.quantize(y, out_scale).double(), out_scale)

    def qadd(self, a, b, so):
        """The residual add on codes or floats (``so``: emit codes at it)."""
        (ta, sa), (tb, sb) = a, b
        if so is not None:
            def term(t, s):
                r = (1.0 / so) if s is None else (s / so)
                t = t.float()
                return t if r == 1.0 else t * _f32(r, t)
            v = term(ta, sa) + term(tb, sb)
            return (torch.clamp(torch.round(v), -self.q, self.q).double(),
                    so)
        if sa is None and sb is None:
            return (ta + tb, None)
        af = ta.float() if sa is None else ta.float() * _f32(sa, ta)
        bf = tb.float() if sb is None else tb.float() * _f32(sb, tb)
        return ((af + bf).to(BF16), None)

    def _relu(self, x):
        return (torch.clamp_min(x[0], 0), x[1])

    def _unfused(self, y, blocks, batch):
        """Basic blocks run op by op, with int8 codes chained where every
        consumer is an int8 conv of >= 128 input channels (a residual add
        rescales codes itself)."""
        x = (y, None)
        for i, b in enumerate(blocks):
            nxt = blocks[i + 1] if i + 1 < len(blocks) else None
            s_next = self.act[nxt.convs[0].name] if nxt else None
            c1, c2 = b.convs
            mid = (self.act[c2.name] if c2.cin >= 128 else None)
            t = self._relu(self.conv(x, c1.name, batch, out_scale=mid))
            t = self.conv(t, c2.name, batch, out_scale=s_next)
            res = (self.conv(x, b.down.name, batch, out_scale=s_next)
                   if b.down else x)
            x = self._relu(self.qadd(t, res, s_next))
        return x[0]

    def _decomposed(self, y, blocks, batch):
        x = (y, None)
        for b in blocks:
            t = x
            for i, c in enumerate(b.convs):
                t = self.conv(t, c.name, batch)
                if i < len(b.convs) - 1:
                    t = self._relu(t)
            res = self.conv(x, b.down.name, batch) if b.down else x
            x = self._relu(self.qadd(t, res, None))
        return x[0]

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, x, batch=None):
        """Logits (float32) of images ``x`` (float32 NCHW on the device) as
        the program computes them at batch ``batch`` (default: x's)."""
        batch = x.shape[0] if batch is None else batch
        with _no_tf32():
            s64, stages, rest = plan(self.cfg, x.shape[2])
            y = self._stage64(x.to(BF16), s64)
            if rest:
                y = self._unfused(y, rest, batch)
            for blks, fused in stages:
                y = (self._stagen(y, blks) if fused
                     else self._decomposed(y, blks, batch))
            g = y.float().mean((-2, -1)).to(BF16)
            z = (g.double() @ self.fc_deq.double().t()).float().to(BF16)
            return (z + self.fc_b).float()

