"""Fused ResNet body stages (basic and bottleneck blocks) — the port of
``planer_tpu/ops/pallas/stagen.py``.

One ``stagen`` op is one ResNet stage: an optional strided/projected entry
block followed by identity blocks at the same width.  The TPU runs the whole
stage in one Pallas kernel (``_stagen_kernel``) with every activation plane
in VMEM.  A stage does not fit in one SM's shared memory (ResNet-50 layer1
holds 256 x 56 x 56 int8 = 800 KB per image), so on Hopper the wrapper
launches the block kernel (``csrc/stagen.cu``) once per residual block, on
int8 NHWC planes it allocates itself: a block's intermediate planes (t1, t2,
mid, the projection residual) stay in shared memory, per output tile.  The
kernel's operands are packed once on the host (``_pack_stream``): every
weight slice of a block, pre-swizzled, in the order the kernel reads them.
Every block of an eligible stage is one launch, whatever its width: a block
whose input region does not fit beside its planes (the wide stages,
ResNet-50 layers 3-4 and ResNet-18 layer 3's entry and layer 4, where the
input side makes them eligible) runs in one of the kernel's wide forms,
which stream the input through a ring of 64-channel slabs (an entry
block's projection input is loaded once per tile, into the ring's place),
read the identity residual from device memory and walk shorter tiles;
``_route`` picks the first geometry of ``_GEOMETRIES`` whose layout
(``_block_smem``) fits one SM's 227 KB.

What is reproduced is the TPU kernel's arithmetic, not the float model's
(the two are far apart on a calibrated model: ROADMAP "Faults found"):

  * the input quantizes to int8 codes at the first conv's act scale
    (``stagen_prologue``);
  * s8 x s8 convs accumulate exactly in int32;
  * every post-ReLU plane requantizes by the trunc-fold rule
    ``clamp(acc*f + b, 0, 127.99)`` truncated to int8, with the rounding's
    +0.5 folded into b; the 1x1 projection residual is requantized once to
    ``clamp(floor(acc*f + b), -127, 127)``;
  * a block ends in ``(acc*f + b) + res*sx`` with float32 rounding at each
    step, clipped and truncated to int8, or, in the stage's last block,
    ReLU and bfloat16 out (bfloat16 in any program, as the TPU kernel's
    output buffer is).

The scales fold on the host in numpy (``_fold``) exactly as the reference's
``_build`` folds them, so the tables and the int8 planes are the
reference's.  The TPU layout (row padding, halos, space-to-depth phase
planes) is not part of the contract.  Ineligible stages fall back to
``decomposed`` and are counted in ``FALLOFF`` by the reference's own gates.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..qtypes import QTensor
from ..torch_ops import conv_s8, quantize, scalar

__all__ = ["stagen", "decomposed", "parse_blocks", "FALLOFF", "LAUNCHES",
           "stagen_stage", "stagen_plain", "stagen_prologue"]

# why the fused path was skipped, by reason (the reference's keys)
FALLOFF = collections.Counter()
# kernel launches, as "stagen_block:<tag>" (one per residual block) by the
# stage geometry (see _Plan.tag) they ran for; runs of the plain version are
# not counted
LAUNCHES = collections.Counter()

# the reference's lane-layout limits, which decide where it fuses
HALO = 128
_S_MAX = 5760
# the kernel's channel granule: planes and weights are zero-padded to it
_CPAD = 64
# the kernel's block forms (its FORM template argument) by (kind, stride)
_FORMS = {("bottleneck", 1): 0, ("basic", 1): 1, ("basic", 2): 2,
          ("bottleneck", 2): 3}
# each form's geometries as (tile rows, input slab slots), in the order
# they are tried: the resident form (0 slots: the whole input region in
# shared memory), then the wide forms (the region streamed through 2 or 1
# 64-channel slabs) at the tile heights the widest ResNet blocks need,
# taller tiles first (fewer weight slices per output pixel: measured faster
# than a second slot, stagen_study); csrc/stagen.cu by_geometry holds the
# same
_GEOMETRIES = {0: ((14, 0), (14, 2), (14, 1), (7, 2), (7, 1)),
               1: ((14, 0), (14, 2), (14, 1)),
               2: ((14, 0), (14, 1), (7, 2), (7, 1)),
               3: ((7, 0), (7, 2), (7, 1), (3, 2), (3, 1))}
# the block kernel's shared-memory budget (227 KB), weight ring depth and
# bf16 staging pitch (csrc/stagen.cu SMEM_MAX, NB, SP)
_SMEM_MAX = 232448
_NB = 6
_SP = 200


# --------------------------------------------------------------------------
# block plan parsing, eligibility (the reference's gates)
# --------------------------------------------------------------------------

def parse_blocks(blocks, w):
    """Split the flat weight list into per-block dicts.

    ``blocks``: list of {"kind": "basic"|"bottleneck", "stride": 1|2,
    "down": bool} (the IR kwarg).  ``w``: flat [W1, B1, W2, B2, (W3, B3),
    (Wd, Bd)] per block."""
    out, i = [], 0
    for b in blocks:
        d = dict(b)
        n = 6 if b["kind"] == "bottleneck" else 4
        d["convs"] = [(w[i + 2 * k], w[i + 2 * k + 1]) for k in range(n // 2)]
        i += n
        if b.get("down"):
            d["proj"] = (w[i], w[i + 1])
            i += 2
        out.append(d)
    if i != len(w):
        raise ValueError(f"stagen: {len(w)} weights != plan {blocks}")
    return out


def _geometry(R):
    """The stage's output side R, or None where the reference decomposes:
    its row stride RS (the first R*RS that is a multiple of 128) must keep
    S = R*RS <= 5760, RS + 1 <= 128 and waste at most 35% of each row, so
    the small grids of ResNet layers 3-4 stay decomposed."""
    if R < 7:
        return None
    RS = next(r for r in range(R + 2, R + 130) if (R * r) % 128 == 0)
    if R * RS > _S_MAX or RS + 1 > HALO or RS > 1.35 * R:
        return None
    return R


def _eligible(x, w, blocks):
    """The stage's output side, or None (recording WHY in FALLOFF)."""
    if not blocks or x.ndim != 4 or x.shape[2] != x.shape[3]:
        FALLOFF["shape"] += 1
        return None
    try:
        parsed = parse_blocks(blocks, w)
    except Exception:
        FALLOFF["weights"] += 1
        return None
    for b in parsed:
        for W, _ in b["convs"] + ([b["proj"]] if b.get("down") else []):
            if not (isinstance(W, QTensor) and W.act_scale is not None
                    and W.q.dtype == torch.int8):
                FALLOFF["weights"] += 1
                return None
    st = int(parsed[0].get("stride", 1))
    H = x.shape[2]
    if H % st:
        FALLOFF["geometry"] += 1
        return None
    R = _geometry(H // st)
    if R is None:
        FALLOFF["geometry"] += 1
        return None
    # later blocks must be stride-1 identity blocks at constant width
    c0 = parsed[0]["convs"][-1][0].q.shape[0]
    for b in parsed[1:]:
        if (int(b.get("stride", 1)) != 1 or b.get("down")
                or b["convs"][-1][0].q.shape[0] != c0):
            FALLOFF["structure"] += 1
            return None
    return R


def decomposed(x, *w, blocks=None, on_conv=None):
    """Reference semantics: exactly the op chain the fusion replaced.
    ``on_conv(x)``, if given, sees each conv's input, in the order of the
    weights (calibration records them)."""
    from .. import torch_ops as tops

    def conv(x, W, B, st=1, pad=0):
        if on_conv is not None:
            on_conv(x)
        return tops.conv2d(x, W, B, strides=(st, st), pads=(pad,) * 4)

    for b in parse_blocks(blocks, w):
        st = int(b.get("stride", 1))
        res = x
        if b["kind"] == "basic":
            (W1, B1), (W2, B2) = b["convs"]
            y = tops.relu(conv(x, W1, B1, st, 1))
            y = conv(y, W2, B2, 1, 1)
        else:
            (W1, B1), (W2, B2), (W3, B3) = b["convs"]
            y = tops.relu(conv(x, W1, B1))
            y = tops.relu(conv(y, W2, B2, st, 1))
            y = conv(y, W3, B3)
        if b.get("down"):
            Wd, Bd = b["proj"]
            res = conv(res, Wd, Bd, st)
        x = tops.relu(tops.add(y, res))
    return x


# --------------------------------------------------------------------------
# host folding (the reference's _build, in numpy float32/float64)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Conv:
    """One conv of the stage with its folded epilogue."""
    w: torch.Tensor          # (O, C, k, k) int8 codes
    f: torch.Tensor          # (O,) float32 folded scale
    b: torch.Tensor          # (O,) float32 folded bias
    stride: int


@dataclasses.dataclass
class _Block:
    kind: str
    stride: int
    convs: list              # W1, W2 (, W3) as _Conv, in chain order
    proj: _Conv | None       # the 1x1 projection of an entry block
    sx_res: float            # the residual's scale into the final sum
    last: bool
    form: int = 0            # the kernel's block form (_FORMS)
    th: int | None = None    # its geometry (_route): tile rows, None if none fits
    xr: int = 0              # input slab slots, 0 for the resident input
    smem: int = 0            # the layout's bytes (the smallest's if none fits)
    stream: torch.Tensor | None = None   # (S, 4096) int8: _pack_stream
    tab: torch.Tensor | None = None      # float32 (f, b) rows: _pack_tab

    def widths(self):
        """(cin, cmid, cout) padded to the granule; cmid = cout for a basic
        block."""
        return (_cpad(self.convs[0].w.shape[1]),
                _cpad(self.convs[0].w.shape[0]),
                _cpad(self.convs[-1].w.shape[0]))


@dataclasses.dataclass
class _Plan:
    s_in: float
    blocks: list
    cin: int
    cout: int

    @property
    def tag(self):
        """The stage's geometry for LAUNCHES: kind, entry stride, widths
        and depth, e.g. "bottleneck/s2/256-128-512x4"."""
        b0 = self.blocks[0]
        cm = b0.convs[1].w.shape[0]
        return (f"{b0.kind}/s{b0.stride}/{self.cin}-{cm}-{self.cout}"
                f"x{len(self.blocks)}")


def _np32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def _fold_scale(W, num, den=1.0):
    """The reference's ``_fold``: f32 scale x f32(num / den)."""
    return _np32(W.scale).reshape(-1) * np.float32(num / den)


def _fold_bias(Bv, c, scale, half):
    """The reference's ``_bias`` plus its folded rounding term: f32 bias x
    f32(scale), then + half."""
    v = (np.zeros((c,), np.float32) if Bv is None
         else _np32(Bv).reshape(-1))
    return v * np.float32(scale) + np.float32(half)


def _res_scale(Wd, cur):
    """The projection residual's requant step, the reference's choice:
    it takes 127 * max per-channel weight scale * input scale as the
    residual's max|v|.  That bounds one product term, not the sum over
    C_in, so on a calibrated net most residual codes clip (ROADMAP "Faults
    found"); the port reproduces it."""
    return float(_np32(Wd.scale).max()) * cur


def _cpad(c):
    return -(-c // _CPAD) * _CPAD


def _swz(p, chunk):
    """Byte offset of 16-byte chunk ``chunk`` of 64-byte row ``p`` in the
    kernel's shared planes and weight slices (csrc/stagen.cu ``swz``)."""
    return (p << 6) | ((chunk ^ ((p >> 1) & 3)) << 4)


# byte of (output o, input channel c) in a 4 KB weight slice
_SLICE_AT = _swz(np.arange(64)[:, None], np.arange(64)[None, :] >> 4) \
    + (np.arange(64)[None, :] & 15)


def _padded(c):
    """(Op, Cp, k*k) int8: the conv's codes zero-padded to the granule."""
    wq = c.w.detach().cpu().numpy()
    o, ci, k, _ = wq.shape
    out = np.zeros((_cpad(o), _cpad(ci), k * k), np.int8)
    out[:o, :ci] = wq.reshape(o, ci, k * k)
    return out


def _slice(wp, n, t, s):
    """Outputs 64n.., tap t, input channels 64s.. of padded weights as the
    kernel's 4 KB slice: byte (o, c) at _swz(o, c >> 4) + (c & 15)."""
    out = np.empty(64 * 64, np.int8)
    out[_SLICE_AT] = wp[64 * n:64 * n + 64, 64 * s:64 * s + 64, t]
    return out


def _pack_stream(blk):
    """The block's weight stream: every slice the kernel reads for one
    output tile, in the order it reads them -> (S, 4096) int8.

    bottleneck: conv1 (once per group of 256 t1 rows) by output chunk and
    input slab; conv2 by output chunk, tap, slab; then per 64 outputs the
    projection's slabs (entry blocks) and conv3's.  basic: conv1 by output
    chunk, tap, slab (a wide form: by output chunk, slab, tap, every tap of
    a streamed slab before the next); then per 64 outputs the projection's
    slabs and conv2's taps and slabs."""
    ws = [_padded(c) for c in blk.convs]
    wd = _padded(blk.proj) if blk.proj is not None else None
    cs = ws[0].shape[1] // 64
    out = []

    def conv(wp, n, taps, slabs, slab_major=False):
        order = ([(t, s) for s in range(slabs) for t in range(taps)]
                 if slab_major else
                 [(t, s) for t in range(taps) for s in range(slabs)])
        out.extend(_slice(wp, n, t, s) for t, s in order)

    if blk.kind == "bottleneck":
        ms, os_ = ws[0].shape[0] // 64, ws[2].shape[0] // 64
        for _ in range(-(-_geo(blk.form, blk.th)[3] // 256)):
            for n in range(ms):
                conv(ws[0], n, 1, cs)
        for n in range(ms):
            conv(ws[1], n, 9, ms)
        fin, fin_taps, fin_slabs = ws[2], 1, ms
    else:
        os_ = ws[0].shape[0] // 64
        for n in range(os_):
            conv(ws[0], n, 9, cs, slab_major=blk.xr > 0)
        fin, fin_taps, fin_slabs = ws[1], 9, os_
    for n in range(os_):
        if wd is not None:
            conv(wd, n, 1, cs)
        conv(fin, n, fin_taps, fin_slabs)
    return np.stack(out)


def _geo(form, th):
    """(tile rows, tile cols, input-region pixels per slab, first-conv rows:
    one per pixel of its t1 / mid plane) of a form at ``th`` tile rows
    (csrc/stagen.cu Geo)."""
    xpix = {0: (th + 2) * 16, 1: (th + 4) * 18, 2: 4 * (th + 3) * 17,
            3: 4 * (th + 1) * 15}[form]
    return th, 14, xpix, xpix if form in (0, 3) else (th + 2) * 16


def _block_smem(form, th, xr, cin, cmid, cout, proj, last):
    """Bytes of dynamic shared memory the block kernel lays out for a block
    of this form, geometry (``th`` tile rows, ``xr`` input slab slots, 0:
    the input region resident at all cin channels) and these padded widths
    (csrc/stagen.cu ``layout``; the library's ``stagen_block_smem`` returns
    the same)."""
    th, tw, xpix, c1rows = _geo(form, th)
    bot = form in (_FORMS["bottleneck", 1], _FORMS["bottleneck", 2])
    out = th * tw
    stage = 64 * _SP * 2 if last else out * 64
    t1b = c1rows * (cmid if bot else cout)
    if bot:                              # staging reuses t1 after conv2
        t1b = max(t1b, stage)
    end = t1b + (out * cmid if bot else 0) + (out * 64 if proj else 0)
    if not bot:
        end += stage
    # the input region: resident, or xr slabs of the wide forms' ring, whose
    # place an entry block's projection input (its out pixels at cin
    # channels) takes after the first conv
    if xr:
        end += max(xr * xpix * 64, out * cin if proj else 0)
    else:
        end += xpix * cin
    return end + _NB * 64 * 64 + 2 * _NB * 8


def _route(blk):
    """The block's geometry: the first of its form's ``_GEOMETRIES`` whose
    layout fits one SM's 227 KB, as (tile rows, slab slots, bytes); (None,
    0, bytes of the smallest) where none does."""
    args = (*blk.widths(), blk.proj is not None, blk.last)
    sizes = [(th, xr, _block_smem(blk.form, th, xr, *args))
             for th, xr in _GEOMETRIES[blk.form]]
    return next((g for g in sizes if g[2] <= _SMEM_MAX),
                (None, 0, min(g[2] for g in sizes)))


def _pack_tab(blk):
    """float32 (f, b) of each conv in chain order, the projection last,
    each zero-padded to the granule."""
    rows = []
    for c in blk.convs + ([blk.proj] if blk.proj is not None else []):
        o = c.f.shape[0]
        for v in (c.f, c.b):
            rows.append(np.pad(_np32(v), (0, _cpad(o) - o)))
    return np.concatenate(rows)


def _fold(w, blocks, device):
    """Fold every requant scale on the host, following the reference's
    ``_build`` step by step: float64 Python scalars rounded to float32 once
    per product, biases as the program passes them (bf16-rounded in a bf16
    program)."""
    parsed = parse_blocks(blocks, w)
    s_in = float(parsed[0]["convs"][0][0].act_scale)

    def conv(W, f, b, stride=1):     # the tables move to device once packed
        return _Conv(W.q, torch.as_tensor(f, dtype=torch.float32),
                     torch.as_tensor(b, dtype=torch.float32), stride)

    cur = s_in
    out = []
    for bi, b in enumerate(parsed):
        last = bi == len(parsed) - 1
        st = int(b.get("stride", 1))
        nxt = (1.0 if last
               else 1.0 / float(parsed[bi + 1]["convs"][0][0].act_scale))
        # +0.5 folded into every QUANTIZING bias; the last block's final
        # bias stays raw for the bf16 out
        hf = 0.0 if last else 0.5
        if b["kind"] == "basic":
            (W1, B1), (W2, B2) = b["convs"]
            cout = W1.q.shape[0]
            s_m = float(W2.act_scale)
            convs = [
                conv(W1, _fold_scale(W1, cur, s_m),
                     _fold_bias(B1, cout, 1.0 / s_m, 0.5), st),
                conv(W2, _fold_scale(W2, s_m * nxt),
                     _fold_bias(B2, cout, nxt, hf))]
        else:
            (W1, B1), (W2, B2), (W3, B3) = b["convs"]
            cmid, cout = W1.q.shape[0], W3.q.shape[0]
            s1, s2 = float(W2.act_scale), float(W3.act_scale)
            convs = [
                conv(W1, _fold_scale(W1, cur, s1),
                     _fold_bias(B1, cmid, 1.0 / s1, 0.5)),
                conv(W2, _fold_scale(W2, s1, s2),
                     _fold_bias(B2, cmid, 1.0 / s2, 0.5), st),
                conv(W3, _fold_scale(W3, s2 * nxt),
                     _fold_bias(B3, cout, nxt, hf))]
        proj = None
        if b.get("down"):
            Wd, Bd = b["proj"]
            # the residual is requantized once to int8 at its own scale
            s_res = _res_scale(Wd, cur)
            proj = conv(Wd, _fold_scale(Wd, cur, s_res),
                        _fold_bias(Bd, cout, 1.0 / s_res, 0.5), st)
            sx_res = s_res * nxt
        else:
            sx_res = cur * nxt
        blk = _Block(b["kind"], st, convs, proj, sx_res, last,
                     _FORMS[b["kind"], st])
        blk.th, blk.xr, blk.smem = _route(blk)
        if blk.th is not None:       # else stagen_stage raises on the card
            blk.stream = torch.as_tensor(_pack_stream(blk)).to(device)
            blk.tab = torch.as_tensor(_pack_tab(blk)).to(device)
        for c in convs + ([proj] if proj is not None else []):
            c.f, c.b = c.f.to(device), c.b.to(device)
        out.append(blk)
        cur = (1.0 if last
               else float(parsed[bi + 1]["convs"][0][0].act_scale))
    cin = parsed[0]["convs"][0][0].q.shape[1]
    return _Plan(s_in, out, cin, out[-1].convs[-1].w.shape[0])


# --------------------------------------------------------------------------
# plain PyTorch version (the kernel's arithmetic, NCHW, on any device)
# --------------------------------------------------------------------------

def stagen_prologue(x, s_in):
    """Quantize the stage input to int8 codes: clamp(round(x / s_in), -127,
    127), with the division compiled as the reference's XLA prologue
    compiles it (a multiply by the float32 reciprocal, torch_ops.quantize).
    The codes are contiguous NCHW whatever x's strides (a decomposed stem
    can hand over a channels-last plane): the kernel reads them in place."""
    return quantize(x, s_in).contiguous()


def _affine(acc, c):
    return acc.float() * c.f.reshape(1, -1, 1, 1) + c.b.reshape(1, -1, 1, 1)


def _requant(acc, c):
    """Post-ReLU plane: trunc-fold requant (float -> int8 truncates)."""
    return torch.clamp(_affine(acc, c), 0.0, 127.99).to(torch.int8)


def _requant_res(acc, c):
    """Pre-ReLU projection residual: explicit floor, symmetric clip."""
    return torch.clamp(torch.floor(_affine(acc, c)), -127.0,
                       127.0).to(torch.int8)


def _block_sum(acc, c, res, sx):
    """A block's final sum (acc*f + b) + res*sx, each step rounded."""
    return _affine(acc, c) + res.float() * scalar(sx, res)


def stagen_plain(xq, plan):
    """(N, C, H, H) int8 codes -> (N, Cout, R, R) bfloat16: every block of
    the stage in NCHW, with the TPU kernel's integer and float32 arithmetic
    (the replay of ``_stagen_kernel`` that tests/test_stagen.py's
    ``_simulate`` is)."""
    cur = xq
    for blk in plan.blocks:
        st = (blk.stride, blk.stride)
        res = cur
        if blk.proj is not None:
            res = _requant_res(conv_s8(cur, blk.proj.w, st), blk.proj)
        if blk.kind == "basic":
            c1, fin = blk.convs
            t = _requant(conv_s8(cur, c1.w, st, (1, 1, 1, 1)), c1)
            acc = conv_s8(t, fin.w, (1, 1), (1, 1, 1, 1))
        else:
            c1, c2, fin = blk.convs
            t = _requant(conv_s8(cur, c1.w), c1)
            t = _requant(conv_s8(t, c2.w, st, (1, 1, 1, 1)), c2)
            acc = conv_s8(t, fin.w)
        v = _block_sum(acc, fin, res, blk.sx_res)
        if blk.last:
            return torch.clamp_min(v, 0.0).to(torch.bfloat16).contiguous()
        cur = torch.clamp(v, 0.0, 127.99).to(torch.int8)
    raise ValueError("stagen: empty plan")


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from . import build
    lib = build.load("stagen")
    if not getattr(lib, "_planer_typed", False):
        lib.stagen_block.argtypes = ([_VP, _VP, _VP, _F, _VP] + [_I] * 12
                                     + [_VP, ctypes.c_longlong, _VP])
        lib.stagen_block.restype = _I
        lib.stagen_block_smem.argtypes = [_I] * 8
        lib.stagen_block_smem.restype = _I
        lib._planer_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch_bytes(blk, n, h, device):
    """The slab images a wide form keeps when it reads a stage's NCHW
    codes: one input region at cin channels per block of its persistent
    grid (one per SM, at most one per tile)."""
    th, tw, xpix, _ = _geo(blk.form, blk.th)
    r = h // blk.stride
    tiles = n * -(-r // th) * -(-r // tw)
    return min(tiles, _sms(device)) * blk.widths()[0] * xpix


def _launch_block(x, h, blk, tag, nchw=False):
    """One block kernel launch on an (N, h, h, Cp) int8 NHWC plane, or
    (``nchw``, a stage's first block) on the stage's (N, C, h, h) int8
    codes (a wide form's slab images in a scratch plane).  Returns (N, r,
    r, Op) int8 NHWC, or (N, Op, r, r) bf16 NCHW for the stage's last
    block, and r."""
    n, cp = x.shape[0], x.shape[1 if nchw else 3]
    cin, cmid, cout = blk.widths()
    if _cpad(cp) != cin:
        raise ValueError(f"stagen block: input has {cp} channels, weights "
                         f"want {cin}")
    r = h // blk.stride
    if blk.last:
        out = torch.empty((n, cout, r, r), dtype=torch.bfloat16,
                          device=x.device)
    else:
        out = torch.empty((n, r, r, cout), dtype=torch.int8, device=x.device)
    scratch = None
    if nchw and blk.xr:
        scratch = torch.empty(_scratch_bytes(blk, n, h, x.device),
                              dtype=torch.int8, device=x.device)
    err = _lib().stagen_block(
        x.data_ptr(), blk.stream.data_ptr(), blk.tab.data_ptr(),
        float(blk.sx_res), out.data_ptr(), n, h, cin, cmid, cout, blk.form,
        blk.th, blk.xr, int(blk.proj is not None), int(blk.last),
        blk.stream.shape[0], cp if nchw else 0,
        scratch.data_ptr() if scratch is not None else None,
        scratch.numel() if scratch is not None else 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"stagen_block launch failed: CUDA error {err}")
    LAUNCHES[f"stagen_block:{tag}"] += 1
    return out, r


def _check_plan(xq, plan):
    if not isinstance(xq, torch.Tensor) or xq.dtype != torch.int8:
        raise TypeError(f"stagen: input must be int8 codes, got "
                        f"{getattr(xq, 'dtype', type(xq))}")
    if xq.ndim != 4 or xq.shape[2] != xq.shape[3] \
            or xq.shape[1] != plan.cin:
        raise ValueError(f"stagen: input shape {tuple(xq.shape)} does not "
                         f"fit a stage of {plan.cin} input channels")
    st = plan.blocks[0].stride
    if xq.shape[2] % st or _geometry(xq.shape[2] // st) is None:
        raise ValueError(f"stagen: no fused geometry for side "
                         f"{xq.shape[2]} at stride {st}")
    if not xq.is_contiguous():
        raise ValueError("stagen: input must be contiguous")
    for blk in plan.blocks:
        ts = [blk.stream, blk.tab]
        for c in blk.convs + ([blk.proj] if blk.proj is not None else []):
            ts += [c.w, c.f, c.b]
        for t in (t for t in ts if t is not None):
            if t.device != xq.device:
                raise ValueError(f"stagen: weights on {t.device}, input "
                                 f"on {xq.device}")


def stagen_stage(xq, plan):
    """Kernel wrapper for ``stagen_plain`` (same arguments and result).
    CPU tensors run the plain version; CUDA tensors launch the block kernel
    once per block of the stage, each in its geometry (``_route``): the
    first block reads the int8 NCHW codes in place, the others the int8
    NHWC planes, padded to 64 channels, that the block before wrote.  A
    block that fits no geometry raises."""
    _check_plan(xq, plan)
    if xq.device.type == "cpu":
        return stagen_plain(xq, plan)
    if xq.device.type != "cuda":
        raise ValueError(f"stagen: no kernel for {xq.device}")
    for i, blk in enumerate(plan.blocks):
        if blk.th is None:
            raise ValueError(
                f"stagen: block {i} of {plan.tag} ({blk.kind}, "
                f"{'-'.join(map(str, blk.widths()))}) needs {blk.smem} bytes "
                f"of shared memory at its smallest tile, over {_SMEM_MAX}")
    out, h = xq, xq.shape[2]
    for i, blk in enumerate(plan.blocks):
        out, h = _launch_block(out, h, blk, plan.tag, nchw=i == 0)
    if out.shape[1] != plan.cout:
        out = out[:, :plan.cout].contiguous()
    return out


# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------

def stagen(x, *w, blocks=None, force_decomposed=False, cache=None,
           plain=False):
    """Fused ResNet body stage.  Positional inputs: x, then per block
    [W1, B1, W2, B2, (W3, B3), (Wd, Bd)] as the ``blocks`` IR kwarg
    describes (see parse_blocks).  An eligible stage runs fused on every
    device: the kernels on CUDA tensors, their plain version on CPU tensors.
    ``cache`` (a dict owned by the caller) keeps the folded tables between
    calls with the same weights.  ``plain`` runs the plain version on any
    device — the reference a caller holds the kernels against; it never
    happens by itself.  A fused stage's output is bfloat16, then cast to
    x's dtype, as the reference's is."""
    if force_decomposed or _eligible(x, w, blocks) is None:
        return decomposed(x, *w, blocks=blocks)
    key = x.device
    plan = cache.get(key) if cache is not None else None
    if plan is None:
        plan = _fold(w, blocks, x.device)
        if cache is not None:
            cache[key] = plan
    xq = stagen_prologue(x, plan.s_in)
    y = stagen_plain(xq, plan) if plain else stagen_stage(xq, plan)
    return y.to(x.dtype)
