"""Spatial parallelism: shard the image H axis across devices — the port's
counterpart of ``planer_tpu/parallel/spatial.py``.

The JAX package annotates its input with an H-axis sharding and lets
GSPMD's spatial partitioner insert the halo exchanges.  The port does the
same partitioning explicitly (``SpatialProgram``), exact to the unsharded
program, unlike host-side tiling (``utils.tile``), which loses receptive
field at window borders:

  * an op with a window over H (``conv``, ``maxpool``, ``averagepool``,
    ``convtranspose``, nearest ``upsample`` by an integer factor): each
    shard computes an even split of the op's *output* rows, fetches the
    input rows those need from the shards that own them, and runs the op
    with the logical image's H padding where its rows meet the image's
    edge and none inside (the W padding kept).  Its route is the unsharded
    op's (``torch_ops.conv_route``);
  * a row-local op (elementwise, activations, ``add``, ``concat`` on C,
    the BN affine, int8 code emission) runs per shard;
  * an op that needs the whole H (global pools, ``flatten``, ``dense``,
    ``reshape``, linear ``resize``, the fused stages), and any op whose
    output has fewer rows than shards, gathers its input, and its result
    continues batch-split or whole (``sharding.ShardedProgram``'s rules).

:func:`halo_exchange` and :func:`spatial_conv` are the explicit building
blocks, on a list of H shards.  On a mesh of one card repeated the
program's step replays as one CUDA graph, as ``ShardedProgram``'s does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import float32_exact
from ..ops import torch_ops as tops
from ..ops.padding import resolve_conv_pads, resolve_pool_pads
from .sharding import (FUSED_OVERRIDES, Mesh, ShardedProgram, Split, _build,
                       _floats, _operand, _place, _grid)

__all__ = ["shard_spatial", "halo_exchange"]


def shard_spatial(net, mesh: Mesh, spatial_axis: str = "model",
                  batch_axis: str | None = "data"):
    """Install a ``SpatialProgram`` of the Net: weights replicated, NCHW
    inputs split over H on ``spatial_axis`` (and over the batch on
    ``batch_axis`` where that axis is larger than 1); return it."""
    if batch_axis is not None and mesh.shape.get(batch_axis, 1) <= 1:
        batch_axis = None
    prog = _build(net, SpatialProgram, mesh=mesh, tp_axis=None,
                  batch_axis=batch_axis, col_axis=spatial_axis)
    prog.op_overrides.update(FUSED_OVERRIDES)
    prog._cache.clear()          # compiled under other overrides
    net._program = prog
    return prog


def _row_ranges(h: int, n: int) -> list[tuple[int, int]]:
    """An even split of ``h`` rows over ``n`` shards (the first ``h % n``
    one row longer), as (start, stop) pairs."""
    q, r = divmod(h, n)
    out, start = [], 0
    for j in range(n):
        stop = start + q + (j < r)
        out.append((start, stop))
        start = stop
    return out


@dataclasses.dataclass
class Tiles:
    """An NCHW value split over the batch and over H: ``parts[i][j]`` is
    data shard ``shards[i]``'s rows ``rows[j]`` of the logical ``h`` rows,
    on the device of (data shard, spatial shard j)."""

    parts: list
    shards: list
    rows: list
    h: int

    @property
    def batch(self) -> int:
        return sum(int(p[0].shape[0]) for p in self.parts)

    @property
    def shape(self) -> tuple:
        n, c, _, w = self.parts[0][0].shape
        return (self.batch, c, self.h, w)

    @property
    def ndim(self) -> int:
        return 4

    @property
    def dtype(self):
        return self.parts[0][0].dtype


# row-local ops: each output row reads its own input row
_ROW_UNARY = {
    "relu", "leakyrelu", "sigmoid", "hardsigmoid", "tanh", "erf", "sqrt",
    "exp", "log", "reciprocal", "abs", "neg", "floor", "ceil", "round",
    "sign", "elu", "softplus", "gelu", "identity", "cast", "clip",
    "batchnorm", "prelu"}
_ROW_NARY = {"add", "sub", "mul", "div", "pow", "equal", "greater",
             "greaterorequal", "where", "min", "max", "mean", "sum"}
_WINDOW_OPS = {"conv", "maxpool", "averagepool", "convtranspose", "upsample"}


class SpatialProgram(ShardedProgram):
    """A Program run with its activations split over H (and the batch) on
    a mesh, from one process; see the module docstring."""

    # --------------------------------------------------------- binding
    def _bind_input(self, x):
        v = super()._bind_input(x)
        if x.ndim != 4 or x.shape[2] < self.n_model or self.n_model == 1:
            return v
        if not isinstance(v, Split):
            v = Split([v], [0])
        return self._tile(v)

    def _tile(self, v: Split) -> Tiles:
        h = int(v.parts[0].shape[2])
        rows = _row_ranges(h, self.n_model)
        parts = [[_place(p[:, :, r0:r1], self._dev(d, j))
                  for j, (r0, r1) in enumerate(rows)]
                 for p, d in zip(v.parts, v.shards)]
        return Tiles(parts, list(v.shards), rows, h)

    def _untile(self, v):
        """A Tiles value as a Split: each data shard's rows gathered on its
        first device."""
        if not isinstance(v, Tiles):
            return v
        return Split([torch.cat([_place(t, self._dev(d)) for t in ts], 2)
                      for ts, d in zip(v.parts, v.shards)], list(v.shards))

    def _whole(self, v):
        return super()._whole(self._untile(v))

    def _take(self, v: Tiles, i: int, lo: int, hi: int, dev):
        """Rows [lo, hi) of data shard piece ``i`` of ``v``, on ``dev``."""
        got = [_place(t[:, :, max(lo, r0) - r0:min(hi, r1) - r0], dev)
               for t, (r0, r1) in zip(v.parts[i], v.rows)
               if r0 < hi and lo < r1]
        return got[0] if len(got) == 1 else torch.cat(got, 2)

    # -------------------------------------------------------- dispatch
    def _apply(self, ri, rec, layer, spec, args, kw):
        if any(isinstance(a, Tiles) for a in args):
            out = None
            if layer.op in _WINDOW_OPS and isinstance(args[0], Tiles) \
                    and not any(isinstance(a, Tiles) for a in args[1:]):
                out = self._window(ri, layer, spec, args, kw)
            elif self._row_local(layer, args, kw):
                out = self._per_tile(ri, spec, args, kw)
            if out is not None:
                return out
            args = [self._untile(a) for a in args]
        return super()._apply(ri, rec, layer, spec, args, kw)

    def _row_local(self, layer, args, kw) -> bool:
        op = layer.op
        tiles = [a for a in args if isinstance(a, Tiles)]
        t0 = tiles[0]
        if any((t.rows, t.shards, t.h) != (t0.rows, t0.shards, t0.h)
               or [p[0].shape[0] for p in t.parts]
               != [p[0].shape[0] for p in t0.parts] for t in tiles):
            return False
        if op == "concat" or op in ("softmax", "logsoftmax"):
            default = 0 if op == "concat" else -1
            if int(kw.get("axis", default)) % 4 not in (1, 3):
                return False
        elif op in _ROW_UNARY:
            if not isinstance(args[0], Tiles) or len(tiles) != 1:
                return False
        elif op not in _ROW_NARY:
            return False
        pieces = [p[0].shape[0] for p in t0.parts]
        for a in args:
            if isinstance(a, Tiles) or not hasattr(a, "shape"):
                continue
            if isinstance(a, Split):
                # a batch-split operand: cut to each tile's rows where it
                # has the image's rows, else broadcast along H
                if a.shards != t0.shards \
                        or [p.shape[0] for p in a.parts] != pieces \
                        or (a.ndim == 4 and a.shape[2] not in (1, t0.h)):
                    return False
            elif a.ndim >= 2 and a.shape[-2] != 1:
                return False    # a whole operand with rows: gather
            elif a.ndim == 4 and a.shape[0] != 1 and len(pieces) > 1:
                return False    # a whole operand with the batch: gather
        return True

    def _per_tile(self, ri, spec, args, kw):
        t0 = next(a for a in args if isinstance(a, Tiles))
        outs = []
        for i, d in enumerate(t0.shards):
            row = []
            for j, (r0, r1) in enumerate(t0.rows):
                dev = self._dev(d, j)
                a = []
                for p, v in enumerate(args):
                    if isinstance(v, Tiles):
                        v = v.parts[i][j]
                    elif isinstance(v, Split):
                        v = v.parts[i]
                        if v.ndim == 4 and v.shape[2] == t0.h > 1:
                            v = v[:, :, r0:r1]
                        v = _place(v, dev)
                    elif (ri, p) in self._wargs:
                        v = self._on((ri, p), v, dev)
                    else:
                        v = _operand(v, p, spec, dev)
                    a.append(v)
                k = {**kw, "cache": self._dcache(ri, (d, j))} \
                    if spec.cached else kw
                row.append(spec.fn(*a, **k))
            outs.append(row)
        if isinstance(outs[0][0], tuple):
            return tuple(Tiles([[o[k] for o in r] for r in outs],
                               list(t0.shards), list(t0.rows), t0.h)
                         for k in range(len(outs[0][0])))
        return Tiles(outs, list(t0.shards), list(t0.rows), t0.h)

    # ----------------------------------------------------- window ops
    def _window(self, ri, layer, spec, args, kw):
        """Run an op with a window over H on its output rows' split, or
        None where it cannot (fewer output rows than shards, a window this
        does not map)."""
        x = args[0]
        plan = self._window_plan(layer, args, kw, x)
        if plan is None:
            return None
        h_out, need, local_kw = plan
        if h_out < self.n_model:
            return None
        rows = _row_ranges(h_out, self.n_model)
        spans = [need(o0, o1) for o0, o1 in rows]
        if any(hi <= lo for lo, hi, _ in spans):
            return None
        route = {}
        if layer.op == "conv":
            pieces = []
            for ts in x.parts:
                for (lo, hi, _), (o0, o1) in zip(spans, rows):
                    pieces.append((ts[0].shape[0], x.shape[1], o1 - o0,
                                   x.shape[3]))
            route = self._route(layer, args, kw, x.shape, pieces, False)
            if route is None:
                return None
        outs = []
        for i, d in enumerate(x.shards):
            row = []
            for j, ((lo, hi, extra), (o0, o1)) in enumerate(zip(spans, rows)):
                dev = self._dev(d, j)
                a = [self._take(x, i, lo, hi, dev)]
                for p, v in enumerate(args[1:], 1):
                    a.append(self._on((ri, p), v, dev)
                             if (ri, p) in self._wargs
                             else _operand(v, p, spec, dev))
                k = {**kw, **route, **local_kw(o0, o1, lo, hi, extra)}
                if spec.cached:
                    k["cache"] = self._dcache(ri, (d, j))
                y = spec.fn(*a, **k)
                if layer.op == "upsample":
                    y = y[:, :, extra:extra + (o1 - o0)]
                row.append(y)
            outs.append(row)
        return Tiles(outs, list(x.shards), rows, h_out)

    def _window_plan(self, layer, args, kw, x):
        """(logical output rows, output rows -> (input rows lo, hi, extra),
        the local kwargs of a shard), or None for a form not mapped."""
        op = layer.op
        h, w = x.shape[2], x.shape[3]
        if op == "conv":
            K = args[1]
            kh, kw_ = (int(v) for v in tuple(K.shape)[2:])
            strides = tuple(int(s) for s in (kw.get("strides") or (1, 1)))
            dil = tuple(int(d) for d in (kw.get("dilations") or (1, 1)))
            pads = kw.get("pads")
            if kw.get("auto_pad"):
                pads = resolve_conv_pads((h, w), (kh, kw_), strides, dil,
                                         pads, kw["auto_pad"])
            pt, pl, pb, pr = (0, 0, 0, 0) if pads is None else (
                int(p) for p in pads)
            sh, dh = strides[0], dil[0]
            ext = dh * (kh - 1) + 1
            h_out = (h + pt + pb - ext) // sh + 1

            def need(o0, o1):
                a, b = o0 * sh - pt, (o1 - 1) * sh - pt + ext
                return max(a, 0), min(b, h), (max(0, -a), max(0, b - h))

            def local(o0, o1, lo, hi, extra):
                return {"pads": (extra[0], pl, extra[1], pr),
                        "auto_pad": None}
            return h_out, need, local
        if op in ("maxpool", "averagepool"):
            win = kw.get("w") or (2, 2)
            strides = kw.get("strides") or (2, 2)
            (pt, pl, pb, pr), (eh, ew) = resolve_pool_pads(
                (h, w), win, strides, kw.get("pads"), kw.get("auto_pad"),
                kw.get("ceil_mode", 0))
            if op == "averagepool" and (eh, ew) != (0, 0):
                return None
            kh, sh = int(win[0]), int(strides[0])
            pb += eh
            h_out = (h + pt + pb - kh) // sh + 1

            def need(o0, o1):
                a, b = o0 * sh - pt, (o1 - 1) * sh - pt + kh
                return max(a, 0), min(b, h), (max(0, -a), max(0, b - h))

            def local(o0, o1, lo, hi, extra):
                return {"pads": (extra[0], pl, extra[1], pr + ew),
                        "auto_pad": None, "ceil_mode": 0}
            return h_out, need, local
        if op == "convtranspose":
            if int(kw.get("group", 1) or 1) != 1:
                return None
            kh = int(args[1].shape[2])
            strides = kw.get("strides") or (2, 2)
            dil = kw.get("dilations") or (1, 1)
            sh, dh = int(strides[0]), int(dil[0])
            pt, pl, pb, pr = (int(p) for p in (kw.get("pads") or (0,) * 4))
            oph, opw = (int(p) for p in (kw.get("output_padding") or (0, 0)))
            h_out = (h - 1) * sh - pt - pb + dh * (kh - 1) + 1 + oph

            def need(o0, o1):
                lo = max(0, -((dh * (kh - 1) - o0 - pt) // sh))
                hi = min(h, (o1 - 1 + pt) // sh + 1)
                return lo, hi, None

            def local(o0, o1, lo, hi, extra):
                r0 = lo * sh - pt
                end = r0 + (hi - lo - 1) * sh + dh * (kh - 1) + 1
                return {"pads": (o0 - r0, pl, end - o1, pr),
                        "output_padding": (0, opw)}
            return h_out, need, local
        if op == "upsample":
            k = _floats(args[1])
            if (kw.get("mode", "nearest") != "nearest" or len(k) != 4
                    or k[0] != 1.0 or k[2] != int(k[2]) or k[2] < 1):
                return None
            f = int(k[2])

            def need(o0, o1):
                lo = o0 // f
                return lo, (o1 - 1) // f + 1, o0 - lo * f

            return h * f, need, lambda *a: {}
        return None


def halo_exchange(shards: list, halo: int) -> list:
    """Each of a list of H shards (N, C, H_local, W), in order along one
    mesh axis, extended by ``halo`` edge rows of its neighbours: the
    previous shard's last rows above, the next shard's first rows below,
    zeros at the image's outer edges.  The counterpart of the JAX
    package's ``ppermute`` exchange inside a ``shard_map``, which has no
    PyTorch form: each shard's result stays on its device."""
    out = []
    for j, x in enumerate(shards):
        top = (torch.zeros_like(x[:, :, :halo]) if j == 0
               else shards[j - 1][:, :, -halo:].to(x.device))
        bot = (torch.zeros_like(x[:, :, -halo:]) if j == len(shards) - 1
               else shards[j + 1][:, :, :halo].to(x.device))
        out.append(torch.cat([top, x, bot], dim=2))
    return out


@float32_exact()
def spatial_conv(x, K, B, mesh: Mesh, axis: str = "model"):
    """An explicitly halo-exchanged 'same' conv (odd square kernel) on an
    input split over H on ``axis``: split x, exchange halos, run a conv
    valid in H with pads (0, halo, 0, halo) per shard, on the shard's
    device, and join the result on x's device.  A float32 conv runs in
    float32, not TF32, as in a program."""
    devs = _grid(mesh, None, axis)[0]
    halo = int(K.shape[2]) // 2
    shards = [_place(p, d)
              for p, d in zip(torch.tensor_split(x, len(devs), dim=2), devs)]
    outs = [tops.conv2d(xh, _place(K, xh.device), _place(B, xh.device),
                        pads=(0, halo, 0, halo))
            for xh in halo_exchange(shards, halo)]
    return torch.cat([_place(o, x.device) for o in outs], dim=2)
