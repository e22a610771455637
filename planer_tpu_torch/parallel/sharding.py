"""Multi-device execution: mesh construction and DP x TP sharding plans —
the port's counterpart of ``planer_tpu/parallel/sharding.py``.

The JAX package annotates its jitted program with ``NamedSharding``s and
lets GSPMD partition it.  PyTorch has no partitioner, so the port keeps
the same plans and runs them explicitly, from one controller process:

  * a mesh is a numpy object array of ``torch.device``s with axis names
    (``data`` x ``model``); entries may repeat, so one card (``cuda:0`` x
    8) or the CPU runs a (2, 4) mesh through the same code as four cards;
  * ``param_shardings`` maps each params leaf to a ``NamedSharding`` by the
    op that consumes it, line by line as the JAX package does (output
    channels on ``model``);
  * ``shard_program`` installs a ``ShardedProgram``: each graph input's
    batch is split over ``data``; an op whose weight is sharded on
    ``model`` runs once per model shard, on that shard's device and slice
    of the weights, and its output-channel pieces are all-gathered by
    ``torch.cat``; every other op that keeps the batch on its leading axis
    runs once per data shard; an op that does not (a reduction or reshape
    over the batch, a per-tensor dynamic activation scale) runs on the
    gathered batch, and its result stays whole.  The outputs' batch pieces
    are concatenated.

Every shape gate is taken at the logical (unsharded) shape, as the JAX
program traces it: a conv's route and a quantized GEMM's branch are forced
from the whole op's shape (``torch_ops.conv_route``), and the convs inside
a fused stage's decomposed chain read the logical batch
(``torch_ops.logical_batch``).  A GEMM whose logical shape takes
``dense_q``'s kernel branch is split only where every piece is a kernel
shape, else it runs on the gathered batch.  The fused stages run their
decomposed chains (``FUSED_OVERRIDES``), per data shard and with their
whole weights: a chain of convs cannot be split on its first conv's output
channels without a gather after each conv.

A program whose mesh repeats one card (``cuda:0`` x 8) captures its step
as one CUDA graph per signature, as an unsharded program does: every
shard's kernels, the gathers and the outputs' gather onto the first
device.  Weights, their slices and the per-shard caches are placed on the
warm run; one first needed inside a capture raises.  A mesh of distinct
cards runs its entries uncaptured.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ir import Graph
from ..ops import torch_ops as tops
from ..ops.kernels import gemm as _gemm
from ..ops.qtypes import QTensor
from ..runtime.program import Program

__all__ = ["make_mesh", "param_shardings", "input_sharding", "shard_program"]

# fused ops that must run their decomposed op chain under a mesh (the JAX
# package: pallas_call cannot be auto-partitioned); the program injects
# this kwarg per application (Program.op_overrides)
FUSED_OPS = ("stage64", "stagen")
FUSED_OVERRIDES = {op: {"force_decomposed": True} for op in FUSED_OPS}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one mesh axis name (or
    None, replicated) per dimension of a value."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A device mesh: ``devices``, a numpy object array of
    ``torch.device``s with one array axis per name in ``axis_names``.
    ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes named "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A value's layout over a mesh: ``spec`` names the mesh axis each of
    its dimensions is split over."""

    mesh: Mesh
    spec: PartitionSpec


def make_mesh(shape=None, axis_names=("data", "model"), devices=None) -> Mesh:
    """Build a device mesh.  ``devices`` defaults to every CUDA device;
    entries may repeat (``["cpu"] * 8``, ``["cuda:0"] * 8``).
    ``shape=None`` puts all devices on ``data``."""
    if devices is None:
        resolve_device("cuda")              # raises where there is no card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert int(np.prod(shape)) == n, f"mesh {shape} != {n} devices"
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


def _spec_for(name: str, leaf, op: str, pos: int, tp_axis: str) -> P:
    """Output-channel TP spec for one weight leaf."""
    shape = leaf.shape
    nd = len(shape)
    none = (None,) * nd

    def axis_spec(axis):
        s = [None] * nd
        s[axis] = tp_axis
        return P(*s)

    if op == "conv":
        if pos == 1 and nd == 4:        # OIHW kernel
            return axis_spec(0)
        if pos == 2 and nd == 1:        # bias (O,)
            return axis_spec(0)
    elif op == "convtranspose":
        if pos == 1 and nd == 4:        # (I, O/g, kh, kw)
            return axis_spec(1)
        if pos == 2 and nd == 1:
            return axis_spec(0)
    elif op == "dense":
        if pos == 1 and nd == 2:        # (O, I)
            return axis_spec(0)
        if pos == 2 and nd == 1:
            return axis_spec(0)
    elif op == "batchnorm":
        # folded affine (1, C, 1, 1): channel axis follows conv output
        if nd == 4 and shape[0] == 1:
            return axis_spec(1)
    elif op in FUSED_OPS:
        # fused-stage operands: [x, Ws, Bs, (W1, B1, W2, B2) x blocks] —
        # every weight is an OIHW conv kernel (shard axis 0) and every bias
        # a (O,)/(1,O,1,1)-shaped vector following the conv's output channels
        if pos >= 1:
            if nd == 4 and shape[0] > 1:
                return axis_spec(0)
            if nd == 4 and shape[0] == 1:
                return axis_spec(1)
            if nd == 1:
                return axis_spec(0)
    return P(*none)


def param_shardings(graph: Graph, params: dict, mesh: Mesh,
                    tp_axis: str = "model"):
    """``NamedSharding`` per params leaf of a Program (a QTensor of two
    for a quantized leaf: the payload's and the scale's)."""
    consumers = {n: u[0] for n, u in graph.weight_users().items()}

    def leaf_sharding(name, leaf):
        op, pos = consumers.get(name, (None, -1))
        spec = _spec_for(name, leaf, op, pos, tp_axis)
        # sharded dim must divide the axis size; fall back to replication
        for ax, s in enumerate(spec):
            if s is not None and leaf.shape[ax] % mesh.shape[tp_axis]:
                spec = P(*((None,) * len(leaf.shape)))
                break
        return NamedSharding(mesh, spec)

    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, QTensor):
            qs = leaf_sharding(name, leaf.q)
            # scales follow the quantized payload's spec on shared dims
            sspec = [None] * leaf.scale.ndim
            for ax in range(min(leaf.scale.ndim, leaf.q.ndim)):
                if (qs.spec[ax] is not None
                        and leaf.scale.shape[ax] == leaf.q.shape[ax]):
                    sspec[ax] = qs.spec[ax]
            out[name] = QTensor(qs, NamedSharding(mesh, P(*sspec)),
                                act_dynamic=leaf.act_dynamic,
                                act_scale=leaf.act_scale)
        else:
            out[name] = leaf_sharding(name, leaf)
    return out


def input_sharding(mesh: Mesh, batch_axis: str = "data"):
    """Batch-dim DP sharding (leading axis; trailing dims replicated)."""
    return NamedSharding(mesh, P(batch_axis))


def shard_program(net, mesh: Mesh, tp_axis: str = "model",
                  batch_axis: str = "data"):
    """Install a ``ShardedProgram`` of the Net on ``mesh`` (weights split
    over ``tp_axis`` by ``param_shardings``, the batch over
    ``batch_axis``) and return it; ``net.forward`` runs it."""
    prog = _build(net, ShardedProgram, mesh=mesh, tp_axis=tp_axis,
                  batch_axis=batch_axis)
    prog.op_overrides.update(FUSED_OVERRIDES)
    prog._cache.clear()          # compiled under other overrides
    net._program = prog
    return prog


def _build(net, cls, **kw):
    """The Net's program as a ``cls`` on the mesh's first device."""
    home = kw["mesh"].devices.flat[0]
    if net.graph.quant:
        from ..quant import make_quant_program
        return make_quant_program(net.graph, net.weights,
                                  compute_dtype=net.compute_dtype,
                                  device=home, cls=cls, **kw)
    return cls(net.graph, net.weights, compute_dtype=net.compute_dtype,
               device=home, **kw)


# --------------------------------------------------------------------------
# explicit execution
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Split:
    """A value split on its leading (batch) axis over the data shards:
    ``parts[i]`` is data shard ``shards[i]``'s piece, on that shard's
    device.  (A data shard left without rows holds no part.)"""

    parts: list
    shards: list

    @property
    def batch(self) -> int:
        return sum(int(p.shape[0]) for p in self.parts)

    @property
    def shape(self) -> tuple:
        return (self.batch,) + tuple(self.parts[0].shape[1:])

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def dtype(self):
        return self.parts[0].dtype


# ops that keep the batch on the leading axis of their first operand, whose
# other operands are parameters (weights, scales, slopes)
_LEAD_OPS = {
    "conv", "convtranspose", "dense", "batchnorm", "instancenormalization",
    "prelu", "maxpool", "averagepool", "gap", "gmp", "stage64", "stagen",
    "relu", "leakyrelu", "sigmoid", "hardsigmoid", "tanh", "erf", "sqrt",
    "exp", "log", "reciprocal", "abs", "neg", "floor", "ceil", "round",
    "sign", "elu", "softplus", "gelu", "identity", "cast", "spacetodepth",
    "depthtospace", "clip"}
# elementwise ops over broadcast operands
_NARY_OPS = {"add", "sub", "mul", "div", "pow", "equal", "greater",
             "greaterorequal", "where", "min", "max", "mean", "sum"}
# ops with an axis: batch-local where the axis is not the batch's
_AXIS_OPS = {"softmax": ("axis", -1), "logsoftmax": ("axis", -1),
             "argmax": ("axis", 0), "argmin": ("axis", 0),
             "split": ("axis", 0), "gather": ("axis", 0)}
_REDUCE_OPS = {"reducesum", "reducemean", "reducemax", "reducemin",
               "reduceprod"}
# opcode -> (output-channel axis of the result, whether the input's
# channels are sliced with the weights): the ops a model-sharded weight
# splits
_TP_OPS = {"conv": (1, False), "convtranspose": (1, False),
           "dense": (-1, False), "batchnorm": (1, True)}


def _param(layer_kw, args, name, pos, default=None):
    """An op parameter given as a kwarg or as a static positional operand."""
    if name in layer_kw and layer_kw[name] is not None:
        return layer_kw[name]
    if pos < len(args) and args[pos] is not None \
            and not isinstance(args[pos], Split):
        return args[pos]
    return default


def _ints(v) -> list[int]:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).astype(np.int64).reshape(-1).tolist()


def _floats(v) -> list[float]:
    if isinstance(v, torch.Tensor):
        v = v.cpu().double().numpy()
    return np.asarray(v, dtype=np.float64).reshape(-1).tolist()


def _slice(leaf, axis: int, i: int, n: int):
    """Piece ``i`` of ``n`` of a weight along ``axis`` (a QTensor's scale
    along the same axis where it has the payload's extent)."""
    if isinstance(leaf, QTensor):
        q = _slice(leaf.q, axis, i, n)
        sc = leaf.scale
        if sc.ndim > axis and sc.shape[axis] == leaf.q.shape[axis]:
            sc = _slice(sc, axis, i, n)
        return QTensor(q, sc, act_dynamic=leaf.act_dynamic,
                       act_scale=leaf.act_scale)
    step = leaf.shape[axis] // n
    return leaf.narrow(axis, i * step, step)


def _place(v, dev):
    if isinstance(v, QTensor):
        return QTensor(_place(v.q, dev), _place(v.scale, dev),
                       act_dynamic=v.act_dynamic, act_scale=v.act_scale)
    if isinstance(v, torch.Tensor) and v.device != dev:
        return v.to(dev)
    return v


def _operand(v, p, spec, dev):
    """Operand ``p`` of an op on ``dev``; a host operand (``spec.host_args``,
    handed over on the host by the program) stays on the host."""
    if p in spec.host_args and isinstance(v, torch.Tensor) \
            and v.device.type == "cpu":
        return v
    return _place(v, dev)


def _grid(mesh: Mesh, row_axis, col_axis) -> np.ndarray:
    """The mesh as a (rows, columns) array of devices: ``row_axis`` down,
    ``col_axis`` across (an absent or None axis has size 1), the first
    device along any other axis."""
    names = list(mesh.axis_names)
    arr = mesh.devices[tuple(slice(None) if n in (row_axis, col_axis)
                             else 0 for n in names)]
    kept = [n for n in names if n in (row_axis, col_axis)]
    if row_axis not in kept:
        arr, kept = arr[None], [row_axis] + kept
    if col_axis not in kept:
        arr, kept = arr[..., None], kept + [col_axis]
    return arr if kept[0] == row_axis else arr.T


class ShardedProgram(Program):
    """A Program run over a (data x model) mesh from one process: the batch
    split over ``batch_axis``, model-sharded weights split over
    ``tp_axis`` (see the module docstring).  The float32 executor
    (``_executor``, the host tail, ``cost_analysis``) is the base
    program's, on the mesh's first device.  Its entries fold their statics
    per signature like the base program's; see ``_captures`` for when they
    run as CUDA graphs."""

    def __init__(self, graph, weights, *, mesh: Mesh, tp_axis="model",
                 batch_axis="data", col_axis=None, **kw):
        super().__init__(graph, weights, **kw)
        self.mesh = mesh
        self.tp_axis, self.batch_axis = tp_axis, batch_axis
        # (data shard, model shard) -> device
        self.grid = _grid(mesh, batch_axis, col_axis or tp_axis)
        self.n_data, self.n_model = self.grid.shape
        self.shardings = param_shardings(graph, self.params, mesh, tp_axis)
        self._placed: dict = {}
        self._dcaches: dict = {}
        # records whose weight is split over the model axis:
        # ri -> {position: weight axis}
        self._tp: dict[int, dict[int, int]] = {}
        if tp_axis is not None and self.n_model > 1:
            self._plan_tp()

    # ------------------------------------------------------------ planning
    def _plan_tp(self):
        graph = self.graph
        for ri, rec in enumerate(self.plan.records):
            if rec.kind != "dyn":
                continue
            edge = graph.flow[rec.edge]
            layer = self._layers[edge.layers[rec.li]]
            if layer.op not in _TP_OPS:
                continue
            if layer.op in ("conv", "convtranspose") \
                    and int(layer.kwargs.get("group", 1) or 1) != 1:
                continue
            src = edge.src if rec.li == 0 else edge.dst
            axes = {}
            for p, s in enumerate(src):
                if (ri, p) not in self._wargs or s not in self.shardings:
                    continue
                sh = self.shardings[s]
                spec = (sh.q if isinstance(sh, QTensor) else sh).spec
                if self.tp_axis in spec:
                    axes[p] = spec.index(self.tp_axis)
            if 1 in axes:
                self._tp[ri] = axes

    def _captures(self) -> bool:
        """On the card, where every device of the grid is the program's
        own (a mesh of one card repeated): one CUDA graph holds the step.
        Over distinct cards the entries run uncaptured."""
        return self.device.type == "cuda" and all(
            d == self.device for d in self.grid.flat)

    # ---------------------------------------------------------- placement
    def _dev(self, d: int, m: int = 0) -> torch.device:
        return self.grid[d, m]

    def _first_use(self, what):
        """Refuse to make ``what`` inside a CUDA graph capture: the capture
        would record its copies once and the warm run makes everything a
        step uses."""
        if tops._capturing(self.device):
            raise RuntimeError(f"{what} first needed inside a CUDA graph "
                               f"capture; the warm run places it")

    def _kept(self, key, make):
        """``make()`` (a weight or a slice of one on a device), made once
        and kept under ``key``."""
        v = self._placed.get(key)
        if v is None:
            self._first_use(f"weight {key}")
            v = self._placed[key] = make()
        return v

    def _on(self, key, leaf, dev):
        """``leaf`` on ``dev``, moved once and kept."""
        return self._kept((key, dev), lambda: _place(leaf, dev))

    def _dcache(self, ri, d):
        c = self._dcaches.get((ri, d))
        if c is None:
            self._first_use(f"the cache of application {ri} on shard {d}")
            c = self._dcaches[(ri, d)] = {}
        return c

    # ------------------------------------------------------ program steps
    def _bind_input(self, x):
        if self.n_data == 1 or x.ndim == 0:
            return x
        pieces = torch.tensor_split(x, self.n_data, dim=0)
        parts, shards = [], []
        for d, p in enumerate(pieces):
            if p.shape[0]:
                parts.append(_place(p, self._dev(d)))
                shards.append(d)
        return Split(parts, shards)

    def _whole(self, v):
        """A value gathered onto the mesh's first device."""
        if isinstance(v, Split):
            return torch.cat([_place(p, self.device) for p in v.parts], 0)
        if isinstance(v, tuple):
            return tuple(self._whole(t) for t in v)
        return v

    def _finish(self, env, senv):
        env = {n: self._whole(v) for n, v in env.items()}
        return super()._finish(env, senv)

    # ---------------------------------------------------------- dispatch
    def _apply(self, ri, rec, layer, spec, args, kw):
        splits = [a for a in args if isinstance(a, Split)]
        if splits and self._batch_local(layer, args, kw):
            ref, x = splits[0], args[0]
            pieces = ([tuple(p.shape) for p in x.parts]
                      if isinstance(x, Split) else [])
            route, tp = self._plan(ri, layer, args, kw, x.shape, pieces)
            if route is not None:
                outs = [self._run_shard(ri, layer, spec, args, kw, i, d,
                                        ref.batch, route, tp)
                        for i, d in enumerate(ref.shards)]
                if isinstance(outs[0], tuple):
                    return tuple(Split([o[k] for o in outs], list(ref.shards))
                                 for k in range(len(outs[0])))
                return Split(outs, list(ref.shards))
        args = [self._whole(a) for a in args]
        shape = tuple(getattr(args[0], "shape", ()))
        route, tp = self._plan(ri, layer, args, kw, shape, [shape])
        return self._run_shard(ri, layer, spec, args, kw, None, 0, None,
                               route, tp)

    def _plan(self, ri, layer, args, kw, shape, pieces):
        """(route kwargs, split over the model axis) of an application on
        these input pieces: TP where the record has it, unless a piece of
        the split would leave the logical GEMM's kernel branch (then
        without TP; route None where the batch split alone does)."""
        tp = ri in self._tp
        route = self._route(layer, args, kw, shape, pieces, tp)
        if route is None and tp:
            tp = False
            route = self._route(layer, args, kw, shape, pieces, tp)
        return route, tp

    def _batch_local(self, layer, args, kw) -> bool:
        """Whether the op maps each batch row to its own output row, so it
        can run once per data shard on the shards' pieces."""
        op = layer.op
        splits = [a for a in args if isinstance(a, Split)]
        sizes = {tuple(p.shape[0] for p in s.parts) for s in splits}
        if len(sizes) != 1 or len({tuple(s.shards) for s in splits}) != 1:
            return False
        x = args[0]
        if op == "concat":
            return (all(isinstance(a, Split) for a in args)
                    and int(kw.get("axis", 0)) % x.ndim != 0)
        if op in _LEAD_OPS or op in _TP_OPS:
            if not isinstance(x, Split) or len(splits) != 1:
                return False
            if op == "conv":
                K = args[1] if len(args) > 1 else None
                # a per-tensor activation scale found at run time is a
                # reduction over the whole batch
                if (isinstance(K, QTensor) and K.act_scale is None
                        and K.act_dynamic):
                    return False
            return True
        if op in _NARY_OPS or op == "return":
            nd = max(a.ndim for a in args if hasattr(a, "ndim"))
            for a in args:
                if isinstance(a, Split) or a is None:
                    continue
                if not hasattr(a, "shape"):
                    continue
                if op == "return" or (a.ndim == nd and a.shape[0] != 1):
                    return False
            return True
        if not isinstance(x, Split) or len(splits) != 1:
            return False
        nd = x.ndim
        if op in _AXIS_OPS:
            name, default = _AXIS_OPS[op]
            return int(kw.get(name, default)) % nd != 0
        if op in _REDUCE_OPS:
            axes = _param(kw, args, "axes", 1)
            return axes is not None and 0 not in {a % nd for a in _ints(axes)}
        if op == "flatten":
            return int(kw.get("axis", 1)) >= 1
        if op == "reshape":
            shp = _ints(args[1])
            rest = list(shp[1:])
            for i, v in enumerate(rest):
                if v == 0:
                    rest[i] = x.shape[i + 1]
            have = int(np.prod(x.shape[1:], dtype=np.int64))
            if -1 in rest:
                return shp[0] in (0, x.shape[0])
            return shp[0] in (0, -1, x.shape[0]) \
                and int(np.prod(rest, dtype=np.int64)) == have
        if op == "transpose":
            axis = kw.get("axis")
            return axis is not None and _ints(axis)[0] == 0
        if op == "unsqueeze":
            axes = _param(kw, args, "axes", 1)
            out_nd = nd + len(_ints(axes))
            return 0 not in {a % out_nd for a in _ints(axes)}
        if op == "squeeze":
            axes = _param(kw, args, "axes", 1)
            return axes is not None and 0 not in {a % nd
                                                  for a in _ints(axes)}
        if op == "pad":
            p = _ints(args[1])
            return p[0] == 0 and p[len(p) // 2] == 0
        if op == "slice":
            axes = args[3] if len(args) > 3 and args[3] is not None \
                else range(len(_ints(args[1])))
            return 0 not in {a % nd for a in _ints(axes)}
        if op == "matmul":
            y = args[1]
            return nd >= 2 and getattr(y, "ndim", 3) <= 2
        if op == "upsample":
            k = _floats(args[1])
            return len(k) == nd and k[0] == 1.0
        return False

    # ------------------------------------------------------------ routes
    def _route(self, layer, args, kw, shape, pieces, tp):
        """The route kwargs of a conv or a quantized dense on an input of
        logical ``shape`` (``{"route": ...}``, ``{"branch": ...}``; empty
        for other ops), or None where one of the input's ``pieces`` (their
        shapes; the output channels split over the model axis where ``tp``)
        would not be a kernel shape of the logical kernel branch."""
        op = layer.op
        K = args[1] if len(args) > 1 else None
        if op not in ("conv", "dense") or not isinstance(K, QTensor):
            return {}
        x = args[0]
        n_model = self.n_model if tp else 1
        if op == "dense":
            N, Kd = K.q.shape
            rows = int(np.prod(shape[:-1], dtype=np.int64))
            if _gemm.tile_plan(rows, N, Kd) is None:
                return {"branch": "fallback"}
            if any(_gemm.tile_plan(int(np.prod(p[:-1], dtype=np.int64)),
                                   N // n_model, Kd) is None
                   for p in pieces):
                return None
            return {"branch": "kernel"}
        route = tops.conv_route(shape, x.dtype, K, kw.get("group"),
                                kw.get("strides"), kw.get("dilations"),
                                kw.get("pads"), kw.get("auto_pad"))
        if route == "gemm":
            o, c = K.q.shape[:2]
            if any(_gemm.tile_plan(p[0] * int(np.prod(p[2:], dtype=np.int64)),
                                   o // n_model, c) is None
                   for p in pieces):
                return None
        return {"route": route}

    # --------------------------------------------------------------- run
    def _run_shard(self, ri, layer, spec, args, kw, i, d, batch, route,
                   tp):
        """The op on data shard ``d``'s operands (piece ``i`` of each Split;
        ``i`` None: the whole values), split over the model axis where
        ``tp``.  ``batch`` is the logical batch (None: the operands')."""
        dev = self._dev(d)
        kw = {**kw, **route} if route else kw
        axes = self._tp[ri] if tp else {}
        n_model = self.n_model if tp else 1
        outs = []
        for m in range(n_model):
            mdev = self._dev(d, m)
            a = []
            for p, v in enumerate(args):
                if isinstance(v, Split):
                    v = v.parts[i]
                if p in axes:
                    v = self._kept(((ri, p, m), mdev), lambda: _place(
                        _slice(v, axes[p], m, n_model), mdev))
                elif (ri, p) in self._wargs:
                    v = self._on((ri, p), v, mdev)
                else:
                    v = _operand(v, p, spec, mdev)
                a.append(v)
            if tp and _TP_OPS[layer.op][1]:
                a[0] = _slice(a[0], 1, m, n_model)
            k = kw
            if spec.cached:
                k = {**kw, "cache": self._dcache(ri, (d, m))}
            if batch is not None:
                with tops.logical_batch(batch):
                    out = spec.fn(*a, **k)
            else:
                out = spec.fn(*a, **k)
            outs.append(out)
        if n_model == 1:
            return outs[0]
        axis = _TP_OPS[layer.op][0]
        return torch.cat([_place(o, dev) for o in outs], dim=axis)
