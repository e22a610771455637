"""ONNX graph -> flow IR lowering: the port's copy of
``planer_tpu/frontend/onnx_convert.py``, which gives the same graph JSON
and the same weight blob for the same model.

The lowering covers the original planer converter's op types and more:
BatchNormalization pre-folded into per-channel affine (K, B) inits with
the node's own ``epsilon``, Constant nodes folded into the weight table,
Gemm lowered to ``dense`` with the weight stored transposed, a synthetic
``return`` node appended, and all weights serialized as one contiguous
uint8 blob.  Opset-13 attribute-to-input migrations (Squeeze/Unsqueeze
axes, Split, Clip min/max, Pad pads) flow through as positional inputs;
``auto_pad`` and pool ``ceil_mode`` are kept as kwargs the ops resolve
from the input shape; Dropout is lowered to identity; an unknown op_type
raises.
"""
from __future__ import annotations

import numpy as np

from ..ir import Graph, Layer, FlowEdge, pack_weights
from . import onnx_proto as op

__all__ = ["convert_onnx", "convert_model"]


def _attrs(node: op.NodeProto) -> dict:
    out = {}
    for a in node.attribute:
        if a.type == op.ATTR.INT:
            out[a.name] = a.i
        elif a.type == op.ATTR.FLOAT:
            out[a.name] = a.f
        elif a.type == op.ATTR.STRING:
            out[a.name] = a.s.decode()
        elif a.type == op.ATTR.INTS:
            out[a.name] = list(a.ints)
        elif a.type == op.ATTR.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == op.ATTR.TENSOR:
            out[a.name] = op.to_array(a.t)
    return out


def _take(a: dict, *names, **renames):
    kw = {}
    for n in names:
        if n in a:
            kw[n] = a[n]
    for onnx_name, ir_name in renames.items():
        if onnx_name in a:
            kw[ir_name] = a[onnx_name]
    return kw


# op_type -> (ir opcode, kwargs builder)
def _simple(opcode):
    return lambda a: (opcode, {})


def _check_rnn(a: dict, kw: dict) -> dict:
    """Reject RNN attributes whose silent omission would change numerics."""
    if "activations" in a:
        acts = [x.decode() if isinstance(x, bytes) else x
                for x in a["activations"]]
        defaults = {"Sigmoid", "Tanh"}
        if any(str(x) not in defaults for x in acts):
            raise NotImplementedError(
                f"RNN with non-default activations {acts} not supported")
    if a.get("clip"):
        raise NotImplementedError("RNN cell clipping not supported")
    return kw


def _autopad_kw(a: dict, pool: bool = False) -> dict:
    """Lower auto_pad/ceil_mode into IR kwargs (pads resolve from the input
    shape when the op runs)."""
    kw = {}
    ap = a.get("auto_pad", "NOTSET")
    if isinstance(ap, bytes):
        ap = ap.decode()
    if ap == "VALID":
        kw["pads"] = [0, 0, 0, 0]
    elif ap in ("SAME_UPPER", "SAME_LOWER"):
        kw["auto_pad"] = ap
    elif ap not in ("", "NOTSET"):
        raise NotImplementedError(f"unknown auto_pad {ap!r}")
    else:
        kw["pads"] = a.get("pads")
    if pool:
        if a.get("ceil_mode", 0):
            kw["ceil_mode"] = 1
        if a.get("storage_order", 0):
            raise NotImplementedError("MaxPool storage_order=1 not supported")
        d = a.get("dilations")
        if d is not None and any(int(v) != 1 for v in d):
            raise NotImplementedError("pool dilations != 1 not supported")
    return kw


_LOWER = {
    "Conv": lambda a: ("conv", {
        "group": a.get("group", 1) or 1,
        "strides": a.get("strides"), "dilations": a.get("dilations"),
        **_autopad_kw(a)}),
    "ConvTranspose": lambda a: ("convtranspose", _take(
        a, "strides", "dilations", "pads", "output_padding", "group")),
    "MatMul": _simple("matmul"),
    "MaxPool": lambda a: ("maxpool", {
        "w": a.get("kernel_shape"), "strides": a.get("strides"),
        **_autopad_kw(a, pool=True)}),
    "AveragePool": lambda a: ("averagepool", {
        "w": a.get("kernel_shape"), "strides": a.get("strides"),
        # ONNX default EXCLUDES padding from the divisor (the op's own
        # default of 1 is the original planer's)
        "count_include_pad": a.get("count_include_pad", 0),
        **_autopad_kw(a, pool=True)}),
    "GlobalAveragePool": _simple("gap"),
    "Upsample": lambda a: ("upsample", _take(a, "mode")),
    "Resize": lambda a: ("resize", _take(
        a, "mode", "nearest_mode", "coordinate_transformation_mode")),
    "Flatten": lambda a: ("flatten", _take(a, "axis")),
    "Unsqueeze": lambda a: ("unsqueeze", _take(a, "axes")),
    "Squeeze": lambda a: ("squeeze", _take(a, "axes")),
    "Relu": _simple("relu"),
    "LeakyRelu": lambda a: ("leakyrelu", {"alpha": a.get("alpha", 0.01)}),
    "HardSigmoid": lambda a: ("hardsigmoid", _take(a, "alpha", "beta")),
    "Sigmoid": _simple("sigmoid"),
    "Softmax": lambda a: ("softmax", _take(a, "axis")),
    "LogSoftmax": lambda a: ("logsoftmax", _take(a, "axis")),
    "Add": _simple("add"), "Sub": _simple("sub"), "Mul": _simple("mul"),
    "Div": _simple("div"), "Pow": _simple("pow"), "Sqrt": _simple("sqrt"),
    "Exp": _simple("exp"), "Log": _simple("log"), "Tanh": _simple("tanh"),
    "Erf": _simple("erf"), "Reciprocal": _simple("reciprocal"),
    "Identity": _simple("identity"), "Dropout": _simple("identity"),
    "Tile": _simple("tile"),
    "ReduceSum": lambda a: ("reducesum", _take(a, "axes", "keepdims")),
    "ReduceMean": lambda a: ("reducemean", _take(a, "axes", "keepdims")),
    "ReduceMax": lambda a: ("reducemax", _take(a, "axes", "keepdims")),
    "ReduceMin": lambda a: ("reducemin", _take(a, "axes", "keepdims")),
    "Concat": lambda a: ("concat", _take(a, "axis")),
    "Pad": lambda a: ("pad", _take(a, "mode", constant_value="constant_value")),
    "LSTM": lambda a: ("lstm", _check_rnn(a, _take(a, "hidden_size",
                                                   "direction"))),
    "GRU": lambda a: ("gru", _check_rnn(a, _take(
        a, "hidden_size", "direction", "linear_before_reset"))),
    "Shape": _simple("shape"),
    "Gather": lambda a: ("gather", _take(a, "axis")),
    "Reshape": _simple("reshape"),
    "Transpose": lambda a: ("transpose", {"axis": a.get("perm")}),
    "ConstantOfShape": lambda a: ("constantofshape", {}),  # value below
    "Greater": _simple("greater"),
    "GreaterOrEqual": _simple("greaterorequal"),
    "Equal": _simple("equal"),
    "NonZero": _simple("nonzero"),
    "TopK": lambda a: ("topk", _take(a, "axis", "largest", "sorted")),
    "Split": lambda a: ("split", _take(a, "axis", "split")),
    "Slice": lambda a: ("slice", {}),
    "Expand": _simple("expand"),
    "Cast": lambda a: ("cast", {"dtype": op.DTYPES.get(a.get("to", 1))}),
    "Range": _simple("range"),
    "Where": _simple("where"),
    "ScatterND": _simple("scatternd"),
    "InstanceNormalization": lambda a: (
        "instancenormalization", _take(a, "epsilon")),
    "Clip": lambda a: ("clip", _take(a, "min", "max")),
    # extended set
    "Abs": _simple("abs"), "Neg": _simple("neg"),
    "Min": _simple("min"), "Max": _simple("max"),
    "Floor": _simple("floor"), "Ceil": _simple("ceil"),
    "Round": _simple("round"), "Sign": _simple("sign"),
    "PRelu": _simple("prelu"),
    "Elu": lambda a: ("elu", _take(a, "alpha")),
    "Softplus": _simple("softplus"),
    "Gelu": lambda a: ("gelu", _take(a, "approximate")),
    "ArgMax": lambda a: ("argmax", _take(a, "axis", "keepdims",
                                         "select_last_index")),
    "ArgMin": lambda a: ("argmin", _take(a, "axis", "keepdims",
                                         "select_last_index")),
    "ReduceProd": lambda a: ("reduceprod", _take(a, "axes", "keepdims")),
    "GlobalMaxPool": _simple("gmp"),
    "SpaceToDepth": lambda a: ("spacetodepth", _take(a, "blocksize")),
    "DepthToSpace": lambda a: ("depthtospace", _take(a, "blocksize", "mode")),
    "Mean": _simple("mean"), "Sum": _simple("sum"),
}


def convert_model(model: op.ModelProto) -> tuple[Graph, np.ndarray]:
    g = model.graph
    init_names = {t.name for t in g.initializer}
    inputs = [vi.name for vi in g.input if vi.name not in init_names]

    inits: list[tuple[str, tuple, str]] = []
    weights: list[np.ndarray] = []
    windex: dict[str, int] = {}

    def add_init(name: str, arr: np.ndarray):
        arr = np.asarray(arr)
        inits.append((name, tuple(arr.shape), str(arr.dtype)))
        windex[name] = len(weights)
        weights.append(arr if arr.ndim else arr.reshape(1))

    for t in g.initializer:
        add_init(t.name, op.to_array(t))

    layers: list[Layer] = []
    flow: list[FlowEdge] = []
    used_names: set[str] = set()

    def unique(name: str, op_type: str) -> str:
        base = name or op_type.lower()
        n, i = base, 1
        while n in used_names:
            n = f"{base}_{i}"
            i += 1
        used_names.add(n)
        return n

    for node in g.node:
        a = _attrs(node)
        nname = unique(node.name, node.op_type)
        ins = [i if i else "None" for i in node.input]
        outs = list(node.output)

        if node.op_type == "Constant":
            val = a.get("value")
            if val is None:
                for k in ("value_float", "value_int"):
                    if k in a:
                        val = np.asarray(a[k])
            add_init(outs[0], np.asarray(val))
            continue

        if node.op_type == "BatchNormalization":
            # pre-fold into affine: K = s/sqrt(var+eps), B = b - s*m/sqrt(var+eps)
            eps = a.get("epsilon", 1e-5)
            s, b_, m, v = (weights[windex[ins[j]]] for j in (1, 2, 3, 4))
            inv = 1.0 / np.sqrt(v + eps)
            K = (s * inv).reshape(1, -1, 1, 1).astype(np.float32)
            B = (b_ - s * m * inv).reshape(1, -1, 1, 1).astype(np.float32)
            kname, bname = ins[1] + "_foldK", ins[1] + "_foldB"
            add_init(kname, K)
            add_init(bname, B)
            layers.append(Layer(nname, "batchnorm", {}))
            flow.append(FlowEdge([ins[0], kname, bname], [nname],
                                 [outs[0]], False, len(outs) == 1))
            continue

        if node.op_type == "Gemm":
            alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
            transB = a.get("transB", 0)
            if a.get("transA", 0):
                raise NotImplementedError("Gemm transA=1 not supported")
            if ins[1] in windex:
                # derive a NEW init rather than mutating in place: the same
                # initializer may feed several Gemm nodes (weight tying)
                if not transB or alpha != 1.0:
                    W = weights[windex[ins[1]]]
                    Wt = W if transB else np.ascontiguousarray(W.T)
                    if alpha != 1.0:
                        Wt = (Wt * alpha).astype(W.dtype)
                    dname = f"{ins[1]}~gemm{'' if transB else 'T'}" \
                            + (f"a{alpha}" if alpha != 1.0 else "")
                    if dname not in windex:
                        add_init(dname, Wt)
                    ins[1] = dname
                if beta != 1.0 and len(ins) > 2:
                    if ins[2] not in windex:
                        raise NotImplementedError(
                            "Gemm with beta != 1 and a non-initializer bias")
                    Bv = weights[windex[ins[2]]]
                    dname = f"{ins[2]}~gemmb{beta}"
                    if dname not in windex:
                        add_init(dname, (Bv * beta).astype(Bv.dtype))
                    ins[2] = dname
            else:
                if not transB or alpha != 1.0:
                    raise NotImplementedError(
                        "Gemm with non-initializer transposed weight")
                if beta != 1.0 and len(ins) > 2:
                    raise NotImplementedError(
                        "Gemm with beta != 1 and a non-initializer weight")
            shp = list(weights[windex[ins[1]]].shape[::-1]) \
                if ins[1] in windex else None
            layers.append(Layer(nname, "dense", {"shp": shp}))
            flow.append(FlowEdge(ins, [nname], outs, False, len(outs) == 1))
            continue

        if node.op_type == "ConstantOfShape":
            val = a.get("value")
            kw = {}
            if val is not None:
                v = np.asarray(val).ravel()
                kw = {"value": v[0].item() if v.size else 0,
                      "dtype": str(np.asarray(val).dtype)}
            layers.append(Layer(nname, "constantofshape", kw))
            flow.append(FlowEdge(ins, [nname], outs, False, len(outs) == 1))
            continue

        low = _LOWER.get(node.op_type)
        if low is None:
            raise NotImplementedError(
                f"ONNX op_type {node.op_type!r} has no IR lowering "
                f"(node {node.name!r})")
        opcode, kwargs = low(a)
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        layers.append(Layer(nname, opcode, kwargs))
        # Dropout and friends: keep only the first output
        if node.op_type in ("Dropout",):
            outs = outs[:1]
        flow.append(FlowEdge(ins, [nname], outs,
                             src_scalar=len(ins) == 1,
                             dst_scalar=len(outs) == 1))

    # synthetic return node bundling the graph outputs
    layers.append(Layer("return", "return", {}))
    out_names = [vi.name for vi in g.output]
    flow.append(FlowEdge(out_names, ["return"], ["plrst"],
                         src_scalar=len(out_names) == 1, dst_scalar=True))

    graph = Graph(inputs=inputs, inits=inits, layers=layers, flow=flow,
                  meta={"producer": model.producer_name,
                        "opset": model.opset})
    graph.validate()
    return graph, pack_weights(weights)


def convert_onnx(path: str) -> tuple[Graph, np.ndarray]:
    return convert_model(op.load_model(path))
