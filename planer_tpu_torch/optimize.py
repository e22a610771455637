"""Graph-level optimization passes over the flow IR — a numpy copy of the
passes of ``planer_tpu/optimize.py`` that the main path runs, so the port
rewrites a graph into the same IR JSON and weight bytes as the JAX package.

  * :func:`fold_bn_into_conv` — a ``conv -> batchnorm`` pair (the affine
    form) folds completely into the conv weights/bias: W'[o] = W[o] * K[o],
    B' = B * K + B_bn.  Removes the elementwise pass AND the affine weight
    streams; applies to every conv/bn in ResNet/YOLO-style nets.
Run :func:`optimize` (or ``Net.optimize()``) BEFORE ``Net.quantize()`` so the
quantizer sees the folded weights (per-channel scales then absorb the BN
gain exactly).
"""
from __future__ import annotations

import numpy as np

from .ir import Graph, FlowEdge

__all__ = ["optimize", "fold_bn_into_conv", "annotate_pool_impl",
           "fuse_stage64", "fuse_stagen", "annotate_output_quant"]


def _consumer_count(graph: Graph) -> dict[str, int]:
    cnt: dict[str, int] = {}
    for e in graph.flow:
        for li in range(len(e.layers)):
            src = e.src if li == 0 else e.dst
            for s in src:
                cnt[s] = cnt.get(s, 0) + 1
    for s in graph.flow[-1].dst:
        cnt[s] = cnt.get(s, 0) + 1  # graph outputs count as consumed
    return cnt


def fold_bn_into_conv(net) -> int:
    """Fold ``conv(x, W, B?) -> batchnorm(y, K, B)`` pairs into the conv.

    Requirements: single-layer edges, conv output consumed ONLY by the bn,
    conv weight/bias and bn affines are inits not shared with other layers,
    group handled (per-output-channel scaling is group-agnostic).  Returns
    the number of pairs folded.
    """
    graph: Graph = net.graph
    layers = graph.layer_map()
    idx = graph.init_index()
    inits = set(graph.init_names())
    users = graph.weight_users()
    consumers = _consumer_count(graph)

    # producer edge index for each tensor (single-assignment assumed; bail
    # on rebinds)
    produced: dict[str, int] = {}
    rebound: set[str] = set()
    for i, e in enumerate(graph.flow):
        for d in e.dst:
            if d in produced:
                rebound.add(d)
            produced[d] = i

    folded = 0
    drop_edges: set[int] = set()
    for j, bn_edge in enumerate(graph.flow):
        if len(bn_edge.layers) != 1 or j in drop_edges:
            continue
        if layers[bn_edge.layers[0]].op != "batchnorm":
            continue
        if len(bn_edge.src) != 3:
            continue
        y, kname, bname = bn_edge.src
        if kname not in inits or bname not in inits:
            continue
        if y in rebound or y not in produced:
            continue
        i = produced[y]
        conv_edge = graph.flow[i]
        if i in drop_edges or len(conv_edge.layers) != 1:
            continue
        if layers[conv_edge.layers[0]].op != "conv":
            continue
        if consumers.get(y, 0) != 1:
            continue  # conv output used elsewhere too
        srcs = conv_edge.src
        if len(srcs) < 2 or srcs[1] not in inits:
            continue
        wname = srcs[1]
        bias_name = srcs[2] if len(srcs) > 2 and srcs[2] != "None" else None
        # weights shared with other ops must not be rewritten
        if len(users.get(wname, [])) > 1:
            continue
        if bias_name and len(users.get(bias_name, [])) > 1:
            continue
        if len(users.get(kname, [])) > 1 or len(users.get(bname, [])) > 1:
            continue
        W = net.weights[idx[wname]]
        if W.dtype != np.float32 or W.ndim != 4:
            continue
        K = net.weights[idx[kname]].reshape(-1)   # (C,)
        Bn = net.weights[idx[bname]].reshape(-1)
        if K.shape[0] != W.shape[0]:
            continue
        # fold
        net.weights[idx[wname]] = (W * K.reshape(-1, 1, 1, 1)).astype(W.dtype)
        if bias_name is not None:
            Bc = net.weights[idx[bias_name]]
            net.weights[idx[bias_name]] = (Bc * K + Bn).astype(Bc.dtype)
        else:
            # conv had no bias: reuse the bn shift init as the conv bias
            net.weights[idx[bname]] = Bn.astype(np.float32)
            graph.inits[idx[bname]] = (bname, Bn.shape, "float32")
            if conv_edge.src_scalar:
                conv_edge.src_scalar = False
            conv_edge.src = [srcs[0], wname, bname]
        # conv now writes the bn's output directly
        conv_edge.dst = list(bn_edge.dst)
        conv_edge.dst_scalar = bn_edge.dst_scalar
        drop_edges.add(j)
        folded += 1

    if folded:
        keep = [e for i, e in enumerate(graph.flow) if i not in drop_edges]
        dropped_layers = {graph.flow[i].layers[0] for i in drop_edges}
        graph.flow = keep
        graph.layers = [l for l in graph.layers if l.name not in dropped_layers]
        # drop inits no longer referenced by any flow edge (dead BN affines)
        still_used = set(graph.weight_users())
        keep_iw = [(i, w) for (i, w) in zip(graph.inits, net.weights)
                   if i[0] in still_used]
        graph.inits = [i for i, _ in keep_iw]
        net.weights = [w for _, w in keep_iw]
        graph.validate()
        net._invalidate()
    return folded


# producers whose epilogue the JAX package's compiler fuses a pool into; a
# maxpool after anything else gets the ``impl="shift"`` lowering hint (the
# port ignores the hint, the IR keeps it)
_FUSABLE_PRODUCERS = {"conv", "convtranspose", "dense", "matmul"}
# elementwise ops the fusion sees through (conv -> bn -> relu -> pool fuses)
_TRANSPARENT = {"batchnorm", "relu", "leakyrelu", "sigmoid", "tanh", "clip",
                "add", "sub", "mul", "div", "identity", "prelu", "elu",
                "hardsigmoid", "cast"}


def annotate_pool_impl(net) -> int:
    """Annotate maxpool layers whose input is NOT a fusable conv epilogue
    with ``impl="shift"`` (the pair-reshape lowering).  Returns the number of
    pools annotated."""
    graph: Graph = net.graph
    layers = graph.layer_map()
    # tensor -> (producing op, that op's first data input); chain layers
    # rebind the edge dst, so later chain members see the previous member
    producer: dict[str, tuple[str, str | None]] = {}
    annotated = 0

    def fusable_upstream(name: str) -> bool:
        seen: set[str] = set()
        while name in producer and name not in seen:
            seen.add(name)
            op, inp = producer[name]
            if op in _FUSABLE_PRODUCERS:
                return True
            if op in _TRANSPARENT:
                name = inp
                continue
            return False
        return False  # graph input / init / unknown: standalone

    for e in graph.flow:
        for li, lname in enumerate(e.layers):
            op = layers[lname].op
            src = e.src if li == 0 else e.dst
            inp = src[0] if src else None
            if op == "maxpool" and inp is not None \
                    and not fusable_upstream(inp):
                if layers[lname].kwargs.get("impl") != "shift":
                    layers[lname].kwargs["impl"] = "shift"
                    annotated += 1
            for d in e.dst:
                producer[d] = (op, inp)
    if annotated:
        net._invalidate()
    return annotated


def _kw_eq(kwargs, key, want, default=None):
    v = kwargs.get(key, default)
    if v is None:
        return want is None or tuple(want) == tuple(default or ())
    try:
        return tuple(int(i) for i in v) == tuple(want)
    except TypeError:
        return v == want


def fuse_stage64(net) -> int:
    """Fuse the ResNet entry stage — ``conv7x7/2 -> relu -> maxpool3/2`` plus
    every following ``conv3x3-relu-conv3x3-add-relu`` basic block at C=64 —
    into one ``stage64`` op, which runs as the fused stage kernels
    (ops/kernels/stage64.py).

    Run AFTER :func:`fold_bn_into_conv` (pattern expects folded conv+bias)
    and after calibration/quantization (the kernel needs the calibrated act
    scales; the op itself is precision-agnostic — an ineligible geometry
    decomposes to exactly the replaced chain).  Returns the number of stages fused.
    """
    graph: Graph = net.graph
    layers = graph.layer_map()
    inits = set(graph.init_names())
    ishape = {n: tuple(s) for n, s, _ in graph.inits}
    consumers = _consumer_count(graph)
    flow = graph.flow

    def single(i, op):
        e = flow[i] if i < len(flow) else None
        if e is None or len(e.layers) != 1 or layers[e.layers[0]].op != op:
            return None
        return e

    def conv_of(i, cin, cout, k, stride, pad):
        e = single(i, "conv")
        if e is None or len(e.src) < 2:
            return None
        w = e.src[1]
        if w not in inits or ishape.get(w) != (cout, cin, k, k):
            return None
        kw = layers[e.layers[0]].kwargs
        if not (_kw_eq(kw, "strides", (stride, stride), (1, 1))
                and _kw_eq(kw, "pads", (pad,) * 4, (0, 0, 0, 0))
                and _kw_eq(kw, "dilations", (1, 1), (1, 1))
                and int(kw.get("group", 1)) == 1
                and not kw.get("auto_pad")):
            return None
        return e

    fused = 0
    i = 0
    while i < len(flow):
        e0 = conv_of(i, 3, 64, 7, 2, 3)
        if e0 is None:
            i += 1
            continue
        e1 = single(i + 1, "relu")
        e2 = single(i + 2, "maxpool")
        if (e1 is None or e2 is None
                or e1.src != [e0.dst[0]] or e2.src[0] != e1.dst[0]
                or consumers.get(e0.dst[0], 0) != 1
                or consumers.get(e1.dst[0], 0) != 1):
            i += 1
            continue
        pkw = layers[e2.layers[0]].kwargs
        if not (_kw_eq(pkw, "w", (3, 3), (2, 2))
                and _kw_eq(pkw, "strides", (2, 2), (2, 2))
                and _kw_eq(pkw, "pads", (1, 1, 1, 1), (0, 0, 0, 0))
                and int(pkw.get("ceil_mode", 0) or 0) == 0
                and not pkw.get("auto_pad")):
            i += 1
            continue
        # greedily match basic blocks
        src = [e0.src[0], e0.src[1],
               e0.src[2] if len(e0.src) > 2 else "None"]
        y = e2.dst[0]
        j = i + 3
        nblocks = 0
        drop = [i, i + 1, i + 2]
        while True:
            c1 = conv_of(j, 64, 64, 3, 1, 1)
            r1 = single(j + 1, "relu")
            c2 = conv_of(j + 2, 64, 64, 3, 1, 1)
            ad = single(j + 3, "add")
            r2 = single(j + 4, "relu")
            if None in (c1, r1, c2, ad, r2):
                break
            if not (c1.src[0] == y and r1.src == [c1.dst[0]]
                    and c2.src[0] == r1.dst[0]
                    and sorted(ad.src) == sorted([c2.dst[0], y])
                    and r2.src == [ad.dst[0]]
                    and consumers.get(y, 0) == 2
                    and consumers.get(c1.dst[0], 0) == 1
                    and consumers.get(r1.dst[0], 0) == 1
                    and consumers.get(c2.dst[0], 0) == 1
                    and consumers.get(ad.dst[0], 0) == 1):
                break
            src += [c1.src[1], c1.src[2] if len(c1.src) > 2 else "None",
                    c2.src[1], c2.src[2] if len(c2.src) > 2 else "None"]
            drop += [j, j + 1, j + 2, j + 3, j + 4]
            y = r2.dst[0]
            nblocks += 1
            j += 5
        # nblocks == 0 still fuses stem + pool alone (ResNet-50's stem is
        # followed by bottlenecks, which fuse_stagen handles; the stem-only
        # stage64 kernel emits bf16)
        from .ir import Layer
        name = f"stage64_{fused}"
        graph.layers.append(Layer(name, "stage64", {"blocks": nblocks}))
        fe = FlowEdge(src, [name], [y])
        dropped = set(drop)
        dropped_layers = {flow[k].layers[0] for k in dropped}
        graph.flow = flow = (flow[:i] + [fe]
                             + [e for k, e in enumerate(flow) if k > i
                                and k not in dropped])
        graph.layers = [l for l in graph.layers
                        if l.name not in dropped_layers]
        layers = graph.layer_map()
        consumers = _consumer_count(graph)
        fused += 1
        i += 1
    if fused:
        graph.validate()
        net._invalidate()
    return fused


# minimum C_in for a conv to count as a codes consumer in
# annotate_output_quant (the JAX package's value).  128 = only convs on the
# s8 path consume codes directly; 1 = ALSO annotate edges into C<128
# consumers, which DECODE to the compute dtype (torch_ops._conv2d).
ANNOTATE_MIN_CIN = 128

# look through residual adds (the qadd extension); False restores the
# conv-relu-conv-only chaining
ANNOTATE_QADD = True


def annotate_output_quant(net) -> int:
    """Quantized-activation chaining: mark every producer op (conv or fused
    stage64) whose output — looking THROUGH relu, which is exact on int8
    codes — feeds ONLY int8-quantized convs sharing one calibrated
    activation scale.  The producer gets that scale as its ``out_scale``
    kwarg and emits int8 activation CODES (the stage64 kernels emit them
    natively), the in-between relu runs on int8, and the consumer convs take
    torch_ops.conv2d's pre-quantized s8 path — so the separate quantize pass
    AND the float activation round-trip both disappear from every
    conv-relu-conv chain (ResNet basic blocks: 1 edge per block).

    Consumers must have C_in >= ANNOTATE_MIN_CIN, the JAX package's choice
    (so the ResNet entry stage's C=64-consumer edge stays float).

    Run AFTER quantize_net + fuse_stage64 with calibrated act_scales in
    graph.meta.  Safe by construction: every non-annotated or fallback path
    emits float and consumers follow their normal dtype-driven gates.
    Returns the number of producers annotated."""
    graph: Graph = net.graph
    scales = graph.meta.get("act_scales", {})
    # consumers rebuild values as codes * act_scale only when the program is
    # statically activation-quantized (quant.py param_transform); annotating
    # a dynamic/float program would emit codes nothing decodes
    if not scales or not graph.quant \
            or graph.meta.get("act_quant") != "static":
        return 0
    layers = graph.layer_map()
    inits = set(graph.init_names())
    ishape = {n: tuple(s) for n, s, _ in graph.inits}
    outputs = set(graph.flow[-1].dst)

    def consumers(y):
        """Every (layer, src) application reading tensor y."""
        for e2 in graph.flow:
            for li, lname in enumerate(e2.layers):
                src = e2.src if li == 0 else e2.dst
                if y in src:
                    yield e2, li, layers[lname], src

    def is_qadd(l2, e2, li, src, y):
        """A single-layer 2-operand elementwise add reading y once: accepts
        int8 codes at ANY scale (torch_ops.add's qadd rescale decodes or
        rescales each operand independently)."""
        return (ANNOTATE_QADD
                and l2.op == "add" and li == 0 and len(e2.layers) == 1
                and len(src) == 2 and src.count(y) == 1
                and not any(s in inits for s in src))

    def sink_scale(y, depth=0):
        """The scale y's consumers need its codes at, or None.

        Consumer kinds: int8 static-scale convs with C_in >= 128 are HARD
        constraints (their calibrated act scale; all must agree), relu is
        transparent (exact on codes), a residual ``add`` is scale-FLEXIBLE
        (it rescales codes per-operand, so it never pins nor vetoes y's
        scale — but when y has no conv consumer at all, the add's own
        resolved output scale is used so the common same-scale residual
        contributes its codes exactly).  Anything else vetoes."""
        if y in outputs or depth > 4:
            return None
        hard, flex = [], []
        for e2, li, l2, src in consumers(y):
            if l2.op == "relu" and li == 0 and len(e2.layers) == 1 \
                    and src == [y]:
                s = sink_scale(e2.dst[0], depth + 1)
                if s is None:
                    return None
                hard.append(s)
                continue
            w = src[1] if len(src) > 1 else None
            if (l2.op == "conv" and src[0] == y and src.count(y) == 1
                    and w in inits and w in graph.quant
                    and graph.quant[w].get("mode") == "int8"
                    and w in scales
                    and int(l2.kwargs.get("group", 1)) == 1
                    and len(ishape.get(w, ())) == 4
                    and ishape[w][1] >= ANNOTATE_MIN_CIN):
                hard.append(float(scales[w]))
                continue
            if is_qadd(l2, e2, li, src, y):
                flex.append(e2)
                continue
            return None
        if hard:
            return hard[0] if all(s == hard[0] for s in hard) else None
        for e2 in flex:
            s = sink_scale(e2.dst[0], depth + 1)
            if s is not None:
                return s
        return None

    # code_at propagation requires producers to precede consumers in flow
    # order (ADVICE r4): a reordered flow would record qadd with sa/sb=None
    # while the producer still emits codes — fail loudly instead.
    all_dst = {d for e in graph.flow for d in e.dst}
    produced = set(graph.inputs) | inits
    for i, e in enumerate(graph.flow):
        for s in e.src:
            # names never produced anywhere are optional-input sentinels
            # (the executor resolves them to None) — only a read of a
            # tensor whose producer comes LATER is a reorder violation
            assert s in produced or s not in all_dst, (
                f"annotate_output_quant: flow is not topologically ordered "
                f"(edge {i} reads {s!r} before its producer)")
        produced.update(e.dst)

    n = 0
    code_at = {}      # tensor name -> scale its int8 codes carry
    for e in graph.flow:
        if len(e.layers) != 1:
            continue
        lay = layers[e.layers[0]]
        if lay.op in ("stage64", "conv"):
            # any conv2d path implements out_scale emission
            s = sink_scale(e.dst[0])
            if s is not None:
                lay.kwargs["out_scale"] = s
                code_at[e.dst[0]] = s
                n += 1
        elif lay.op == "relu" and e.src and e.src[0] in code_at \
                and list(e.src) == [e.src[0]]:
            # relu is exact on codes: downstream tensors stay codes
            code_at[e.dst[0]] = code_at[e.src[0]]
        elif ANNOTATE_QADD and lay.op == "add" and len(e.src) == 2 \
                and not any(s in inits for s in e.src):
            # residual chaining: operands whose producers were annotated
            # arrive as codes (flow order is topological, so both operand
            # producers were already visited); so != None re-emits codes
            sa, sb = code_at.get(e.src[0]), code_at.get(e.src[1])
            so = sink_scale(e.dst[0])
            if so is None and sa is None and sb is None:
                continue
            lay.kwargs["qadd"] = [sa, sb, so]
            if so is not None:
                code_at[e.dst[0]] = so
                n += 1
    if n:
        net._invalidate()
    return n


# round-2 name for the stage64-only version of the pass
annotate_stage_output_quant = annotate_output_quant


def optimize(net) -> dict:
    """Run all IR optimization passes; returns per-pass counts."""
    report = {"fold_bn_into_conv": fold_bn_into_conv(net),
              "annotate_pool_impl": annotate_pool_impl(net)}
    return report


def fuse_stagen(net, max_cout: int | None = None) -> int:
    """Fuse ResNet body stages — a strided/projected entry block plus its
    following identity blocks at constant width, basic OR bottleneck — into
    ``stagen`` ops, which run as the fused stage kernel
    (ops/kernels/stagen.py).  Run AFTER fuse_stage64 (which consumes the
    entry stem + C=64 basic blocks) and after quantization; like stage64 the
    op is precision-agnostic and decomposes to exactly the replaced chain
    for unsupported geometry.  Opt-in: ``Net.quantize(fuse="all")`` runs it,
    the default fuse does not, as in the JAX package.  ``max_cout``: a
    stage whose entry block's output width exceeds it is not fused.

    Returns the number of stages fused.
    """
    graph: Graph = net.graph
    layers = graph.layer_map()
    inits = set(graph.init_names())
    ishape = {n: tuple(s) for n, s, _ in graph.inits}
    consumers = _consumer_count(graph)
    flow = graph.flow

    def single(i, op):
        e = flow[i] if 0 <= i < len(flow) else None
        if e is None or len(e.layers) != 1 or layers[e.layers[0]].op != op:
            return None
        return e

    def conv_at(i, k, stride, pad, cin=None, cout=None, cmid_eq=None):
        e = single(i, "conv")
        if e is None or len(e.src) < 2:
            return None
        w = e.src[1]
        sh = ishape.get(w) if w in inits else None
        if (sh is None or len(sh) != 4 or sh[2] != k or sh[3] != k
                or (cin is not None and sh[1] != cin)
                or (cout is not None and sh[0] != cout)):
            return None
        kw = layers[e.layers[0]].kwargs
        if not (_kw_eq(kw, "strides", (stride, stride), (1, 1))
                and _kw_eq(kw, "pads", (pad,) * 4, (0, 0, 0, 0))
                and _kw_eq(kw, "dilations", (1, 1), (1, 1))
                and int(kw.get("group", 1)) == 1
                and not kw.get("auto_pad")):
            return None
        return e

    def wb(e):
        return [e.src[1], e.src[2] if len(e.src) > 2 else "None"]

    def try_block(j, y, first, kind=None, want_co=None, want_cm=None):
        """Match one residual block starting at flow[j] with input ``y``.
        Returns (n_edges, srcs, desc, out, co, cm) or None."""
        for knd in (("basic", "bottleneck") if kind is None else (kind,)):
            for stride in ((1, 2) if first else (1,)):
                if knd == "basic":
                    c1 = conv_at(j, 3, stride, 1, cout=want_co)
                    if c1 is None or c1.src[0] != y:
                        continue
                    cin, co = ishape[c1.src[1]][1], ishape[c1.src[1]][0]
                    cm = co
                    r1 = single(j + 1, "relu")
                    c2 = conv_at(j + 2, 3, 1, 1, cin=co, cout=co)
                    k = j + 3
                    chain = [c1, r1, c2]
                else:
                    c1 = conv_at(j, 1, 1, 0, cout=want_cm)
                    if c1 is None or c1.src[0] != y:
                        continue
                    cin, cm = ishape[c1.src[1]][1], ishape[c1.src[1]][0]
                    r1 = single(j + 1, "relu")
                    c2 = conv_at(j + 2, 3, stride, 1, cin=cm, cout=cm)
                    r2 = single(j + 3, "relu")
                    c3 = conv_at(j + 4, 1, 1, 0, cin=cm, cout=want_co)
                    if c3 is None:
                        continue
                    co = ishape[c3.src[1]][0]
                    k = j + 5
                    chain = [c1, r1, c2, r2, c3]
                if None in chain:
                    continue
                # intra-chain wiring + single consumers
                ok = True
                prev = chain[0].dst[0]
                for e in chain[1:]:
                    if e.src[0] != prev or consumers.get(prev, 0) != 1:
                        ok = False
                        break
                    prev = e.dst[0]
                if not ok or consumers.get(prev, 0) != 1:
                    continue
                down = first and (stride != 1 or cin != co)
                cd = None
                if down:
                    cd = conv_at(k, 1, stride, 0, cin=cin, cout=co)
                    if cd is None or cd.src[0] != y:
                        continue
                    k += 1
                ad = single(k, "add")
                rf = single(k + 1, "relu")
                res = cd.dst[0] if down else y
                if (ad is None or rf is None
                        or sorted(ad.src) != sorted([prev, res])
                        or rf.src != [ad.dst[0]]
                        or consumers.get(y, 0) != 2
                        or consumers.get(ad.dst[0], 0) != 1
                        or (down and consumers.get(res, 0) != 1)):
                    continue
                srcs = wb(chain[0]) + wb(chain[2])
                if knd == "bottleneck":
                    srcs += wb(chain[4])
                if down:
                    srcs += wb(cd)
                desc = {"kind": knd, "stride": stride, "down": down}
                n = (k + 2) - j
                return n, srcs, desc, rf.dst[0], co, cm
        return None

    fused = 0
    i = 0
    while i < len(flow):
        m = try_block(i, flow[i].src[0] if flow[i].src else None, True)
        if m is None:
            i += 1
            continue
        x0 = flow[i].src[0]
        n, srcs, desc, y, co, cm = m
        if max_cout is not None and co > max_cout:
            i += 1
            continue
        blocks, all_srcs = [desc], list(srcs)
        drop = list(range(i, i + n))
        j = i + n
        while True:
            m2 = try_block(j, y, False, kind=desc["kind"],
                           want_co=co, want_cm=cm)
            if m2 is None:
                break
            n2, srcs2, desc2, y, _, _ = m2
            blocks.append(desc2)
            all_srcs += srcs2
            drop += list(range(j, j + n2))
            j += n2
        from .ir import Layer
        name = f"stagen_{fused}"
        graph.layers.append(Layer(name, "stagen", {"blocks": blocks}))
        fe = FlowEdge([x0] + all_srcs, [name], [y])
        dropped = set(drop)
        dropped_layers = {flow[k2].layers[0] for k2 in dropped}
        graph.flow = flow = (flow[:i] + [fe]
                             + [e for k2, e in enumerate(flow) if k2 > i
                                and k2 not in dropped])
        graph.layers = [l for l in graph.layers
                        if l.name not in dropped_layers]
        layers = graph.layer_map()
        consumers = _consumer_count(graph)
        fused += 1
        i += 1
    if fused:
        graph.validate()
        net._invalidate()
    return fused
