"""torch2planer: convert a PyTorch module directly to the flow IR — the
port's copy of ``planer_tpu/frontend/torch2planer.py``, which gives the same
graph JSON and the same weights for the same module.

Neither machine the port runs on has the ``onnx`` package, so this
converter goes straight from a ``torch.fx`` symbolic trace to the IR:
call_module / call_function / call_method nodes are lowered to opcodes,
BatchNorm running statistics are folded into per-channel affine (K, B)
exactly as the ONNX converter folds them, and weights are emitted in the
converter's layouts (dense weight (O, I) with ``shp`` its transpose;
ConvTranspose (I, O/g, kh, kw)).  A module that lives on the card is read
through ``.cpu()``.

Coverage: conv, linear, batch, instance and layer norm, the activations,
pools, upsample and interpolate, flatten, cat, permute, the arithmetic
operators (a parameter operand as a weight), view and reshape.  Unknown
nodes raise with the fx target name.
"""
from __future__ import annotations

import operator

import numpy as np

from ..ir import Graph, Layer, FlowEdge, pack_weights

__all__ = ["torch2planer", "fx_to_graph"]


class _TraceTimeOnly:
    """Sentinel for fx values with no tensor identity (x.size(i)): consumed
    structurally by the view/reshape lowering; emitting it into the IR means
    a computed dynamic dim leaked somewhere it cannot be represented."""

    def __init__(self, node):
        self.node = node


def _np(t):
    return t.detach().cpu().numpy()


def _arg(node, pos, name, default=None):
    """An fx call's argument, given by keyword or at position ``pos``."""
    if name in node.kwargs:
        return node.kwargs[name]
    return node.args[pos] if len(node.args) > pos else default


class _Lowerer:
    def __init__(self, gm, example_shapes):
        import torch
        self.torch = torch
        self.gm = gm
        self.inits: list = []
        self.weights: list = []
        self.layers: list = []
        self.flow: list = []
        self.inputs: list = []
        self.env: dict = {}           # fx node name -> IR tensor name
        self.shapes: dict = example_shapes or {}
        self._ctr = 0

    def fresh(self, hint):
        self._ctr += 1
        return f"{hint}_{self._ctr}"

    def add_weight(self, name, arr):
        arr = np.asarray(arr)
        self.inits.append((name, tuple(arr.shape), str(arr.dtype)))
        self.weights.append(arr if arr.ndim else arr.reshape(1))
        return name

    def emit(self, opcode, srcs, n_out=1, **kwargs):
        for s in srcs:
            if isinstance(s, _TraceTimeOnly):
                raise NotImplementedError(
                    f"x.size(...) value feeds {opcode!r} — computed dynamic "
                    f"shapes have no IR reshape lowering; re-express the "
                    f"shape statically")
        lname = self.fresh(opcode)
        self.layers.append(Layer(lname, opcode, kwargs))
        dsts = [self.fresh("t") for _ in range(n_out)]
        self.flow.append(FlowEdge(list(srcs), [lname], dsts,
                                  src_scalar=len(srcs) == 1,
                                  dst_scalar=n_out == 1))
        return dsts[0] if n_out == 1 else tuple(dsts)

    # ------------------------------------------------------------- modules
    def lower_module(self, node, mod):
        nn = self.torch.nn
        x = self.env[node.args[0].name]
        name = node.target.replace(".", "_")

        if isinstance(mod, nn.Conv2d):
            W = self.add_weight(f"{name}.w", _np(mod.weight))
            srcs = [x, W]
            if mod.bias is not None:
                srcs.append(self.add_weight(f"{name}.b", _np(mod.bias)))
            ph, pw = (mod.padding if isinstance(mod.padding, tuple)
                      else (mod.padding, mod.padding))
            return self.emit("conv", srcs, group=mod.groups,
                             strides=list(mod.stride),
                             dilations=list(mod.dilation),
                             pads=[ph, pw, ph, pw])
        if isinstance(mod, nn.ConvTranspose2d):
            W = self.add_weight(f"{name}.w", _np(mod.weight))
            srcs = [x, W]
            if mod.bias is not None:
                srcs.append(self.add_weight(f"{name}.b", _np(mod.bias)))
            ph, pw = (mod.padding if isinstance(mod.padding, tuple)
                      else (mod.padding, mod.padding))
            oph, opw = (mod.output_padding
                        if isinstance(mod.output_padding, tuple)
                        else (mod.output_padding, mod.output_padding))
            return self.emit("convtranspose", srcs, group=mod.groups,
                             strides=list(mod.stride),
                             dilations=list(mod.dilation),
                             pads=[ph, pw, ph, pw],
                             output_padding=[oph, opw])
        if isinstance(mod, nn.Linear):
            W = self.add_weight(f"{name}.w", _np(mod.weight))  # (O, I)
            srcs = [x, W]
            if mod.bias is not None:
                srcs.append(self.add_weight(f"{name}.b", _np(mod.bias)))
            return self.emit("dense", srcs,
                             shp=list(_np(mod.weight).shape[::-1]))
        if isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm1d)):
            # fold running stats into affine (same math as the ONNX path)
            eps = mod.eps
            var, mean = _np(mod.running_var), _np(mod.running_mean)
            if mod.affine:
                s, b_ = _np(mod.weight), _np(mod.bias)
            else:
                s, b_ = np.ones_like(var), np.zeros_like(var)
            inv = 1.0 / np.sqrt(var + eps)
            K = (s * inv).reshape(1, -1, 1, 1).astype(np.float32)
            B = (b_ - s * mean * inv).reshape(1, -1, 1, 1).astype(np.float32)
            Kn = self.add_weight(f"{name}.foldK", K)
            Bn = self.add_weight(f"{name}.foldB", B)
            return self.emit("batchnorm", [x, Kn, Bn])
        if isinstance(mod, nn.LayerNorm):
            return self._emit_layernorm(x, mod.normalized_shape, mod.weight,
                                        mod.bias, mod.eps, name)
        if isinstance(mod, nn.InstanceNorm2d):
            c = mod.num_features
            s = _np(mod.weight) if mod.affine else np.ones(c, np.float32)
            b_ = _np(mod.bias) if mod.affine else np.zeros(c, np.float32)
            Sn = self.add_weight(f"{name}.s", s)
            Bn = self.add_weight(f"{name}.b", b_)
            return self.emit("instancenormalization", [x, Sn, Bn],
                             epsilon=mod.eps)
        if isinstance(mod, nn.ReLU):
            return self.emit("relu", [x])
        if isinstance(mod, nn.LeakyReLU):
            return self.emit("leakyrelu", [x], alpha=mod.negative_slope)
        if isinstance(mod, nn.Sigmoid):
            return self.emit("sigmoid", [x])
        if isinstance(mod, nn.Tanh):
            return self.emit("tanh", [x])
        if isinstance(mod, nn.Softmax):
            return self.emit("softmax", [x], axis=mod.dim)
        if isinstance(mod, nn.MaxPool2d):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) \
                else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) \
                else (mod.stride or mod.kernel_size,) * 2
            p = mod.padding if isinstance(mod.padding, tuple) \
                else (mod.padding,) * 2
            return self.emit("maxpool", [x], w=list(k),
                             pads=[p[0], p[1], p[0], p[1]], strides=list(s))
        if isinstance(mod, nn.AvgPool2d):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) \
                else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) \
                else (mod.stride or mod.kernel_size,) * 2
            p = mod.padding if isinstance(mod.padding, tuple) \
                else (mod.padding,) * 2
            return self.emit("averagepool", [x], w=list(k),
                             pads=[p[0], p[1], p[0], p[1]], strides=list(s),
                             count_include_pad=1 if mod.count_include_pad
                             else 0)
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            out = mod.output_size
            if out in (1, (1, 1)):
                return self.emit("gap", [x])
            raise NotImplementedError(
                "AdaptiveAvgPool2d only supported with output_size=1")
        if isinstance(mod, nn.Upsample):
            sf = mod.scale_factor
            if sf is None:
                raise NotImplementedError("Upsample with size= not supported")
            sf = sf if isinstance(sf, (tuple, list)) else (sf, sf)
            return self._emit_upsample(x, sf, mod.mode,
                                       getattr(mod, "align_corners", None))
        if isinstance(mod, nn.GELU):
            approx = getattr(mod, "approximate", "none")
            return self.emit("gelu", [x], approximate=approx)
        if isinstance(mod, nn.SiLU):   # x * sigmoid(x), composed
            s_ = self.emit("sigmoid", [x])
            return self.emit("mul", [x, s_])
        if isinstance(mod, nn.ELU):
            return self.emit("elu", [x], alpha=mod.alpha)
        if isinstance(mod, nn.PReLU):
            sl = self.add_weight(f"{name}.slope", _np(mod.weight))
            return self.emit("prelu", [x, sl])
        if isinstance(mod, nn.ReLU6):
            return self.emit("clip", [x], min=0.0, max=6.0)
        if isinstance(mod, nn.Hardswish):  # x * clip(x+3, 0, 6) / 6
            three = self.add_weight(self.fresh("c3"),
                                    np.float32(3.0).reshape(()))
            sixth = self.add_weight(self.fresh("c6i"),
                                    np.float32(1 / 6).reshape(()))
            t = self.emit("add", [x, three])
            t = self.emit("clip", [t], min=0.0, max=6.0)
            t = self.emit("mul", [x, t])
            return self.emit("mul", [t, sixth])
        if isinstance(mod, nn.Softplus):
            return self.emit("softplus", [x])
        if isinstance(mod, (nn.Dropout, nn.Identity)):
            return self.emit("identity", [x])
        if isinstance(mod, nn.Flatten):
            return self.emit("flatten", [x], axis=mod.start_dim)
        raise NotImplementedError(
            f"torch module {type(mod).__name__} at {node.target!r} "
            f"has no IR lowering")

    def _emit_layernorm(self, x, shape, weight, bias, eps, name):
        """``layernorm`` over the trailing ``shape``; a missing scale or
        bias (``elementwise_affine=False``) as ones or zeros.  ``weight``
        and ``bias`` are parameters or IR tensor names."""
        shape = tuple(int(v) for v in shape)
        srcs = [x]
        for v, part, fill in ((weight, "s", np.ones), (bias, "b", np.zeros)):
            if isinstance(v, str):
                srcs.append(v)
            else:
                a = fill(shape, np.float32) if v is None else _np(v)
                srcs.append(self.add_weight(f"{name}.{part}", a))
        return self.emit("layernorm", srcs, axis=-len(shape),
                         epsilon=float(eps))

    @staticmethod
    def _pool_args(node):
        """kernel/stride/padding of a functional pool call, positional OR
        keyword (F.avg_pool2d(x, 3, 1, 1) is the common positional style)."""
        k = _arg(node, 1, "kernel_size")
        k = k if isinstance(k, (tuple, list)) else (k, k)
        st = _arg(node, 2, "stride") or k
        st = st if isinstance(st, (tuple, list)) else (st, st)
        p_ = _arg(node, 3, "padding", 0)
        p_ = p_ if isinstance(p_, (tuple, list)) else (p_, p_)
        return k, st, p_

    def _emit_upsample(self, x, sf, mode, align_corners):
        """torch nearest == asymmetric+floor (the 'upsample' op); torch
        bilinear uses half-pixel coords (align_corners=False) or
        align_corners — lower those to the 'resize' op with the exact
        coordinate_transformation_mode."""
        kn = self.add_weight(self.fresh("upk"),
                             np.array([1, 1, sf[0], sf[1]], np.float32))
        if mode == "nearest":
            return self.emit("upsample", [x, kn], mode="nearest")
        if mode in ("bilinear", "linear"):
            coord = "align_corners" if align_corners else "pytorch_half_pixel"
            return self.emit("resize", [x, "None", kn], mode="linear",
                             coordinate_transformation_mode=coord)
        raise NotImplementedError(f"interpolate mode {mode!r}")

    # ----------------------------------------------------- functions/methods
    def lower_function(self, node):
        import torch
        import torch.nn.functional as F
        fn = node.target
        a = node.args

        def src(i):
            return self.env[a[i].name]

        binops = {operator.add: "add", torch.add: "add",
                  operator.sub: "sub", torch.sub: "sub",
                  operator.mul: "mul", torch.mul: "mul",
                  operator.truediv: "div", torch.div: "div",
                  torch.matmul: "matmul"}
        if fn in binops:
            srcs = []
            for arg in a[:2]:
                if hasattr(arg, "name") and arg.name in self.env:
                    srcs.append(self.env[arg.name])
                else:  # python scalar operand -> constant init
                    srcs.append(self.add_weight(
                        self.fresh("c"), np.asarray(arg, np.float32)))
            return self.emit(binops[fn], srcs)
        if fn in (F.relu, torch.relu):
            return self.emit("relu", [src(0)])
        if fn is F.leaky_relu:
            alpha = a[1] if len(a) > 1 else node.kwargs.get(
                "negative_slope", 0.01)
            return self.emit("leakyrelu", [src(0)], alpha=alpha)
        if fn is torch.sigmoid or fn is getattr(F, "sigmoid", None):
            return self.emit("sigmoid", [src(0)])
        if fn is torch.tanh or fn is getattr(F, "tanh", None):
            return self.emit("tanh", [src(0)])
        if fn is F.softmax:
            axis = node.kwargs.get("dim", a[1] if len(a) > 1 else -1)
            return self.emit("softmax", [src(0)], axis=axis)
        if fn is torch.cat:
            items = [self.env[n.name] for n in a[0]]
            axis = node.kwargs.get("dim", a[1] if len(a) > 1 else 0)
            return self.emit("concat", items, axis=axis)
        if fn is torch.flatten:
            axis = a[1] if len(a) > 1 else node.kwargs.get("start_dim", 0)
            return self.emit("flatten", [src(0)], axis=axis)
        if fn is F.interpolate:
            sf = node.kwargs.get("scale_factor")
            mode = node.kwargs.get("mode", "nearest")
            if sf is None:
                raise NotImplementedError("interpolate with size= unsupported")
            sf = sf if isinstance(sf, (tuple, list)) else (sf, sf)
            return self._emit_upsample(src(0), sf, mode,
                                       node.kwargs.get("align_corners"))
        if fn is F.max_pool2d:
            # F.max_pool2d(input, kernel, stride, padding, dilation, ceil)
            k, st, p_ = self._pool_args(node)
            dil = node.kwargs.get("dilation", a[4] if len(a) > 4 else 1)
            if (dil if isinstance(dil, int) else max(dil)) != 1:
                raise NotImplementedError("max_pool2d dilation != 1")
            if node.kwargs.get("ceil_mode", False) or (len(a) > 5 and a[5]):
                raise NotImplementedError("max_pool2d ceil_mode=True")
            return self.emit("maxpool", [src(0)], w=list(k),
                             pads=[p_[0], p_[1], p_[0], p_[1]],
                             strides=list(st))
        if fn is F.adaptive_avg_pool2d:
            return self.emit("gap", [src(0)])
        if fn is F.layer_norm:
            w, b = (_arg(node, i, k) for i, k in ((2, "weight"),
                                                  (3, "bias")))
            return self._emit_layernorm(
                src(0), _arg(node, 1, "normalized_shape"),
                None if w is None else self.env[w.name],
                None if b is None else self.env[b.name],
                _arg(node, 4, "eps", 1e-5), self.fresh("layernorm"))
        if fn is torch.permute:
            dims = _arg(node, 1, "dims")
            return self.emit("transpose", [src(0)], axis=list(dims))
        if fn is F.gelu:
            approx = node.kwargs.get("approximate", "none")
            return self.emit("gelu", [src(0)], approximate=approx)
        if fn is F.silu:
            s_ = self.emit("sigmoid", [src(0)])
            return self.emit("mul", [src(0), s_])
        if fn is F.elu:
            alpha = node.kwargs.get("alpha", a[1] if len(a) > 1 else 1.0)
            return self.emit("elu", [src(0)], alpha=alpha)
        if fn is F.avg_pool2d:
            # F.avg_pool2d(input, kernel, stride, padding, ceil, count_incl)
            k, st, p_ = self._pool_args(node)
            if node.kwargs.get("ceil_mode", False) or (len(a) > 4 and a[4]):
                raise NotImplementedError("avg_pool2d ceil_mode=True")
            cip = node.kwargs.get("count_include_pad",
                                  a[5] if len(a) > 5 else True)
            return self.emit("averagepool", [src(0)], w=list(k),
                             pads=[p_[0], p_[1], p_[0], p_[1]],
                             strides=list(st),
                             count_include_pad=1 if cip else 0)
        if fn is getattr(operator, "getitem", None):
            raise NotImplementedError("tensor slicing in fx not yet lowered")
        raise NotImplementedError(
            f"torch function {getattr(fn, '__name__', fn)!r} has no IR "
            f"lowering")

    def lower_method(self, node):
        name = node.target
        x = self.env[node.args[0].name]
        if name in ("view", "reshape"):
            # 0 in a reshape target means keep-input-dim at that POSITION, so
            # a non-int fx arg may only map to 0 when it is literally
            # x.size(i) of the same tensor at position i — anything computed
            # (b*t, another tensor's size) must fail loudly, not guess
            dims = []
            for i, d in enumerate(node.args[1:]):
                if isinstance(d, int):
                    dims.append(d)
                elif (getattr(d, "op", None) == "call_method"
                      and d.target == "size" and len(d.args) == 2
                      and d.args[0] is node.args[0] and d.args[1] == i):
                    dims.append(0)
                else:
                    raise NotImplementedError(
                        f"dynamic reshape dim at position {i} is not "
                        f"x.size({i}) of the reshaped tensor; re-express the "
                        f"shape statically")
            shp = self.add_weight(self.fresh("shp"),
                                  np.asarray(dims, np.int64))
            return self.emit("reshape", [x, shp])
        if name == "flatten":
            axis = node.args[1] if len(node.args) > 1 else 0
            return self.emit("flatten", [x], axis=axis)
        if name == "permute":
            dims = node.args[1:]
            if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
                dims = dims[0]
            return self.emit("transpose", [x], axis=list(dims))
        if name == "mean":
            axes = node.args[1] if len(node.args) > 1 else None
            kd = node.kwargs.get("keepdim", False)
            if axes is None:
                raise NotImplementedError(".mean() without dims")
            axes = axes if isinstance(axes, (tuple, list)) else [axes]
            return self.emit("reducemean", [x], axes=list(axes),
                             keepdims=1 if kd else 0)
        if name == "contiguous":
            return self.emit("identity", [x])
        if name == "sigmoid":
            return self.emit("sigmoid", [x])
        if name == "size":
            # trace-time-only value: consumed structurally by the view/
            # reshape lowering (which inspects the fx node, not the env);
            # any other consumer resolves this sentinel and fails loudly
            return _TraceTimeOnly(node)
        raise NotImplementedError(f"tensor method {name!r} has no IR lowering")

    # ------------------------------------------------------------------ run
    def run(self):
        modules = dict(self.gm.named_modules())
        outputs = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.inputs.append(node.name)
                self.env[node.name] = node.name
            elif node.op == "get_attr":
                t = self.gm
                for part in node.target.split("."):
                    t = getattr(t, part)
                self.env[node.name] = self.add_weight(
                    node.target.replace(".", "_"), _np(t))
            elif node.op == "call_module":
                self.env[node.name] = self.lower_module(
                    node, modules[node.target])
            elif node.op == "call_function":
                self.env[node.name] = self.lower_function(node)
            elif node.op == "call_method":
                self.env[node.name] = self.lower_method(node)
            elif node.op == "output":
                arg = node.args[0]
                if isinstance(arg, (tuple, list)):
                    outputs = [self.env[n.name] for n in arg]
                else:
                    outputs = [self.env[arg.name]]
        self.layers.append(Layer("return", "return", {}))
        self.flow.append(FlowEdge(outputs, ["return"], ["plrst"],
                                  src_scalar=len(outputs) == 1,
                                  dst_scalar=True))
        g = Graph(inputs=self.inputs, inits=self.inits, layers=self.layers,
                  flow=self.flow, meta={"producer": "torch2planer(fx)"})
        g.validate()
        return g, pack_weights(self.weights)


def fx_to_graph(module, example=None):
    """Symbolically trace a torch module and lower to (Graph, blob)."""
    import torch
    module = module.eval()
    gm = torch.fx.symbolic_trace(module)
    return _Lowerer(gm, None).run()


def torch2planer(module, path: str, example=None, zip: bool = True,
                 quantize: str | None = None):
    """Write ``path.pla`` (or ``path.json`` + ``.npy`` with zip=False) from
    a torch module; ``quantize`` ("int8" or "fp8") stores quantized
    weights.  Conversion runs nothing on a device: load the file with
    ``read_net`` to run it."""
    from ..io import save_pla
    from ..ir import unpack_weights
    graph, blob = fx_to_graph(module, example)
    weights = unpack_weights(graph, blob)
    if quantize:
        from ..runtime.net import Net
        # quantize_net rewrites the host weights only
        net = Net(graph, weights, device="cpu")
        net.quantize(mode=quantize)
        graph, weights = net.graph, net.weights
    if zip:
        return save_pla(path, graph, weights)
    import json as _json
    with open(path + ".json", "w") as f:
        f.write(graph.to_json())
    np.save(path + ".npy", pack_weights(weights))
    return path + ".json"
