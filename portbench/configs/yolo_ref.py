"""Plain reference of the static W8A8 YOLO-v3 configuration (Darknet-53 and
its three FPN detection heads, int8 per-output-channel weights, static
int8 activation scales, bfloat16 compute).

It starts from the float arrays and calibration images the benchmark made
and works out again everything the program derives from them: the
BatchNorm fold, the activation scales (percentile of |input| per conv over
the calibration batches, in a float32 forward with TF32 off), the int8
weights, which residual adds emit int8 codes and at which scale (an add
whose output feeds int8 convs of >= 128 input channels, and adds, and
nothing else), the route each conv takes at the program's batch, and the
bfloat16 roundings of the dequant, the bias, LeakyReLU (its alpha rounded
to bfloat16 first), the residual add, the nearest upsample and the concat.
A conv and a residual add are computed as in ``resnet_ref``, whose
decomposed arithmetic this network shares; only the graph is YOLO's.

Departures from the published model (Redmon & Farhadi, arXiv:1804.02767;
darknet's ``cfg/yolov3.cfg`` at 416): the answer is the three raw head
maps, with no box decode, score filter or NMS (the port does those after
the heads, ``models/yolo_post``); weights are random.

Integer convolutions run as float64 convolutions of integer-valued tensors
(exact: |sum| <= 127**2 * 9,216 < 2**53); a bfloat16 conv runs in float64
on the bfloat16 operands and rounds once to float32, then to bfloat16.
Nothing here imports the program or its kernels: torch and numpy only.

``bits`` sets the integer width of weights and activation codes; the
benchmark's control is this reference at ``bits=4``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import resnet_ref as rr

BF16 = torch.bfloat16
# the least input channels of a conv that takes int8 codes
CODES_MIN_CIN = 128


@dataclasses.dataclass(frozen=True)
class Node:
    """One step of the network, named as the port's zoo names its layer."""
    name: str
    op: str            # "conv" | "add" | "up" (nearest 2x) | "cat" (channels)
    src: tuple         # the nodes it reads; "x" is the image
    cin: int = 0
    cout: int = 0
    k: int = 1
    stride: int = 1
    head: bool = False  # a head's 1x1 conv: its own bias, no BN, no activation

    @property
    def pad(self):
        return self.k // 2


def network(cfg) -> tuple[list[Node], list[str]]:
    """(the nodes in flow order, the three heads' names, stride 32 first).

    Darknet-53: a 3x3 conv, then per stage a 3x3 stride-2 conv and
    ``blocks[i]`` residual blocks (1x1 to half width, 3x3 back, add), every
    conv with BatchNorm and LeakyReLU.  Then per FPN level, from the last
    stage: (below the first level) a 1x1 route conv, a nearest 2x upsample
    and a concat with the stage's output, five convs alternating 1x1 and
    3x3, a 3x3 conv and the head's 1x1 conv to 3 * (5 + classes)
    channels."""
    nodes = []

    def conv(src, cin, cout, k, stride, name, head=False):
        nodes.append(Node(name, "conv", (src,), cin, cout, k, stride, head))
        return name

    w = cfg["widths"]
    y = conv("x", 3, w[0], 3, 1, "d0")
    feats = []
    for i, n in enumerate(cfg["blocks"]):
        y = conv(y, w[i], w[i + 1], 3, 2, f"d{i + 1}")
        c = w[i + 1]
        for j in range(n):
            p = f"r{i + 1}.{j}"
            t = conv(y, c, c // 2, 1, 1, f"{p}.1")
            t = conv(t, c // 2, c, 3, 1, f"{p}.2")
            nodes.append(Node(f"{p}.add", "add", (t, y)))
            y = f"{p}.add"
        feats.append(y)
    out = cfg["anchors_per_scale"] * (5 + cfg["num_classes"])
    heads, x, cin = [], feats[-1], w[-1]
    for lvl, cmid in enumerate(cfg["fpn_widths"]):
        s = len(cfg["blocks"]) - lvl          # the backbone stage it joins
        if lvl:
            r = conv(x, cin, cmid, 1, 1, f"route{s}")
            nodes.append(Node(f"{r}.up", "up", (r,)))
            nodes.append(Node(f"{r}.cat", "cat", (f"{r}.up", feats[s - 1])))
            x, cin = f"{r}.cat", cmid + w[s]
        for i in range(5):
            k, cout = (1, cmid) if i % 2 == 0 else (3, 2 * cmid)
            x, cin = conv(x, cin, cout, k, 1, f"h{s}.{i}"), cout
        y = conv(x, cmid, 2 * cmid, 3, 1, f"det{2 ** s}.conv")
        heads.append(conv(y, 2 * cmid, out, 1, 1, f"det{2 ** s}.out",
                          head=True))
    return nodes, heads


def code_sinks(nodes) -> dict[str, str]:
    """add name -> the conv whose activation scale its output codes carry,
    for every residual add whose output the program hands on as int8 codes:
    one read by a single int8 conv of >= ``CODES_MIN_CIN`` input channels
    and otherwise only by adds (a concat or a narrower conv vetoes)."""
    readers = {n.name: [] for n in nodes}
    for n in nodes:
        for s in n.src:
            if s in readers:
                readers[s].append(n)
    out = {}
    for n in nodes:
        if n.op != "add":
            continue
        convs = [r for r in readers[n.name]
                 if r.op == "conv" and r.cin >= CODES_MIN_CIN]
        if len(convs) == 1 and all(r.op == "add" or r is convs[0]
                                   for r in readers[n.name]):
            out[n.name] = convs[0].name
    return out


def out_side(n: Node, h):
    return (h + 2 * n.pad - n.k) // n.stride + 1


def routes(cfg, side, batch) -> dict[str, tuple[str, int]]:
    """conv name -> (route, input side) at the program's ``batch``, by
    ``resnet_ref.conv_route``'s gates: "s8" (codes in), "w8a8" or
    "float"."""
    nodes, _ = network(cfg)
    sinks = code_sinks(nodes)
    size, coded, out = {"x": side}, {"x": False}, {}
    for n in nodes:
        h = size[n.src[0]]
        if n.op == "conv":
            out[n.name] = (rr.conv_route(n, h, h, coded[n.src[0]], batch), h)
            size[n.name] = out_side(n, h)
        else:
            size[n.name] = 2 * h if n.op == "up" else h
        coded[n.name] = n.name in sinks
    return out


def _up(t):
    return t.repeat_interleave(2, 2).repeat_interleave(2, 3)


class Int8Yolo(rr.Int8ResNet):
    """The reference network.  ``arrays``: name -> float32 array (conv
    weights OIHW, BatchNorm affine ``.bn.k`` / ``.bn.b`` of shape (1, C,
    1, 1), a head's bias ``.b``); ``calib``: the calibration batches
    (float32 NCHW tensors on ``device``).  The decomposed conv
    (``conv``), the residual add (``qadd``), the activation codes
    (``quantize``), the weights' quantization and the calibration are
    ``resnet_ref.Int8ResNet``'s."""

    def __init__(self, cfg, arrays, calib, device, bits=8):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.q = 2 ** (bits - 1) - 1
        self.nodes, self.heads = network(cfg)
        self.convs = {n.name: n for n in self.nodes if n.op == "conv"}
        last = {}
        for i, n in enumerate(self.nodes):
            for s in n.src:
                last[s] = i
        self._last = last
        self._fold_bn(arrays)
        self.act = self._calibrate(calib)
        self._quantize()
        self.codes = {a: self.act[c] for a, c in
                      code_sinks(self.nodes).items()}

    def _fold_bn(self, arrays):
        self.fw, self.fb = {}, {}
        for n, c in self.convs.items():
            w = np.asarray(arrays[f"{n}.w"], np.float32)
            if c.head:
                self.fw[n] = w
                self.fb[n] = np.asarray(arrays[f"{n}.b"], np.float32)
                continue
            k = np.asarray(arrays[f"{n}.bn.k"], np.float32).reshape(-1)
            self.fw[n] = (w * k.reshape(-1, 1, 1, 1)).astype(np.float32)
            self.fb[n] = np.asarray(arrays[f"{n}.bn.b"],
                                    np.float32).reshape(-1)

    def _quantize(self):
        self.ws, self.wq_t, self.ws_t, self.b_bf = {}, {}, {}, {}
        for n in self.convs:
            q, s = self._wq(self.fw[n])
            self.ws[n] = s.reshape(-1)
            self.wq_t[n] = self._t(q, torch.float64)
            self.ws_t[n] = self._t(s.reshape(-1))
            # the program hands every float parameter over in bfloat16
            self.b_bf[n] = self._t(self.fb[n]).to(BF16)

    def _walk(self, x, conv, add, up, cat):
        """The heads of the network run on ``x`` by the given steps, each
        value dropped after its last reader."""
        vals = {"x": x}
        for i, n in enumerate(self.nodes):
            a = [vals[s] for s in n.src]
            if n.op == "conv":
                vals[n.name] = conv(n, a[0])
            elif n.op == "add":
                vals[n.name] = add(n, *a)
            elif n.op == "up":
                vals[n.name] = up(a[0])
            else:
                vals[n.name] = cat(*a)
            for s in n.src:
                if self._last[s] == i:
                    del vals[s]
        return [vals[h] for h in self.heads]

    def float_forward(self, x, record=None):
        """The float32 model on the folded weights, TF32 off: the three
        heads of images ``x``; ``record(name, t)`` sees each conv's
        input."""
        def conv(n, t):
            if record is not None:
                record(n.name, t)
            y = F.conv2d(t, self._t(self.fw[n.name]), None, n.stride, n.pad)
            y = y + self._t(self.fb[n.name]).reshape(1, -1, 1, 1)
            if n.head:
                return y
            return torch.where(y > 0, y, y * rr._f32(self.cfg["leaky"], y))

        with rr._no_tf32(), torch.no_grad():
            return self._walk(x.float(), conv, lambda n, a, b: a + b, _up,
                              lambda a, b: torch.cat([a, b], 1))

    @torch.no_grad()
    def forward(self, x, batch=None):
        """The three heads (float32 tensors of bfloat16 values) of images
        ``x`` (float32 NCHW on the device) as the program computes them at
        batch ``batch`` (default: x's)."""
        batch = x.shape[0] if batch is None else batch
        # LeakyReLU's alpha as the program takes it: rounded to bfloat16
        # (0.1 -> 0.10009765625), the product exact in float32, then rounded
        alpha = float(torch.tensor(self.cfg["leaky"], dtype=BF16))

        def conv(n, v):
            t, _ = self.conv(v, n.name, batch)
            if n.head:
                return (t, None)
            neg = (t.float() * rr._f32(alpha, t)).to(BF16)
            return (torch.where(t > 0, t, neg), None)

        def add(n, a, b):
            return self.qadd(a, b, self.codes.get(n.name))

        def up(v):
            assert v[1] is None, "codes into an upsample"
            return (_up(v[0]), None)

        def cat(a, b):
            assert a[1] is None and b[1] is None, "codes into a concat"
            return (torch.cat([a[0], b[0]], 1), None)

        with rr._no_tf32():
            heads = self._walk((x.to(BF16), None), conv, add, up, cat)
        return tuple(t.float() for t, _ in heads)
