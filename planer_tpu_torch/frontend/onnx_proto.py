"""Self-contained ONNX protobuf wire-format codec (no ``onnx`` dependency) —
a copy of ``planer_tpu/frontend/onnx_proto.py``, which the port may not
import.  Both write the same bytes for the same model.

Neither the CPU machines nor the CUDA machines the port runs on ship the
``onnx`` package (``torch.onnx.export`` needs it), so the frontend carries
its own minimal reader/writer for the ModelProto subset the converter needs
(nodes, attributes, initializers, graph inputs/outputs).  Field numbers
follow the public onnx.proto3 spec; the codec round-trips its own output
and reads files produced by standard exporters.

Only the protobuf *wire format* is implemented here (varint / 64-bit /
length-delimited / 32-bit records), numpy only.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "TensorProto", "AttributeProto", "NodeProto", "ValueInfoProto",
    "GraphProto", "ModelProto", "load_model", "save_model", "to_array",
    "from_array", "DTYPES", "ATTR",
]

# ONNX TensorProto.DataType enum -> numpy dtype (spec order)
DTYPES = {
    1: "float32", 2: "uint8", 3: "int8", 4: "uint16", 5: "int16",
    6: "int32", 7: "int64", 8: "object", 9: "bool", 10: "float16",
    11: "float64", 12: "uint32", 13: "uint64", 16: "bfloat16",
}
DTYPE_CODE = {v: k for k, v in DTYPES.items()}


class ATTR:
    FLOAT, INT, STRING, TENSOR, GRAPH = 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10


# ---------------------------------------------------------------- wire level
def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, v: int):
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _scan(data: bytes):
    """Yield (field_number, wire_type, value) records of one message."""
    buf = memoryview(data)
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = bytes(buf[pos:pos + 8]); pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = bytes(buf[pos:pos + ln]); pos += ln
        elif wt == 5:
            v = bytes(buf[pos:pos + 4]); pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


def _emit(out: bytearray, fn: int, wt: int, v):
    _write_varint(out, (fn << 3) | wt)
    if wt == 0:
        _write_varint(out, v)
    elif wt == 2:
        _write_varint(out, len(v))
        out.extend(v)
    elif wt == 5:
        out.extend(v)
    elif wt == 1:
        out.extend(v)


def _emit_str(out, fn, s: str | bytes):
    _emit(out, fn, 2, s.encode() if isinstance(s, str) else s)


def _packed_ints(vals) -> bytes:
    b = bytearray()
    for v in vals:
        _write_varint(b, int(v))
    return bytes(b)


def _unpack_ints(v, wt) -> list[int]:
    if wt == 0:
        return [_signed(v)]
    out = []
    buf = memoryview(v)
    pos = 0
    while pos < len(buf):
        x, pos = _read_varint(buf, pos)
        out.append(_signed(x))
    return out


def _unpack_floats(v, wt) -> list[float]:
    if wt == 5:
        return [struct.unpack("<f", v)[0]]
    return list(np.frombuffer(v, "<f4"))


# ------------------------------------------------------------- proto classes
@dataclass
class TensorProto:
    dims: list = field(default_factory=list)      # field 1
    data_type: int = 1                            # field 2
    float_data: list = field(default_factory=list)   # 4
    int32_data: list = field(default_factory=list)   # 5
    string_data: list = field(default_factory=list)  # 6
    int64_data: list = field(default_factory=list)   # 7
    name: str = ""                                # 8
    raw_data: bytes = b""                         # 9
    double_data: list = field(default_factory=list)  # 10
    uint64_data: list = field(default_factory=list)  # 11

    @staticmethod
    def parse(data: bytes) -> "TensorProto":
        t = TensorProto()
        for fn, wt, v in _scan(data):
            if fn == 1:
                t.dims.extend(_unpack_ints(v, wt))
            elif fn == 2:
                t.data_type = v
            elif fn == 4:
                t.float_data.extend(_unpack_floats(v, wt))
            elif fn == 5:
                t.int32_data.extend(_unpack_ints(v, wt))
            elif fn == 6:
                t.string_data.append(v)
            elif fn == 7:
                t.int64_data.extend(_unpack_ints(v, wt))
            elif fn == 8:
                t.name = v.decode()
            elif fn == 9:
                t.raw_data = v
            elif fn == 10:
                t.double_data.extend(np.frombuffer(v, "<f8") if wt == 2
                                     else [struct.unpack("<d", v)[0]])
            elif fn == 11:
                t.uint64_data.extend(_unpack_ints(v, wt))
        return t

    def dump(self) -> bytes:
        o = bytearray()
        if self.dims:
            _emit(o, 1, 2, _packed_ints(self.dims))
        _emit(o, 2, 0, self.data_type)
        if self.name:
            _emit_str(o, 8, self.name)
        if self.raw_data:
            _emit(o, 9, 2, self.raw_data)
        if self.float_data:
            _emit(o, 4, 2, np.asarray(self.float_data, "<f4").tobytes())
        if self.int64_data:
            _emit(o, 7, 2, _packed_ints(self.int64_data))
        if self.int32_data:
            _emit(o, 5, 2, _packed_ints(self.int32_data))
        return bytes(o)


@dataclass
class AttributeProto:
    name: str = ""          # 1
    f: float = 0.0          # 2
    i: int = 0              # 3
    s: bytes = b""          # 4
    t: TensorProto | None = None  # 5
    floats: list = field(default_factory=list)   # 7
    ints: list = field(default_factory=list)     # 8
    strings: list = field(default_factory=list)  # 9
    type: int = 0           # 20

    @staticmethod
    def parse(data: bytes) -> "AttributeProto":
        a = AttributeProto()
        seen_fields = set()
        for fn, wt, v in _scan(data):
            seen_fields.add(fn)
            if fn == 1:
                a.name = v.decode()
            elif fn == 2:
                a.f = struct.unpack("<f", v)[0]
            elif fn == 3:
                a.i = _signed(v)
            elif fn == 4:
                a.s = v
            elif fn == 5:
                a.t = TensorProto.parse(v)
            elif fn == 7:
                a.floats.extend(_unpack_floats(v, wt))
            elif fn == 8:
                a.ints.extend(_unpack_ints(v, wt))
            elif fn == 9:
                a.strings.append(v)
            elif fn == 20:
                a.type = v
        if not a.type:  # exporters may omit; infer from populated field
            if 5 in seen_fields:
                a.type = ATTR.TENSOR
            elif 8 in seen_fields:
                a.type = ATTR.INTS
            elif 7 in seen_fields:
                a.type = ATTR.FLOATS
            elif 9 in seen_fields:
                a.type = ATTR.STRINGS
            elif 4 in seen_fields:
                a.type = ATTR.STRING
            elif 2 in seen_fields:
                a.type = ATTR.FLOAT
            elif 3 in seen_fields:
                a.type = ATTR.INT
        return a

    def dump(self) -> bytes:
        o = bytearray()
        _emit_str(o, 1, self.name)
        if self.type == ATTR.FLOAT:
            _emit(o, 2, 5, struct.pack("<f", self.f))
        elif self.type == ATTR.INT:
            _emit(o, 3, 0, self.i)
        elif self.type == ATTR.STRING:
            _emit(o, 4, 2, self.s)
        elif self.type == ATTR.TENSOR:
            _emit(o, 5, 2, self.t.dump())
        elif self.type == ATTR.FLOATS:
            _emit(o, 7, 2, np.asarray(self.floats, "<f4").tobytes())
        elif self.type == ATTR.INTS:
            _emit(o, 8, 2, _packed_ints(self.ints))
        elif self.type == ATTR.STRINGS:
            for s in self.strings:
                _emit(o, 9, 2, s)
        _emit(o, 20, 0, self.type)
        return bytes(o)


@dataclass
class NodeProto:
    input: list = field(default_factory=list)     # 1
    output: list = field(default_factory=list)    # 2
    name: str = ""                                # 3
    op_type: str = ""                             # 4
    attribute: list = field(default_factory=list)  # 5
    domain: str = ""                              # 7

    @staticmethod
    def parse(data: bytes) -> "NodeProto":
        n = NodeProto()
        for fn, wt, v in _scan(data):
            if fn == 1:
                n.input.append(v.decode())
            elif fn == 2:
                n.output.append(v.decode())
            elif fn == 3:
                n.name = v.decode()
            elif fn == 4:
                n.op_type = v.decode()
            elif fn == 5:
                n.attribute.append(AttributeProto.parse(v))
            elif fn == 7:
                n.domain = v.decode()
        return n

    def dump(self) -> bytes:
        o = bytearray()
        for s in self.input:
            _emit_str(o, 1, s)
        for s in self.output:
            _emit_str(o, 2, s)
        if self.name:
            _emit_str(o, 3, self.name)
        _emit_str(o, 4, self.op_type)
        for a in self.attribute:
            _emit(o, 5, 2, a.dump())
        return bytes(o)


@dataclass
class ValueInfoProto:
    name: str = ""     # 1
    elem_type: int = 1
    shape: list = field(default_factory=list)  # dim_value or dim_param str

    @staticmethod
    def parse(data: bytes) -> "ValueInfoProto":
        vi = ValueInfoProto()
        for fn, wt, v in _scan(data):
            if fn == 1:
                vi.name = v.decode()
            elif fn == 2:  # TypeProto
                for fn2, wt2, v2 in _scan(v):
                    if fn2 == 1:  # tensor_type
                        for fn3, wt3, v3 in _scan(v2):
                            if fn3 == 1:
                                vi.elem_type = v3
                            elif fn3 == 2:  # TensorShapeProto
                                for fn4, wt4, v4 in _scan(v3):
                                    if fn4 == 1:  # Dimension
                                        dim = None
                                        for fn5, wt5, v5 in _scan(v4):
                                            if fn5 == 1:
                                                dim = _signed(v5)
                                            elif fn5 == 2:
                                                dim = v5.decode()
                                        vi.shape.append(dim)
        return vi

    def dump(self) -> bytes:
        dims = bytearray()
        for d in self.shape:
            dd = bytearray()
            if isinstance(d, str):
                _emit_str(dd, 2, d)
            elif d is not None:
                _emit(dd, 1, 0, int(d))
            _emit(dims, 1, 2, bytes(dd))
        tt = bytearray()
        _emit(tt, 1, 0, self.elem_type)
        _emit(tt, 2, 2, bytes(dims))
        tp = bytearray()
        _emit(tp, 1, 2, bytes(tt))
        o = bytearray()
        _emit_str(o, 1, self.name)
        _emit(o, 2, 2, bytes(tp))
        return bytes(o)


@dataclass
class GraphProto:
    node: list = field(default_factory=list)         # 1
    name: str = ""                                   # 2
    initializer: list = field(default_factory=list)  # 5
    input: list = field(default_factory=list)        # 11
    output: list = field(default_factory=list)       # 12

    @staticmethod
    def parse(data: bytes) -> "GraphProto":
        g = GraphProto()
        for fn, wt, v in _scan(data):
            if fn == 1:
                g.node.append(NodeProto.parse(v))
            elif fn == 2:
                g.name = v.decode()
            elif fn == 5:
                g.initializer.append(TensorProto.parse(v))
            elif fn == 11:
                g.input.append(ValueInfoProto.parse(v))
            elif fn == 12:
                g.output.append(ValueInfoProto.parse(v))
        return g

    def dump(self) -> bytes:
        o = bytearray()
        for n in self.node:
            _emit(o, 1, 2, n.dump())
        if self.name:
            _emit_str(o, 2, self.name)
        for t in self.initializer:
            _emit(o, 5, 2, t.dump())
        for vi in self.input:
            _emit(o, 11, 2, vi.dump())
        for vi in self.output:
            _emit(o, 12, 2, vi.dump())
        return bytes(o)


@dataclass
class ModelProto:
    ir_version: int = 8       # 1
    # the JAX package's default, so both codecs write the same bytes
    producer_name: str = "planer_tpu"  # 2
    graph: GraphProto = None  # 7
    opset: int = 13           # 8: OperatorSetId.version

    @staticmethod
    def parse(data: bytes) -> "ModelProto":
        m = ModelProto()
        for fn, wt, v in _scan(data):
            if fn == 1:
                m.ir_version = _signed(v)
            elif fn == 2:
                m.producer_name = v.decode()
            elif fn == 7:
                m.graph = GraphProto.parse(v)
            elif fn == 8:
                for fn2, wt2, v2 in _scan(v):
                    if fn2 == 2:
                        m.opset = _signed(v2)
        return m

    def dump(self) -> bytes:
        o = bytearray()
        _emit(o, 1, 0, self.ir_version)
        _emit_str(o, 2, self.producer_name)
        _emit(o, 7, 2, self.graph.dump())
        ops = bytearray()
        _emit(ops, 2, 0, self.opset)
        _emit(o, 8, 2, bytes(ops))
        return bytes(o)


# ----------------------------------------------------------------- top level
def load_model(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return ModelProto.parse(f.read())


def save_model(model: ModelProto, path: str):
    with open(path, "wb") as f:
        f.write(model.dump())


def to_array(t: TensorProto) -> np.ndarray:
    dt = np.dtype(DTYPES[t.data_type])
    shape = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dt)
    elif t.float_data:
        arr = np.asarray(t.float_data, np.float32).astype(dt, copy=False)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, np.int64).astype(dt, copy=False)
    elif t.int32_data:
        # int32_data also carries int8/uint8/fp16/bf16 payloads per spec;
        # 16-bit floats are stored as uint16 BIT PATTERNS, not values
        raw = np.asarray(t.int32_data, np.int32)
        if t.data_type in (10, 16):
            arr = raw.astype(np.uint16).view(dt)
        else:
            arr = raw.astype(dt, copy=False)
    elif t.double_data:
        arr = np.asarray(t.double_data, np.float64).astype(dt, copy=False)
    elif t.uint64_data:
        arr = np.asarray(t.uint64_data, np.uint64).astype(dt, copy=False)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 0, dt)
    return arr.reshape(shape)


def from_array(a: np.ndarray, name: str = "") -> TensorProto:
    a = np.asarray(a)
    return TensorProto(dims=list(a.shape), data_type=DTYPE_CODE[str(a.dtype)],
                       name=name, raw_data=a.tobytes())
