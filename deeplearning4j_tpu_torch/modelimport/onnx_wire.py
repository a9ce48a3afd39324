"""Minimal ONNX protobuf wire codec (reader AND writer), no dependencies.

The port's own copy of ``deeplearning4j_tpu/modelimport/onnx_wire.py``
(it imports nothing of the JAX package): the same schema table, reader
and writer, so a model written by either copy is the same bytes. The
reference's ONNX import path (nd4j-api
org.nd4j.imports.graphmapper.onnx.OnnxGraphMapper + onnx.proto) parses
ModelProto files via generated protobuf classes; neither the `onnx`
package nor its generated classes are needed here: this module speaks the
protobuf wire format directly for the subset of onnx.proto that
inference model files use: ModelProto / GraphProto / NodeProto /
AttributeProto / TensorProto / ValueInfoProto / TypeProto /
TensorShapeProto / OperatorSetIdProto.

Field numbers follow the public onnx.proto schema (onnx/onnx.proto in
the ONNX repo — stable since IR version 3; proto field numbers are
frozen by protobuf compatibility rules). Unknown fields are skipped on
read, so files produced by any ONNX exporter parse as long as they only
*use* ops the mapper supports. The writer exists so tests can assemble
real ONNX files (and users can round-trip graphs) without the onnx
package; reader and writer share one schema table, and the tests
cross-check the codec against byte sequences hand-assembled from the
wire-format spec.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# schema: message name -> {field number: (field name, kind)}
# kinds:  int        signed 64-bit varint
#         str        length-delimited utf-8
#         bytes      length-delimited raw
#         float      fixed32
#         rep_int    repeated int64 (accepts packed or unpacked; writes packed)
#         rep_uint   repeated uint64 (same, but no sign reinterpretation)
#         rep_float  repeated float (same)
#         rep_double repeated double (same)
#         rep_str    repeated string
#         rep_bytes  repeated bytes
#         Name       embedded message
#         rep_Name   repeated embedded message
# ---------------------------------------------------------------------------

SCHEMA = {
    "ModelProto": {
        1: ("ir_version", "int"),
        2: ("producer_name", "str"),
        3: ("producer_version", "str"),
        4: ("domain", "str"),
        5: ("model_version", "int"),
        6: ("doc_string", "str"),
        7: ("graph", "GraphProto"),
        8: ("opset_import", "rep_OperatorSetIdProto"),
    },
    "OperatorSetIdProto": {
        1: ("domain", "str"),
        2: ("version", "int"),
    },
    "GraphProto": {
        1: ("node", "rep_NodeProto"),
        2: ("name", "str"),
        5: ("initializer", "rep_TensorProto"),
        10: ("doc_string", "str"),
        11: ("input", "rep_ValueInfoProto"),
        12: ("output", "rep_ValueInfoProto"),
        13: ("value_info", "rep_ValueInfoProto"),
    },
    "NodeProto": {
        1: ("input", "rep_str"),
        2: ("output", "rep_str"),
        3: ("name", "str"),
        4: ("op_type", "str"),
        5: ("attribute", "rep_AttributeProto"),
        6: ("doc_string", "str"),
        7: ("domain", "str"),
    },
    "AttributeProto": {
        1: ("name", "str"),
        2: ("f", "float"),
        3: ("i", "int"),
        4: ("s", "bytes"),
        5: ("t", "TensorProto"),
        6: ("g", "GraphProto"),
        7: ("floats", "rep_float"),
        8: ("ints", "rep_int"),
        9: ("strings", "rep_bytes"),
        10: ("tensors", "rep_TensorProto"),
        20: ("type", "int"),
    },
    "TensorProto": {
        1: ("dims", "rep_int"),
        2: ("data_type", "int"),
        4: ("float_data", "rep_float"),
        5: ("int32_data", "rep_int"),
        6: ("string_data", "rep_bytes"),
        7: ("int64_data", "rep_int"),
        8: ("name", "str"),
        9: ("raw_data", "bytes"),
        10: ("double_data", "rep_double"),
        11: ("uint64_data", "rep_uint"),
    },
    "ValueInfoProto": {
        1: ("name", "str"),
        2: ("type", "TypeProto"),
        3: ("doc_string", "str"),
    },
    "TypeProto": {
        1: ("tensor_type", "TypeProto.Tensor"),
    },
    "TypeProto.Tensor": {
        1: ("elem_type", "int"),
        2: ("shape", "TensorShapeProto"),
    },
    "TensorShapeProto": {
        1: ("dim", "rep_TensorShapeProto.Dimension"),
    },
    "TensorShapeProto.Dimension": {
        1: ("dim_value", "int"),
        2: ("dim_param", "str"),
    },
}

# AttributeProto.AttributeType values (onnx.proto enum)
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS, ATTR_TENSORS = 6, 7, 8, 9


class Message:
    """A decoded protobuf message: fields as attributes, repeated -> list.
    `schema` is the table the message's type is in (ONNX's unless
    another is given, as ``tf_wire`` gives TensorFlow's); ``_seen``
    holds the names of the fields a decode read (a oneof's member)."""

    def __init__(self, type_name, schema=None, **fields):
        schema = SCHEMA if schema is None else schema
        if type_name not in schema:
            raise ValueError(f"unknown message type {type_name!r}")
        self._type = type_name
        self._schema = schema
        self._seen = set()
        for _num, (fname, kind) in schema[type_name].items():
            if kind.startswith("rep_"):
                setattr(self, fname, [])
            elif kind in ("int", "float"):
                setattr(self, fname, 0)
            elif kind == "str":
                setattr(self, fname, "")
            elif kind == "bytes":
                setattr(self, fname, b"")
            else:  # embedded message: absent until set
                setattr(self, fname, None)
        for k, v in fields.items():
            if not hasattr(self, k):
                raise ValueError(f"{type_name} has no field {k!r}")
            setattr(self, k, v)

    def __repr__(self):
        set_fields = {k: v for k, v in vars(self).items()
                      if not k.startswith("_") and v not in (None, [], "", b"", 0)}
        return f"{self._type}({', '.join(f'{k}={v!r}' for k, v in set_fields.items())})"


# ---------------------------------------------------------------------------
# varint / wire primitives
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _write_varint(out, value):
    value &= _MASK64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data, pos):
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed(value):
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field_num, wire_type):
    return (field_num << 3) | wire_type


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(msg):
    """Message -> wire bytes."""
    out = bytearray()
    for num, (fname, kind) in sorted(msg._schema[msg._type].items()):
        val = getattr(msg, fname)
        # a zero scalar is written only where a decode read it (a oneof
        # member set to its default)
        put = bool(val) or fname in msg._seen
        if kind == "int":
            if put:
                _write_varint(out, _tag(num, 0))
                _write_varint(out, val)
        elif kind == "float":
            if put:
                _write_varint(out, _tag(num, 5))
                out += struct.pack("<f", val)
        elif kind == "str":
            if put:
                _emit_len(out, num, val.encode("utf-8"))
        elif kind == "bytes":
            if put:
                _emit_len(out, num, bytes(val))
        elif kind in ("rep_int", "rep_uint"):
            if val:
                packed = bytearray()
                for v in val:
                    _write_varint(packed, int(v))
                _emit_len(out, num, bytes(packed))
        elif kind == "rep_float":
            if val:
                _emit_len(out, num, struct.pack(f"<{len(val)}f", *val))
        elif kind == "rep_double":
            if val:
                _emit_len(out, num, struct.pack(f"<{len(val)}d", *val))
        elif kind == "rep_str":
            for v in val:
                _emit_len(out, num, v.encode("utf-8"))
        elif kind == "rep_bytes":
            for v in val:
                _emit_len(out, num, bytes(v))
        elif kind.startswith("rep_"):
            for v in val:
                _emit_len(out, num, encode(v))
        else:  # embedded message
            if val is not None:
                _emit_len(out, num, encode(val))
    return bytes(out)


def _emit_len(out, num, payload):
    _write_varint(out, _tag(num, 2))
    _write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def decode(type_name, data, schema=None):
    """wire bytes -> Message of `schema` (ONNX's unless given; unknown
    fields skipped)."""
    schema = SCHEMA if schema is None else schema
    msg = Message(type_name, schema)
    fields = schema[type_name]
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 0x7
        spec = fields.get(num)
        if spec is None:
            pos = _skip(data, pos, wt)
            continue
        fname, kind = spec
        msg._seen.add(fname)
        if wt == 0:  # varint
            raw, pos = _read_varint(data, pos)
            if kind == "int":
                setattr(msg, fname, _signed(raw))
            elif kind == "rep_int":
                getattr(msg, fname).append(_signed(raw))
            elif kind == "rep_uint":
                getattr(msg, fname).append(raw)
            elif kind == "float":  # malformed; tolerate as int bits
                setattr(msg, fname, float(raw))
            else:
                pass  # wrong wire type for field: ignore
        elif wt == 5:  # fixed32
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32")
            raw = struct.unpack_from("<f", data, pos)[0]
            pos += 4
            if kind == "float":
                setattr(msg, fname, raw)
            elif kind == "rep_float":
                getattr(msg, fname).append(raw)
        elif wt == 1:  # fixed64
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64")
            raw = struct.unpack_from("<d", data, pos)[0]
            pos += 8
            if kind == "rep_double":
                getattr(msg, fname).append(raw)
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            if pos + ln > len(data):
                raise ValueError(f"truncated field {fname} ({ln} bytes)")
            payload = data[pos:pos + ln]
            pos += ln
            if kind == "str":
                setattr(msg, fname, payload.decode("utf-8"))
            elif kind == "bytes":
                setattr(msg, fname, bytes(payload))
            elif kind == "rep_str":
                getattr(msg, fname).append(payload.decode("utf-8"))
            elif kind == "rep_bytes":
                getattr(msg, fname).append(bytes(payload))
            elif kind in ("rep_int", "rep_uint"):  # packed
                p = 0
                dst = getattr(msg, fname)
                signed = kind == "rep_int"
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    dst.append(_signed(v) if signed else v)
            elif kind == "rep_float":  # packed
                getattr(msg, fname).extend(
                    struct.unpack(f"<{len(payload) // 4}f", payload))
            elif kind == "rep_double":
                getattr(msg, fname).extend(
                    struct.unpack(f"<{len(payload) // 8}d", payload))
            elif kind.startswith("rep_"):
                getattr(msg, fname).append(decode(kind[4:], payload,
                                                  schema))
            elif kind in ("int", "float"):
                pass  # wrong wire type: ignore
            else:  # embedded message
                setattr(msg, fname, decode(kind, payload, schema))
        else:
            raise ValueError(f"unsupported wire type {wt} in {type_name}")
    return msg


def _skip(data, pos, wire_type):
    if wire_type == 0:
        _, pos = _read_varint(data, pos)
        return pos
    if wire_type == 1:
        return pos + 8
    if wire_type == 5:
        return pos + 4
    if wire_type == 2:
        ln, pos = _read_varint(data, pos)
        return pos + ln
    raise ValueError(f"cannot skip wire type {wire_type}")


# ---------------------------------------------------------------------------
# builder helpers (mirror onnx.helper's make_* API so test/export code reads
# like standard ONNX assembly)
# ---------------------------------------------------------------------------

# numpy dtype -> TensorProto.DataType enum
NP_TO_ONNX = {
    "float32": 1, "uint8": 2, "int8": 3, "uint16": 4, "int16": 5,
    "int32": 6, "int64": 7, "bool": 9, "float16": 10, "float64": 11,
    "uint32": 12, "uint64": 13, "bfloat16": 16,
}


def make_tensor(name, array):
    """numpy array -> TensorProto (raw_data encoding, little-endian)."""
    import numpy as np

    arr = np.ascontiguousarray(array)
    dt = NP_TO_ONNX.get(arr.dtype.name)
    if dt is None:
        raise ValueError(f"no ONNX dtype for numpy {arr.dtype}")
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return Message("TensorProto", name=name, dims=list(arr.shape),
                   data_type=dt, raw_data=arr.tobytes())


def make_attribute(name, value):
    """Python value -> AttributeProto, dispatching on type like onnx.helper."""
    import numpy as np

    a = Message("AttributeProto", name=name)
    if isinstance(value, float):
        a.f, a.type = value, ATTR_FLOAT
    elif isinstance(value, bool):
        a.i, a.type = int(value), ATTR_INT
    elif isinstance(value, int):
        a.i, a.type = value, ATTR_INT
    elif isinstance(value, str):
        a.s, a.type = value.encode("utf-8"), ATTR_STRING
    elif isinstance(value, bytes):
        a.s, a.type = value, ATTR_STRING
    elif isinstance(value, np.ndarray):
        a.t, a.type = make_tensor(name, value), ATTR_TENSOR
    elif isinstance(value, Message) and value._type == "TensorProto":
        a.t, a.type = value, ATTR_TENSOR
    elif isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, (int, np.integer)) for v in vals):
            a.ints, a.type = [int(v) for v in vals], ATTR_INTS
        elif all(isinstance(v, (int, float, np.floating)) for v in vals):
            a.floats, a.type = [float(v) for v in vals], ATTR_FLOATS
        elif all(isinstance(v, str) for v in vals):
            a.strings = [v.encode("utf-8") for v in vals]
            a.type = ATTR_STRINGS
        else:
            raise ValueError(f"mixed-type attribute list for {name!r}")
    else:
        raise ValueError(f"cannot infer attribute type for {name!r}: "
                         f"{type(value).__name__}")
    return a


def make_node(op_type, inputs, outputs, name="", **attrs):
    return Message(
        "NodeProto", op_type=op_type, input=list(inputs),
        output=list(outputs), name=name or f"{op_type}_{outputs[0]}",
        attribute=[make_attribute(k, v) for k, v in attrs.items()])


def make_value_info(name, dtype, shape):
    """name + numpy dtype + shape tuple -> ValueInfoProto (None dim -> dim_param)."""
    import numpy as np

    dims = []
    for i, d in enumerate(shape):
        if d is None or (isinstance(d, int) and d < 0):
            dims.append(Message("TensorShapeProto.Dimension",
                                dim_param=f"dyn_{i}"))
        else:
            dims.append(Message("TensorShapeProto.Dimension",
                                dim_value=int(d)))
    tt = Message("TypeProto.Tensor",
                 elem_type=NP_TO_ONNX[np.dtype(dtype).name],
                 shape=Message("TensorShapeProto", dim=dims))
    return Message("ValueInfoProto", name=name,
                   type=Message("TypeProto", tensor_type=tt))


def make_graph(nodes, name, inputs, outputs, initializers=()):
    return Message("GraphProto", node=list(nodes), name=name,
                   input=list(inputs), output=list(outputs),
                   initializer=list(initializers))


def make_model(graph, opset=17, producer="deeplearning4j_tpu"):
    return Message(
        "ModelProto", ir_version=8, producer_name=producer, graph=graph,
        opset_import=[Message("OperatorSetIdProto", domain="",
                              version=int(opset))])
