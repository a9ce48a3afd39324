"""A TensorFlow GraphDef wire codec (reader and writer), no dependencies.

The reference's TF importer parses GraphDef through ``tensorflow``'s
generated ``graph_pb2`` classes; the port speaks the protobuf wire
format itself, on the primitives of ``modelimport/onnx_wire.py``
(``Message``, ``encode``, ``decode``) with a schema table of its own for
the messages a frozen inference graph uses: GraphDef, NodeDef (its
``attr`` map as repeated entry messages), AttrValue (a oneof member set
to zero is kept through ``Message._seen``, so TF's bytes re-encode
bytewise) with ListValue, TensorProto (``tensor_content`` and the typed
``*_val`` fields, packed or not), TensorShapeProto and VersionDef. Field numbers follow the public
``tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape,versions}.proto``; unknown fields are skipped. The writer
lets tests and tools assemble frozen graphs without ``tensorflow``.

``.pbtxt`` text-format graphs are read by ``parse_text``, a small
reader of the protobuf text format over the same schema.
"""

from __future__ import annotations

import re

import numpy as np

from deeplearning4j_tpu_torch.modelimport.onnx_wire import (
    Message,
    decode as _decode,
    encode,
)

__all__ = ["SCHEMA", "Message", "message", "encode", "decode",
           "parse_text", "node_attrs", "make_node", "make_tensor",
           "make_graph", "attr_value", "tensor_to_ndarray", "DT",
           "NP_TO_DT"]

SCHEMA = {
    "GraphDef": {
        1: ("node", "rep_NodeDef"),
        3: ("version", "int"),
        4: ("versions", "VersionDef"),
    },
    "VersionDef": {
        1: ("producer", "int"),
        2: ("min_consumer", "int"),
        3: ("bad_consumers", "rep_int"),
    },
    "NodeDef": {
        1: ("name", "str"),
        2: ("op", "str"),
        3: ("input", "rep_str"),
        4: ("device", "str"),
        5: ("attr", "rep_NodeDef.AttrEntry"),
    },
    "NodeDef.AttrEntry": {
        1: ("key", "str"),
        2: ("value", "AttrValue"),
    },
    "AttrValue": {
        1: ("list", "AttrValue.ListValue"),
        2: ("s", "bytes"),
        3: ("i", "int"),
        4: ("f", "float"),
        5: ("b", "int"),
        6: ("type", "int"),
        7: ("shape", "TensorShapeProto"),
        8: ("tensor", "TensorProto"),
        9: ("placeholder", "str"),
    },
    "AttrValue.ListValue": {
        2: ("s", "rep_bytes"),
        3: ("i", "rep_int"),
        4: ("f", "rep_float"),
        5: ("b", "rep_int"),
        6: ("type", "rep_int"),
        7: ("shape", "rep_TensorShapeProto"),
        8: ("tensor", "rep_TensorProto"),
    },
    "TensorProto": {
        1: ("dtype", "int"),
        2: ("tensor_shape", "TensorShapeProto"),
        3: ("version_number", "int"),
        4: ("tensor_content", "bytes"),
        5: ("float_val", "rep_float"),
        6: ("double_val", "rep_double"),
        7: ("int_val", "rep_int"),
        8: ("string_val", "rep_bytes"),
        10: ("int64_val", "rep_int"),
        11: ("bool_val", "rep_int"),
        13: ("half_val", "rep_int"),
        16: ("uint32_val", "rep_uint"),
        17: ("uint64_val", "rep_uint"),
    },
    "TensorShapeProto": {
        2: ("dim", "rep_TensorShapeProto.Dim"),
        3: ("unknown_rank", "int"),
    },
    "TensorShapeProto.Dim": {
        1: ("size", "int"),
        2: ("name", "str"),
    },
}

#: DataType enum -> numpy dtype (bf16 14 and half 19 are 16-bit patterns,
#: decoded by ``tensor_to_ndarray``)
DT = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
      6: np.int8, 9: np.int64, 10: np.bool_, 19: np.float16}
DT_BFLOAT16, DT_HALF = 14, 19
NP_TO_DT = {"float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5,
            "int8": 6, "int64": 9, "bool": 10, "float16": 19}


def message(type_name, **fields):
    """A TF message of this module's schema."""
    return Message(type_name, SCHEMA, **fields)


def decode(type_name, data):
    """wire bytes -> a TF Message (unknown fields skipped)."""
    return _decode(type_name, bytes(data), SCHEMA)


def node_attrs(node):
    """A NodeDef's attr map as {name: AttrValue}."""
    return {e.key: e.value for e in node.attr}


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def _bf16_to_f32(bits):
    """uint16 bfloat16 patterns -> float32: the bits are the float32's
    top half."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def tensor_to_ndarray(tp):
    """TensorProto -> numpy (reference: ``_tensor_to_ndarray``): from
    ``tensor_content`` or the typed field, a single typed value
    broadcast over a non-scalar shape. DT_BFLOAT16 decodes to its exact
    float32 widening (numpy has no bf16 here), DT_HALF to float16; both
    from their 16-bit patterns."""
    shape = tuple(int(d.size) for d in tp.tensor_shape.dim) \
        if tp.tensor_shape is not None else ()
    if tp.dtype in (DT_BFLOAT16, DT_HALF):
        if tp.tensor_content:
            bits = np.frombuffer(tp.tensor_content, np.uint16)
        else:
            bits = np.asarray(tp.half_val, np.int64).astype(np.uint16)
        arr = _bf16_to_f32(bits) if tp.dtype == DT_BFLOAT16 \
            else bits.view(np.float16)
        return _shaped(arr, shape)
    dtype = DT.get(tp.dtype)
    if dtype is None:
        raise ValueError(f"unsupported TensorProto dtype {tp.dtype}")
    if tp.tensor_content:
        return np.frombuffer(tp.tensor_content,
                             dtype=dtype).reshape(shape).copy()
    for field in ("float_val", "double_val", "int_val", "int64_val",
                  "bool_val"):
        vals = getattr(tp, field)
        if vals:
            return _shaped(np.asarray(vals).astype(dtype), shape)
    return np.zeros(shape, dtype=dtype)


def _shaped(arr, shape):
    if shape and arr.size == 1:
        return np.full(shape, arr.reshape(-1)[0], dtype=arr.dtype)
    return arr.reshape(shape) if shape else arr.reshape(())


def make_tensor(array, dtype=None):
    """numpy array -> TensorProto in ``tensor_content`` (little-endian);
    `dtype` "bfloat16" writes float32 values as bf16 patterns (rounded to
    nearest even)."""
    arr = np.ascontiguousarray(array)
    shape = message("TensorShapeProto", dim=[
        message("TensorShapeProto.Dim", size=int(d)) for d in arr.shape])
    if dtype == "bfloat16":
        u = arr.astype(np.float32).view(np.uint32).astype(np.uint64)
        bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        return message("TensorProto", dtype=DT_BFLOAT16, tensor_shape=shape,
                       tensor_content=bits.tobytes())
    return message("TensorProto", dtype=NP_TO_DT[arr.dtype.name],
                   tensor_shape=shape, tensor_content=arr.tobytes())


def attr_value(v):
    """A Python value -> AttrValue: bool -> b, int -> i, float -> f,
    str/bytes -> s, numpy array -> tensor, a list of ints/floats/
    strings -> list, ("type", n) -> type, ("shape", dims) -> shape."""
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "type":
        return message("AttrValue", type=int(v[1]))
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "shape":
        return message("AttrValue", shape=message("TensorShapeProto", dim=[
            message("TensorShapeProto.Dim", size=int(d)) for d in v[1]]))
    if isinstance(v, bool):
        return message("AttrValue", b=int(v))
    if isinstance(v, int):
        return message("AttrValue", i=v)
    if isinstance(v, float):
        return message("AttrValue", f=v)
    if isinstance(v, str):
        return message("AttrValue", s=v.encode("utf-8"))
    if isinstance(v, bytes):
        return message("AttrValue", s=v)
    if isinstance(v, np.ndarray):
        return message("AttrValue", tensor=make_tensor(v))
    if isinstance(v, list):
        lv = message("AttrValue.ListValue")
        if all(isinstance(x, (int, np.integer)) for x in v):
            lv.i = [int(x) for x in v]
        elif all(isinstance(x, (float, int)) for x in v):
            lv.f = [float(x) for x in v]
        else:
            lv.s = [x.encode("utf-8") if isinstance(x, str) else x
                    for x in v]
        return message("AttrValue", list=lv)
    raise TypeError(f"no AttrValue for {v!r}")


def make_node(op, name, inputs=(), **attrs):
    """A NodeDef; attrs through ``attr_value`` (an AttrValue passes)."""
    return message("NodeDef", name=name, op=op, input=list(inputs), attr=[
        message("NodeDef.AttrEntry", key=k,
                value=v if isinstance(v, Message) else attr_value(v))
        for k, v in attrs.items()])


def make_graph(nodes, producer=0):
    return message("GraphDef", node=list(nodes),
                   versions=message("VersionDef", producer=producer))


# ---------------------------------------------------------------------------
# the protobuf text format (.pbtxt)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r'''
    \s+ | \#[^\n]* |
    (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*') |
    (?P<punct>[{}\[\]:<>,;]) |
    (?P<word>[^\s{}\[\]:<>,;"']+)''', re.VERBOSE)

_ESCAPES = {"n": 10, "t": 9, "r": 13, "\\": 92, "'": 39, '"': 34, "a": 7,
            "b": 8, "f": 12, "v": 11}


def _unescape(body):
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        n = body[i + 1]
        if n in "01234567":
            j = i + 1
            while j < min(i + 4, len(body)) and body[j] in "01234567":
                j += 1
            out.append(int(body[i + 1:j], 8) & 0xFF)
            i = j
        elif n in "xX":
            j = i + 2
            while j < min(i + 4, len(body)) and \
                    body[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(int(body[i + 2:j], 16))
            i = j
        else:
            out.append(_ESCAPES[n])
            i += 2
    return bytes(out)


def _tokens(text):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"pbtxt: cannot read at {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.group("str"):
            yield ("str", _unescape(m.group("str")[1:-1]))
        elif m.group("punct"):
            yield ("punct", m.group("punct"))
        elif m.group("word"):
            yield ("word", m.group("word"))


#: enum names the text format may use for int fields
_ENUMS = {"DT_FLOAT": 1, "DT_DOUBLE": 2, "DT_INT32": 3, "DT_UINT8": 4,
          "DT_INT16": 5, "DT_INT8": 6, "DT_STRING": 7, "DT_INT64": 9,
          "DT_BOOL": 10, "DT_BFLOAT16": 14, "DT_HALF": 19,
          "true": 1, "false": 0, "True": 1, "False": 0}


def _scalar(kind, tok):
    t, v = tok
    if kind in ("str", "rep_str"):
        return v.decode("utf-8") if t == "str" else v
    if kind in ("bytes", "rep_bytes"):
        return v if t == "str" else v.encode("utf-8")
    if kind in ("float", "rep_float", "rep_double"):
        return float(v.rstrip("fF")) if v not in ("inf", "-inf", "nan") \
            else float(v)
    if v in _ENUMS:
        return _ENUMS[v]
    return int(v, 0)


def parse_text(type_name, text):
    """Protobuf text format -> a TF Message (reference: ``.pbtxt``
    graphs through ``google.protobuf.text_format``). Unknown fields
    raise."""
    toks = list(_tokens(text))
    msg, pos = _parse_fields(type_name, toks, 0, None)
    if pos != len(toks):
        raise ValueError("pbtxt: unexpected trailing tokens")
    return msg


def _parse_fields(type_name, toks, pos, close):
    msg = message(type_name)
    by_name = {fname: kind for fname, kind in SCHEMA[type_name].values()}
    while pos < len(toks):
        t, v = toks[pos]
        if t == "punct" and v == close:
            return msg, pos + 1
        if t != "word" or v not in by_name:
            raise ValueError(f"pbtxt: unknown field {v!r} in {type_name}")
        kind = by_name[v]
        pos += 1
        msg._seen.add(v)
        sub = kind[4:] if kind.startswith("rep_") else kind
        if sub in SCHEMA:
            if toks[pos] == ("punct", ":"):
                pos += 1
            opener = toks[pos][1]
            closer = {"{": "}", "<": ">"}[opener]
            val, pos = _parse_fields(sub, toks, pos + 1, closer)
            if kind.startswith("rep_"):
                getattr(msg, v).append(val)
            else:
                setattr(msg, v, val)
        else:
            if toks[pos] != ("punct", ":"):
                raise ValueError(f"pbtxt: ':' expected after {v!r}")
            pos += 1
            if toks[pos] == ("punct", "["):
                pos += 1
                while toks[pos] != ("punct", "]"):
                    if toks[pos] == ("punct", ","):
                        pos += 1
                        continue
                    getattr(msg, v).append(_scalar(kind, toks[pos]))
                    pos += 1
                pos += 1
            elif kind.startswith("rep_"):
                getattr(msg, v).append(_scalar(kind, toks[pos]))
                pos += 1
            else:
                setattr(msg, v, _scalar(kind, toks[pos]))
                pos += 1
        if pos < len(toks) and toks[pos] in (("punct", ","),
                                             ("punct", ";")):
            pos += 1
    if close is not None:
        raise ValueError(f"pbtxt: {close!r} expected")
    return msg, pos
