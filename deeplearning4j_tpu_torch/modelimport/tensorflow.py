"""TF frozen-graph (GraphDef) import into SameDiff.

The counterpart of ``deeplearning4j_tpu/modelimport/tensorflow.py``
(reference: nd4j-api org.nd4j.imports.graphmapper.tf.TFGraphMapper):
the same op table maps a frozen GraphDef's nodes onto SameDiff ops, so
the imported model runs, differentiates and serializes like a natively
built graph, on the card unless the caller asks for the CPU.

Scope (the reference's): Placeholder, Const, Identity/StopGradient,
Conv2D (VALID, SAME, EXPLICIT), DepthwiseConv2dNative, BiasAdd,
FusedBatchNorm(V2/V3), Relu, Relu6, LeakyRelu, Sigmoid, Tanh, Softmax,
MaxPool, AvgPool, Mean, MatMul, Add/AddV2/AddN, Sub, Mul, RealDiv,
Maximum, Minimum, Pow, Rsqrt, Sqrt, Exp, Log, Neg, Square, Abs, Reshape,
Squeeze, Pad/PadV2, ConcatV2, Cast, NoOp. NHWC only (NCHW graphs raise);
anything else raises ``TFImportException`` with the node and op.

Parsing: the reference reads GraphDef through ``tensorflow``'s
``graph_pb2``; the port reads it with its own wire codec
(``modelimport/tf_wire.py``), which also reads ``.pbtxt`` text. A
DT_BFLOAT16 constant decodes from its bit patterns with no
``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.modelimport import tf_wire as wire
from deeplearning4j_tpu_torch.modelimport.onnx import _same_pads
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy

__all__ = ["TFGraphMapper", "TFImportException", "importFrozenTF"]


class TFImportException(ValueError):
    pass


_TORCH = {1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8,
          5: torch.int16, 6: torch.int8, 9: torch.int64, 10: torch.bool,
          14: torch.bfloat16, 19: torch.float16}


def _graph_def_from(source):
    """A GraphDef Message, serialized bytes, or a .pb/.pbtxt path."""
    if isinstance(source, wire.Message):
        if source._type != "GraphDef":
            raise TFImportException(f"expected GraphDef, got {source._type}")
        return source
    if isinstance(source, (bytes, bytearray)):
        return wire.decode("GraphDef", source)
    path = str(source)
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith((".pbtxt", ".pbtext")):
        return wire.parse_text("GraphDef", data.decode("utf-8"))
    return wire.decode("GraphDef", data)


def _tensor_to_torch(tp):
    """TensorProto -> a CPU tensor of its dtype (bf16 bit for bit)."""
    if tp.dtype not in _TORCH:
        raise TFImportException(f"unsupported TensorProto dtype {tp.dtype}")
    arr = wire.tensor_to_ndarray(tp)
    return torch.from_numpy(np.array(arr, copy=True)).reshape(
        arr.shape).to(_TORCH[tp.dtype])


def _attr(node, name, default=None):
    return wire.node_attrs(node).get(name, default)


def _require_attr(node, name):
    """Attrs a node is meaningless without (strides, ksize, value)."""
    a = _attr(node, name)
    if a is None:
        raise TFImportException(
            f"node '{node.name}' ({node.op}) is missing required "
            f"attribute '{name}'")
    return a


def _require_nhwc(node):
    a = _attr(node, "data_format")
    fmt = a.s.decode() if (a is not None and a.s) else "NHWC"
    if fmt != "NHWC":
        raise TFImportException(
            f"node '{node.name}' ({node.op}) uses data_format={fmt}; only "
            "NHWC graphs are supported (TF's CPU freezing default)")


def _conv_padding(node, xshape, k, s, d=(1, 1)):
    a = _attr(node, "padding")
    p = a.s.decode() if (a is not None and a.s) else "VALID"
    if p == "VALID":
        return ((0, 0), (0, 0))
    if p == "SAME":
        return _same_pads(xshape[1], xshape[2], k, s, d)
    if p == "EXPLICIT":
        ep = list(_require_attr(node, "explicit_paddings").list.i)
        return ((ep[2], ep[3]), (ep[4], ep[5]))  # NHWC: [b,b,h,h,w,w,c,c]
    raise TFImportException(f"node '{node.name}': unsupported padding {p!r}")


def _hw(list_attr):
    v = list(list_attr.list.i)
    return (v[1], v[2])  # NHWC [1, h, w, 1]


class TFGraphMapper:
    """importGraph(frozen GraphDef) -> SameDiff (reference:
    TFGraphMapper)."""

    @staticmethod
    def importGraph(source, inputShapes=None, device=None):
        """`inputShapes`: {placeholderName: shape} filling unknown dims
        (placeholders routinely have batch -1; the graph's shapes are
        static). The graph lives on `device`: the card unless the caller
        asks for the CPU."""
        from deeplearning4j_tpu_torch.autodiff.ops_impl import OPS

        gd = _graph_def_from(source)
        sd = SameDiff.create(device)
        vars_ = {}   # tf node name -> SDVariable
        meta = {}    # SDVariable name -> meta tensor (shape and dtype)

        def emit(opName, inputs, kwargs=None):
            v = sd._op(opName, inputs, kwargs)
            try:
                with torch.no_grad():
                    out = OPS[opName](*[meta[i.name] for i in inputs],
                                      **(kwargs or {}))
                meta[v.name] = out[0] if isinstance(out, (list, tuple)) \
                    else out
            except Exception:
                pass  # best-effort; shape_of falls back to the variable
            return v

        def shape_of(v):
            m = meta.get(v.name)
            return tuple(m.shape) if m is not None else tuple(v.shape)

        def get(ref):
            name = ref.lstrip("^")
            if ":" in name:
                base, idx = name.rsplit(":", 1)
                if idx != "0":
                    raise TFImportException(
                        f"reference '{ref}': only output 0 of multi-output "
                        "nodes is supported (FusedBatchNorm etc. expose y)")
                name = base
            if name not in vars_:
                raise TFImportException(f"reference to unknown node '{name}'")
            return vars_[name]

        def const_value(ref):
            v = get(ref)
            arr = sd._arrays.get(v.name)
            if arr is None:
                raise TFImportException(
                    f"'{ref}' must be a Const (structural argument)")
            return to_numpy(arr)

        for node in gd.node:
            op = node.op
            ins = [i for i in node.input if not i.startswith("^")]
            if op == "NoOp":
                continue
            if op == "Placeholder":
                shape = None
                if inputShapes and node.name in inputShapes:
                    shape = tuple(int(x) for x in inputShapes[node.name])
                else:
                    a = _attr(node, "shape")
                    if a is not None and a.shape is not None \
                            and not a.shape.unknown_rank:
                        shape = tuple(int(d.size) for d in a.shape.dim)
                if shape is None or any(s < 0 for s in shape):
                    raise TFImportException(
                        f"placeholder '{node.name}' has unknown dims "
                        f"{shape}; pass inputShapes={{'{node.name}': "
                        "(...)}} (the graph's shapes are static)")
                da = _attr(node, "dtype")
                dt = _TORCH.get(da.type, torch.float32) if da is not None \
                    else torch.float32
                v = sd.placeHolder(node.name, dt, *shape)
                vars_[node.name] = v
                meta[v.name] = torch.empty(shape, dtype=dt, device="meta")
                continue
            if op == "Const":
                t = _tensor_to_torch(_require_attr(node, "value").tensor)
                v = sd.constant(t, node.name)
                vars_[node.name] = v
                meta[v.name] = torch.empty(t.shape, dtype=t.dtype,
                                           device="meta")
                continue
            if op in ("Identity", "StopGradient"):
                vars_[node.name] = emit("identity", [get(ins[0])])
                continue
            if op in ("Conv2D", "DepthwiseConv2dNative"):
                _require_nhwc(node)
                x, w = get(ins[0]), get(ins[1])
                s = _hw(_require_attr(node, "strides"))
                dil_a = _attr(node, "dilations")
                d = _hw(dil_a) if dil_a is not None else (1, 1)
                kshp = shape_of(w)
                pad = _conv_padding(node, shape_of(x), kshp[:2], s, d)
                kw = {"stride": s, "padding": pad, "dilation": d}
                if op == "DepthwiseConv2dNative":
                    # TF's (kh,kw,Cin,mult) -> the grouped (kh,kw,1,Cin*mult)
                    kh, kwd, cin, mult = kshp
                    w = emit("reshape", [w],
                             {"shape": [kh, kwd, 1, cin * mult]})
                    kw["groups"] = int(cin)
                vars_[node.name] = emit("conv2d", [x, w], kw)
                continue
            if op == "BiasAdd":
                _require_nhwc(node)
                vars_[node.name] = emit("add", [get(ins[0]), get(ins[1])])
                continue
            if op in ("FusedBatchNorm", "FusedBatchNormV2",
                      "FusedBatchNormV3"):
                _require_nhwc(node)
                t = _attr(node, "is_training")
                if t is not None and t.b:
                    raise TFImportException(
                        f"node '{node.name}': is_training=true — freeze the "
                        "graph for inference import")
                ea = _attr(node, "epsilon")
                eps = float(ea.f) if ea is not None else 1e-4  # proto default
                x, gamma, beta, mean, var = (get(i) for i in ins[:5])
                vars_[node.name] = emit(
                    "batchNorm", [x, mean, var, gamma, beta],
                    {"epsilon": eps, "axis": -1})
                continue
            if op in ("MaxPool", "AvgPool"):
                _require_nhwc(node)
                x = get(ins[0])
                k = _hw(_require_attr(node, "ksize"))
                s = _hw(_require_attr(node, "strides"))
                pad = _conv_padding(node, shape_of(x), k, s)
                kw = {"kernel": k, "stride": s, "padding": pad}
                if op == "AvgPool":
                    # TF divides border windows by their real cells
                    kw["count_include_pad"] = False
                vars_[node.name] = emit(
                    "maxPooling2d" if op == "MaxPool" else "avgPooling2d",
                    [x], kw)
                continue
            if op == "MatMul":
                ta, tb = _attr(node, "transpose_a"), _attr(node, "transpose_b")
                vars_[node.name] = emit(
                    "mmul", [get(ins[0]), get(ins[1])],
                    {"transposeA": bool(ta.b) if ta else False,
                     "transposeB": bool(tb.b) if tb else False})
                continue
            if op in ("Add", "AddV2"):
                vars_[node.name] = emit("add", [get(ins[0]), get(ins[1])])
                continue
            if op == "AddN":
                acc = get(ins[0])
                for r in ins[1:]:
                    acc = emit("add", [acc, get(r)])
                vars_[node.name] = emit("identity", [acc])
                continue
            if op in ("Sub", "Mul", "RealDiv", "Maximum", "Minimum", "Pow"):
                nm = {"Sub": "sub", "Mul": "mul", "RealDiv": "div",
                      "Maximum": "maximum", "Minimum": "minimum",
                      "Pow": "pow"}[op]
                vars_[node.name] = emit(nm, [get(ins[0]), get(ins[1])])
                continue
            if op in ("Rsqrt", "Sqrt", "Exp", "Log", "Neg", "Square", "Abs",
                      "Relu", "Sigmoid", "Tanh", "Softmax"):
                vars_[node.name] = emit(op.lower(), [get(ins[0])])
                continue
            if op == "Relu6":
                vars_[node.name] = emit(
                    "clipByValue", [get(ins[0])],
                    {"clipValueMin": 0.0, "clipValueMax": 6.0})
                continue
            if op == "LeakyRelu":
                a = _attr(node, "alpha")
                vars_[node.name] = emit(
                    "leakyRelu", [get(ins[0])],
                    {"alpha": float(a.f) if a else 0.2})
                continue
            if op == "Reshape":
                shape = [int(v) for v in const_value(ins[1])]
                vars_[node.name] = emit("reshape", [get(ins[0])],
                                        {"shape": shape})
                continue
            if op == "Squeeze":
                sa = _attr(node, "squeeze_dims")
                dims = list(sa.list.i) if sa is not None \
                    and sa.list is not None else []
                vars_[node.name] = emit(
                    "squeeze", [get(ins[0])],
                    {"axis": tuple(int(d) for d in dims) if dims else None})
                continue
            if op in ("Pad", "PadV2"):
                kw = {"padding": const_value(ins[1]).tolist()}
                if op == "PadV2" and len(ins) > 2:
                    kw["constant"] = float(const_value(ins[2]))
                vars_[node.name] = emit("pad", [get(ins[0])], kw)
                continue
            if op == "ConcatV2":
                axis = int(const_value(ins[-1]))
                vars_[node.name] = emit(
                    "concat", [get(i) for i in ins[:-1]], {"dimension": axis})
                continue
            if op == "Mean":
                axes = np.atleast_1d(const_value(ins[1])).tolist()
                kd = _attr(node, "keep_dims")
                vars_[node.name] = emit(
                    "mean", [get(ins[0])],
                    {"dimensions": [int(a) for a in axes],
                     "keepDims": bool(kd.b) if kd else False})
                continue
            if op == "Cast":
                dt = _TORCH.get(_require_attr(node, "DstT").type)
                if dt is None:
                    raise TFImportException(
                        f"node '{node.name}': unsupported Cast target")
                vars_[node.name] = emit(
                    "cast", [get(ins[0])], {"dtype": str(dt).split(".")[-1]})
                continue
            raise TFImportException(
                f"unsupported TF op '{op}' (node '{node.name}'); supported "
                "subset is documented in modelimport.tensorflow")
        sd._tf_vars = vars_  # tf node name -> SDVariable (introspection)
        return sd

    @staticmethod
    def outputVariable(sd, tfName):
        """The SDVariable for a TF node name in an imported graph."""
        return sd._tf_vars[tfName.split(":")[0]]


def importFrozenTF(source, inputShapes=None, device=None):
    """Convenience wrapper (reference: TFGraphMapper.importGraph)."""
    return TFGraphMapper.importGraph(source, inputShapes=inputShapes,
                                     device=device)
