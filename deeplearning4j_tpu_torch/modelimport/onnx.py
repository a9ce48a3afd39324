"""ONNX model import into SameDiff.

The counterpart of ``deeplearning4j_tpu/modelimport/onnx.py`` (reference:
nd4j-api org.nd4j.imports.graphmapper.onnx.OnnxGraphMapper): the same op
table maps an ONNX graph onto SameDiff ops, so the imported model runs,
differentiates and serializes like a natively built graph, on the card
unless the caller asks for the CPU.

Layout: ONNX is NCHW/OIHW. The mapper keeps every tensor in its ONNX
layout and brackets conv/pool ops with ``permute`` pairs into SameDiff's
NHWC/HWIO ops, as the reference does. XLA cancels the back-to-back
transposes there; eager torch does not, but a permute is a view here and
the cnn ops take NHWC views of NCHW memory back to torch's NCHW order as
views too, so each bracketed conv reads its input in place (no relayout
copy, the same arithmetic).

Parsing uses the port's ``modelimport/onnx_wire.py`` (its own copy of
the dependency-free protobuf codec); bf16 and fp16 initializers decode
from their bit patterns with no ``ml_dtypes``.

Scope (the reference's inference-graph subset): Conv (groups, dilations,
auto_pad), ConvTranspose, MaxPool/AveragePool/GlobalAveragePool/
GlobalMaxPool, BatchNormalization (inference), Gemm, MatMul, elementwise
+-*/ Pow Min Max, Relu/LeakyRelu/PRelu/Elu/Selu/Sigmoid/HardSigmoid/
Tanh/Softplus/Softsign/Erf/Clip, Softmax (both pre- and post-opset-13
semantics), Reshape/Flatten/Transpose/Squeeze/Unsqueeze/Concat/Pad/Slice
basics, ReduceMean/Sum/Max/Min/Prod, Gather, Cast, Constant,
Dropout/Identity. Anything else raises ONNXImportException naming the
node and op type.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.modelimport import onnx_wire as wire
from deeplearning4j_tpu_torch.ndarray.dtype import numpy_name
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy

__all__ = ["OnnxGraphMapper", "ONNXImportException", "importOnnx",
           "tensor_to_ndarray", "tensor_to_torch"]


class ONNXImportException(ValueError):
    pass


# TensorProto.DataType enum -> torch dtype
_DT = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 4: torch.uint16,
       5: torch.int16, 6: torch.int32, 7: torch.int64, 9: torch.bool,
       10: torch.float16, 11: torch.float64, 12: torch.uint32,
       13: torch.uint64, 16: torch.bfloat16}
_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
       6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
       12: np.uint32, 13: np.uint64}

# TensorProto typed-field fallbacks (when raw_data is absent); note
# float16/bfloat16 ship in int32_data as raw bit patterns per onnx.proto
_TYPED_FIELD = {1: "float_data", 6: "int32_data", 7: "int64_data",
                9: "int32_data", 11: "double_data", 2: "int32_data",
                3: "int32_data", 4: "int32_data", 5: "int32_data",
                12: "uint64_data", 13: "uint64_data"}


def tensor_to_torch(tp):
    """TensorProto -> a CPU tensor of its dtype (bf16 and fp16 from their
    16-bit patterns, bit for bit)."""
    if tp.data_type not in _DT:
        raise ONNXImportException(
            f"tensor '{tp.name}': unsupported ONNX dtype {tp.data_type}")
    shape = tuple(int(d) for d in tp.dims)
    if tp.data_type in (10, 16):
        bits = (np.frombuffer(tp.raw_data, dtype=np.uint16) if tp.raw_data
                else np.asarray(tp.int32_data, np.uint16))
        t = torch.from_numpy(bits.astype(np.int16, copy=True))
        return t.view(_DT[tp.data_type]).reshape(shape)
    dtype = _NP[tp.data_type]
    if tp.raw_data:
        arr = np.frombuffer(tp.raw_data, dtype=dtype).reshape(shape).copy()
    else:
        field = _TYPED_FIELD.get(tp.data_type)
        if field is None:
            raise ONNXImportException(
                f"tensor '{tp.name}': no data field for dtype {tp.data_type}")
        arr = np.asarray(getattr(tp, field), dtype=dtype).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(shape)


def tensor_to_ndarray(tp):
    """TensorProto -> numpy array (a bf16 tensor as its exact float32
    widening: numpy has no bf16 without ml_dtypes)."""
    return to_numpy(tensor_to_torch(tp))


def _model_from(source):
    """Accept a ModelProto Message, serialized bytes, or a .onnx path."""
    if isinstance(source, wire.Message):
        if source._type == "ModelProto":
            return source
        raise ONNXImportException(
            f"expected ModelProto, got {source._type}")
    if isinstance(source, (bytes, bytearray)):
        return wire.decode("ModelProto", bytes(source))
    with open(str(source), "rb") as f:
        return wire.decode("ModelProto", f.read())


def _attrs(node):
    return {a.name: a for a in node.attribute}


def _attr_i(attrs, name, default=None):
    return int(attrs[name].i) if name in attrs else default


def _attr_f(attrs, name, default=None):
    return float(attrs[name].f) if name in attrs else default


def _attr_s(attrs, name, default=None):
    return attrs[name].s.decode("utf-8") if name in attrs else default


def _attr_ints(attrs, name, default=None):
    return [int(v) for v in attrs[name].ints] if name in attrs else default


_NHWC = (0, 2, 3, 1)   # NCHW -> NHWC
_NCHW = (0, 3, 1, 2)   # NHWC -> NCHW
_HWIO = (2, 3, 1, 0)   # OIHW -> HWIO (also correct per-group)


def _auto_pads(auto_pad, in_hw, k, s, d, node_name):
    """auto_pad SAME_UPPER/SAME_LOWER/VALID -> explicit ((lo,hi),(lo,hi))."""
    if auto_pad in ("", "NOTSET", None):
        return None
    if auto_pad == "VALID":
        return ((0, 0), (0, 0))
    if auto_pad not in ("SAME_UPPER", "SAME_LOWER"):
        raise ONNXImportException(
            f"node '{node_name}': unsupported auto_pad {auto_pad!r}")
    return _same_pads(in_hw[0], in_hw[1], k, s, d,
                      lower=auto_pad == "SAME_LOWER")


def _pads_2d(attrs, node_name):
    p = _attr_ints(attrs, "pads")
    if p is None:
        return ((0, 0), (0, 0))
    if len(p) != 4:
        raise ONNXImportException(
            f"node '{node_name}': only 2-spatial-dim pads supported, "
            f"got pads={p}")
    return ((p[0], p[2]), (p[1], p[3]))  # [hb, wb, he, we]


class OnnxGraphMapper:
    """importGraph(ModelProto | bytes | path) -> SameDiff.

    Reference: OnnxGraphMapper.importGraph (nd4j-api onnx import)."""

    @staticmethod
    def importGraph(source, inputShapes=None, device=None):
        """`inputShapes`: {inputName: shape tuple} overriding/filling
        symbolic dims (ONNX inputs routinely have batch as a dim_param;
        the graph's shapes are static). The graph lives on `device`: the
        card unless the caller asks for the CPU."""
        from deeplearning4j_tpu_torch.autodiff.ops_impl import OPS

        model = _model_from(source)
        graph = model.graph
        if graph is None:
            raise ONNXImportException("ModelProto has no graph")
        opset = 17
        for osi in model.opset_import:
            if osi.domain in ("", "ai.onnx"):
                opset = int(osi.version) or opset
        sd = SameDiff.create(device)
        vars_ = {}   # ONNX tensor name -> SDVariable
        consts = {}  # ONNX tensor name -> numpy (initializers + Constants)
        meta = {}    # SDVariable name -> meta tensor (shape and dtype)

        def emit(opName, inputs, kwargs=None):
            v = sd._op(opName, inputs, kwargs)
            try:
                with torch.no_grad():
                    out = OPS[opName](*[meta[i.name] for i in inputs],
                                      **(kwargs or {}))
                meta[v.name] = out[0] if isinstance(out, (list, tuple)) else out
            except Exception:
                pass  # best-effort; shape_of falls back to the variable
            return v

        def bind(tname, arr):
            t = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.array(arr, copy=True)).reshape(
                    np.shape(arr))
            v = sd.constant(t, None)  # ONNX names may collide with sd ids
            vars_[tname] = v
            consts[tname] = to_numpy(t)
            meta[v.name] = torch.empty(t.shape, dtype=t.dtype, device="meta")
            return v

        def get(tname):
            if tname not in vars_:
                raise ONNXImportException(
                    f"reference to unknown tensor '{tname}' (graph inputs, "
                    "initializers and prior node outputs are resolvable)")
            return vars_[tname]

        def const_value(tname):
            if tname in consts:
                return consts[tname]
            v = get(tname)
            arr = sd._arrays.get(v.name)
            if arr is None:
                raise ONNXImportException(
                    f"'{tname}' must be a constant/initializer here "
                    "(structural argument)")
            return to_numpy(arr)

        def shape_of(tname):
            m = meta.get(vars_[tname].name) if tname in vars_ else None
            if m is not None:
                return tuple(m.shape)
            return tuple(get(tname).shape)

        def rank_of(tname):
            return len(shape_of(tname))

        def dtype_of(tname):
            m = meta.get(vars_[tname].name) if tname in vars_ else None
            return m.dtype if m is not None else torch.float32

        def scalar(tname, ref, value):
            """Bind a helper scalar in `ref`'s dtype: a float32 literal
            would promote an fp16/bf16 graph (ONNX: a node's output dtype
            equals its input's)."""
            return bind(tname, torch.tensor(value, dtype=dtype_of(ref)))

        for init in graph.initializer:
            bind(init.name, tensor_to_torch(init))

        for vi in graph.input:
            if vi.name in vars_:  # initializers may be re-listed as inputs
                continue
            shape = None
            tt = vi.type.tensor_type if vi.type is not None else None
            if inputShapes and vi.name in inputShapes:
                shape = tuple(int(x) for x in inputShapes[vi.name])
            elif tt is not None and tt.shape is not None:
                dims = []
                for d in tt.shape.dim:
                    dims.append(int(d.dim_value) if not d.dim_param
                                and d.dim_value > 0 else -1)
                shape = tuple(dims)
            if shape is None or any(s < 0 for s in shape):
                raise ONNXImportException(
                    f"input '{vi.name}' has symbolic/unknown dims {shape}; "
                    f"pass inputShapes={{'{vi.name}': (...)}} (the graph's "
                    "shapes are static)")
            dt = _DT.get(tt.elem_type, torch.float32) if tt is not None \
                else torch.float32
            v = sd.placeHolder(vi.name, dt, *shape)
            vars_[vi.name] = v
            meta[v.name] = torch.empty(shape, dtype=dt, device="meta")

        def spatial_op(node, x_name, kernel_from_w=None):
            """Common conv/pool geometry: returns (strides, dilations,
            explicit pads) honoring auto_pad, all in (H, W) order."""
            attrs = _attrs(node)
            if rank_of(x_name) != 4:
                raise ONNXImportException(
                    f"node '{node.name}' ({node.op_type}): only 4-D NCHW "
                    f"inputs supported, got rank {rank_of(x_name)}")
            k = kernel_from_w or tuple(_attr_ints(attrs, "kernel_shape"))
            s = tuple(_attr_ints(attrs, "strides", [1, 1]))
            d = tuple(_attr_ints(attrs, "dilations", [1, 1]))
            if len(k) != 2:
                raise ONNXImportException(
                    f"node '{node.name}': only 2 spatial dims supported "
                    f"(kernel {k})")
            in_hw = shape_of(x_name)[2:4]
            pads = _auto_pads(_attr_s(attrs, "auto_pad"), in_hw, k, s, d,
                              node.name)
            if pads is None:
                pads = _pads_2d(attrs, node.name)
            return k, s, d, pads

        def to_nhwc(v):
            return emit("permute", [v], {"dimensions": _NHWC})

        def to_nchw(v):
            return emit("permute", [v], {"dimensions": _NCHW})

        for node in graph.node:
            op = node.op_type
            attrs = _attrs(node)
            ins = list(node.input)
            out = node.output[0] if node.output else None

            if op == "Constant":
                if "value" in attrs:
                    bind(out, tensor_to_torch(attrs["value"].t))
                elif "value_float" in attrs:
                    bind(out, np.float32(attrs["value_float"].f))
                elif "value_int" in attrs:
                    bind(out, np.int64(attrs["value_int"].i))
                elif "value_floats" in attrs:
                    bind(out, np.asarray(attrs["value_floats"].floats,
                                         np.float32))
                elif "value_ints" in attrs:
                    bind(out, np.asarray(attrs["value_ints"].ints, np.int64))
                else:
                    raise ONNXImportException(
                        f"Constant node '{node.name}' has no supported "
                        "value attribute")
                continue

            if op in ("Identity", "Dropout"):
                # Dropout at inference is identity; the optional mask
                # output is not materialized (an error surfaces naturally
                # if a downstream node references it)
                vars_[out] = emit("identity", [get(ins[0])])
                # structural arguments (Reshape shapes, Clip bounds, …)
                # are routinely routed through Identity by exporters and
                # graph optimizers — keep their const-ness visible
                if ins[0] in consts:
                    consts[out] = consts[ins[0]]
                continue

            if op in ("Add", "Sub", "Mul", "Div", "Pow"):
                name = {"Add": "add", "Sub": "sub", "Mul": "mul",
                        "Div": "div", "Pow": "pow"}[op]
                vars_[out] = emit(name, [get(ins[0]), get(ins[1])])
                continue

            if op in ("Max", "Min"):  # n-ary
                name = "maximum" if op == "Max" else "minimum"
                acc = get(ins[0])
                for extra in ins[1:]:
                    acc = emit(name, [acc, get(extra)])
                vars_[out] = acc
                continue

            _UNARY = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
                      "Exp": "exp", "Log": "log", "Sqrt": "sqrt",
                      "Neg": "neg", "Abs": "abs", "Erf": "erf",
                      "Floor": "floor", "Ceil": "ceil", "Round": "round",
                      "Reciprocal": "reciprocal", "Softplus": "softplus",
                      "Softsign": "softsign", "Sign": "sign",
                      "Not": "not"}
            if op in _UNARY:
                vars_[out] = emit(_UNARY[op], [get(ins[0])])
                continue

            if op == "LeakyRelu":
                vars_[out] = emit("leakyRelu", [get(ins[0])],
                                  {"alpha": _attr_f(attrs, "alpha", 0.01)})
                continue

            if op == "Elu":
                alpha = _attr_f(attrs, "alpha", 1.0)
                x = get(ins[0])
                if alpha == 1.0:
                    vars_[out] = emit("elu", [x])
                else:
                    zero = scalar(f"__{out}_zero", ins[0], 0.0)
                    a = scalar(f"__{out}_alpha", ins[0], alpha)
                    one = scalar(f"__{out}_one", ins[0], 1.0)
                    em1 = emit("sub", [emit("exp", [x]), one])
                    vars_[out] = emit(
                        "where", [emit("gt", [x, zero]), x,
                                  emit("mul", [a, em1])])
                continue

            if op == "Selu":
                vars_[out] = emit("selu", [get(ins[0])])
                continue

            if op == "HardSigmoid":
                # ONNX: max(0, min(1, alpha*x + beta)), defaults .2/.5
                alpha = _attr_f(attrs, "alpha", 0.2)
                beta = _attr_f(attrs, "beta", 0.5)
                x = get(ins[0])
                a = scalar(f"__{out}_a", ins[0], alpha)
                b = scalar(f"__{out}_b", ins[0], beta)
                y = emit("add", [emit("mul", [x, a]), b])
                vars_[out] = emit("clipByValue", [y], {"clipValueMin": 0.0,
                                                       "clipValueMax": 1.0})
                continue

            if op == "PRelu":
                x, slope = get(ins[0]), get(ins[1])
                zero = scalar(f"__{out}_zero", ins[0], 0.0)
                vars_[out] = emit(
                    "where", [emit("gt", [x, zero]), x,
                              emit("mul", [x, slope])])
                continue

            if op == "Clip":
                x = get(ins[0])
                if opset >= 11:
                    lo = (float(np.asarray(const_value(ins[1])).ravel()[0])
                          if len(ins) > 1 and ins[1] else None)
                    hi = (float(np.asarray(const_value(ins[2])).ravel()[0])
                          if len(ins) > 2 and ins[2] else None)
                else:
                    lo = _attr_f(attrs, "min")
                    hi = _attr_f(attrs, "max")
                # both bounds are optional per spec (clamp_min exports
                # Clip with no max); clipByValue needs both
                if lo is not None and hi is not None:
                    vars_[out] = emit("clipByValue", [x],
                                      {"clipValueMin": lo,
                                       "clipValueMax": hi})
                elif lo is not None:
                    vars_[out] = emit(
                        "maximum", [x, scalar(f"__{out}_lo", ins[0], lo)])
                elif hi is not None:
                    vars_[out] = emit(
                        "minimum", [x, scalar(f"__{out}_hi", ins[0], hi)])
                else:
                    vars_[out] = emit("identity", [x])
                continue

            if op == "Gemm":
                alpha = _attr_f(attrs, "alpha", 1.0)
                beta = _attr_f(attrs, "beta", 1.0)
                y = emit("mmul", [get(ins[0]), get(ins[1])],
                         {"transposeA": bool(_attr_i(attrs, "transA", 0)),
                          "transposeB": bool(_attr_i(attrs, "transB", 0))})
                if alpha != 1.0:
                    y = emit("mul", [y, scalar(f"__{out}_alpha",
                                               ins[0], alpha)])
                if len(ins) > 2 and ins[2]:
                    c = get(ins[2])
                    if beta != 1.0:
                        c = emit("mul", [c, scalar(f"__{out}_beta",
                                                   ins[2], beta)])
                    y = emit("add", [y, c])
                vars_[out] = y
                continue

            if op == "MatMul":
                vars_[out] = emit("mmul", [get(ins[0]), get(ins[1])])
                continue

            if op == "Conv":
                x, w = ins[0], ins[1]
                wshape = shape_of(w)  # OIHW: (M, C/g, kH, kW)
                groups = _attr_i(attrs, "group", 1)
                k, s, d, pads = spatial_op(node, x,
                                           kernel_from_w=wshape[2:4])
                conv_ins = [to_nhwc(get(x)),
                            emit("permute", [get(w)],
                                 {"dimensions": _HWIO})]
                if len(ins) > 2 and ins[2]:
                    conv_ins.append(get(ins[2]))
                y = emit("conv2d", conv_ins,
                         {"stride": s, "padding": pads, "dilation": d,
                          "groups": groups})
                vars_[out] = to_nchw(y)
                continue

            if op == "ConvTranspose":
                x, w = ins[0], ins[1]
                wshape = shape_of(w)  # (C, M/g, kH, kW)
                if _attr_i(attrs, "group", 1) != 1:
                    raise ONNXImportException(
                        f"node '{node.name}': grouped ConvTranspose is not "
                        "supported")
                if _attr_ints(attrs, "output_padding"):
                    if any(_attr_ints(attrs, "output_padding")):
                        raise ONNXImportException(
                            f"node '{node.name}': output_padding is not "
                            "supported")
                k, s, d, pads = spatial_op(node, x,
                                           kernel_from_w=wshape[2:4])
                ap = _attr_s(attrs, "auto_pad")
                if ap in ("SAME_UPPER", "SAME_LOWER"):
                    # ConvTranspose SAME is NOT forward-conv SAME: spec
                    # fixes output = input*stride, so per axis
                    # total_pad = eff_kernel - stride (clamped at 0) —
                    # spatial_op's _same_pads math would over-pad
                    pads = []
                    for kk, ss, dd in zip(k, s, d):
                        eff = (kk - 1) * dd + 1
                        tot = max(eff - ss, 0)
                        lo = (tot // 2 if ap == "SAME_UPPER"
                              else tot - tot // 2)
                        pads.append((lo, tot - lo))
                    pads = tuple(pads)
                # ONNX ConvTranspose pads REMOVE output (out = (in-1)*s
                # + eff_k - lo - hi); lax.conv_transpose padding pads
                # the lhs-dilated input (out = (in-1)*s + 1 + lo + hi +
                # eff_k - 2k + ...). The conversion per side is
                # lax_pad = (k-1)*d - onnx_pad.
                pads = tuple(
                    ((kk - 1) * dd - lo, (kk - 1) * dd - hi)
                    for (lo, hi), kk, dd in zip(pads, k, d))
                # ONNX/torch ConvTranspose is the TRUE transpose of a
                # forward conv (scatter form => correlation with the
                # spatially-flipped kernel); deconv2d does not flip, so
                # reverse kH/kW, then (Cin, M, kH, kW) -> (kH, kW, Cin, M)
                wf = emit("reverse", [get(w)], {"dimensions": (2, 3)})
                conv_ins = [to_nhwc(get(x)),
                            emit("permute", [wf],
                                 {"dimensions": (2, 3, 0, 1)})]
                if len(ins) > 2 and ins[2]:
                    conv_ins.append(get(ins[2]))
                y = emit("deconv2d", conv_ins,
                         {"stride": s, "padding": pads, "dilation": d})
                vars_[out] = to_nchw(y)
                continue

            if op in ("MaxPool", "AveragePool"):
                if _attr_i(attrs, "ceil_mode", 0):
                    raise ONNXImportException(
                        f"node '{node.name}': ceil_mode=1 is not supported")
                k, s, d, pads = spatial_op(node, ins[0])
                if d != (1, 1):
                    raise ONNXImportException(
                        f"node '{node.name}': dilated pooling is not "
                        "supported")
                kw = {"kernel": k, "stride": s, "padding": pads}
                if op == "MaxPool":
                    # maxPooling2d pads with -inf, matching ONNX's
                    # semantics for explicit pads
                    y = emit("maxPooling2d", [to_nhwc(get(ins[0]))], kw)
                else:
                    kw["count_include_pad"] = bool(
                        _attr_i(attrs, "count_include_pad", 0))
                    y = emit("avgPooling2d", [to_nhwc(get(ins[0]))], kw)
                vars_[out] = to_nchw(y)
                continue

            if op in ("GlobalAveragePool", "GlobalMaxPool"):
                # spec: reduce over ALL spatial dims (rank-agnostic:
                # NCW, NCHW, NCDHW all legal)
                r = rank_of(ins[0])
                if r < 3:
                    raise ONNXImportException(
                        f"node '{node.name}' ({op}): input rank {r} has "
                        "no spatial dims")
                red = "mean" if op == "GlobalAveragePool" else "max"
                vars_[out] = emit(red, [get(ins[0])],
                                  {"dimensions": list(range(2, r)),
                                   "keepDims": True})
                continue

            if op == "BatchNormalization":
                if _attr_i(attrs, "training_mode", 0):
                    raise ONNXImportException(
                        f"node '{node.name}': training_mode=1 "
                        "BatchNormalization is not supported (export for "
                        "inference)")
                eps = _attr_f(attrs, "epsilon", 1e-5)
                x, scale, b, mean, var = (get(ins[0]), get(ins[1]),
                                          get(ins[2]), get(ins[3]),
                                          get(ins[4]))
                vars_[out] = emit("batchNorm", [x, mean, var, scale, b],
                                  {"epsilon": eps, "axis": 1})
                continue

            if op == "Softmax":
                axis = _attr_i(attrs, "axis", -1 if opset >= 13 else 1)
                x = get(ins[0])
                if opset >= 13:
                    vars_[out] = emit("softmax", [x], {"dimension": axis})
                else:
                    # pre-13 semantics: coerce to 2-D at `axis`, softmax
                    # over the flattened trailing block, restore shape
                    shp = shape_of(ins[0])
                    ax = axis % len(shp)
                    lead = int(np.prod(shp[:ax])) if ax else 1
                    trail = int(np.prod(shp[ax:]))
                    y = emit("reshape", [x], {"shape": [lead, trail]})
                    y = emit("softmax", [y], {"dimension": -1})
                    vars_[out] = emit("reshape", [y],
                                      {"shape": list(shp)})
                continue

            if op == "Reshape":
                shp = [int(v) for v in const_value(ins[1])]
                in_shape = shape_of(ins[0])
                if not _attr_i(attrs, "allowzero", 0):
                    shp = [in_shape[i] if v == 0 else v
                           for i, v in enumerate(shp)]
                vars_[out] = emit("reshape", [get(ins[0])], {"shape": shp})
                continue

            if op == "Flatten":
                axis = _attr_i(attrs, "axis", 1)
                shp = shape_of(ins[0])
                # spec: negative axis means rank+axis (axis in [-r, r])
                ax = axis if axis >= 0 else axis + len(shp)
                lead = int(np.prod(shp[:ax])) if ax else 1
                vars_[out] = emit("reshape", [get(ins[0])],
                                  {"shape": [lead, -1]})
                continue

            if op == "Transpose":
                perm = _attr_ints(attrs, "perm")
                if perm is None:
                    perm = list(range(rank_of(ins[0])))[::-1]
                vars_[out] = emit("permute", [get(ins[0])],
                                  {"dimensions": tuple(perm)})
                continue

            if op == "Concat":
                axis = _attr_i(attrs, "axis")
                if axis is None:
                    raise ONNXImportException(
                        f"node '{node.name}': Concat requires axis")
                vars_[out] = emit("concat", [get(i) for i in ins],
                                  {"dimension": axis})
                continue

            if op in ("Squeeze", "Unsqueeze"):
                if opset >= 13:
                    axes = ([int(v) for v in const_value(ins[1])]
                            if len(ins) > 1 and ins[1] else None)
                else:
                    axes = _attr_ints(attrs, "axes")
                x = get(ins[0])
                if op == "Squeeze":
                    ax = (tuple(a % rank_of(ins[0]) for a in axes)
                          if axes else None)
                    vars_[out] = emit("squeeze", [x], {"axis": ax})
                else:
                    if axes is None:
                        raise ONNXImportException(
                            f"node '{node.name}': Unsqueeze requires axes")
                    r = rank_of(ins[0]) + len(axes)
                    for a in sorted(ax % r for ax in axes):
                        x = emit("expandDims", [x], {"axis": a})
                    vars_[out] = x
                continue

            if op == "Pad":
                mode = _attr_s(attrs, "mode", "constant")
                if mode not in ("constant", "reflect", "edge"):
                    raise ONNXImportException(
                        f"node '{node.name}': unsupported Pad mode {mode!r}")
                if opset >= 11:
                    pads = [int(v) for v in const_value(ins[1])]
                    cval = (float(np.asarray(const_value(ins[2])).ravel()[0])
                            if len(ins) > 2 and ins[2] else 0.0)
                else:
                    pads = _attr_ints(attrs, "pads")
                    cval = _attr_f(attrs, "value", 0.0)
                rank = rank_of(ins[0])
                if len(ins) > 3 and ins[3]:
                    # opset 18+: pads bind to the listed axes only
                    axes = [int(a) % rank for a in const_value(ins[3])]
                else:
                    axes = list(range(rank))
                if len(pads) != 2 * len(axes):
                    raise ONNXImportException(
                        f"node '{node.name}': Pad expects "
                        f"{2 * len(axes)} pad values for {len(axes)} "
                        f"axes, got {len(pads)}")
                n = len(axes)
                full = [(0, 0)] * rank
                for j, a in enumerate(axes):
                    full[a] = (pads[j], pads[j + n])
                padding = tuple(full)
                kw = {"padding": padding,
                      "mode": {"constant": "CONSTANT", "reflect": "REFLECT",
                               "edge": "EDGE"}[mode]}
                if mode == "constant":
                    kw["constant"] = cval
                vars_[out] = emit("pad", [get(ins[0])], kw)
                continue

            _REDUCE = {"ReduceMean": "mean", "ReduceSum": "sum",
                       "ReduceMax": "max", "ReduceMin": "min",
                       "ReduceProd": "prod"}
            if op in _REDUCE:
                # axes moved from attr to input at opset 13 (ReduceSum)
                # and 18 (the rest); accept either
                if len(ins) > 1 and ins[1]:
                    axes = [int(v) for v in np.atleast_1d(
                        const_value(ins[1]))]
                else:
                    axes = _attr_ints(attrs, "axes")
                kd = bool(_attr_i(attrs, "keepdims", 1))
                if not axes and _attr_i(attrs, "noop_with_empty_axes", 0):
                    # spec: empty axes + noop flag -> identity
                    vars_[out] = emit("identity", [get(ins[0])])
                else:
                    vars_[out] = emit(_REDUCE[op], [get(ins[0])],
                                      {"dimensions": axes, "keepDims": kd})
                continue

            if op == "Gather":
                axis = _attr_i(attrs, "axis", 0)
                dim = shape_of(ins[0])[axis]
                ids = get(ins[1])
                if ins[1] in consts:
                    # spec: negative indices wrap from the end —
                    # normalize constant indices at import time
                    arr = np.asarray(consts[ins[1]])
                    if (arr < 0).any():
                        ids = bind(f"__{out}_ids", arr % dim)
                else:
                    # mod wraps negatives Python-style, exactly the
                    # spec's semantics for in-range indices
                    ids = emit("mod", [ids, scalar(f"__{out}_dim",
                                                   ins[1], dim)])
                vars_[out] = emit("gather", [get(ins[0]), ids],
                                  {"axis": axis})
                continue

            if op == "Cast":
                dt = _DT.get(_attr_i(attrs, "to"))
                if dt is None:
                    raise ONNXImportException(
                        f"node '{node.name}': unsupported Cast target "
                        f"{_attr_i(attrs, 'to')}")
                vars_[out] = emit("cast", [get(ins[0])],
                                  {"dtype": numpy_name(dt)})
                continue

            if op == "Slice":
                if opset < 10:
                    starts = _attr_ints(attrs, "starts")
                    ends = _attr_ints(attrs, "ends")
                    axes = _attr_ints(attrs, "axes")
                    steps = None
                else:
                    starts = [int(v) for v in const_value(ins[1])]
                    ends = [int(v) for v in const_value(ins[2])]
                    axes = ([int(v) for v in const_value(ins[3])]
                            if len(ins) > 3 and ins[3] else None)
                    steps = ([int(v) for v in const_value(ins[4])]
                             if len(ins) > 4 and ins[4] else None)
                shp = shape_of(ins[0])
                r = len(shp)
                if axes is None:
                    axes = list(range(len(starts)))
                if steps is None:
                    steps = [1] * len(starts)
                begin, end, stride = ([0] * r), list(shp), ([1] * r)
                for a, st, en, sp in zip(axes, starts, ends, steps):
                    a %= r
                    if sp <= 0:
                        raise ONNXImportException(
                            f"node '{node.name}': non-positive Slice steps "
                            "are not supported")
                    # spec: negatives wrap once, then CLAMP into
                    # [0, dim] — Python's slice() would re-wrap
                    # out-of-range negatives a second time
                    begin[a] = max(0, min(st if st >= 0 else st + shp[a],
                                          shp[a]))
                    end[a] = max(0, min(en if en >= 0 else en + shp[a],
                                        shp[a]))
                    stride[a] = sp
                vars_[out] = emit("stridedSlice", [get(ins[0])],
                                  {"begin": begin, "end": end,
                                   "strides": stride})
                continue

            raise ONNXImportException(
                f"unsupported ONNX op '{op}' (node '{node.name}'); the "
                "supported subset is documented in modelimport.onnx")

        missing = [vo.name for vo in graph.output if vo.name not in vars_]
        if missing:
            raise ONNXImportException(
                f"graph outputs {missing} were never produced by any node")
        sd._onnx_vars = vars_  # ONNX tensor name -> SDVariable
        sd._onnx_outputs = [vo.name for vo in graph.output]
        return sd

    @staticmethod
    def outputVariable(sd, onnxName):
        """The SDVariable for an ONNX tensor name in an imported graph."""
        return sd._onnx_vars[onnxName]


def importOnnx(source, inputShapes=None, device=None):
    """Convenience wrapper (reference: OnnxGraphMapper.importGraph)."""
    return OnnxGraphMapper.importGraph(source, inputShapes=inputShapes,
                                       device=device)


def _same_pads(in_h, in_w, k, s, d=(1, 1), lower=False):
    """SAME padding -> explicit ((lo,hi),(lo,hi)) for static shapes
    (reference: ``modelimport/tensorflow.py``'s ``_same_pads``).
    `lower=False` puts the odd pad at the end (TF SAME / ONNX
    SAME_UPPER); `lower=True` at the start (ONNX SAME_LOWER)."""
    pads = []
    for size, kk, ss, dd in ((in_h, k[0], s[0], d[0]),
                             (in_w, k[1], s[1], d[1])):
        eff = (kk - 1) * dd + 1
        out = -(-size // ss)
        tot = max((out - 1) * ss + eff - size, 0)
        lo = tot - tot // 2 if lower else tot // 2
        pads.append((lo, tot - lo))
    return tuple(pads)
