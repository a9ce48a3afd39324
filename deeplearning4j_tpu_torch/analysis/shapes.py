"""Shape/dtype inference pass over model configurations (reference:
``deeplearning4j_tpu/analysis/shapes.py``, whose checks, codes and
report this copies).

Reference: the InputType propagation that
MultiLayerConfiguration.Builder.build() / ComputationGraphConfiguration
perform — re-run here as a COLLECTING validator: instead of raising at
the first mistake (or, worse, deferring it to the first step, where the
error names a kernel instead of a layer), every layer/vertex is checked and each
problem becomes a Diagnostic naming the layer, what it expected, what
it got, and how to fix it. The pass also emits the per-layer
parameter-count / activation-memory report (on the meta device, so no
parameter arrays are ever materialized).

Checks:
- nIn/nOut consistency (SHP01, SHP06)
- conv/pool spatial arithmetic: padding/stride/dilation that collapse a
  dimension to zero or negative (SHP02)
- preprocessor insertion points / impossible format adaptations (SHP03)
- merge- and elementwise-vertex rank/shape agreement (SHP04) — the
  executor's MergeVertex concatenates blindly, so a disagreement today
  surfaces as a concat error deep in the step
- anything a layer's own getOutputType/inferNIn raises (SHP05)
- fp64 dataType on the card (DTY01, warning)

Retargeted: where the reference builds the parameter and forward
report through ``jax.eval_shape``, the port initializes each layer and
runs its forward on ``torch.device("meta")``: shapes and dtypes only, no
parameter array allocated on the host or on the card, and no draw taken
from any init generator (a throwaway generator is handed in). Layouts
are the port's own (CNN [B, C, H, W], CNN3D [B, C, D, H, W]).
"""

from __future__ import annotations

import copy

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    ERROR, WARNING, Report, ConfigValidationError,
)

__all__ = ["validate_model", "ConfigValidationError"]


# ----------------------------------------------------------------------
# formatting helpers
# ----------------------------------------------------------------------

def _fmt_type(it):
    """Human shape tag: FF[784], CNN[28x28x1], RNN[F=64,T=10], ..."""
    if it is None:
        return "<unknown>"
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    d = it.dims
    if it.kind == InputType.FF:
        return f"FF[{d['size']}]"
    if it.kind == InputType.RNN:
        t = d.get("timeSeriesLength")
        return f"RNN[F={d['size']},T={'?' if t is None else t}]"
    if it.kind == InputType.CNN:
        return f"CNN[{d['height']}x{d['width']}x{d['channels']}]"
    if it.kind == InputType.CNN_FLAT:
        return f"CNNFlat[{d['height']}x{d['width']}x{d['channels']}]"
    if it.kind == InputType.CNN3D:
        return (f"CNN3D[{d['depth']}x{d['height']}x{d['width']}"
                f"x{d['channels']}]")
    return repr(it)


def _layer_where(idx_or_name, layer):
    cls = type(layer).__name__
    nm = getattr(layer, "name", None)
    tag = f"layer {idx_or_name} ({cls})" if not isinstance(idx_or_name, str) \
        else f"layer '{idx_or_name}' ({cls})"
    if nm and not isinstance(idx_or_name, str):
        tag = f"layer {idx_or_name} ({cls} '{nm}')"
    return tag


def _spatial_dims(it):
    """(axis-name, extent) pairs that must stay positive."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if it is None:
        return []
    if it.kind == InputType.CNN:
        return [("height", it.height), ("width", it.width)]
    if it.kind == InputType.CNN3D:
        return [("depth", it.depth), ("height", it.height),
                ("width", it.width)]
    if it.kind == InputType.RNN:
        t = it.dims.get("timeSeriesLength")
        return [] if t is None else [("timeSeriesLength", t)]
    return []


def _dtype_size(dataType):
    return int(dataType.torch_dtype.itemsize)


# ----------------------------------------------------------------------
# per-layer checks shared by the sequential and graph walks
# ----------------------------------------------------------------------

def _needs_nout(layer):
    """FeedForward-family layers that cannot derive nOut themselves."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import recurrent as R

    if not isinstance(layer, L.FeedForwardLayer):
        return False
    return not isinstance(layer, (L.DepthwiseConvolution2D, R.Bidirectional,
                                  R.LastTimeStep))


def _expected_nin(layer, cur):
    """What inferNIn would set for input `cur` — reusing the layer's
    own inference logic so the check can never disagree with it. None
    when the layer cannot infer (e.g. EmbeddingLayer: nIn is a vocab
    size, not an input width). Probes by stash/restore on the layer —
    the walk owns a private deep copy, and copying the layer again
    would duplicate anything heavy it carries (a WeightInitEmbedding's
    whole pretrained matrix, say)."""
    saved = getattr(layer, "nIn", None)
    try:
        layer.nIn = None
        layer.inferNIn(cur)
        return layer.nIn
    except Exception:
        return None
    finally:
        layer.nIn = saved


def _abstract_init(layer, inputType, dtype):
    """(params, state) as meta tensors: the layer's own initialize on
    ``torch.device("meta")`` with a throwaway generator, so nothing is
    allocated and no init generator is advanced. None when the layer's
    initialize needs runtime-only context."""
    import torch

    meta = torch.device("meta")
    try:
        with torch.device(meta):
            return layer.initialize(torch.Generator(), inputType, dtype,
                                    meta)
    except Exception:
        return None


def _leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return []


def _param_count(abstract):
    if abstract is None:
        return 0
    return int(sum(l.numel() for l in _leaves(abstract[0])))


def _internal_shape(it, batch, t_default=8):
    """Concrete internal-layout array shape for an InputType (the
    port's layouts): FF [B,N], RNN NCW [B,F,T], CNN [B,C,H,W], CNN3D
    [B,C,D,H,W]. None where the extent is unknown (wildcard in
    comparisons)."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if it.kind == InputType.FF:
        return (batch, it.size)
    if it.kind == InputType.RNN:
        t = it.dims.get("timeSeriesLength")
        return (batch, it.size, t if t is not None else t_default)
    if it.kind == InputType.CNN:
        return (batch, it.channels, it.height, it.width)
    if it.kind == InputType.CNN3D:
        return (batch, it.channels, it.depth, it.height, it.width)
    return None


def _declared_shape(it, batch, t_default=8):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    s = _internal_shape(it, batch, t_default=t_default)
    if s is not None and it.kind == InputType.RNN \
            and it.dims.get("timeSeriesLength") is None:
        return (batch, it.size, None)  # unknown T: wildcard
    return s


def _check_forward_agreement(report, where, layer, cur, out, dataType,
                             batchSize, abstract):
    """Deep check: execute the layer's forward on meta tensors (no
    FLOPs, no arrays) and confirm it produces the shape
    getOutputType declared. A disagreement is a latent bug that
    otherwise surfaces as a shape error mid-step."""
    import torch

    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    x_shape = _internal_shape(cur, batchSize)
    want = _declared_shape(out, batchSize)
    if x_shape is None or want is None or abstract is None:
        return
    if (cur.kind == InputType.RNN
            and cur.dims.get("timeSeriesLength") is None
            and out.kind == InputType.RNN and len(want) == 3):
        # the input T is unknown (probed with a placeholder length), so
        # the output T cannot be checked — a layer whose declared T is
        # concrete (EmbeddingSequenceLayer inputLength) would otherwise
        # false-positive against the placeholder
        want = (want[0], want[1], None)
    params, state = abstract
    try:
        x = torch.empty(x_shape, dtype=dataType.torch_dtype, device="meta")
        with torch.no_grad():
            y = layer.forward(params, state, x, False, None)[0]
    except Exception:
        return  # forward needs runtime context; declaration checks only
    got = tuple(y.shape)
    if len(got) != len(want) or any(
            w is not None and g != w for g, w in zip(got[1:], want[1:])):
        report.add(
            "SHP05", ERROR, where,
            f"forward() produces shape {got} but getOutputType declares "
            f"{_fmt_type(out)} (expected {want}) for input "
            f"{_fmt_type(cur)}")


_LOSS_ACTIVATIONS = {
    # lossFunction -> activations that match its domain (reference:
    # OutputLayerUtil.validateOutputLayer's loss/activation pairing)
    "mcxent": ("softmax", "sigmoid"),
    "xent": ("sigmoid", "softmax"),
    "negativeloglikelihood": ("softmax", "sigmoid"),
}


def _check_loss_activation(report, where, layer):
    loss = getattr(layer, "lossFunction", None)
    act = getattr(layer, "activation", None)
    if loss is None or act is None or not isinstance(loss, str) \
            or not isinstance(act, str):
        return
    allowed = _LOSS_ACTIVATIONS.get(loss.lower())
    if allowed and act.lower() not in allowed:
        report.add(
            "SHP05", WARNING, where,
            f"lossFunction='{loss}' expects a {'/'.join(allowed)} "
            f"activation but got '{act}' — the loss will see values "
            "outside its domain",
            hint=f"use activation='{allowed[0]}' (or switch the loss)")


def _bn_features(it):
    """The feature count BatchNormalization normalizes over for input
    `it` (channels of an image, the width of a vector or sequence)."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if it.kind in (InputType.CNN, InputType.CNN3D, InputType.CNN_FLAT):
        return it.channels
    if it.kind in (InputType.FF, InputType.RNN):
        return it.size
    return None


def _param_dtype(dataType):
    """The dtype the networks keep parameters in: f64 under DOUBLE, else
    f32 (a bf16 network computes in bf16 over f32 master weights)."""
    import torch

    return torch.float64 if dataType.torch_dtype == torch.float64 \
        else torch.float32


def _check_layer(report, where, layer, cur, dataType, batchSize, index=None,
                 key=None):
    """Validate one layer against its (already format-adapted) input
    type. Returns the layer's output InputType, or None when
    propagation past this layer is impossible. `key` is the caller's
    stable handle back to the layer (sequential index / graph vertex
    name) — the partition-plan analyzer uses it to re-resolve the layer
    object from the original config."""
    from deeplearning4j_tpu_torch.nn.conf.builder import _unwrap_layer
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    u = _unwrap_layer(layer)

    if _needs_nout(u) and getattr(u, "nOut", None) is None:
        report.add("SHP06", ERROR, where,
                   f"requires nOut but none was configured "
                   f"(input {_fmt_type(cur)})",
                   hint="set nOut=<width> on the layer")
        return None

    if not getattr(layer, "multiInput", False):
        explicit = getattr(u, "nIn", None)
        expected = _expected_nin(u, cur) if explicit is not None else None
        if (explicit is not None and expected is not None
                and int(explicit) != int(expected)):
            report.add(
                "SHP01", ERROR, where,
                f"explicit nIn={explicit} but the propagated input is "
                f"{_fmt_type(cur)} (nIn would be {expected})",
                hint="drop nIn and let shape inference set it, or fix "
                     "the upstream layer width")
            return None
        # BatchNormalization carries nIn/nOut outside the FF family
        if isinstance(u, L.BatchNormalization) and u.nOut is not None:
            feat = _bn_features(cur)
            if feat is not None and int(u.nOut) != int(feat):
                report.add(
                    "SHP01", ERROR, where,
                    f"explicit nOut={u.nOut} but the incoming activation "
                    f"has {feat} features ({_fmt_type(cur)})",
                    hint="drop nOut; BatchNormalization infers its width")
                return None

    try:
        if hasattr(layer, "inferNIn"):
            layer.inferNIn(cur)
        out = layer.getOutputType(cur)
    except Exception as e:
        report.add("SHP05", ERROR, where,
                   f"shape inference failed for input {_fmt_type(cur)}: {e}")
        return None

    bad = [(ax, v) for ax, v in _spatial_dims(out) if v is not None and v <= 0]
    if bad:
        detail = ", ".join(f"{ax}={v}" for ax, v in bad)
        kern = getattr(layer, "kernelSize", None)
        stride = getattr(layer, "stride", None)
        report.add(
            "SHP02", ERROR, where,
            f"output {_fmt_type(out)} has non-positive {detail} for input "
            f"{_fmt_type(cur)}"
            + (f" (kernelSize={kern}, stride={stride})" if kern else ""),
            hint="shrink kernel/stride, add padding, or use "
                 "convolutionMode='same'")
        return None

    _check_loss_activation(report, where, layer)
    # ONE abstract init shared by the forward deep check and the param
    # count (the --zoo pre-flight walks 1000+ layers; doubling the
    # eval_shape work here doubled its wall time)
    abstract = _abstract_init(layer, cur, _param_dtype(dataType))
    _check_forward_agreement(report, where, layer, cur, out, dataType,
                             batchSize, abstract)
    n_params = _param_count(abstract)
    act = out.arrayElementsPerExample() * _dtype_size(dataType) * batchSize
    param_shapes = {}
    if abstract is not None:
        for pname, leaf in (abstract[0] or {}).items():
            try:
                param_shapes[pname] = tuple(int(d) for d in leaf.shape)
            except (AttributeError, TypeError):
                # nested/non-array leaves (rare wrappers): flatten
                for j, l in enumerate(_leaves(leaf)):
                    param_shapes[f"{pname}.{j}"] = tuple(
                        int(d) for d in l.shape)
    out_shape = _internal_shape(out, batchSize)
    report.layers.append({
        "index": index if index is not None else len(report.layers),
        "key": key if key is not None else index,
        "name": getattr(layer, "name", None) or (where.split("(")[0].strip()),
        "type": type(layer).__name__,
        "in": _fmt_type(cur),
        "out": _fmt_type(out),
        "out_kind": out.kind,
        "out_shape": None if out_shape is None
        else tuple(int(d) if d is not None else None for d in out_shape),
        "params": n_params,
        "param_shapes": param_shapes,
        "activation_bytes": int(act),
    })
    return out


def _multi_input_row(report, layer, key, index, in_types, out, dataType,
                     batchSize):
    """The layers row of a multi-input layer (an attention vertex): its
    params and their shapes from its own initialize on meta tensors, so
    the partition plan and PAR06 see its leaves (the reference's pass
    gives such a layer no row)."""
    abstract = _abstract_init(layer, list(in_types), _param_dtype(dataType))
    shapes = {}
    for pname, leaf in ((abstract or ({}, {}))[0] or {}).items():
        shapes[pname] = tuple(int(d) for d in leaf.shape)
    out_shape = _internal_shape(out, batchSize)
    report.layers.append({
        "index": index, "key": key,
        "name": getattr(layer, "name", None) or key,
        "type": type(layer).__name__,
        "in": ", ".join(_fmt_type(t) for t in in_types),
        "out": _fmt_type(out), "out_kind": out.kind,
        "out_shape": None if out_shape is None
        else tuple(int(d) if d is not None else None for d in out_shape),
        "params": _param_count(abstract), "param_shapes": shapes,
        "activation_bytes": int(out.arrayElementsPerExample()
                                * _dtype_size(dataType) * batchSize),
    })


def _adapt_format(report, where, layer, cur, preprocessor):
    """Apply the explicit or auto-inserted preprocessor; SHP03 when the
    needed adaptation does not exist."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        _wants, auto_preprocessor,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if preprocessor is not None:
        try:
            return preprocessor.getOutputType(cur)
        except Exception as e:
            report.add("SHP05", ERROR, where,
                       f"explicit preprocessor "
                       f"{type(preprocessor).__name__} rejected input "
                       f"{_fmt_type(cur)}: {e}")
            return None
    try:
        _, cur2 = auto_preprocessor(layer, cur)
        return cur2
    except ValueError:
        wants = _wants(layer)
        hint = None
        if cur.kind == InputType.FF and wants == InputType.CNN:
            hint = ("declare setInputType(InputType.convolutionalFlat"
                    "(h, w, c)) or insert a FeedForwardToCnnPreProcessor")
        report.add("SHP03", ERROR, where,
                   f"expected {wants} input, got {_fmt_type(cur)} and no "
                   f"preprocessor exists for {cur.kind} -> {wants}",
                   hint=hint)
        return None


# ----------------------------------------------------------------------
# sequential (MultiLayerConfiguration) walk
# ----------------------------------------------------------------------

def _validate_sequential(report, layers, defaults, inputType, preprocessors,
                         dataType, batchSize):
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if inputType is None:
        report.add("SHP05", ERROR, "network",
                   "no input type: call setInputType(...) or set nIn on "
                   "the first layer")
        return
    if any(l is None for l in layers):
        report.add("SHP05", ERROR, "network", "gap in layer indices")
        return

    cur = inputType
    if cur.kind == InputType.CNN_FLAT:
        first = layers[0]
        if isinstance(first, (L.ConvolutionLayer, L.SubsamplingLayer,
                              L.BatchNormalization)):
            cur = InputType.convolutional(cur.height, cur.width, cur.channels)
        else:
            cur = InputType.feedForward(cur.arrayElementsPerExample())

    for i, layer in enumerate(layers):
        where = _layer_where(i, layer)
        layer.mergeGlobals(defaults)
        cur = _adapt_format(report, where, layer, cur,
                            preprocessors.get(i))
        if cur is None:
            return
        cur = _check_layer(report, where, layer, cur, dataType, batchSize,
                           index=i, key=i)
        if cur is None:
            return


# ----------------------------------------------------------------------
# graph (ComputationGraphConfiguration) walk
# ----------------------------------------------------------------------

def _check_vertex_forward_agreement(report, where, vertex, in_types, out,
                                    dataType, batchSize):
    """Deep check for parameterless vertices: run apply() on meta
    tensors and compare against the declared output type (batch dim
    excluded — Stack/Unstack legitimately change it)."""
    import torch

    shapes = [_internal_shape(t, batchSize) for t in in_types]
    want = _declared_shape(out, batchSize)
    if want is None or any(s is None for s in shapes):
        return
    try:
        xs = [torch.empty(s, dtype=dataType.torch_dtype, device="meta")
              for s in shapes]
        with torch.no_grad():
            y = vertex.apply(xs)
    except Exception:
        return
    got = tuple(y.shape)
    if len(got) != len(want) or any(
            w is not None and g != w for g, w in zip(got[1:], want[1:])):
        report.add(
            "SHP05", ERROR, where,
            f"apply() produces shape {got} but getOutputType declares "
            f"{_fmt_type(out)} (expected {want}) for inputs "
            + ", ".join(_fmt_type(t) for t in in_types))


def _check_vertex_inputs(report, where, vertex, in_types):
    """SHP04: merge/elementwise inputs must agree in rank (and, for
    merge, in every non-concatenated dim)."""
    from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    known = [t for t in in_types if t is not None]
    if len(known) < 2:
        return True
    kinds = {t.kind for t in known}
    if isinstance(vertex, (MergeVertex, ElementWiseVertex)) and len(kinds) > 1:
        report.add(
            "SHP04", ERROR, where,
            "inputs disagree in rank/format: "
            + ", ".join(_fmt_type(t) for t in known),
            hint="insert preprocessors (or a ReshapeVertex) so every "
                 "input shares one format")
        return False
    if isinstance(vertex, MergeVertex):
        k = known[0].kind
        if k == InputType.CNN:
            hw = {(t.height, t.width) for t in known}
            if len(hw) > 1:
                report.add(
                    "SHP04", ERROR, where,
                    "CNN merge inputs disagree spatially: "
                    + ", ".join(_fmt_type(t) for t in known),
                    hint="align strides/padding of the merged branches")
                return False
        if k == InputType.RNN:
            ts = {t.dims.get("timeSeriesLength") for t in known} - {None}
            if len(ts) > 1:
                report.add(
                    "SHP04", ERROR, where,
                    "RNN merge inputs disagree in sequence length: "
                    + ", ".join(_fmt_type(t) for t in known))
                return False
    elif isinstance(vertex, ElementWiseVertex):
        # timeSeriesLength None is "unknown", not a disagreement (same
        # wildcard the merge check applies)
        dims = {tuple(sorted((k, v) for k, v in t.dims.items()
                             if k != "timeSeriesLength"))
                for t in known}
        ts = {t.dims.get("timeSeriesLength") for t in known} - {None}
        if len(dims) > 1 or len(ts) > 1:
            report.add(
                "SHP04", ERROR, where,
                f"{type(vertex).__name__}({vertex.op}) inputs must have "
                "identical shapes: "
                + ", ".join(_fmt_type(t) for t in known),
                hint="project the branches to matching widths (1x1 conv / "
                     "dense) before combining")
            return False
    return True


def _graph_topo(report, nodes):
    """Topological order over builder/config nodes; SHP05 diagnostics
    for unknown references and cycles (the build-time errors, collected
    instead of raised)."""
    order, seen, temp = [], set(), set()
    ok = True

    def visit(name):
        nonlocal ok
        if name in seen:
            return
        if name in temp:
            report.add("SHP05", ERROR, f"vertex '{name}'",
                       "cycle detected in the graph configuration")
            ok = False
            return
        temp.add(name)
        for dep in nodes[name].inputs:
            if dep not in nodes:
                report.add("SHP05", ERROR, f"vertex '{name}'",
                           f"references unknown input '{dep}'")
                ok = False
                continue
            visit(dep)
        temp.discard(name)
        seen.add(name)
        order.append(name)

    for name in nodes:
        visit(name)
    return order if ok else None


def _validate_graph(report, nodes, networkInputs, networkOutputs, inputTypes,
                    defaults, dataType, batchSize):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    if not networkInputs:
        report.add("SHP05", ERROR, "network", "addInputs(...) required")
        return
    if not networkOutputs:
        report.add("SHP05", ERROR, "network", "setOutputs(...) required")
        return
    missing = [n for n in networkInputs if n not in inputTypes]
    if missing:
        report.add("SHP05", ERROR, "network",
                   f"setInputTypes(...) missing for inputs {missing}")
        return
    order = _graph_topo(report, nodes)
    if order is None:
        return

    resolved = {}
    for li, name in enumerate(order):
        node = nodes[name]
        if node.kind == "input":
            it = inputTypes[name]
            if it.kind == InputType.CNN_FLAT:
                it = InputType.convolutional(it.height, it.width, it.channels)
            resolved[name] = it
            continue
        in_types = [resolved.get(i) for i in node.inputs]
        if any(t is None for t in in_types):
            resolved[name] = None  # upstream already failed
            continue
        if node.kind == "vertex":
            where = f"vertex '{name}' ({type(node.payload).__name__})"
            if not _check_vertex_inputs(report, where, node.payload,
                                        in_types):
                resolved[name] = None
                continue
            try:
                out = node.payload.getOutputType(*in_types)
            except Exception as e:
                report.add("SHP05", ERROR, where,
                           "shape inference failed for inputs "
                           + ", ".join(_fmt_type(t) for t in in_types)
                           + f": {e}")
                resolved[name] = None
                continue
            bad = [(ax, v) for ax, v in _spatial_dims(out)
                   if v is not None and v <= 0]
            if bad:
                report.add("SHP02", ERROR, where,
                           f"output {_fmt_type(out)} has non-positive "
                           + ", ".join(f"{ax}={v}" for ax, v in bad))
                resolved[name] = None
                continue
            _check_vertex_forward_agreement(report, where, node.payload,
                                            in_types, out, dataType,
                                            batchSize)
            resolved[name] = out
            continue
        # layer node
        layer = node.payload
        where = _layer_where(name, layer)
        layer.mergeGlobals(defaults)
        if getattr(layer, "multiInput", False):
            try:
                if hasattr(layer, "inferNIn"):
                    layer.inferNIn(*in_types)
                resolved[name] = layer.getOutputType(*in_types)
            except Exception as e:
                report.add("SHP05", ERROR, where,
                           "shape inference failed for inputs "
                           + ", ".join(_fmt_type(t) for t in in_types)
                           + f": {e}")
                resolved[name] = None
                continue
            _multi_input_row(report, layer, name, li, in_types,
                             resolved[name], dataType, batchSize)
            continue
        cur = _adapt_format(report, where, layer, in_types[0],
                            getattr(node, "preprocessor", None))
        if cur is None:
            resolved[name] = None
            continue
        resolved[name] = _check_layer(report, where, layer, cur, dataType,
                                      batchSize, index=li, key=name)

    for out in networkOutputs:
        if out not in nodes:
            report.add("SHP05", ERROR, "network",
                       f"setOutputs names unknown vertex '{out}'")


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def validate_model(model, batchSize=32):
    """Static shape/dtype validation of a model configuration.

    Accepts a MultiLayerConfiguration / ComputationGraphConfiguration, a
    ListBuilder / GraphBuilder (validated WITHOUT calling build(), so a
    config build() would reject still yields a full diagnostic list), a
    ZooModel, or an initialized network. Returns a Report; raises
    nothing. The input object is never mutated (the walk runs on a deep
    copy)."""
    from deeplearning4j_tpu_torch.ndarray.dtype import DataType
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        ListBuilder, MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration, GraphBuilder,
    )

    subject = type(model).__name__
    report = Report(subject=subject)
    owned = False  # True when `model` is already a private throwaway copy

    # zoo models build their conf fresh; config exceptions become findings
    if hasattr(model, "conf") and callable(getattr(model, "conf", None)) \
            and not isinstance(model, (ListBuilder, GraphBuilder,
                                       MultiLayerConfiguration,
                                       ComputationGraphConfiguration)):
        report.subject = subject
        try:
            model = model.conf()
            owned = True  # freshly built, nobody else holds it
        except Exception as e:
            report.add("SHP05", ERROR, subject,
                       f"conf() raised during build: {e}")
            return report
    elif hasattr(model, "conf") and not callable(getattr(model, "conf")):
        model = model.conf  # an initialized network

    dataType = getattr(model, "dataType", None)
    if dataType is None and hasattr(model, "_defaults"):
        dataType = model._defaults.get("dataType")
    dataType = dataType or DataType.FLOAT
    if dataType == DataType.DOUBLE:
        report.add("DTY01", WARNING, "network",
                   "dataType DOUBLE: fp64 runs far below the card's "
                   "bf16/tf32 tensor-core rates, and the attention "
                   "kernels (K1-K5) take f32 and bf16 only",
                   hint="use FLOAT (or BFLOAT16 compute) unless running "
                        "gradient checks")

    if isinstance(model, ListBuilder):
        model = _conf_without_inference(model)  # deep-copies the layers
        owned = True
    if isinstance(model, MultiLayerConfiguration):
        if not owned:
            model = copy.deepcopy(model)
        _validate_sequential(report, model.layers, model.defaults,
                             model.inputType, dict(model.preprocessors),
                             dataType, batchSize)
        return report

    if isinstance(model, GraphBuilder):
        nodes = copy.deepcopy(model._nodes)
        _validate_graph(report, nodes, list(model._inputs),
                        list(model._outputs), dict(model._inputTypes),
                        dict(model._defaults), dataType, batchSize)
        return report
    if isinstance(model, ComputationGraphConfiguration):
        nodes = model.nodes if owned else copy.deepcopy(model.nodes)
        _validate_graph(report, nodes, list(model.networkInputs),
                        list(model.networkOutputs), dict(model.inputTypes),
                        dict(model.defaults), dataType, batchSize)
        return report

    report.add("SHP05", ERROR, subject,
               f"don't know how to validate a {subject}")
    return report


def _conf_without_inference(lb):
    """ListBuilder internals -> a MultiLayerConfiguration WITHOUT running
    build()'s raising inferShapes walk (the validator re-runs that walk
    collecting diagnostics instead)."""
    from deeplearning4j_tpu_torch.ndarray.dtype import DataType
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration, input_type_from_first_layer,
    )

    d = lb._defaults
    conf = MultiLayerConfiguration(
        layers=copy.deepcopy(lb._layers), defaults=d,
        seed=d.get("seed", 12345),
        dataType=d.get("dataType", DataType.FLOAT),
        inputType=lb._inputType,
        preprocessors=dict(lb._preprocessors),
        backpropType=lb._backpropType,
        tbpttFwdLength=lb._tbpttFwd, tbpttBackLength=lb._tbpttBack,
        gradientNormalization=d.get("gradientNormalization"),
        gradientNormalizationThreshold=d.get(
            "gradientNormalizationThreshold", 1.0))
    if conf.inputType is None and conf.layers \
            and conf.layers[0] is not None:
        conf.inputType = input_type_from_first_layer(conf.layers)
    return conf
