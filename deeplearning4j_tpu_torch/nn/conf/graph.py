"""ComputationGraph configuration: a DAG of layers and vertices.

The counterpart of ``deeplearning4j_tpu/nn/conf/graph.py``:
``GraphVertex``, ``MergeVertex``, ``ElementWiseVertex`` (the residual
add), ``SubsetVertex``, ``StackVertex``, ``UnstackVertex``,
``ScaleVertex``, ``ShiftVertex``, ``L2NormalizeVertex``, ``L2Vertex``,
``DotProductVertex``, ``ReshapeVertex``, ``PreprocessorVertex``, the
time-series vertices ``ReverseTimeSeriesVertex``, ``LastTimeStepVertex``
and ``DuplicateToTimeSeriesVertex`` (``maskAware``: the graph hands them
their inputs' masks and takes the mask they return), ``_Node``, ``ComputationGraphConfiguration`` (topological order, shape
inference, the automatic preprocessor) and ``GraphBuilder``. Vertices
are plain functions of their inputs; autograd differentiates through
them. A 4-d activation is NCHW-logical here where the reference's is
NHWC, so the channel axis is dim 1 (MergeVertex, SubsetVertex, a
per-channel Scale/Shift factor) and ReshapeVertex reshapes in the
reference's NHWC order. The builder refuses the time-series vertices
under truncated BPTT, which would cut the sequence they need whole.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["GraphVertex", "MergeVertex", "ElementWiseVertex",
           "SubsetVertex", "StackVertex", "UnstackVertex", "ScaleVertex",
           "ShiftVertex", "L2NormalizeVertex", "L2Vertex",
           "DotProductVertex", "ReshapeVertex", "PreprocessorVertex",
           "ReverseTimeSeriesVertex", "LastTimeStepVertex",
           "DuplicateToTimeSeriesVertex", "ComputationGraphConfiguration",
           "GraphBuilder"]


class GraphVertex:
    """Parameterless DAG node combining input activations."""

    def apply(self, inputs: list):
        raise NotImplementedError

    def getOutputType(self, *inputTypes) -> InputType:
        raise NotImplementedError


class MergeVertex(GraphVertex):
    """Concatenate along the channel/feature axis (reference:
    MergeVertex): dim 1 for 4-d (channels) and NCW 3-d (features), the
    last dim for 2-d."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=1 if inputs[0].dim() in (3, 4) else -1)

    def getOutputType(self, *its):
        it = its[0]
        if it.kind == InputType.CNN:
            return InputType.convolutional(it.height, it.width,
                                           sum(i.channels for i in its))
        if it.kind == InputType.RNN:
            return InputType.recurrent(sum(i.size for i in its),
                                       it.dims.get("timeSeriesLength"))
        return InputType.feedForward(sum(i.size for i in its))


class ElementWiseVertex(GraphVertex):
    """Pointwise combine (reference: ElementWiseVertex; Add/Subtract/
    Product/Average/Max) — the residual-connection vertex."""

    Add, Subtract, Product, Average, Max = \
        "add", "subtract", "product", "average", "max"

    def __init__(self, op="add"):
        self.op = str(op).lower()

    def apply(self, inputs):
        if self.op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if self.op == "subtract":
            return inputs[0] - inputs[1]
        if self.op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if self.op == "average":
            return sum(inputs) / len(inputs)
        if self.op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op {self.op}")

    def getOutputType(self, *its):
        return its[0]


class SubsetVertex(GraphVertex):
    """The channels/features frm..to inclusive (reference: SubsetVertex)."""

    def __init__(self, frm, to):
        self.frm, self.to = int(frm), int(to)

    def apply(self, inputs):
        x = inputs[0]
        return x[:, self.frm:self.to + 1]

    def getOutputType(self, *its):
        it = its[0]
        n = self.to - self.frm + 1
        if it.kind == InputType.CNN:
            return InputType.convolutional(it.height, it.width, n)
        if it.kind == InputType.RNN:
            return InputType.recurrent(n, it.dims.get("timeSeriesLength"))
        return InputType.feedForward(n)


class StackVertex(GraphVertex):
    """Stack along the batch axis (reference: StackVertex)."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)

    def getOutputType(self, *its):
        return its[0]


class UnstackVertex(GraphVertex):
    """Slice stackIndex of numStacks equal batch blocks (reference:
    UnstackVertex)."""

    def __init__(self, stackIndex, numStacks):
        self.stackIndex, self.numStacks = int(stackIndex), int(numStacks)

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.numStacks
        return x[self.stackIndex * n:(self.stackIndex + 1) * n]

    def getOutputType(self, *its):
        return its[0]


def _affine_factor(v):
    """A scalar, or a 1-d per-channel factor kept as a tuple (configs
    stay array-free, so toJson works) (reference: ``_affine_factor``)."""
    import numpy as np

    if isinstance(v, (int, float)):
        return float(v)
    arr = np.asarray(v, np.float32)
    if arr.ndim == 0:
        return float(arr)
    if arr.ndim != 1:
        raise ValueError(f"scale/shift factor must be a scalar or 1-d "
                         f"per-channel array, got shape {arr.shape}")
    return tuple(float(x) for x in arr)


class _AffineVertex(GraphVertex):
    """Scale/Shift: a scalar, or a per-channel factor (the channel axis:
    dim 1 of a 4-d activation, the last of a 2-d one); refused on NCW
    3-d activations, where it would broadcast over time."""

    _factor = 0.0

    def _value(self, x):
        if isinstance(self._factor, float):
            return self._factor
        if x.dim() == 3:
            raise ValueError(
                f"per-channel {type(self).__name__} factors are not "
                "supported on recurrent (NCW) activations — the factor "
                "would broadcast over the time axis")
        f = torch.tensor(self._factor, dtype=torch.float32, device=x.device)
        return f.reshape(1, -1, 1, 1) if x.dim() == 4 else f

    def getOutputType(self, *its):
        if (not isinstance(self._factor, float)
                and its[0].kind == InputType.RNN):
            raise ValueError(
                f"per-channel {type(self).__name__} factors are not "
                "supported on recurrent inputs")
        return its[0]


class ScaleVertex(_AffineVertex):
    def __init__(self, scaleFactor):
        self.scaleFactor = self._factor = _affine_factor(scaleFactor)

    def apply(self, inputs):
        return inputs[0] * self._value(inputs[0])


class ShiftVertex(_AffineVertex):
    def __init__(self, shiftFactor):
        self.shiftFactor = self._factor = _affine_factor(shiftFactor)

    def apply(self, inputs):
        return inputs[0] + self._value(inputs[0])


class L2NormalizeVertex(GraphVertex):
    """x / sqrt(sum over every non-batch axis of x² + eps)."""

    def __init__(self, eps=1e-8):
        self.eps = eps

    def apply(self, inputs):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        return x / torch.sqrt(x.square().sum(axes, keepdim=True) + self.eps)

    def getOutputType(self, *its):
        return its[0]


class L2Vertex(GraphVertex):
    """The per-example L2 distance of two inputs, [B, 1] (reference:
    L2Vertex)."""

    def __init__(self, eps=1e-8):
        self.eps = eps

    def apply(self, inputs):
        a, b = inputs[0], inputs[1]
        axes = tuple(range(1, a.dim()))
        return torch.sqrt((a - b).square().sum(axes)[:, None] + self.eps)

    def getOutputType(self, *its):
        return InputType.feedForward(1)


class DotProductVertex(GraphVertex):
    """The per-example dot product of two inputs, [B, 1] (reference:
    DotProductVertex)."""

    def apply(self, inputs):
        a, b = inputs[0], inputs[1]
        return (a * b).sum(tuple(range(1, a.dim())))[:, None]

    def getOutputType(self, *its):
        return InputType.feedForward(1)


class ReshapeVertex(GraphVertex):
    """Reshape each example (reference: ReshapeVertex). newShape is in
    the reference's layout, NHWC for 4-d, so a 4-d input or output is
    taken through its NHWC view."""

    def __init__(self, *newShape):
        self.newShape = tuple(int(s) for s in newShape)

    def apply(self, inputs):
        x = inputs[0]
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        y = x.reshape((x.shape[0],) + self.newShape[1:])
        return y.permute(0, 3, 1, 2) if y.dim() == 4 else y

    def getOutputType(self, *its):
        if len(self.newShape) == 2:
            return InputType.feedForward(self.newShape[1])
        if len(self.newShape) == 4:
            return InputType.convolutional(self.newShape[1],
                                           self.newShape[2],
                                           self.newShape[3])
        return its[0]


class PreprocessorVertex(GraphVertex):
    def __init__(self, preProcessor):
        self.pp = preProcessor

    def apply(self, inputs):
        return self.pp.preProcess(inputs[0])

    def getOutputType(self, *its):
        return self.pp.getOutputType(its[0])


class ReverseTimeSeriesVertex(GraphVertex):
    """Reverse the time axis of NCW data (reference:
    rnn.ReverseTimeSeriesVertex). With a mask each example reverses only
    its valid prefix; the padding stays at the tail and the mask stays
    as it is."""

    maskAware = True

    def apply(self, inputs):
        return inputs[0].flip(2)

    def applyMasked(self, inputs, masks):
        x, m = inputs[0], masks[0]
        if m is None:
            return x.flip(2), None
        T = x.shape[2]
        lengths = m.sum(dim=1).long()[:, None]                 # [B, 1]
        t = torch.arange(T, device=x.device)[None, :]          # [1, T]
        src = torch.where(t < lengths, lengths - 1 - t, t)     # [B, T]
        return torch.gather(x, 2, src[:, None, :].expand_as(x)), m

    def getOutputType(self, *its):
        return its[0]


class LastTimeStepVertex(GraphVertex):
    """[B, F, T] -> [B, F], each example's LAST VALID step (reference:
    rnn.LastTimeStepVertex); step T - 1 with no mask. A row whose mask
    is all zero takes index -1, which the reference's gather reads as
    the last step, so the port wraps it to T - 1. The output is
    feed-forward: no mask goes on."""

    maskAware = True

    def apply(self, inputs):
        return inputs[0][:, :, -1]

    def applyMasked(self, inputs, masks):
        x, m = inputs[0], masks[0]
        if m is None:
            return x[:, :, -1], None
        last = (m.sum(dim=1).long() - 1) % x.shape[2]          # [B]
        idx = last[:, None, None].expand(x.shape[0], x.shape[1], 1)
        return torch.gather(x, 2, idx)[:, :, 0], None

    def getOutputType(self, *its):
        return InputType.feedForward(its[0].size)


class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, F, T], the vector repeated at every step (reference:
    rnn.DuplicateToTimeSeriesVertex). T and the output's mask come from
    the SECOND input, a [B, *, T] sequence."""

    maskAware = True

    @staticmethod
    def _require_two(inputs):
        if len(inputs) < 2:
            raise ValueError(
                "DuplicateToTimeSeriesVertex needs two inputs: the [B,F] "
                "vector and a [B,*,T] sequence whose length to mirror")

    def apply(self, inputs):
        self._require_two(inputs)
        v, seq = inputs[0], inputs[1]
        return v[:, :, None].expand(-1, -1, seq.shape[-1])

    def applyMasked(self, inputs, masks):
        return self.apply(inputs), masks[1] if len(masks) > 1 else None

    def getOutputType(self, *its):
        self._require_two(its)  # at build time, with the other errors
        return InputType.recurrent(its[0].size,
                                   its[1].dims.get("timeSeriesLength"))


_TIME_VERTICES = (ReverseTimeSeriesVertex, LastTimeStepVertex,
                  DuplicateToTimeSeriesVertex)


class _Node:
    """Resolved DAG node: input | layer | vertex."""

    def __init__(self, name, kind, payload=None, inputs=()):
        self.name = name
        self.kind = kind          # "input" | "layer" | "vertex"
        self.payload = payload    # Layer config or GraphVertex
        self.inputs = list(inputs)
        self.preprocessor = None  # for layer nodes
        self.inputType = None     # resolved InputType of the node OUTPUT


class ComputationGraphConfiguration:
    def __init__(self, nodes, inputs, outputs, defaults, inputTypes,
                 backpropType="standard", tbpttFwdLength=20,
                 tbpttBackLength=20):
        self.nodes = nodes            # {name: _Node} insertion-ordered
        self.networkInputs = inputs
        self.networkOutputs = outputs
        self.defaults = defaults
        self.inputTypes = inputTypes  # {input_name: InputType}
        self.seed = defaults.get("seed", 12345)
        self.dataType = defaults.get("dataType", DataType.FLOAT)
        self.backpropType = backpropType
        self.tbpttFwdLength = tbpttFwdLength
        self.tbpttBackLength = tbpttBackLength
        self.gradientNormalization = defaults.get("gradientNormalization")
        self.gradientNormalizationThreshold = defaults.get(
            "gradientNormalizationThreshold", 1.0)
        self.optimizationAlgo = defaults.get(
            "optimizationAlgo", "STOCHASTIC_GRADIENT_DESCENT")
        self.maxNumLineSearchIterations = defaults.get(
            "maxNumLineSearchIterations", 20)
        self.checkpointPolicy = defaults.get("checkpointPolicy")
        self.activationCheckpointing = defaults.get(
            "activationCheckpointing", False)
        self.topoOrder = self._topo_sort()
        self._infer_shapes()

    def toJson(self) -> str:
        """Config-only JSON in the reference's format (reference:
        ComputationGraphConfiguration.toJson; ``util.serde``)."""
        from deeplearning4j_tpu_torch.util import serde

        return serde.to_json(self)

    @staticmethod
    def fromJson(text: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.util import serde

        return serde.from_json(text, ComputationGraphConfiguration)

    def _topo_sort(self):
        order, seen, temp = [], set(), set()

        def visit(name):
            if name in seen:
                return
            if name in temp:
                raise ValueError(f"Cycle detected at vertex '{name}'")
            temp.add(name)
            for dep in self.nodes[name].inputs:
                visit(dep)
            temp.discard(name)
            seen.add(name)
            order.append(name)

        for name in self.nodes:
            visit(name)
        return order

    def _infer_shapes(self):
        if not self.inputTypes:
            raise ValueError(
                "setInputTypes(...) is required for ComputationGraph")
        for name in self.topoOrder:
            node = self.nodes[name]
            if node.kind == "input":
                node.inputType = self.inputTypes[name]
                continue
            in_types = [self.nodes[i].inputType for i in node.inputs]
            if node.kind == "vertex":
                node.inputType = node.payload.getOutputType(*in_types)
                continue
            layer = node.payload
            layer.mergeGlobals(self.defaults)
            if getattr(layer, "multiInput", False):
                # multi-input layer node (AttentionVertex): all input types
                # flow through; no auto preprocessor between sequences
                layer.inferNIn(*in_types)
                node.layerInputType = list(in_types)
                node.inputType = layer.getOutputType(*in_types)
                continue
            cur = in_types[0]
            if node.preprocessor is None:
                pp, cur2 = self._auto_pp(layer, cur)
                if pp is not None:
                    node.preprocessor = pp
                    cur = cur2
            else:
                cur = node.preprocessor.getOutputType(cur)
            if hasattr(layer, "inferNIn"):
                layer.inferNIn(cur)
            node.layerInputType = cur
            node.inputType = layer.getOutputType(cur)

    @staticmethod
    def _auto_pp(layer, cur):
        from deeplearning4j_tpu_torch.nn.conf.builder import auto_preprocessor

        return auto_preprocessor(layer, cur)


class GraphBuilder:
    """Reference: ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, defaults):
        self._defaults = defaults
        self._nodes = {}
        self._inputs = []
        self._outputs = []
        self._inputTypes = {}
        self._backpropType = "standard"
        self._tbpttFwd = self._tbpttBack = 20

    def addInputs(self, *names):
        for n in names:
            self._inputs.append(n)
            self._nodes[n] = _Node(n, "input")
        return self

    def addLayer(self, name, layer, *inputs, preprocessor=None):
        node = _Node(name, "layer", layer, inputs)
        node.preprocessor = preprocessor
        self._nodes[name] = node
        return self

    def layer(self, name, layer, *inputs):
        return self.addLayer(name, layer, *inputs)

    def addVertex(self, name, vertex, *inputs):
        # parameterized vertices (AttentionVertex) carry the Layer
        # interface; the executor runs them as (multi-input) layer nodes
        kind = "layer" if isinstance(vertex, L.Layer) else "vertex"
        self._nodes[name] = _Node(name, kind, vertex, inputs)
        return self

    def setOutputs(self, *names):
        self._outputs = list(names)
        return self

    def setInputTypes(self, *types):
        for n, t in zip(self._inputs, types):
            self._inputTypes[n] = t
        return self

    def inputPreProcessor(self, layerName, pp):
        self._nodes[layerName].preprocessor = pp
        return self

    def backpropType(self, bp):
        self._backpropType = bp
        return self

    def tBPTTForwardLength(self, n):
        self._tbpttFwd = n
        return self

    def tBPTTBackwardLength(self, n):
        self._tbpttBack = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("addInputs(...) required")
        if not self._outputs:
            raise ValueError("setOutputs(...) required")
        for name, node in self._nodes.items():
            for dep in node.inputs:
                if dep not in self._nodes:
                    raise ValueError(
                        f"Vertex '{name}' references unknown input '{dep}'")
        if str(self._backpropType).lower().startswith("t"):
            bad = [n for n, node in self._nodes.items()
                   if isinstance(node.payload, _TIME_VERTICES)]
            if bad:
                raise ValueError(
                    f"vertices {bad} need the full sequence and are "
                    "incompatible with truncated BPTT (each tbptt window "
                    "would be processed independently)")
        return ComputationGraphConfiguration(
            self._nodes, self._inputs, self._outputs, self._defaults,
            self._inputTypes, self._backpropType, self._tbpttFwd,
            self._tbpttBack)
