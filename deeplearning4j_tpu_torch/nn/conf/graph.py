"""ComputationGraph configuration: a DAG of layers and vertices.

The counterpart of ``deeplearning4j_tpu/nn/conf/graph.py`` for the
encoder slice: ``GraphVertex``, ``ElementWiseVertex`` (the residual add),
``PreprocessorVertex``, ``_Node``, ``ComputationGraphConfiguration``
(topological order, shape inference, the automatic preprocessor) and
``GraphBuilder``. Vertices are plain functions of their inputs; autograd
differentiates through them. The other vertices, JSON round trips and
truncated BPTT wait for their slices (ROADMAP.md Queue 1 items 5 and 8).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["GraphVertex", "ElementWiseVertex", "PreprocessorVertex",
           "ComputationGraphConfiguration", "GraphBuilder"]


class GraphVertex:
    """Parameterless DAG node combining input activations."""

    def apply(self, inputs: list):
        raise NotImplementedError

    def getOutputType(self, *inputTypes) -> InputType:
        raise NotImplementedError


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


class PreprocessorVertex(GraphVertex):
    def __init__(self, preProcessor):
        self.pp = preProcessor

    def apply(self, inputs):
        return self.pp.preProcess(inputs[0])

    def getOutputType(self, *its):
        return self.pp.getOutputType(its[0])


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
        self.checkpointPolicy = defaults.get("checkpointPolicy")
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
        return ComputationGraphConfiguration(
            self._nodes, self._inputs, self._outputs, self._defaults,
            self._inputTypes, self._backpropType, self._tbpttFwd,
            self._tbpttBack)
