"""Transfer learning.

The counterpart of ``deeplearning4j_tpu/nn/transfer.py`` (reference:
org.deeplearning4j.nn.transferlearning: TransferLearning.Builder and
GraphBuilder, FineTuneConfiguration, FrozenLayer,
TransferLearningHelper). Freezing is a config flag, as in the reference:
both networks cut a frozen layer's parameters from autograd
(``multilayer.train_params``), run it in inference mode and give it no
update, so no backward runs below the lowest trainable layer. The
builders copy the original network's configuration, freeze the trunk,
replace or append the head, and graft the trained parameters and layer
states into the layers they keep (as copies: the new network and the
original train independently). A transferred network is an ordinary
network: its model file (frozen flags included) loads in either package.
"""

from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, map_tree, strip_carries,
)

__all__ = ["FrozenLayer", "FineTuneConfiguration", "TransferLearning",
           "TransferLearningHelper"]


def _copy(tree):
    return map_tree(lambda t: t.detach().clone(), tree)


def FrozenLayer(layer):
    """Mark a layer config as frozen (reference: layers.misc.FrozenLayer).
    Returns the same config object with backprop disabled for its
    params."""
    layer.frozen = True
    return layer


class FineTuneConfiguration:
    """Overrides applied to every retained (non-frozen) layer and the
    global config when transferring (reference:
    transferlearning.FineTuneConfiguration)."""

    _LAYER_FIELDS = ("activation", "weightInit", "biasInit", "updater",
                     "biasUpdater", "l1", "l2", "l1Bias", "l2Bias",
                     "weightDecay", "dropOut")

    class Builder:
        def __init__(self):
            self._d = {}

        def seed(self, s):
            self._d["seed"] = int(s)
            return self

        def updater(self, u):
            from deeplearning4j_tpu_torch.nn import updaters as _upd

            self._d["updater"] = _upd.resolve(u)
            return self

        def activation(self, a):
            self._d["activation"] = a
            return self

        def weightInit(self, w):
            self._d["weightInit"] = w
            return self

        def biasInit(self, b):
            self._d["biasInit"] = float(b)
            return self

        def l1(self, v):
            self._d["l1"] = float(v)
            return self

        def l2(self, v):
            self._d["l2"] = float(v)
            return self

        def weightDecay(self, v):
            self._d["weightDecay"] = float(v)
            return self

        def dropOut(self, v):
            # float (retain prob) or an nn.conf.dropout.IDropout strategy
            self._d["dropOut"] = v if not isinstance(v, (int, float)) \
                else float(v)
            return self

        def build(self):
            return FineTuneConfiguration(self._d)

    def __init__(self, overrides: dict):
        self.overrides = dict(overrides)

    def applyToLayer(self, layer):
        for f in self._LAYER_FIELDS:
            if f in self.overrides:
                setattr(layer, f, self.overrides[f])


class TransferLearning:
    """Reference: transferlearning.TransferLearning.Builder (the
    MultiLayerNetwork variant); ``TransferLearning.GraphBuilder`` is the
    ComputationGraph one."""

    class Builder:
        def __init__(self, origNet: MultiLayerNetwork):
            if origNet._params is None:
                raise ValueError("original network must be initialized")
            self._orig = origNet
            self._ftc = None
            self._frozenTill = -1
            self._nOutReplace = {}   # idx -> (nOut, weightInit or None)
            self._removeFromOutput = 0
            self._appended = []

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, layerIndex: int):
            """Freeze layers [0..layerIndex] inclusive."""
            self._frozenTill = int(layerIndex)
            return self

        def nOutReplace(self, layerIndex: int, nOut: int, weightInit=None):
            """Change a layer's output size, re-initializing it and the
            next layer (whose nIn changes)."""
            self._nOutReplace[int(layerIndex)] = (int(nOut), weightInit)
            return self

        def removeOutputLayer(self):
            return self.removeLayersFromOutput(1)

        def removeLayersFromOutput(self, n: int):
            self._removeFromOutput += int(n)
            return self

        def addLayer(self, layer):
            self._appended.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            orig = self._orig
            oconf = orig.conf
            n_keep = len(oconf.layers) - self._removeFromOutput
            if n_keep < 0:
                raise ValueError("removed more layers than the network has")

            layers = [copy.deepcopy(l) for l in oconf.layers[:n_keep]]
            # fresh params at replaced layers, their successors and the
            # appended layers; everything else copies the trained weights
            fresh = set(range(n_keep, n_keep + len(self._appended)))
            for idx, (nOut, winit) in self._nOutReplace.items():
                if idx >= n_keep:
                    raise ValueError(f"nOutReplace index {idx} was removed")
                layers[idx].nOut = nOut
                if winit is not None:
                    layers[idx].weightInit = winit
                fresh.add(idx)
                if idx + 1 < n_keep:
                    nxt = layers[idx + 1]
                    if getattr(nxt, "nIn", None) is not None:
                        nxt.nIn = None  # re-infer from the new nOut
                    fresh.add(idx + 1)
            layers.extend(self._appended)

            defaults = dict(oconf.defaults)
            seed = oconf.seed
            if self._ftc is not None:
                defaults.update(self._ftc.overrides)
                seed = self._ftc.overrides.get("seed", seed)
                for i, l in enumerate(layers):
                    if i > self._frozenTill:
                        self._ftc.applyToLayer(l)
            for i in range(min(self._frozenTill + 1, len(layers))):
                layers[i].frozen = True

            # the retained prefix keeps its explicit preprocessors;
            # inferShapes re-derives the automatic ones for the new tail
            pps = {i: copy.deepcopy(pp)
                   for i, pp in oconf.preprocessors.items() if i < n_keep}
            conf = MultiLayerConfiguration(
                layers=layers,
                defaults=defaults,
                seed=seed,
                dataType=oconf.dataType,
                inputType=oconf.inputType,
                preprocessors=pps,
                backpropType=oconf.backpropType,
                tbpttFwdLength=oconf.tbpttFwdLength,
                tbpttBackLength=oconf.tbpttBackLength,
                gradientNormalization=oconf.gradientNormalization,
                gradientNormalizationThreshold=(
                    oconf.gradientNormalizationThreshold),
            )
            conf.inferShapes()

            net = MultiLayerNetwork(conf, device=orig.device).init()
            params, states = list(net._params), list(net._states)
            for i in range(n_keep):
                if i in fresh:
                    continue
                old_p = orig._params[i]
                for k, t in params[i].items():
                    if old_p[k].shape != t.shape:
                        raise ValueError(
                            f"layer {i} param '{k}' shape changed "
                            f"{tuple(old_p[k].shape)} -> {tuple(t.shape)}; "
                            "use nOutReplace")
                params[i] = _copy(old_p)
                states[i] = _copy(strip_carries(orig._states)[i])
            net._set_params(params, states)
            return net


class TransferLearningHelper:
    """Featurize once through the frozen bottom, train only the top
    (reference: transferlearning.TransferLearningHelper); saves the
    frozen forward of every epoch over a static dataset."""

    def __init__(self, net: MultiLayerNetwork, frozenTill: int):
        self._net = net
        self._split = int(frozenTill) + 1
        top_conf = MultiLayerConfiguration(
            layers=net.conf.layers[self._split:],
            defaults=net.conf.defaults,
            seed=net.conf.seed,
            dataType=net.conf.dataType,
            inputType=net.conf.layerInputTypes[self._split],
            preprocessors={i - self._split: pp
                           for i, pp in net.conf.preprocessors.items()
                           if i >= self._split},
            backpropType=net.conf.backpropType,
            tbpttFwdLength=net.conf.tbpttFwdLength,
            tbpttBackLength=net.conf.tbpttBackLength,
        )
        top_conf.layerInputTypes = net.conf.layerInputTypes[self._split:]
        self._top = MultiLayerNetwork(top_conf, device=net.device)
        n = len(net.layers)
        states = strip_carries(net._states)
        self._top.initFrom([_copy(net._params[i])
                            for i in range(self._split, n)],
                           [_copy(states[i]) for i in range(self._split, n)])

    def featurize(self, dataset):
        """Run the frozen bottom: a DataSet of (the activations at the
        boundary, in the API's layout; the original labels and masks)."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        feat = self._net.feedForward(dataset.getFeatures())[self._split]
        return DataSet(feat.tensor(), dataset.getLabels(),
                       dataset.getFeaturesMaskArray(),
                       dataset.getLabelsMaskArray())

    def fitFeaturized(self, dataset):
        """Fit the top on featurized data, then write its params and
        states back into the full network (as copies)."""
        self._top.fit(dataset)
        with torch.no_grad():
            for j in range(len(self._top.layers)):
                dst = self._net._params[self._split + j]
                for k, t in self._top._params[j].items():
                    dst[k].copy_(t)
                self._net._states[self._split + j] = _copy(
                    self._top._states[j])
        return self

    def outputFromFeaturized(self, features):
        return self._top.output(features)

    def unfrozenMLN(self) -> MultiLayerNetwork:
        return self._top


class _TransferGraphBuilder:
    """Reference: transferlearning.TransferLearning.GraphBuilder, the
    ComputationGraph variant: freeze a trunk, remove or replace the head,
    graft the trained weights."""

    def __init__(self, origGraph):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        if not isinstance(origGraph, ComputationGraph):
            raise TypeError("GraphBuilder wraps a ComputationGraph; use "
                            "TransferLearning.Builder for MultiLayerNetwork")
        origGraph._require_init()
        self._orig = origGraph
        self._ftc = None
        self._frozen_upto = None       # vertex name: freeze its ancestors+it
        self._removed = set()
        self._keep_connections = set()
        self._added = []               # (name, payload, inputs)
        self._nOutReplace = {}         # layer name -> (nOut, weightInit)
        self._outputs = None

    def fineTuneConfiguration(self, ftc):
        self._ftc = ftc
        return self

    def setFeatureExtractor(self, vertexName):
        """Freeze `vertexName` and every node it (transitively) depends
        on: the trunk up to and including the named vertex."""
        if vertexName not in self._orig.conf.nodes:
            raise ValueError(f"unknown vertex '{vertexName}'")
        self._frozen_upto = vertexName
        return self

    def removeVertexAndConnections(self, name):
        self._removed.add(name)
        return self

    def removeVertexKeepConnections(self, name):
        """Remove `name` but keep edges referencing it: a re-added node
        with the same name takes its place in the graph."""
        self._removed.add(name)
        self._keep_connections.add(name)
        return self

    def addLayer(self, name, layer, *inputs):
        self._added.append((name, layer, inputs))
        return self

    def addVertex(self, name, vertex, *inputs):
        self._added.append((name, vertex, inputs))
        return self

    def nOutReplace(self, layerName, nOut, weightInit=None):
        node = self._orig.conf.nodes.get(layerName)
        if node is None or node.kind != "layer":
            raise ValueError(f"unknown layer '{layerName}' (nOutReplace "
                             f"takes a layer node of the original graph)")
        self._nOutReplace[layerName] = (int(nOut), weightInit)
        return self

    def setOutputs(self, *names):
        self._outputs = list(names)
        return self

    def _frozen_set(self, nodes):
        if self._frozen_upto is None:
            return set()
        frozen, stack = set(), [self._frozen_upto]
        while stack:
            n = stack.pop()
            if n in frozen or n not in nodes:
                continue
            frozen.add(n)
            stack.extend(nodes[n].inputs)
        return frozen

    def build(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        orig = self._orig
        oconf = orig.conf
        added_names = {n for n, _, _ in self._added}
        for r in self._keep_connections:
            if r not in added_names:
                raise ValueError(
                    f"removeVertexKeepConnections('{r}') needs a "
                    f"same-named replacement via addLayer/addVertex")

        defaults = dict(oconf.defaults)
        if self._ftc is not None:
            defaults.update(self._ftc.overrides)
        gb = GraphBuilder(defaults)
        gb.addInputs(*oconf.networkInputs)
        gb.setInputTypes(*[oconf.inputTypes[n] for n in oconf.networkInputs])

        frozen = self._frozen_set(oconf.nodes)
        fresh = set()  # layer names needing re-init (replaced or new nIn)
        kept = []
        for name in oconf.topoOrder:
            node = oconf.nodes[name]
            if node.kind == "input" or name in self._removed:
                continue
            for dep in node.inputs:
                if dep in self._removed and dep not in self._keep_connections:
                    raise ValueError(
                        f"node '{name}' references removed vertex '{dep}'; "
                        f"remove it too or re-add '{dep}'")
            payload = copy.deepcopy(node.payload)
            if name in self._nOutReplace:
                nOut, winit = self._nOutReplace[name]
                payload.nOut = nOut
                if winit is not None:
                    payload.weightInit = winit
                fresh.add(name)
            if name in frozen:
                payload.frozen = True
            elif self._ftc is not None and node.kind == "layer":
                self._ftc.applyToLayer(payload)
            if node.kind == "layer":
                gb.addLayer(name, payload, *node.inputs,
                            preprocessor=copy.deepcopy(node.preprocessor))
            else:
                gb.addVertex(name, payload, *node.inputs)
            kept.append(name)
        for name, payload, inputs in self._added:
            # addVertex dispatches Layer payloads to layer nodes itself
            gb.addVertex(name, payload, *inputs)
            fresh.add(name)
        # width changes flow through parameterless vertices (the
        # residual-graph case): a layer downstream of a replaced layer
        # re-infers nIn; whether its grafted weights survive is decided
        # by shape at graft time (maybe_resized)
        width_changed = set(self._nOutReplace) | set(self._keep_connections)
        maybe_resized = set()
        for name in list(gb._nodes):
            node = gb._nodes[name]
            if node.kind == "input" or not any(
                    d in width_changed for d in node.inputs):
                continue
            if node.kind == "vertex":
                width_changed.add(name)  # shape passes through
                continue
            p = node.payload
            if getattr(p, "nIn", None) is not None:
                p.nIn = None
            maybe_resized.add(name)
        outputs = self._outputs or oconf.networkOutputs
        for o in outputs:
            if o not in gb._nodes:
                raise ValueError(
                    f"output '{o}' does not exist in the new graph: call "
                    f"setOutputs(...) after removing/renaming an output "
                    f"vertex")
        gb.setOutputs(*outputs)
        gb.backpropType(oconf.backpropType)
        gb.tBPTTForwardLength(oconf.tbpttFwdLength)
        gb.tBPTTBackwardLength(oconf.tbpttBackLength)

        net = ComputationGraph(gb.build(), device=orig.device).init()
        params, states = dict(net._params), dict(net._states)
        ostates = strip_carries(orig._states)
        for name in kept:
            if name in fresh or name not in orig._params:
                continue
            old_p, new_p = orig._params[name], params.get(name)
            if not new_p:
                continue
            bad = [k for k in new_p if old_p[k].shape != new_p[k].shape]
            if bad:
                if name in maybe_resized:
                    continue  # width changed upstream: keep the fresh init
                k = bad[0]
                raise ValueError(
                    f"'{name}' param '{k}' shape changed "
                    f"{tuple(old_p[k].shape)} -> {tuple(new_p[k].shape)}; "
                    "use nOutReplace")
            params[name] = _copy(old_p)
            states[name] = _copy(ostates[name])
        net._set_params(params, states)
        return net


TransferLearning.GraphBuilder = _TransferGraphBuilder
