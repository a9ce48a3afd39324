"""ComputationGraph — the DAG network executor.

The counterpart of ``deeplearning4j_tpu/nn/graph.py`` for the SGD-family
training path. Where the reference jits one donated-buffer train step,
the port runs it eagerly: the forward over the DAG (every vertex, the
loss on every output layer, the regularization), ``loss.backward()``,
gradient normalization, then each layer's updater applied to its
parameters in place under ``torch.no_grad()``. Attention layers reach
the hand-written flash kernels through ``ops.flash_attention``.

Parameters are fp32 master tensors (fp64 under ``DataType.DOUBLE``) in a
``{layer_name: {param_name: tensor}}`` dict with the reference's names
and layouts; a bf16/fp16 ``dataType`` casts them for the forward and
autograd carries the gradient back to the fp32 master. Public methods
return ``torch.Tensor`` where the reference returns ``INDArray``; the
``INDArray`` wrapper waits for the ndarray slice (ROADMAP.md Queue 1
item 2). Solvers, truncated BPTT, ``fitDataSet``, ``DataSet`` and
``MultiDataSet``, the AOT cache, remat policies and evaluation wait for
their slices and raise ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import (
    _grad_normalize, _out_act, _tm, _unwrap, cast_params,
    default_param_update, strip_carries,
)

__all__ = ["ComputationGraph", "params_from_reference"]


def _later(what, slice_):
    return NotImplementedError(
        f"{what} waits for the {slice_} (ROADMAP.md Queue 1)")


def params_from_reference(tree):
    """The reference network's ``_params`` (after ``jax.tree.map(
    np.asarray, ...)``: ``{layer_name: {param_name: array}}``) as CPU
    tensors: a plain copy, both keep the ``[in, out]`` layout. bf16
    leaves (numpy's ml_dtypes type) come across bit for bit."""
    def tensor(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    return {name: {k: tensor(v) for k, v in p.items()}
            for name, p in tree.items()}


class ComputationGraph:
    def __init__(self, conf, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._layer_names = [n for n in conf.topoOrder
                             if conf.nodes[n].kind == "layer"]
        self._params = None      # {layer_name: {param_name: tensor}}
        self._states = None
        self._upd_states = None
        self._updaters = None
        self._iteration = 0
        self._score = float("nan")
        self._compute_dtype = conf.dataType.torch_dtype
        self._param_dtype = (torch.float64
                             if self._compute_dtype == torch.float64
                             else torch.float32)

    # ------------------------------------------------------------------
    def _layer_seed(self, i):
        """The init stream of layer i: a function of (seed, i) only."""
        ss = np.random.SeedSequence([int(self.conf.seed) & 0xFFFFFFFF, i])
        return int(ss.generate_state(1, np.uint64)[0] >> 1)

    def init(self):
        """Initialize parameters, layer state and updater state."""
        params, states = {}, {}
        for i, name in enumerate(self._layer_names):
            node = self.conf.nodes[name]
            gen = torch.Generator().manual_seed(self._layer_seed(i))
            p, s = node.payload.initialize(gen, node.layerInputType,
                                           self._param_dtype, self.device)
            params[name] = p
            states[name] = s
        self._set_params(params, states)
        return self

    def _set_params(self, params, states=None):
        self._params = {n: {k: v.detach().to(self.device, self._param_dtype)
                            .requires_grad_(True) for k, v in p.items()}
                        for n, p in params.items()}
        if states is not None:
            self._states = states
        self._updaters, self._upd_states = {}, {}
        for name in self._layer_names:
            payload = self.conf.nodes[name].payload
            u = _upd.resolve(payload.updater) \
                if payload.updater is not None else _upd.Sgd()
            self._updaters[name] = u
            with torch.no_grad():
                self._upd_states[name] = (u.init(self._params[name])
                                          if self._params[name] else ())

    def load_reference_params(self, tree):
        """Set the parameters from the reference network's ``_params``
        (``params_from_reference``) and reset the updater state."""
        self._require_init()
        src = params_from_reference(tree)
        if set(src) != set(self._params) or any(
                set(src[n]) != set(self._params[n]) for n in src):
            raise ValueError("reference params do not match this graph's "
                             "layers and parameter names")
        for n, p in src.items():
            for k, v in p.items():
                if tuple(v.shape) != tuple(self._params[n][k].shape):
                    raise ValueError(
                        f"{n}.{k}: reference shape {tuple(v.shape)} vs "
                        f"{tuple(self._params[n][k].shape)}")
        self._set_params(src)
        return self

    def _require_init(self):
        if self._params is None:
            raise RuntimeError("Call net.init() before fit/output/score")

    # ------------------------------------------------------------------
    def _entry(self, x):
        return _unwrap(x, self.device).to(self._compute_dtype)

    def _run_graph(self, params, states, inputs, train, gen, fmasks):
        """inputs: {name: tensor}. Returns (activations, preacts of the
        output layers, new states). A node's mask is its first input's
        mask (reference: ComputationGraph.feedForwardMaskArrays)."""
        acts, masks, new_states, preacts = {}, {}, {}, {}
        B = None
        for name in self.conf.networkInputs:
            x = self._entry(inputs[name])
            B = x.shape[0] if B is None else B
            acts[name] = x
            masks[name] = None if fmasks is None else fmasks.get(name)
        for name in self.conf.topoOrder:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            if node.kind == "vertex":
                pp = getattr(node.payload, "pp", None)
                if pp is not None and hasattr(pp, "batch"):
                    pp.batch = B  # FeedForwardToRnn needs B to un-flatten
                acts[name] = node.payload.apply([acts[i] for i in node.inputs])
                masks[name] = masks.get(node.inputs[0])
                continue
            layer = node.payload
            out_mask = masks.get(node.inputs[0])
            if getattr(layer, "multiInput", False):
                h = [acts[i] for i in node.inputs]
                # the KEYS' mask governs score masking; the output is
                # aligned to the query axis
                fmask = masks.get(node.inputs[1 if len(node.inputs) > 1
                                              else 0])
            else:
                h = acts[node.inputs[0]]
                fmask = out_mask
            if node.preprocessor is not None:
                if hasattr(node.preprocessor, "batch"):
                    node.preprocessor.batch = B
                h = node.preprocessor.preProcess(h)
            p = cast_params(params[name], self._compute_dtype,
                            self._param_dtype)
            if name in self.conf.networkOutputs and isinstance(
                    layer, L.BaseOutputLayer):
                h = layer._dropout_input(h, train, gen)
                pre = layer.preoutput(p, h)
                preacts[name] = pre
                acts[name] = _out_act(layer, pre)
                new_states[name] = states[name]
                continue
            h, s = layer.forward(p, states[name], h, train, gen, fmask)
            acts[name] = h
            masks[name] = out_mask
            new_states[name] = s
        return acts, preacts, new_states

    def _loss(self, preacts, labels, lmasks):
        total = 0.0
        for i, name in enumerate(self.conf.networkOutputs):
            layer = self.conf.nodes[name].payload
            pre = preacts[name]
            ldt = _losses.tail_dtype(pre.dtype)
            pre = pre.to(ldt)
            y = labels[i].to(ldt)
            if pre.dim() == 3:  # NCW preact: loss over [B,T,O]
                pre, y = pre.transpose(1, 2), y.transpose(1, 2)
            lmask = None if lmasks is None else lmasks[i]
            total = total + _losses.compute(layer.lossFunction, y, pre,
                                            layer.activation, lmask)
        return total

    def _regularization(self, params):
        reg = 0.0
        for name in self._layer_names:
            if params[name]:
                reg = reg + self.conf.nodes[name].payload.regularization(
                    params[name])
        return reg

    def _loss_fn(self, params, states, inputs, labels, fmasks, lmasks):
        _, preacts, new_states = self._run_graph(
            params, strip_carries(states), inputs, True, None, fmasks)
        loss = self._loss(preacts, labels, lmasks) \
            + self._regularization(params)
        return loss, new_states

    def _train_step(self, inputs, labels, fmasks, lmasks):
        """One eager step: forward, backward, normalize, update in place.
        Returns the loss tensor."""
        for p in self._params.values():
            for t in p.values():
                t.grad = None
        loss, new_states = self._loss_fn(self._params, self._states, inputs,
                                         labels, fmasks, lmasks)
        loss.backward()
        grads = [{k: t.grad if t.grad is not None else torch.zeros_like(t)
                  for k, t in self._params[n].items()}
                 for n in self._layer_names]
        glist = _grad_normalize(grads, self.conf.gradientNormalization,
                                self.conf.gradientNormalizationThreshold)
        with torch.no_grad():
            for name, g in zip(self._layer_names, glist):
                if not self._params[name]:
                    continue
                _, self._upd_states[name] = default_param_update(
                    self._updaters[name], g, self._upd_states[name],
                    self._iteration, self._params[name])
        for p in self._params.values():
            for t in p.values():
                t.grad = None
        self._states = new_states
        return loss.detach()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _coerce_inputs(self, features):
        arrs = list(features) if isinstance(features, (list, tuple)) \
            else [features]
        return dict(zip(self.conf.networkInputs, arrs))

    def _coerce_labels(self, labels):
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        return [_unwrap(y, self.device) for y in labs]

    def fit(self, data, labels=None, epochs=None):
        """One optimizer step on (features, labels): arrays or tensors,
        or lists of them for multi-input/-output graphs. DataSets and
        iterators wait for the data slice."""
        self._require_init()
        if labels is None:
            raise _later("fit(DataSet / iterator)", "data slice, item 10")
        if self.conf.backpropType == "tbptt":
            raise _later("truncated BPTT", "recurrent slice, item 8")
        inputs = self._coerce_inputs(data)
        labs = self._coerce_labels(labels)
        tm = _tm()
        t0 = time.perf_counter()
        loss = self._train_step(inputs, labs, None, None)
        self._score = float(loss)
        dt = time.perf_counter() - t0
        tm["step_s"].observe(dt)
        tm["steps"].inc()
        tm["reg"].add_span("train.step", "train", t0, dt,
                           iteration=self._iteration)
        self._iteration += 1
        return self

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=None):
        raise _later("fitDataSet", "data slice, item 10")

    def precompile(self, *args, **kwargs):
        raise _later("precompile (the AOT cache)", "runtime slice, item 13")

    def evaluate(self, iterator):
        raise _later("evaluation", "training-runtime slice, item 10")

    def output(self, *features):
        """The output activations, one ``torch.Tensor`` per network
        output (a single tensor for one output)."""
        self._require_init()
        inputs = self._coerce_inputs(
            features if len(features) > 1 else features[0])
        with torch.no_grad():
            acts, _, _ = self._run_graph(self._params,
                                         strip_carries(self._states),
                                         inputs, False, None, None)
        outs = [acts[n] for n in self.conf.networkOutputs]
        return outs[0] if len(outs) == 1 else outs

    def outputSingle(self, *features) -> torch.Tensor:
        """The first output's activations as a ``torch.Tensor``."""
        out = self.output(*features)
        return out if isinstance(out, torch.Tensor) else out[0]

    def feedForward(self, *features, train=False):
        """Every vertex/layer activation by name, as ``torch.Tensor``s
        (reference: ComputationGraph.feedForward)."""
        self._require_init()
        inputs = self._coerce_inputs(
            features if len(features) > 1 else features[0])
        with torch.no_grad():
            acts, _, _ = self._run_graph(self._params,
                                         strip_carries(self._states),
                                         inputs, train, None, None)
        return acts

    def score(self, ds=None) -> float:
        """The loss of the last fit step (reference: Model.score()).
        Scoring a DataSet waits for the data slice."""
        if ds is not None:
            raise _later("score(DataSet)", "data slice, item 10")
        return self._score

    def computeGradientAndScore(self, inputs, labels):
        """(grads, score) for gradient checks (reference:
        Model.computeGradientAndScore): grads is ``{layer_name:
        {param_name: torch.Tensor}}``. The parameters are not touched."""
        self._require_init()
        feed = self._coerce_inputs(inputs)
        labs = self._coerce_labels(labels)
        loss, _ = self._loss_fn(self._params, self._states, feed, labs,
                                None, None)
        flat = [(n, k, t) for n in self._layer_names
                for k, t in self._params[n].items()]
        gs = torch.autograd.grad(loss, [t for _, _, t in flat],
                                 allow_unused=True)
        grads = {n: {} for n in self._layer_names}
        for (n, k, t), g in zip(flat, gs):
            grads[n][k] = torch.zeros_like(t) if g is None else g
        return grads, float(loss.detach())

    def numParams(self) -> int:
        return sum(t.numel() for p in self._params.values()
                   for t in p.values())

    def getIterationCount(self):
        return self._iteration
