"""MultiLayerNetwork, and the network helpers ``nn/graph.py`` shares.

The counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: the
module-level helpers (``_unwrap``, ``_tm`` training telemetry,
``strip_carries``, ``cast_params``, ``default_param_update``,
``_grad_normalize``, ``_out_act``), the carry of the reference's weights
(``params_from_reference`` / ``params_to_reference``, layer by layer
through each layer's layout map) and the ``MultiLayerNetwork`` class.

Where the reference jits one donated-buffer train step, the port runs it
eagerly: the forward over the layers (BN's running statistics come back
as the layers' new state), the loss on the output layer and the
regularization, ``loss.backward()``, gradient normalization, then each
layer's updater applied in place under ``torch.no_grad()``. Parameters
are a list of per-layer ``{name: tensor}`` dicts with the reference's
names, fp32 masters (fp64 under ``DataType.DOUBLE``) cast to the compute
dtype for the forward. Convolutional activations are NCHW-logical in
``channels_last`` memory; an ``InputType.convolutional(.., format=
"NHWC")`` network takes NHWC features. ``output`` and ``feedForward``
return ``INDArray``s, as the reference does; ``fit``, ``score`` and
``output`` take INDArrays, tensors or numpy arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray
from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.builder import (
    GradientNormalization, refuse_checkpoint_policy,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["MultiLayerNetwork", "strip_carries", "cast_params",
           "default_param_update", "params_from_reference",
           "params_to_reference"]


def _later(what, slice_):
    return NotImplementedError(
        f"{what} waits for the {slice_} (ROADMAP.md Queue 1)")


def _unwrap(x, device=None):
    """An INDArray, tensor, numpy array or nested list as a tensor on
    `device`."""
    if x is None:
        return None
    if isinstance(x, INDArray):
        x = x.tensor()
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device or "cpu")


_TM = None


def _tm():
    """Training telemetry handles, resolved once: the ``train.step`` span
    and the step histogram and counter on the port's registry."""
    global _TM
    if _TM is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        _TM = {
            "reg": reg,
            "step_s": reg.histogram(
                "dl4j_train_step_seconds",
                "train-step wall: forward, backward, update and the loss "
                "fetch, host-observed").labels(),
            "steps": reg.counter(
                "dl4j_train_steps_total", "optimizer steps applied").labels(),
        }
    return _TM


def strip_carries(states):
    """Drop transient rnn carries (h/c) from a {layer: state} dict; keep
    persistent state."""

    def strip(s):
        if isinstance(s, dict):
            return {k: strip(v) for k, v in s.items() if k not in ("h", "c")}
        return s

    return {n: strip(s) for n, s in states.items()}


def cast_params(p, compute_dtype, param_dtype):
    """fp32 master params -> the compute dtype (bf16/fp16) for the
    forward; autograd carries the gradient back to the fp32 master."""
    if compute_dtype == param_dtype:
        return p
    return {k: a.to(compute_dtype) if a.is_floating_point() else a
            for k, a in p.items()}


def default_param_update(updater, grads, upd_state, iteration, params):
    """Apply one layer's updater and subtract its updates from the params
    in place (the caller holds ``torch.no_grad()``)."""
    upd, us = updater.apply(grads, upd_state, iteration, params=params)
    for k, p in params.items():
        p.sub_(upd[k].to(p.dtype))
    return params, us


def _grad_normalize(grads_per_layer, mode, threshold):
    """Gradient clipping/normalization over per-layer {name: grad} dicts
    (reference: GradientNormalization)."""
    if mode is None:
        return grads_per_layer
    out = []
    for g in grads_per_layer:
        if not g:
            out.append(g)
            continue
        if mode == GradientNormalization.ClipElementWiseAbsoluteValue:
            g = {k: torch.clamp(a, -threshold, threshold)
                 for k, a in g.items()}
        elif mode in (GradientNormalization.ClipL2PerLayer,
                      GradientNormalization.RenormalizeL2PerLayer):
            l2 = torch.sqrt(sum(a.square().sum() for a in g.values())
                            + 1e-12)
            scale = (torch.clamp(threshold / l2, max=1.0)
                     if mode == GradientNormalization.ClipL2PerLayer
                     else 1.0 / l2)
            g = {k: a * scale for k, a in g.items()}
        elif mode in (GradientNormalization.ClipL2PerParamType,
                      GradientNormalization.RenormalizeL2PerParamType):
            def per_param(a):
                l2 = torch.sqrt(a.square().sum() + 1e-12)
                if mode == GradientNormalization.ClipL2PerParamType:
                    return a * torch.clamp(threshold / l2, max=1.0)
                return a / l2
            g = {k: per_param(a) for k, a in g.items()}
        out.append(g)
    return out


def _out_act(layer, pre):
    """The output activation over the CLASS axis: NCW [B,O,T] output
    needs softmax over O, not the trailing time axis."""
    act = _act.get(layer.activation)
    if pre.dim() == 3:
        return act(pre.transpose(1, 2)).transpose(1, 2)
    return act(pre)


def layer_seed(seed, i):
    """The init stream of layer i: a function of (seed, i) only."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, i])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def to_api_layout(t, nhwc):
    """A 4-d activation (NCHW-logical) in the API's layout: NHWC for an
    NHWC-format network, else as it is."""
    return t.permute(0, 2, 3, 1) if nhwc and t.dim() == 4 else t


def cnn_entry(x, it):
    """A network input in the internal layout for its InputType: a CNN
    feed [B,C,H,W] to channels_last (an NHWC feed [B,H,W,C] through a
    permute, which is channels_last already), a convolutionalFlat feed
    [B, C*H*W] reshaped to [B,C,H,W]; anything else as it is."""
    if it is not None and it.kind == InputType.CNN and x.dim() == 4:
        if getattr(it, "format", "NCHW") == "NHWC":
            return x.permute(0, 3, 1, 2)
        return x.contiguous(memory_format=torch.channels_last)
    if it is not None and it.kind == InputType.CNN_FLAT and x.dim() == 2:
        x = x.reshape(x.shape[0], it.channels, it.height, it.width)
        return x.contiguous(memory_format=torch.channels_last)
    return x


def fit_batches(net, data, labels, epochs, step_arrays, step_ds):
    """The ``fit`` contract both networks share: (features, labels) ->
    ``step_arrays(data, labels)``; a DataSet -> ``step_ds(ds)``; an
    iterator (reset/hasNext/next) -> ``step_ds`` on each batch, for
    ``epochs`` (default 1) passes. Each step returns its loss tensor,
    recorded as the score with the ``train.step`` span and histogram."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    net._require_init()
    if net.conf.backpropType == "tbptt":
        raise _later("truncated BPTT", "recurrent slice, item 8")
    if labels is not None:
        _timed_step(net, lambda: step_arrays(data, labels))
    elif isinstance(data, DataSet):
        _timed_step(net, lambda: step_ds(data))
    elif all(callable(getattr(data, a, None))
             for a in ("reset", "hasNext", "next")):
        for _ in range(epochs or 1):
            data.reset()
            while data.hasNext():
                ds = data.next()
                _timed_step(net, lambda: step_ds(ds))
            net._epoch += 1
    else:
        raise TypeError(
            "fit takes (features, labels) arrays or tensors, a DataSet, or "
            f"a DataSetIterator (reset/hasNext/next), got "
            f"{type(data).__name__}")
    return net


def _timed_step(net, step):
    tm = _tm()
    t0 = time.perf_counter()
    net._score = float(step())
    dt = time.perf_counter() - t0
    tm["step_s"].observe(dt)
    tm["steps"].inc()
    tm["reg"].add_span("train.step", "train", t0, dt,
                       iteration=net._iteration)
    net._iteration += 1


# ----------------------------------------------------------------------
# carrying the reference's weights across
# ----------------------------------------------------------------------

def _tensor(a):
    """A numpy array as a CPU tensor; bf16 (numpy's ml_dtypes type)
    comes across bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t):
    """A tensor as a numpy array (bf16 widened to float32, exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def carry_layer(layer, tree):
    """One layer's reference {name: array} -> the port's {name: tensor},
    through the layer's layout map."""
    return {k: layer.param_from_reference(k, _tensor(v))
            for k, v in tree.items()}


def uncarry_layer(layer, tree):
    """One layer's port {name: tensor} -> the reference's layout as
    numpy (bf16 as float32)."""
    return {k: _array(layer.param_to_reference(k, v))
            for k, v in tree.items()}


def params_from_reference(layers, params, states=None):
    """The reference MultiLayerNetwork's ``_params`` (and ``_states``),
    lists of per-layer {name: array} after ``jax.tree.map(np.asarray,
    ...)``, as the port's lists of CPU tensors in its layouts. Returns
    (params, states or None)."""
    ps = [carry_layer(l, p) for l, p in zip(layers, params)]
    ss = None if states is None else [carry_layer(l, s)
                                      for l, s in zip(layers, states)]
    return ps, ss


def params_to_reference(layers, params):
    """The inverse of ``params_from_reference`` for params or gradients:
    the port's per-layer dicts in the reference's layouts, as numpy."""
    return [uncarry_layer(l, p) for l, p in zip(layers, params)]


def check_carried(src, dst, where):
    """Raise unless `src` has exactly `dst`'s names and shapes."""
    if set(src) != set(dst):
        raise ValueError(f"{where}: reference names {sorted(src)} vs "
                         f"{sorted(dst)}")
    for k, v in src.items():
        if tuple(v.shape) != tuple(dst[k].shape):
            raise ValueError(f"{where}.{k}: reference shape "
                             f"{tuple(v.shape)} vs {tuple(dst[k].shape)}")


# ----------------------------------------------------------------------
# MultiLayerNetwork
# ----------------------------------------------------------------------

class MultiLayerNetwork:
    """A sequential network over ``MultiLayerConfiguration.layers``
    (reference: MultiLayerNetwork)."""

    def __init__(self, conf, device=None):
        refuse_checkpoint_policy(conf.checkpointPolicy)
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self._params = None       # [ {param_name: tensor} ] per layer
        self._states = None
        self._upd_states = None
        self._updaters = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._compute_dtype = conf.dataType.torch_dtype
        self._param_dtype = (torch.float64
                             if self._compute_dtype == torch.float64
                             else torch.float32)

    def init(self):
        """Initialize parameters, layer state and updater state."""
        params, states = [], []
        for i, layer in enumerate(self.layers):
            gen = torch.Generator().manual_seed(layer_seed(self.conf.seed, i))
            p, s = layer.initialize(gen, self.conf.layerInputTypes[i],
                                    self._param_dtype, self.device)
            params.append(p)
            states.append(s)
        self._set_params(params, states)
        self._iteration = 0
        return self

    def _set_params(self, params, states=None):
        self._params = [{k: v.detach().to(self.device, self._param_dtype)
                         .requires_grad_(True) for k, v in p.items()}
                        for p in params]
        if states is not None:
            self._states = [{k: v.to(self.device) for k, v in s.items()}
                            for s in states]
        self._updaters = [_upd.resolve(l.updater) if l.updater is not None
                          else _upd.Sgd() for l in self.layers]
        with torch.no_grad():
            self._upd_states = [u.init(p) if p else ()
                                for u, p in zip(self._updaters,
                                                self._params)]

    def load_reference_params(self, params, states=None):
        """Set the parameters (and, when given, the layer states: BN's
        running mean and var) from the reference network's ``_params``
        and ``_states`` (``params_from_reference``), and reset the
        updater state."""
        self._require_init()
        ps, ss = params_from_reference(self.layers, params, states)
        if len(ps) != len(self._params):
            raise ValueError(f"{len(ps)} reference layers vs "
                             f"{len(self._params)}")
        for i, p in enumerate(ps):
            check_carried(p, self._params[i], f"layer {i}")
            if ss is not None:
                check_carried(ss[i], self._states[i], f"layer {i} state")
        self._set_params(ps, ss)
        return self

    def _require_init(self):
        if self._params is None:
            raise RuntimeError("Call net.init() before fit/output/score")

    @property
    def _api_nhwc(self):
        it = self.conf.inputType
        return (it is not None and it.kind == InputType.CNN
                and getattr(it, "format", "NCHW") == "NHWC")

    def _entry(self, x):
        x = _unwrap(x, self.device).to(self._compute_dtype)
        return cnn_entry(x, self.conf.inputType)

    def _run_layers(self, params, states, x, train, fmask):
        """-> (the output layer's pre-activation, or the last layer's
        output when the last layer is not an output layer; new states)."""
        h = self._entry(x)
        B = h.shape[0]
        new_states = []
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            pp = self.conf.preprocessors.get(i)
            if pp is not None:
                if hasattr(pp, "batch"):
                    pp.batch = B
                h = pp.preProcess(h, fmask)
            p = cast_params(params[i], self._compute_dtype, self._param_dtype)
            if i == last and isinstance(layer, L.BaseOutputLayer):
                h = layer._dropout_input(h, train, None)
                new_states.append(states[i])
                return layer.preoutput(p, h), new_states
            h, s = layer.forward(p, states[i], h, train, None, fmask)
            new_states.append(s)
        return h, new_states

    def _loss_from_preact(self, preact, y, lmask):
        last = self.layers[-1]
        if not isinstance(last, L.BaseOutputLayer):
            raise ValueError("The last layer must be an OutputLayer to "
                             "compute a loss")
        ldt = _losses.tail_dtype(preact.dtype)
        preact, y = preact.to(ldt), y.to(ldt)
        if preact.dim() == 3:   # RnnOutputLayer: loss over [B,T,O]
            preact, y = preact.transpose(1, 2), y.transpose(1, 2)
        return _losses.compute(last.lossFunction, y, preact,
                               last.activation, lmask)

    def _regularization(self, params):
        reg = 0.0
        for layer, p in zip(self.layers, params):
            if p:
                reg = reg + layer.regularization(p)
        return reg

    def _loss_fn(self, params, states, x, y, fmask, lmask, train=True):
        preact, new_states = self._run_layers(params, states, x, train,
                                              fmask)
        loss = self._loss_from_preact(preact, _unwrap(y, self.device),
                                      lmask) + self._regularization(params)
        return loss, new_states

    def _train_step(self, x, y, fmask, lmask):
        """One eager step: forward, backward, normalize, update in place;
        the layers' new states (BN running statistics) replace the old.
        Returns the loss tensor."""
        loss, new_states = self._loss_fn(self._params, self._states, x, y,
                                         fmask, lmask)
        loss.backward()
        grads = [{k: t.grad if t.grad is not None else torch.zeros_like(t)
                  for k, t in p.items()} for p in self._params]
        glist = _grad_normalize(grads, self.conf.gradientNormalization,
                                self.conf.gradientNormalizationThreshold)
        with torch.no_grad():
            for i, g in enumerate(glist):
                if self._params[i]:
                    _, self._upd_states[i] = default_param_update(
                        self._updaters[i], g, self._upd_states[i],
                        self._iteration, self._params[i])
        for p in self._params:
            for t in p.values():
                t.grad = None
        self._states = [{k: v.detach() for k, v in s.items()}
                        for s in new_states]
        return loss.detach()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs=None):
        """fit(x, y) | fit(DataSet) | fit(DataSetIterator[, epochs]):
        one optimizer step per batch."""
        return fit_batches(
            self, data, labels, epochs,
            lambda x, y: self._train_step(x, y, None, None),
            lambda ds: self._train_step(
                ds.getFeatures(), ds.getLabels(),
                _unwrap(ds.getFeaturesMaskArray(), self.device),
                _unwrap(ds.getLabelsMaskArray(), self.device)))

    def fitSteps(self, data, labels=None, numSteps=1):
        raise _later("fitSteps", "nn-conf slice, item 4")

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=None):
        raise _later("fitDataSet", "nn-conf slice, item 4")

    def pretrain(self, iterator, epochs=1):
        raise _later("layerwise pretraining", "nn-conf slice, item 4")

    def pretrainLayer(self, layerIdx, data, epochs=1):
        raise _later("layerwise pretraining", "nn-conf slice, item 4")

    def rnnTimeStep(self, x):
        raise _later("rnnTimeStep", "recurrent slice, item 8")

    def output(self, x, train=False):
        """The output layer's activations as an ``INDArray`` (inference
        mode: BN uses its running statistics)."""
        self._require_init()
        with torch.no_grad():
            h, _ = self._run_layers(self._params, self._states, x, False,
                                    None)
        last = self.layers[-1]
        return INDArray(_out_act(last, h)
                        if isinstance(last, L.BaseOutputLayer) else h)

    def feedForward(self, x):
        """The input and every layer's activation, in inference mode, as
        ``INDArray``s; 4-d ones in the API's layout (the reference returns
        its internal NHWC)."""
        self._require_init()
        with torch.no_grad():
            h = self._entry(x)
            B = h.shape[0]
            acts = [h]
            for i, layer in enumerate(self.layers):
                pp = self.conf.preprocessors.get(i)
                if pp is not None:
                    if hasattr(pp, "batch"):
                        pp.batch = B
                    h = pp.preProcess(h, None)
                p = cast_params(self._params[i], self._compute_dtype,
                                self._param_dtype)
                h, _ = layer.forward(p, self._states[i], h, False, None,
                                     None)
                acts.append(h)
        return [INDArray(to_api_layout(a, self._api_nhwc)) for a in acts]

    def score(self, dataset=None) -> float:
        """The loss of the last fit step, or of a DataSet in inference
        mode (reference: ``score``)."""
        if dataset is None:
            return self._score
        self._require_init()
        if not hasattr(dataset, "getFeatures"):
            raise TypeError(f"score takes a DataSet, got "
                            f"{type(dataset).__name__}")
        with torch.no_grad():
            loss, _ = self._loss_fn(
                self._params, self._states, dataset.getFeatures(),
                dataset.getLabels(),
                _unwrap(dataset.getFeaturesMaskArray(), self.device),
                _unwrap(dataset.getLabelsMaskArray(), self.device),
                train=False)
        return float(loss)

    def computeGradientAndScore(self, x, y):
        """(grads, score) for gradient checks (reference:
        Model.computeGradientAndScore): grads is a list of per-layer
        {param_name: torch.Tensor}, in training mode. Neither the
        parameters nor the layer states are touched."""
        self._require_init()
        loss, _ = self._loss_fn(self._params, self._states, x, y, None,
                                None)
        flat = [(i, k, t) for i, p in enumerate(self._params)
                for k, t in p.items()]
        gs = torch.autograd.grad(loss, [t for _, _, t in flat],
                                 allow_unused=True)
        grads = [{} for _ in self._params]
        for (i, k, t), g in zip(flat, gs):
            grads[i][k] = torch.zeros_like(t) if g is None else g
        return grads, float(loss.detach())

    def numParams(self) -> int:
        return sum(t.numel() for p in self._params for t in p.values())

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch
