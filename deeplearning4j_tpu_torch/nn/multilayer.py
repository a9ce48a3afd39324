"""MultiLayerNetwork, and the network helpers ``nn/graph.py`` shares.

The counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: the
module-level helpers (``_unwrap``, ``_tm`` training telemetry,
``strip_carries``, ``cast_params``, ``default_param_update``,
``_grad_normalize``, ``_out_act``, the truncated-BPTT window loop
``run_tbptt``), the carry of the reference's weights
(``params_from_reference`` / ``params_to_reference``, layer by layer
through each layer's layout map, nested wrapper trees included) and the
``MultiLayerNetwork`` class.

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

Recurrent layers hand their final carries (``"h"``/``"c"``) back in
their state. Standard backprop strips them before the forward and after
the step, so no carry outlives a ``fit``. Truncated BPTT runs
``ceil(T / tbpttFwdLength)`` windows, each one optimizer step that starts
from the previous window's carries, detached (the truncation). Stateful
inference is ``rnnTimeStep``; ``rnnStepBatched`` is its pure twin over
caller-held carries, the step the carry-slot sequence scheduler batches.
Both run their rows padded to a multiple of ``STEP_ROWS``, so every
batch of up to 8 rows, a single one included, takes the same product
shapes and each row is computed by the same kernels.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray
from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import recurrent as R
from deeplearning4j_tpu_torch.nn.conf.builder import (
    BackpropType, GradientNormalization, refuse_checkpoint_policy,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import norm as _norm

__all__ = ["MultiLayerNetwork", "strip_carries", "cast_params",
           "default_param_update", "params_from_reference",
           "params_to_reference", "run_tbptt", "STEP_ROWS"]

#: the single-step inference path pads its rows to a multiple of this,
#: so batches of 1..8 rows share one product shape (module docstring)
STEP_ROWS = 8


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
    """Drop transient rnn carries (h/c) from a container of per-layer
    states (a list, or a {layer: state} dict); keep persistent state."""

    def strip(s):
        if isinstance(s, dict):
            return {k: strip(v) for k, v in s.items() if k not in ("h", "c")}
        return s

    if isinstance(states, dict):
        return {n: strip(s) for n, s in states.items()}
    return [strip(s) for s in states]


def map_tree(fn, tree):
    """`fn` over every tensor of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def map_carries(fn, state):
    """`fn` over the rnn carries (h/c) of one layer's state, wrappers'
    nested states included; everything else as it is."""
    return {k: (map_carries(fn, v) if isinstance(v, dict)
                else fn(v) if k in ("h", "c") else v)
            for k, v in state.items()}


def run_tbptt(net, T, L, window_step):
    """The truncated-BPTT window loop MultiLayerNetwork and
    ComputationGraph share (reference: ``run_tbptt``): ceil(T / L)
    windows, the last one possibly short; ``window_step(sl, c)`` runs
    window c (time slice `sl`) as one timed optimizer step that starts
    from the carries window c - 1 left (none for c = 0) and returns its
    loss. The carries are stripped after the last window."""
    for c in range(math.ceil(T / L)):
        sl = slice(c * L, min((c + 1) * L, T))
        _timed_step(net, lambda: window_step(sl, c))
    net._states = strip_carries(net._states)


def time_slice(a, sl):
    """A sequence array's [B, C, T] time slice; feed-forward arrays and
    None pass whole."""
    return a[:, :, sl] if a is not None and a.dim() == 3 else a


def mask_slice(m, sl):
    """A [B, T] mask's time slice (None passes)."""
    return None if m is None else m[:, sl]


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
    ``epochs`` (default 1) passes. Each callback runs its batch's
    optimizer step (or truncated-BPTT windows) through ``_timed_step``."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    net._require_init()
    if labels is not None:
        step_arrays(data, labels)
    elif isinstance(data, DataSet):
        step_ds(data)
    elif all(callable(getattr(data, a, None))
             for a in ("reset", "hasNext", "next")):
        for _ in range(epochs or 1):
            data.reset()
            while data.hasNext():
                step_ds(data.next())
            net._epoch += 1
    else:
        raise TypeError(
            "fit takes (features, labels) arrays or tensors, a DataSet, or "
            f"a DataSetIterator (reset/hasNext/next), got "
            f"{type(data).__name__}")
    return net


def _timed_step(net, step):
    """Run one optimizer step; its loss becomes the score, with the
    ``train.step`` span and histogram, and the iteration count moves."""
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


def flatten_tree(tree, prefix=""):
    """A nested {name: {...}} tree as one flat {"outer.inner": leaf}
    dict (a wrapper's ``{"fwd": {"W": ...}}`` -> ``{"fwd.W": ...}``);
    empty subtrees vanish."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def nest_tree(flat):
    """The inverse of ``flatten_tree``."""
    tree = {}
    for k, v in flat.items():
        *outer, leaf = k.split(".")
        node = tree
        for o in outer:
            node = node.setdefault(o, {})
        node[leaf] = v
    return tree


def carry_layer(layer, tree):
    """One layer's reference {name: array} tree (nested for a wrapper)
    -> the port's flat {name: tensor}, through the layer's layout map."""
    return {k: layer.param_from_reference(k, _tensor(v))
            for k, v in flatten_tree(tree).items()}


def uncarry_layer(layer, tree):
    """One layer's port {name: tensor} -> the reference's layout and
    nesting as numpy (bf16 as float32)."""
    return nest_tree({k: _array(layer.param_to_reference(k, v))
                      for k, v in tree.items()})


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
    """Raise unless `src` has exactly `dst`'s names and shapes (`dst`
    flattened as the carry flattens)."""
    dst = flatten_tree(dst)
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
        self._rnn_state = None    # rnnTimeStep's carried states
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
            self._states = map_tree(lambda t: t.to(self.device), states)
        self._rnn_state = None
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

    def _loss_fn(self, params, states, x, y, fmask, lmask, train=True,
                 use_carries=False):
        run_states = states if use_carries else strip_carries(states)
        preact, new_states = self._run_layers(params, run_states, x, train,
                                              fmask)
        loss = self._loss_from_preact(preact, _unwrap(y, self.device),
                                      lmask) + self._regularization(params)
        return loss, new_states

    def _train_step(self, x, y, fmask, lmask, window=None,
                    grad_transform=None, loss_transform=None,
                    state_transform=None, bn_group=None):
        """One eager step: forward, backward, normalize, update in place;
        the layers' new states (BN running statistics) replace the old.
        `window` is the truncated-BPTT window's index: window c > 0
        starts from the carries the last window left, and every window
        keeps its new carries, detached, for the next; a standard step
        (None) strips them. Returns the loss tensor.

        The hooks let the data-parallel trainers (``parallel.trainer``)
        splice in their collectives, in the reference's order
        (``nn/multilayer.py:974-992`` there): ``grad_transform`` maps the
        per-layer gradients right after the backward pass and before
        gradient normalization, ``loss_transform`` the detached loss (the
        score), ``state_transform`` the new layer states; BN takes its
        batch statistics over ``bn_group`` (``ops.norm.sync_batch_norm``)."""
        with _norm.sync_batch_norm(bn_group):
            loss, new_states = self._loss_fn(self._params, self._states, x,
                                             y, fmask, lmask,
                                             use_carries=bool(window))
        loss.backward()
        grads = [{k: t.grad if t.grad is not None else torch.zeros_like(t)
                  for k, t in p.items()} for p in self._params]
        if grad_transform is not None:
            grads = grad_transform(grads)
        loss = loss.detach()
        if loss_transform is not None:
            loss = loss_transform(loss)
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
        new_states = map_tree(torch.Tensor.detach, new_states)
        if window is None:
            new_states = strip_carries(new_states)
        if state_transform is not None:
            new_states = state_transform(new_states)
        self._states = new_states
        return loss

    def _fit_batch(self, x, y, fmask, lmask):
        """One batch: a timed optimizer step, or under truncated BPTT on
        [B, F, T] features the windows of ``run_tbptt``."""
        x, y = _unwrap(x, self.device), _unwrap(y, self.device)
        if (self.conf.backpropType == BackpropType.TruncatedBPTT
                and x.dim() == 3):
            run_tbptt(self, x.shape[2], self.conf.tbpttFwdLength,
                      lambda sl, c: self._train_step(
                          time_slice(x, sl), time_slice(y, sl),
                          mask_slice(fmask, sl), mask_slice(lmask, sl),
                          window=c))
        else:
            _timed_step(self, lambda: self._train_step(x, y, fmask, lmask))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs=None):
        """fit(x, y) | fit(DataSet) | fit(DataSetIterator[, epochs]):
        one optimizer step per batch."""
        return fit_batches(
            self, data, labels, epochs,
            lambda x, y: self._fit_batch(x, y, None, None),
            lambda ds: self._fit_batch(
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

    def output(self, x, train=False):
        """The output layer's activations as an ``INDArray`` (inference
        mode: BN uses its running statistics)."""
        self._require_init()
        with torch.no_grad():
            h, _ = self._run_layers(self._params,
                                    strip_carries(self._states), x, False,
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
            states = strip_carries(self._states)
            for i, layer in enumerate(self.layers):
                pp = self.conf.preprocessors.get(i)
                if pp is not None:
                    if hasattr(pp, "batch"):
                        pp.batch = B
                    h = pp.preProcess(h, None)
                p = cast_params(self._params[i], self._compute_dtype,
                                self._param_dtype)
                h, _ = layer.forward(p, states[i], h, False, None, None)
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

    # ------------------------------------------------------------------
    # stateful and slot-batched stepping (serving/sequence.py)
    # ------------------------------------------------------------------
    def _step(self, params, states, x):
        """The inference forward from carried states, rows padded with
        zeros to a multiple of STEP_ROWS and cut back after: (the output
        layer's activations, or the last layer's output, for the real
        rows; the new states, carries cut to those rows)."""
        B = x.shape[0]
        pad = (-B) % STEP_ROWS

        def grow(t):
            return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) \
                if pad else t

        x = grow(_unwrap(x, self.device))
        states = [map_carries(grow, s) for s in states]
        h, new_states = self._run_layers(params, states, x, False, None)
        last = self.layers[-1]
        if isinstance(last, L.BaseOutputLayer):
            h = _out_act(last, h)
        return h[:B], [map_carries(lambda t: t[:B], s) for s in new_states]

    def rnnTimeStep(self, x):
        """Stateful inference for generation (reference:
        MultiLayerNetwork.rnnTimeStep): x is [B, F, T] or one step [B, F]
        (answered in 2-d); each call starts from the carries the last one
        left (the layers' stripped states after rnnClearPreviousState)."""
        self._require_init()
        x = _unwrap(x, self.device)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, :, None]
        states = self._rnn_state if self._rnn_state is not None \
            else strip_carries(self._states)
        with torch.no_grad():
            h, self._rnn_state = self._step(self._params, states, x)
        if squeeze and h.dim() == 3:
            h = h[:, :, 0]
        return INDArray(h)

    def rnnClearPreviousState(self):
        self._rnn_state = None

    def rnnCarrySpec(self):
        """Per-layer carry keys for the stepwise path: ("h", "c") for the
        LSTMs, ("h",) for SimpleRnn/GRU, () for the rest. Raises for a
        layer that wraps its recurrent state (Bidirectional needs the
        whole sequence) and for a net with no recurrent layer."""
        spec = []
        for i, layer in enumerate(self.layers):
            if isinstance(layer, (R.Bidirectional, R.LastTimeStep)):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) wraps its "
                    "recurrent state: stepwise decode needs causal flat "
                    "h/c carries (LSTM/GravesLSTM/SimpleRnn/GRU)")
            if isinstance(layer, R.LSTM):
                spec.append(("h", "c"))
            elif isinstance(layer, R.BaseRecurrentLayer):
                spec.append(("h",))
            else:
                spec.append(())
        if not any(spec):
            raise ValueError(
                "no recurrent layers: nothing carries state between "
                "steps, so there is nothing to serve stepwise")
        return tuple(spec)

    def rnnCarryZeros(self, batch):
        """Zero carries, [batch, nOut] per carry key in the compute dtype
        on the network's device: the state a fresh sequence starts
        from."""
        return [{k: torch.zeros((int(batch), int(layer.nOut)),
                                dtype=self._compute_dtype,
                                device=self.device) for k in keys}
                for keys, layer in zip(self.rnnCarrySpec(), self.layers)]

    def _rnn_step(self, params, states, carries, x):
        """A pure single-timestep forward: x [S, F], carries shaped as
        rnnCarrySpec, [S, H] each. Returns (out [S, O], new carries); no
        ``_rnn_state`` is touched, and rows are independent."""
        spec = self.rnnCarrySpec()
        run = [{**st, **c} for st, c in zip(states, carries)]
        h, new_states = self._step(params, run, x[:, :, None])
        return h[:, :, 0] if h.dim() == 3 else h, \
            [{k: s[k] for k in keys} for keys, s in zip(spec, new_states)]

    def rnnStepBatched(self, x, carries):
        """One decode step for a slot batch: x [S, F] (tensor or numpy),
        carries from rnnCarryZeros or the last step. Returns (out [S, O]
        tensor in the compute dtype, new carries)."""
        self._require_init()
        with torch.no_grad():
            return self._rnn_step(self._params,
                                  strip_carries(self._states), carries,
                                  _unwrap(x, self.device))

    def numParams(self) -> int:
        return sum(t.numel() for p in self._params for t in p.values())

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch
