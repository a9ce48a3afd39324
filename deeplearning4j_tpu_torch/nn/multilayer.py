"""MultiLayerNetwork, and the network helpers ``nn/graph.py`` shares.

The counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: the
module-level helpers (``_unwrap``, ``_tm`` training telemetry,
``strip_carries``, ``cast_params``, ``default_param_update``,
``_grad_normalize``, ``_out_act``, the truncated-BPTT window loop
``run_tbptt``), the carry of the reference's weights
(``params_from_reference`` / ``params_to_reference``, layer by layer
through each layer's layout map, nested wrapper trees included), the
fitDataSet block driver (``BlockStager``, ``run_staged_blocks``,
``run_fit_dataset_epoch``), ``NetworkRuntime`` (what both networks share:
files, flat params in the reference's order, listeners, evaluation,
``fitSteps``, ``fitDataSet``) and the ``MultiLayerNetwork`` class; the
loss heads' helpers (``out_activation``, ``loss_for_head``: a 4-d
``CnnLossLayer`` map takes its class axis last, its label NCHW unless the
network is NHWC-format) and the remat policy (``remat_segment``).

Dropout draws from the step's key, ``dropout.step_key(seed, iteration)``
(folded with the rank under data parallelism, with the layer's index in
each layer), so a fitDataSet block, fitSteps, a resumed run and ``fit``
draw the same masks; frozen layers run without it. Weight noise draws
from the layer's key the same way (``forward_params``). Each step's
update goes through ``update_layer`` for both networks: nothing for a
frozen layer (its params take no gradient and no regularization either),
else the layer's updater (``layer_updater``: with a biasUpdater the
biases step by their own) and then its constraints. Layerwise
pretraining (``run_pretrain``) trains a pretrainable layer on its own
loss, fed by the inference forward below it, at the key
``pretrain_key(seed, iteration)``.

fitDataSet(stepsPerSync=k) issues a block of k steps back to back with
nothing read back: each loss stays a device tensor, the k are stacked
and copied to pinned host memory behind an event, and the host waits on
that event one block later, the block's one sync. Nothing in a step may
read a tensor on the host (``sync_free_blocks`` makes such a read raise
on the card). The dispatch side keeps its own iteration cursor for the
updater's schedule; ``_iteration`` and the listeners move at the sync.

Where the reference jits one donated-buffer train step, the port runs it
eagerly: the forward over the layers (BN's running statistics come back
as the layers' new state), the loss on the output layer and the
regularization, ``loss.backward()``, gradient normalization, then each
layer's updater applied in place under ``torch.no_grad()`` (under a
line-search ``optimizationAlgo``, one whole-parameter solver step of
``nn/solvers.py`` instead). Parameters
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
    BackpropType, GradientNormalization,
)
from deeplearning4j_tpu_torch.nn.conf.constraint import apply_constraints
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey, step_key
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.solvers import build_solver, network_step
from deeplearning4j_tpu_torch.ops import norm as _norm

__all__ = ["MultiLayerNetwork", "strip_carries", "cast_params",
           "default_param_update", "params_from_reference",
           "params_to_reference", "run_tbptt", "STEP_ROWS",
           "remat_segment", "product_segments", "is_product",
           "layer_trains"]

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
            "data_wait_s": reg.histogram(
                "dl4j_fit_dataset_data_wait_seconds",
                "fitDataSet: waiting on the iterator for a block's "
                "batches").labels(),
            "staging_s": reg.histogram(
                "dl4j_fit_dataset_staging_seconds",
                "fitDataSet: stacking a block and queueing its copy to "
                "the device").labels(),
            "sync_wait_s": reg.histogram(
                "dl4j_fit_dataset_sync_wait_seconds",
                "fitDataSet: the host blocked on a block's losses (its "
                "one sync)").labels(),
            "syncs": reg.counter(
                "dl4j_fit_dataset_syncs_total",
                "fitDataSet block syncs").labels(),
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
    needs softmax over O, not the trailing time axis. A head with its own
    loss (``outputFromPreact``) drops what its preoutput carries for the
    loss."""
    if hasattr(layer, "outputFromPreact"):
        return layer.outputFromPreact(pre)
    act = _act.get(layer.activation)
    if pre.dim() == 3:
        return act(pre.transpose(1, 2)).transpose(1, 2)
    return act(pre)


def _nhwc(t):
    """[B,C,H,W] -> [B,H,W,C] (a view)."""
    return t.permute(0, 2, 3, 1)


def out_activation(layer, pre, nhwc=False):
    """The output layer's activations in the API's layout: ``_out_act``,
    and a 4-d (CnnLossLayer) map activated over its channels, returned
    NCHW, or NHWC for an NHWC-format network."""
    if pre.dim() != 4 or hasattr(layer, "outputFromPreact"):
        return _out_act(layer, pre)
    out = _act.get(layer.activation)(_nhwc(pre))
    return out if nhwc else out.permute(0, 3, 1, 2)


def loss_for_head(layer, pre, y, lmask, nhwc, params=None):
    """A loss head's mean loss from its preoutput: NCW [B,O,T] as
    [B,T,O]; a 4-d map with the class axis last ([B,H,W,C]), its label
    NCHW from the API unless the network is NHWC-format (reference:
    ``_loss_from_preact`` / ``ComputationGraph._loss``). A head with its
    own loss (``computeLoss``: CenterLossOutputLayer, OCNNOutputLayer)
    computes it at f32 or wider from its preoutput and its `params` (in
    the compute dtype), as the reference does."""
    if hasattr(layer, "computeLoss"):
        wdt = torch.promote_types(pre.dtype, torch.float32)
        p = {k: v.to(pre.dtype) for k, v in (params or {}).items()}
        return layer.computeLoss(pre.to(wdt), y.to(wdt), lmask, p)
    ldt = _losses.tail_dtype(pre.dtype)
    pre, y = pre.to(ldt), y.to(ldt)
    if pre.dim() == 3:
        pre, y = pre.transpose(1, 2), y.transpose(1, 2)
    elif pre.dim() == 4:
        pre = _nhwc(pre)
        if not nhwc:
            y = _nhwc(y)
    return _losses.compute(layer.lossFunction, y, pre, layer.activation,
                           lmask)


def layer_trains(layer, train):
    """Whether `layer` runs in training mode: frozen layers run in
    inference mode, no dropout (reference: ``_run_layers``)."""
    return train and (not getattr(layer, "frozen", False)
                      or getattr(layer, "frozenKeepTraining", False))


def train_params(layer, p):
    """A frozen layer's params cut from autograd (their gradient is
    structurally zero, as the reference's stop_gradient); others as they
    are."""
    if getattr(layer, "frozen", False):
        return {k: t.detach() for k, t in p.items()}
    return p


def forward_params(layer, p, lk, compute_dtype, param_dtype):
    """A layer's params for its forward: cast to the compute dtype, and
    perturbed by its weight noise when it trains with a key (`lk`, its
    dropout key; the noise draws from ``lk.fold(0x5EED)``, as the
    reference folds its key)."""
    p = cast_params(p, compute_dtype, param_dtype)
    wn = getattr(layer, "weightNoise", None)
    if wn is not None and lk is not None:
        p = wn.apply(p, lk.fold(0x5EED))
    return p


def layer_updater(layer):
    """A layer's updater (Sgd when none is set); with a biasUpdater the
    biases take their own (``updaters.BiasSplit``)."""
    u = _upd.resolve(layer.updater) if layer.updater is not None \
        else _upd.Sgd()
    bu = getattr(layer, "biasUpdater", None)
    return u if bu is None else _upd.BiasSplit(u, _upd.resolve(bu))


def update_layer(layer, updater, grads, upd_state, it, params):
    """One layer's step in place under ``torch.no_grad()``: none for a
    frozen layer, else the updater's, then the layer's constraints
    (reference: ``_train_step``). Returns the updater state."""
    if not params or getattr(layer, "frozen", False):
        return upd_state
    _, upd_state = default_param_update(updater, grads, upd_state, it,
                                        params)
    apply_constraints(layer, params)
    return upd_state


def regularization(layers, params):
    """The summed penalty of the layers that train (frozen ones take
    none, as in the reference)."""
    reg = 0.0
    for layer, p in zip(layers, params):
        if p and not getattr(layer, "frozen", False):
            reg = reg + layer.regularization(p)
    return reg


def pretrain_key(seed, iteration):
    """A pretraining step's key (reference: ``fold_in(key(seed ^
    0xE1B0), iteration)``)."""
    return StepKey(int(seed) ^ 0xE1B0, iteration)


def pretrain_feeds(data, epochs):
    """The feature batches of a pretraining call: a DataSet's, a
    DataSetIterator's (reset each epoch) or a features array, `epochs`
    times."""
    for _ in range(epochs):
        if hasattr(data, "hasNext"):
            data.reset()
            while data.hasNext():
                yield data.next().getFeatures()
        elif hasattr(data, "getFeatures"):
            yield data.getFeatures()
        else:
            yield data


def run_pretrain(net, layer, key, feed, feeds):
    """Layerwise unsupervised pretraining of one layer (reference:
    ``pretrainLayer``): for each batch its input is ``feed(features)``,
    the frozen inference forward of what lies below; its params step by
    the layer's own updater and state against its ``pretrain_loss`` at
    the net's iteration, which moves one a batch. The losses stay on the
    device (``net._pretrain_losses``) and the last becomes the score,
    the call's one host read."""
    if net._solver is not None:
        raise ValueError(
            "layerwise pretraining uses the per-layer updater path; it is "
            "not defined under a whole-parameter optimizationAlgo "
            f"({net.conf.optimizationAlgo}): pretrain with "
            "STOCHASTIC_GRADIENT_DESCENT, then fine-tune with the solver")
    params, updater = net._params[key], net._updaters[key]
    names = list(params)
    losses = []
    for x in feeds:
        with torch.no_grad():
            h = feed(x)
        p = cast_params(params, net._compute_dtype, net._param_dtype)
        loss = layer.pretrain_loss(
            p, h, pretrain_key(net.conf.seed, net._iteration))
        gs = torch.autograd.grad(loss, [params[k] for k in names],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, gs)}
        with torch.no_grad():
            _, net._upd_states[key] = default_param_update(
                updater, grads, net._upd_states[key], net._iteration,
                params)
        losses.append(loss.detach())
        net._iteration += 1
    net._pretrain_losses = losses
    if losses:
        net._score = float(losses[-1])
    return net


def is_product(layer):
    """A layer whose output ends a remat segment: a convolution or a
    dense product (an output layer's too)."""
    return isinstance(layer, (L.ConvolutionLayer, L.FeedForwardLayer))


def product_segments(flags):
    """[lo, hi) ranges over a sequence of nodes, each ending just after
    a product (flags[i] True) or at the end."""
    out, lo = [], 0
    for i, f in enumerate(flags):
        if f:
            out.append((lo, i + 1))
            lo = i + 1
    if lo < len(flags):
        out.append((lo, len(flags)))
    return out


def remat_segment(fn, *args):
    """``fn(*args)``, one segment of the training forward under the
    "save_conv_outputs" policy (reference: ``_ckpt_loss_fn``). The
    networks cut their forward after every convolution and dense
    product and run each segment under ``torch.utils.checkpoint``, which
    keeps only the segment's inputs: the product outputs before it (and
    any earlier activation it reads, such as a residual shortcut). The
    backward recomputes a segment's BN, activations, pooling, dropout and
    closing product from those inputs when it reaches the segment, one
    segment at a time, so the other activations of the step are never
    held together. The recompute runs the same ops on the same inputs,
    so the gradients are the stock ones bit for bit; BN's running
    statistics come from the first forward only (the recompute's copies
    are dropped); dropout re-seeds each draw from its key, and
    synchronised BN re-enters the group it ran in."""
    from torch.utils.checkpoint import checkpoint

    group = _norm.current_sync_group()

    def run(*a):
        with _norm.sync_batch_norm(group):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


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


def fire(net, hook, *args):
    """Call `hook` on each of the net's listeners that has it (duck-typed
    listeners may lack the epoch, sync and resilience hooks)."""
    for lst in net._listeners:
        fn = getattr(lst, hook, None)
        if fn is not None:
            fn(net, *args)


def fit_batches(net, data, labels, epochs, step_arrays, step_ds):
    """The ``fit`` contract both networks share: (features, labels) ->
    ``step_arrays(data, labels)``; a DataSet -> ``step_ds(ds)``; an
    iterator (reset/hasNext/next) -> ``step_ds`` on each batch, for
    ``epochs`` (default 1) passes, between the listeners' onEpochStart
    and onEpochEnd. Each callback runs its batch's optimizer step (or
    truncated-BPTT windows) through ``_timed_step``."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet

    net._require_init()
    if labels is not None:
        step_arrays(data, labels)
    elif isinstance(data, (DataSet, MultiDataSet)):
        step_ds(data)
    elif all(callable(getattr(data, a, None))
             for a in ("reset", "hasNext", "next")):
        for _ in range(epochs or 1):
            data.reset()
            fire(net, "onEpochStart")
            while data.hasNext():
                step_ds(data.next())
            fire(net, "onEpochEnd")
            net._epoch += 1
    else:
        raise TypeError(
            "fit takes (features, labels) arrays or tensors, a DataSet, or "
            f"a DataSetIterator (reset/hasNext/next), got "
            f"{type(data).__name__}")
    return net


def _timed_step(net, step):
    """Run one optimizer step; its loss becomes the score (the step's
    host sync), with the ``train.step`` span and histogram; the
    iteration count moves and the listeners' iterationDone fires."""
    tm = _tm()
    t0 = time.perf_counter()
    net._score = float(step())
    dt = time.perf_counter() - t0
    tm["step_s"].observe(dt)
    tm["steps"].inc()
    tm["reg"].add_span("train.step", "train", t0, dt,
                       iteration=net._iteration)
    net._iteration += 1
    for lst in net._listeners:
        lst.iterationDone(net, net._iteration, net._epoch)


# ----------------------------------------------------------------------
# carrying the reference's weights across
# ----------------------------------------------------------------------

def _tensor(a):
    """A numpy array (or a CPU tensor) as a CPU tensor of its own; bf16
    (numpy's ml_dtypes type) comes across bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
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
    dict (a wrapper's ``{"fwd": {"W": ...}}`` -> ``{"fwd.W": ...}``, the
    VAE's list ``{"enc": [{"W": ...}]}`` -> ``{"enc.0.W": ...}``); empty
    subtrees vanish."""
    flat = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            flat.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def nest_tree(flat):
    """The inverse of ``flatten_tree``: a level whose names are all
    digits is a list again."""
    tree = {}
    for k, v in flat.items():
        *outer, leaf = k.split(".")
        node = tree
        for o in outer:
            node = node.setdefault(o, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


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


def tree_items(tree, path=()):
    """(path, leaf) pairs of a nested dict/list/tuple tree in
    ``jax.tree_util``'s leaf order: dict keys sorted, sequences in order,
    None holds no leaf. The reference's flat ``params()`` and its
    checkpoint digest walk this order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_items(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_items(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree):
    """The leaves of a nested tree in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in tree_items(tree)]


def _params_shaped(d, keys):
    return isinstance(d, dict) and bool(d) and set(flatten_tree(d)) == keys


def upd_to_reference(layer, state, keys):
    """One layer's updater state in the reference's layouts as numpy:
    every sub-dict keyed like the layer's params (`keys`: its flat port
    names), such as Adam's ``m`` and ``v`` or Nesterovs' whole state,
    goes through the layer's layout map leaf by leaf."""
    if _params_shaped(state, keys):
        return uncarry_layer(layer, state)
    if isinstance(state, dict):
        return {k: upd_to_reference(layer, v, keys) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(upd_to_reference(layer, v, keys) for v in state)
    return _array(state) if isinstance(state, torch.Tensor) else state


def upd_from_reference(layer, state, keys):
    """The inverse of ``upd_to_reference``: CPU tensors in the port's
    layouts."""
    if _params_shaped(state, keys):
        return carry_layer(layer, state)
    if isinstance(state, dict):
        return {k: upd_from_reference(layer, v, keys)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(upd_from_reference(layer, v, keys)
                           for v in state)
    return _tensor(state) if hasattr(state, "shape") else state


# ----------------------------------------------------------------------
# fitDataSet: k fresh batches a block, one host sync a block
# ----------------------------------------------------------------------

_SYNC_CHECK = False


class sync_free_blocks:
    """Within this context every fitDataSet block issues its k steps
    under ``torch.cuda.set_sync_debug_mode("error")``: a step that syncs
    the host with the card raises instead of stalling the block."""

    def __enter__(self):
        global _SYNC_CHECK
        self._was, _SYNC_CHECK = _SYNC_CHECK, True
        return self

    def __exit__(self, *exc):
        global _SYNC_CHECK
        _SYNC_CHECK = self._was


def _stack_component(arrs, what):
    """k batches' arrays of one component -> one [k', ...] tensor over
    the k' batches that have one, and each batch's index into it (None
    where a batch has none: that step runs as ``fit`` runs it, with no
    array there, so a block matches ``fit`` bit for bit)."""
    idx = [i for i, a in enumerate(arrs) if a is not None]
    pos = [None] * len(arrs)
    if not idx:
        return None, pos
    shapes = {arrs[i].shape for i in idx}
    if len(shapes) > 1:
        raise ValueError(
            f"fitDataSet stack has ragged {what} shapes {sorted(shapes)}: "
            "device staging needs one fixed shape per component (the "
            "built-in iterators pad their final batch already)")
    for j, i in enumerate(idx):
        pos[i] = j
    if isinstance(arrs[idx[0]], torch.Tensor):   # already on the card
        return torch.stack([arrs[i] for i in idx]), pos
    return torch.from_numpy(np.stack([arrs[i] for i in idx])), pos


def staging_array(a):
    """A batch component as fitDataSet stages it: a tensor already on
    the card (an ``AsyncDataSetIterator``'s) as it is, anything else as
    numpy (``data.dataset._np``)."""
    from deeplearning4j_tpu_torch.data.dataset import _np

    if isinstance(a, torch.Tensor) and a.device.type == "cuda":
        return a
    return _np(a)


class BlockStager:
    """Stages one block of k batches on the device. Each component (the
    network's ``_batch_arrays``) is stacked on the host as ``fit`` reads
    it (same dtype, contiguous, so the steps see the layout ``fit``'s
    see and cuDNN picks the same algorithms); on the card the stack is
    copied from pinned memory with ``non_blocking`` on a side stream,
    behind an event the compute stream waits on, so block n+1's copy
    overlaps block n's steps. A component whose batches are already on
    the card (an ``AsyncDataSetIterator`` handed them there) is stacked
    there, on the compute stream. Returns per-batch tensor lists and the
    event (None on the CPU)."""

    def __init__(self, device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def __call__(self, net, batches):
        per = [net._batch_arrays(ds) for ds in batches]
        names = net._batch_array_names(len(per[0]))
        stacks = [_stack_component([p[c] for p in per], names[c])
                  for c in range(len(per[0]))]
        event = None
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.device)
            host = [st is not None and not st.is_cuda for st, _ in stacks]
            with torch.cuda.stream(self.stream):
                stacks = [(st.pin_memory().to(self.device,
                                              non_blocking=True)
                           if h else st, pos)
                          for (st, pos), h in zip(stacks, host)]
            for (st, _), h in zip(stacks, host):
                if h:
                    st.record_stream(cur)
            event = torch.cuda.Event()
            event.record(self.stream)
        else:
            stacks = [(None if st is None else st.to(self.device), pos)
                      for st, pos in stacks]
        staged = [[None if pos[b] is None else st[pos[b]]
                   for st, pos in stacks] for b in range(len(batches))]
        return staged, event


def run_staged_blocks(iterator, k, dispatch, consume):
    """The double-buffered block driver every fitDataSet shares
    (reference: ``run_staged_blocks``): for each full stack of k fresh
    batches ``dispatch(batches)`` stages and launches the block and
    returns its pending losses; ``consume`` blocks on them one block
    behind the launch, so stack n+1's copy and steps are queued while
    the host waits on stack n. Returns the ragged final stack (< k
    batches, possibly empty) for the caller's per-batch fit."""
    from deeplearning4j_tpu_torch.data.iterators import iter_stacks

    tm = _tm()
    pending = None
    tail = []
    stacks = iter_stacks(iterator, k)
    _end = object()
    try:
        while True:
            t0 = time.perf_counter()
            batches = next(stacks, _end)
            dt = time.perf_counter() - t0
            tm["data_wait_s"].observe(dt)
            tm["reg"].add_span("fit_dataset.data_wait", "train", t0, dt, k=k)
            if batches is _end:
                break
            if len(batches) < k:
                tail = batches
                break
            out = dispatch(batches)
            if pending is not None:
                consume(pending)
            pending = out
    finally:
        # an error mid-epoch lands after a block was launched: consuming
        # it keeps the iteration count in step with the params
        if pending is not None:
            consume(pending)
    return tail


def launch_block(net, staged, ready, it0, step):
    """Issue one block: the compute stream waits for the staged copy,
    then k steps run back to back (``step(args, iteration)`` returns the
    step's loss tensor, unread) and their losses are stacked and copied
    to pinned host memory behind an event. Nothing here waits on the
    card. Returns (host losses, event or None on the CPU)."""
    cuda = net.device.type == "cuda"
    if ready is not None:
        torch.cuda.current_stream(net.device).wait_event(ready)
    if cuda and _SYNC_CHECK:
        torch.cuda.set_sync_debug_mode("error")
    try:
        losses = torch.stack([step(args, it0 + i)
                              for i, args in enumerate(staged)])
        if not cuda:
            return losses, None
        host = torch.empty(losses.shape, dtype=losses.dtype,
                           pin_memory=True)
        host.copy_(losses, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event
    finally:
        if cuda and _SYNC_CHECK:
            torch.cuda.set_sync_debug_mode("default")


def wait_block(event):
    """The block's one host sync."""
    if event is not None:
        event.synchronize()


def run_fit_dataset_epoch(net, iterator, k, step, fit_one, stager):
    """One epoch of k-step blocks (reference: ``run_fit_dataset_epoch``).

    The dispatch side keeps its own iteration cursor, so step i of a
    block sees the updater schedule's iteration ``it0 + i`` while
    ``net._iteration`` moves only when the block is consumed. Consuming
    is the block's one host sync: the k losses are replayed through the
    listeners' iterationDone one by one, then onSyncBoundary fires once.
    The ragged final stack runs through ``fit_one``, one sync a batch.
    Returns the syncs: one a block plus one a tail batch."""
    syncs = 0
    it_next = net._iteration
    tm = _tm()

    def consume(pending):
        nonlocal syncs
        host, event, _ = pending
        syncs += 1
        t0 = time.perf_counter()
        wait_block(event)
        vals = host.numpy()
        dt = time.perf_counter() - t0
        tm["sync_wait_s"].observe(dt)
        tm["syncs"].inc()
        tm["steps"].inc(len(vals))
        tm["reg"].add_span("fit_dataset.sync_wait", "train", t0, dt, k=k,
                           iteration=net._iteration)
        for v in vals:
            net._score = float(v)
            net._iteration += 1
            for lst in net._listeners:
                lst.iterationDone(net, net._iteration, net._epoch)
        fire(net, "onSyncBoundary", net._iteration, vals)

    def dispatch(batches):
        nonlocal it_next
        t0 = time.perf_counter()
        staged, ready = stager(net, batches)
        dt = time.perf_counter() - t0
        tm["staging_s"].observe(dt)
        tm["reg"].add_span("fit_dataset.staging", "train", t0, dt, k=k,
                           iteration=it_next)
        t1 = time.perf_counter()
        host, event = launch_block(net, staged, ready, it_next, step)
        tm["reg"].add_span("fit_dataset.dispatch", "train", t1,
                           time.perf_counter() - t1, k=k, iteration=it_next)
        it_next += k
        return host, event, staged

    tail = run_staged_blocks(iterator, k, dispatch, consume)
    for ds in tail:
        fit_one(ds)
        syncs += 1
    return syncs


TBPTT_REFUSAL = (
    "fitDataSet does not support truncated BPTT: the k-batch stack would "
    "need a second on-device window sweep per step; use fit() (per-batch "
    "windows) or fitSteps()")


def check_steps_per_sync(stepsPerSync):
    k = int(stepsPerSync)
    if k < 1:
        raise ValueError(f"stepsPerSync must be >= 1, got {k}")
    return k


# ----------------------------------------------------------------------
# what both networks share: files, flat params, listeners, evaluation
# ----------------------------------------------------------------------

class NetworkRuntime:
    """The training runtime both networks share. A network supplies
    ``_unit_keys()`` (its layers' keys: indices, or names in topological
    order), ``_unit_layer(key)``, ``_pack(values)`` (a list, or a dict by
    name), ``_batch_arrays(ds)`` / ``_batch_array_names(n)`` /
    ``_batch_args(tensors)`` (a DataSet as the arrays fitDataSet stages,
    and those arrays as ``_train_step``'s arguments), ``_is_tbptt()``,
    ``_fit_ds(ds)`` and ``_eval_output(features)``."""

    # ----- the reference's layouts ------------------------------------
    def reference_state(self, saveUpdater=True):
        """{"params", "states"[, "upd_states", "bias_upd_states"]} in the
        reference's layouts and containers, as numpy: what its files
        hold. A layer with a biasUpdater writes its main updater's state
        (the reference's structure) under "upd_states" and its biases'
        under "bias_upd_states" (None for the other layers), which the
        reference does not read."""
        keys = self._unit_keys()
        lay = self._unit_layer
        states = strip_carries(self._states)
        out = {"params": self._pack([uncarry_layer(lay(k), self._params[k])
                                     for k in keys]),
               "states": self._pack([uncarry_layer(lay(k), states[k])
                                     for k in keys])}
        if saveUpdater and self._solver is None:
            # a solver's memory is batch-local and not written (reference:
            # ``_net_payload``): a restored net starts it fresh
            main, bias = [], []
            for k in keys:
                us, names = self._upd_states[k], set(self._params[k])
                split = bool(names) and isinstance(self._updaters[k],
                                                   _upd.BiasSplit)
                main.append(upd_to_reference(
                    lay(k), us["main"] if split else us, names))
                bias.append(upd_to_reference(
                    lay(k), us["bias"], {n for n in names
                                         if _upd.is_bias(n)})
                    if split else None)
            out["upd_states"] = self._pack(main)
            if any(b is not None for b in bias):
                out["bias_upd_states"] = self._pack(bias)
        return out

    def from_reference_state(self, params, states, upd_states=None,
                             bias_upd_states=None):
        """The inverse of ``reference_state``: CPU tensors in the port's
        layouts, as ``initFrom`` takes them. A layer with a biasUpdater
        whose biases' state the file lacks (a reference file) starts it
        fresh."""
        keys = self._unit_keys()
        lay = self._unit_layer
        ps = [carry_layer(lay(k), params[k]) for k in keys]
        ss = [carry_layer(lay(k), states[k]) for k in keys]
        if upd_states is None:
            return self._pack(ps), self._pack(ss), None
        us = []
        for k, p in zip(keys, ps):
            u = upd_from_reference(lay(k), upd_states[k], set(p))
            upd = layer_updater(lay(k))
            if p and isinstance(upd, _upd.BiasSplit):
                biases = {n: t for n, t in p.items() if _upd.is_bias(n)}
                b = None if bias_upd_states is None else bias_upd_states[k]
                u = {"main": u, "bias": upd.bias.init(biases) if b is None
                     else upd_from_reference(lay(k), b, set(biases))}
            us.append(u)
        return self._pack(ps), self._pack(ss), self._pack(us)

    def _keep_states(self, new_states, window, state_transform, loss):
        """The step's new layer states replace the old (carries stripped
        outside truncated BPTT); returns the loss."""
        new_states = map_tree(torch.Tensor.detach, new_states)
        if window is None:
            new_states = strip_carries(new_states)
        if state_transform is not None:
            new_states = state_transform(new_states)
        self._states = new_states
        return loss

    def _init_solver(self):
        """The conf's whole-parameter solver, or None under SGD
        (reference: the solver set-up of the networks' ``__init__``)."""
        algo = getattr(self.conf, "optimizationAlgo",
                       "STOCHASTIC_GRADIENT_DESCENT")
        self._solver = self._solver_state = None
        if algo == "STOCHASTIC_GRADIENT_DESCENT":
            return
        self._solver = build_solver(
            algo, getattr(self.conf, "maxNumLineSearchIterations", 20))
        if self.conf.gradientNormalization is not None:
            import warnings

            warnings.warn(
                f"gradientNormalization={self.conf.gradientNormalization} "
                f"is IGNORED under optimizationAlgo={algo}: the line search "
                "needs the true gradient of the loss for its Wolfe/Armijo "
                "conditions, so clipping/renorm is not applied. Use "
                "SGD-family updaters for gradient clipping.", stacklevel=3)

    def load_reference_solver_state(self, state):
        """Carry the reference network's solver state (its
        ``_upd_states`` under a line-search ``optimizationAlgo``, as
        numpy: an optax chain state) into this network's solver, each
        params-shaped tree through the layers' layout maps. Load the
        params first (``load_reference_params`` starts the solver
        fresh)."""
        keys = self._unit_keys()

        def flat(tree):
            out = []
            for k in keys:
                lay = carry_layer(self._unit_layer(k), tree[k])
                out += [lay[n].to(self.device, self._param_dtype)
                        for n in self._params[k]]
            return out

        self._solver_state = self._solver.from_reference(state, flat)
        return self

    def _reset_solver(self):
        """Fresh solver memory over the current parameters."""
        if self._solver is not None:
            self._solver_state = self._solver.init(
                [t.detach() for k in self._unit_keys()
                 for t in self._params[k].values()])

    def initFrom(self, params, states, upd_states=None):
        """Parameters, layer states and (when given) updater state from
        existing tensors in the port's layouts, copied to the network's
        device, without a random init (reference: ``initFrom``, the
        restore path). The iteration count restarts."""
        self._set_params(params, states)
        if upd_states is not None and self._solver is None:
            with torch.no_grad():
                self._upd_states = self._pack([
                    map_tree(lambda t: t.to(self.device, copy=True),
                             upd_states[k]) for k in self._unit_keys()])
        self._iteration = 0
        return self

    def clone(self):
        """An independent copy: the same configuration, copies of the
        parameters, layer states and updater state, and the training
        position (reference: ``clone``)."""
        def copy(t):
            return t.detach().clone()

        net = type(self)(self.conf, device=self.device).initFrom(
            map_tree(copy, self._params),
            map_tree(copy, strip_carries(self._states)),
            map_tree(copy, self._upd_states))
        net._iteration = self._iteration
        net._epoch = self._epoch
        return net

    # ----- parameters in the reference's order and layouts ------------
    def _reference_params(self):
        """The params as the reference nests them, in its layouts, on
        the network's device (tensors)."""
        keys = self._unit_keys()
        return self._pack([
            nest_tree({n: self._unit_layer(k).param_to_reference(n, t)
                       for n, t in self._params[k].items()}) for k in keys])

    def params(self) -> INDArray:
        """Every parameter flattened into one f32 vector in the
        reference's leaf order and layouts, so a vector carries across
        the packages through ``setParams``."""
        leaves = tree_leaves(self._reference_params())
        if not leaves:
            return INDArray(torch.zeros(0, device=self.device))
        return INDArray(torch.cat([t.detach().reshape(-1).float()
                                   for t in leaves]))

    def setParams(self, flat):
        """The inverse of ``params()`` (reference: ``Model.setParams``)."""
        items = tree_items(self._reference_params())
        vec = _unwrap(flat, self.device).reshape(-1)
        total = sum(t.numel() for _, t in items)
        if vec.numel() != total:
            raise ValueError(f"setParams: got {vec.numel()} values for "
                             f"{total} parameters")
        with torch.no_grad():
            for (path, t), v in zip(items, vec.split(
                    [t.numel() for _, t in items])):
                key, name = path[0], ".".join(map(str, path[1:]))
                dst = self._params[key][name]
                dst.copy_(self._unit_layer(key).param_from_reference(
                    name, v.reshape(t.shape)).to(dst.dtype))
        return self

    def paramTable(self) -> dict:
        """``"<layer>_<param>"`` -> ``INDArray`` in the reference's layout
        (reference: ``paramTable``)."""
        return {f"{k}_{n}": INDArray(
                    self._unit_layer(k).param_to_reference(n, t.detach()))
                for k in self._unit_keys()
                for n, t in self._params[k].items()}

    def getParam(self, key: str):
        """One parameter by ``"<layer>_<param>"`` key, in the reference's
        layout (reference: ``Model.getParam``)."""
        k, name = self._split_key(key)
        return INDArray(self._unit_layer(k).param_to_reference(
            name, self._params[k][name].detach()))

    def setParamTable(self, table: dict):
        """Assign parameters by ``"<layer>_<param>"`` keys from arrays in
        the reference's layout (reference: ``Model.setParamTable``)."""
        with torch.no_grad():
            for key, v in table.items():
                k, name = self._split_key(key)
                cur = self._params[k][name]
                t = self._unit_layer(k).param_from_reference(
                    name, _unwrap(v, self.device))
                if tuple(t.shape) != tuple(cur.shape):
                    raise ValueError(
                        f"setParamTable: {key} has shape {tuple(t.shape)}, "
                        f"expected {tuple(cur.shape)}")
                cur.copy_(t.to(cur.dtype))
        return self

    # ----- listeners ----------------------------------------------------
    def setListeners(self, *listeners):
        self._listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)
        return self

    # ----- files --------------------------------------------------------
    def save(self, path, saveUpdater: bool = True):
        """Reference: ``save(File, saveUpdater)`` (``ModelSerializer``)."""
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        ModelSerializer.writeModel(self, path, saveUpdater)
        return self

    # ----- fitSteps / fitDataSet ---------------------------------------
    def fitSteps(self, data, labels=None, numSteps=1):
        """``numSteps`` optimizer steps on ONE batch with one host sync
        at the end (reference: ``fitSteps``): the steps, iteration counts
        and updater schedule of ``numSteps`` consecutive ``fit`` calls on
        that batch; a truncated-BPTT net sweeps its windows each step.
        Listeners fire once, at the end, with the last loss."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        self._require_init()
        ds = DataSet(data, labels) if labels is not None else data
        args = self._batch_args([_unwrap(a, self.device)
                                 for a in self._batch_arrays(ds)])
        windows = self._tbptt_windows(args)
        it = self._iteration
        loss = None
        for _ in range(int(numSteps)):
            for c, window_args in enumerate(windows):
                loss = self._train_step(*window_args, window=c if
                                        len(windows) > 1 else None,
                                        iteration=it)
                it += 1
            self._states = strip_carries(self._states)
        self._score = float(loss)
        self._iteration = it
        for lst in self._listeners:
            lst.iterationDone(self, self._iteration, self._epoch)
        return self

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=None):
        """Epoch training with ONE host sync a block of ``stepsPerSync``
        fresh batches (reference: ``fitDataSet``): the trajectory,
        iteration counts and listener calls of ``fit(iterator)``, with
        the block driver of ``run_fit_dataset_epoch``. stepsPerSync=1 is
        ``fit(iterator)``. The call's host-sync count is left in
        ``_fit_dataset_syncs``."""
        self._require_init()
        k = check_steps_per_sync(stepsPerSync)
        if k == 1:
            it0 = self._iteration
            self.fit(iterator, epochs=epochs)
            self._fit_dataset_syncs = self._iteration - it0
            return self
        if self._is_tbptt():
            raise ValueError(TBPTT_REFUSAL)
        stager = BlockStager(self.device)

        def step(tensors, it):
            return self._train_step(*self._batch_args(tensors),
                                    iteration=it)

        self._fit_dataset_syncs = 0
        for _ in range(epochs or 1):
            iterator.reset()
            fire(self, "onEpochStart")
            self._fit_dataset_syncs += run_fit_dataset_epoch(
                self, iterator, k, step, self._fit_ds, stager)
            fire(self, "onEpochEnd")
            self._epoch += 1
        return self

    # ----- evaluation ---------------------------------------------------
    def doEvaluation(self, iterator, *evaluations):
        """Stream the iterator through the network's output into any
        number of IEvaluation instances (reference: ``doEvaluation``). A
        4-d (CnnLossLayer) map is evaluated per pixel with its class axis
        last, whatever the API's layout."""
        if not evaluations:
            raise ValueError("doEvaluation needs at least one IEvaluation")
        self._check_evaluable()
        iterator.reset()
        while iterator.hasNext():
            ds = iterator.next()
            out = self._eval_output(ds.getFeatures())
            lab, mask = self._eval_labels(ds)
            if out.tensor().dim() == 4 and not self._api_nhwc:
                out = _nhwc(out.tensor())
                lab = _nhwc(_unwrap(lab))
            for e in evaluations:
                e.eval(lab, out, mask=mask)
        return evaluations if len(evaluations) > 1 else evaluations[0]

    def _check_evaluable(self):
        pass

    def _eval_labels(self, ds):
        return ds.getLabels(), ds.getLabelsMaskArray()

    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation

        return self.doEvaluation(iterator, Evaluation())

    def evaluateRegression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation.regression import \
            RegressionEvaluation

        return self.doEvaluation(iterator, RegressionEvaluation())

    def evaluateROC(self, iterator, thresholdSteps=0):
        from deeplearning4j_tpu_torch.evaluation.roc import ROC

        return self.doEvaluation(iterator, ROC(thresholdSteps))

    def evaluateROCMultiClass(self, iterator, thresholdSteps=0):
        from deeplearning4j_tpu_torch.evaluation.roc import ROCMultiClass

        return self.doEvaluation(iterator, ROCMultiClass(thresholdSteps))


# ----------------------------------------------------------------------
# MultiLayerNetwork
# ----------------------------------------------------------------------

class MultiLayerNetwork(NetworkRuntime):
    """A sequential network over ``MultiLayerConfiguration.layers``
    (reference: MultiLayerNetwork)."""

    def __init__(self, conf, device=None):
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
        self._listeners = []
        self._rnn_state = None    # rnnTimeStep's carried states
        self._compute_dtype = conf.dataType.torch_dtype
        self._param_dtype = (torch.float64
                             if self._compute_dtype == torch.float64
                             else torch.float32)
        self._init_solver()

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
        self._updaters = [layer_updater(l) for l in self.layers]
        with torch.no_grad():
            self._upd_states = [u.init(p) if p else ()
                                for u, p in zip(self._updaters,
                                                self._params)]
        self._reset_solver()

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

    def _run_layers(self, params, states, x, train, fmask, key=None):
        """-> (the output layer's pre-activation, or the last layer's
        output when the last layer is not an output layer; new states).
        `key` is the training step's ``StepKey``: layer i draws its
        dropout from ``key.fold(i)``. Training under the remat policy
        runs the layers in ``remat_segment``s cut after each product."""
        h = self._entry(x)
        B = h.shape[0]
        last = len(self.layers) - 1

        def run(lo, hi, h):
            out = []
            for i in range(lo, hi):
                layer = self.layers[i]
                pp = self.conf.preprocessors.get(i)
                if pp is not None:
                    if hasattr(pp, "batch"):
                        pp.batch = B
                    h = pp.preProcess(h, fmask)
                l_train = layer_trains(layer, train)
                lk = None if key is None or not l_train else key.fold(i)
                p = forward_params(layer, params[i], lk, self._compute_dtype,
                                   self._param_dtype)
                if i == last and isinstance(layer, (L.BaseOutputLayer,
                                                    L.LossLayer)):
                    # dropout applies to the output layer's input too
                    h = layer._dropout_input(h, l_train, lk)
                    out.append(states[i])
                    return layer.preoutput(p, h), out
                h, s = layer.forward(p, states[i], h, l_train, lk, fmask)
                out.append(s)
            return h, out

        if not (train and self.conf.checkpointPolicy):
            return run(0, len(self.layers), h)
        new_states = []
        for lo, hi in product_segments([is_product(l) for l in self.layers]):
            h, s = remat_segment(run, lo, hi, h)
            new_states.extend(s)
        return h, new_states

    def _loss_from_preact(self, preact, y, lmask, params):
        last = self.layers[-1]
        if not isinstance(last, (L.BaseOutputLayer, L.LossLayer)):
            raise ValueError("The last layer must be an OutputLayer or a "
                             "LossLayer to compute a loss")
        return loss_for_head(last, preact, y, lmask, self._api_nhwc,
                             params[-1])

    def _regularization(self, params):
        return regularization(self.layers, params)

    def _loss_fn(self, params, states, x, y, fmask, lmask, train=True,
                 use_carries=False, key=None):
        params = [train_params(l, p) for l, p in zip(self.layers, params)]
        run_states = states if use_carries else strip_carries(states)
        preact, new_states = self._run_layers(params, run_states, x, train,
                                              fmask, key)
        loss = self._loss_from_preact(preact, _unwrap(y, self.device),
                                      lmask, params) \
            + self._regularization(params)
        return loss, new_states

    def _train_step(self, x, y, fmask, lmask, window=None,
                    grad_transform=None, loss_transform=None,
                    state_transform=None, bn_group=None, iteration=None,
                    rank=None):
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
        batch statistics over ``bn_group`` (``ops.norm.sync_batch_norm``).
        `iteration` is the updater schedule's (default: the net's count;
        a fitDataSet block passes its own cursor). Dropout draws from the
        step's key (``dropout.step_key`` of the seed, that iteration and,
        under data parallelism, the `rank`), so a block, a resumed run and
        ``fit`` draw the same masks. Under the conf's remat policy the
        forward runs in ``remat_segment``s. Nothing here reads a tensor
        back to the host."""
        it = self._iteration if iteration is None else iteration
        key = step_key(self.conf.seed, it, rank)
        if self._solver is not None:     # (distributed trainers refuse it)
            loss, new_states = network_step(
                self, lambda ps: self._loss_fn(ps, self._states, x, y, fmask,
                                               lmask, use_carries=bool(window),
                                               key=key))
            return self._keep_states(new_states, window, state_transform,
                                     loss)
        with _norm.sync_batch_norm(bn_group):
            loss, new_states = self._loss_fn(self._params, self._states, x,
                                             y, fmask, lmask,
                                             use_carries=bool(window),
                                             key=key)
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
                self._upd_states[i] = update_layer(
                    self.layers[i], self._updaters[i], g,
                    self._upd_states[i], it, self._params[i])
        for p in self._params:
            for t in p.values():
                t.grad = None
        return self._keep_states(new_states, window, state_transform, loss)

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
            self._fit_ds)

    def _fit_ds(self, ds):
        self._fit_batch(ds.getFeatures(), ds.getLabels(),
                        _unwrap(ds.getFeaturesMaskArray(), self.device),
                        _unwrap(ds.getLabelsMaskArray(), self.device))

    # the hooks of NetworkRuntime (fitSteps, fitDataSet, files, params)
    def _unit_keys(self):
        return list(range(len(self.layers)))

    def _unit_layer(self, i):
        return self.layers[i]

    @staticmethod
    def _pack(values):
        return list(values)

    @staticmethod
    def _split_key(key):
        i, _, name = key.partition("_")
        return int(i), name

    @staticmethod
    def _batch_arrays(ds):
        return [staging_array(ds.getFeatures()),
                staging_array(ds.getLabels()),
                staging_array(ds.getFeaturesMaskArray()),
                staging_array(ds.getLabelsMaskArray())]

    @staticmethod
    def _batch_array_names(n):
        return ["features", "labels", "features-mask", "labels-mask"]

    @staticmethod
    def _batch_args(tensors):
        return tuple(tensors)

    def _is_tbptt(self):
        return self.conf.backpropType == BackpropType.TruncatedBPTT

    def _tbptt_windows(self, args):
        """One step's truncated-BPTT windows of (x, y, fmask, lmask), or
        the whole batch as one."""
        x, y, fmask, lmask = args
        if not (self._is_tbptt() and x.dim() == 3):
            return [args]
        T, L = x.shape[2], self.conf.tbpttFwdLength
        if T % L != 0:
            raise ValueError(
                f"fitSteps tBPTT needs seq len divisible by tbpttFwdLength "
                f"(got T={T}, L={L}): the on-device window sweep uses "
                "fixed-size dynamic slices. Use fit() for ragged tails.")
        return [(time_slice(x, sl), time_slice(y, sl), mask_slice(fmask, sl),
                 mask_slice(lmask, sl))
                for sl in (slice(c * L, (c + 1) * L) for c in range(T // L))]

    def _eval_output(self, features):
        return self.output(features)

    @staticmethod
    def load(path, loadUpdater: bool = True, device=None):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        return ModelSerializer.restoreMultiLayerNetwork(path, loadUpdater,
                                                        device=device)

    def summary(self) -> str:
        lines = [f"{'idx':<4}{'type':<28}{'out shape':<24}{'params':<12}"]
        total = 0
        for i, layer in enumerate(self.layers):
            n = sum(t.numel() for t in self._params[i].values()) \
                if self._params else 0
            total += n
            ot = layer.getOutputType(self.conf.layerInputTypes[i])
            lines.append(f"{i:<4}{type(layer).__name__:<28}{str(ot):<24}"
                         f"{n:<12}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def getLayers(self):
        return self.layers

    def getnLayers(self) -> int:
        return len(self.layers)

    # ----- layerwise unsupervised pretraining ------------------------
    def _frozen_feed(self, layerIdx, x):
        """The input layer `layerIdx` receives: the inference forward of
        the layers below it, every preprocessor up to and including its
        own applied (reference: ``_frozen_feed``)."""
        h = self._entry(x)
        B = h.shape[0]
        states = strip_carries(self._states)
        for j in range(layerIdx + 1):
            pp = self.conf.preprocessors.get(j)
            if pp is not None:
                if hasattr(pp, "batch"):
                    pp.batch = B
                h = pp.preProcess(h, None)
            if j < layerIdx:
                p = cast_params(self._params[j], self._compute_dtype,
                                self._param_dtype)
                h, _ = self.layers[j].forward(p, states[j], h, False, None,
                                              None)
        return h

    def pretrain(self, iterator, epochs=1):
        """Layerwise pretraining of every pretrainable layer, bottom up
        (reference: ``pretrain(DataSetIterator)``, how a
        VariationalAutoencoder or AutoEncoder trains)."""
        for i, layer in enumerate(self.layers):
            if getattr(layer, "pretrainable", False):
                self.pretrainLayer(i, iterator, epochs)
        return self

    def pretrainLayer(self, layerIdx, data, epochs=1):
        """Unsupervised pretraining of one layer against its own
        ``pretrain_loss`` (``run_pretrain``), fed by the frozen forward of
        the layers below; `data` is a DataSet, a DataSetIterator or a
        features array (reference: ``pretrainLayer``); refused under a
        line-search solver, as in the reference."""
        self._require_init()
        layer = self.layers[layerIdx]
        if not getattr(layer, "pretrainable", False):
            raise ValueError(f"Layer {layerIdx} "
                             f"({type(layer).__name__}) is not pretrainable")
        return run_pretrain(
            self, layer, layerIdx,
            lambda x: self._frozen_feed(layerIdx, x),
            pretrain_feeds(data, epochs))

    def reconstructionLogProbability(self, data, numSamples=5, layerIdx=0):
        """Each example's log p(x) estimate from a VariationalAutoencoder
        layer, fed by the frozen forward below it (reference:
        ``reconstructionLogProbability``, its key 0). Higher is more
        in-distribution."""
        self._require_init()
        layer = self.layers[layerIdx]
        if not hasattr(layer, "reconstructionLogProbability"):
            raise ValueError(
                f"Layer {layerIdx} ({type(layer).__name__}) is not a "
                "VariationalAutoencoder")
        with torch.no_grad():
            p = cast_params(self._params[layerIdx], self._compute_dtype,
                            self._param_dtype)
            return INDArray(layer.reconstructionLogProbability(
                p, self._frozen_feed(layerIdx, data), int(numSamples),
                StepKey(0)))

    def output(self, x, train=False):
        """The output layer's activations as an ``INDArray`` (inference
        mode: BN uses its running statistics)."""
        self._require_init()
        return INDArray(self._forward_infer(self._params, x))

    def _forward_infer(self, params, x):
        """The inference forward over `params` (per-layer dicts as
        ``_params``): the output as a tensor."""
        with torch.no_grad():
            h, _ = self._run_layers(params, strip_carries(self._states), x,
                                    False, None)
        last = self.layers[-1]
        if isinstance(last, (L.BaseOutputLayer, L.LossLayer)):
            return out_activation(last, h, self._api_nhwc)
        return h

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
        if isinstance(last, (L.BaseOutputLayer, L.LossLayer)):
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
