"""ComputationGraph — the DAG network executor.

The counterpart of ``deeplearning4j_tpu/nn/graph.py``. Where the
reference jits one donated-buffer train step, the port runs it eagerly: the forward over the DAG (every vertex, the
loss on every output layer, the regularization), ``loss.backward()``,
gradient normalization, then each layer's updater applied to its
parameters in place under ``torch.no_grad()``; the layers' new states
(BN's running statistics) replace the old. Attention layers reach the
hand-written flash kernels through ``ops.flash_attention``.

CNN inputs are NCHW, or NHWC where the input type says
``format="NHWC"``; inside, activations are NCHW-logical in
``channels_last`` memory (an NHWC feed is a permute of it, no copy), and
``feedForward`` returns 4-d activations in the API's layout.

Parameters are fp32 master tensors (fp64 under ``DataType.DOUBLE``) in a
``{layer_name: {param_name: tensor}}`` dict with the reference's names
and layouts; a bf16/fp16 ``dataType`` casts them for the forward and
autograd carries the gradient back to the fp32 master. ``output`` and
``feedForward`` return ``INDArray``s, as the reference does
(``nn/graph.py:877-888`` there); ``fit``, ``score`` and ``output`` take
INDArrays, tensors or numpy arrays. Truncated BPTT slices the [B, C, T]
inputs, labels and masks into windows through the window loop
``MultiLayerNetwork`` uses (``multilayer.run_tbptt``); feed-forward
inputs of a mixed graph pass whole. ``fitSteps``, ``fitDataSet``
(k-step blocks, one host sync a block), evaluation, listeners and the
files come from ``multilayer.NetworkRuntime``; a ``MultiDataSet`` feeds a
multi-input graph. Dropout draws from the step's key, folded with each
layer's index in ``_layer_names``; training under the conf's remat policy
runs the forward in ``multilayer.remat_segment``s; a ``LossLayer``
or ``CnnLossLayer`` is an output as an ``OutputLayer`` is. Under a
line-search ``optimizationAlgo`` a step is one whole-parameter solver
step (``nn/solvers.py``); the AOT cache waits for its slice and raises
``NotImplementedError`` naming it. A layer's weight noise perturbs its
weights in the training forward; frozen layers take no gradient,
regularization or update; each update is followed by the layer's
constraints, with its biases stepped by its biasUpdater when it has one
(``multilayer.update_layer``).
``pretrain``/``pretrainLayer`` train pretrainable layers (the
variational autoencoder, the AutoEncoder) on their own losses.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.dropout import step_key
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import (
    NetworkRuntime, _grad_normalize, _later, _timed_step, _unwrap,
    carry_layer, check_carried, cnn_entry, fit_batches, forward_params,
    is_product, layer_seed, layer_trains, layer_updater, loss_for_head,
    map_tree, mask_slice, out_activation, pretrain_feeds, product_segments,
    regularization, remat_segment, run_pretrain, run_tbptt, staging_array,
    strip_carries, time_slice, to_api_layout, train_params, uncarry_layer,
    update_layer,
)
from deeplearning4j_tpu_torch.nn.solvers import network_step
from deeplearning4j_tpu_torch.ops import norm as _norm

__all__ = ["ComputationGraph", "params_from_reference",
           "params_to_reference"]


def params_from_reference(conf, params, states=None):
    """The reference ComputationGraph's ``_params`` (and ``_states``),
    ``{layer_name: {name: array}}`` after ``jax.tree.map(np.asarray,
    ...)``, as the port's CPU tensors in its layouts (each layer's
    ``param_from_reference``; bf16 bit for bit). Returns (params, states
    or None)."""
    def layer(n):
        return conf.nodes[n].payload

    ps = {n: carry_layer(layer(n), p) for n, p in params.items()}
    ss = None if states is None else {
        n: carry_layer(layer(n), s) for n, s in states.items()}
    return ps, ss


def params_to_reference(conf, params):
    """The inverse of ``params_from_reference`` for params or gradients:
    ``{layer_name: {name: numpy array}}`` in the reference's layouts."""
    return {n: uncarry_layer(conf.nodes[n].payload, p)
            for n, p in params.items()}


class ComputationGraph(NetworkRuntime):
    def __init__(self, conf, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._layer_names = [n for n in conf.topoOrder
                             if conf.nodes[n].kind == "layer"]
        # each layer's dropout stream: its index among the layers
        self._layer_idx = {n: i for i, n in enumerate(self._layer_names)}
        self._params = None      # {layer_name: {param_name: tensor}}
        self._states = None
        self._upd_states = None
        self._updaters = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._listeners = []
        self._compute_dtype = conf.dataType.torch_dtype
        self._param_dtype = (torch.float64
                             if self._compute_dtype == torch.float64
                             else torch.float32)
        self._init_solver()

    # ------------------------------------------------------------------
    def init(self):
        """Initialize parameters, layer state and updater state."""
        params, states = {}, {}
        for i, name in enumerate(self._layer_names):
            node = self.conf.nodes[name]
            gen = torch.Generator().manual_seed(layer_seed(self.conf.seed, i))
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
            self._states = map_tree(lambda t: t.to(self.device), states)
        self._updaters, self._upd_states = {}, {}
        for name in self._layer_names:
            u = layer_updater(self.conf.nodes[name].payload)
            self._updaters[name] = u
            with torch.no_grad():
                self._upd_states[name] = (u.init(self._params[name])
                                          if self._params[name] else ())
        self._reset_solver()

    def load_reference_params(self, params, states=None):
        """Set the parameters (and, when given, the layer states: BN's
        running mean and var) from the reference network's ``_params``
        and ``_states`` (``params_from_reference``), and reset the
        updater state."""
        self._require_init()
        ps, ss = params_from_reference(self.conf, params, states)
        if set(ps) != set(self._params):
            raise ValueError("reference params do not match this graph's "
                             "layers")
        for n, p in ps.items():
            check_carried(p, self._params[n], n)
        if ss is not None:
            if set(ss) != set(self._states):
                raise ValueError("reference states do not match this "
                                 "graph's layers")
            for n, st in ss.items():
                check_carried(st, self._states[n], f"{n} state")
        self._set_params(ps, ss)
        return self

    def _require_init(self):
        if self._params is None:
            raise RuntimeError("Call net.init() before fit/output/score")

    # ------------------------------------------------------------------
    @property
    def _api_nhwc(self):
        """True when every declared CNN input is NHWC-format: then 4-d
        arrays at the API boundary are NHWC (reference: ``_api_nhwc``)."""
        its = [it for it in self.conf.inputTypes.values()
               if it is not None and it.kind == InputType.CNN]
        return bool(its) and all(
            getattr(it, "format", "NCHW") == "NHWC" for it in its)

    def _entry(self, name, x):
        # cast before the relayout, so it moves compute-dtype bytes
        x = _unwrap(x, self.device).to(self._compute_dtype)
        return cnn_entry(x, self.conf.inputTypes.get(name))

    def _run_graph(self, params, states, inputs, train, key, fmasks):
        """inputs: {name: tensor}. Returns (activations, preacts of the
        output layers, new states). Masks flow along the edges: a node's
        mask is its first input's, except that a ``maskAware`` vertex
        (the time-series vertices) sees its inputs' masks and gives its
        own (reference: ComputationGraph.feedForwardMaskArrays). `key`
        is the training step's ``StepKey`` (None: no dropout). Training
        under the remat policy runs the nodes in ``remat_segment``s cut
        after each product layer, and keeps only the activations a later
        segment or the loss reads."""
        acts, masks, new_states, preacts = {}, {}, {}, {}
        B = None
        for name in self.conf.networkInputs:
            x = self._entry(name, inputs[name])
            B = x.shape[0] if B is None else B
            acts[name] = x
            masks[name] = None if fmasks is None else fmasks.get(name)
        order = [n for n in self.conf.topoOrder
                 if self.conf.nodes[n].kind != "input"]

        def run(names, acts, new_states, preacts):
            for name in names:
                self._run_node(name, params, states, train, key, B, acts,
                               masks, new_states, preacts)
            return acts

        if not (train and self.conf.checkpointPolicy):
            return run(order, acts, new_states, preacts), preacts, new_states
        last_use = {}
        for idx, name in enumerate(order):
            for i in self.conf.nodes[name].inputs:
                last_use[i] = idx
        outputs = set(self.conf.networkOutputs)
        flags = [self.conf.nodes[n].kind == "layer"
                 and is_product(self.conf.nodes[n].payload) for n in order]
        for lo, hi in product_segments(flags):
            seg = order[lo:hi]
            ext = sorted({i for n in seg for i in self.conf.nodes[n].inputs
                          if i not in seg})
            keep = [n for n in seg if n in outputs or last_use.get(n, -1)
                    >= hi]

            def segment(*xs, seg=seg, ext=ext, keep=keep):
                # its own dicts: a recompute's states and preacts are
                # dropped, not written over the first forward's
                st, pre = {}, {}
                local = run(seg, dict(zip(ext, xs)), st, pre)
                return [local[n] for n in keep], st, pre

            outs, st, pre = remat_segment(segment, *[acts[i] for i in ext])
            acts.update(zip(keep, outs))
            new_states.update(st)
            preacts.update(pre)
            for i in ext:       # drop what no later segment reads
                if last_use.get(i, -1) < hi and i not in outputs:
                    acts.pop(i, None)
        return acts, preacts, new_states

    def _run_node(self, name, params, states, train, key, B, acts, masks,
                  new_states, preacts):
        """One node of the forward: its activation into `acts` (and its
        mask, new state and, for an output layer, its preact)."""
        node = self.conf.nodes[name]
        if node.kind == "vertex":
            pp = getattr(node.payload, "pp", None)
            if pp is not None and hasattr(pp, "batch"):
                pp.batch = B  # FeedForwardToRnn needs B to un-flatten
            ins = [acts[i] for i in node.inputs]
            if getattr(node.payload, "maskAware", False):
                acts[name], masks[name] = node.payload.applyMasked(
                    ins, [masks.get(i) for i in node.inputs])
            else:
                acts[name] = node.payload.apply(ins)
                masks[name] = masks.get(node.inputs[0])
            return
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
        l_train = layer_trains(layer, train)
        lk = None if key is None or not l_train else \
            key.fold(self._layer_idx[name])
        p = forward_params(layer, params[name], lk, self._compute_dtype,
                           self._param_dtype)
        if name in self.conf.networkOutputs and isinstance(
                layer, (L.BaseOutputLayer, L.LossLayer)):
            h = layer._dropout_input(h, l_train, lk)
            pre = layer.preoutput(p, h)
            preacts[name] = pre
            acts[name] = out_activation(layer, pre)
            new_states[name] = states[name]
            return
        h, s = layer.forward(p, states[name], h, l_train, lk, fmask)
        acts[name] = h
        masks[name] = out_mask
        new_states[name] = s

    def _loss(self, preacts, labels, lmasks, params):
        total = 0.0
        for i, name in enumerate(self.conf.networkOutputs):
            lmask = None if lmasks is None else lmasks[i]
            total = total + loss_for_head(self.conf.nodes[name].payload,
                                          preacts[name], labels[i], lmask,
                                          self._api_nhwc, params.get(name))
        return total

    def _regularization(self, params):
        return regularization([self._unit_layer(n) for n in
                               self._layer_names],
                              [params[n] for n in self._layer_names])

    def _loss_fn(self, params, states, inputs, labels, fmasks, lmasks,
                 use_carries=False, key=None):
        params = {n: train_params(self._unit_layer(n), p)
                  for n, p in params.items()}
        _, preacts, new_states = self._run_graph(
            params, states if use_carries else strip_carries(states),
            inputs, True, key, fmasks)
        loss = self._loss(preacts, labels, lmasks, params) \
            + self._regularization(params)
        return loss, new_states

    def _train_step(self, inputs, labels, fmasks, lmasks, window=None,
                    grad_transform=None, loss_transform=None,
                    state_transform=None, bn_group=None, iteration=None,
                    rank=None):
        """One eager step: forward, backward, normalize, update in place.
        `window` is a truncated-BPTT window's index, and the hooks,
        `bn_group`, `iteration` and `rank` are as in
        ``MultiLayerNetwork._train_step`` (gradients as a list in
        ``_layer_names`` order). Returns the loss tensor, unread."""
        it = self._iteration if iteration is None else iteration
        key = step_key(self.conf.seed, it, rank)
        for p in self._params.values():
            for t in p.values():
                t.grad = None
        if self._solver is not None:     # (distributed trainers refuse it)
            loss, new_states = network_step(
                self, lambda ps: self._loss_fn(ps, self._states, inputs,
                                               labels, fmasks, lmasks,
                                               use_carries=bool(window),
                                               key=key))
            return self._keep_states(new_states, window, state_transform,
                                     loss)
        with _norm.sync_batch_norm(bn_group):
            loss, new_states = self._loss_fn(self._params, self._states,
                                             inputs, labels, fmasks, lmasks,
                                             use_carries=bool(window),
                                             key=key)
        loss.backward()
        grads = [{k: t.grad if t.grad is not None else torch.zeros_like(t)
                  for k, t in self._params[n].items()}
                 for n in self._layer_names]
        if grad_transform is not None:
            grads = grad_transform(grads)
        loss = loss.detach()
        if loss_transform is not None:
            loss = loss_transform(loss)
        glist = _grad_normalize(grads, self.conf.gradientNormalization,
                                self.conf.gradientNormalizationThreshold)
        with torch.no_grad():
            for name, g in zip(self._layer_names, glist):
                self._upd_states[name] = update_layer(
                    self._unit_layer(name), self._updaters[name], g,
                    self._upd_states[name], it, self._params[name])
        for p in self._params.values():
            for t in p.values():
                t.grad = None
        return self._keep_states(new_states, window, state_transform, loss)

    def _fit_batch(self, inputs, labels, fmasks, lmasks):
        """One batch: a timed optimizer step, or under truncated BPTT
        (any [B, C, T] input) the windows of ``run_tbptt``."""
        inputs = {n: _unwrap(v, self.device) for n, v in inputs.items()}
        seqs = [v for v in inputs.values() if v.dim() == 3]
        if self.conf.backpropType == "tbptt" and seqs:
            def window(sl, c):
                return self._train_step(
                    {n: time_slice(v, sl) for n, v in inputs.items()},
                    [time_slice(y, sl) for y in labels],
                    None if fmasks is None else
                    {n: mask_slice(m, sl) for n, m in fmasks.items()},
                    None if lmasks is None else
                    [mask_slice(m, sl) for m in lmasks], window=c)

            run_tbptt(self, max(v.shape[2] for v in seqs),
                      self.conf.tbpttFwdLength, window)
        else:
            _timed_step(self, lambda: self._train_step(inputs, labels,
                                                       fmasks, lmasks))

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
        """One optimizer step on (features, labels) — arrays or tensors,
        or lists of them for multi-input/-output graphs — or on a
        DataSet; a DataSetIterator runs ``epochs`` (default 1) passes,
        one step a batch."""
        return fit_batches(
            self, data, labels, epochs,
            lambda x, y: self._fit_batch(self._coerce_inputs(x),
                                         self._coerce_labels(y), None,
                                         None),
            self._fit_ds)

    def _fit_ds(self, ds):
        self._fit_batch(*self._extract_ds(ds))

    def _extract_ds(self, ds):
        """(inputs, labels, feature masks, label masks) of a DataSet or a
        MultiDataSet, on the device."""
        return self._batch_args([_unwrap(a, self.device)
                                 for a in self._batch_arrays(ds)])

    # the hooks of NetworkRuntime (fitSteps, fitDataSet, files, params)
    def _unit_keys(self):
        return list(self._layer_names)

    def _unit_layer(self, name):
        return self.conf.nodes[name].payload

    def _pack(self, values):
        return dict(zip(self._layer_names, values))

    @staticmethod
    def _split_key(key):
        # vertex names may hold underscores: split on the last one
        name, _, pname = key.rpartition("_")
        return name, pname

    def _batch_arrays(self, ds):
        """A DataSet or MultiDataSet as the flat list [inputs..., labels...,
        input masks..., label masks...] (numpy or, already on the card, a
        tensor; None where absent)."""
        from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet

        nin = len(self.conf.networkInputs)
        nout = len(self.conf.networkOutputs)
        if isinstance(ds, MultiDataSet):
            fms = ds.getFeaturesMaskArrays() or [None] * nin
            lms = ds.getLabelsMaskArrays() or [None] * nout
            arrs = list(ds.getFeatures()) + list(ds.getLabels()) \
                + list(fms) + list(lms)
        else:
            arrs = [ds.getFeatures(), ds.getLabels(),
                    ds.getFeaturesMaskArray(), ds.getLabelsMaskArray()]
        if len(arrs) != 2 * (nin + nout):
            raise ValueError(
                f"{type(ds).__name__} holds {len(arrs)} arrays; this graph "
                f"takes {nin} input(s) and {nout} output(s)")
        return [staging_array(a) for a in arrs]

    def _batch_array_names(self, n):
        nin = len(self.conf.networkInputs)
        nout = len(self.conf.networkOutputs)
        return ([f"features[{i}]" for i in range(nin)]
                + [f"labels[{i}]" for i in range(nout)]
                + [f"features-mask[{i}]" for i in range(nin)]
                + [f"labels-mask[{i}]" for i in range(nout)])

    def _batch_args(self, t):
        names = self.conf.networkInputs
        nin, nout = len(names), len(self.conf.networkOutputs)
        fms = t[nin + nout:2 * nin + nout]
        lms = t[2 * nin + nout:]
        return (dict(zip(names, t[:nin])), list(t[nin:nin + nout]),
                None if all(m is None for m in fms)
                else dict(zip(names, fms)),
                None if all(m is None for m in lms) else list(lms))

    def _is_tbptt(self):
        return self.conf.backpropType == "tbptt"

    def _tbptt_windows(self, args):
        inputs, labels, fmasks, lmasks = args
        seqs = [v for v in inputs.values() if v.dim() == 3]
        if not (self._is_tbptt() and seqs):
            return [args]
        T, L = max(v.shape[2] for v in seqs), self.conf.tbpttFwdLength
        if T % L != 0:
            raise ValueError(
                f"fitSteps tBPTT needs seq len divisible by tbpttFwdLength "
                f"(got T={T}, L={L}); use fit() for ragged tails")
        return [({n: time_slice(v, sl) for n, v in inputs.items()},
                 [time_slice(y, sl) for y in labels],
                 None if fmasks is None else
                 {n: mask_slice(m, sl) for n, m in fmasks.items()},
                 None if lmasks is None else
                 [mask_slice(m, sl) for m in lmasks])
                for sl in (slice(c * L, (c + 1) * L) for c in range(T // L))]

    def _check_evaluable(self):
        if len(self.conf.networkOutputs) > 1:
            raise ValueError(
                "doEvaluation evaluates a single-output graph; score "
                "multi-output graphs per-output via output() directly "
                "(reference throws here too)")

    def _eval_output(self, features):
        return self.outputSingle(*features) \
            if isinstance(features, (list, tuple)) \
            else self.outputSingle(features)

    def _eval_labels(self, ds):
        from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet

        if isinstance(ds, MultiDataSet):
            lm = ds.getLabelsMaskArrays()
            return ds.getLabels(0), None if lm is None else lm[0]
        return ds.getLabels(), ds.getLabelsMaskArray()

    @staticmethod
    def load(path, loadUpdater: bool = True, device=None):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        return ModelSerializer.restoreComputationGraph(path, loadUpdater,
                                                       device=device)

    def summary(self) -> str:
        lines = [f"{'name':<24}{'type':<26}{'inputs':<30}{'params':<10}"]
        total = 0
        for name in self.conf.topoOrder:
            node = self.conf.nodes[name]
            n = 0
            if node.kind == "layer" and self._params:
                n = sum(t.numel() for t in self._params[name].values())
            total += n
            kind = type(node.payload).__name__ \
                if node.payload is not None else "Input"
            lines.append(f"{name:<24}{kind:<26}{','.join(node.inputs):<30}"
                         f"{n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    # ----- layerwise unsupervised pretraining ------------------------
    def pretrain(self, iterator, epochs=1):
        """Layerwise pretraining of every pretrainable layer in
        topological order (reference: ComputationGraph.pretrain)."""
        for name in self._layer_names:
            if getattr(self._unit_layer(name), "pretrainable", False):
                self.pretrainLayer(name, iterator, epochs)
        return self

    def pretrainLayer(self, layerName, data, epochs=1):
        """Unsupervised pretraining of one named layer against its own
        ``pretrain_loss`` (``multilayer.run_pretrain``), fed by the
        graph's inference forward up to its input and its preprocessor
        (reference: ComputationGraph.pretrainLayer)."""
        self._require_init()
        node = self.conf.nodes[layerName]
        layer = node.payload
        if not getattr(layer, "pretrainable", False):
            raise ValueError(f"Layer '{layerName}' "
                             f"({type(layer).__name__}) is not pretrainable")

        def feed(features):
            inputs = self._coerce_inputs(features)
            acts, _, _ = self._run_graph(
                self._params, strip_carries(self._states), inputs, False,
                None, None)
            h = acts[node.inputs[0]]
            if node.preprocessor is not None:
                if hasattr(node.preprocessor, "batch"):
                    node.preprocessor.batch = acts[
                        self.conf.networkInputs[0]].shape[0]
                h = node.preprocessor.preProcess(h)
            return h

        return run_pretrain(self, layer, layerName, feed,
                            pretrain_feeds(data, epochs))

    def precompile(self, *args, **kwargs):
        raise _later("precompile (the AOT cache)", "runtime slice, item 13")

    def output(self, *features):
        """The output activations, one ``INDArray`` per network output
        (a single INDArray for one output)."""
        self._require_init()
        outs = self._forward_infer(self._params, *features)
        if isinstance(outs, list):
            return [INDArray(o) for o in outs]
        return INDArray(outs)

    def _forward_infer(self, params, *features):
        """The inference forward over `params` (per-layer dicts as
        ``_params``): the output tensor, or a list of them."""
        inputs = self._coerce_inputs(
            features if len(features) > 1 else features[0])
        with torch.no_grad():
            acts, _, _ = self._run_graph(params,
                                         strip_carries(self._states),
                                         inputs, False, None, None)
        # a loss head's 4-d map in the API's layout (reference:
        # ``_run_graph``); other outputs as they are
        outs = [to_api_layout(acts[n], self._api_nhwc)
                if self._is_head(n) else acts[n]
                for n in self.conf.networkOutputs]
        return outs[0] if len(outs) == 1 else outs

    def _is_head(self, name):
        return isinstance(self.conf.nodes[name].payload,
                          (L.BaseOutputLayer, L.LossLayer))

    def outputSingle(self, *features) -> INDArray:
        """The first output's activations as an ``INDArray``."""
        out = self.output(*features)
        return out if isinstance(out, INDArray) else out[0]

    def feedForward(self, *features, train=False):
        """Every vertex/layer activation by name, as ``INDArray``s, 4-d
        ones in the API's layout (reference:
        ComputationGraph.feedForward)."""
        self._require_init()
        inputs = self._coerce_inputs(
            features if len(features) > 1 else features[0])
        with torch.no_grad():
            acts, _, _ = self._run_graph(self._params,
                                         strip_carries(self._states),
                                         inputs, train, None, None)
        return {n: INDArray(to_api_layout(a, self._api_nhwc))
                for n, a in acts.items()}

    def score(self, ds=None) -> float:
        """The loss of the last fit step (reference: Model.score()), or
        of a DataSet in inference mode (BN from its running statistics,
        as the reference's ``_loss_only``)."""
        if ds is None:
            return self._score
        self._require_init()
        if not hasattr(ds, "getFeatures"):
            raise TypeError(f"score takes a DataSet, got {type(ds).__name__}")
        inputs, labels, fmasks, lmasks = self._extract_ds(ds)
        with torch.no_grad():
            _, preacts, _ = self._run_graph(
                self._params, strip_carries(self._states), inputs, False,
                None, fmasks)
            loss = self._loss(preacts, labels, lmasks, self._params) \
                + self._regularization(self._params)
        return float(loss)

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

    def getEpochCount(self):
        return self._epoch
