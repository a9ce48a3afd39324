"""The tensor-parallel layer rule: a network over a "model" axis.

Port-only. The reference annotates parameters with partition specs
(``parallel/sharding.py:90`` there) and lets GSPMD partition the step,
so the annotations do not change the function the network computes.
The port runs one process a rank, so it states the rule itself, kept
out of the layers: ``sharding.shard_params`` keeps this rank's block of
each sharded leaf in the network and installs a ``TensorParallel`` as
``net._tp``; the networks' forwards hand each layer to it.

* Column-parallel: a layer whose weight is sharded on its output
  dimension runs its own forward on this rank's blocks, from the
  replicated input behind ``collectives.copy_to`` (whose backward
  all-reduces the input's partial gradient over the model group), and
  its output block is gathered (``collectives.gather_from``, whose
  backward is this rank's slice) before anything that mixes channels
  reads it. A replicated bias (a leaf under ``min_shard_size``) goes in
  as this rank's block through ``collectives.scatter_to``, whose
  backward gathers the gradient's blocks, so its gradient is whole and
  equal on every rank. The rule covers DenseLayer, OutputLayer,
  ConvolutionLayer (OIHW ``W``, channels gathered on dimension 1 of the
  channels_last activation), EmbeddingLayer and EmbeddingSequenceLayer
  (``[V, E]``) under an activation that acts on each element alone (a
  softmax layer takes the gather path); an output head's preoutput
  (the layer's own, gathered before the softmax and loss); LSTM
  (``W``/``RW [., 4H]``: the gates are gathered every step, since the
  recurrence reads the whole ``h``); and the attention layers' heads
  (``attention._mha_apply``: ``Wq``/``Wk``/``Wv`` and their biases
  sharded on the heads, ``nHeads % m == 0``: ``nHeads/m`` heads a rank,
  gathered before ``Wo``, which is itself column-parallel when sharded).
* Every other layout (a layer not in that list, an unaligned head
  split, an LSTM with a replicated recurrent weight) takes the exact
  gather path: each sharded leaf is all-gathered into the whole leaf
  before the layer's own forward, and the backward keeps the leaf's
  gradient block. Both paths are counted (``calls``, and the
  ``dl4j_tp_layer_calls_total`` counter by path); under per-layer
  activation remat a recompute runs (and counts) its layer's exchanges
  again, in the same order on every rank.

Since every rank of a model group computes the same whole activations
after each gather, replicated leaves get bitwise equal gradients there
with no further collective. With a data axis above 1 each rank's batch
rows are its data shard, batch statistics (BN) are taken over the data
group and the gradients averaged over it only (the reference's implicit
all-reduce in ``jit(net._train_step)``); dropout draws agree across a
model group and differ across the data axis. A penalty (l1/l2) on a
sharded leaf is summed over the model group (``reduce_from``). Norms and
draws over a whole leaf (L2 gradient normalization, weight noise) are
refused by ``shard_params``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel import collectives as _coll

__all__ = ["TensorParallel", "COLUMN", "GATHER"]

COLUMN, GATHER = "column", "gather"
_COUNTER = None


def _counter():
    global _COUNTER
    if _COUNTER is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        _COUNTER = telemetry.get_registry().counter(
            "dl4j_tp_layer_calls_total",
            "tensor-parallel layer forwards, by path", labels=("path",))
    return _COUNTER


def _elementwise(activation):
    """Whether `activation` acts on each element alone, so that it runs
    on an output block as on the whole output (a softmax does not; a
    callable is not known to)."""
    from deeplearning4j_tpu_torch.nn import activations as _act

    return isinstance(activation, str) and activation.lower() in \
        _act.ACTIVATIONS and activation.lower() != "softmax"


def _rows(tree, group, axis):
    """Every tensor of `tree` (nested dict/list/tuple) cut to this rank's
    rows over `group` (``sharding.shard_batch``)."""
    from deeplearning4j_tpu_torch.parallel.sharding import shard_batch

    if isinstance(tree, dict):
        return {k: _rows(v, group, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, group, axis) for v in tree)
    if isinstance(tree, torch.Tensor):
        return shard_batch(tree, group, axis)
    return tree


class TensorParallel:
    """The placement ``shard_params`` installs on a network: `mesh`, the
    model and data groups, and for each layer key the sharded leaves'
    dimension (``sharded[key][name]``)."""

    def __init__(self, mesh, model_axis, batch_axis, sharded):
        from deeplearning4j_tpu_torch.parallel.mesh import axis_group

        self.mesh = mesh
        self.model_axis, self.batch_axis = model_axis, batch_axis
        self.model = axis_group(mesh, model_axis)
        self.data = axis_group(mesh, batch_axis)
        self.sharded = sharded
        self.calls = {COLUMN: 0, GATHER: 0}

    # ----- bookkeeping ------------------------------------------------
    def _note(self, path):
        self.calls[path] += 1
        _counter().labels(path=path).inc()

    def block(self, t, dim):
        """This rank's block of a whole leaf `t` along `dim`."""
        n = t.shape[dim] // self.model.size
        return t.narrow(dim, self.model.rank * n, n)

    def block_of(self, key, name, t):
        """This rank's block of leaf `name`'s whole value `t` (`t` when
        the leaf is replicated)."""
        dim = self._dim(key, name)
        return t if dim is None else self.block(t, dim)

    def whole(self, key, name, t):
        """The whole leaf of block `t` (an all-gather; every rank of the
        model group calls it), or `t` when it is replicated."""
        dim = self._dim(key, name)
        if dim is None:
            return t
        return _coll._gather_dim(t.detach(), self.model, dim)

    def _gather_leaves(self, key, p):
        """The gather path's whole leaves, differentiable (backward: the
        block of the gradient)."""
        dims = self.sharded.get(key, {})
        return {n: _coll.gather_from(t, self.model, dims[n]) if n in dims
                else t for n, t in p.items()}

    def refuse_blocks(self, key, what):
        """Raise when layer `key` holds sharded leaves: `what` reads the
        layer's whole params outside the rule (a stated deviation)."""
        if self.sharded.get(key):
            raise ValueError(
                f"{what} reads layer {key}'s whole params, which "
                f"shard_params placed as blocks over the "
                f"'{self.model_axis}' axis: run it before shard_params or "
                "after replicate_params")

    def _dim(self, key, name):
        return self.sharded.get(key, {}).get(name)

    # ----- the rule ---------------------------------------------------
    def _column_kind(self, key, layer, p):
        """The column rule that applies to `layer`, or None (module
        docstring)."""
        from deeplearning4j_tpu_torch.nn.conf import attention as A
        from deeplearning4j_tpu_torch.nn.conf import layers as L
        from deeplearning4j_tpu_torch.nn.conf import recurrent as R

        d = self.sharded.get(key, {})
        t = type(layer)
        b_ok = "b" not in p or d.get("b", 0) == 0
        if t in (L.DenseLayer, L.OutputLayer, L.EmbeddingLayer,
                 L.EmbeddingSequenceLayer):
            return "linear" if d.get("W") == 1 and b_ok \
                and set(p) <= {"W", "b"} else None
        if t is L.ConvolutionLayer:
            return "conv" if d.get("W") == 0 and b_ok \
                and set(p) <= {"W", "b"} else None
        if t is R.LSTM:
            return "lstm" if d.get("W") == 1 and d.get("RW") == 1 \
                and b_ok else None
        if t in (A.SelfAttentionLayer, A.AttentionVertex) \
                and layer.projectInput:
            m = self.model.size
            heads = all(d.get(w) == 1 for w in ("Wq", "Wk", "Wv")) and all(
                d.get(b) == 0 for b in ("bq", "bk", "bv") if b in p)
            wo = ("Wo" not in d or d["Wo"] == 1) and \
                ("bo" not in d or d["bo"] == 0)
            return "attention" if heads and wo and layer.nHeads % m == 0 \
                else None
        return None

    def _column_params(self, key, p):
        """A column-parallel layer's params `p` with each replicated
        (bias) leaf cut to this rank's block behind ``scatter_to``."""
        d = self.sharded.get(key, {})
        return {n: t if n in d else _coll.scatter_to(t, self.model, 0)
                for n, t in p.items()}

    def forward(self, key, layer, p, state, h, train, lk, fmask):
        """Layer `key`'s forward with this rank's params `p`: (output,
        new state), the output whole on every rank of the model group."""
        from deeplearning4j_tpu_torch.nn.conf import layers as L

        if not self.sharded.get(key):
            return layer.forward(p, state, h, train, lk, fmask)
        kind = self._column_kind(key, layer, p)
        if kind == "attention" and isinstance(h, (list, tuple)) \
                and len(h) > 2:
            kind = None    # a distinct values input: not the heads' form
        if kind in ("linear", "conv") and not _elementwise(layer.activation):
            kind = None
        if kind is None:
            self._note(GATHER)
            return layer.forward(self._gather_leaves(key, p), state, h,
                                 train, lk, fmask)
        self._note(COLUMN)
        if kind == "lstm":
            return self._lstm(key, layer, p, state, h, train, lk, fmask)
        if kind == "attention":
            return self._attention(key, layer, p, state, h, train, lk,
                                   fmask)
        y, state = layer.forward(self._column_params(key, p), state,
                                 _coll.copy_to(h, self.model), train, lk,
                                 fmask)
        dim = 1 if kind == "conv" or isinstance(
            layer, L.EmbeddingSequenceLayer) else -1
        return _coll.gather_from(y, self.model, dim), state

    def preoutput(self, key, layer, p, h):
        """An output head's preoutput (its input's dropout already
        applied), whole on every rank."""
        if not self.sharded.get(key):
            return layer.preoutput(p, h)
        if self._column_kind(key, layer, p) != "linear":
            self._note(GATHER)
            return layer.preoutput(self._gather_leaves(key, p), h)
        self._note(COLUMN)
        return _coll.gather_from(
            layer.preoutput(self._column_params(key, p),
                            _coll.copy_to(h, self.model)), self.model, -1)

    def _lstm(self, key, layer, p, state, h, train, lk, fmask):
        from deeplearning4j_tpu_torch.nn import activations as _act
        from deeplearning4j_tpu_torch.nn.conf.recurrent import _to_ncw
        from deeplearning4j_tpu_torch.ops import rnn as _rnn

        g = self.model
        x = layer._dropout_input(h, train, lk)
        xt = layer._time_major(x)                   # [T, B, F]
        T, B, _ = xt.shape
        H = layer.nOut
        bs = self._dim(key, "b") is not None
        xw = _coll.copy_to(xt, g).reshape(T * B, -1) @ p["W"]
        if bs:
            xw = xw + p["b"]
        xw = xw.reshape(T, B, -1)
        state = state or {}
        hh = _rnn._zeros(xt, H) if state.get("h") is None else state["h"]
        c = _rnn._zeros(xt, H) if state.get("c") is None else state["c"]
        act = _act.get(layer.activation)
        gate = _act.get(layer.gateActivationFn)
        dt = xt.dtype
        ys = []
        for xw_t in xw:
            blk = _rnn._wide(xw_t) + _rnn._wide(_coll.copy_to(hh, g)
                                                @ p["RW"])
            z = _coll.gather_from(blk, g, -1)
            if not bs:
                z = z + _rnn._wide(p["b"])
            i, f, o, gg = z.split(H, dim=-1)
            c_w = gate(f) * _rnn._wide(c) + gate(i) * act(gg)
            hh = (gate(o) * act(c_w)).to(dt)
            c = c_w.to(dt)
            ys.append(hh)
        return _to_ncw(torch.stack(ys), fmask), {**state, "h": hh, "c": c}

    def _attention(self, key, layer, p, state, h, train, lk, fmask):
        from deeplearning4j_tpu_torch.nn import activations as _act
        from deeplearning4j_tpu_torch.nn.conf import attention as A

        if isinstance(layer, A.AttentionVertex):
            xs = h if isinstance(h, (list, tuple)) else [h]
            qt = xs[0].transpose(1, 2)
            kvt = (xs[1] if len(xs) > 1 else xs[0]).transpose(1, 2)
            mask = fmask
        else:
            x = layer._dropout_input(h, train, lk)
            qt = kvt = x.transpose(1, 2)
            mask = fmask

        def out_proj(o):
            if self._dim(key, "Wo") is None:
                return A._project(o, p["Wo"], p.get("bo"))
            q = self._column_params(key, {n: p[n] for n in ("Wo", "bo")
                                          if n in p})
            y = A._project(_coll.copy_to(o, self.model), q["Wo"],
                           q.get("bo"))
            return _coll.gather_from(y, self.model, -1)

        y = A._mha_apply(p, qt, kvt, layer.nHeads, mask=mask,
                         block_size=layer.blockSize, group=self.model,
                         out_proj=out_proj)
        if not isinstance(layer, A.AttentionVertex) and mask is not None:
            y = y * mask[:, :, None]
        y = _act.get(layer.activation)(y)
        return y.transpose(1, 2), state

    # ----- the step ---------------------------------------------------
    def penalty(self, layers, params, keys):
        """The l1/l2 penalty of the layers that train: a sharded leaf's
        share summed over the model group."""
        total = 0.0
        for k, layer in zip(keys, layers):
            p = params[k]
            if not p or getattr(layer, "frozen", False):
                continue
            dims = self.sharded.get(k, {})
            total = total + layer.regularization(
                {n: t for n, t in p.items() if n not in dims})
            if dims:
                part = layer.regularization(
                    {n: t for n, t in p.items() if n in dims})
                if isinstance(part, torch.Tensor):
                    part = _coll.reduce_from(part, self.model)
                total = total + part
        return total

    def train_step(self, net, args, it):
        """One step of `net` on `args` (its ``_train_step`` arguments for
        the global batch): this rank's data rows, the gradients and score
        averaged over the data group, BN over it. Capture is refused and
        counted."""
        from deeplearning4j_tpu_torch.parallel import sharding as _sh

        cap = net._captured
        if cap is not None:
            cap.uncaptured += 1
            cap.cache().note_uncaptured(cap.entry, "refused")
        d = self.data
        if d.size == 1:
            return net._train_step(*args, iteration=it)
        args = _rows(args, self.mesh, self.batch_axis)

        def grads_mean(grads):
            from deeplearning4j_tpu_torch.parallel.trainer import (
                _leaves, _rebuild,
            )

            return _rebuild(grads, iter(_sh.mean_all(_leaves(grads), d)))

        return net._train_step(
            *args, iteration=it, rank=d.rank, grad_transform=grads_mean,
            loss_transform=lambda loss: _sh.mean_all([loss.reshape(1)],
                                                     d)[0][0],
            bn_group=d)

    # ----- whole trees ------------------------------------------------
    def whole_params(self, net):
        """The network's params with every sharded leaf gathered whole
        (in ``_unit_keys`` order, packed as the network packs them)."""
        keys = net._unit_keys()
        return net._pack([{n: self.whole(k, n, t)
                           for n, t in net._params[k].items()}
                          for k in keys])

    def _map_state(self, key, tree, fn, path=()):
        """`fn(t, dim)` over the updater-state leaves of a sharded leaf
        (a tensor under that leaf's name)."""
        dims = self.sharded.get(key, {})
        if isinstance(tree, dict):
            return {n: self._map_state(key, v, fn, path + (n,))
                    for n, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._map_state(key, v, fn, path)
                              for v in tree)
        if isinstance(tree, torch.Tensor) and path and path[-1] in dims:
            return fn(tree, dims[path[-1]])
        return tree

    def whole_upd_states(self, net, upd_states):
        keys = net._unit_keys()
        return net._pack([self._map_state(
            k, upd_states[k],
            lambda t, dim: _coll._gather_dim(t, self.model, dim))
            for k in keys])

    def block_upd_state(self, key, tree):
        """An updater state of whole leaves cut to this rank's blocks."""
        return self._map_state(key, tree,
                               lambda t, dim: self.block(t, dim).clone())
