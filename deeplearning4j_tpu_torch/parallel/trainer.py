"""Data-parallel trainers over ``torch.distributed``.

The counterpart of ``deeplearning4j_tpu/parallel/trainer.py``
(reference: org.deeplearning4j.parallelism.ParallelWrapper and the Spark
gradient-sharing stack). The reference is one process re-jitting the
network's train step over a mesh; the port is one process per rank
(``parallel.multihost``) running the network's own eager step with the
step hooks (``grad_transform``, ``loss_transform``, ``state_transform``,
``bn_group``) that splice the collectives in:

* Every rank builds the wrapper and calls ``fit`` with the SAME global
  batch or iterator; each keeps its contiguous ``B/dp`` rows
  (``sharding.shard_batch``: rank r takes [r·B/dp, (r+1)·B/dp)).
* At the first ``fit`` rank 0 broadcasts params, updater state and
  layer state (the reference's ``_place_replicated``), so ranks that
  built their nets from different seeds agree from the first step.
* ``gradient_compression=None`` (dense) equals single-device training on
  the combined batch, BN included: BN takes its batch statistics over
  the group (``ops.norm.sync_batch_norm``), as GSPMD reduces them over
  the sharded batch in the reference; the gradients are all-reduced as
  one flat buffer per dtype and divided by dp, and the score is the
  mean loss. Under a label mask each rank's gradient and loss are
  weighted by its share of the unmasked count instead, so a padded last
  batch still gives the combined batch's masked mean.
* "int8"/"block_int8" (``sharding.quantized_psum_mean``) and "threshold"
  (``sharding.threshold_psum_mean``) keep the reference's shard_map
  semantics: BN statistics per rank, the mean of the inexact layer
  state after the step (``sync_states``) and the mean loss. Threshold
  mode's per-rank error-feedback residual and live tau are the
  wrapper's (``_residual``), with the reference's residual clipping and
  adaptive tau.
* "hierarchical" (``sharding.hierarchical_grad_exchange``) is the 2-hop
  exchange over node groups of ``compressionGroupSize`` contiguous ranks
  (``sharding.hierarchical_mesh``: a ``torch.distributed`` subgroup a
  node group and one an intra position): a dense or block_int8
  reduce-scatter inside the group, the threshold exchange between the
  ranks holding the same block, an all-gather back; its residual is
  this rank's blocks, with the flat mode's clipping and adaptive tau,
  BN statistics, loss and layer state as in the compressed modes.
* ``weight_update="sharded"`` installs ``sharding.ZeroShardedUpdate`` on
  the net (``_update_impl``): dense, int8 or block_int8, the eligible
  gradients are reduce-scattered instead of all-reduced, the updater
  runs on this rank's 1/dp block of the params and of its state
  (allocated sharded), and the fresh blocks are all-gathered. Files
  and checkpoints hold the updater state canonical (full-shape).
* Collectives a step: dense 1 (the gradients; 1 more per dtype beyond
  the first) + 1 (the loss) + 3 per BN layer at dp > 1 (two in its
  forward, one in its backward); int8 and block_int8 4 (the scales, the
  packed lanes, the loss, the layer state; 3 with no layer state);
  threshold 3 (the codes, the loss, the layer state) + 1 with an
  adaptive tau; hierarchical 5 (dense hop 1) or 6 (block_int8: its
  scales) + 1 with an adaptive tau; sharded dense 2 a dtype (the
  reduce-scatter, the all-gather) + 1 for the replicated leaves.
  ``last_step`` holds the count and bytes of the last step
  (``collectives.totals``).

Each rank's dropout draws from the step's key folded with its rank, as
the reference's replicas decorrelate theirs. The gradients that reach
``grad_transform`` are this rank's, before
gradient normalization (the reference's order); every mode leaves the
params bitwise equal on every rank after every step. ``_trainer_state``
is what a checkpoint holds beyond the net (every rank's residual and the
tau; ``runtime.resilience.ResilientFit`` over a wrapper resumes from
it). ``precompile`` captures the data-parallel step as a CUDA graph
(``runtime.aot``) at world 1, which ``fit`` and ``fitDataSet`` replay;
over more ranks it warms the step eagerly and records its key, and each
step runs eagerly, counted as uncaptured (capturing the NCCL exchange is
item 7's). ``trainStep`` returns the step function.
``fitDataSet(stepsPerSync=k)`` runs k-batch blocks through the networks'
block driver, one host sync a block.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.multilayer import (
    TBPTT_REFUSAL, BlockStager, _timed_step, _unwrap, check_steps_per_sync,
    fire, fit_batches, run_fit_dataset_epoch,
)
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel import sharding as _sh

__all__ = ["FixedThresholdAlgorithm", "AdaptiveThresholdAlgorithm",
           "TargetSparsityThresholdAlgorithm",
           "ResidualClippingPostProcessor", "THRESHOLD_ALGORITHMS",
           "ParallelWrapper", "SharedTrainingMaster",
           "ParameterAveragingTrainingMaster"]


# ----------------------------------------------------------------------
# threshold-algorithm configs (reference: org.nd4j.parameterserver
# ThresholdAlgorithm implementations), mapped by SharedTrainingMaster
# ----------------------------------------------------------------------

class FixedThresholdAlgorithm:
    """A constant Strom threshold tau (reference:
    FixedThresholdAlgorithm)."""

    def __init__(self, threshold):
        self.threshold = float(threshold)


class AdaptiveThresholdAlgorithm:
    """Adapt tau multiplicatively so the mean transmitted fraction
    tracks `sparsityTarget` (reference: AdaptiveThresholdAlgorithm)."""

    def __init__(self, initialThreshold=1e-3, sparsityTarget=1e-2):
        self.threshold = float(initialThreshold)
        self.sparsityTarget = float(sparsityTarget)


class TargetSparsityThresholdAlgorithm(AdaptiveThresholdAlgorithm):
    """Alias of the adaptive algorithm with the target spelled first
    (reference: TargetSparsityThresholdAlgorithm)."""

    def __init__(self, sparsityTarget=1e-2, initialThreshold=1e-3):
        super().__init__(initialThreshold, sparsityTarget)


class ResidualClippingPostProcessor:
    """Clip the error-feedback residual to +-(clipValue * tau) every
    `frequency` iterations (reference: ResidualClippingPostProcessor)."""

    def __init__(self, clipValue=5.0, frequency=1):
        self.clipValue = float(clipValue)
        self.frequency = int(frequency)
        if self.clipValue <= 0:
            raise ValueError(
                f"clipValue must be > 0, got {clipValue}")
        if self.frequency < 1:
            raise ValueError(
                f"frequency must be >= 1, got {frequency}")


#: the named threshold algorithms SharedTrainingMaster accepts (a bare
#: number is shorthand for FixedThresholdAlgorithm)
THRESHOLD_ALGORITHMS = (FixedThresholdAlgorithm,
                        AdaptiveThresholdAlgorithm,
                        TargetSparsityThresholdAlgorithm)


# ----------------------------------------------------------------------
# trees of tensors: per-layer dicts in a list, or {layer: dict}
# ----------------------------------------------------------------------

def _leaves(tree):
    """The tensors of a nested dict/list/tuple, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, it):
    """`tree` with each tensor replaced by the next of iterator `it`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it) if isinstance(tree, torch.Tensor) else tree


def _buckets(tensors):
    """Indices of `tensors` grouped by (dtype, device), in first-seen
    order: one flat buffer (one collective) per group."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return list(groups.values())


def _flat_apply(tensors, fn):
    """fn(flat) over each bucket of `tensors` concatenated; returns the
    results as tensors shaped like the inputs (views into the flats)."""
    out = [None] * len(tensors)
    for idx in _buckets(tensors):
        flat = fn(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, seg in zip(idx, flat.split([tensors[i].numel()
                                           for i in idx])):
            out[i] = seg.view(tensors[i].shape)
    return out


def _inexact(t):
    return t.is_floating_point() or t.is_complex()


def _uninstall_update_hook(net):
    """A ZeRO hook a wrapper left on `net`, removed, with its updater
    state put back in the canonical layout (reference:
    ``_uninstall_sharded_update``)."""
    if getattr(net, "_update_impl", None) is None or net._upd_states is None:
        return
    net._upd_states = net._canonical_upd_states()
    net._update_impl = None
    net._rebind()


class ParallelWrapper:
    """Data-parallel trainer over the ranks of a data group.

    Usage (reference ParallelWrapper.Builder parity), on every rank:
        pw = ParallelWrapper(net)              # the default process group
        pw = ParallelWrapper(net, mesh=mesh)   # parallel.data_parallel_mesh()
        pw.fit(iterator)                       # the same data on every rank
    """

    def __init__(self, net, mesh=None, gradient_compression=None,
                 batch_axis=_mesh.DATA_AXIS, threshold=1e-3,
                 targetSparsity=None, weight_update="replicated",
                 min_shard_size=2 ** 16, encodingCapacity=None,
                 residualClip=None, residualClipFrequency=1,
                 compressionBlock=None, compressionGroupSize=None,
                 intraGroupCompression="block_int8"):
        if getattr(net, "_solver", None) is not None:
            raise ValueError(
                "distributed trainers require "
                "optimizationAlgo=STOCHASTIC_GRADIENT_DESCENT: a shard-"
                "local line search (LBFGS/CG) would accept a different "
                "step size on every replica and silently desynchronize "
                "the supposedly-replicated parameters")
        self.net = net
        self.mesh = _mesh.data_parallel_mesh() if mesh is None else mesh
        self.batch_axis = batch_axis
        self.gradient_compression = gradient_compression
        self.threshold = float(threshold)
        if gradient_compression in ("threshold", "hierarchical") \
                and self.threshold <= 0:
            raise ValueError(
                f"threshold (tau) must be > 0, got {threshold}: the "
                "Strom encoder transmits sign(g)*tau, so a non-positive "
                "tau would negate (or zero) every transmitted update")
        self.targetSparsity = None if targetSparsity is None \
            else float(targetSparsity)
        if encodingCapacity is None:
            cap = _sh.DEFAULT_ENCODING_CAPACITY \
                if self.targetSparsity is None \
                else max(_sh.DEFAULT_ENCODING_CAPACITY,
                         min(1.0, 2.0 * self.targetSparsity))
        else:
            cap = float(encodingCapacity)
            if not 0.0 < cap <= 1.0:
                raise ValueError(
                    f"encodingCapacity must be in (0, 1], got {cap}")
            if self.targetSparsity is not None \
                    and self.targetSparsity > cap:
                raise ValueError(
                    f"targetSparsity {self.targetSparsity} exceeds "
                    f"encodingCapacity {cap}: the fixed-capacity "
                    "encoder can never transmit more than the capacity "
                    "fraction, so the adaptive threshold could not "
                    "reach its target")
        self.encoding_capacity = cap
        self.residual_clip = None if residualClip is None \
            else float(residualClip)
        self.residual_clip_frequency = int(residualClipFrequency)
        if self.residual_clip is not None and self.residual_clip <= 0:
            raise ValueError(
                f"residualClip must be > 0, got {residualClip}")
        if self.residual_clip_frequency < 1:
            raise ValueError(
                "residualClipFrequency must be >= 1, got "
                f"{residualClipFrequency}")
        self.compression_block = _sh.DEFAULT_COMPRESSION_BLOCK \
            if compressionBlock is None else int(compressionBlock)
        if self.compression_block < 1:
            raise ValueError(
                f"compressionBlock must be >= 1, got {compressionBlock}")
        if gradient_compression not in _sh.COMPRESSION_MODES:
            raise ValueError(
                "gradient_compression must be one of "
                f"{_sh.COMPRESSION_MODES}, got {gradient_compression!r}")
        if intraGroupCompression not in (None, "block_int8"):
            raise ValueError(
                "intraGroupCompression must be None (dense hop-1 "
                "reduce-scatter) or 'block_int8', got "
                f"{intraGroupCompression!r}")
        self.intra_compression = intraGroupCompression
        self._hier = None
        self.compression_group = None
        if gradient_compression == "hierarchical":
            dp = self.mesh.shape.get(self.batch_axis, 0)
            gsz = _sh.default_compression_group(dp) \
                if compressionGroupSize is None else int(compressionGroupSize)
            # hierarchical_mesh validates (a pure data axis, g >= 2, g <
            # dp, g | dp) and makes this rank's two subgroups
            self._hier = _sh.hierarchical_mesh(self.mesh, gsz,
                                               batch_axis=self.batch_axis)
            self.compression_group = gsz
            self._n_groups = self._hier.n_groups
        elif compressionGroupSize is not None:
            raise ValueError(
                f"compressionGroupSize given together with "
                f"gradient_compression={gradient_compression!r}: the "
                "node-group size only applies to the 'hierarchical' "
                "2-hop exchange; drop one of the two arguments")
        if weight_update not in ("replicated", "sharded"):
            raise ValueError(
                "weight_update must be 'replicated' or 'sharded', got "
                f"{weight_update!r}")
        if weight_update == "sharded" \
                and gradient_compression in ("threshold", "hierarchical"):
            raise ValueError(
                "weight_update='sharded' composes with "
                "gradient_compression None/'int8'/'block_int8' "
                "(compressed reduce-scatter -> 1/dp shard update -> "
                "all-gather), but not "
                f"{gradient_compression!r}: the Strom exchange's "
                "per-replica error-feedback residual transmits sparse "
                "all-gathered messages, which have no per-parameter "
                "reduce-scatter form. Pick 'int8'/'block_int8', or "
                "keep the update replicated.")
        if gradient_compression in ("int8", "block_int8") \
                and weight_update == "sharded" \
                and getattr(net.conf, "gradientNormalization", None) \
                is not None:
            raise ValueError(
                "gradient normalization is applied to the REDUCED "
                "gradient, but the compressed sharded update "
                "reduce-scatters inside the weight-update hook — the "
                "normalization would see per-replica gradients and "
                "silently change semantics. Drop gradientNormalization "
                "or use weight_update='replicated'.")
        self.weight_update = weight_update
        self.min_shard_size = int(min_shard_size)
        self._zero = None
        if weight_update == "sharded":
            self._zero = _sh.ZeroShardedUpdate(
                self.mesh, axis=self.batch_axis,
                min_shard_size=self.min_shard_size,
                compression=gradient_compression,
                block=self.compression_block)
            # the dense exchange under gradient normalization reduces the
            # whole gradient first; the hook then takes its blocks
            self._zero.pre_reduced = gradient_compression is None and \
                getattr(net.conf, "gradientNormalization", None) is not None
        if self.mesh.backend == "nccl" and net.device.type != "cuda":
            raise ValueError(
                f"a NCCL group trains networks on the card, and this one "
                f"is on {net.device}: build it with a CUDA device, or "
                "initialise the group with backend='gloo'")
        self._placed = False
        self._captured = None  # the CapturedStep, once precompiled
        self._ef = None       # threshold, hierarchical: this rank's
        self._tau = None      # residual (one flat) and the live tau
        self._weight = None   # dense under a label mask: this rank's share
        #: collectives and bytes of the last step (collectives.totals)
        self.last_step = {}

    @property
    def _residual(self):
        """(this rank's error-feedback residual, live tau) in threshold
        mode (in the shape of the net's params) and hierarchical mode
        (one flat block a param, ``hierarchical_shard_elems`` long: this
        rank's row of the reference's [groups, group, shard]); None in
        the other modes or before the first fit."""
        if self._ef is None:
            return None
        layers = self._layer_params()
        leaves = _leaves(layers)
        if self._hier is None:
            views = iter(v.view(t.shape) for v, t in zip(
                self._ef.split([t.numel() for t in leaves]), leaves))
        else:
            views = iter(self._ef.split(self._ef_sizes(leaves)))
        ef = [_rebuild(p, views) for p in layers]
        if self._is_graph():
            ef = dict(zip(self.net._layer_names, ef))
        return ef, self._tau

    def _is_graph(self):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return isinstance(self.net, ComputationGraph)

    def _layer_params(self):
        """The net's per-layer param dicts in gradient order."""
        n = self.net
        if self._is_graph():
            return [n._params[name] for name in n._layer_names]
        return list(n._params)

    def _net_state(self):
        n = self.net
        return [n._params, n._upd_states, n._states]

    def _ef_sizes(self, leaves):
        """The residual's length a param leaf."""
        if self._hier is None:
            return [t.numel() for t in leaves]
        return [_sh.hierarchical_shard_elems(t.numel(),
                                             self.compression_group)
                for t in leaves]

    # ------------------------------------------------------------------
    def _broadcast_from_rank0(self, tree):
        """Overwrite every tensor of `tree` in place with rank 0's."""
        if self.mesh.pg is None:
            return
        leaves = _leaves(tree)
        flat = _flat_apply(leaves,
                           lambda f: _coll.broadcast(f, self.mesh, 0))
        with torch.no_grad():
            for t, v in zip(leaves, flat):
                t.copy_(v)

    def _place_replicated(self):
        """Rank 0's params, updater state and layer state on every rank
        (reference: ``_place_replicated``), the ZeRO hook installed or a
        stale one uninstalled (``_place_sharded_update``), and the
        threshold and hierarchical modes' zero residual and initial
        tau."""
        _uninstall_update_hook(self.net)
        self._broadcast_from_rank0(self._net_state())
        if self._zero is not None:
            self._place_sharded_update()
        if self.gradient_compression in ("threshold", "hierarchical"):
            leaves = _leaves(self._layer_params())
            self._ef = torch.zeros(sum(self._ef_sizes(leaves)),
                                   dtype=leaves[0].dtype,
                                   device=self.net.device)
            self._tau = torch.tensor(self.threshold, dtype=torch.float32,
                                     device=self.net.device)
        self._placed = True

    def _place_sharded_update(self):
        """Install the ZeRO hook and put the updater state into the
        sharded layout (reference: ``_place_sharded_update``): a fresh
        net (iteration 0) allocates it sharded, a trained or restored
        one (the canonical full-shape layout) keeps this rank's blocks,
        bitwise."""
        n, z = self.net, self._zero
        fresh = n._iteration == 0
        keys = n._unit_keys()
        for k in keys:
            if n._params[k]:
                n._upd_states[k] = z.init_state(n._updaters[k],
                                                n._params[k]) \
                    if fresh else z.place_state(n._upd_states[k])
        n._update_impl = z
        n._rebind()

    def _trainer_state(self):
        """What a checkpoint must hold beyond the net for a bitwise
        resume (reference: the carry ``{ef, tau}``): every rank's
        error-feedback residual, gathered in rank order [dp, len], and
        the live tau; None in the modes without one. Every rank calls
        it."""
        if self._ef is None:
            return None
        return {"ef": _coll.all_gather(self._ef, self.mesh),
                "tau": self._tau.reshape(())}

    def _load_trainer_state(self, state):
        """This rank's row of a checkpoint's trainer state (after
        placement); a layout this wrapper's mode does not hold
        raises."""
        if state is None:
            if self._ef is not None:
                raise ValueError(
                    f"the checkpoint holds no trainer state, and "
                    f"gradient_compression={self.gradient_compression!r} "
                    "needs its residual and tau for a bitwise resume")
            return
        ef = torch.as_tensor(state["ef"])
        want = (self.mesh.size, 0 if self._ef is None else self._ef.numel())
        if self._ef is None or tuple(ef.shape) != want:
            raise ValueError(
                f"incompatible trainer state: the checkpoint's residual "
                f"is {tuple(ef.shape)}, this wrapper "
                f"(gradient_compression={self.gradient_compression!r}, "
                f"{self.mesh.size} ranks) holds {want}")
        self._ef = _sh.own_row(ef, self.mesh).to(
            self._ef.device, self._ef.dtype).clone()
        self._tau = torch.as_tensor(state["tau"]).to(
            self._tau.device, torch.float32).reshape(()).clone()

    # ------------------------------------------------------------------
    def _mean(self, tensors, weight=None):
        """The mean over the ranks of each tensor (one all-reduce a
        dtype): the sum of `weight`-scaled tensors when a weight is
        given."""
        return _sh.mean_all(tensors, self.mesh, weight)

    def _mask_weight(self, lmask):
        """This rank's share of the global unmasked label count (dense
        mode under a label mask; module docstring), or None."""
        if lmask is None or self.mesh.size == 1:
            return None
        if isinstance(lmask, (list, tuple)):
            lmask = lmask[0]
        local = lmask.sum(dtype=torch.float64).reshape(1)
        total = _coll.all_reduce(local.clone(), self.mesh)
        return (local / total.clamp_min(1.0))[0]

    def _exchange_grads(self, grads):
        """This rank's per-layer gradients -> the exchanged mean (every
        mode); `grads` as the networks' ``_train_step`` hands them."""
        leaves = _leaves(grads)
        mode = self.gradient_compression
        if self._zero is not None:
            # the hook reduce-scatters; only the dense mode under
            # gradient normalization reduces the whole gradient here
            if not self._zero.pre_reduced:
                return grads
            out = self._mean(leaves, self._weight)
        elif mode is None:
            out = self._mean(leaves, self._weight)
        elif mode in ("threshold", "hierarchical"):
            out = self._threshold_exchange(leaves)
        else:
            out = _sh.quantized_psum_mean(leaves, self.mesh, mode,
                                          self.compression_block)
        return _rebuild(grads, iter(out))

    def _threshold_exchange(self, leaves):
        """The Strom exchange, flat or hierarchical (its leader hop),
        with error feedback, residual clipping and the adaptive tau
        (reference: ``_threshold_step``, ``_hierarchical_step``: the
        transmitted fraction is of the residual's entries, averaged over
        every rank)."""
        g, tau = self.mesh, self._tau
        if self._hier is None:
            means, res, sent = _sh.threshold_psum_mean(
                leaves, self._ef, tau, self.encoding_capacity, g)
        else:
            means, res, sent = _sh.hierarchical_grad_exchange(
                leaves, self._ef, tau, self._hier, self.encoding_capacity,
                self.intra_compression, self.compression_block)
        clip, freq = self.residual_clip, self.residual_clip_frequency
        if clip is not None and (freq == 1 or self._step_it % freq == 0):
            lim = (clip * tau).to(res.dtype)
            res = res.clamp(-lim, lim)
        self._ef = res
        if self.targetSparsity is not None:
            total = res.numel()
            frac = _sh._div(sent.to(torch.float32), total).reshape(1)
            frac = _sh._div(_coll.all_reduce(frac, g)[0], g.size)
            target = self.targetSparsity
            self._tau = torch.where(
                frac > 1.25 * target, tau * 1.1,
                torch.where(frac < 0.8 * target, _sh._div(tau, 1.1), tau))
        return means

    def _loss_mean(self, loss):
        return self._mean([loss.reshape(1)], self._weight)[0][0]

    def _state_mean(self, states):
        """The mean of the inexact layer-state leaves (reference:
        ``sync_states``)."""
        leaves = _leaves(states)
        idx = [i for i, t in enumerate(leaves) if _inexact(t)]
        means = self._mean([leaves[i] for i in idx])
        for i, m in zip(idx, means):
            leaves[i] = m
        return _rebuild(states, iter(leaves))

    def _hooks(self, lmask):
        """The step hooks of this mode (module docstring)."""
        dense = self.gradient_compression is None
        self._weight = self._mask_weight(lmask) if dense else None  # purity-ok[PUR04]: a device tensor the same step's hooks read while it is captured; a replay reruns the kernels that compute it
        if self._zero is not None:
            self._zero.weight = self._weight  # purity-ok[PUR04]: the same step's weight, read by the same step's hook
        return dict(grad_transform=self._exchange_grads,
                    loss_transform=self._loss_mean,
                    state_transform=None if dense else self._state_mean,
                    bn_group=self.mesh if dense else None)

    # ------------------------------------------------------------------
    def _rows(self, a):
        if a is None:
            return None
        return _sh.shard_batch(_unwrap(a), self.mesh,
                               self.batch_axis).to(self.net.device)

    def _fit_batch(self, x, y, fmask, lmask):
        _timed_step(self.net, lambda: self._step(*self._args(x, y, fmask,
                                                             lmask)))

    def _args(self, x, y, fmask, lmask):
        """One global batch as this rank's rows, in the form the net's
        ``_train_step`` takes."""
        n = self.net
        if self._is_graph():
            conf = n.conf
            if (len(conf.networkInputs) != 1 or len(conf.networkOutputs) != 1
                    or isinstance(x, (list, tuple))):
                raise ValueError(
                    "ParallelWrapper supports single-input/single-output "
                    "ComputationGraphs; use MultiDataSet-aware training "
                    "directly for multi-IO graphs")
        x, y, fmask, lmask = (self._rows(a) for a in (x, y, fmask, lmask))
        if self._is_graph():
            name = n.conf.networkInputs[0]
            x, y = {name: x}, [y]
            fmask = None if fmask is None else {name: fmask}
            lmask = None if lmask is None else [lmask]
        return x, y, fmask, lmask

    def _body(self, x, y, fmask, lmask, iteration):
        """This mode's data-parallel step at `iteration` (what a capture
        holds); the loss tensor."""
        self._step_it = iteration  # purity-ok[PUR04]: read only by the threshold exchange, whose capture is refused (precompile)
        n = self.net
        return n._train_step(
            x, y, fmask, lmask, iteration=iteration, rank=self.mesh.rank,
            hyper=None if self._captured is None else n._hyper_scalars(),
            **self._hooks(lmask))

    def _step(self, x, y, fmask, lmask, iteration=None):
        n = self.net
        it = n._iteration if iteration is None else iteration
        before = _coll.totals()
        cap = self._captured
        if cap is None:
            loss = self._body(x, y, fmask, lmask, it)
        elif cap.refusal is not None:
            loss = cap._eager((x, y, fmask, lmask), {"iteration": it},
                              "refused")
        else:
            loss = cap(x, y, fmask, lmask, iteration=it).clone()
        self._record(before)
        return loss

    def precompile(self, batchSize=32, featuresShape=None,
                   labelsShape=None, cache=None):
        """Capture the data-parallel step for one GLOBAL batch signature
        (reference: ``precompile``): at world 1 a CUDA graph that ``fit``
        replays; over more ranks (every rank calls it) one eager warm
        step, put back, with the key recorded, and the steps stay eager,
        each counted as uncaptured. Returns {"pw_train_step": {key,
        status, seconds}}."""
        import time

        import numpy as np

        from deeplearning4j_tpu_torch.nn.multilayer import example_batch
        from deeplearning4j_tpu_torch.runtime import aot

        n = self.net
        n._require_init()
        if not self._placed:
            self._place_replicated()
        if self._is_graph():
            fs, ls = n._example_shapes(batchSize, featuresShape, labelsShape)
            x, y = np.zeros(fs, np.float32), np.zeros(ls, np.float32)
        else:
            x, y = example_batch(n, batchSize, featuresShape, labelsShape)
        args = self._args(x, y, None, None)
        if self._captured is None:
            n._train_capture()      # the net's own fits: counted too
            self._captured = aot.CapturedStep(
                self._body, owner=n, entry="pw_train_step",
                extra=f"|{self.gradient_compression}|{self.mesh.size}"
                      f"|{self.weight_update}|{self.compression_group}",
                prologue=lambda iteration: n._hyper_scalars().write(
                    iteration, n._epoch),
                snapshot=n._snapshot, restore=n._restore)
            if self.mesh.size > 1 or self.mesh.pg is not None:
                self._captured.refusal = (
                    "capturing the NCCL exchange of a step over "
                    f"{self.mesh.size} rank(s) waits for ROADMAP.md Queue 1 "
                    "item 7; the steps run eagerly")
            elif self.gradient_compression in ("threshold",
                                               "hierarchical"):
                self._captured.refusal = (
                    "the threshold exchange rebinds its residual and tau "
                    "on the host each step and clips the residual on the "
                    "iteration's count: a replay would reuse the "
                    "capture's buffers and decision")
            else:
                self._captured.refusal = n._capture_refusal()
        cap = self._captured
        if cache is not None:
            cap.pin_cache(cache)
        if cap.refusal is None:
            key, status, secs = cap.capture(args, iteration=n._iteration)
        else:
            t0 = time.perf_counter()
            snap = n._snapshot()
            self._body(*args, iteration=n._iteration)
            n._restore(snap)
            key, status = cap.key_for(args), "eager"
            secs = time.perf_counter() - t0
        return {"pw_train_step": {"key": key, "status": status,
                                  "seconds": round(secs, 3)}}

    def trainStep(self):
        """The per-batch step with the reference's signature,
        ``(params, upd, states, it, x, y, key, fmask, lmask) -> (params,
        upd, states, loss)``: the port's step updates the network's own
        tensors in place, so it takes the net's containers (anything
        else raises) and returns them. `x`, `y` are this rank's rows."""
        n = self.net

        def step(params, upd, states, it, x, y, key=None, fmask=None,
                 lmask=None):
            if params is not n._params or upd is not n._upd_states:
                raise ValueError(
                    "the port's step updates the network's tensors in "
                    "place: pass net._params and net._upd_states")
            loss = self._step(x, y, fmask, lmask, iteration=int(it))
            return n._params, n._upd_states, n._states, loss

        return step

    def _record(self, before):
        count, payload, wire = (a - b for a, b in
                                zip(_coll.totals(), before))
        self.last_step = {"collectives": count, "payload_bytes": payload,
                          "wire_bytes": wire}

    def fit(self, data, labels=None, epochs=None):
        """fit(x, y) | fit(DataSet) | fit(DataSetIterator[, epochs]) with
        the same global batches on every rank; one data-parallel step a
        batch. Returns self."""
        self.net._require_init()
        if not self._placed:
            self._place_replicated()
        fit_batches(
            self.net, data, labels, epochs,
            lambda x, y: self._fit_batch(x, y, None, None),
            lambda ds: self._fit_batch(ds.getFeatures(), ds.getLabels(),
                                       ds.getFeaturesMaskArray(),
                                       ds.getLabelsMaskArray()))
        return self

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=None):
        """``fit`` of an iterator with one host sync a block of
        ``stepsPerSync`` batches, through the networks' block driver
        (``nn.multilayer.run_fit_dataset_epoch``): each rank stages the
        block's global batches on its device, and each step takes this
        rank's rows of batch i and runs this mode's data-parallel step.
        stepsPerSync=1 is ``fit``; the host syncs are left in
        ``_fit_dataset_syncs``."""
        n = self.net
        k = check_steps_per_sync(stepsPerSync)
        n._require_init()
        if not self._placed:
            self._place_replicated()
        if k == 1:
            it0 = n._iteration
            self.fit(iterator, epochs=epochs)
            self._fit_dataset_syncs = n._iteration - it0
            return self
        if n._is_tbptt():
            raise ValueError(TBPTT_REFUSAL)
        stager = BlockStager(n.device)

        def step(tensors, it):
            return self._step(*self._args(*tensors), iteration=it)

        def fit_one(ds):
            self._fit_batch(ds.getFeatures(), ds.getLabels(),
                            ds.getFeaturesMaskArray(),
                            ds.getLabelsMaskArray())

        self._fit_dataset_syncs = 0
        for _ in range(epochs or 1):
            iterator.reset()
            fire(n, "onEpochStart")
            self._fit_dataset_syncs += run_fit_dataset_epoch(
                n, iterator, k, step, fit_one, stager)
            fire(n, "onEpochEnd")
            n._epoch += 1
        return self

    def averagingFrequency(self, *_):
        # synchronous exchange makes per-step averaging exact already;
        # periodic averaging is ParameterAveragingTrainingMaster's
        return self

    def workers(self, *_):
        return self


class SharedTrainingMaster(ParallelWrapper):
    """Gradient-sharing distributed trainer (reference: Spark
    SharedTrainingMaster): ParallelWrapper with the int8-quantized
    all-reduce by default. ``gradient_compression=None`` is the dense
    all-reduce, ``"block_int8"`` per-block scales, ``"threshold"`` or a
    ``thresholdAlgorithm`` the Strom-2015 encoding. ``thresholdAlgorithm``
    maps to trainer config: a bare number or FixedThresholdAlgorithm pins
    tau; AdaptiveThresholdAlgorithm / TargetSparsityThresholdAlgorithm
    set the initial tau and targetSparsity; ``residualPostProcessor=
    ResidualClippingPostProcessor(...)`` wires residual clipping;
    unknown objects raise naming the supported set.
    ``compressionGroupSize`` selects the hierarchical 2-hop exchange."""

    def __init__(self, net, mesh=None, thresholdAlgorithm=None,
                 residualPostProcessor=None, compressionGroupSize=None,
                 **kw):
        if compressionGroupSize is not None:
            gc = kw.get("gradient_compression", "hierarchical")
            if gc != "hierarchical":
                raise ValueError(
                    f"compressionGroupSize given together with "
                    f"gradient_compression={gc!r}: the node-group size "
                    "only applies to the 'hierarchical' 2-hop exchange; "
                    "drop one of the two arguments")
            kw.setdefault("gradient_compression", "hierarchical")
            kw["compressionGroupSize"] = compressionGroupSize
        if thresholdAlgorithm is not None:
            gc = kw.get("gradient_compression", "threshold")
            if gc not in ("threshold", "hierarchical"):
                raise ValueError(
                    f"thresholdAlgorithm given together with "
                    f"gradient_compression={gc!r}: the threshold algorithm "
                    "only applies to the 'threshold' (Strom-2015) encoding "
                    "or the 'hierarchical' 2-hop exchange (whose leader "
                    "hop is the same encoder); drop one of the two "
                    "arguments")
            kw.setdefault("gradient_compression", "threshold")
            algo = thresholdAlgorithm
            if isinstance(algo, (int, float)) \
                    and not isinstance(algo, bool):
                algo = FixedThresholdAlgorithm(algo)
            if isinstance(algo, AdaptiveThresholdAlgorithm):
                kw.setdefault("threshold", algo.threshold)
                kw.setdefault("targetSparsity", algo.sparsityTarget)
            elif isinstance(algo, FixedThresholdAlgorithm) \
                    or hasattr(algo, "threshold"):
                kw.setdefault("threshold", float(algo.threshold))
            else:
                names = [c.__name__ for c in THRESHOLD_ALGORITHMS]
                raise ValueError(
                    f"unknown thresholdAlgorithm {thresholdAlgorithm!r}; "
                    f"pass a number (fixed tau) or one of {names}")
        if residualPostProcessor is not None:
            if kw.get("gradient_compression",
                      "threshold") not in ("threshold", "hierarchical") \
                    and thresholdAlgorithm is None:
                raise ValueError(
                    "residualPostProcessor only applies to the "
                    "'threshold' and 'hierarchical' encodings (there "
                    "is no residual elsewhere)")
            rpp = residualPostProcessor
            if not isinstance(rpp, ResidualClippingPostProcessor):
                raise ValueError(
                    f"unknown residualPostProcessor {rpp!r}; supported: "
                    "ResidualClippingPostProcessor")
            kw.setdefault("gradient_compression", "threshold")
            kw.setdefault("residualClip", rpp.clipValue)
            kw.setdefault("residualClipFrequency", rpp.frequency)
        kw.setdefault("gradient_compression", "int8")
        super().__init__(net, mesh=mesh, **kw)


class ParameterAveragingTrainingMaster(ParallelWrapper):
    """Parameter-averaging distributed trainer (reference: Spark
    ParameterAveragingTrainingMaster). Each rank's replica takes LOCAL
    updater steps on its own rows (no gradient exchange; per-rank BN)
    and every ``averagingFrequency`` iterations params, updater state
    and the inexact layer state are averaged over the ranks. The score
    is the mean loss. The net itself holds the replicas' average after
    each ``fit`` (the reference's aggregated model); the
    replica a rank trains is ``_replica``. With ``averagingFrequency=1``
    and plain SGD this equals synchronous gradient sharing."""

    def __init__(self, net, mesh=None, averagingFrequency=5,
                 batch_axis=_mesh.DATA_AXIS, weight_update="replicated"):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        if isinstance(net, ComputationGraph):
            raise ValueError(
                "ParameterAveragingTrainingMaster supports "
                "MultiLayerNetwork; for ComputationGraph data-parallel "
                "training use ParallelWrapper/SharedTrainingMaster "
                "(single-input/-output graphs)")
        if weight_update == "sharded":
            raise ValueError(
                "ParameterAveragingTrainingMaster does not support "
                "weight_update='sharded': its replicas take LOCAL "
                "updater steps on per-replica state, so there is no "
                "cross-replica weight update to shard. The ZeRO-style "
                "sharded update is supported by ParallelWrapper and "
                "SharedTrainingMaster(gradient_compression=None).")
        super().__init__(net, mesh=mesh, batch_axis=batch_axis,
                         weight_update=weight_update)
        if int(averagingFrequency) < 1:
            raise ValueError("averagingFrequency must be >= 1")
        self._avg_freq = int(averagingFrequency)
        self._replica = None    # this rank's [params, upd, states]
        self._in_sync = True    # every replica equal (just averaged)

    def trainStep(self):
        raise ValueError(
            "ParameterAveragingTrainingMaster's step is not expressible "
            "as one wrappable train step: it takes LOCAL per-replica "
            "steps with a periodic average, all inside its own "
            "_fit_batch. Wrap ParallelWrapper/SharedTrainingMaster "
            "instead")

    def precompile(self, *args, **kwargs):
        raise ValueError(
            "ParameterAveragingTrainingMaster picks a local step or an "
            "averaging step per iteration on the host: there is no one "
            "step to capture; precompile the ParallelWrapper/"
            "SharedTrainingMaster step instead")

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=None):
        if int(stepsPerSync) == 1:
            return self.fit(iterator, epochs=epochs)
        raise ValueError(
            "ParameterAveragingTrainingMaster does not support "
            "stepsPerSync > 1: it picks a different executable per "
            "iteration host-side (averaging vs local step), which a "
            "single traced k-loop cannot express without paying the "
            "full-state pmean every step; use ParallelWrapper/"
            "SharedTrainingMaster for the k-stack loop")

    def averagingFrequency(self, k):
        if self._placed:
            raise RuntimeError("set averagingFrequency before the first fit()")
        if int(k) < 1:
            raise ValueError("averagingFrequency must be >= 1")
        self._avg_freq = int(k)
        return self

    def _place_replicated(self):
        """Rank 0's model on every rank, then this rank's own copy of it
        to take local steps on."""
        self._broadcast_from_rank0(self._net_state())

        def clone(t):
            c = t.detach().clone()
            return c.requires_grad_(t.requires_grad)

        self._replica = [_rebuild(tree, iter([clone(t)
                                              for t in _leaves(tree)]))
                         for tree in self._net_state()]
        self._in_sync = True
        self._placed = True

    def _average_(self, tree):
        """Every inexact tensor of `tree` replaced in place by its mean
        over the ranks."""
        leaves = [t for t in _leaves(tree) if _inexact(t)]
        with torch.no_grad():
            for t, m in zip(leaves, self._mean(leaves)):
                t.copy_(m)

    def _step(self, x, y, fmask, lmask):
        n = self.net
        before = _coll.totals()
        canonical = self._net_state()
        n._params, n._upd_states, n._states = self._replica
        try:
            loss = n._train_step(x, y, fmask, lmask, rank=self.mesh.rank,
                                 loss_transform=self._loss_mean)
            self._replica = self._net_state()
        finally:
            n._params, n._upd_states, n._states = canonical
        self._in_sync = (n._iteration + 1) % self._avg_freq == 0
        if self._in_sync:
            self._average_(self._replica)
        self._record(before)
        return loss

    def fit(self, data, labels=None, epochs=None):
        super().fit(data, labels, epochs)
        self._sync_to_net()
        return self

    def _sync_to_net(self):
        """The replicas' average as the net's model (reference:
        ``_sync_to_net``); no collective when the last step averaged."""
        if self._replica is None:
            return
        canonical = self._net_state()
        with torch.no_grad():
            for dst, src in zip(_leaves(canonical), _leaves(self._replica)):
                dst.copy_(src)
        if not self._in_sync:
            self._average_(canonical)
