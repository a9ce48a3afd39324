"""Resilient training runtime: retry, resume, and the non-finite guard.

The counterpart of ``deeplearning4j_tpu/runtime/resilience.py``, three
cooperating pieces:

* ``RetryPolicy`` / ``retry``: capped exponential backoff with
  deterministic seeded jitter, shared by the data path
  (``data.resilient.RetryingDataSetIterator``, ResilientFit's batch
  fetch) and checkpoint I/O.
* ``ResilientFit``: ``MultiLayerNetwork`` training with periodic atomic
  checkpoints (``util.sharded_checkpoint``), resume from the latest
  complete one (the iterator is replayed to the saved batch position, so
  a run killed mid-epoch and restarted lands on the bitwise identical
  trajectory: the shuffle order is ``RandomState(seed + epoch)`` and the
  port trains without dropout, so no RNG stream has to be restored), and
  the non-finite step guard.
* ``FaultInjector``: a deterministic, seedable fault schedule (an IOError
  on the n-th batch, a NaN-poisoned step, a preemption after a step).

The guard. The reference selects the old values inside its jitted step;
the port updates parameters and updater state in place, so
``NonFiniteGuard`` copies them into a shadow before the step
(``torch._foreach_copy_``) and afterwards puts each leaf back through a
device-side ``torch.where(ok, new, old)``; the layer states (BN's running
statistics), which a step replaces, are selected the same way. ``ok`` is
the finiteness of the loss and of the sum of ``torch._foreach_norm`` over
the new parameters (a NaN gradient surfaces as a NaN parameter), so the
guard itself reads nothing back. With ``stepsPerSync=k`` the flags, the
consecutive-bad count and the ``maxConsecutiveBadSteps`` freeze stay on
the device until the block's one sync, then the host replays them step
by step exactly as k = 1 fires them.

``ResilientFit`` over a ``ParallelWrapper`` runs the wrapper's step on
this rank's rows under the same guard, which also restores the
wrapper's residual and tau on a bad step. Every rank gathers the
checkpointed state (a ZeRO updater state in its canonical layout, every
rank's residual as the trainer state) and rank 0 writes it; a resume
re-places the net on the wrapper (re-sharding the updater state) and
gives each rank its residual, so a mid-epoch resume is bitwise the
unbroken run.
"""

from __future__ import annotations

import os
import random
import time

import torch

from deeplearning4j_tpu_torch.runtime.chaos import fault_point
from deeplearning4j_tpu_torch.util import sharded_checkpoint as _ckpt

__all__ = ["RetryPolicy", "retry", "Preemption", "FaultInjector",
           "NonFiniteStepError", "NonFiniteGuard", "non_finite_guard",
           "ResilientFit"]

_TM = None


def _tm():
    """Resilience telemetry handles (runtime.telemetry): retry counts and
    checkpoint I/O durations; the event counts are the MetricsListener's."""
    global _TM
    if _TM is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        _TM = {
            "reg": reg,
            "retries": reg.counter(
                "dl4j_retries_total",
                "transient failures retried with backoff (data fetch, "
                "checkpoint I/O)").labels(),
            "ckpt_save_s": reg.histogram(
                "dl4j_checkpoint_save_seconds",
                "atomic checkpoint write wall (ResilientFit._save)").labels(),
            "ckpt_restore_s": reg.histogram(
                "dl4j_checkpoint_restore_seconds",
                "checkpoint restore wall (resume-after-preemption)").labels(),
        }
    return _TM


# ----------------------------------------------------------------------
# retry with capped exponential backoff + deterministic jitter
# ----------------------------------------------------------------------
class RetryPolicy:
    """Capped exponential backoff. attempt k (1-based) sleeps

        base_k = min(maxDelay, initialDelay * multiplier**(k-1))
        delay_k in [base_k * (1 - jitter), base_k]

    with the jitter fraction drawn from random.Random(seed): the same seed
    replays the same delay sequence."""

    def __init__(self, maxRetries: int = 3, initialDelay: float = 0.05,
                 maxDelay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 retryOn=(IOError, OSError, TimeoutError), sleep=time.sleep):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.maxRetries = int(maxRetries)
        self.initialDelay = float(initialDelay)
        self.maxDelay = float(maxDelay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.retryOn = tuple(retryOn)
        self.sleep = sleep

    def delay(self, attempt: int, rng: random.Random) -> float:
        base = min(self.maxDelay,
                   self.initialDelay * self.multiplier ** (attempt - 1))
        return base * (1.0 - self.jitter * rng.random())

    def delays(self):
        """The full deterministic delay sequence this policy would sleep."""
        rng = random.Random(self.seed)
        return [self.delay(k, rng) for k in range(1, self.maxRetries + 1)]


def retry(fn, policy: RetryPolicy = None, on_retry=None):
    """Call fn(); on an exception in policy.retryOn, back off and retry up
    to policy.maxRetries times, then re-raise the last error.
    on_retry(attempt, exc, delay) observes each backoff."""
    policy = policy or RetryPolicy()
    rng = random.Random(policy.seed)
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retryOn as e:
            attempt += 1
            if attempt > policy.maxRetries:
                raise
            d = policy.delay(attempt, rng)
            _tm()["retries"].inc()
            if on_retry is not None:
                on_retry(attempt, e, d)
            policy.sleep(d)


# ----------------------------------------------------------------------
# deterministic fault injection
# ----------------------------------------------------------------------
class Preemption(Exception):
    """Simulated host preemption, raised by FaultInjector.killAfterStep."""


class FaultInjector:
    """Deterministic, seedable fault schedule threaded through the data
    iterators (wrapIterator) and the train step (ResilientFit). Every
    injection is recorded in .events as (kind, position)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.events = []
        self._io_faults = {}     # global batch index -> [times left, exc]
        self._poison_steps = set()
        self._kill_after = None
        self._killed = False

    def failOnBatch(self, n: int, times: int = 1, exc=None):
        """Raise `exc` (default IOError) from the wrapped iterator's
        next() for the n-th batch (0-based, counted across epochs),
        `times` consecutive attempts before that fetch succeeds."""
        self._io_faults[int(n)] = [int(times),
                                   exc if exc is not None
                                   else IOError(f"injected data fault at "
                                                f"batch {n}")]
        return self

    def randomIOFaults(self, nBatches: int, rate: float, times: int = 1):
        """IOErrors on a seed-deterministic subset of the first nBatches
        fetches (about `rate` of them)."""
        rng = random.Random(self.seed)
        for b in range(int(nBatches)):
            if rng.random() < rate:
                self.failOnBatch(b, times=times)
        return self

    def poisonStep(self, *steps: int):
        """Poison the features of the given global iterations with NaN."""
        self._poison_steps.update(int(s) for s in steps)
        return self

    def killAfterStep(self, step: int):
        """Raise Preemption once, right after the iteration count reaches
        `step` (after any checkpoint scheduled at that step)."""
        self._kill_after = int(step)
        return self

    def maybe_poison(self, iteration: int, x):
        if iteration in self._poison_steps:
            self.events.append(("poison", iteration))
            return torch.full_like(x, float("nan"))
        return x

    def maybe_kill(self, iteration: int):
        if (self._kill_after is not None and not self._killed
                and iteration >= self._kill_after):
            self._killed = True
            self.events.append(("preempt", iteration))
            raise Preemption(f"injected preemption after step {iteration}")

    def wrapIterator(self, iterator):
        """A DataSetIterator wrapper raising the scheduled data faults,
        before the underlying fetch (a retry consumes the same batch)."""
        return _FaultyIterator(iterator, self)

    def _check_fetch(self, global_batch: int):
        fault = self._io_faults.get(global_batch)
        if fault and fault[0] > 0:
            fault[0] -= 1
            self.events.append(("data_fault", global_batch))
            raise fault[1]


class _FaultyIterator:
    """FaultInjector's data-path shim: counts successful fetches across
    epochs and raises the scheduled exception before the fetch."""

    def __init__(self, base, injector: FaultInjector):
        self._base = base
        self._injector = injector
        self._fetched = 0

    def reset(self):
        self._base.reset()

    def hasNext(self):
        return self._base.hasNext()

    def next(self, num=None):
        self._injector._check_fetch(self._fetched)
        ds = self._base.next() if num is None else self._base.next(num)
        self._fetched += 1
        return ds

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def __getattr__(self, name):  # batch()/totalExamples()/preprocessors
        return getattr(self._base, name)


# ----------------------------------------------------------------------
# the non-finite step guard
# ----------------------------------------------------------------------
class NonFiniteStepError(FloatingPointError):
    """K consecutive steps produced a non-finite loss or parameters."""


def _tensors(tree):
    from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _select(keep, new, old):
    """`new` where `keep`, else `old`, leaf by leaf over equal trees."""
    if isinstance(new, dict):
        return {k: _select(keep, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(keep, v, o) for v, o in zip(new, old))
    if isinstance(new, torch.Tensor) and new.is_floating_point():
        return torch.where(keep, new, old)
    return new


def non_finite_guard(step_fn):
    """Wrap a functional train step ``(params, upd, states, it, x, y,
    key, fm, lm) -> (params', upd', states', loss)`` so that a step whose
    loss or updated parameters hold NaN/Inf returns its inputs unchanged,
    and an ``ok`` flag (reference: ``non_finite_guard``; the reference
    selects inside the jitted step, this one on the device with
    ``torch.where``, no host sync). The networks' own guarded step is
    ``NonFiniteGuard``."""

    def guarded(params, upd_states, states, iteration, x, y, key, fmask,
                lmask):
        new_p, new_u, new_s, loss = step_fn(
            params, upd_states, states, iteration, x, y, key, fmask, lmask)
        ok = torch.isfinite(torch.as_tensor(loss)).all()
        for t in _tensors(new_p):
            if t.is_floating_point():
                ok = ok & torch.isfinite(t).all()
        return (_select(ok, new_p, params), _select(ok, new_u, upd_states),
                _select(ok, new_s, states), loss, ok)

    return guarded


class NonFiniteGuard:
    """A guarded optimizer step over a network's ``_train_step``, or a
    ``ParallelWrapper``'s data-parallel step (module docstring):
    ``step(args, iteration, alive=None) -> (loss, ok)`` with both as
    device tensors; a step that is not ok (or not alive) leaves
    parameters, updater state, layer states and the wrapper's residual
    and tau as they were. The loss a wrapper's step returns is the mean
    over its ranks and the params are equal on every rank, so every rank
    takes the same decision."""

    def __init__(self, net, wrapper=None):
        self.net, self.wrapper = net, wrapper
        self._shadow = None

    def step(self, args, iteration, alive=None):
        net, w = self.net, self.wrapper
        live = _tensors([net._params, net._upd_states])
        with torch.no_grad():
            if self._shadow is None or len(self._shadow) != len(live) or any(
                    s.shape != t.shape for s, t in zip(self._shadow, live)):
                self._shadow = [torch.empty_like(t) for t in live]
            torch._foreach_copy_(self._shadow, live)
        old_states = net._states
        if w is None:
            loss = net._train_step(*args, iteration=iteration)
        else:
            old_ef, old_tau = w._ef, w._tau    # rebound, not written, a step
            loss = w._step(*args, iteration=iteration)
        with torch.no_grad():
            norms = torch._foreach_norm(_tensors(net._params))
            ok = torch.isfinite(loss).all()
            if norms:
                ok = ok & torch.isfinite(torch.stack(norms).sum())
            keep = ok if alive is None else ok & alive
            for t, s in zip(live, self._shadow):
                t.copy_(torch.where(keep, t, s))
            net._states = _select(keep, net._states, old_states)
            if w is not None and old_ef is not None:
                w._ef = torch.where(keep, w._ef, old_ef)
                w._tau = torch.where(keep, w._tau, old_tau)
        return loss, ok


# ----------------------------------------------------------------------
# the resilient training harness
# ----------------------------------------------------------------------
class ResilientFit:
    """Preemption-safe fit() for MultiLayerNetwork (reference:
    ResilientFit): periodic atomic checkpoints every
    ``saveEveryNIterations`` steps with keep-last-N rotation, resume from
    the latest complete checkpoint, the non-finite step guard, and retry
    with backoff on the batch fetch and the checkpoint I/O.

        rf = ResilientFit(net, ckpt_dir, saveEveryNIterations=50)
        rf.fit(iterator, epochs=10)        # kill it; run again: resumes

    Listener hooks: onStepSkipped, onCheckpointSaved,
    onCheckpointRestored, plus iterationDone/onEpochStart/onEpochEnd as
    fit() fires them."""

    def __init__(self, net, checkpointDir=None, *,
                 saveEveryNIterations: int = 0, keepLast: int = 2,
                 saveUpdater: bool = True,
                 maxConsecutiveBadSteps: int = 3,
                 retryPolicy: RetryPolicy = None,
                 injector: FaultInjector = None):
        from deeplearning4j_tpu_torch.nn.conf.builder import BackpropType
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper

        from deeplearning4j_tpu_torch.parallel.trainer import \
            ParameterAveragingTrainingMaster

        if isinstance(net, ParameterAveragingTrainingMaster):
            raise ValueError(
                "ResilientFit guards one data-parallel step a batch; a "
                "ParameterAveragingTrainingMaster takes local per-replica "
                "steps whose replicas a checkpoint of the averaged net "
                "does not hold: wrap a ParallelWrapper/"
                "SharedTrainingMaster instead")
        if isinstance(net, ParallelWrapper):
            self.wrapper, self.net = net, net.net
        else:
            self.wrapper, self.net = None, net
        if not isinstance(self.net, MultiLayerNetwork):
            raise TypeError(
                f"ResilientFit wraps MultiLayerNetwork (directly or via "
                f"ParallelWrapper); got {type(self.net).__name__}")
        if self.net.conf.backpropType == BackpropType.TruncatedBPTT:
            raise ValueError(
                "ResilientFit does not support truncated BPTT yet: a "
                "mid-sequence skip would desynchronize the carry stream")
        self.checkpointDir = None if checkpointDir is None \
            else os.path.abspath(str(checkpointDir))
        self.saveEvery = int(saveEveryNIterations)
        if self.saveEvery > 0 and self.checkpointDir is None:
            raise ValueError(
                "saveEveryNIterations > 0 needs a checkpointDir")
        self.keepLast = int(keepLast)
        self.saveUpdater = bool(saveUpdater)
        self.maxBad = int(maxConsecutiveBadSteps)
        self.retryPolicy = retryPolicy or RetryPolicy()
        self.injector = injector
        self._guard = NonFiniteGuard(self.net, self.wrapper)
        self._stager = None
        self._bad = 0
        self.skippedSteps = 0

    # ----- checkpoint / resume ----------------------------------------
    def _fire(self, hook, *args):
        from deeplearning4j_tpu_torch.nn.multilayer import fire

        fire(self.net, hook, *args)

    def _lead(self):
        """Whether this process writes the checkpoints (rank 0 of a
        wrapper's group; the only process without one)."""
        w = self.wrapper
        return w is None or w.mesh.pg is None or w.mesh.rank == 0

    def _all_ok(self, ok):
        """Whether `ok` holds on every rank of the wrapper's group: one
        MIN all-reduce, which is also a barrier."""
        w = self.wrapper
        if w is None or w.mesh.pg is None:
            return ok
        import torch.distributed as dist

        flag = torch.tensor([int(ok)], device=w.mesh.device or "cpu")
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=w.mesh.pg)
        return bool(flag.item())

    def _save(self, batch_in_epoch: int):
        net, w = self.net, self.wrapper
        tm = _tm()
        t0 = time.perf_counter()
        path = _ckpt.step_path(self.checkpointDir, net._iteration)
        # every rank gathers: a ZeRO updater state's blocks, and the
        # residuals of the trainer state; one rank writes
        state = _ckpt.net_state(net, self.saveUpdater)
        trainer = None if w is None else w._trainer_state()

        def _write():
            # the chaos seam sits inside the retried call: an injected
            # write fault is retried like any transient I/O failure
            fault_point("checkpoint.write")
            return _ckpt.write_state(
                net, path, state, saveUpdater=self.saveUpdater,
                extra={"iteration": net._iteration, "epoch": net._epoch,
                       "batch_in_epoch": int(batch_in_epoch)},
                trainer_state=trainer)

        err = None
        if self._lead():
            try:
                retry(_write, self.retryPolicy)
                _ckpt.gc_checkpoints(self.checkpointDir, self.keepLast)
            except Exception as e:      # raised below, on every rank
                err = e
        # no rank reads a checkpoint before its commit, and no rank goes
        # on (or waits) where the lead's write failed
        if not self._all_ok(err is None):
            if err is not None:
                raise err
            raise OSError(
                f"the checkpoint of iteration {net._iteration} failed on "
                f"the writing rank (rank 0): {path}")
        dt = time.perf_counter() - t0
        tm["ckpt_save_s"].observe(dt)
        tm["reg"].add_span("resilience.checkpoint_save", "resilience", t0,
                           dt, iteration=net._iteration)
        self._fire("onCheckpointSaved", path, net._iteration)

    def _maybe_resume(self) -> int:
        """Restore the latest complete checkpoint into the net and return
        the batch within its epoch to replay past (0: a fresh or
        epoch-aligned start). A checkpoint failing its digest is treated
        as absent: the walk falls back to the previous one."""
        if self.checkpointDir is None:
            return 0
        steps = _ckpt.complete_steps(self.checkpointDir)
        if not steps:
            return 0
        tm = _tm()
        t0 = time.perf_counter()
        restored = path = None
        for step in reversed(steps):
            path = _ckpt.step_path(self.checkpointDir, step)

            def _restore(p=path):
                fault_point("checkpoint.restore")
                return _ckpt.ShardedModelSerializer.restore(
                    p, device=self.net.device)

            try:
                restored = retry(_restore, self.retryPolicy)
                break
            except _ckpt.CheckpointDigestError:
                tm["reg"].add_span("resilience.checkpoint_corrupt",
                                   "resilience", time.perf_counter(), 0.0,
                                   step=step, path=path)
                continue
        if restored is None:
            return 0
        net, w = self.net, self.wrapper
        net._params = restored._params
        net._states = restored._states
        net._upd_states = restored._upd_states
        net._iteration = restored._iteration
        net._epoch = restored._epoch
        net._rebind()
        if w is not None:
            # the restored updater state is canonical: the wrapper
            # re-shards it (ZeRO) and takes this rank's residual and tau
            net._update_impl = None
            w._place_replicated()
            w._load_trainer_state(_ckpt.restore_trainer_state(
                path, device=net.device))
        extra = _ckpt.read_manifest(path).get("extra", {})
        dt = time.perf_counter() - t0
        tm["ckpt_restore_s"].observe(dt)
        tm["reg"].add_span("resilience.checkpoint_restore", "resilience",
                           t0, dt, iteration=net._iteration)
        self._fire("onCheckpointRestored", path, net._iteration)
        return int(extra.get("batch_in_epoch", 0))

    # ----- the loop ----------------------------------------------------
    def fit(self, data, epochs: int = 1, stepsPerSync: int = 1):
        """Train until `epochs` epochs are complete, resuming from the
        latest checkpoint when there is one. `data` is a DataSetIterator
        whose order replays (deterministic or seeded).

        stepsPerSync=k > 1 runs k-batch blocks with the guard inside each
        step and one host sync a block; checkpoint and preemption points
        fall on the block boundaries (a save cadence landing mid-block
        commits at the block's end). The parameter trajectory, skipped
        steps included, is that of stepsPerSync=1; the ragged final
        block runs per batch."""
        from deeplearning4j_tpu_torch.nn.multilayer import (
            BlockStager, check_steps_per_sync,
        )

        net = self.net
        net._require_init()
        k = check_steps_per_sync(stepsPerSync)
        replay = self._maybe_resume()
        if self.wrapper is not None and not self.wrapper._placed:
            self.wrapper._place_replicated()
        if k > 1 and self._stager is None:
            self._stager = BlockStager(net.device)
        self._bad = 0
        while net._epoch < int(epochs):
            data.reset()
            skip, replay = replay, 0
            if skip == 0:
                self._fire("onEpochStart")
            b = 0
            buf = []
            while self._has_next(data):
                ds = retry(data.next, self.retryPolicy)
                b += 1
                if b <= skip:
                    continue  # replayed: already folded into the params
                if k == 1:
                    self._step(ds)
                    self._boundary(b, 1)
                else:
                    buf.append(ds)
                    if len(buf) == k:
                        self._block_step(buf)
                        buf = []
                        self._boundary(b, k)
            for i, ds in enumerate(buf):
                self._step(ds)
                self._boundary(b - len(buf) + i + 1, 1)
            self._fire("onEpochEnd")
            net._epoch += 1
        return net

    def _boundary(self, b, steps):
        """Checkpoint / injected-preemption hooks at a sync boundary that
        just advanced the iteration count by `steps`."""
        net = self.net
        if self.saveEvery > 0 and \
                net._iteration // self.saveEvery > \
                (net._iteration - steps) // self.saveEvery:
            self._save(b)
        if self.injector is not None:
            self.injector.maybe_kill(net._iteration)

    def _has_next(self, data) -> bool:
        """hasNext with next()'s backoff. If an error was retried and the
        iterator then reports exhausted, the end of the epoch is the
        iterator dying: re-raise the original error."""
        errs = []

        def probe():
            try:
                return data.hasNext()
            except self.retryPolicy.retryOn as e:
                errs.append(e)
                raise

        more = retry(probe, self.retryPolicy)
        if not more and errs:
            raise errs[-1]
        return more

    def _args(self, tensors, iteration):
        net = self.net
        if self.injector is not None:
            tensors = [self.injector.maybe_poison(iteration, tensors[0])] \
                + list(tensors[1:])
        if self.wrapper is not None:
            return self.wrapper._args(*tensors)   # this rank's rows
        return net._batch_args(tensors)

    def _step(self, ds):
        from deeplearning4j_tpu_torch.nn.multilayer import _tm as _train_tm
        from deeplearning4j_tpu_torch.nn.multilayer import _unwrap

        net = self.net
        tensors = [_unwrap(a, net.device) for a in net._batch_arrays(ds)]
        tm = _train_tm()
        t0 = time.perf_counter()
        loss, ok = self._guard.step(self._args(tensors, net._iteration),
                                    net._iteration)
        ok = bool(ok)   # the guarded step's host sync
        dt = time.perf_counter() - t0
        tm["step_s"].observe(dt)
        tm["reg"].add_span("train.step", "train", t0, dt,
                           iteration=net._iteration, ok=ok)
        self._account_step(float(loss), ok)

    def _account_step(self, loss, ok):
        """Per-step guard accounting, shared by the k=1 path and the
        block replay: score/iteration advance, skip events, the
        consecutive-bad abort."""
        from deeplearning4j_tpu_torch.nn.multilayer import _tm as _train_tm

        net = self.net
        net._score = float(loss)
        net._iteration += 1
        _train_tm()["steps"].inc()
        if ok:
            self._bad = 0
        else:
            self._bad += 1
            self.skippedSteps += 1
            self._fire("onStepSkipped", net._iteration, net._epoch,
                       net._score)
        for lst in net._listeners:
            lst.iterationDone(net, net._iteration, net._epoch)
        if not ok and self._bad >= self.maxBad:
            raise NonFiniteStepError(
                f"{self._bad} consecutive non-finite steps (last loss "
                f"{net._score}) at iteration {net._iteration} — aborting "
                f"instead of skipping forever; lower the learning rate "
                f"or enable gradient clipping")

    def _block_step(self, batches):
        """One stepsPerSync block: stage k batches, run the k guarded
        steps with the consecutive-bad count on the device (a step where
        it has reached the abort threshold does not train, as k=1 would
        have raised before it), then read the k (loss, ok) pairs in one
        host sync and replay the accounting step by step."""
        from deeplearning4j_tpu_torch.nn.multilayer import (
            launch_block, wait_block,
        )

        net = self.net
        start = net._iteration
        staged, ready = self._stager(net, batches)
        bad = torch.full((), self._bad, dtype=torch.int32, device=net.device)
        carry = {"bad": bad}

        def step(tensors, it):
            bad = carry["bad"]
            alive = bad < self.maxBad
            loss, ok = self._guard.step(self._args(tensors, it), it, alive)
            carry["bad"] = torch.where(
                alive, torch.where(ok, torch.zeros_like(bad), bad + 1), bad)
            return torch.stack([loss.reshape(()), ok.to(loss.dtype)])

        host, event = launch_block(net, staged, ready, start, step)
        wait_block(event)   # the block's one host sync
        vals = host.numpy()
        for loss, ok in vals:
            # raises at the step k=1 would; the frozen steps after it
            # did not train, so the params match k=1's
            self._account_step(loss, bool(ok))
        self._fire("onSyncBoundary", net._iteration, vals[:, 0])
