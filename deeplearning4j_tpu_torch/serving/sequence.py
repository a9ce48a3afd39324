"""Iteration-level slot scheduling for stateful models.

The counterpart of ``deeplearning4j_tpu/serving/sequence.py``. Both
schedulers keep a slot table of live sequences, refill free slots from a
bounded FIFO at every iteration boundary and step every live slot once
per iteration, padded to a slot bucket (``DEFAULT_SLOT_BUCKETS``). What
they share (the FIFO and its ``QueueFullError``, per-step deadlines,
``poll``/``drain`` under an injectable clock, the background loop,
``stats``/``occupancy`` and ``close``) lives in ``_SlotScheduler``.

``SequenceScheduler`` serves a recurrent ``MultiLayerNetwork`` (LSTM,
GravesLSTM, SimpleRnn, GRU): per-step feature rows in, per-step output
rows out. Each layer's carries live on the network's device as
``[max_slots + 2, H]`` tensors in the compute dtype, one row per slot, a
row that stays zero and a scratch row. Every iteration copies the step's
input rows and its read and write slot indices over in one staging copy
each, gathers the rows' carries by read index (the zero row pads the
bucket), runs ONE ``MultiLayerNetwork.rnnStepBatched``, scatters all S
new carries back by write index on the device (the pad rows into the
scratch row) and copies the ``[S, O]`` output to the host once, for the
results and the feedback. ``admission="step"`` refills
free slots every iteration; ``"gang"`` admits only into an empty table,
the run-to-completion baseline. A request may ask for ``extra_steps``
past its prompt; each then consumes ``feedback(last_output_row)``
(``greedy_onehot_feedback`` for a char-RNN).

The serving contract. The reference claims per-slot outputs bitwise
equal to serial batch-1 ``rnnTimeStep``; that does not hold, not even in
the reference: its own test fails by 1.49e-8 (8.2e-8 relative) on 2 of
25 elements, because a product's rounding depends on how many rows it
has, and cuBLAS, like XLA, picks its algorithm by the row count. What
the port holds:

* per-slot output within rtol 1e-6 / atol 1e-7 of serial batch-1
  ``rnnTimeStep`` in f32, within 1 bf16 ulp in bf16;
* bitwise where it is structural: the same submissions at the same
  buckets give bitwise-equal results run after run, and ``"step"`` and
  ``"gang"`` admission give the same per-request outputs within the
  tolerance above;
* exact counts: Σ live slots over all dispatches = Σ steps served, and
  gang needs at least 2x the dispatches of step on a straggler-skewed
  mix.

The stepping path pads its rows to a multiple of 8
(``multilayer.STEP_ROWS``), so buckets up to 8 and a batch-1
``rnnTimeStep`` run the same product shapes.

``PagedSequenceScheduler`` serves a paged-attention LM: its per-slot
state is KV in a bounded ``PagedKVCache``. Every iteration it also runs
at most ONE page-sized prefill chunk (a long prompt never stalls the
running batch), adopting registered prompt prefixes copy-on-write. The
decode's token ids, sequence lengths and block tables are staged in one
per-bucket host buffer (pinned on the card) and copied over once; the
logits come back with one device-to-host copy, which also orders the
next step's staging writes after this step's copy. Sampling is
host-side per request with a ``stream_rng(sampler_seed, stream_id)``
stream, stream ids in submit order, so generation is deterministic per
(seed, stream) and bitwise the serial dense trajectory within one
bucket.

Captured steps: ``warm()`` captures
each slot bucket's device step as a CUDA graph (``runtime.aot``) over
the bucket's fixed device staging twins: the paged scheduler's
``decode_paged`` over its staging buffer and KV pools, with K4's
workspace allocated inside the capture from the graph's pool; the
carry-slot scheduler's gather, ``rnnStepBatched`` and scatter. An
iteration then copies its staging over, replays the bucket's graph and
copies the static output back once. A step at a bucket with no graph
runs eagerly and is counted (``dl4j_capture_uncaptured_total``). The KV
pools are allocated once, never rebound while graphs hold them; a
version swap builds a new scheduler, whose ``warm()`` captures (and
counts) its own graphs, and the old one drops its graphs at close. On
the CPU the step runs eagerly, as before.

``warm()`` runs one step per slot bucket (the paged one builds its
kernels first and runs a prefill chunk), so the first request never
waits. With ``start_thread=False`` and a ``queue.ManualClock``,
``poll()``/``drain()`` drive a scheduler deterministically.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.chaos import fault_point, register_seam
from deeplearning4j_tpu_torch.serving.kvcache import (
    KVCacheFullError, PagedKVCache,
)
from deeplearning4j_tpu_torch.serving.queue import (
    DeadlineExceededError, QueueFullError, ServingClosedError,
    occupancy_summary_from,
)
from deeplearning4j_tpu_torch.serving.sampling import (
    greedy_sampler, stream_rng,
)

__all__ = ["SequenceRequest", "SequenceScheduler", "GenerationRequest",
           "PagedSequenceScheduler", "greedy_onehot_feedback",
           "DEFAULT_SLOT_BUCKETS"]

#: unique default metric label for anonymous schedulers
_SCHED_SEQ = itertools.count(1)

#: default slot-count buckets: one padded step shape per bucket
DEFAULT_SLOT_BUCKETS = (1, 2, 4, 8)

#: the stats keys the dict view carries
_STAT_KEYS = ("sequences", "completed", "dispatches", "slot_steps",
              "expired", "rejected", "errors", "refills")

#: chunked-prefill chaos seam: fires before each prompt chunk dispatch
PREFILL_SEAM = register_seam("sequence.prefill")

#: the registry families the scheduler records into (and releases its
#: series from at close())
_SEQ_METRIC_FAMILIES = (
    "dl4j_seq_sequences_total", "dl4j_seq_completed_total",
    "dl4j_seq_dispatches_total", "dl4j_seq_slot_steps_total",
    "dl4j_seq_expired_total", "dl4j_seq_rejected_total",
    "dl4j_seq_errors_total", "dl4j_seq_refills_total",
    "dl4j_seq_queue_depth", "dl4j_seq_active_slots",
    "dl4j_seq_queue_wait_seconds", "dl4j_seq_slot_occupancy",
    "dl4j_seq_ttft_seconds",
)


def _seq_metrics(reg, name):
    """The dl4j_seq_* instrument set, labelled for one scheduler."""
    lab = {"model": name}

    def counter(metric, help):
        return reg.counter(metric, help, labels=("model",)).labels(**lab)

    def gauge(metric, help):
        return reg.gauge(metric, help, labels=("model",)).labels(**lab)

    return {
        "sequences": counter("dl4j_seq_sequences_total",
                             "sequences accepted into the sequence queue"),
        "completed": counter("dl4j_seq_completed_total",
                             "sequences completed (all steps served)"),
        "dispatches": counter("dl4j_seq_dispatches_total",
                              "slot-batched decode-step dispatches"),
        "slot_steps": counter(
            "dl4j_seq_slot_steps_total",
            "live slot-steps served (occupancy x dispatches)"),
        "expired": counter(
            "dl4j_seq_expired_total",
            "sequences failed by a per-step deadline expiry (504)"),
        "rejected": counter("dl4j_seq_rejected_total",
                            "sequences rejected on a full queue (429)"),
        "errors": counter("dl4j_seq_errors_total",
                          "sequences failed by a dispatch error"),
        "refills": counter(
            "dl4j_seq_refills_total",
            "mid-sequence slot refills (admissions while other slots "
            "were mid-flight)"),
        "depth": gauge("dl4j_seq_queue_depth",
                       "sequences waiting for a slot"),
        "active": gauge("dl4j_seq_active_slots",
                        "slots occupied by live sequences"),
        "wait": reg.histogram(
            "dl4j_seq_queue_wait_seconds",
            "enqueue-to-first-step wait per sequence",
            labels=("model",)).labels(**lab),
        "occupancy": reg.histogram(
            "dl4j_seq_slot_occupancy",
            "live-slots/bucket fill fraction per decode step",
            labels=("model",),
            buckets=(0.25, 0.5, 0.75, 1.0)).labels(**lab),
        "ttft": reg.histogram(
            "dl4j_seq_ttft_seconds",
            "enqueue to first output (row or sampled token), per "
            "sequence",
            labels=("model",)).labels(**lab),
    }


def greedy_onehot_feedback(vocab):
    """The feedback of a one-hot token model: argmax the output row and
    feed the matching one-hot row back as the next input (greedy
    char-RNN sampling; deterministic)."""
    eye = np.eye(int(vocab), dtype=np.float32)

    def feedback(out_row):
        return eye[int(np.argmax(out_row))]

    return feedback


class _SlotScheduler:
    """What both slot schedulers share: the bounded FIFO, the slot table
    and its per-step deadlines, the ways to run it (``poll``, ``drain``, the
    background loop), the counters and ``close``. A subclass builds its
    state, then calls ``_start``; it implements ``_iterate_locked`` (one
    iteration, under the step lock) and ``_warm`` (one step per bucket),
    and may release a request's resources in ``_release_req`` and its
    own in ``_teardown``."""

    #: what a mid-flight expiry or close interrupted
    _MID = "mid-sequence"

    def __init__(self, model, slot_buckets, queue_limit, clock, name):
        if int(queue_limit) < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.model = model
        buckets = slot_buckets or DEFAULT_SLOT_BUCKETS
        self.slot_buckets = tuple(sorted(int(b) for b in buckets))
        if self.slot_buckets[0] < 1:
            raise ValueError(f"slot buckets must be >= 1, got {buckets}")
        self.max_slots = self.slot_buckets[-1]
        self.queue_limit = int(queue_limit)
        self.clock = clock if clock is not None else time.monotonic
        self.name = str(name) if name else f"seq{next(_SCHED_SEQ)}"
        self.device = model.device
        self._cond = threading.Condition()
        # one iteration at a time: the background loop and a draining
        # close() must never both step the same slot table
        self._step_lock = threading.Lock()
        self._pending = deque()
        self._active = []                   # the slot table
        self._staging = {}                  # S -> reused staging buffers
        #: host bytes served from the staging pool instead of fresh
        #: buffers (the alloc-reduction record)
        self.staging_reuse_bytes = 0
        self._closed = False
        #: (live_slots, bucket) per step dispatch
        self.occupancy = []
        self._registry = telemetry.get_registry()
        self._m = _seq_metrics(self._registry, self.name)
        self._thread = None
        self._warm_asks = []                # warm() calls for the thread
        from deeplearning4j_tpu_torch.runtime import aot

        #: the device step's CapturedStep (module docstring); the model
        #: owns it, so a rebind of the model's tensors drops its graphs.
        #: None steps eagerly, uncounted (an eager baseline's)
        self._step_capture = aot.CapturedStep(
            self._device_step, owner=model,
            entry=f"{type(self).__name__}.step",
            fingerprint=f"{type(model).__name__}:{id(model)}")

    def _run_step(self, *staged):
        """The device step over staged inputs: a replay of the bucket's
        graph once ``warm()`` captured it, else eagerly, counted as
        uncaptured."""
        if self._step_capture is None:
            return self._device_step(*staged)
        return self._step_capture(*staged)

    def _capture_bucket(self, *staged):
        if self._step_capture is not None \
                and not self._step_capture.captured(staged):
            self._step_capture.capture(staged)

    def _start(self, start_thread):
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _enqueue(self, make_req):
        """Queue the request `make_req()` builds (called under the lock,
        once the closed and queue-full checks pass)."""
        with self._cond:
            if self._closed:
                raise ServingClosedError("sequence scheduler is closed")
            if len(self._pending) >= self.queue_limit:
                self._m["rejected"].inc()
                raise QueueFullError(
                    f"sequence queue full ({len(self._pending)} waiting, "
                    f"queueLimit={self.queue_limit})")
            req = make_req()
            self._pending.append(req)
            self._m["sequences"].inc()
            self._m["depth"].set(len(self._pending))
            self._cond.notify()
        return req

    # -- the slot table (lock held) -------------------------------------
    def _release_req(self, req):
        """Free what a request holds when it leaves the table."""

    def _drop_locked(self, reqs):
        """Take `reqs` out of the table, releasing what they hold."""
        for req in reqs:
            self._release_req(req)
        gone = set(map(id, reqs))
        self._active = [r for r in self._active if id(r) not in gone]
        self._m["active"].set(len(self._active))

    def _expire_locked(self, now):
        """Fail every sequence, queued or mid-flight, whose deadline has
        passed; a mid-flight expiry frees its slot this iteration."""
        keep = deque()
        for req in self._pending:
            if req.deadline is not None and now >= req.deadline:
                self._m["expired"].inc()
                req.fail(DeadlineExceededError(
                    f"deadline passed {now - req.deadline:.3f}s before "
                    "a slot was granted"))
            else:
                keep.append(req)
        self._pending = keep
        late = [r for r in self._active
                if r.deadline is not None and now >= r.deadline]
        for req in late:
            self._m["expired"].inc()
            req.fail(DeadlineExceededError(
                f"deadline passed at {req.progress()} — slot released "
                f"{self._MID}"))
        self._drop_locked(late)
        self._m["depth"].set(len(self._pending))

    def bucket_for(self, n):
        """Smallest slot bucket >= n live slots."""
        for b in self.slot_buckets:
            if n <= b:
                return b
        return self.slot_buckets[-1]

    def _fail_batch(self, batch, exc):
        """A step failed: fail every request it carried."""
        with self._cond:
            self._m["errors"].inc(len(batch))
            for req in batch:
                req.fail(exc)
            self._drop_locked(batch)

    # -- running the iterations ---------------------------------------
    def _step_once(self):
        with self._step_lock:
            return self._iterate_locked()

    def poll(self):
        """One synchronous scheduler iteration (the thread-less test
        seam). Returns the progress count — 0 means idle."""
        return self._step_once()

    def drain(self):
        """Run iterations until the table AND queue are empty (deadlines
        still expire per step on the clock)."""
        while self._step_once():
            pass
        return self

    def warm(self):
        """Run one step per slot bucket (``_warm``) so the first request
        is served hot, and return its report. A threaded scheduler warms
        on its own thread: the first steps a thread runs on the card
        carry a one-time set-up, which would otherwise land on the first
        requests' time to first output."""
        if self._thread is None or self._thread is threading.current_thread():
            return self._warm()
        ask = {"done": threading.Event()}
        with self._cond:
            if self._closed:            # the loop may have returned
                ask = None
            else:
                self._warm_asks.append(ask)
                self._cond.notify()
        if ask is None:
            return self._warm()
        # bounded: a loop thread that died never answers
        while not ask["done"].wait(0.5):
            if not self._thread.is_alive():
                raise RuntimeError(
                    "the scheduler thread ended before it warmed the "
                    "slot buckets")
        if "error" in ask:
            raise ask["error"]
        return ask["report"]

    def _answer_warm_asks(self, asks):
        for ask in asks:
            try:
                ask["report"] = self._warm()
            except Exception as e:
                ask["error"] = e
            finally:
                ask["done"].set()

    def _loop(self):  # fault-ok[FLT02]: each step runs a subclass's _iterate_locked, which fires sequence.step, sequence.prefill and kv.page_alloc (reachability does not follow overrides)
        while True:
            with self._cond:
                asks, self._warm_asks = self._warm_asks, []
                if not asks:
                    if self._closed and not self._pending \
                            and not self._active:
                        return
                    if not self._pending and not self._active:
                        self._cond.wait(0.05)
                        continue
            if asks:
                self._answer_warm_asks(asks)
                continue
            try:
                self._step_once()
            except Exception as e:
                # a scheduler bug must release every waiter, never
                # leave them blocked on a dead thread
                self._fail_all(e)

    def _fail_all(self, exc):
        with self._cond:
            n = len(self._pending) + len(self._active)
            if n:
                self._m["errors"].inc(n)
            while self._pending:
                self._pending.popleft().fail(exc)
            for req in self._active:
                req.fail(exc)
            self._drop_locked(list(self._active))
            self._m["depth"].set(0)

    # -- introspection / lifecycle --------------------------------------
    @property
    def depth(self):
        """Sequences waiting for a slot."""
        with self._cond:
            return len(self._pending)

    @property
    def active_slots(self):
        with self._cond:
            return len(self._active)

    @property
    def stats(self):
        """Dict view over the registry counters (dl4j_seq_*)."""
        return {k: int(self._m[k].value) for k in _STAT_KEYS}

    def occupancy_summary(self):
        """Mean live slots per bucket and its quartile histogram over
        every step so far."""
        return occupancy_summary_from(self.occupancy, "mean_live_slots")

    def _teardown(self):
        """Release the scheduler's own resources at close (its graphs
        first)."""
        if self._step_capture is not None:
            self._step_capture.invalidate()

    def close(self, drain=True):
        """Stop accepting. drain=True serves everything queued or
        mid-flight to completion; drain=False fails them with
        ServingClosedError."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._pending:
                    self._pending.popleft().fail(
                        ServingClosedError("scheduler closed before "
                                           "a slot was granted"))
                for req in self._active:
                    req.fail(ServingClosedError(
                        f"scheduler closed {self._MID}"))
                self._drop_locked(list(self._active))
                self._m["depth"].set(0)
            self._cond.notify_all()
        if drain:
            self.drain()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._teardown()
        reg = self._registry
        for metric in _SEQ_METRIC_FAMILIES:
            fam = reg.get(metric)
            if fam is not None:
                fam.remove(model=self.name)
        return self


class _Request:
    """A queued request's outcome: ``finish``/``fail`` release ``wait``,
    which returns the result, raises the request's error, or raises
    DeadlineExceededError when `timeout` passes first."""

    __slots__ = ("enqueued_at", "deadline", "started_at", "result",
                 "error", "_event")

    def __init__(self, enqueued_at, deadline):
        self.enqueued_at = float(enqueued_at)
        self.deadline = None if deadline is None else float(deadline)
        self.started_at = None              # admission time
        self.result = None
        self.error = None
        self._event = threading.Event()

    @property
    def done(self):
        return self._event.is_set()

    def finish(self, result):
        self.result = result
        self._event.set()

    def fail(self, exc):
        self.error = exc
        self._event.set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeadlineExceededError(f"no result within {timeout:.3f}s")
        if self.error is not None:
            raise self.error
        return self.result


class SequenceRequest(_Request):
    """One sequence: prompt features [T, F] consumed one timestep per
    iteration, then ``extra_steps`` generation steps, each consuming
    ``feedback(last output row)``. The result is the stacked per-step
    output [T + extra_steps, O] (float32; a bf16 model's values widened
    exactly)."""

    __slots__ = ("features", "steps", "extra_steps", "feedback",
                 "steps_done", "outputs", "slot")

    def __init__(self, features, enqueued_at, deadline=None,
                 extra_steps=0, feedback=None):
        super().__init__(enqueued_at, deadline)
        self.features = features            # [T, F] float32
        self.steps = int(features.shape[0]) + int(extra_steps)
        self.extra_steps = int(extra_steps)
        self.feedback = feedback
        self.steps_done = 0
        self.outputs = []                   # per-step [O] rows
        self.slot = None                    # carry row while admitted

    def progress(self):
        return f"step {self.steps_done}/{self.steps}"

    def next_input(self):
        """The feature row this sequence consumes at its next step."""
        t = self.steps_done
        if t < self.features.shape[0]:
            return self.features[t]
        if self.feedback is None:
            raise RuntimeError(
                "generation step with no feedback fn (extra_steps > 0 "
                "needs a request- or scheduler-level feedback)")
        return self.feedback(self.outputs[-1])


class SequenceScheduler(_SlotScheduler):
    """Iteration-level carry-slot scheduler over one recurrent
    ``MultiLayerNetwork`` (module docstring).

    model:        an initialized network with at least one recurrent
                  layer (validated eagerly by ``rnnCarrySpec``).
    slot_buckets: the step's padded slot counts; the largest is the
                  table's capacity.
    queue_limit:  bound on WAITING sequences (QueueFullError past it).
    admission:    "step" (refill free slots every iteration) or "gang"
                  (refill only an empty table, the run-to-completion
                  baseline).
    feedback:     scheduler-level generation feedback, out_row [O] ->
                  next input row [F]; a request's own overrides it.
    clock/start_thread/name: inject a ManualClock and drive ``poll()``/
                  ``drain()`` with no thread for deterministic tests.
    """

    def __init__(self, model, *, slot_buckets=None, queue_limit=64,
                 admission="step", feedback=None, clock=None,
                 start_thread=True, name=None):
        if admission not in ("step", "gang"):
            raise ValueError(
                f"admission must be 'step' (iteration-level) or 'gang' "
                f"(run-to-completion baseline), got {admission!r}")
        spec = model.rnnCarrySpec()          # validates the net, eagerly
        super().__init__(model, slot_buckets, queue_limit, clock, name)
        self._spec = spec
        self.admission = admission
        self.feedback = feedback
        self.feature_size = int(model.conf.inputType.size)
        #: the carries' dtype: the model's compute dtype
        self._carry_dtype = model._compute_dtype
        # per layer and key, one row per slot, the zero pad row and the
        # scratch row the pad rows' new carries go to
        self._carries = [
            {k: torch.zeros((self.max_slots + 2, int(layer.nOut)),
                            dtype=self._carry_dtype, device=self.device)
             for k in keys}
            for keys, layer in zip(spec, model.layers)]
        self._free = list(range(self.max_slots))
        self._start(start_thread)

    def submit(self, features, deadline=None, extra_steps=0,
               feedback=None, wait=True, timeout=None):
        """Enqueue one sequence of per-step features [T, F] (T >= 1).

        deadline: absolute time on this scheduler's clock, checked at
        every step boundary, queued or mid-flight. extra_steps: closed-
        loop generation steps past the prompt (needs a feedback fn).
        wait=True blocks for the stacked [T + extra_steps, O] result;
        False returns the SequenceRequest."""
        features = np.asarray(features, np.float32)
        if features.ndim != 2 or features.shape[0] < 1:
            raise ValueError(
                f"features must be [steps, {self.feature_size}] with "
                f"steps >= 1, got shape {features.shape}")
        if features.shape[1] != self.feature_size:
            raise ValueError(
                f"per-step feature width {features.shape[1]} does not "
                f"match the model's {self.feature_size}")
        fb = feedback if feedback is not None else self.feedback
        if int(extra_steps) > 0 and fb is None:
            raise ValueError(
                "extra_steps > 0 needs a feedback fn (request- or "
                "scheduler-level) to close the generation loop")
        req = self._enqueue(lambda: SequenceRequest(
            features, self.clock(), deadline, extra_steps=extra_steps,
            feedback=fb))
        return req.wait(timeout) if wait else req

    # -- the slot table (lock held) -------------------------------------
    def _release_req(self, req):
        if req.slot is not None:
            self._free.append(req.slot)
            req.slot = None

    def _refill_locked(self, now):
        """Admit queued sequences into free slots, each slot's carry rows
        zeroed: every iteration under "step", only into an empty table
        under "gang"."""
        if self.admission == "gang" and self._active:
            return
        midrun = any(r.steps_done > 0 for r in self._active)
        while self._pending and len(self._active) < self.max_slots:
            req = self._pending.popleft()
            req.started_at = now
            self._free.sort()
            req.slot = self._free.pop(0)
            for d in self._carries:
                for c in d.values():
                    c[req.slot].zero_()
            self._active.append(req)
            self._m["wait"].observe(now - req.enqueued_at)
            if midrun:
                self._m["refills"].inc()
        self._m["depth"].set(len(self._pending))
        self._m["active"].set(len(self._active))

    # -- one iteration ----------------------------------------------------
    def _staging_for(self, S):
        """Per-bucket staging, allocated once and reused: the input rows
        [S, F] and the read and write slot indices [2S] on the host
        (pinned on the card) and their device twins (the same tensors on
        the CPU)."""
        st = self._staging.get(S)
        if st is None:
            pin = self.device.type == "cuda"
            xh = torch.zeros((S, self.feature_size), dtype=torch.float32,
                             pin_memory=pin)
            ih = torch.zeros((2 * S,), dtype=torch.int64, pin_memory=pin)
            st = (xh, ih, xh.to(self.device), ih.to(self.device))
            self._staging[S] = st
        else:
            self.staging_reuse_bytes += st[0].numel() * 4 \
                + st[1].numel() * 8
        return st

    def _stage_slots(self, ih, slots):
        """Read indices: the live slots, then the zero row; write
        indices: the live slots, then the scratch row."""
        S = ih.shape[0] // 2
        pad = S - len(slots)
        ih.numpy()[:] = list(slots) + [self.max_slots] * pad \
            + list(slots) + [self.max_slots + 1] * pad

    def _device_step(self, xd, idx):
        """Gather, ONE ``rnnStepBatched``, scatter all S rows (what a
        captured bucket holds). Returns the output [S, O] as float32."""
        S = xd.shape[0]
        carries = [{k: c.index_select(0, idx[:S]) for k, c in d.items()}
                   for d in self._carries]
        out, new = self.model.rnnStepBatched(xd, carries)
        for d, nd in zip(self._carries, new):
            for k, c in d.items():
                c.index_copy_(0, idx[S:], nd[k])
        return out.float()

    def _step_on_device(self, staging, n):
        """Step a staged bucket: copy the rows and slot indices over,
        then the device step (``_run_step``). Returns the live rows'
        output [n, O] as host float32."""
        xh, ih, xd, idx = staging
        if xd is not xh:
            xd.copy_(xh, non_blocking=True)
            idx.copy_(ih, non_blocking=True)
        out = self._run_step(xd, idx)
        # the one device-to-host copy; it also orders the next step's
        # staging writes after this step's host-to-device copies
        return out.cpu().numpy()[:n]

    def _iterate_locked(self):
        """One iteration: expire -> refill -> gather -> ONE step ->
        scatter. Returns the live slots stepped (0 = idle)."""
        with self._cond:
            now = self.clock()
            self._expire_locked(now)
            self._refill_locked(now)
            batch = list(self._active)
        if not batch:
            return 0
        # next-input rows before the step: a raising or wrong-width
        # feedback fails ITS request and frees the slot, never the loop
        rows, bad = [], []
        for req in batch:
            try:
                row = np.asarray(req.next_input(),
                                 dtype=np.float32).reshape(-1)
                if row.shape[0] != self.feature_size:
                    raise ValueError(
                        f"feedback row has width {row.shape[0]}, "
                        f"model feature size is {self.feature_size}")
                rows.append(row)
            except Exception as e:
                bad.append((req, e))
        if bad:
            with self._cond:
                self._m["errors"].inc(len(bad))
                for req, e in bad:
                    req.fail(e)
                self._drop_locked([r for r, _ in bad])
            failed = {id(r) for r, _ in bad}
            batch = [r for r in batch if id(r) not in failed]
            if not batch:
                return len(bad)     # progress: drain must not stall
        n = len(batch)
        S = self.bucket_for(n)
        xh, ih, _, _ = self._staging_for(S)
        x = xh.numpy()
        x[:n] = np.stack(rows)
        x[n:] = 0.0
        self._stage_slots(ih, [r.slot for r in batch])
        t0 = self.clock()
        self._m["dispatches"].inc()
        self._m["slot_steps"].inc(n)
        self._m["occupancy"].observe(n / S)
        self.occupancy.append((n, S))
        try:
            # the (possibly corrupted) payload goes back into the
            # staging the step reads: a captured step replays from it
            y = fault_point("sequence.step", x)
            if y is not x:
                x[...] = y
            out = self._step_on_device(self._staging[S], n)
        except Exception as e:
            self._fail_batch(batch, e)
            return 0
        finally:
            self._registry.add_span(
                "sequence.step", "serving", t0, self.clock() - t0,
                model=self.name, slots=n, bucket=S)
        now = self.clock()
        finished = []
        with self._cond:
            for i, req in enumerate(batch):
                if req.done:        # expired/failed between gather + now
                    continue
                req.outputs.append(out[i])
                req.steps_done += 1
                if req.steps_done == 1:
                    self._m["ttft"].observe(now - req.enqueued_at)
                if req.steps_done >= req.steps:
                    finished.append(req)
            if finished:
                self._drop_locked(finished)
                self._m["completed"].inc(len(finished))
        for req in finished:        # release waiters outside the lock
            req.finish(np.stack(req.outputs, axis=0))
        return n

    def _warm(self):
        """One step per slot bucket on the zero row. Returns {bucket:
        wall seconds}, each ending in the step's device-to-host copy."""
        report = {}
        with self._step_lock:
            for S in self.slot_buckets:
                t = time.perf_counter()
                st = self._staging_for(S)
                st[0].zero_()
                self._stage_slots(st[1], [])
                if st[2] is not st[0]:
                    st[2].copy_(st[0])
                    st[3].copy_(st[1])
                self._capture_bucket(st[2], st[3])
                self._step_on_device(st, 0)
                report[int(S)] = time.perf_counter() - t
        return report


class GenerationRequest(_Request):
    """One token-prompt generation request on the KV-slot path.

    The prompt is consumed in page-sized prefill chunks; generation then
    appends one token per decode iteration until ``max_new`` tokens have
    been sampled; the result is the sampled token ids [max_new] (int64).
    ``pages``/``block_row``/``seq_len`` are the slot's KV state (owned
    page ids, logical-block -> physical-page row, live KV rows)."""

    __slots__ = ("tokens", "max_new", "sampler", "rng", "stream_id",
                 "prefilled", "seq_len", "pages", "block_row",
                 "out_tokens", "logits_rows", "logits")

    def __init__(self, tokens, enqueued_at, deadline=None, max_new=1,
                 sampler=None, rng=None, stream_id=0):
        super().__init__(enqueued_at, deadline)
        self.tokens = tokens                # [T] int32 prompt
        self.max_new = int(max_new)
        self.sampler = sampler
        self.rng = rng
        self.stream_id = int(stream_id)
        self.prefilled = 0                  # prompt tokens with KV live
        self.seq_len = 0                    # total KV rows live
        self.pages = []                     # owned page ids (in order)
        self.block_row = None               # [MP] int32
        self.out_tokens = []                # sampled tokens, in order
        self.logits_rows = []               # fp32 [V] per sampled token
        self.logits = None                  # stacked at finish

    def progress(self):
        return f"{len(self.out_tokens)}/{self.max_new} tokens"

    def finish(self, result):
        self.logits = (np.stack(self.logits_rows, axis=0)
                       if self.logits_rows else None)
        super().finish(result)


class PagedSequenceScheduler(_SlotScheduler):
    """Iteration-level KV-slot scheduler over one paged-attention LM
    (``nn.transformer.CausalTransformerLM`` or any ``kind ==
    "paged_lm"`` model with the same step functions); see the module
    docstring. Pool exhaustion surfaces as the typed
    ``KVCacheFullError`` (429), never a hang."""

    _MID = "mid-generation"

    def __init__(self, model, *, num_pages, slot_buckets=None,
                 queue_limit=64, sampler=None, sampler_seed=0,
                 prefix_sharing=True, clock=None, start_thread=True,
                 name=None):
        if getattr(model, "kind", None) != "paged_lm":
            raise ValueError(
                "PagedSequenceScheduler needs a paged LM "
                f"(kind == 'paged_lm'), got {type(model).__name__}")
        super().__init__(model, slot_buckets, queue_limit, clock, name)
        self.vocab = int(model.vocab)
        self.sampler = sampler if sampler is not None else greedy_sampler()
        self.sampler_seed = int(sampler_seed)
        self.prefix_sharing = bool(prefix_sharing)
        self.cache = PagedKVCache(
            n_layers=model.n_layers, n_heads=model.n_heads,
            head_dim=model.head_dim, page_size=model.page_size,
            num_pages=num_pages, dtype=model._compute_dtype,
            model=self.name, device=self.device)
        self._mp = int(model.max_pages_per_slot)
        self._stream_ids = itertools.count(0)
        #: prompt chunks prefilled (the interleave record)
        self.prefill_chunks = 0
        self._start(start_thread)

    # -- submit ---------------------------------------------------------
    def submit(self, tokens, deadline=None, max_new_tokens=1,
               sampler=None, wait=True, timeout=None):
        """Enqueue one token prompt [T] (T >= 1, ids in [0, vocab)).

        max_new_tokens >= 1 tokens are generated (the first is sampled
        from the prompt's final logits, so KV grows by T + max_new - 1
        rows, bounded by the model's max_context). deadline: absolute
        time on this scheduler's clock, checked per step. wait=True
        blocks for the sampled token ids; False returns the
        GenerationRequest. A prompt that could NEVER fit the pool is
        rejected up front with KVCacheFullError (429)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        if tokens.shape[0] < 1:
            raise ValueError("prompt must have >= 1 token")
        if np.any(tokens < 0) or np.any(tokens >= self.vocab):
            raise ValueError(
                f"prompt token ids must be in [0, {self.vocab})")
        tokens = tokens.astype(np.int32)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = tokens.shape[0] + max_new - 1
        if total > self.model.max_context:
            raise ValueError(
                f"prompt + generation needs {total} KV rows, model "
                f"max_context is {self.model.max_context}")
        if self.cache.pages_for(total) > self.cache.capacity:
            raise KVCacheFullError(
                f"sequence needs {self.cache.pages_for(total)} pages, "
                f"pool capacity is {self.cache.capacity} — unservable "
                f"at any load")

        def make_req():
            sid = next(self._stream_ids)    # stream ids in submit order
            return GenerationRequest(
                tokens, self.clock(), deadline, max_new=max_new,
                sampler=sampler if sampler is not None else self.sampler,
                rng=stream_rng(self.sampler_seed, sid), stream_id=sid)

        req = self._enqueue(make_req)
        return req.wait(timeout) if wait else req

    # -- scheduling core ------------------------------------------------
    def _release_req(self, req):
        """Return a request's pages to the pool (slot teardown)."""
        if req.pages:
            self.cache.release(req.pages)
            req.pages = []

    def _refill_locked(self, now):
        """Admit queued prompts into free KV slots, adopting registered
        prefixes copy-on-write. An exact-prompt adoption completes the
        prompt outright; those come back for the caller to sample
        OUTSIDE this lock."""
        adopted_done = []
        midrun = any(r.seq_len > 0 for r in self._active)
        while self._pending and len(self._active) < self.max_slots:
            req = self._pending.popleft()
            req.started_at = now
            req.block_row = np.zeros((self._mp,), np.int32)
            logits = None
            if self.prefix_sharing:
                pages, n_shared, logits = self.cache.match_prefix(
                    req.tokens)
                if pages:
                    req.pages = list(pages)
                    req.block_row[:len(pages)] = pages
                    req.prefilled = req.seq_len = int(n_shared)
            self._active.append(req)
            self._m["wait"].observe(now - req.enqueued_at)
            if midrun:
                self._m["refills"].inc()
            if logits is not None:
                adopted_done.append((req, logits))
        self._m["depth"].set(len(self._pending))
        self._m["active"].set(len(self._active))
        return adopted_done

    def _fail_req(self, req, exc):
        """Fail one mid-flight request and free its slot + pages."""
        self._fail_batch([req], exc)

    def _complete_prompt(self, req, last_logits):
        """The prompt is fully in KV: sample the first generated token
        from its final-position logits. Returns True if that already
        finishes the request (max_new == 1)."""
        row = np.asarray(last_logits, np.float32)
        req.logits_rows.append(row)
        req.out_tokens.append(int(req.sampler(row, req.rng)))
        self._m["ttft"].observe(self.clock() - req.enqueued_at)
        if len(req.out_tokens) >= req.max_new:
            self._finish_req(req)
            return True
        return False

    def _finish_req(self, req):
        with self._cond:
            self._drop_locked([req])
            self._m["completed"].inc()
        req.finish(np.asarray(req.out_tokens, np.int64))

    def _prefill_one(self, req):
        """Dispatch ONE page-sized prompt chunk for one slot: allocate
        the chunk's page, append its K/V, attend causally over the table
        so far. Completing the prompt registers it for prefix sharing
        and samples the first token. A pool-exhausted or injected
        failure fails THIS request only (typed, 429 at the HTTP tier)."""
        page = self.model.page_size
        T = int(req.tokens.shape[0])
        t0 = req.prefilled
        n_valid = min(page, T - t0)
        t0c = self.clock()
        try:
            pg = self.cache.alloc(1)[0]
            req.pages.append(pg)
            req.block_row[t0 // page] = pg
            chunk = np.zeros((page,), np.int32)
            chunk[:n_valid] = req.tokens[t0:t0 + n_valid]
            # inside the failure try: an injected raise fails this
            # prefill like an organic dispatch error
            chunk = fault_point("sequence.prefill", chunk)
            # chunk and block row go over in ONE host-to-device copy
            staged = torch.from_numpy(
                np.concatenate([chunk, req.block_row])).to(self.device)
            logits, _, _ = self.model.prefill_paged(
                staged[:page], t0, n_valid, self.cache.k_pools,
                self.cache.v_pools, staged[page:])
            last = (logits.cpu().numpy() if t0 + n_valid >= T else None)
        except Exception as e:
            self._fail_req(req, e)
            return True                     # progress: the slot freed
        finally:
            self._registry.add_span(
                "sequence.prefill", "serving", t0c,
                self.clock() - t0c, model=self.name, chunk=n_valid)
        req.prefilled += n_valid
        req.seq_len = req.prefilled
        self.prefill_chunks += 1
        if last is not None:
            if self.prefix_sharing:
                self.cache.register_prefix(req.tokens, req.pages, last)
            self._complete_prompt(req, last)
        return True

    def _staging_for(self, S):
        """Per-bucket decode staging, allocated once and reused every
        iteration: one host buffer (pinned on the card) holding tokens,
        seq lens and block tables as numpy views, and its device twin.
        Returns (tok, sls, bts, host, dev)."""
        st = self._staging.get(S)
        if st is None:
            n = S * (2 + self._mp)
            host = torch.zeros((n,), dtype=torch.int32,
                               pin_memory=self.device.type == "cuda")
            arr = host.numpy()
            st = (arr[:S], arr[S:2 * S], arr[2 * S:].reshape(S, self._mp),
                  host, torch.empty((n,), dtype=torch.int32,
                                    device=self.device))
            self._staging[S] = st
        else:
            self.staging_reuse_bytes += st[3].numel() * 4
        return st

    def _device_step(self, dev):
        """``decode_paged`` over a bucket's device staging twin (what a
        captured bucket holds): the logits [S, V] fp32."""
        S = dev.shape[0] // (2 + self._mp)
        out, _, _ = self.model.decode_paged(
            dev[:S], self.cache.k_pools, self.cache.v_pools,
            dev[2 * S:].view(S, self._mp), dev[S:2 * S])
        return out

    def _decode_on_device(self, S, host, dev):
        """Copy the staging over once and step the model (a replay of
        the bucket's graph once captured); returns the logits [S, V] as
        host fp32 (one device-to-host copy)."""
        dev.copy_(host, non_blocking=True)
        return self._run_step(dev).cpu().numpy()

    def _decode_batch(self, batch):
        """One slot-batched decode step over every fully-prefilled slot:
        per-slot page prep (CoW fork / fresh page at a page boundary — a
        pool-exhausted slot fails alone), padded staging, ONE dispatch,
        scatter + sample."""
        ready = []
        for req in batch:
            try:
                idx = req.seq_len // self.model.page_size
                if req.seq_len % self.model.page_size == 0 \
                        and req.block_row[idx] == 0:
                    pg = self.cache.alloc(1)[0]
                    req.pages.append(pg)
                    req.block_row[idx] = pg
                else:
                    old = int(req.block_row[idx])
                    pg = self.cache.ensure_private(old)
                    if pg != old:
                        req.block_row[idx] = pg
                        req.pages = [pg if p == old else p
                                     for p in req.pages]
                ready.append(req)
            except Exception as e:
                self._fail_req(req, e)
        if not ready:
            return 0
        S = self.bucket_for(len(ready))
        tok, sls, bts, host, dev = self._staging_for(S)
        n = len(ready)
        for i, req in enumerate(ready):
            tok[i] = req.out_tokens[-1]
            sls[i] = req.seq_len
            bts[i] = req.block_row
        tok[n:] = 0
        sls[n:] = 0
        bts[n:] = 0
        t0c = self.clock()
        self._m["dispatches"].inc()
        self._m["slot_steps"].inc(n)
        self._m["occupancy"].observe(n / S)
        self.occupancy.append((n, S))
        try:
            y = fault_point("sequence.step", tok)
            if y is not tok:
                tok[...] = y
            out = self._decode_on_device(S, host, dev)
        except Exception as e:
            self._fail_batch(ready, e)
            return 0
        finally:
            self._registry.add_span(
                "sequence.step", "serving", t0c, self.clock() - t0c,
                model=self.name, slots=n, bucket=S)
        finished = []
        for i, req in enumerate(ready):
            if req.done:                # expired between gather + now
                continue
            req.seq_len += 1
            row = out[i]
            req.logits_rows.append(row)
            req.out_tokens.append(int(req.sampler(row, req.rng)))
            if len(req.out_tokens) >= req.max_new:
                finished.append(req)
        for req in finished:
            self._finish_req(req)
        return n

    def _iterate_locked(self):
        """One iteration: expire -> refill (prefix adoption) -> at most
        ONE prefill chunk -> one slot-batched decode step. Returns the
        progress count (0 = idle)."""
        with self._cond:
            now = self.clock()
            self._expire_locked(now)
            adopted = self._refill_locked(now)
        progress = 0
        for req, logits in adopted:       # exact-prefix admissions
            self._complete_prompt(req, logits)
            progress += 1
        with self._cond:
            batch = list(self._active)
        if not batch:
            return progress
        pre = next((r for r in batch
                    if not r.done and r.prefilled < r.tokens.shape[0]),
                   None)
        if pre is not None:
            self._prefill_one(pre)
            progress += 1
        decode = [r for r in batch
                  if not r.done and r.prefilled >= r.tokens.shape[0]]
        if decode:
            progress += self._decode_batch(decode)
        return progress

    def _warm(self):
        """Build the kernels (on the card) and run one decode per slot
        bucket plus one prefill chunk against the null page. Returns
        {"build": s, bucket: s,
        "prefill": s} wall seconds, each ending in a device sync."""
        from deeplearning4j_tpu_torch.ops import _kernels

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        report = {}
        with self._step_lock:
            t = time.perf_counter()
            if self.device.type == "cuda":
                _kernels.library()
            report["build"] = time.perf_counter() - t
            for S in self.slot_buckets:
                t = time.perf_counter()
                tok, sls, bts, host, dev = self._staging_for(S)
                tok[:] = 0
                sls[:] = 0
                bts[:] = 0
                dev.copy_(host)
                self._capture_bucket(dev)
                self._decode_on_device(S, host, dev)
                report[int(S)] = time.perf_counter() - t
            t = time.perf_counter()
            zeros = torch.zeros((self.model.page_size + self._mp,),
                                dtype=torch.int32, device=self.device)
            self.model.prefill_paged(
                zeros[:self.model.page_size], 0, 1, self.cache.k_pools,
                self.cache.v_pools, zeros[self.model.page_size:])
            sync()
            report["prefill"] = time.perf_counter() - t
        return report

    def _teardown(self):
        self.cache.close()
