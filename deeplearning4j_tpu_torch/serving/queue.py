"""Bounded request queue and dynamic micro-batcher for one-shot serving.

The counterpart of ``deeplearning4j_tpu/serving/queue.py``. Each
dispatch pays the same host cost (a Python forward issuing a few hundred
kernels, one host-to-device and one device-to-host copy) whether it
carries 1 row or 128, so a server facing many small concurrent requests
coalesces them into one padded batch and pays the dispatch once per
micro-batch:

* ``submit`` appends to a bounded FIFO; a queue at ``queue_limit``
  raises ``QueueFullError`` (HTTP 429), never a hang.
* the scheduler coalesces the FIFO prefix up to ``max_rows`` (the
  largest batch bucket). It dispatches at once when the prefix fills a
  full bucket, and otherwise holds the batch open at most ``max_wait``
  seconds from the OLDEST waiting request.
* per-request deadlines hold end to end: an expired request is failed
  with ``DeadlineExceededError`` instead of wasting bucket rows, and
  ``InferenceRequest.wait(timeout)`` bounds the caller side too.
* the clock is injectable (``ManualClock``) and the scheduler can be
  driven synchronously through ``poll()``, so latency-path tests run
  with no thread and no sleeps.

The batcher never pads and never touches a device: it hands the
host-concatenated numpy rows to ``dispatch``
(``ParallelInference._dispatch_coalesced``), which pads to the bucket,
copies the batch to the network's device once, runs the forward and
brings the result back once; the rows are sliced per request here, on
the host.

Also the serving tier's error types and the occupancy math the sequence
schedulers share.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.chaos import fault_point

__all__ = ["QueueFullError", "DeadlineExceededError", "ServingClosedError",
           "RequestCancelledError", "InferenceRequest", "MicroBatcher",
           "ManualClock", "occupancy_summary_from"]

#: unique default metric label for anonymous batchers
_BATCHER_SEQ = itertools.count(1)

#: the ``stats`` view's keys (and the per-model counters behind them)
_STAT_KEYS = ("requests", "rows", "dispatches", "dispatched_rows",
              "coalesced", "expired", "rejected", "errors")

class QueueFullError(RuntimeError):
    """Request queue at queue_limit — backpressure (HTTP 429)."""


class DeadlineExceededError(RuntimeError):
    """Per-request deadline expired before a result (HTTP 504)."""


class ServingClosedError(RuntimeError):
    """Submitted to a closed/draining batcher or scheduler (HTTP
    503)."""


class RequestCancelledError(RuntimeError):
    """The submitter cancelled a still-pending request (the losing leg
    of a hedged dispatch, serving/fleet.py); the scheduler drops it
    before it wastes bucket rows."""


class ManualClock:
    """Deterministic monotonic clock: latency-path tests advance time
    explicitly instead of sleeping. Pair with a thread-less scheduler
    (``start_thread=False``) driven via ``poll()``."""

    def __init__(self, start=0.0):
        self.now = float(start)

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += float(seconds)
        return self.now


class InferenceRequest:
    """One enqueued request: features [rows, ...], bookkeeping times,
    and the completion event the submitting thread blocks on."""

    __slots__ = ("features", "rows", "enqueued_at", "deadline",
                 "result", "error", "_event", "_cbs")

    def __init__(self, features, enqueued_at, deadline=None):
        self.features = features
        self.rows = int(features.shape[0])
        self.enqueued_at = float(enqueued_at)
        self.deadline = None if deadline is None else float(deadline)
        self.result = None
        self.error = None
        self._event = threading.Event()
        self._cbs = []

    @property
    def done(self):
        return self._event.is_set()

    def add_done_callback(self, cb):
        """Run ``cb(self)`` once the request completes (result, error
        or cancellation); if it already has, run it now on the caller.
        Callbacks run on the completing thread — keep them tiny and
        non-blocking (the hedged-dispatch wakeup just notifies a
        condition). Ordering is append-then-recheck so a completion
        racing the registration can never be missed, at the cost that
        a callback may run twice in that race — callbacks MUST be
        idempotent."""
        self._cbs.append(cb)
        if self._event.is_set():
            cb(self)

    def _notify(self):
        for cb in list(self._cbs):
            cb(self)

    def finish(self, result):
        self.result = result
        self._event.set()
        self._notify()

    def fail(self, exc):
        self.error = exc
        self._event.set()
        self._notify()

    def wait_done(self, timeout=None):
        """Block up to `timeout` for completion WITHOUT raising or
        consuming the outcome: True = a result or error is set. The
        hedged-dispatch primitive — the router polls two in-flight
        requests and only the winner's ``wait()`` re-raises."""
        return self._event.wait(timeout)

    def cancel(self, exc=None):
        """Best-effort cancellation: a still-pending request is failed
        with RequestCancelledError (the scheduler then drops it before
        it wastes bucket rows — _take_batch_locked skips done
        requests); a request already completed, or already inside a
        running dispatch, keeps its outcome and its late result is
        simply discarded. Returns True when THIS call cancelled it."""
        if self._event.is_set():
            return False
        self.fail(exc if exc is not None else RequestCancelledError(
            "request cancelled by submitter"))
        return True

    def wait(self, timeout=None):
        """Block until the batch carrying this request completes.

        The one-shot tier's release contract (ServedModel and the HTTP
        504 path defer here; the sequence schedulers' requests keep the
        same one). The caller is released by exactly one of:

        1. result — the dispatch carrying this request completed;
        2. the dispatch's failure, re-raised (HTTP 500);
        3. DeadlineExceededError set by the SCHEDULER — the deadline
           passed while the request was still queued (it never wasted
           bucket rows) or, for sequences, at a step boundary;
        4. DeadlineExceededError raised HERE when `timeout` elapses
           first — the MID-DISPATCH release: even when the dispatcher
           is wedged inside a batch that includes this request, the
           client is released at its deadline (HTTP 504) while the
           batch itself runs to completion in the background. A
           released request's late result is discarded, never
           delivered.

        There is no path that leaves the caller blocked forever short
        of timeout=None with a dispatcher that never returns."""
        if not self._event.wait(timeout):
            raise DeadlineExceededError(
                f"no result within {timeout:.3f}s")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Dynamic micro-batcher over a bounded FIFO (module docstring).

    dispatch:     callable(features [R, ...]) -> output [R, ...] or a
                  list of such arrays (multi-output graphs); row i of
                  every output must correspond to input row i.
    max_rows:     coalescing ceiling — the largest batch bucket.
    queue_limit:  bound on WAITING requests; beyond it submit raises
                  QueueFullError (HTTP 429).
    max_wait:     seconds the oldest waiting request may age before a
                  partial batch dispatches anyway.
    bucket_for:   rows -> dispatch bucket (occupancy accounting only;
                  e.g. ParallelInference._target_batch).
    trailing_shape/feature_dtype: optional per-example contract checked
                  at submit time — a malformed request is ITS error
                  (HTTP 400), never a poisoned coalesced batch.
    clock:        injectable monotonic clock.
    start_thread: run the background scheduler thread. False = the
                  owner drives `poll()`/`flush()` explicitly
                  (deterministic tests).
    name:         the `model` label on this batcher's registry
                  instruments (serving host passes "model:vN"); default
                  a unique per-instance label so anonymous batchers
                  never share series.
    """

    def __init__(self, dispatch, *, max_rows, queue_limit=64,
                 max_wait=0.002, bucket_for=None, trailing_shape=None,
                 feature_dtype=None, clock=None, start_thread=True,
                 name=None):
        if int(queue_limit) < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if int(max_rows) < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self._dispatch = dispatch
        self.max_rows = int(max_rows)
        self.queue_limit = int(queue_limit)
        self.max_wait = float(max_wait)
        self.clock = clock if clock is not None else time.monotonic
        self._bucket_for = bucket_for or (lambda rows: rows)
        self.trailing_shape = None if trailing_shape is None \
            else tuple(trailing_shape)
        self.feature_dtype = feature_dtype
        self._cond = threading.Condition()
        self._pending = deque()
        self._inflight = 0      # requests popped into a running dispatch
        self._closed = False
        self.name = str(name) if name else f"batcher{next(_BATCHER_SEQ)}"
        # per-instance registry instruments (counters/gauge/histograms
        # labeled model=<name>); `stats` reads through the counter
        # children
        reg = telemetry.get_registry()
        lab = {"model": self.name}
        self._registry = reg
        self._m = {
            "requests": reg.counter(
                "dl4j_serving_requests_total",
                "requests accepted into the serving queue",
                labels=("model",)).labels(**lab),
            "rows": reg.counter(
                "dl4j_serving_rows_total",
                "feature rows accepted into the serving queue",
                labels=("model",)).labels(**lab),
            "dispatches": reg.counter(
                "dl4j_serving_dispatches_total",
                "coalesced micro-batch dispatches",
                labels=("model",)).labels(**lab),
            "dispatched_rows": reg.counter(
                "dl4j_serving_dispatched_rows_total",
                "rows carried by dispatched micro-batches",
                labels=("model",)).labels(**lab),
            "coalesced": reg.counter(
                "dl4j_serving_coalesced_total",
                "requests coalesced into dispatched micro-batches",
                labels=("model",)).labels(**lab),
            "expired": reg.counter(
                "dl4j_serving_expired_total",
                "requests whose deadline passed before dispatch (504)",
                labels=("model",)).labels(**lab),
            "rejected": reg.counter(
                "dl4j_serving_rejected_total",
                "requests rejected on a full queue (429)",
                labels=("model",)).labels(**lab),
            "errors": reg.counter(
                "dl4j_serving_errors_total",
                "requests failed by a dispatch error",
                labels=("model",)).labels(**lab),
            "depth": reg.gauge(
                "dl4j_serving_queue_depth",
                "requests currently waiting in the serving queue",
                labels=("model",)).labels(**lab),
            "wait": reg.histogram(
                "dl4j_serving_queue_wait_seconds",
                "enqueue-to-dispatch wait per request",
                labels=("model",)).labels(**lab),
            "occupancy": reg.histogram(
                "dl4j_serving_batch_occupancy",
                "rows/bucket fill fraction per dispatch",
                labels=("model",),
                buckets=(0.25, 0.5, 0.75, 1.0)).labels(**lab),
        }
        #: (rows, bucket) per dispatch: the occupancy record
        self.occupancy = []
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- submit ---------------------------------------------------------
    def submit(self, features, deadline=None, wait=True, timeout=None):
        """Enqueue one request of features [rows, ...].

        deadline: absolute time (per this batcher's clock) after which
        the request must not be dispatched; compute as
        ``batcher.clock() + seconds``.
        wait=True blocks for the result (timeout bounds the block and
        raises DeadlineExceededError); wait=False returns the
        InferenceRequest for the caller to ``wait()`` on.
        """
        features = np.asarray(features)
        if features.ndim < 1 or features.shape[0] < 1:
            raise ValueError(
                f"features must be [rows, ...] with rows >= 1, got "
                f"shape {features.shape}")
        if self.trailing_shape is not None \
                and tuple(features.shape[1:]) != self.trailing_shape:
            raise ValueError(
                f"per-example shape {tuple(features.shape[1:])} does not "
                f"match the model's {self.trailing_shape}")
        if self.feature_dtype is not None:
            features = features.astype(self.feature_dtype, copy=False)
        with self._cond:
            if self._closed:
                raise ServingClosedError("batcher is closed")
            if len(self._pending) >= self.queue_limit:
                self._m["rejected"].inc()
                raise QueueFullError(
                    f"request queue full ({len(self._pending)} waiting, "
                    f"queueLimit={self.queue_limit})")
            req = InferenceRequest(features, self.clock(), deadline)
            self._pending.append(req)
            self._m["requests"].inc()
            self._m["rows"].inc(req.rows)
            self._m["depth"].set(len(self._pending))
            self._cond.notify()
        if wait:
            return req.wait(timeout)
        return req

    # -- scheduling core (lock held) ------------------------------------
    def _expire_locked(self, now):
        """Fail every WAITING request whose deadline has passed — an
        expired request must not waste bucket rows. Requests keep FIFO
        order; expiry can strike anywhere in the queue."""
        if not self._pending:
            return
        keep = deque()
        for req in self._pending:
            if req.deadline is not None and now >= req.deadline:
                self._m["expired"].inc()
                req.fail(DeadlineExceededError(
                    f"deadline passed {now - req.deadline:.3f}s before "
                    "dispatch"))
            else:
                keep.append(req)
        self._pending = keep
        self._m["depth"].set(len(self._pending))

    def _wait_needed_locked(self, now):
        """None = idle (nothing pending); 0 = dispatch now; > 0 =
        seconds until the oldest request's max-wait expires."""
        if not self._pending:
            return None
        if self._closed:
            return 0.0  # draining: flush immediately
        rows = 0
        for req in self._pending:
            rows += req.rows
            if rows >= self.max_rows:
                return 0.0  # a full bucket never waits
        return max(0.0, self.max_wait
                   - (now - self._pending[0].enqueued_at))

    def _take_batch_locked(self):
        """Pop the FIFO prefix that fits max_rows (at least one request
        — an oversized single request dispatches alone; the dispatch
        side handles overflow buckets)."""
        batch, rows = [], 0
        while self._pending:
            req = self._pending[0]
            if req.done:
                # cancelled (hedge loser) or released: already failed,
                # must not waste bucket rows
                self._pending.popleft()
                continue
            if batch and rows + req.rows > self.max_rows:
                break
            batch.append(self._pending.popleft())
            rows += req.rows
        # popped requests stay visible as load (`outstanding`) until
        # their dispatch returns — a wedged dispatch must not make the
        # batcher read idle to the fleet's least-loaded ranking
        self._inflight += len(batch)
        self._m["depth"].set(len(self._pending))
        return batch

    # -- dispatch (lock NOT held) ---------------------------------------
    def _run_batch(self, batch):
        try:
            self._dispatch_batch(batch)
        finally:
            with self._cond:
                self._inflight -= len(batch)

    def _dispatch_batch(self, batch):
        rows = sum(r.rows for r in batch)
        bucket = int(self._bucket_for(rows))
        taken = self.clock()
        oldest = min(r.enqueued_at for r in batch)
        self._m["dispatches"].inc()
        self._m["dispatched_rows"].inc(rows)
        self._m["coalesced"].inc(len(batch))
        self._m["occupancy"].observe(rows / bucket if bucket else 1.0)
        for r in batch:
            self._m["wait"].observe(taken - r.enqueued_at)
        # enqueue→coalesce→dispatch→reply span chain on THIS batcher's
        # clock (ManualClock-driven tests get deterministic traces)
        self._registry.add_span(
            "serving.coalesce", "serving", oldest, taken - oldest,
            model=self.name, requests=len(batch), rows=rows)
        self.occupancy.append((rows, bucket))
        try:
            feats = batch[0].features if len(batch) == 1 else \
                np.concatenate([r.features for r in batch], axis=0)
            # chaos seam INSIDE the batch-failure try: an injected
            # raise fails this batch exactly the way an organic
            # dispatch error does (runtime/chaos.py)
            feats = fault_point("queue.dispatch", feats)
            outs = self._dispatch(feats)
        except Exception as e:
            self._m["errors"].inc(len(batch))
            for r in batch:
                r.fail(e)
            return
        finally:
            self._registry.add_span(
                "serving.dispatch", "serving", taken,
                self.clock() - taken, model=self.name, rows=rows,
                bucket=bucket)
        t_reply = self.clock()
        multi = isinstance(outs, (list, tuple))
        outs_list = [np.asarray(o) for o in (outs if multi else [outs])]
        off = 0
        for r in batch:
            sl = [o[off:off + r.rows] for o in outs_list]
            off += r.rows
            r.finish(sl if multi else sl[0])
        self._registry.add_span(
            "serving.reply", "serving", t_reply,
            self.clock() - t_reply, model=self.name,
            requests=len(batch))

    # -- drivers --------------------------------------------------------
    def poll(self, now=None):
        """One synchronous scheduler pass: expire, then dispatch every
        batch that is due at `now` (default: the clock). Returns the
        seconds until the next max-wait expiry, or None when nothing is
        waiting. This is the thread-less driver deterministic tests
        (and flush) use."""
        while True:
            with self._cond:
                t = self.clock() if now is None else float(now)
                self._expire_locked(t)
                wait_s = self._wait_needed_locked(t)
                if wait_s is None or wait_s > 0:
                    return wait_s
                batch = self._take_batch_locked()
            if batch:
                self._run_batch(batch)

    def flush(self):
        """Dispatch everything pending NOW, regardless of max-wait."""
        while True:
            with self._cond:
                self._expire_locked(self.clock())
                if not self._pending:
                    return
                batch = self._take_batch_locked()
            if batch:    # may be empty when every waiter was cancelled
                self._run_batch(batch)

    def _loop(self):
        """Background scheduler. Uses the real condition-variable clock
        for its timed waits — with an injected ManualClock, drive
        poll() directly instead of starting the thread."""
        while True:
            batch = None
            with self._cond:
                if self._closed and not self._pending:
                    return
                if not self._pending:
                    self._cond.wait(0.05)
                    continue
                now = self.clock()
                self._expire_locked(now)
                wait_s = self._wait_needed_locked(now)
                if wait_s is not None and wait_s > 0:
                    # bounded: re-evaluates on notify (new arrivals may
                    # complete a bucket) or when the max-wait expires
                    self._cond.wait(wait_s)
                    continue
                if wait_s is not None:
                    batch = self._take_batch_locked()
            if batch:
                self._run_batch(batch)

    @property
    def depth(self):
        """Requests currently waiting (the queue-limit denominator)."""
        with self._cond:
            return len(self._pending)

    @property
    def outstanding(self):
        """Requests this batcher still owes a reply: queued + popped
        into a dispatch that has not returned. The load signal
        (ModelHost.queued_work / fleet least-loaded ranking) — `depth`
        alone reads 0 while a wedged dispatch holds a whole batch."""
        with self._cond:
            return len(self._pending) + self._inflight

    def close(self, drain=True):
        """Stop accepting. drain=True completes everything already
        queued (the rolling-swap contract: enqueued requests finish on
        the version they were enqueued against); drain=False fails them
        with ServingClosedError."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._pending:
                    self._pending.popleft().fail(
                        ServingClosedError("batcher closed before "
                                           "dispatch"))
                self._m["depth"].set(0)
            self._cond.notify_all()
        if drain:
            self.flush()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # release this instance's registry series: a long-lived server
        # rolling swaps (model:v1, v2, ...) or a process creating many
        # anonymous batchers must not grow every future /metrics scrape
        # with dead series. The cached self._m handles stay usable
        # (the stats read-through keeps working after close) — they are
        # just detached from exposition.
        reg = self._registry
        for metric in ("dl4j_serving_requests_total",
                       "dl4j_serving_rows_total",
                       "dl4j_serving_dispatches_total",
                       "dl4j_serving_dispatched_rows_total",
                       "dl4j_serving_coalesced_total",
                       "dl4j_serving_expired_total",
                       "dl4j_serving_rejected_total",
                       "dl4j_serving_errors_total",
                       "dl4j_serving_queue_depth",
                       "dl4j_serving_queue_wait_seconds",
                       "dl4j_serving_batch_occupancy"):
            fam = reg.get(metric)
            if fam is not None:
                fam.remove(model=self.name)
        return self

    # -- reporting ------------------------------------------------------
    @property
    def stats(self):
        """Read-through view over this batcher's registry counters (the
        `dl4j_serving_*` instruments labeled model=<name>), computed on
        access."""
        return {k: int(self._m[k].value) for k in _STAT_KEYS}

    def occupancy_summary(self):
        """Occupancy of every dispatch so far: mean rows/bucket plus a
        quartile histogram (the 'is max_wait tuned right' signal),
        computed from the `self.occupancy` record; live dispatches also
        feed the registry's dl4j_serving_batch_occupancy histogram,
        whose quartile edges mirror this binning."""
        return occupancy_summary_from(self.occupancy,
                                      "mean_rows_per_dispatch")


def occupancy_summary_from(records, rows_key):
    """Mean/quartile-histogram occupancy over (rows, bucket) records;
    `rows_key` names the per-tier mean (live slots per step)."""
    if not records:
        return {"dispatches": 0, "mean_occupancy": None,
                "histogram": {}}
    occ = [rows / bucket for rows, bucket in records]
    hist = {"0-25%": 0, "25-50%": 0, "50-75%": 0, "75-100%": 0}
    for o in occ:
        if o <= 0.25:
            hist["0-25%"] += 1
        elif o <= 0.5:
            hist["25-50%"] += 1
        elif o <= 0.75:
            hist["50-75%"] += 1
        else:
            hist["75-100%"] += 1
    return {"dispatches": len(occ),
            "mean_occupancy": round(sum(occ) / len(occ), 4),
            rows_key: round(sum(r for r, _ in records)
                            / len(records), 2),
            "histogram": hist}
