"""Deterministic fault seams for the serving path.

A copy of ``deeplearning4j_tpu/runtime/chaos.py``: a seeded
``ChaosPlan`` schedules faults against named ``fault_point`` seams
wired at the dispatch boundaries, so the breaker, quarantine, hedge and
brownout machinery of ``serving/fleet.py`` is tested against the
failures it exists for, and the same fault sequence replays from the
same seed.

========================  ============================================
seam                      dispatch boundary
========================  ============================================
``host.submit``           ServedModel.submit
``host.submit_sequence``  ServedSequenceModel.submit / submit_tokens
``queue.dispatch``        MicroBatcher coalesced dispatch (inside the
                          batch-failure try: an injected raise fails
                          the batch the way a dispatch error does)
``sequence.step``         the sequence schedulers' slot-batched step
``fleet.dispatch``        FleetRouter per-replica dispatch attempt
                          (inside the failover try)
``server.request``        the HTTP GET/POST handlers
``aot.disk_read``         a warm-start record's read (inside the try
                          that turns disk rot into a miss)
``aot.disk_write``        a warm-start record's write (inside the try
                          that costs the record, never the process)
``checkpoint.write``      ResilientFit's checkpoint write
``checkpoint.restore``    ResilientFit's checkpoint restore
========================  ============================================

Other modules register theirs (``kv.page_alloc``, ``sequence.prefill``)
with ``register_seam``.

Fault kinds, per rule: ``raise`` N times, ``wedge`` for T seconds
(blocking on an optional release event), ``slow`` by T seconds, and
``corrupt`` (a payload transform). Every rule resolves to an explicit
set of per-seam invocation ordinals when it is scheduled, the
``random_*`` rules drawing theirs from the plan's seeded RNG, so the
fired sequence is a function of the seed and each seam's invocation
order, never of thread timing. ``plan.events`` records ``(seam, kind,
ordinal)`` in fire order. ``wedge`` and ``slow`` call the plan's
injectable ``sleep``, so tests never block for real.

Disarmed, ``fault_point`` is one read of a module global before it
returns the payload unchanged; an armed plan returns as fast for a seam
it has no rules for. Every fired fault counts in
``dl4j_chaos_injections_total{seam,kind}``; tests tell injected
failures from organic ones by type (``ChaosError``).
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np

__all__ = ["ChaosError", "ChaosPlan", "SEAMS", "arm", "armed_plan",
           "default_corrupt", "disarm", "fault_point", "register_seam",
           "registered_seams"]

#: the built-in seam inventory; modules add theirs via register_seam
SEAMS = ("host.submit", "host.submit_sequence", "queue.dispatch",
         "sequence.step", "fleet.dispatch", "server.request",
         "aot.disk_read", "aot.disk_write", "checkpoint.write",
         "checkpoint.restore")

_KINDS = ("raise", "wedge", "slow", "corrupt")

_EXTRA_SEAMS = set()
_ARM_LOCK = threading.Lock()

#: the armed plan, or None (the fast path)
_PLAN = None


def register_seam(name):
    """Register a seam beyond ``SEAMS`` so plans naming it pass arm-time
    validation. Idempotent; returns the name."""
    name = str(name)
    if not name:
        raise ValueError("seam name must be non-empty")
    with _ARM_LOCK:
        if name not in SEAMS:
            _EXTRA_SEAMS.add(name)
    return name


def registered_seams():
    """Every seam a plan may schedule: the built-in inventory plus every
    registered one."""
    with _ARM_LOCK:
        return SEAMS + tuple(sorted(_EXTRA_SEAMS))


class ChaosError(RuntimeError):
    """An INJECTED failure (tests tell it from organic errors by type)."""


def fault_point(seam, payload=None):
    """The seam hook: disarmed, returns `payload` unchanged; armed, the
    plan fires whatever it scheduled for this invocation of `seam` and
    returns the (possibly corrupted) payload."""
    plan = _PLAN
    if plan is None:
        return payload
    return plan._fire(seam, payload)


def arm(plan):
    """Install `plan` process-wide. A plan naming a seam that is neither
    built in nor registered is rejected: it would never fire."""
    global _PLAN
    with _ARM_LOCK:
        unknown = sorted(set(plan._rules) - set(SEAMS) - _EXTRA_SEAMS)
        if unknown:
            raise ValueError(
                "plan schedules unknown seam(s) "
                + ", ".join(repr(s) for s in unknown)
                + ": not in chaos.SEAMS and never register_seam()-ed")
        _PLAN = plan
    return plan


def disarm():
    """Remove the armed plan; returns it (or None)."""
    global _PLAN
    with _ARM_LOCK:
        plan, _PLAN = _PLAN, None
    return plan


def armed_plan():
    return _PLAN


def default_corrupt(payload):
    """The stock corruption: a numeric array gets its first element
    poisoned (NaN for floats, the dtype's max for ints), a string a
    suffix that breaks it, bytes a flipped bit; anything else passes."""
    if isinstance(payload, np.ndarray) and payload.size:
        bad = np.array(payload, copy=True)
        flat = bad.reshape(-1)
        if np.issubdtype(bad.dtype, np.floating):
            flat[0] = np.nan
        elif np.issubdtype(bad.dtype, np.integer):
            flat[0] = np.iinfo(bad.dtype).max
        return bad
    if isinstance(payload, str):
        return payload + ".chaos-corrupt"
    if isinstance(payload, bytes):
        return bytes([payload[0] ^ 0xFF]) + payload[1:] if payload \
            else b"\xff"
    return payload


class ChaosPlan:
    """A seeded, replayable fault schedule over the named seams.

    Rules bind to explicit invocation ordinals of their seam (``at`` the
    first, ``times`` consecutive), or, for ``random_*`` rules, to
    ordinals drawn from the plan's seeded RNG when the rule is added.
    Ordinals count a seam's ``fault_point`` calls from 0 while the plan
    is armed; a seam with no rules is never counted. ``sleep`` (default
    ``time.sleep``) is what ``slow`` and an event-less ``wedge`` call.
    Use as a context manager to arm and disarm."""

    def __init__(self, seed=0, sleep=None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = threading.Lock()
        self._rules = {}     # seam -> [rule dict]
        self._counts = {}    # seam -> invocations seen while armed
        #: (seam, kind, ordinal) in fire order
        self.events = []
        self._m_fired = None  # registered on the first fire

    # -- schedule --------------------------------------------------------
    def _add(self, seam, kind, fires, **kw):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {_KINDS})")
        rule = {"seam": str(seam), "kind": kind,
                "fires": frozenset(int(i) for i in fires), **kw}
        if not rule["fires"]:
            return self
        with self._lock:
            self._rules.setdefault(str(seam), []).append(rule)
        return self

    def raise_n(self, seam, times=1, at=0, exc=ChaosError,
                message="injected fault"):
        """Raise `exc` on invocations [at, at+times) of `seam`."""
        return self._add(seam, "raise", range(at, at + times), exc=exc,
                         message=str(message))

    def wedge(self, seam, seconds, at=0, times=1, release=None):
        """Block for `seconds` (or until `release`, a threading.Event,
        is set) on invocations [at, at+times): the wedged replica."""
        return self._add(seam, "wedge", range(at, at + times),
                         seconds=float(seconds), release=release)

    def slow(self, seam, seconds, at=0, times=1):
        """Sleep `seconds` on invocations [at, at+times)."""
        return self._add(seam, "slow", range(at, at + times),
                         seconds=float(seconds))

    def corrupt(self, seam, at=0, times=1, mutate=None):
        """Pass the payload through `mutate` (default
        ``default_corrupt``) on invocations [at, at+times)."""
        return self._add(seam, "corrupt", range(at, at + times),
                         mutate=mutate or default_corrupt)

    def random_raises(self, seam, rate, window, exc=ChaosError,
                      message="injected fault"):
        """Each of the first `window` invocations raises with
        probability `rate`, the ordinals drawn now from the plan's
        RNG."""
        fires = [i for i in range(int(window))
                 if self._rng.random() < float(rate)]
        return self._add(seam, "raise", fires, exc=exc,
                         message=str(message))

    def random_slows(self, seam, rate, window, seconds):
        """Seeded intermittent slowness over the first `window`
        invocations of `seam`."""
        fires = [i for i in range(int(window))
                 if self._rng.random() < float(rate)]
        return self._add(seam, "slow", fires, seconds=float(seconds))

    # -- introspection ---------------------------------------------------
    def schedule(self):
        """{seam: sorted fire ordinals per rule}."""
        with self._lock:
            return {seam: [sorted(r["fires"]) for r in rules]
                    for seam, rules in self._rules.items()}

    def fired(self, seam=None):
        """Count of fired faults (optionally for one seam)."""
        with self._lock:
            return sum(1 for s, _, _ in self.events
                       if seam is None or s == seam)

    # -- runtime ---------------------------------------------------------
    def _metrics(self):
        with self._lock:
            if self._m_fired is None:
                from deeplearning4j_tpu_torch.runtime import telemetry

                self._m_fired = telemetry.get_registry().counter(
                    "dl4j_chaos_injections_total",
                    "chaos faults fired, by seam and kind",
                    labels=("seam", "kind"))
            return self._m_fired

    def _fire(self, seam, payload):
        rules = self._rules.get(seam)  # thread-ok[THR01]: rule books are built before arm() and only read after; a dict get is one atomic read
        if not rules:
            return payload
        with self._lock:
            n = self._counts.get(seam, 0)
            self._counts[seam] = n + 1
            due = [r for r in rules if n in r["fires"]]
            for r in due:
                self.events.append((seam, r["kind"], n))
        # act outside the lock: wedge and slow block, raise unwinds
        for r in due:
            self._metrics().labels(seam=seam, kind=r["kind"]).inc()
            kind = r["kind"]
            if kind == "slow":
                self._sleep(r["seconds"])
            elif kind == "wedge":
                ev = r["release"]
                if ev is not None:
                    ev.wait(r["seconds"])
                else:
                    self._sleep(r["seconds"])
            elif kind == "corrupt":
                payload = r["mutate"](payload)
            else:
                raise r["exc"](f"chaos[{seam}#{n}]: {r['message']}")
        return payload

    def __enter__(self):
        arm(self)
        return self

    def __exit__(self, *exc):
        disarm()
        return False
