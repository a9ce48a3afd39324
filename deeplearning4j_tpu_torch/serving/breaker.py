"""Failure-domain primitives for the serving fleet.

A copy of ``deeplearning4j_tpu/serving/breaker.py`` (it imports no
accelerator library).

Four small, clock-injectable, individually-testable pieces the
``FleetRouter`` composes (serving/fleet.py):

* ``CircuitBreaker`` — closed/open/half-open per REPLICA over a
  sliding failure-rate window. Consulted by the router's least-loaded
  ranking: an open breaker removes the replica from organic traffic
  for ``open_for_s``, then half-open admits traffic again and
  ``close_after`` consecutive successes re-close it (one failure
  re-opens). All transitions are pure functions of the injected clock
  and the recorded outcomes — ManualClock tests predict them exactly.
* ``ReplicaHealth`` — the per-replica wrapper: breaker + quarantine.
  A QUARANTINED replica serves only health probes; ``note_probe``
  re-admits it after ``readmit_after`` consecutive probe successes
  (and resets the breaker, so re-admission starts clean).
* ``RetryBudget`` — a deterministic token bucket capping failover
  retries at ``ratio`` x requests (+ a small burst): every request
  deposits ``ratio`` tokens, every retry spends one, an empty bucket
  fails fast. This is what keeps a brown-out from amplifying into a
  retry storm — fleet-wide retry amplification is bounded by
  ratio + burst/requests.
* ``BrownoutController`` — admission-time load shedding: estimated
  queue delay (queued work x per-item service estimate) vs the
  request's deadline; a request that cannot make its deadline is shed
  BEFORE it occupies queue space, so overload degrades p50 instead of
  detonating p99. The estimate is conservative on purpose (sheds only
  when the deadline is already hopeless by the measured estimate).

Nothing here spawns threads; all state is lock-guarded, and every
clock is injectable.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["BrownoutController", "CircuitBreaker", "ReplicaHealth",
           "RetryBudget"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-replica circuit breaker (module docstring).

    window:        sliding outcome window length.
    failure_ratio: trip threshold over the window.
    min_samples:   outcomes required before the ratio can trip (a
                   single early failure must not open a cold breaker).
    open_for_s:    how long OPEN rejects before HALF_OPEN admits again.
    close_after:   consecutive HALF_OPEN successes that re-close.
    clock:         injectable monotonic clock (ManualClock in tests).
    """

    def __init__(self, *, window=16, failure_ratio=0.5, min_samples=4,
                 open_for_s=5.0, close_after=2, clock=None):
        if not 0.0 < float(failure_ratio) <= 1.0:
            raise ValueError(
                f"failure_ratio must be in (0, 1], got {failure_ratio}")
        self.window = int(window)
        self.failure_ratio = float(failure_ratio)
        self.min_samples = int(min_samples)
        self.open_for_s = float(open_for_s)
        self.close_after = int(close_after)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._outcomes = deque(maxlen=self.window)  # True = success
        self._state = CLOSED
        self._opened_at = None
        self._half_open_ok = 0
        self.opened_total = 0

    # -- state -----------------------------------------------------------
    def _state_locked(self, now):
        """Resolve the time-driven OPEN -> HALF_OPEN transition."""
        if self._state == OPEN \
                and now - self._opened_at >= self.open_for_s:
            self._state = HALF_OPEN
            self._half_open_ok = 0
        return self._state

    @property
    def state(self):
        with self._lock:
            return self._state_locked(self._clock())

    def allow(self):
        """May organic traffic reach the replica right now? CLOSED and
        HALF_OPEN admit; OPEN rejects until open_for_s elapses."""
        with self._lock:
            return self._state_locked(self._clock()) != OPEN

    # -- outcomes --------------------------------------------------------
    def record(self, ok):
        """Record one dispatch outcome; returns the post-record state."""
        ok = bool(ok)
        with self._lock:
            state = self._state_locked(self._clock())
            if state == HALF_OPEN:
                if ok:
                    self._half_open_ok += 1
                    if self._half_open_ok >= self.close_after:
                        self._state = CLOSED
                        self._outcomes.clear()
                else:
                    self._trip_locked()
                return self._state
            self._outcomes.append(ok)
            if not ok and len(self._outcomes) >= self.min_samples:
                failures = sum(1 for o in self._outcomes if not o)
                if failures / len(self._outcomes) \
                        >= self.failure_ratio:
                    self._trip_locked()
            return self._state

    def _trip_locked(self):
        self._state = OPEN
        self._opened_at = self._clock()
        self._outcomes.clear()
        self._half_open_ok = 0
        self.opened_total += 1

    def reset(self):
        """Force CLOSED with a clean window (the re-admission path)."""
        with self._lock:
            self._state = CLOSED
            self._outcomes.clear()
            self._half_open_ok = 0

    def snapshot(self):
        with self._lock:
            state = self._state_locked(self._clock())
            return {"state": state,
                    "window": list(self._outcomes),
                    "opened_total": self.opened_total}


class ReplicaHealth:
    """Breaker + quarantine for one replica (module docstring)."""

    def __init__(self, *, readmit_after=3, breaker=None, clock=None,
                 **breaker_kw):
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker(clock=clock, **breaker_kw)
        self.readmit_after = int(readmit_after)
        self._lock = threading.Lock()
        self._quarantined = False
        self._probe_ok = 0

    @property
    def quarantined(self):
        with self._lock:
            return self._quarantined

    def admissible(self):
        """May the router rank this replica for organic traffic?"""
        return not self.quarantined and self.breaker.allow()

    def quarantine(self):
        """Remove from organic traffic; only probes reach it now."""
        with self._lock:
            self._quarantined = True
            self._probe_ok = 0

    def readmit(self):
        with self._lock:
            self._quarantined = False
            self._probe_ok = 0
        self.breaker.reset()

    def note_probe(self, ok):
        """Record one health-probe outcome against a quarantined
        replica. Returns True when this probe completed re-admission
        (readmit_after consecutive successes; any failure resets the
        streak)."""
        with self._lock:
            if not self._quarantined:
                return False
            self._probe_ok = self._probe_ok + 1 if ok else 0
            if self._probe_ok < self.readmit_after:
                return False
        self.readmit()
        return True

    def record(self, ok):
        """Record one organic dispatch outcome (feeds the breaker)."""
        return self.breaker.record(ok)

    def snapshot(self):
        with self._lock:
            q, streak = self._quarantined, self._probe_ok
        return {"quarantined": q, "probe_streak": streak,
                **self.breaker.snapshot()}


class RetryBudget:
    """Deterministic ratio-capped retry tokens (module docstring).

    ratio: tokens deposited per request (retries allowed per request,
           long-run).
    burst: bucket cap AND the initial balance — a cold fleet can still
           fail over its first few requests.
    """

    def __init__(self, ratio=0.2, burst=10.0):
        if float(ratio) < 0.0:
            raise ValueError(f"ratio must be >= 0, got {ratio}")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._tokens = self.burst
        self.requests = 0
        self.spent = 0
        self.denied = 0

    def note_request(self):
        """Deposit for one admitted request."""
        with self._lock:
            self.requests += 1
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self):
        """Take one retry token; False = budget exhausted, fail fast."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    def snapshot(self):
        with self._lock:
            return {"tokens": self._tokens, "requests": self.requests,
                    "spent": self.spent, "denied": self.denied,
                    "ratio": self.ratio, "burst": self.burst}


class BrownoutController:
    """Admission-time deadline-hopeless shedding (module docstring).

    est_item_s: per-queued-item service estimate; None = use the
                measured estimate the caller passes per decision (and
                never shed while neither exists — no data, no shed).
    margin:     multiplier on the estimate; > 1 sheds EARLIER (more
                aggressively), < 1 later. Kept at 1.0 by default so
                the controller sheds only what the measurement already
                calls hopeless.
    """

    def __init__(self, est_item_s=None, margin=1.0):
        self.est_item_s = None if est_item_s is None \
            else float(est_item_s)
        self.margin = float(margin)
        self._lock = threading.Lock()
        self.shed = 0
        self.admitted = 0

    def estimate_wait_s(self, queued_work, measured_item_s=None):
        """Queue-delay estimate for `queued_work` items ahead, or None
        when no per-item estimate exists yet."""
        est = self.est_item_s if self.est_item_s is not None \
            else measured_item_s
        if est is None:
            return None
        return float(queued_work) * float(est) * self.margin

    def should_shed(self, queued_work, deadline_s,
                    measured_item_s=None):
        """True when the estimated queue delay alone already exceeds
        the request's deadline — the request is hopeless BEFORE it
        wastes queue space. No deadline or no estimate = admit."""
        if deadline_s is None:
            self._note(False)
            return False
        wait = self.estimate_wait_s(queued_work, measured_item_s)
        hopeless = wait is not None and wait > float(deadline_s)
        self._note(hopeless)
        return hopeless

    def _note(self, shed):
        with self._lock:
            if shed:
                self.shed += 1
            else:
                self.admitted += 1

    def snapshot(self):
        with self._lock:
            return {"shed": self.shed, "admitted": self.admitted,
                    "est_item_s": self.est_item_s,
                    "margin": self.margin}
