"""Multi-host serving fleet: N ModelHost replicas behind one router.

A copy of ``deeplearning4j_tpu/serving/fleet.py`` over the port's
``ModelHost``.

One ``ModelHost`` is one serving process's worth of models (queue +
micro-batcher + warm buckets per model). Production traffic from
millions of users needs N of them — and the pieces that make N hosts a
FLEET are host-side and statically testable: least-loaded dispatch,
per-model SLOs, queue-depth-driven autoscaling *decisions* (a callback
surface — the fleet layer decides, an operator/orchestrator actuates;
no real processes are spawned here), and rolling swaps that stay
zero-5xx fleet-wide because each replica's swap already is
(serving/host.py).

* ``FleetRouter.submit`` picks the replica with the LEAST total queued
  work for the target model (queue depth + live slot count for
  sequence models) and fails over to the next-least-loaded on
  ``QueueFullError`` — a single saturated replica sheds to its peers
  before the client ever sees a 429; only a fleet-wide full queue
  surfaces backpressure.
* ``register``/``register_sequence`` fan a model out to every replica;
  ``swap_all`` rolls a new version across replicas ONE AT A TIME (the
  remaining replicas keep serving, each per-replica swap is itself
  warm-then-flip) — fleet-wide zero-5xx rolling deploys.
* ``set_slo`` declares per-model targets (p99 ms, queue-depth bounds,
  replica min/max); ``autoscale_tick`` turns the live queue depths +
  measured p99 into scale decisions and invokes every ``on_scale``
  callback with a structured record.
* ``metrics_snapshot`` is the fleet view: per-replica queue depth +
  slot occupancy + per-model fleet aggregates, additive over the
  per-host snapshot schema.

Failure domains: every replica
carries a ``ReplicaHealth`` — a closed/open/half-open circuit breaker
over its dispatch outcomes plus a quarantine flag — consulted by the
least-loaded ranking, so a replica that WEDGES or THROWS (not just one
that politely raises QueueFullError) is evicted from organic traffic
and re-admitted only after the breaker's half-open probe successes (or
``probe_tick`` health canaries for a quarantined replica). Failover
covers every dispatch-path error class (counted per class in
``dl4j_fleet_failovers_total``) under a per-model ratio-capped
``RetryBudget`` so a brown-out cannot amplify into a retry storm;
``set_hedge`` arms tail-latency hedging for idempotent one-shot
``:predict`` (second replica fired at the p95 mark, first response
wins, loser cancelled); ``set_brownout`` sheds deadline-hopeless
requests at admission. All of it is exercised by the deterministic
chaos harness (runtime/chaos.py, seam ``fleet.dispatch``).

Load scenarios: diurnal ramp (open-loop rate swept through a day
curve), hot-model skew (one model takes most of the traffic),
slow-client storm (closed-loop clients with think time holding
results). Each records fleet requests/sec, p50/p99 and per-error-class
counts.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.chaos import fault_point
from deeplearning4j_tpu_torch.serving import loadgen
from deeplearning4j_tpu_torch.serving.breaker import (
    BrownoutController, ReplicaHealth, RetryBudget,
)
from deeplearning4j_tpu_torch.serving.queue import (
    DeadlineExceededError, QueueFullError, ServingClosedError,
)

__all__ = ["FleetRouter", "ModelSLO", "scenario_diurnal_ramp",
           "scenario_hot_model_skew", "scenario_slow_client_storm"]

#: breaker-state gauge encoding (dl4j_fleet_breaker_state)
_BREAKER_STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

_REPLICA_SEQ = itertools.count(1)


class ModelSLO:
    """Per-model service-level objective + autoscale thresholds.

    p99_ms:       latency target; a measured fleet p99 above it votes
                  scale_up.
    queue_high:   mean per-replica queued work above this votes
                  scale_up.
    queue_low:    mean per-replica queued work below this votes
                  scale_down (never below min_replicas).
    min_replicas/max_replicas: the decision clamp.
    """

    __slots__ = ("p99_ms", "queue_high", "queue_low", "min_replicas",
                 "max_replicas")

    def __init__(self, p99_ms=None, queue_high=8.0, queue_low=1.0,
                 min_replicas=1, max_replicas=8):
        if float(queue_low) > float(queue_high):
            raise ValueError(
                f"queue_low {queue_low} > queue_high {queue_high}: the "
                "scale-down band must sit below the scale-up band")
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)

    def as_dict(self):
        return {"p99_ms": self.p99_ms, "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}


class FleetRouter:
    """Least-loaded router over N ModelHost replicas (module
    docstring). Thread-safe: the replica table and SLO book are
    lock-guarded; dispatches run outside the lock."""

    def __init__(self, replicas=(), clock=None, breaker=None,
                 readmit_after=3, retry_ratio=0.2, retry_burst=10.0):
        """breaker: dict of CircuitBreaker kwargs applied to every
        replica's health record (window/failure_ratio/min_samples/
        open_for_s/close_after), or False to disable breaker +
        quarantine gating entirely. retry_ratio/retry_burst: the
        per-model RetryBudget (serving/breaker.py)."""
        self._lock = threading.Lock()
        self._replicas = {}        # id -> ModelHost
        self._health = {}          # id -> ReplicaHealth
        self._slos = {}            # model name -> ModelSLO
        self._scale_cbs = []
        self._budgets = {}         # model name -> RetryBudget
        self._hedge = {}           # model name -> {"after_s": ...}
        self._brownouts = {}       # model name -> BrownoutController
        self._probes = {}          # model name -> canary features
        self._clock = clock
        self._breaker_kw = None if breaker is False else dict(breaker
                                                              or {})
        self._readmit_after = int(readmit_after)
        self._retry_ratio = float(retry_ratio)
        self._retry_burst = float(retry_burst)
        reg = telemetry.get_registry()
        self._registry = reg
        self._m_requests = reg.counter(
            "dl4j_fleet_requests_total",
            "requests routed by the fleet router",
            labels=("model",))
        self._m_failover = reg.counter(
            "dl4j_fleet_failovers_total",
            "requests shed to a peer replica, by error class",
            labels=("model", "error"))
        self._m_latency = reg.histogram(
            "dl4j_fleet_request_seconds",
            "router-measured request latency (the SLO p99 source)",
            labels=("model",))
        self._m_replicas = reg.gauge(
            "dl4j_fleet_replicas", "replicas registered to the fleet")
        self._m_breaker = reg.gauge(
            "dl4j_fleet_breaker_state",
            "per-replica breaker state (0 closed, 1 half-open, 2 open)",
            labels=("replica",))
        self._m_hedges = reg.counter(
            "dl4j_fleet_hedges_total",
            "hedged second dispatches fired", labels=("model",))
        self._m_hedge_wins = reg.counter(
            "dl4j_fleet_hedge_wins_total",
            "hedged dispatches won by the second replica",
            labels=("model",))
        self._m_shed = reg.counter(
            "dl4j_fleet_brownout_shed_total",
            "requests shed at admission (deadline already unmeetable)",
            labels=("model",))
        self._m_probes = reg.counter(
            "dl4j_fleet_probes_total",
            "health-probe canaries against quarantined replicas",
            labels=("model", "outcome"))
        for host in replicas:
            self.add_replica(host)

    # -- replica lifecycle ----------------------------------------------
    def add_replica(self, host, replica_id=None):
        """Attach one ModelHost; returns its replica id."""
        rid = str(replica_id) if replica_id else \
            f"replica{next(_REPLICA_SEQ)}"
        with self._lock:
            if rid in self._replicas:
                raise ValueError(f"replica {rid!r} already attached")
            self._replicas[rid] = host
            if self._breaker_kw is not None:
                self._health[rid] = ReplicaHealth(
                    readmit_after=self._readmit_after,
                    clock=self._now, **self._breaker_kw)
            self._m_replicas.set(len(self._replicas))
        self._m_breaker.labels(replica=rid).set(0.0)
        return rid

    def remove_replica(self, replica_id, drain=True):
        """Detach + close one replica (drain=True completes its queued
        work — the scale-down path)."""
        with self._lock:
            host = self._replicas.pop(replica_id, None)
            self._health.pop(replica_id, None)
            self._m_replicas.set(len(self._replicas))
        self._m_breaker.remove(replica=replica_id)
        if host is None:
            raise KeyError(f"unknown replica {replica_id!r} "
                           f"(attached: {self.replica_ids()})")
        host.close(drain=drain)
        return host

    def replica_ids(self):
        with self._lock:
            return sorted(self._replicas)

    def _hosts(self):
        with self._lock:
            return list(self._replicas.items())

    # -- model fan-out ---------------------------------------------------
    def register(self, name, network, **kw):
        """Register a one-shot model on EVERY replica (each warms its
        buckets before the name is routable there)."""
        return {rid: host.register(name, network, **kw)
                for rid, host in self._hosts()}

    def register_sequence(self, name, network, **kw):
        """Register a sequence (iteration-level) model on every
        replica."""
        return {rid: host.register_sequence(name, network, **kw)
                for rid, host in self._hosts()}

    def swap_all(self, name, network, **overrides):
        """Fleet-wide rolling deploy: swap replicas ONE AT A TIME.
        While replica i warms+flips, the other N-1 keep serving the old
        version; each per-replica swap is itself warm-then-flip with a
        drain (serving/host.py), so no request anywhere sees a cold
        dispatch or a 5xx. Covers one-shot AND sequence models (each
        host routes by its own registration kind)."""
        out = {}
        for rid, host in self._hosts():
            kind = host.kind(name)
            if kind == "sequence":
                out[rid] = host.swap_sequence(name, network, **overrides)
            elif kind == "oneshot":
                out[rid] = host.swap(name, network, **overrides)
            else:
                raise KeyError(
                    f"replica {rid!r} does not serve model {name!r} — "
                    "register it fleet-wide before swap_all")
        return out

    # -- dispatch --------------------------------------------------------
    @staticmethod
    def _queued_work(host, name):
        """Outstanding work this replica holds for `name`: one-shot
        requests queued or inside a running dispatch, or queue depth +
        live slots for a sequence model (the least-loaded ranking
        key); None when the replica does not serve the model. A
        point-in-time probe — routing tolerates staleness."""
        return host.queued_work(name)

    def health(self, replica_id):
        """The replica's ReplicaHealth (breaker + quarantine), or None
        when breaker gating is disabled (breaker=False)."""
        with self._lock:
            return self._health.get(replica_id)

    def _note_outcome(self, rid, ok):
        """Feed one dispatch outcome into the replica's breaker and
        mirror the resulting state into the breaker gauge."""
        h = self.health(rid)
        if h is None:
            return
        state = h.record(ok)
        self._m_breaker.labels(replica=rid).set(
            _BREAKER_STATES.get(state, 0.0))

    def _ranked(self, name):
        """(replica_id, host) pairs serving `name`, least loaded
        first. Replicas whose breaker is OPEN or that are QUARANTINED
        are excluded from organic traffic — unless that would empty
        the list, in which case the router FAILS OPEN and ranks the
        barred replicas anyway (a wrongly-tripped fleet must degrade,
        not hard-down)."""
        ranked, barred = [], []
        for rid, host in self._hosts():
            load = self._queued_work(host, name)
            if load is None:
                continue
            h = self.health(rid)
            if h is None or h.admissible():
                ranked.append((load, rid, host))
            else:
                barred.append((load, rid, host))
        if not ranked and not barred:
            raise KeyError(
                f"no replica serves model {name!r} "
                f"(replicas: {self.replica_ids()})")
        if not ranked:
            ranked = barred  # fail open: serving beats a hard down
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [(rid, host) for _, rid, host in ranked]

    def _budget(self, name):
        with self._lock:
            b = self._budgets.get(name)
            if b is None:
                b = self._budgets[name] = RetryBudget(
                    ratio=self._retry_ratio, burst=self._retry_burst)
        return b

    # -- admission: brownout ---------------------------------------------
    def set_brownout(self, name, est_item_s=None, margin=1.0,
                     enabled=True):
        """Arm (or disarm) admission-time shedding for `name`: a
        deadline-carrying request whose estimated queue delay (least
        queued work x per-item estimate) already exceeds its deadline
        is rejected NOW with DeadlineExceededError instead of wasting
        queue space. est_item_s=None uses the measured mean request
        latency (dl4j_fleet_request_seconds)."""
        with self._lock:
            if not enabled:
                return self._brownouts.pop(name, None)
            bo = self._brownouts[name] = BrownoutController(
                est_item_s=est_item_s, margin=margin)
        return bo

    def _admit(self, name, deadline_s, least_load):
        with self._lock:
            bo = self._brownouts.get(name)
        if bo is None or deadline_s is None:
            return
        child = self._m_latency.labels_get(model=name)
        measured = child.mean() if child is not None else None
        if bo.should_shed(least_load, deadline_s, measured):
            self._m_shed.labels(model=name).inc()
            raise DeadlineExceededError(
                f"brownout: ~{bo.estimate_wait_s(least_load, measured):.3f}s "
                f"of queued work ahead exceeds the {deadline_s:.3f}s "
                f"deadline — shed at admission")

    # -- dispatch --------------------------------------------------------
    def submit(self, name, features, deadline_s=None):
        """Route one one-shot request to the least-loaded admissible
        replica; fail over on ANY dispatch-path error (not just
        QueueFullError) within the per-model retry budget. Only a
        fleet-wide failure re-raises. With set_hedge armed, a second
        replica is fired at the p95 mark and the first response
        wins."""
        with self._lock:
            hedge = self._hedge.get(name)
        if hedge is not None:
            return self._submit_hedged(name, features, deadline_s,
                                       hedge)
        t0 = self._now()
        out = self._failover(
            name, lambda host: host.submit(name, features,
                                           deadline_s=deadline_s),
            deadline_s=deadline_s)
        # observed only for COMPLETED requests: a 429 storm's fast
        # failures must not dilute the p99 the autoscaler votes on
        self._m_latency.labels(model=name).observe(self._now() - t0)
        return out

    def submit_sequence(self, name, features, deadline_s=None,
                        extra_steps=0, wait=True, timeout=None):
        """Route one sequence to the least-loaded replica's slot
        scheduler (same failover discipline as submit; sequences are
        stateful mid-decode, so they are never hedged)."""
        t0 = self._now()
        out = self._failover(
            name, lambda host: host.submit_sequence(
                name, features, deadline_s=deadline_s,
                extra_steps=extra_steps, wait=wait, timeout=timeout),
            deadline_s=deadline_s)
        if wait:
            # wait=False returns at enqueue — that sample would read
            # sub-ms and suppress the autoscaler's p99 scale-up vote
            self._m_latency.labels(model=name).observe(self._now() - t0)
        return out

    def _failover(self, name, call, deadline_s=None, want_rid=False):
        """Try replicas least-loaded first. Error classification:

        * QueueFullError / ServingClosedError — backpressure or a
          replica mid-retirement: fail over (budget-capped) but do NOT
          charge the replica's breaker; load is not a fault.
        * DeadlineExceededError, ValueError, KeyError — the REQUEST's
          own problem (deadline spent, malformed, unknown model): no
          failover, no breaker charge; re-raise immediately.
        * anything else — a replica fault: charge the breaker, fail
          over (budget-capped). Only a fleet-wide failure surfaces.
        """
        self._m_requests.labels(model=name).inc()
        budget = self._budget(name)
        budget.note_request()
        ranked = self._ranked(name)
        self._admit(name, deadline_s,
                    self._queued_work(ranked[0][1], name) or 0)
        last = None
        for i, (rid, host) in enumerate(ranked):
            try:
                # the routing chaos seam: an injected raise here is a
                # dispatch-path fault on THIS replica (runtime/chaos.py)
                fault_point("fleet.dispatch")
                out = call(host)
            except (QueueFullError, ServingClosedError) as e:
                last = e
                if i + 1 < len(ranked) and budget.try_spend():
                    self._m_failover.labels(
                        model=name, error=type(e).__name__).inc()
                    continue
                raise
            except (DeadlineExceededError, ValueError, KeyError):
                raise
            except Exception as e:
                last = e
                self._note_outcome(rid, False)
                if i + 1 < len(ranked) and budget.try_spend():
                    self._m_failover.labels(
                        model=name, error=type(e).__name__).inc()
                    continue
                raise
            else:
                self._note_outcome(rid, True)
                return (out, rid) if want_rid else out
        raise last

    # -- hedged dispatch -------------------------------------------------
    def set_hedge(self, name, after_s=None, enabled=True):
        """Arm (or disarm) tail-latency hedging for idempotent one-shot
        `name`: when the primary has not answered within the hedge
        mark, fire the SAME request at the next-ranked replica — first
        response wins, the loser is cancelled. after_s=None uses the
        live p95 of dl4j_fleet_request_seconds (falling back to 50 ms
        until enough samples exist). Hedges spend the same retry
        budget as failovers, so a brown-out cannot double the load."""
        with self._lock:
            if not enabled:
                return self._hedge.pop(name, None)
            self._hedge[name] = {"after_s": None if after_s is None
                                 else float(after_s)}

    def _hedge_after(self, name, conf):
        if conf["after_s"] is not None:
            return conf["after_s"]
        child = self._m_latency.labels_get(model=name)
        p95 = child.percentile(95) if child is not None else None
        return 0.05 if p95 is None else p95

    def _submit_hedged(self, name, features, deadline_s, conf):
        t0 = self._now()
        # completion wakeup: every leg notifies this condition the
        # moment it finishes (add_done_callback), so the race loop
        # below sleeps on a bounded CV wait instead of busy-spinning
        done = threading.Condition()

        def _wake(_req):  # idempotent — add_done_callback may re-call
            with done:
                done.notify_all()

        req1, rid1 = self._failover(
            name, lambda host: host.submit(name, features,
                                           deadline_s=deadline_s,
                                           wait=False),
            deadline_s=deadline_s, want_rid=True)
        req1.add_done_callback(_wake)
        legs = [(rid1, req1)]
        hedge_after = self._hedge_after(name, conf)
        if not req1.wait_done(hedge_after):
            # primary is past the hedge mark: fire the second replica
            # (next-ranked, never the same one) if budget allows
            cand = next(((rid, h) for rid, h in self._ranked(name)
                         if rid != rid1), None)
            if cand is not None and self._budget(name).try_spend():
                rid2, host2 = cand
                rem = None if deadline_s is None else \
                    max(1e-3, deadline_s - (self._now() - t0))
                try:
                    req2 = host2.submit(name, features, deadline_s=rem,
                                        wait=False)
                except Exception as e:
                    # hedge enqueue refused: the primary races on
                    # alone, but the refusal is COUNTED under its
                    # error class and — unless it is backpressure —
                    # charged to the refusing replica, same as any
                    # dispatch fault (a silently swallowed refusal
                    # here hid dead hedge replicas from the breaker)
                    req2 = None
                    if not isinstance(e, (QueueFullError,
                                          ServingClosedError)):
                        self._note_outcome(rid2, False)
                    self._m_failover.labels(
                        model=name, error=type(e).__name__).inc()
                if req2 is not None:
                    self._m_hedges.labels(model=name).inc()
                    req2.add_done_callback(_wake)
                    legs.append((rid2, req2))
        # first COMPLETED-with-result leg wins; a leg that completes
        # with an error is charged to its replica and dropped so the
        # other leg keeps racing (hedging covers faults for free)
        last_err = None
        while legs:
            for rid, req in list(legs):
                if not req.done:
                    continue
                if req.error is not None:
                    self._note_outcome(rid, False)
                    legs.remove((rid, req))
                    last_err = req.error
                    continue
                for orid, other in legs:    # cancel the loser(s)
                    if other is not req:
                        other.cancel()
                self._note_outcome(rid, True)
                if req is not req1:
                    self._m_hedge_wins.labels(model=name).inc()
                self._m_latency.labels(model=name).observe(
                    self._now() - t0)
                return req.result
            if deadline_s is not None \
                    and self._now() - t0 > deadline_s + 1.0:
                # backstop only: each leg's own deadline releases it
                # (the queue.py wait contract) long before this fires
                for _, req in legs:
                    req.cancel()
                raise DeadlineExceededError(
                    f"hedged request exceeded {deadline_s:.3f}s")
            with done:
                # bounded wait: a completing leg's callback wakes this
                # immediately (no lost wakeup — the re-check holds the
                # condition lock the callback must take to notify);
                # the 50 ms bound only paces the deadline backstop
                if not any(r.done for _, r in legs):
                    done.wait(0.05)
        raise last_err

    # -- health probes / quarantine --------------------------------------
    def quarantine(self, replica_id):
        """Remove a replica from organic traffic; it serves only
        probe_tick canaries until readmit_after consecutive successes
        re-admit it (breaker reset on re-admission)."""
        h = self.health(replica_id)
        if h is None:
            raise RuntimeError(
                "breaker gating disabled (breaker=False) — "
                "quarantine needs ReplicaHealth")
        h.quarantine()
        self._m_breaker.labels(replica=replica_id).set(
            _BREAKER_STATES["open"])
        return h

    def set_probe(self, name, features, deadline_s=1.0):
        """Register the canary request probe_tick sends for `name`."""
        with self._lock:
            self._probes[name] = (np.asarray(features),
                                  float(deadline_s))

    def probe_tick(self):
        """Send one canary per (quarantined replica, probed model it
        serves). Returns structured probe results; a replica whose
        consecutive-success streak reaches readmit_after is re-admitted
        (and its breaker reset). Call this from the operator loop the
        same way as autoscale_tick."""
        with self._lock:
            probes = dict(self._probes)
        results = []
        for rid, host in self._hosts():
            h = self.health(rid)
            if h is None or not h.quarantined:
                continue
            for name, (feats, deadline_s) in probes.items():
                if host.queued_work(name) is None:
                    continue
                try:
                    host.submit(name, feats, deadline_s=deadline_s)
                    ok = True
                except Exception:  # fault-ok[FLT01]: the outcome IS the classification (below)
                    # the outcome is the classification: it feeds
                    # dl4j_fleet_probes_total{outcome=fail} and the
                    # readmission streak below
                    ok = False
                readmitted = h.note_probe(ok)
                self._m_probes.labels(
                    model=name, outcome="ok" if ok else "fail").inc()
                if readmitted:
                    self._m_breaker.labels(replica=rid).set(
                        _BREAKER_STATES["closed"])
                results.append({"replica": rid, "model": name,
                                "ok": ok, "readmitted": readmitted})
        return results

    def _now(self):
        return self._clock() if self._clock is not None \
            else self._registry.clock()

    # -- SLOs + autoscale decisions --------------------------------------
    def set_slo(self, name, **kw):
        """Declare the SLO for one model (ModelSLO kwargs)."""
        slo = ModelSLO(**kw)
        with self._lock:
            self._slos[name] = slo
        return slo

    def slos(self):
        with self._lock:
            return {n: s.as_dict() for n, s in self._slos.items()}

    def on_scale(self, callback):
        """Register a scale-decision callback:
        ``callback(decision_dict)``. The fleet layer only DECIDES —
        spawning/retiring replica processes is the operator's
        (orchestrator's) actuation, wired through this surface."""
        with self._lock:
            self._scale_cbs.append(callback)
        return callback

    def autoscale_tick(self):
        """Evaluate every SLO'd model against the live fleet state and
        emit scale decisions. Returns the decision list; each decision
        was also passed to every on_scale callback.

        Votes: mean per-replica queued work > queue_high -> up;
        measured fleet p99 above the SLO target -> up; queued work <
        queue_low -> down. The desired count is clamped to
        [min_replicas, max_replicas]; "hold" decisions are returned but
        NOT dispatched to callbacks (callbacks see actionable deltas
        only)."""
        with self._lock:
            slos = dict(self._slos)
            cbs = list(self._scale_cbs)
        decisions = []
        for name, slo in slos.items():
            loads = []
            for _, host in self._hosts():
                load = self._queued_work(host, name)
                if load is not None:
                    loads.append(load)
            if not loads:
                continue
            n = len(loads)
            mean_load = sum(loads) / n
            child = self._m_latency.labels_get(model=name)
            p99_ms = None
            if child is not None:
                p99 = child.percentile(99)
                p99_ms = None if p99 is None else p99 * 1000.0
            reasons = []
            if mean_load > slo.queue_high:
                reasons.append(
                    f"mean queued work {mean_load:.1f} > "
                    f"queue_high {slo.queue_high:g}")
            if slo.p99_ms is not None and p99_ms is not None \
                    and p99_ms > slo.p99_ms:
                reasons.append(
                    f"p99 {p99_ms:.1f}ms > slo {slo.p99_ms:g}ms")
            if reasons:
                desired = n + 1
            elif mean_load < slo.queue_low:
                desired = n - 1
                reasons.append(
                    f"mean queued work {mean_load:.1f} < "
                    f"queue_low {slo.queue_low:g}")
            else:
                desired = n
            # the replica bounds outrank the votes — and when a clamp
            # changes the direction (n already past a bound), the bound
            # must be the recorded justification, not the vote
            bounded = max(slo.min_replicas,
                          min(desired, slo.max_replicas))
            if bounded != desired:
                clamp = (f"replica bound: desired {desired} clamped "
                         f"to {bounded} (min {slo.min_replicas:g}, "
                         f"max {slo.max_replicas:g})")
                if (bounded > n) != (desired > n) or bounded == n:
                    reasons = [clamp]
                else:
                    reasons.append(clamp)
                desired = bounded
            decision = {
                "model": name,
                "replicas": n,
                "desired_replicas": desired,
                "action": ("scale_up" if desired > n else
                           "scale_down" if desired < n else "hold"),
                "mean_queued_work": round(mean_load, 2),
                "p99_ms": None if p99_ms is None else round(p99_ms, 2),
                "reasons": reasons,
                "slo": slo.as_dict(),
            }
            decisions.append(decision)
            if decision["action"] != "hold":
                self._registry.event("fleet.scale_decision", "serving",
                                     **{k: v for k, v in decision.items()
                                        if k not in ("slo", "reasons")})
                for cb in cbs:
                    cb(decision)
        return decisions

    # -- observability / lifecycle ---------------------------------------
    def metrics_snapshot(self):
        """The fleet view: per-replica queue depth + slot occupancy,
        per-model fleet aggregates, the SLO book, and the process
        registry, additive over the per-host snapshot schema."""
        per_replica = {}
        fleet_models = {}
        for rid, host in self._hosts():
            snap = host.metrics_snapshot()
            replica_depth = 0
            for name, view in snap["models"].items():
                replica_depth += view["queue_depth"]
                agg = fleet_models.setdefault(
                    name, {"kind": "oneshot", "queue_depth": 0,
                           "replicas": 0})
                agg["queue_depth"] += view["queue_depth"]
                agg["replicas"] += 1
            for name, view in snap.get("sequences", {}).items():
                replica_depth += view["queue_depth"]
                agg = fleet_models.setdefault(
                    name, {"kind": "sequence", "queue_depth": 0,
                           "active_slots": 0, "replicas": 0})
                agg["queue_depth"] += view["queue_depth"]
                agg["active_slots"] = agg.get("active_slots", 0) \
                    + view["active_slots"]
                agg["replicas"] += 1
            per_replica[rid] = {
                "queue_depth": replica_depth,
                "models": snap["models"],
                "sequences": snap.get("sequences", {}),
            }
        return {"registry": telemetry.get_registry().snapshot(),
                "replicas": per_replica,
                "models": fleet_models,
                "slos": self.slos()}

    def close(self, drain=True):
        with self._lock:
            hosts = list(self._replicas.values())
            self._replicas.clear()
            self._m_replicas.set(0)
        for host in hosts:
            host.close(drain=drain)


# ----------------------------------------------------------------------
# fleet load scenarios
# ----------------------------------------------------------------------

def scenario_diurnal_ramp(submit, make_request, *, base_rate,
                          peak_rate, phases=5, requests_per_phase=64,
                          seed=0, max_clients=16):
    """Open-loop rate swept low -> peak -> low (a day curve compressed
    into `phases` phases). Records per-phase rps/p50/p99 + error
    classes and the whole-run aggregate."""
    if phases < 3:
        # 2 phases would put both samples at the triangle's feet —
        # base_rate twice, peak_rate never driven
        raise ValueError(f"need >= 3 phases for a ramp, got {phases}")
    # triangle curve: up to the peak and back down
    half = (phases - 1) / 2.0
    rates = [base_rate + (peak_rate - base_rate)
             * (1.0 - abs(i - half) / half) for i in range(phases)]
    recs = []
    for i, rate in enumerate(rates):
        recs.append(dict(loadgen.run_open_loop(
            submit, make_request, rate=rate,
            n_requests=requests_per_phase, seed=seed + i,
            max_clients=max_clients), phase=i,
            rate_rps=round(rate, 1)))
    total = sum(r["completed"] for r in recs)
    dur = sum(r["duration_s"] for r in recs)
    errors = {}
    for r in recs:
        for k, v in r["errors"].items():
            errors[k] = errors.get(k, 0) + v
    p99s = [r["p99_ms"] for r in recs if r.get("p99_ms") is not None]
    return {"scenario": "diurnal_ramp", "phases": recs,
            "completed": total, "errors": errors,
            "requests_per_sec": round(total / dur, 2) if dur else None,
            "p99_ms": max(p99s) if p99s else None}


def scenario_hot_model_skew(submit_for, make_request, *, models,
                            hot_fraction=0.8, rate=200.0,
                            n_requests=128, seed=0, max_clients=16):
    """One model takes `hot_fraction` of the traffic, the rest split
    the remainder — the skew that makes per-model least-loaded routing
    earn its keep. submit_for(name) -> submit callable. Records
    per-model rps/p99 + error classes."""
    models = list(models)
    if len(models) < 2:
        raise ValueError("hot-model skew needs >= 2 models")
    hot, rest = models[0], models[1:]
    rng = np.random.RandomState(seed)
    picks = [hot if rng.rand() < hot_fraction
             else rest[rng.randint(len(rest))]
             for _ in range(n_requests)]

    # route by request index: the loadgen drives (name, features)
    # tuples so the per-model split is part of the seeded schedule
    rec_by_model = {m: {"lat": [], "errors": {}} for m in models}
    lock = threading.Lock()

    def tagged_make(i):
        return (picks[i], make_request(i))

    def tagged_submit(req):
        name, x = req
        t0 = time.monotonic()
        try:
            submit_for(name)(x)
            with lock:
                rec_by_model[name]["lat"].append(time.monotonic() - t0)
        except Exception as e:
            with lock:
                errs = rec_by_model[name]["errors"]
                errs[type(e).__name__] = errs.get(type(e).__name__,
                                                  0) + 1
            raise

    rec = loadgen.run_open_loop(tagged_submit, tagged_make, rate=rate,
                                n_requests=n_requests, seed=seed,
                                max_clients=max_clients)
    per_model = {}
    for m in models:
        lat = sorted(rec_by_model[m]["lat"])
        per_model[m] = {
            "requests": len(lat)
            + sum(rec_by_model[m]["errors"].values()),
            "errors": rec_by_model[m]["errors"],
            "p99_ms": None if not lat else round(
                loadgen.percentile(lat, 99) * 1000.0, 3),
        }
    return {"scenario": "hot_model_skew", "hot_model": hot,
            "hot_fraction": hot_fraction, "per_model": per_model,
            **{k: rec[k] for k in ("requests", "completed", "errors",
                                   "requests_per_sec", "p50_ms",
                                   "p99_ms") if k in rec}}


def scenario_slow_client_storm(submit, make_request, *, n_clients=24,
                               requests_per_client=8,
                               think_time_s=0.01, seed=0,
                               timeout_s=120.0, hedged_submit=None,
                               hedge_stats=None):
    """A storm of CLOSED-LOOP clients that block on each response and
    think before the next request — the slow-client population an
    open loop cannot model (loadgen.run_closed_loop). Records
    rps/p50/p99 + error classes.

    hedged_submit: optional second submit callable with tail-latency
    hedging armed (FleetRouter.set_hedge) — the SAME seeded storm
    reruns through it and the record gains a ``hedged`` sub-record
    with the hedge fire-rate and the p99 delta (negative = hedging
    won).
    hedge_stats: zero-arg callable returning the cumulative
    hedges-fired count (e.g. the dl4j_fleet_hedges_total child's
    ``.value``) so the scenario can report the fire-rate."""
    rec = loadgen.run_closed_loop(
        submit, make_request, n_clients=n_clients,
        requests_per_client=requests_per_client,
        think_time_s=think_time_s, seed=seed, timeout_s=timeout_s)
    out = dict(rec, scenario="slow_client_storm")
    if hedged_submit is not None:
        fired0 = hedge_stats() if hedge_stats is not None else None
        hrec = loadgen.run_closed_loop(
            hedged_submit, make_request, n_clients=n_clients,
            requests_per_client=requests_per_client,
            think_time_s=think_time_s, seed=seed, timeout_s=timeout_s)
        hedged = {k: hrec[k] for k in ("requests", "completed",
                                       "errors", "requests_per_sec",
                                       "p50_ms", "p99_ms")
                  if k in hrec}
        if fired0 is not None:
            fired = hedge_stats() - fired0
            hedged["hedges_fired"] = int(fired)
            hedged["hedge_rate"] = round(
                fired / max(1, hrec.get("requests", 0)), 4)
        if "p99_ms" in hrec and "p99_ms" in rec:
            hedged["p99_delta_ms"] = round(
                hrec["p99_ms"] - rec["p99_ms"], 3)
        out["hedged"] = hedged
    return out
