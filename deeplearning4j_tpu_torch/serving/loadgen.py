"""Load generators for the serving tier: open loop AND closed loop.

A copy of ``deeplearning4j_tpu/serving/loadgen.py``.

Open-loop means arrivals are scheduled by an external clock,
independent of completions — the honest way to measure a server
(a closed loop throttles itself to the server's pace and hides
queueing collapse). Inter-arrival gaps are exponential (Poisson
process) drawn from a SEEDED rng, so a run is reproducible; per-request
latency is measured from the SCHEDULED arrival (so pacer slip and
queueing both count against the server, the open-loop convention).

``run_closed_loop`` models the population an open loop cannot: clients
that BLOCK on each response (and optionally think before the next
request) — the slow-client storm of serving/fleet.py's scenarios.
Closed-loop latency runs submit→completion per request, and think
times are seeded jitter so a storm replays exactly.

Both record per-ERROR-CLASS counts (exception type name -> count) in
the summarize() record: requests/sec sustained, p50/p99 latency and
error classes, beside which a caller puts the dispatcher's
batch-occupancy histogram.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.runtime import telemetry

__all__ = ["arrival_offsets", "percentile", "summarize",
           "run_open_loop", "run_closed_loop"]


def arrival_offsets(rate, n, seed=0):
    """n Poisson-process arrival offsets (seconds from t0) at `rate`
    requests/sec: cumulative sum of seeded exponential gaps."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / float(rate), int(n)))


def percentile(values, q):
    """Linear-interpolated percentile (q in [0, 100]) of a sequence: the
    one implementation the telemetry histograms read out through
    (runtime.telemetry.percentile, numpy's default 'linear' method)."""
    return telemetry.percentile(values, q)


def summarize(latencies_s, duration_s, errors=None, scheduled=None):
    """Reduce per-request latencies to the serving record: sustained
    requests/sec (completed / wall duration) + latency percentiles in
    ms + error counts by type."""
    lat = np.asarray(sorted(latencies_s), np.float64)
    n_err = sum((errors or {}).values())
    rec = {
        "requests": int(len(lat) + n_err if scheduled is None
                        else scheduled),
        "completed": int(len(lat)),
        "errors": dict(errors or {}),
        "duration_s": round(float(duration_s), 4),
        "requests_per_sec": round(len(lat) / duration_s, 2)
        if duration_s > 0 else None,
    }
    if len(lat):
        rec.update(
            p50_ms=round(percentile(lat, 50) * 1000.0, 3),
            p99_ms=round(percentile(lat, 99) * 1000.0, 3),
            mean_ms=round(float(lat.mean()) * 1000.0, 3),
            max_ms=round(float(lat.max()) * 1000.0, 3),
        )
    return rec


def run_open_loop(submit, make_request, *, rate, n_requests, seed=0,
                  max_clients=16, timeout_s=120.0, clock=time.monotonic,
                  sleep=time.sleep):
    """Drive `submit` (callable(features) -> result, raising on
    failure) with `n_requests` Poisson arrivals at `rate` req/s.

    make_request: i -> features array for request i (seed your own rng
    so the workload is reproducible).
    A pool of `max_clients` persistent client threads consumes the
    arrival schedule — the bounded concurrent-clients population of a
    real front-end (a "limited open loop": admission is bounded, but
    latency for request i still runs from its SCHEDULED arrival to
    completion, so falling behind the schedule shows up as queueing
    latency, never as a silently slower arrival rate). A request that
    raises is counted by exception type in the summarize() record.
    """
    offsets = arrival_offsets(rate, n_requests, seed=seed)
    lat = [None] * n_requests
    errors = {}
    state_lock = threading.Lock()
    next_i = [0]
    t0 = [None]

    def client():  # fault-ok[FLT02]: the load generator is the traffic source; faults are injected at the serving seams it drives
        while True:
            with state_lock:
                i = next_i[0]
                if i >= n_requests:
                    return
                next_i[0] = i + 1
            sched_abs = t0[0] + offsets[i]
            delay = sched_abs - clock()
            if delay > 0:
                sleep(delay)
            try:
                submit(make_request(i))
                lat[i] = clock() - sched_abs
            except Exception as e:
                with state_lock:
                    key = type(e).__name__
                    errors[key] = errors.get(key, 0) + 1

    workers = [threading.Thread(target=client, daemon=True)
               for _ in range(min(int(max_clients), int(n_requests)))]
    t0[0] = clock()
    for w in workers:
        w.start()
    deadline = clock() + timeout_s
    for w in workers:
        w.join(timeout=max(0.0, deadline - clock()))
    duration = clock() - t0[0]
    # one consistent snapshot: abandoned = whatever is neither a
    # completed latency sample nor a counted error, so
    # completed + errors == scheduled even if a straggler finishes
    # between the join timeout and this accounting
    done = [v for v in lat if v is not None]
    with state_lock:
        errs = dict(errors)
    missing = n_requests - len(done) - sum(errs.values())
    if missing > 0:
        errs["TimeoutAbandoned"] = missing
    return summarize(done, duration, errors=errs,
                     scheduled=n_requests)


def run_closed_loop(submit, make_request, *, n_clients,
                    requests_per_client, think_time_s=0.0, seed=0,
                    timeout_s=120.0, clock=time.monotonic,
                    sleep=time.sleep):
    """Drive `submit` with `n_clients` CLOSED-LOOP clients: each sends
    one request, BLOCKS on the response, thinks, repeats — the
    self-throttling population (slow clients holding results) an open
    loop cannot model, and the load shape of the fleet's slow-client
    storm scenario (serving/fleet.py).

    make_request: (client, i) -> features for that client's i-th
    request. think_time_s: mean think pause between a response and the
    next request, drawn as SEEDED exponential jitter per client so a
    storm replays exactly (0 = a tight closed loop). Latency is
    submit→completion (the closed-loop convention — there is no
    external schedule to slip against); a request that raises is
    counted by exception type and the client moves on. The record is
    summarize() plus ``mode``/``clients`` fields.
    """
    n_clients = int(n_clients)
    per = int(requests_per_client)
    lat = []
    errors = {}
    state_lock = threading.Lock()

    def client(c):  # fault-ok[FLT02]: traffic source, not a served boundary: the submit() it calls crosses the real seams
        rng = np.random.RandomState(seed + c)
        for i in range(per):
            t0 = clock()
            try:
                x = make_request(c, i)
                submit(x)
                done = clock() - t0
                with state_lock:
                    lat.append(done)
            except Exception as e:
                with state_lock:
                    key = type(e).__name__
                    errors[key] = errors.get(key, 0) + 1
            if think_time_s > 0:
                sleep(float(rng.exponential(think_time_s)))

    workers = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    t0 = clock()
    for w in workers:
        w.start()
    deadline = clock() + timeout_s
    for w in workers:
        w.join(timeout=max(0.0, deadline - clock()))
    duration = clock() - t0
    with state_lock:
        done, errs = list(lat), dict(errors)
    scheduled = n_clients * per
    missing = scheduled - len(done) - sum(errs.values())
    if missing > 0:
        errs["TimeoutAbandoned"] = missing
    rec = summarize(done, duration, errors=errs, scheduled=scheduled)
    rec["mode"] = "closed"
    rec["clients"] = n_clients
    rec["think_time_s"] = float(think_time_s)
    return rec
