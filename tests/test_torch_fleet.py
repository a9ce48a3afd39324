"""The port's serving fleet (deeplearning4j_tpu_torch/serving/fleet.py over
the port's ModelHost): the reference's tests/test_fleet.py case by case
on the CPU. Zero request-path compiles become zero cold dispatches
(``ParallelInference.cold_dispatches`` of every version on every
replica) and the warm report's "warm" status for a swapped-in version of
the same shape. The scenarios' records are checked against the
reference's on the same seeded schedule where the schedule alone fixes
them (the hot-model split).
"""

import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import (
    FleetRouter, ModelHost, ModelSLO, QueueFullError, loadgen,
)
from deeplearning4j_tpu_torch.serving.fleet import (
    scenario_diurnal_ramp, scenario_hot_model_skew,
    scenario_slow_client_storm,
)

torch.set_num_threads(1)


def _mln(seed=7, nout=16):
    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Nesterovs(0.1, 0.9)).list()
            .layer(P.DenseLayer(nOut=nout, activation="relu"))
            .layer(P.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.feedForward(8)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _scaled(net, factor):
    with torch.no_grad():
        for p in net._params:
            for t in p.values():
                t.mul_(factor)
    return net


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


def _fleet(n_replicas, net, **kw):
    kw.setdefault("batchBuckets", (8,))
    kw.setdefault("maxWaitMs", 1.0)
    fleet = FleetRouter()
    rids = [fleet.add_replica(ModelHost()) for _ in range(n_replicas)]
    fleet.register("m", net, **kw)
    return fleet, rids


def _until(cond, timeout=10):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


def _wedge(batcher):
    """Hold `batcher`'s dispatches until the returned event is set;
    the second event is set once a dispatch is held."""
    orig = batcher._dispatch
    release, entered = threading.Event(), threading.Event()

    def held(f):
        entered.set()
        release.wait(30)
        return orig(f)

    batcher._dispatch = held
    return release, entered


class TestModelSLO:
    def test_validation_and_dict(self):
        slo = ModelSLO(p99_ms=50, queue_high=8, queue_low=1,
                       min_replicas=2, max_replicas=6)
        assert slo.as_dict() == {"p99_ms": 50.0, "queue_high": 8.0,
                                 "queue_low": 1.0, "min_replicas": 2,
                                 "max_replicas": 6}
        with pytest.raises(ValueError, match="scale-down band"):
            ModelSLO(queue_high=1.0, queue_low=4.0)


class TestFleetRouting:
    def test_replica_lifecycle_errors(self):
        fleet = FleetRouter()
        rid = fleet.add_replica(ModelHost(), replica_id="a")
        with pytest.raises(ValueError, match="already attached"):
            fleet.add_replica(ModelHost(), replica_id="a")
        with pytest.raises(KeyError, match="unknown replica"):
            fleet.remove_replica("ghost")
        with pytest.raises(KeyError, match="no replica serves"):
            fleet.submit("nope", _rows(1))
        fleet.remove_replica(rid)
        assert fleet.replica_ids() == []
        fleet.close()

    def test_least_loaded_dispatch_avoids_wedged_replica(self):
        fleet, (ra, rb) = _fleet(2, _mln(), queueLimit=8)
        release = threading.Event()
        try:
            hosts = dict(fleet._hosts())
            release, entered = _wedge(hosts[ra].model("m").batcher)
            for _ in range(2):
                threading.Thread(
                    target=lambda: hosts[ra].submit("m", _rows(1)),
                    daemon=True).start()
            assert _until(lambda: fleet._queued_work(hosts[ra], "m") >= 2)
            out = fleet.submit("m", _rows(2, seed=3))
            assert np.asarray(out).shape == (2, 4)
            # the per-instance occupancy record (the registry's serving
            # counters are labeled by model, so they sum over replicas)
            assert hosts[rb].model("m").batcher.occupancy == [(2, 8)]
            assert fleet._queued_work(hosts[ra], "m") == 2
        finally:
            release.set()
            fleet.close()

    def test_wedged_dispatch_still_counts_as_outstanding(self):
        fleet, (ra,) = _fleet(1, _mln(), queueLimit=8)
        release = threading.Event()
        try:
            host = dict(fleet._hosts())[ra]
            b = host.model("m").batcher
            release, entered = _wedge(b)
            threading.Thread(target=lambda: host.submit("m", _rows(1)),
                             daemon=True).start()
            assert entered.wait(20)
            assert b.depth == 0 and b.outstanding == 1
            assert host.queued_work("m") == 1
            release.set()
            assert _until(lambda: host.queued_work("m") == 0)
        finally:
            release.set()
            fleet.close()

    def test_failover_on_full_queue_then_fleet_wide_429(self):
        fleet, (ra, rb) = _fleet(2, _mln(), queueLimit=1)
        releases = []
        try:
            hosts = dict(fleet._hosts())
            for rid in (ra, rb):
                b = hosts[rid].model("m").batcher
                release, entered = _wedge(b)
                releases.append(release)
                threading.Thread(
                    target=lambda h=hosts[rid]: h.submit("m", _rows(1)),
                    daemon=True).start()
                assert entered.wait(20)
                threading.Thread(
                    target=lambda h=hosts[rid]: h.submit("m", _rows(1)),
                    daemon=True).start()
                assert _until(lambda b=b: b.depth == 1)
            lab = fleet._m_failover.labels(model="m",
                                           error="QueueFullError")
            before = lab.value
            with pytest.raises(QueueFullError):
                fleet.submit("m", _rows(1, seed=9))
            assert lab.value == before + 1
            assert all(fleet.health(r).breaker.state == "closed"
                       for r in (ra, rb))   # load is not a fault
        finally:
            for ev in releases:
                ev.set()
            fleet.close()


class TestFleetRollingSwap:
    def test_swap_all_zero_errors_zero_cold_dispatches_under_load(self):
        net1, net2 = _mln(), _scaled(_mln(), 1.5)
        o1 = ParallelInference(net1, batchBuckets=(8,))
        o2 = ParallelInference(net2, batchBuckets=(8,))
        n_threads, n_each = 3, 16
        feats = {(t, i): _rows(1 + (t + i) % 4, seed=50 + t * 100 + i)
                 for t in range(n_threads) for i in range(n_each)}
        want1 = {k: o1.output(v).toNumpy() for k, v in feats.items()}
        want2 = {k: o2.output(v).toNumpy() for k, v in feats.items()}
        fleet, _ = _fleet(2, net1, queueLimit=256)
        olds = [h.model("m") for _, h in fleet._hosts()]
        failures, versions = [], set()
        swap_at = threading.Event()

        def client(t):
            for i in range(n_each):
                if t == 0 and i == 3:
                    swap_at.set()
                k = (t, i)
                try:
                    got = np.asarray(fleet.submit("m", feats[k]))
                except Exception as e:
                    failures.append((k, repr(e)))
                    continue
                if np.array_equal(got, want1[k]):
                    versions.add(1)
                elif np.array_equal(got, want2[k]):
                    versions.add(2)
                else:
                    failures.append((k, "matches NEITHER version"))

        try:
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            assert swap_at.wait(30)
            rep = fleet.swap_all("m", net2)
            for t in ts:
                t.join(timeout=60)
            news = [h.model("m") for _, h in fleet._hosts()]
            assert not failures, failures[:5]
            assert {r["version"] for r in rep.values()} == {2}
            assert all({b: d["status"] for b, d in r["warm"].items()}
                       == {8: "warm"} for r in rep.values())
            assert sum(sm.pi.cold_dispatches for sm in olds + news) == 0
            assert 2 in versions
        finally:
            fleet.close()

    def test_swap_all_covers_sequence_models(self):
        def rnn(seed=3):
            conf = (P.NeuralNetConfiguration.Builder().seed(seed)
                    .updater(P.Nesterovs(0.1, 0.9)).list()
                    .layer(P.LSTM(nOut=6))
                    .layer(P.RnnOutputLayer(nOut=3, activation="softmax",
                                            lossFunction="mcxent"))
                    .setInputType(P.InputType.recurrent(4, 5)).build())
            return P.MultiLayerNetwork(conf, device="cpu").init()

        net1, net2 = rnn(), _scaled(rnn(), 1.5)
        fleet = FleetRouter()
        for _ in range(2):
            fleet.add_replica(ModelHost())
        try:
            fleet.register_sequence("seq", net1, slotBuckets=(2,))
            assert {h.kind("seq") for _, h in fleet._hosts()} \
                == {"sequence"}
            feats = np.random.RandomState(5).randn(3, 4).astype(
                np.float32)
            before = np.asarray(fleet.submit_sequence("seq", feats))
            rep = fleet.swap_all("seq", net2)
            after = np.asarray(fleet.submit_sequence("seq", feats))
            assert {r["version"] for r in rep.values()} == {2}
            assert after.shape == before.shape == (3, 3)
            assert not np.array_equal(before, after)
            with pytest.raises(KeyError, match="register it fleet-wide"):
                fleet.swap_all("ghost", net2)
        finally:
            fleet.close()


class TestAutoscale:
    def test_queue_depth_scale_up_then_idle_scale_down(self):
        fleet, (ra, rb) = _fleet(2, _mln(), queueLimit=64)
        releases = []
        try:
            fleet.set_slo("m", queue_high=2.0, queue_low=0.5,
                          min_replicas=1, max_replicas=4)
            seen = []
            fleet.on_scale(seen.append)
            hosts = dict(fleet._hosts())
            for rid in (ra, rb):
                b = hosts[rid].model("m").batcher
                release, _ = _wedge(b)
                releases.append(release)
                for j in range(6):
                    b.submit(_rows(1, seed=j), wait=False)
            assert _until(lambda: all(
                fleet._queued_work(h, "m") == 6 for h in hosts.values()))
            up = [d for d in fleet.autoscale_tick() if d["model"] == "m"][0]
            assert up["action"] == "scale_up"
            assert up["desired_replicas"] == 3
            assert up["mean_queued_work"] == 6.0
            assert any("queue_high" in r for r in up["reasons"])
            assert seen and seen[-1]["action"] == "scale_up"
            for ev in releases:
                ev.set()
            assert _until(lambda: not any(
                fleet._queued_work(h, "m") for _, h in fleet._hosts()),
                timeout=20)
            down = [d for d in fleet.autoscale_tick()
                    if d["model"] == "m"][0]
            assert down["action"] == "scale_down"
            assert down["desired_replicas"] == 1
        finally:
            for ev in releases:
                ev.set()
            fleet.close()

    def test_p99_slo_votes_scale_up_and_hold_not_dispatched(self):
        fleet, _ = _fleet(1, _mln())
        try:
            fleet.set_slo("m", p99_ms=0.0001, queue_high=1e9,
                          queue_low=-1.0, max_replicas=3)
            seen = []
            fleet.on_scale(seen.append)
            for i in range(4):
                fleet.submit("m", _rows(1, seed=i))
            d = [x for x in fleet.autoscale_tick() if x["model"] == "m"][0]
            assert d["action"] == "scale_up"
            assert any("p99" in r for r in d["reasons"])
            fleet.set_slo("m", p99_ms=None, queue_high=1e9,
                          queue_low=-1.0)
            seen.clear()
            d = [x for x in fleet.autoscale_tick() if x["model"] == "m"][0]
            assert d["action"] == "hold" and not seen
        finally:
            fleet.close()

    def test_replica_bounds_outrank_the_votes(self):
        fleet, _ = _fleet(2, _mln())
        try:
            fleet.set_slo("m", queue_high=1e9, queue_low=-1.0,
                          min_replicas=3, max_replicas=4)
            d = [x for x in fleet.autoscale_tick() if x["model"] == "m"][0]
            assert d["action"] == "scale_up" and d["desired_replicas"] == 3
            assert d["reasons"][0].startswith("replica bound")
        finally:
            fleet.close()


class TestFleetObservability:
    def test_snapshot_additive_schema(self):
        fleet, (ra, rb) = _fleet(2, _mln())
        try:
            fleet.submit("m", _rows(2, seed=1))
            snap = fleet.metrics_snapshot()
            assert set(snap) == {"registry", "replicas", "models", "slos"}
            assert set(snap["replicas"]) == {ra, rb}
            for view in snap["replicas"].values():
                assert set(view) == {"queue_depth", "models", "sequences"}
                assert set(view["models"]["m"]) == {
                    "version", "stats", "queue_depth", "occupancy"}
            agg = snap["models"]["m"]
            assert agg["kind"] == "oneshot" and agg["replicas"] == 2
            assert "dl4j_fleet_requests_total" in snap["registry"]
        finally:
            fleet.close()


class TestClosedLoopLoadgen:
    def test_closed_loop_counts_and_error_classes(self):
        calls = []

        def submit(x):
            calls.append(x)
            if int(x[0, 0]) % 3 == 0:
                raise QueueFullError("full")

        rec = loadgen.run_closed_loop(
            submit, lambda c, i: np.full((1, 1), c * 100 + i, np.float32),
            n_clients=3, requests_per_client=6, think_time_s=0.0, seed=0)
        assert rec["mode"] == "closed" and rec["clients"] == 3
        assert rec["requests"] == 18
        assert rec["completed"] + sum(rec["errors"].values()) == 18
        assert rec["errors"] == {"QueueFullError": 6}
        assert len(calls) == 18

    def test_closed_loop_blocks_on_response(self):
        in_flight, peak = [0], [0]
        lock = threading.Lock()

        def submit(x):
            with lock:
                in_flight[0] += 1
                peak[0] = max(peak[0], in_flight[0])
            time.sleep(0.002)
            with lock:
                in_flight[0] -= 1

        rec = loadgen.run_closed_loop(
            submit, lambda c, i: np.zeros((1, 1), np.float32),
            n_clients=2, requests_per_client=5, think_time_s=0.0, seed=1)
        assert rec["completed"] == 10
        assert peak[0] <= 2

    def test_seeded_think_time_reproducible_and_the_references(self):
        from deeplearning4j_tpu.serving import loadgen as ref

        sleeps = []
        for lg in (loadgen, loadgen, ref):
            sink = []
            lg.run_closed_loop(
                lambda x: None, lambda c, i: np.zeros((1, 1), np.float32),
                n_clients=2, requests_per_client=3, think_time_s=0.01,
                seed=5, sleep=sink.append)
            sleeps.append(sorted(sink))
        assert sleeps[0] == sleeps[1] == sleeps[2]
        assert len(sleeps[0]) == 6


class TestScenarios:
    def test_slow_client_storm_record(self):
        fleet, _ = _fleet(2, _mln(), queueLimit=128)
        try:
            rec = scenario_slow_client_storm(
                lambda x: fleet.submit("m", x),
                lambda c, i: _rows(1, seed=c * 10 + i),
                n_clients=6, requests_per_client=3, think_time_s=0.0,
                seed=2)
            assert rec["scenario"] == "slow_client_storm"
            assert rec["completed"] == 18 and rec["errors"] == {}
            assert rec["p99_ms"] is not None
        finally:
            fleet.close()

    def test_slow_client_storm_hedged_rerun(self):
        fleet, _ = _fleet(2, _mln(), queueLimit=128)
        try:
            hedges = fleet._m_hedges.labels(model="m")
            armed = []

            def hedged_submit(x):
                if not armed:
                    fleet.set_hedge("m", after_s=10.0)
                    armed.append(1)
                return fleet.submit("m", x)

            rec = scenario_slow_client_storm(
                lambda x: fleet.submit("m", x),
                lambda c, i: _rows(1, seed=c * 10 + i),
                n_clients=4, requests_per_client=3, think_time_s=0.0,
                seed=2, hedged_submit=hedged_submit,
                hedge_stats=lambda: hedges.value)
            h = rec["hedged"]
            assert h["completed"] == 12 and h["errors"] == {}
            assert h["hedges_fired"] == 0 and h["hedge_rate"] == 0.0
            assert isinstance(h["p99_delta_ms"], float)
        finally:
            fleet.close()

    def test_diurnal_ramp_phases_and_error_classes(self):
        fails = [0]
        lock = threading.Lock()

        def submit(x):
            with lock:
                fails[0] += 1
                n = fails[0]
            if n % 5 == 0:
                raise QueueFullError("full")

        rec = scenario_diurnal_ramp(
            submit, lambda i: _rows(1, seed=i), base_rate=200.0,
            peak_rate=800.0, phases=3, requests_per_phase=10, seed=3)
        assert rec["scenario"] == "diurnal_ramp"
        assert [p["rate_rps"] for p in rec["phases"]] == [200.0, 800.0,
                                                          200.0]
        assert rec["errors"] == {"QueueFullError": 6}
        assert rec["completed"] + sum(rec["errors"].values()) == 30
        with pytest.raises(ValueError, match=">= 3 phases"):
            scenario_diurnal_ramp(submit, lambda i: None, base_rate=1.0,
                                  peak_rate=2.0, phases=2)

    def test_hot_model_skew_split_matches_the_reference(self):
        from deeplearning4j_tpu.serving.fleet import \
            scenario_hot_model_skew as ref_skew

        net = _mln()
        fleet = FleetRouter([ModelHost()])
        try:
            fleet.register("hot", net, batchBuckets=(8,))
            fleet.register("cold", net, batchBuckets=(8,))
            kw = dict(models=["hot", "cold"], hot_fraction=0.8,
                      rate=500.0, n_requests=40, seed=4)
            rec = scenario_hot_model_skew(
                lambda n: (lambda x: fleet.submit(n, x)),
                lambda i: _rows(1, seed=i), **kw)
            want = ref_skew(lambda n: (lambda x: None), lambda i: None,
                            **kw)
            assert rec["scenario"] == "hot_model_skew"
            assert rec["hot_model"] == "hot"
            split = {m: v["requests"] for m, v in rec["per_model"].items()}
            assert split == {m: v["requests"]
                             for m, v in want["per_model"].items()}
            assert split["hot"] + split["cold"] == 40
            assert split["hot"] > split["cold"]
            assert rec["completed"] == 40
            with pytest.raises(ValueError, match=">= 2 models"):
                scenario_hot_model_skew(
                    lambda n: (lambda x: None), lambda i: None,
                    models=["one"])
        finally:
            fleet.close()
