"""The port's chaos harness and the fleet's failure domains
(deeplearning4j_tpu_torch/runtime/chaos.py, serving/breaker.py,
serving/fleet.py): the reference's tests/test_chaos.py (its plan, fault
kinds, breaker, health, budget, brownout, fleet and soak cases) on the
CPU, with the seeded schedules held equal to the reference's.

Where the reference times the CPU (the armed-but-quiet harness within
3 % of the disarmed path), the port asserts what makes that hold: an
armed plan with no rule for a seam neither counts nor fires there, and
the answers are bitwise the disarmed ones. Zero steady-state compiles
become zero cold dispatches. Nothing here sleeps for a wedge or a slow
fault: the plans take an injected sleep or a release event.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.runtime.chaos import ChaosPlan as RefChaosPlan
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.runtime import chaos
from deeplearning4j_tpu_torch.runtime.chaos import (
    ChaosError, ChaosPlan, fault_point,
)
from deeplearning4j_tpu_torch.serving import (
    BrownoutController, CircuitBreaker, DeadlineExceededError,
    FleetRouter, ManualClock, ModelHost, ReplicaHealth, RetryBudget,
)

pytestmark = pytest.mark.faults

torch.set_num_threads(1)

# a seam with a string payload, as the reference's aot.disk_read
_DISK = chaos.register_seam("test.disk_read")


def _mln(seed=7, nout=16):
    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Nesterovs(0.1, 0.9)).list()
            .layer(P.DenseLayer(nOut=nout, activation="relu"))
            .layer(P.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.feedForward(8)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


@pytest.fixture(autouse=True)
def _always_disarmed():
    """No test may leak an armed plan into the next."""
    chaos.disarm()
    yield
    chaos.disarm()


def _fleet(n_replicas, net, *, router_kw=None, **kw):
    kw.setdefault("batchBuckets", (8,))
    kw.setdefault("maxWaitMs", 1.0)
    fleet = FleetRouter(**(router_kw or {}))
    rids = [fleet.add_replica(ModelHost()) for _ in range(n_replicas)]
    fleet.register("m", net, **kw)
    return fleet, rids


def _count_dispatches(hosts, name="m"):
    """Per-replica dispatch counts (the serving counters are labeled by
    model and sum over replicas): each replica's batcher dispatch is
    wrapped."""
    hits = {}
    for rid, host in hosts.items():
        hits[rid] = 0
        b = host.model(name).batcher

        def counted(feats, _rid=rid, _orig=b._dispatch):
            hits[_rid] += 1
            return _orig(feats)

        b._dispatch = counted
    return hits


def _cold(fleet, name="m"):
    return sum(h.model(name).pi.cold_dispatches for _, h in fleet._hosts())


# ----------------------------------------------------------------------
# ChaosPlan: determinism + fault kinds
# ----------------------------------------------------------------------
class TestChaosPlanDeterminism:
    def _drive(self, plan, n=40):
        with plan:
            for i in range(n):
                seam = "fleet.dispatch" if i % 2 else "queue.dispatch"
                try:
                    fault_point(seam, payload=i)
                except ChaosError:
                    pass
        return list(plan.events)

    @staticmethod
    def _plan(seed, cls=ChaosPlan):
        return (cls(seed=seed, sleep=lambda s: None)
                .random_raises("fleet.dispatch", rate=0.3, window=20)
                .random_slows("queue.dispatch", rate=0.3, window=20,
                              seconds=0.01)
                .raise_n("queue.dispatch", at=1))

    def test_same_seed_same_traffic_identical_fault_sequence(self):
        ev_a = self._drive(self._plan(seed=5))
        ev_b = self._drive(self._plan(seed=5))
        assert ev_a == ev_b
        assert ev_a, "the seeded plan must actually fire"
        assert all(len(e) == 3 for e in ev_a)

    def test_different_seed_different_schedule(self):
        scheds = {json.dumps(self._plan(seed=s).schedule(),
                             sort_keys=True) for s in range(6)}
        assert len(scheds) > 1

    @pytest.mark.parametrize("seed", [0, 9, 11])
    def test_schedule_fixed_before_arming_equals_the_references(self,
                                                                 seed):
        a = self._plan(seed=seed).schedule()
        assert a == self._plan(seed=seed).schedule()
        assert a == self._plan(seed=seed, cls=RefChaosPlan).schedule()

    def test_disarmed_is_identity_and_armed_skips_ruleless_seams(self):
        payload = object()
        assert fault_point("fleet.dispatch", payload) is payload
        plan = ChaosPlan(seed=0).raise_n("queue.dispatch", at=0)
        with plan:
            assert fault_point("fleet.dispatch", payload) is payload
            with pytest.raises(ChaosError):
                fault_point("queue.dispatch")
        assert plan.fired("fleet.dispatch") == 0
        assert plan.fired("queue.dispatch") == 1
        assert plan._counts == {"queue.dispatch": 1}
        assert chaos.armed_plan() is None

    def test_arm_disarm_roundtrip_and_unknown_seam_rejected(self):
        plan = ChaosPlan()
        assert chaos.arm(plan) is plan
        assert chaos.armed_plan() is plan
        assert chaos.disarm() is plan
        assert chaos.disarm() is None
        with pytest.raises(ValueError, match="unknown seam"):
            chaos.arm(ChaosPlan().raise_n("fleet.dispach"))
        assert {"host.submit", "queue.dispatch", "fleet.dispatch",
                _DISK} <= set(chaos.registered_seams())

    def test_unknown_kind_and_empty_rule(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            ChaosPlan()._add("queue.dispatch", "melt", [0])
        plan = ChaosPlan().raise_n("queue.dispatch", times=0)
        assert plan.schedule() == {}


class TestFaultKinds:
    def test_raise_n_exact_ordinals_and_custom_exc(self):
        class Boom(OSError):
            pass

        plan = ChaosPlan().raise_n(_DISK, times=2, at=1, exc=Boom,
                                   message="disk gone")
        with plan:
            fault_point(_DISK)
            for _ in range(2):
                with pytest.raises(Boom, match="disk gone"):
                    fault_point(_DISK)
            fault_point(_DISK)
        assert plan.events == [(_DISK, "raise", 1), (_DISK, "raise", 2)]

    def test_slow_and_wedge_use_injected_sleep(self):
        slept = []
        plan = (ChaosPlan(sleep=slept.append)
                .slow("queue.dispatch", 0.25, at=0)
                .wedge("queue.dispatch", 7.0, at=1))
        with plan:
            fault_point("queue.dispatch")
            fault_point("queue.dispatch")
        assert slept == [0.25, 7.0]

    def test_wedge_release_event_unblocks(self):
        release = threading.Event()
        release.set()
        plan = ChaosPlan().wedge("sequence.step", 60.0, at=0,
                                 release=release)
        t0 = time.monotonic()
        with plan:
            fault_point("sequence.step")
        assert time.monotonic() - t0 < 5.0
        assert plan.events == [("sequence.step", "wedge", 0)]

    def test_corrupt_default_and_custom_mutate(self):
        plan = (ChaosPlan()
                .corrupt("host.submit", at=0)
                .corrupt(_DISK, at=0)
                .corrupt("server.request", at=0, mutate=lambda p: p * 10)
                .corrupt("fleet.dispatch", at=0))
        with plan:
            arr = fault_point("host.submit", np.ones(4, dtype=np.float32))
            path = fault_point(_DISK, "/x.bin")
            n = fault_point("server.request", 4)
            ints = fault_point("fleet.dispatch", np.zeros(3, np.int32))
        assert np.isnan(arr[0]) and not np.isnan(arr[1:]).any()
        assert path == "/x.bin.chaos-corrupt"
        assert n == 40
        assert ints[0] == np.iinfo(np.int32).max and not ints[1:].any()

    def test_default_corrupt_equals_the_references(self):
        from deeplearning4j_tpu.runtime.chaos import \
            default_corrupt as ref

        for payload in (np.arange(5, dtype=np.float64), np.ones(2, np.int8),
                        "a/b", b"\x01\x02", b"", 7):
            got, want = chaos.default_corrupt(payload), ref(payload)
            if isinstance(got, np.ndarray):
                np.testing.assert_array_equal(got, want)
            else:
                assert got == want

    def test_fired_counts_reach_telemetry(self):
        from deeplearning4j_tpu_torch.runtime import telemetry

        child = telemetry.get_registry().counter(
            "dl4j_chaos_injections_total",
            "chaos faults fired, by seam and kind",
            labels=("seam", "kind")).labels(seam="server.request",
                                            kind="raise")
        before = child.value
        plan = ChaosPlan().raise_n("server.request", times=3)
        with plan:
            for _ in range(3):
                with pytest.raises(ChaosError):
                    fault_point("server.request")
        assert child.value == before + 3
        assert plan.fired() == 3


# ----------------------------------------------------------------------
# breaker / quarantine / budget / brownout (pure units, ManualClock)
# ----------------------------------------------------------------------
class TestCircuitBreaker:
    def test_exact_manualclock_transitions(self):
        clk = ManualClock()
        br = CircuitBreaker(window=8, failure_ratio=0.5, min_samples=4,
                            open_for_s=10.0, close_after=2, clock=clk)
        assert br.record(False) == "closed"
        assert br.record(False) == "closed"
        assert br.record(True) == "closed"
        assert br.record(False) == "open"
        assert br.opened_total == 1 and not br.allow()
        clk.advance(9.999)
        assert br.state == "open"
        clk.advance(0.001)
        assert br.state == "half_open"
        assert br.allow()
        assert br.record(True) == "half_open"
        assert br.record(True) == "closed"
        assert br.snapshot()["window"] == []

    def test_half_open_failure_retrips_immediately(self):
        clk = ManualClock()
        br = CircuitBreaker(window=4, failure_ratio=0.5, min_samples=2,
                            open_for_s=5.0, close_after=2, clock=clk)
        br.record(False), br.record(False)
        assert br.state == "open"
        clk.advance(5.0)
        assert br.record(False) == "open"
        assert br.opened_total == 2
        clk.advance(4.999)
        assert br.state == "open"

    def test_successes_never_trip(self):
        br = CircuitBreaker(window=4, min_samples=1, clock=ManualClock())
        for _ in range(50):
            assert br.record(True) == "closed"

    @pytest.mark.parametrize("ratio", [0.0, 1.5])
    def test_failure_ratio_validated(self, ratio):
        with pytest.raises(ValueError, match="failure_ratio"):
            CircuitBreaker(failure_ratio=ratio)


class TestReplicaHealthQuarantine:
    def test_readmission_after_exact_probe_streak(self):
        h = ReplicaHealth(readmit_after=3, clock=ManualClock())
        assert h.admissible()
        h.quarantine()
        assert h.quarantined and not h.admissible()
        assert h.note_probe(True) is False
        assert h.note_probe(True) is False
        assert h.note_probe(False) is False
        for _ in range(2):
            assert h.note_probe(True) is False
        assert h.note_probe(True) is True
        assert not h.quarantined and h.admissible()
        assert h.breaker.state == "closed"

    def test_probe_ignored_when_not_quarantined(self):
        h = ReplicaHealth(readmit_after=1, clock=ManualClock())
        assert h.note_probe(True) is False


class TestRetryBudget:
    def test_burst_then_ratio_cap(self):
        b = RetryBudget(ratio=0.5, burst=2.0)
        assert b.try_spend() and b.try_spend()
        assert not b.try_spend()
        b.note_request()
        assert not b.try_spend()
        b.note_request()
        assert b.try_spend()
        snap = b.snapshot()
        assert snap["spent"] == 3 and snap["denied"] == 2
        assert snap["requests"] == 2

    def test_deposits_capped_at_burst(self):
        b = RetryBudget(ratio=1.0, burst=1.0)
        for _ in range(100):
            b.note_request()
        assert b.try_spend()
        assert not b.try_spend()


class TestBrownout:
    def test_sheds_only_hopeless_deadlines(self):
        bo = BrownoutController(est_item_s=0.1)
        assert not bo.should_shed(4, deadline_s=0.5)
        assert bo.should_shed(6, deadline_s=0.5)
        assert not bo.should_shed(1000, deadline_s=None)
        assert bo.snapshot() == {"shed": 1, "admitted": 2,
                                 "est_item_s": 0.1, "margin": 1.0}

    def test_no_estimate_never_sheds(self):
        bo = BrownoutController()
        assert bo.estimate_wait_s(10) is None
        assert not bo.should_shed(10 ** 6, deadline_s=1e-9)
        assert bo.should_shed(10, deadline_s=0.5, measured_item_s=0.1)

    def test_margin_scales_the_estimate(self):
        bo = BrownoutController(est_item_s=0.1, margin=2.0)
        assert bo.estimate_wait_s(5) == pytest.approx(1.0)


# ----------------------------------------------------------------------
# fleet failure domains (live hosts)
# ----------------------------------------------------------------------
class TestFleetFailureDomains:
    def test_failover_on_injected_dispatch_fault(self):
        fleet, rids = _fleet(2, _mln())
        try:
            lab = fleet._m_failover.labels(model="m", error="ChaosError")
            before = lab.value
            with ChaosPlan().raise_n("fleet.dispatch", at=0):
                out = fleet.submit("m", _rows(2, seed=1))
            assert np.asarray(out).shape == (2, 4)
            assert lab.value == before + 1
            charged = [r for r in rids
                       if False in fleet.health(r).snapshot()["window"]]
            assert charged == [rids[0]]   # ties rank by replica id
        finally:
            fleet.close()

    @pytest.mark.parametrize("seam", ["host.submit", "queue.dispatch"])
    def test_replica_fault_below_the_router_fails_over(self, seam):
        """A raise at the host's seam or inside the coalesced dispatch
        (the batch fails the organic way) is a replica fault too."""
        fleet, rids = _fleet(2, _mln())
        try:
            with ChaosPlan().raise_n(seam, at=0) as plan:
                out = fleet.submit("m", _rows(2, seed=1))
            assert np.asarray(out).shape == (2, 4)
            assert plan.fired(seam) == 1
            assert fleet.health(rids[0]).snapshot()["window"] == [False]
            assert fleet.health(rids[1]).snapshot()["window"] == [True]
        finally:
            fleet.close()

    def test_breaker_opens_and_recovers_at_exact_clock_steps(self):
        clk = ManualClock()
        fleet, rids = _fleet(
            2, _mln(), router_kw=dict(
                clock=clk,
                breaker=dict(window=4, failure_ratio=0.5, min_samples=2,
                             open_for_s=10.0, close_after=1)))
        try:
            plan = ChaosPlan().raise_n("fleet.dispatch", times=10 ** 6)
            with plan:
                for _ in range(2):
                    with pytest.raises(ChaosError):
                        fleet.submit("m", _rows(1))
            for r in rids:
                assert fleet.health(r).breaker.state == "open"
                assert fleet._m_breaker.labels(replica=r).value == 2.0
            out = fleet.submit("m", _rows(1, seed=2))   # fails open
            assert np.asarray(out).shape == (1, 4)
            clk.advance(9.999)
            assert {fleet.health(r).breaker.state for r in rids} \
                == {"open"}
            clk.advance(0.001)
            for r in rids:
                assert fleet.health(r).breaker.state == "half_open"
            fleet.submit("m", _rows(1, seed=3))
            states = sorted(fleet.health(r).breaker.state for r in rids)
            assert states == ["closed", "half_open"]
        finally:
            fleet.close()

    def test_open_breaker_excludes_replica_from_ranking(self):
        clk = ManualClock()
        fleet, (ra, rb) = _fleet(
            2, _mln(), router_kw=dict(
                clock=clk, breaker=dict(min_samples=1, window=4,
                                        failure_ratio=0.5,
                                        open_for_s=30.0)))
        try:
            fleet.health(ra).record(False)
            assert fleet.health(ra).breaker.state == "open"
            hits = _count_dispatches(dict(fleet._hosts()))
            for i in range(4):
                fleet.submit("m", _rows(1, seed=10 + i))
            assert hits == {ra: 0, rb: 4}
        finally:
            fleet.close()

    def test_quarantine_probe_readmission_cycle(self):
        fleet, (ra, rb) = _fleet(2, _mln(),
                                 router_kw=dict(readmit_after=3))
        try:
            fleet.quarantine(rb)
            assert fleet._m_breaker.labels(replica=rb).value == 2.0
            hits = _count_dispatches(dict(fleet._hosts()))
            fleet.submit("m", _rows(1))
            assert hits[rb] == 0
            fleet.set_probe("m", _rows(1, seed=4))
            ticks = [fleet.probe_tick() for _ in range(3)]
            flat = [r for t in ticks for r in t]
            assert [r["ok"] for r in flat] == [True] * 3
            assert [r["readmitted"] for r in flat] == [False, False, True]
            assert not fleet.health(rb).quarantined
            assert fleet._m_breaker.labels(replica=rb).value == 0.0
            assert fleet.probe_tick() == []
            assert hits[rb] == 3
        finally:
            fleet.close()

    def test_failing_probe_resets_the_streak(self):
        fleet, (ra, rb) = _fleet(2, _mln(),
                                 router_kw=dict(readmit_after=2))
        try:
            fleet.quarantine(rb)
            fleet.set_probe("m", _rows(1, seed=4))
            assert fleet.probe_tick()[0]["ok"] is True
            with ChaosPlan().raise_n("host.submit", at=0):
                assert fleet.probe_tick()[0]["ok"] is False
            assert [fleet.probe_tick()[0]["readmitted"]
                    for _ in range(2)] == [False, True]
        finally:
            fleet.close()

    def test_quarantine_needs_breaker_gating(self):
        fleet, (ra,) = _fleet(1, _mln(), router_kw=dict(breaker=False))
        try:
            assert fleet.health(ra) is None
            with pytest.raises(RuntimeError, match="breaker gating"):
                fleet.quarantine(ra)
        finally:
            fleet.close()

    def test_brownout_sheds_hopeless_admits_feasible(self):
        fleet, (ra,) = _fleet(1, _mln(), queueLimit=8)
        release = threading.Event()
        try:
            bo = fleet.set_brownout("m", est_item_s=10.0)
            shed_lab = fleet._m_shed.labels(model="m")
            base = shed_lab.value
            host = dict(fleet._hosts())[ra]
            plan = ChaosPlan().wedge("queue.dispatch", 30.0, at=0,
                                     release=release)
            with plan:
                threading.Thread(target=lambda: host.submit("m", _rows(1)),
                                 daemon=True).start()
                deadline = time.time() + 10
                while fleet._queued_work(host, "m") < 1 \
                        and time.time() < deadline:
                    time.sleep(0.005)
                with pytest.raises(DeadlineExceededError, match="brownout"):
                    fleet.submit("m", _rows(1, seed=5), deadline_s=0.5)
                assert shed_lab.value == base + 1 and bo.shed == 1
                release.set()
                while fleet._queued_work(host, "m") > 0 \
                        and time.time() < deadline:
                    time.sleep(0.005)
            out = fleet.submit("m", _rows(1, seed=6), deadline_s=30.0)
            assert np.asarray(out).shape == (1, 4)
            assert shed_lab.value == base + 1
            # deadline-less requests are never brownout candidates
            fleet.submit("m", _rows(1, seed=7))
            assert bo.snapshot()["admitted"] == 1
            assert fleet.set_brownout("m", enabled=False) is bo
        finally:
            release.set()
            fleet.close()

    def test_hedged_dispatch_second_replica_wins(self):
        """The primary's coalesced dispatch is wedged (released only at
        the end); the hedge fires at the mark, the second replica
        answers and wins with the right answer, and the primary's leg is
        cancelled or discarded."""
        net = _mln()
        feats = _rows(2, seed=8)
        want = ParallelInference(net, batchBuckets=(8,)).output(
            feats).toNumpy()
        fleet, rids = _fleet(2, net)
        release = threading.Event()
        try:
            fleet.submit("m", _rows(1))
            fleet.set_hedge("m", after_s=0.02)
            hedges = fleet._m_hedges.labels(model="m")
            wins = fleet._m_hedge_wins.labels(model="m")
            h0, w0 = hedges.value, wins.value
            with ChaosPlan().wedge("queue.dispatch", 30.0, at=0,
                                   release=release):
                got = np.asarray(fleet.submit("m", feats))
            np.testing.assert_array_equal(got, want)
            assert hedges.value == h0 + 1
            assert wins.value == w0 + 1
        finally:
            release.set()
            fleet.close()

    def test_hedge_not_fired_when_primary_is_fast(self):
        fleet, _ = _fleet(2, _mln())
        try:
            fleet.submit("m", _rows(1))
            fleet.set_hedge("m", after_s=5.0)
            hedges = fleet._m_hedges.labels(model="m")
            h0 = hedges.value
            out = fleet.submit("m", _rows(2, seed=9))
            assert np.asarray(out).shape == (2, 4)
            assert hedges.value == h0
            assert fleet.set_hedge("m", enabled=False) == {"after_s": 5.0}
        finally:
            fleet.close()


# ----------------------------------------------------------------------
# the chaos soak, and the armed-but-quiet fast path as counts
# ----------------------------------------------------------------------
class TestChaosSoak:
    def test_soak_zero_noninjected_failures_zero_cold_dispatches(self):
        """A 3-replica fleet under a seeded plan (a wedged dispatch,
        sparse dispatch-path raises, seeded slow batches through an
        injected sleep) serves every request bitwise-correctly, surfaces
        no client-visible error, counts every injected raise as exactly
        one failover, and pays no cold dispatch."""
        net = _mln()
        n_threads, n_each = 3, 20
        feats = {(t, i): _rows(1 + (t + i) % 4, seed=100 + t * 50 + i)
                 for t in range(n_threads) for i in range(n_each)}
        oracle = ParallelInference(net, batchBuckets=(8,))
        want = {k: oracle.output(v).toNumpy() for k, v in feats.items()}
        fleet, rids = _fleet(3, net, queueLimit=64)
        failures, served = [], []
        release = threading.Event()

        def client(t):
            for i in range(n_each):
                k = (t, i)
                try:
                    got = np.asarray(fleet.submit("m", feats[k]))
                except Exception as e:   # the assertion below
                    failures.append((k, repr(e)))
                    continue
                if not np.array_equal(got, want[k]):
                    failures.append((k, "wrong answer"))
                served.append(k)
                if len(served) >= 12:
                    # the wedged replica is held until the others have
                    # served a dozen requests around it
                    release.set()

        slept = []
        plan = ChaosPlan(seed=11, sleep=slept.append)
        for at in (3, 17, 31, 45):
            plan.raise_n("fleet.dispatch", at=at)
        plan.wedge("queue.dispatch", 0.25, at=5, release=release)
        plan.random_slows("queue.dispatch", rate=0.10, window=60,
                          seconds=0.01)
        assert plan.schedule() == (
            RefChaosPlan(seed=11).raise_n("fleet.dispatch", at=3)
            .raise_n("fleet.dispatch", at=17)
            .raise_n("fleet.dispatch", at=31)
            .raise_n("fleet.dispatch", at=45)
            .wedge("queue.dispatch", 0.25, at=5)
            .random_slows("queue.dispatch", rate=0.10, window=60,
                          seconds=0.01).schedule())
        lab = fleet._m_failover.labels(model="m", error="ChaosError")
        fo0 = lab.value
        try:
            fleet.submit("m", _rows(2, seed=999))
            with plan:
                ts = [threading.Thread(target=client, args=(t,))
                      for t in range(n_threads)]
                for th in ts:
                    th.start()
                for th in ts:
                    th.join(timeout=120)
            assert not any(th.is_alive() for th in ts)
            assert not failures, failures[:5]
            assert _cold(fleet) == 0
            assert plan.fired("fleet.dispatch") == 4
            assert lab.value - fo0 == 4
            slows = [e for e in plan.events if e[1] == "slow"]
            assert len(slept) == len(slows) >= 1
            assert ("queue.dispatch", "wedge", 5) in plan.events
            snap = fleet._budget("m").snapshot()
            assert snap["spent"] <= snap["ratio"] * snap["requests"] \
                + snap["burst"]
        finally:
            release.set()
            fleet.close()

    def test_armed_quiet_harness_counts_nothing_and_changes_nothing(self):
        """The fast path the reference's 1.03x gate times: a plan with
        rules only on an untouched seam counts no invocation, fires
        nothing, and the served answers are bitwise the disarmed
        ones."""
        fleet, _ = _fleet(1, _mln(), maxWaitMs=0.1)
        quiet = ChaosPlan().raise_n(_DISK, times=10 ** 6)
        try:
            xs = [_rows(1, seed=12 + i) for i in range(20)]
            disarmed = [fleet.submit("m", x) for x in xs]
            with quiet:
                armed = [fleet.submit("m", x) for x in xs]
            for a, b in zip(armed, disarmed):
                np.testing.assert_array_equal(a, b)
            assert quiet.events == [] and quiet._counts == {}
            assert _cold(fleet) == 0
        finally:
            fleet.close()


class TestTelemetryReadouts:
    """The registry readouts the fleet and the batcher reach: a series'
    mean, unlabeled facades, reset in place, snapshot and instant
    events on an injected clock."""

    def test_mean_reset_snapshot_and_event(self):
        from deeplearning4j_tpu_torch.runtime.telemetry import (
            MetricsRegistry,
        )

        clk = ManualClock(5.0)
        reg = MetricsRegistry(clock=clk)
        h = reg.histogram("t_seconds", "h", labels=("model",))
        child = h.labels(model="a")
        assert child.mean() is None
        for v in (0.1, 0.3):
            child.observe(v)
        assert child.mean() == pytest.approx(0.2)
        g = reg.gauge("t_depth", "g")
        g.set(3)
        g.inc(2)
        g.dec()
        assert g.value == 4.0
        c = reg.counter("t_total", "c", labels=("model",))
        c.labels(model="a").inc(7)
        with pytest.raises(ValueError, match="labeled"):
            c.value
        reg.event("fleet.scale_decision", "serving", action="scale_up")
        snap = reg.snapshot()
        assert snap["t_seconds"]["series"][0]["count"] == 2
        assert snap["t_total"]["series"][0] == {"labels": {"model": "a"},
                                                 "value": 7.0}
        assert snap["t_depth"]["series"][0]["value"] == 4.0
        span = reg.trace.spans()[0]
        assert (span["ph"], span["ts"], span["args"]) == (
            "i", 5.0, {"action": "scale_up"})
        reg.reset()
        assert child.count == 0 and child.mean() is None
        assert g.value == 0.0 and reg.trace.spans() == []
        unlabeled = reg.histogram("t_u_seconds", "u")
        unlabeled.labels().observe(1.5)
        assert (unlabeled.count, unlabeled.sum) == (1, 1.5)
