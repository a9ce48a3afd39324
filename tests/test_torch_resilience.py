"""Port parity for the resilient training runtime
(deeplearning4j_tpu_torch/runtime/resilience.py, data/resilient.py,
util/sharded_checkpoint.py) against the JAX reference.

Mirrors tests/test_resilience.py's TestRetry, TestPreemptionResume,
TestNanGuard and TestDataFaults, and tests/test_sharded_checkpoint.py's
cases that do not need Orbax (the round trip, no-updater and missing
path, the ComputationGraph round trip; the port's checkpoint directory
is its own format, so the mesh-placement and async cases have no
counterpart). Every fault is injected deterministically.

Tolerances: inside the port, bitwise (a resumed run against one that
never stopped, the guarded trajectory against plain fit, params across
a skipped step). Against the reference (weights carried from it): the
same retry delays and fault schedules exactly, the same skip events and
iteration counts exactly, params rtol/atol 2e-6 (f32).
"""

import os

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.data import DataSetIterator as JIterator
from deeplearning4j_tpu.optimize import ResilienceListener as JRL
from deeplearning4j_tpu.runtime import resilience as jres
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.data.resilient import RetryingDataSetIterator
from deeplearning4j_tpu_torch.optimize import ResilienceListener
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, ParameterAveragingTrainingMaster,
)
from deeplearning4j_tpu_torch.runtime.resilience import (
    FaultInjector, NonFiniteStepError, Preemption, ResilientFit, RetryPolicy,
    retry,
)
from deeplearning4j_tpu_torch.util import sharded_checkpoint as ck

torch.set_num_threads(1)
PARAMS = dict(rtol=2e-6, atol=2e-6)


def _mlp(M=P, seed=42):
    return (M.NeuralNetConfiguration.Builder()
            .seed(seed).updater(M.Adam(1e-2)).activation("relu").list()
            .layer(M.DenseLayer(nOut=16))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.feedForward(4)).build())


def _net(seed=42):
    return P.MultiLayerNetwork(_mlp(P, seed), device="cpu").init()


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, n)]
    return x, y


def _iter(n=64, batch=16, seed=0, cls=DataSetIterator):
    x, y = _data(n, seed)
    return cls(x, y, batch)


def _equal(a, b):
    assert torch.equal(a.params().tensor(), b.params().tensor())


def _upd_equal(a, b):
    for la, lb in zip(a._upd_states, b._upd_states):
        for part in la:
            for k in la[part]:
                assert torch.equal(la[part][k], lb[part][k])


_FAST = RetryPolicy(maxRetries=3, initialDelay=0.001, maxDelay=0.004,
                    sleep=lambda s: None)


# ----------------------------------------------------------------------
# retry backoff
# ----------------------------------------------------------------------
class TestRetry:
    def test_deterministic_jitter_and_bounds(self):
        kw = dict(maxRetries=6, initialDelay=0.05, maxDelay=0.4,
                  multiplier=2.0, jitter=0.5, seed=11)
        d1 = RetryPolicy(**kw).delays()
        assert d1 == RetryPolicy(**kw).delays()
        assert d1 == jres.RetryPolicy(**kw).delays()   # the reference's
        assert d1 != RetryPolicy(maxRetries=6, initialDelay=0.05,
                                 maxDelay=0.4, seed=12).delays()
        for k, d in enumerate(d1, start=1):
            base = min(0.4, 0.05 * 2.0 ** (k - 1))
            assert base * 0.5 <= d <= base
        with pytest.raises(ValueError, match="jitter"):
            RetryPolicy(jitter=1.5)

    def test_retry_succeeds_after_transients_then_gives_up(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise IOError("transient")
            return "ok"

        seen = []
        assert retry(flaky, _FAST,
                     on_retry=lambda a, e, d: seen.append((a, d))) == "ok"
        assert seen == list(zip([1, 2], _FAST.delays()[:2]))

        def always():
            raise IOError("permanent")

        with pytest.raises(IOError, match="permanent"):
            retry(always, _FAST)

    def test_non_matching_exception_not_retried(self):
        calls = {"n": 0}

        def boom():
            calls["n"] += 1
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            retry(boom, _FAST)
        assert calls["n"] == 1


# ----------------------------------------------------------------------
# preemption-safe fit
# ----------------------------------------------------------------------
class TestPreemptionResume:
    def test_resume_matches_uninterrupted_bitwise(self, tmp_path):
        epochs, steps_per_epoch = 3, 4
        ref = _net()
        ref.fit(_iter(), epochs=epochs)
        net = _net()
        inj = FaultInjector().killAfterStep(7)
        rf = ResilientFit(net, tmp_path / "ck", saveEveryNIterations=2,
                          keepLast=2, retryPolicy=_FAST, injector=inj)
        with pytest.raises(Preemption):
            rf.fit(_iter(), epochs=epochs)
        assert ("preempt", 7) in inj.events
        assert net._iteration == 7
        assert ck.latest_step(tmp_path / "ck") == 6
        net2 = _net()
        events2 = ResilienceListener()
        net2.setListeners(events2)
        ResilientFit(net2, tmp_path / "ck", saveEveryNIterations=2,
                     keepLast=2, retryPolicy=_FAST).fit(_iter(),
                                                        epochs=epochs)
        assert events2.restores == 1
        assert net2._iteration == epochs * steps_per_epoch
        _equal(ref, net2)
        _upd_equal(ref, net2)

    def test_keep_last_n_rotation_and_latest_step(self, tmp_path):
        rf = ResilientFit(_net(), tmp_path / "ck", saveEveryNIterations=1,
                          keepLast=2, retryPolicy=_FAST)
        rf.fit(_iter(), epochs=2)
        kept = sorted(p.name for p in (tmp_path / "ck").iterdir()
                      if p.name.startswith("step_"))
        assert kept == ["step_7", "step_8"]
        assert ck.latest_step(tmp_path / "ck") == 8

    def test_atomic_save_never_exposes_torn_checkpoint(self, tmp_path):
        d = tmp_path / "ck"
        net = _net()
        net.fit(_iter())
        ck.ShardedModelSerializer.writeModel(net, ck.step_path(d, 4))
        torn = ck.step_path(d, 9) + ".tmp-123-456"
        os.makedirs(torn)
        with open(os.path.join(torn, "manifest.json"), "w") as f:
            f.write("{")
        assert ck.latest_step(d) == 4
        restored = ck.ShardedModelSerializer.restore(ck.step_path(d, 4),
                                                     device="cpu")
        _equal(net, restored)
        ck.gc_checkpoints(d, keepLast=5)
        assert not os.path.exists(torn)

    def test_manifest_extra_roundtrip(self, tmp_path):
        net = _net()
        net.fit(_iter())
        p = ck.step_path(tmp_path, 1)
        ck.ShardedModelSerializer.writeModel(net, p,
                                             extra={"batch_in_epoch": 3})
        assert ck.read_manifest(p)["extra"] == {"batch_in_epoch": 3}

    def test_corrupt_latest_falls_back_to_previous(self, tmp_path):
        d = tmp_path / "ck"
        rf = ResilientFit(_net(), d, saveEveryNIterations=2, keepLast=3,
                          retryPolicy=_FAST)
        rf.fit(_iter(), epochs=1)           # saves at steps 2 and 4
        state = os.path.join(ck.step_path(d, 4), "state.npz")
        z = dict(np.load(state))
        z["arr_0"] = z["arr_0"] + 1.0       # bit rot in the newest one
        np.savez(state, **z)
        with pytest.raises(ck.CheckpointDigestError):
            ck.ShardedModelSerializer.restore(ck.step_path(d, 4),
                                              device="cpu")
        net = _net()
        events = ResilienceListener()
        net.setListeners(events)
        ResilientFit(net, d, retryPolicy=_FAST)._maybe_resume()
        assert net._iteration == 2 and events.restores == 1


# ----------------------------------------------------------------------
# the non-finite step guard
# ----------------------------------------------------------------------
class TestNanGuard:
    def test_poisoned_step_skipped_not_applied(self):
        net = _net()
        events = ResilienceListener()
        net.setListeners(events)
        inj = FaultInjector().poisonStep(2)
        ResilientFit(net, injector=inj, retryPolicy=_FAST).fit(_iter(),
                                                               epochs=1)
        assert events.skippedSteps == 1 and events.events[0][1] == 3
        assert ("poison", 2) in inj.events
        assert all(torch.isfinite(t).all() for p in net._params
                   for t in p.values())
        assert net._iteration == 4

    def test_params_frozen_across_skip(self):
        net = _net()
        before, after = {}, {}

        class Grab:
            def iterationDone(self, model, iteration, epoch):
                c = [{k: t.detach().clone() for k, t in p.items()}
                     for p in model._params]
                s = [{k: t.clone() for k, t in st.items()}
                     for st in model._states]
                if iteration == 1:
                    before["p"], before["s"] = c, s
                elif iteration == 2:
                    after["p"], after["s"] = c, s

        net.setListeners(Grab())
        ResilientFit(net, injector=FaultInjector().poisonStep(1),
                     retryPolicy=_FAST).fit(_iter(), epochs=1)
        for a, b in zip(before["p"] + before["s"], after["p"] + after["s"]):
            for k in a:
                assert torch.equal(a[k], b[k])

    def test_guard_rolls_back_bn_state_and_updater(self):
        """BN's running statistics and Adam's moments come back with the
        params: after the skipped step the whole state is the pre-step
        state, bit for bit (only the iteration count moved, as in the
        reference)."""
        conf = (P.NeuralNetConfiguration.Builder().seed(3)
                .updater(P.Adam(1e-2)).list()
                .layer(P.DenseLayer(nOut=8, activation="relu"))
                .layer(P.BatchNormalization())
                .layer(P.OutputLayer(nOut=3, activation="softmax"))
                .setInputType(P.InputType.feedForward(4)).build())
        net = P.MultiLayerNetwork(conf, device="cpu").init()
        snaps = {}

        class Grab:
            def iterationDone(self, model, iteration, epoch):
                snaps[iteration] = [
                    t.detach().clone() for t in ck.tree_leaves(
                        [model._params, model._states, model._upd_states])]

        net.setListeners(Grab())
        ResilientFit(net, injector=FaultInjector().poisonStep(1),
                     retryPolicy=_FAST).fit(_iter(), epochs=1)
        assert len(snaps[1]) == len(snaps[2]) > 10
        for a, b in zip(snaps[1], snaps[2]):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b)
                       for a, b in zip(snaps[2], snaps[3]))

    def test_consecutive_bad_steps_abort(self):
        rf = ResilientFit(_net(), injector=FaultInjector().poisonStep(1, 2),
                          retryPolicy=_FAST, maxConsecutiveBadSteps=2)
        with pytest.raises(NonFiniteStepError, match="2 consecutive"):
            rf.fit(_iter(), epochs=1)

    def test_guard_overhead_free_path_identical(self):
        a = _net()
        a.fit(_iter(), epochs=2)
        b = _net()
        ResilientFit(b, retryPolicy=_FAST).fit(_iter(), epochs=2)
        _equal(a, b)
        _upd_equal(a, b)

    @pytest.mark.parametrize("k", [1, 2])
    def test_matches_reference_guard(self, k):
        """The same poisoned schedule through both packages' ResilientFit
        from the same weights: the same skips, the same trajectory."""
        jn = J.MultiLayerNetwork(_mlp(J)).init()
        pn = _net()
        pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                                 jax.tree.map(np.asarray, jn._states))
        jl, pl = JRL(), ResilienceListener()
        jn.setListeners(jl)
        pn.setListeners(pl)
        jres.ResilientFit(jn, injector=jres.FaultInjector().poisonStep(1, 5),
                          retryPolicy=_FAST).fit(_iter(cls=JIterator),
                                                 epochs=2, stepsPerSync=k)
        ResilientFit(pn, injector=FaultInjector().poisonStep(1, 5),
                     retryPolicy=_FAST).fit(_iter(), epochs=2,
                                            stepsPerSync=k)
        assert [e[:2] for e in pl.events] == [e[:2] for e in jl.events]
        assert pn._iteration == jn._iteration == 8
        np.testing.assert_allclose(pn.params().toNumpy(),
                                   np.asarray(jn.params().toNumpy()),
                                   **PARAMS)

    def test_parallel_wrapper_waits_for_item_7(self, tmp_path):
        """ResilientFit over a ParallelWrapper is ported (the
        multi-rank resumes: tests/test_torch_zero_sharding.py and
        tests/test_torch_hier_compression.py). On one rank a guarded
        wrapper skips the poisoned steps as the plain net does, and a
        preempted run resumes bitwise, its residual and tau included."""
        plain, wrapped = _net(), _net()
        ResilientFit(plain, injector=FaultInjector().poisonStep(1, 5),
                     retryPolicy=_FAST).fit(_iter(), epochs=2)
        rf = ResilientFit(ParallelWrapper(wrapped),
                          injector=FaultInjector().poisonStep(1, 5),
                          retryPolicy=_FAST)
        rf.fit(_iter(), epochs=2)
        _equal(plain, wrapped)
        assert rf.skippedSteps == 2 and wrapped._iteration == 8

        def wrap():
            return ParallelWrapper(_net(), gradient_compression="threshold",
                                   threshold=1e-3)

        w1 = wrap()
        ResilientFit(w1).fit(_iter(), epochs=2)
        d = tmp_path / "ck"
        with pytest.raises(Preemption):
            ResilientFit(wrap(), d, saveEveryNIterations=3,
                         injector=FaultInjector().killAfterStep(5)).fit(
                _iter(), epochs=2)
        w3 = wrap()
        ResilientFit(w3, d, saveEveryNIterations=3).fit(_iter(), epochs=2)
        _equal(w1.net, w3.net)
        assert torch.equal(w1._ef, w3._ef) and torch.equal(w1._tau, w3._tau)
        with pytest.raises(ValueError, match="ParameterAveraging"):
            ResilientFit(ParameterAveragingTrainingMaster(_net()))


# ----------------------------------------------------------------------
# the data path
# ----------------------------------------------------------------------
class TestDataFaults:
    def test_iterator_ioerror_retried_through_fit(self):
        net = _net()
        inj = FaultInjector().failOnBatch(1, times=2)
        ResilientFit(net, injector=inj, retryPolicy=_FAST).fit(
            inj.wrapIterator(_iter()), epochs=1)
        assert net._iteration == 4
        assert [e for e in inj.events if e[0] == "data_fault"] == \
            [("data_fault", 1), ("data_fault", 1)]
        ref = _net()
        ref.fit(_iter(), epochs=1)
        _equal(ref, net)

    def test_retrying_iterator_standalone(self):
        inj = FaultInjector().failOnBatch(0, times=1).failOnBatch(2, times=3)
        it = RetryingDataSetIterator(inj.wrapIterator(_iter()), policy=_FAST)
        assert sum(1 for _ in it) == 4
        assert it.retries == 4
        assert it.batch() == 16

    def test_retries_exhausted_raises_original(self):
        inj = FaultInjector().failOnBatch(0, times=10)
        it = RetryingDataSetIterator(inj.wrapIterator(_iter()), policy=_FAST)
        it.reset()
        assert it.hasNext()
        with pytest.raises(IOError, match="injected data fault"):
            it.next()

    def test_dying_iterator_not_silently_truncated(self):
        class DiesMidEpoch:
            def __init__(self):
                self.base = _iter()
                self.dead = self.raised = False

            def reset(self):
                self.base.reset()

            def hasNext(self):
                if self.dead:
                    return False
                if self.base._cursor >= 32 and not self.raised:
                    self.raised = self.dead = True
                    raise IOError("producer died")
                return self.base.hasNext()

            def next(self, num=None):
                return self.base.next()

        net = _net()
        with pytest.raises(IOError, match="producer died"):
            ResilientFit(net, retryPolicy=_FAST).fit(DiesMidEpoch(),
                                                     epochs=1)
        assert net._epoch == 0

    def test_random_faults_seed_deterministic(self):
        a = FaultInjector(seed=5).randomIOFaults(100, rate=0.2)
        b = FaultInjector(seed=5).randomIOFaults(100, rate=0.2)
        c = FaultInjector(seed=6).randomIOFaults(100, rate=0.2)
        assert set(a._io_faults) == set(b._io_faults)
        assert set(a._io_faults) != set(c._io_faults)
        assert set(a._io_faults) == set(
            jres.FaultInjector(seed=5).randomIOFaults(100, 0.2)._io_faults)


# ----------------------------------------------------------------------
# tests/test_sharded_checkpoint.py, the cases without Orbax
# ----------------------------------------------------------------------
class TestShardedCheckpoint:
    def test_roundtrip_preserves_training_state(self, tmp_path):
        x, y = _data()
        net = _net()
        for _ in range(5):
            net.fit(DataSetIterator(x, y, 32))
        ck.ShardedModelSerializer.writeModel(net, tmp_path / "ckpt")
        net2 = ck.ShardedModelSerializer.restore(tmp_path / "ckpt",
                                                 device="cpu")
        _equal(net, net2)
        _upd_equal(net, net2)
        assert net2._iteration == net._iteration
        assert net2._epoch == net._epoch
        net.fit(DataSetIterator(x, y, 32))
        net2.fit(DataSetIterator(x, y, 32))
        _equal(net, net2)

    def test_no_updater_and_missing_path(self, tmp_path):
        x, y = _data(32, seed=4)
        net = _net(5)
        net.fit(DataSetIterator(x, y, 32))
        ck.ShardedModelSerializer.writeModel(net, tmp_path / "nu",
                                             saveUpdater=False)
        _equal(net, ck.ShardedModelSerializer.restore(tmp_path / "nu",
                                                      device="cpu"))
        with pytest.raises(ValueError, match="manifest"):
            ck.ShardedModelSerializer.restore(tmp_path / "nowhere",
                                              device="cpu")

    def test_computation_graph_roundtrip(self, tmp_path):
        x, y = _data(32, seed=6)
        conf = (P.NeuralNetConfiguration.Builder()
                .seed(2).updater(P.Adam(1e-2)).graphBuilder()
                .addInputs("in")
                .addLayer("h", P.DenseLayer(nOut=16, activation="relu"), "in")
                .addLayer("out", P.OutputLayer(nOut=3, activation="softmax"),
                          "h")
                .setOutputs("out")
                .setInputTypes(P.InputType.feedForward(4)).build())
        g = P.ComputationGraph(conf, device="cpu").init()
        g.fit(DataSetIterator(x, y, 32))
        ck.ShardedModelSerializer.writeModel(g, tmp_path / "g")
        g2 = ck.ShardedModelSerializer.restore(tmp_path / "g", device="cpu")
        assert isinstance(g2, P.ComputationGraph)
        _equal(g, g2)

    def test_trainer_state_waits_for_item_7(self, tmp_path):
        """Trainer state rides a checkpoint beside the net's (ported):
        read back bitwise, absent from a checkpoint written without it,
        and a corrupted one fails its digest."""
        state = {"ef": torch.arange(6.0).reshape(1, 6),
                 "tau": torch.tensor(1e-3)}
        net = _net()
        ck.ShardedModelSerializer.writeModel(net, tmp_path / "t",
                                             trainer_state=state)
        got = ck.restore_trainer_state(tmp_path / "t")
        assert set(got) == {"ef", "tau"}
        for k in state:
            assert torch.equal(got[k], state[k])
        assert ck.read_manifest(tmp_path / "t")["trainerState"] is True
        _equal(net, ck.ShardedModelSerializer.restore(tmp_path / "t",
                                                      device="cpu"))
        ck.ShardedModelSerializer.writeModel(net, tmp_path / "u")
        assert ck.restore_trainer_state(tmp_path / "u") is None
        np.savez(tmp_path / "t" / "trainer.npz", ef=np.zeros((1, 6)),
                 tau=np.float32(1e-3))
        with pytest.raises(ck.CheckpointDigestError):
            ck.restore_trainer_state(tmp_path / "t")
