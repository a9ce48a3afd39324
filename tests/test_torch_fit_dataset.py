"""Port parity for fitDataSet(iterator, stepsPerSync=k) and fitSteps
(the block driver in deeplearning4j_tpu_torch/nn/multilayer.py:
``BlockStager``, ``run_staged_blocks``, ``run_fit_dataset_epoch``) on
MultiLayerNetwork, ComputationGraph, SameDiff, ParallelWrapper at dp 2
and ResilientFit, against the JAX reference.

Mirrors tests/test_fit_dataset.py's TestStacking, TestFitDataSetMultiLayer,
TestFitDataSetGraph, TestFitDataSetSameDiff, TestFitDataSetResilient and
the non-ZeRO cases of TestFitDataSetSharded (on two gloo ranks spawned by
``parallel.launch``; their bodies are in tests/_torch_parallel_ranks.py).

The port runs a block as k eager steps issued back to back, so inside the
port its contract is bitwise: for k in {1, 3, 4} fitDataSet gives the
losses, params, updater state and iteration counts of fit over the same
iterator, with ceil(n/k) syncs (one a block plus one a ragged-tail
batch). Against the reference's own fitDataSet trajectory (weights
carried from the reference) it is held to the reference test's bands:
params rtol/atol 2e-6, scores rtol 2e-5 / atol 2e-6 (f32, the two
frameworks sum in another order). The reference's dropout-stream and
single-compile cases have no port counterpart (the port trains without
dropout and compiles nothing): dropout's refusal and the block driver's
spans stand in their place.
"""

import math

import numpy as np
import pytest
import torch

import jax

import _torch_parallel_ranks as R
import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.optimize as JO
from deeplearning4j_tpu.data import DataSetIterator as JIterator
from deeplearning4j_tpu.data.iterators import iter_stacks as j_iter_stacks
from deeplearning4j_tpu.data.iterators import stack_datasets as j_stack
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.data.iterators import (
    iter_stacks, stack_datasets,
)
from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresListener, ResilienceListener, TrainingListener,
)
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, ParameterAveragingTrainingMaster, launch,
)
from deeplearning4j_tpu_torch.runtime.resilience import (
    FaultInjector, NonFiniteStepError, Preemption, ResilientFit, RetryPolicy,
)

torch.set_num_threads(1)
PARAMS = dict(rtol=2e-6, atol=2e-6)
SCORES = dict(rtol=2e-5, atol=2e-6)


def _mlp(M, seed=42, dropout=None):
    dense = M.DenseLayer(nOut=16) if dropout is None else \
        M.DenseLayer(nOut=16, dropOut=dropout)
    return (M.NeuralNetConfiguration.Builder()
            .seed(seed).updater(M.Adam(1e-2)).weightInit(M.WeightInit.XAVIER)
            .activation("relu").list()
            .layer(dense)
            .layer(M.OutputLayer(nOut=3, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.feedForward(4)).build())


def _net(seed=42):
    return P.MultiLayerNetwork(_mlp(P, seed), device="cpu").init()


def _pair(seed=42):
    jn = J.MultiLayerNetwork(_mlp(J, seed)).init()
    pn = _net(seed)
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, n)]
    return x, y


def _iter(n_batches, batch=8, seed=0, cls=DataSetIterator, rows=None):
    x, y = _data(n_batches * batch if rows is None else rows, seed)
    return cls(x, y, batch)


def _flat(net):
    return net.params().tensor()


def _jflat(net):
    return np.asarray(net.params().toNumpy())


class _SyncSpy(TrainingListener):
    def __init__(self):
        self.boundaries = []

    def onSyncBoundary(self, model, iteration, scores):
        self.boundaries.append((iteration, len(scores)))


class _ListIt:
    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def reset(self):
        self.i = 0

    def hasNext(self):
        return self.i < len(self.batches)

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]


# ----------------------------------------------------------------------
# staging helpers
# ----------------------------------------------------------------------
class TestStacking:
    def test_iter_stacks_grouping(self):
        assert [len(g) for g in iter_stacks(_iter(7), 3)] == [3, 3, 1]
        assert [len(g) for g in iter_stacks(_iter(6), 3)] == [3, 3]
        assert [len(g) for g in j_iter_stacks(_iter(7, cls=JIterator),
                                              3)] == [3, 3, 1]

    def test_iter_stacks_plain_iterable(self):
        items = [object() for _ in range(5)]
        groups = list(iter_stacks(items, 2))
        assert [len(g) for g in groups] == [2, 2, 1]
        assert [x for g in groups for x in g] == items

    def test_stack_shapes_and_missing_masks(self):
        batches = [next(iter(_iter(1, seed=s))) for s in range(3)]
        jb = [next(iter(_iter(1, seed=s, cls=JIterator))) for s in range(3)]
        got, want = stack_datasets(batches), j_stack(jb)
        assert got[0].shape == (3, 8, 4) and got[1].shape == (3, 8, 3)
        assert got[2] is None and got[3] is None
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, np.asarray(w))

    def test_mixed_label_mask_synthesized(self):
        x, y = _data(20)
        it, jt = DataSetIterator(x, y, 8), JIterator(x, y, 8)
        got = stack_datasets([it.next() for _ in range(3)])
        want = j_stack([jt.next() for _ in range(3)])
        assert got[2] is None and got[3].shape == (3, 8)
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))

    def test_ragged_component_shapes_rejected(self):
        a = DataSet(np.zeros((8, 4), "float32"), np.zeros((8, 3), "float32"))
        b = DataSet(np.zeros((4, 4), "float32"), np.zeros((4, 3), "float32"))
        with pytest.raises(ValueError, match="ragged"):
            stack_datasets([a, b])
        net = _net()
        with pytest.raises(ValueError, match="ragged"):
            net.fitDataSet(_ListIt([a, b]), stepsPerSync=2)


# ----------------------------------------------------------------------
# MultiLayerNetwork
# ----------------------------------------------------------------------
class TestFitDataSetMultiLayer:
    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_matches_sequential_fit(self, k):
        n = 10           # k = 3 and 4 leave a ragged tail
        a, b = _net(), _net()
        sa, sb = CollectScoresListener(), CollectScoresListener()
        a.setListeners(sa)
        b.setListeners(sb)
        a.fit(_iter(n))
        b.fitDataSet(_iter(n), stepsPerSync=k)
        assert torch.equal(_flat(a), _flat(b))
        for la, lb in zip(a._upd_states, b._upd_states):
            for key in la["m"]:
                assert torch.equal(la["m"][key], lb["m"][key])
                assert torch.equal(la["v"][key], lb["v"][key])
        assert a._iteration == b._iteration == n
        assert sa.iterations == sb.iterations
        assert sa.scores == sb.scores
        full, tail = divmod(n, k)
        assert b._fit_dataset_syncs == full + tail
        if tail <= 1:
            assert b._fit_dataset_syncs == math.ceil(n / k)

    @pytest.mark.parametrize("k", [3, 4])
    def test_matches_reference_fit_dataset(self, k):
        """The port's blocks against the reference's own fitDataSet."""
        n = 10
        jn, pn = _pair()
        sj, sp = JO.CollectScoresListener(), CollectScoresListener()
        jn.setListeners(sj)
        pn.setListeners(sp)
        jn.fitDataSet(_iter(n, cls=JIterator), stepsPerSync=k)
        pn.fitDataSet(_iter(n), stepsPerSync=k)
        np.testing.assert_allclose(pn.params().toNumpy(), _jflat(jn),
                                   **PARAMS)
        np.testing.assert_allclose(sp.scores, sj.scores, **SCORES)
        assert sp.iterations == sj.iterations
        assert pn._fit_dataset_syncs == jn._fit_dataset_syncs
        assert pn._iteration == jn._iteration == n

    def test_dropout_refused_as_in_fit(self):
        """Dropout trains since the CNN-zoo slice (it raised in both
        before): a block draws each step's masks from the iteration the
        dispatch cursor gives it, so fitDataSet is fit bit for bit."""
        a = P.MultiLayerNetwork(_mlp(P, 3, dropout=0.7), device="cpu").init()
        b = P.MultiLayerNetwork(_mlp(P, 3, dropout=0.7), device="cpu").init()
        a.fit(_iter(6))
        b.fitDataSet(_iter(6), stepsPerSync=3)
        assert torch.equal(_flat(a), _flat(b))
        assert a.score() == b.score()
        assert b._iteration == 6

    def test_ragged_tail_parity(self):
        n, k = 10, 4
        a, b = _net(), _net()
        a.fit(_iter(n))
        b.fitDataSet(_iter(n), stepsPerSync=k)
        assert torch.equal(_flat(a), _flat(b))
        assert b._iteration == n
        assert b._fit_dataset_syncs == math.ceil(n / k) + 1

    def test_host_sync_count_and_boundaries(self):
        net = _net()
        spy = _SyncSpy()
        net.setListeners(spy)
        net.fitDataSet(_iter(12), stepsPerSync=4)
        assert net._fit_dataset_syncs == math.ceil(12 / 4) == 3
        assert spy.boundaries == [(4, 4), (8, 4), (12, 4)]

    def test_block_spans_across_epochs(self):
        """The block driver's spans (data wait, staging, dispatch, sync
        wait) over two epochs of 3 blocks and a ragged tail batch."""
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        reg.trace.clear()
        net = _net()
        net.fitDataSet(_iter(13), stepsPerSync=4, epochs=2)
        assert net._iteration == 26 and net._epoch == 2
        assert net._fit_dataset_syncs == 2 * (3 + 1)
        names = [s["name"] for s in reg.trace.spans()]
        for name in ("staging", "dispatch", "sync_wait"):
            assert names.count(f"fit_dataset.{name}") == 6
        assert names.count("fit_dataset.data_wait") == 8

    def test_steps_per_sync_one_is_fit(self):
        a, b = _net(), _net()
        a.fit(_iter(4))
        b.fitDataSet(_iter(4), stepsPerSync=1)
        assert torch.equal(_flat(a), _flat(b))
        assert b._fit_dataset_syncs == 4

    def test_invalid_k_rejected(self):
        with pytest.raises(ValueError, match="stepsPerSync"):
            _net().fitDataSet(_iter(4), stepsPerSync=0)

    def test_tbptt_rejected(self):
        conf = (P.NeuralNetConfiguration.Builder().seed(1)
                .updater(P.Sgd(0.05)).list()
                .layer(P.LSTM(nOut=8))
                .layer(P.RnnOutputLayer(nOut=3, activation="softmax",
                                        lossFunction="mcxent"))
                .setInputType(P.InputType.recurrent(4, 8))
                .backpropType(P.BackpropType.TruncatedBPTT).tBPTTLength(4)
                .build())
        net = P.MultiLayerNetwork(conf, device="cpu").init()
        with pytest.raises(ValueError, match="truncated BPTT"):
            net.fitDataSet(_iter(4), stepsPerSync=2)

    def test_fit_steps_matches_repeated_fit_and_reference(self):
        x, y = _data(8)
        a, b = _net(), _net()
        for _ in range(3):
            a.fit(x, y)
        b.fitSteps(x, y, numSteps=3)
        assert torch.equal(_flat(a), _flat(b)) and a.score() == b.score()
        assert b.getIterationCount() == 3
        jn, pn = _pair()
        jn.fitSteps(x, y, numSteps=3)
        pn.fitSteps(DataSet(x, y), numSteps=3)
        np.testing.assert_allclose(pn.params().toNumpy(), _jflat(jn),
                                   **PARAMS)
        np.testing.assert_allclose(pn.score(), jn.score(), **SCORES)

    def test_fit_steps_tbptt_windows(self):
        def conf(M):
            return (M.NeuralNetConfiguration.Builder().seed(1)
                    .updater(M.Sgd(0.05)).list()
                    .layer(M.LSTM(nOut=6))
                    .layer(M.RnnOutputLayer(nOut=3, activation="softmax",
                                            lossFunction="mcxent"))
                    .setInputType(M.InputType.recurrent(4))
                    .backpropType(M.BackpropType.TruncatedBPTT)
                    .tBPTTLength(3).build())

        rng = np.random.RandomState(4)
        x = rng.randn(4, 4, 6).astype("float32")
        y = np.eye(3, dtype="float32")[rng.randint(0, 3, (4, 6))] \
            .transpose(0, 2, 1).copy()
        a = P.MultiLayerNetwork(conf(P), device="cpu").init()
        b = P.MultiLayerNetwork(conf(P), device="cpu").init()
        a.fit(x, y)
        a.fit(x, y)
        b.fitSteps(x, y, numSteps=2)
        assert torch.equal(_flat(a), _flat(b)) and a.score() == b.score()
        assert b.getIterationCount() == 4      # 2 windows a step
        with pytest.raises(ValueError, match="divisible"):
            b.fitSteps(x[:, :, :5], y[:, :, :5], numSteps=1)


# ----------------------------------------------------------------------
# ComputationGraph
# ----------------------------------------------------------------------
def _graph(M, seed=9):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Adam(1e-2)).graphBuilder()
            .addInputs("in")
            .addLayer("d", M.DenseLayer(nOut=16, activation="relu"), "in")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax",
                                           lossFunction="mcxent"), "d")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(4)).build())


def _two_input(M):
    return (M.NeuralNetConfiguration.Builder().seed(3)
            .updater(M.Sgd(0.1)).graphBuilder()
            .addInputs("a", "b")
            .addLayer("da", M.DenseLayer(nOut=8, activation="tanh"), "a")
            .addLayer("db", M.DenseLayer(nOut=8, activation="tanh"), "b")
            .addVertex("m", M.ElementWiseVertex("Add"), "da", "db")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"),
                      "m")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(4),
                           M.InputType.feedForward(3)).build())


def _mds_batches(n, masks=False):
    rng = np.random.RandomState(0)
    return [MultiDataSet(
        [rng.randn(8, 4).astype("float32"), rng.randn(8, 3).astype("float32")],
        [np.eye(2, dtype="float32")[rng.randint(0, 2, 8)]],
        featuresMasks=[np.ones(8, "float32"), None] if masks else None)
        for _ in range(n)]


class TestFitDataSetGraph:
    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_matches_sequential_fit(self, k):
        n = 9
        a = P.ComputationGraph(_graph(P), device="cpu").init()
        b = P.ComputationGraph(_graph(P), device="cpu").init()
        a.fit(_iter(n))
        b.fitDataSet(_iter(n), stepsPerSync=k)
        assert torch.equal(_flat(a), _flat(b)) and a.score() == b.score()
        assert a._iteration == b._iteration == n
        full, tail = divmod(n, k)
        assert b._fit_dataset_syncs == full + tail

    def test_matches_reference_fit_dataset(self):
        jn = J.ComputationGraph(_graph(J)).init()
        pn = P.ComputationGraph(_graph(P), device="cpu").init()
        pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                                 jax.tree.map(np.asarray, jn._states))
        jn.fitDataSet(_iter(9, cls=JIterator), stepsPerSync=3)
        pn.fitDataSet(_iter(9), stepsPerSync=3)
        np.testing.assert_allclose(pn.params().toNumpy(), _jflat(jn),
                                   **PARAMS)
        np.testing.assert_allclose(pn.score(), jn.score(), **SCORES)

    def test_multi_input_multidataset_iterator(self):
        batches = _mds_batches(5)
        a = P.ComputationGraph(_two_input(P), device="cpu").init()
        b = P.ComputationGraph(_two_input(P), device="cpu").init()
        for ds in batches:
            a.fit(ds)
        b.fitDataSet(_ListIt(batches), stepsPerSync=2)
        assert torch.equal(_flat(a), _flat(b))
        assert b._iteration == 5 and b._fit_dataset_syncs == 3

    def test_per_input_none_features_mask(self):
        batches = _mds_batches(4, masks=True)
        a = P.ComputationGraph(_two_input(P), device="cpu").init()
        g = P.ComputationGraph(_two_input(P), device="cpu").init()
        for ds in batches:
            a.fit(ds)
        g.fitDataSet(_ListIt(batches), stepsPerSync=2)
        assert g._iteration == 4 and np.isfinite(g.score())
        assert torch.equal(_flat(a), _flat(g))


# ----------------------------------------------------------------------
# SameDiff
# ----------------------------------------------------------------------
class TestFitDataSetSameDiff:
    def _make(self, pkg):
        if pkg == "j":
            import jax.numpy as jnp

            from deeplearning4j_tpu.autodiff import SameDiff, TrainingConfig
            sd, dt, upd = SameDiff.create(), jnp.float32, J.Adam
        else:
            from deeplearning4j_tpu_torch.autodiff import (
                SameDiff, TrainingConfig,
            )
            sd, dt, upd = SameDiff.create(device="cpu"), torch.float32, \
                P.Adam
        rs = np.random.RandomState(7)
        x = sd.placeHolder("x", dt, 8, 4)
        y = sd.placeHolder("y", dt, 8, 3)
        w = sd.var("w", (rs.randn(4, 3) * 0.1).astype("float32"))
        b = sd.var("b", np.zeros(3, dtype="float32"))
        logits = sd.nn.linear(x, w, b, name="logits")
        sd.loss.softmaxCrossEntropy(y, logits, name="loss")
        sd.setTrainingConfig(
            TrainingConfig.Builder().updater(upd(learningRate=1e-2))
            .dataSetFeatureMapping("x").dataSetLabelMapping("y").build())
        return sd

    def _batches(self, n):
        out = []
        for i in range(n):
            rng = np.random.RandomState(i)
            out.append((rng.rand(8, 4).astype("float32"),
                        np.eye(3, dtype="float32")[rng.randint(0, 3, 8)]))
        return out

    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_matches_fit_history_and_params(self, k):
        raw = self._batches(7)
        batches = [DataSet(x, y) for x, y in raw]
        a, b = self._make("p"), self._make("p")
        h1 = a.fit(data=batches)
        spy = _SyncSpy()
        h2 = b.fitDataSet(_ListIt(batches), stepsPerSync=k, listeners=[spy])
        assert h1 == h2
        assert torch.equal(a.getVariable("w").getArr().tensor(),
                           b.getVariable("w").getArr().tensor())
        assert a._iteration == b._iteration == 7
        full, tail = divmod(7, k)
        assert b._fit_dataset_syncs == full + tail
        if k > 1:
            assert spy.boundaries == [(k * (i + 1), k) for i in range(full)]
        with pytest.raises(ValueError, match="resettable"):
            b.fitDataSet(iter(batches), stepsPerSync=k, epochs=2)
        # against the reference's own fitDataSet
        from deeplearning4j_tpu.data import DataSet as JDataSet

        j = self._make("j")
        h3 = j.fitDataSet(_ListIt([JDataSet(x, y) for x, y in raw]),
                          stepsPerSync=k)
        np.testing.assert_allclose(h2, h3, **SCORES)
        assert j._fit_dataset_syncs == b._fit_dataset_syncs
        np.testing.assert_allclose(
            b.getVariable("w").getArr().toNumpy(),
            np.asarray(j.getVariable("w").getArr().toNumpy()), **PARAMS)

    def test_evaluate_and_listeners(self):
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        batches = [DataSet(x, y) for x, y in self._batches(4)]
        sd = self._make("p")
        seen = []

        class L:
            def iterationDone(self, model, it, loss):
                seen.append((it, loss))

        hist = sd.fit(data=batches, listeners=[L()])
        assert [s[1] for s in seen] == hist and seen[-1][0] == 4
        e = sd.evaluate(_ListIt(batches), "logits", Evaluation())
        assert e.getConfusionMatrix().sum() == 32


# ----------------------------------------------------------------------
# data parallel: two gloo ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sharded():
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
    from deeplearning4j_tpu.parallel import data_parallel_mesh as jmesh

    jn = J.MultiLayerNetwork(_ref_mlp()).init()
    init = {"mlp": (jax.tree.map(np.asarray, jn._params),
                    jax.tree.map(np.asarray, jn._states))}
    # the reference's own k-block data-parallel run from the same start
    JPW(jn, mesh=jmesh()).fitDataSet(
        _iter(8, batch=16, cls=JIterator), stepsPerSync=4)
    ranks = launch(R.fit_dataset_rank, 2, device="cpu", timeout=240,
                   args=(init,))
    return jn, ranks


def _ref_mlp():
    """tests/_torch_parallel_ranks.mlp_conf in the reference."""
    return (J.NeuralNetConfiguration.Builder()
            .seed(42).updater(J.Adam(1e-2)).activation("relu").list()
            .layer(J.DenseLayer(nOut=32))
            .layer(J.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(J.InputType.feedForward(4)).build())


class TestFitDataSetSharded:
    def test_parallel_wrapper_parity_with_single_device(self, sharded):
        jn, ranks = sharded
        for r in ranks:
            d = r["dense"]
            for k in d["fit"]:
                np.testing.assert_array_equal(d["blocks"][k], d["fit"][k])
            assert d["syncs"] == 8 // 4 and d["iteration"] == 8
            for steps, want in (("k1", 8), ("k3", 2 + 2)):
                e = r[steps]
                for k in e["fit"]:
                    np.testing.assert_array_equal(e["blocks"][k],
                                                  e["fit"][k])
                assert e["syncs"] == want and e["iteration"] == 8
        # equal on both ranks, and the reference's dp k-block trajectory
        for k in ranks[0]["dense"]["blocks"]:
            np.testing.assert_array_equal(ranks[0]["dense"]["blocks"][k],
                                          ranks[1]["dense"]["blocks"][k])
        want = np.asarray(jn.params().toNumpy(), np.float64)
        got = np.concatenate([ranks[0]["dense"]["blocks"][f"{i}.{n}"]
                              .reshape(-1) for i, ps in
                              enumerate(jax.tree.map(np.asarray,
                                                     jn._params))
                              for n in sorted(ps)])
        np.testing.assert_allclose(got, want, **PARAMS)

    def test_int8_compression_runs(self, sharded):
        for r in sharded[1]:
            d = r["int8"]
            assert np.isfinite(d["score"]) and d["iteration"] == 4
            for k in d["fit"]:
                np.testing.assert_array_equal(d["blocks"][k], d["fit"][k])

    def test_threshold_mode_k_loop_matches_per_batch(self, sharded):
        for r in sharded[1]:
            d = r["threshold"]
            assert d["syncs"] == 2
            for k in d["fit"]:
                np.testing.assert_array_equal(d["blocks"][k], d["fit"][k])
            np.testing.assert_array_equal(d["res_blocks"], d["res_fit"])

    def test_parameter_averaging_rejected(self):
        pam = ParameterAveragingTrainingMaster(_net())
        with pytest.raises(ValueError, match="stepsPerSync"):
            pam.fitDataSet(_iter(4, batch=16), stepsPerSync=2)

    def test_indivisible_batch_rejected(self, sharded):
        for r in sharded[1]:
            assert "divisible" in r["indivisible"]


# ----------------------------------------------------------------------
# ResilientFit(stepsPerSync=k)
# ----------------------------------------------------------------------
FAST = RetryPolicy(maxRetries=2, initialDelay=1e-4, maxDelay=1e-3)


class TestFitDataSetResilient:
    def test_block_parity_with_per_batch_guarded(self):
        a, b, c = _net(), _net(), _net()
        ResilientFit(a).fit(_iter(8, batch=16), epochs=1)
        ResilientFit(b).fit(_iter(8, batch=16), epochs=1, stepsPerSync=4)
        c.fit(_iter(8, batch=16))
        assert torch.equal(_flat(a), _flat(b))
        assert torch.equal(_flat(a), _flat(c))    # the guard is free
        assert a._iteration == b._iteration == 8

    def test_skip_accounting_from_k_vector(self):
        net = _net()
        events = ResilienceListener()
        net.setListeners(events)
        inj = FaultInjector().poisonStep(2).poisonStep(5)
        rf = ResilientFit(net, injector=inj)
        rf.fit(_iter(8, batch=16), epochs=1, stepsPerSync=4)
        assert rf.skippedSteps == 2
        skips = [e for e in events.events if e[0] == "skip"]
        assert [e[1] for e in skips] == [3, 6]
        assert all(not np.isfinite(e[2]) for e in skips)
        assert net._iteration == 8

    def test_consecutive_bad_aborts_mid_block(self):
        net = _net()
        inj = FaultInjector().poisonStep(1, 2, 3)
        rf = ResilientFit(net, injector=inj, maxConsecutiveBadSteps=3)
        with pytest.raises(NonFiniteStepError):
            rf.fit(_iter(8, batch=16), epochs=1, stepsPerSync=4)
        assert rf.skippedSteps == 3

    def test_abort_mid_block_params_match_k1(self):
        def run(k):
            net = _net()
            inj = FaultInjector().poisonStep(0, 1, 2)
            rf = ResilientFit(net, injector=inj, maxConsecutiveBadSteps=3)
            with pytest.raises(NonFiniteStepError):
                rf.fit(_iter(8, batch=16), epochs=1, stepsPerSync=k)
            return net

        a, b = run(1), run(4)
        assert a._iteration == b._iteration == 3
        assert torch.equal(_flat(a), _flat(b))
        assert torch.equal(_flat(a), _flat(_net()))   # nothing trained

    def test_resume_mid_epoch_matches_uninterrupted(self, tmp_path):
        ref = _net()
        ResilientFit(ref, retryPolicy=FAST).fit(
            _iter(4, batch=16), epochs=2, stepsPerSync=2)
        net = _net()
        rf = ResilientFit(net, tmp_path / "ck", saveEveryNIterations=2,
                          retryPolicy=FAST,
                          injector=FaultInjector().killAfterStep(5))
        with pytest.raises(Preemption):
            rf.fit(_iter(4, batch=16), epochs=2, stepsPerSync=2)
        assert net._iteration == 6
        net2 = _net()
        ResilientFit(net2, tmp_path / "ck", saveEveryNIterations=2,
                     retryPolicy=FAST).fit(_iter(4, batch=16), epochs=2,
                                           stepsPerSync=2)
        assert net2._iteration == 8
        assert torch.equal(_flat(ref), _flat(net2))
