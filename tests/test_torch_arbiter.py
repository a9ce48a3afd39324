"""Port parity for Arbiter (deeplearning4j_tpu_torch/arbiter) against the
JAX reference, and the reference's tests/test_arbiter.py cases on the
port.

Every generator draws from ``np.random.RandomState(seed)``, so for one
seed the port's random, grid and genetic generators emit the reference's
candidates, exactly (the genetic one given the same reported scores).
A candidate's score is held to the reference's from carried weights:
held-out loss within 1e-5 relative before and after two epochs of fit
(f32; the products sum in another order), accuracy equal.
"""

import math

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import arbiter as JA
from deeplearning4j_tpu.data import DataSetIterator as JIterator
from deeplearning4j_tpu_torch.arbiter import (
    ComputationGraphSpace, ContinuousParameterSpace, DenseLayerSpace,
    DiscreteParameterSpace, EvaluationScoreFunction,
    GeneticSearchCandidateGenerator, GridSearchCandidateGenerator,
    IntegerParameterSpace, LocalOptimizationRunner, MaxCandidatesCondition,
    MaxTimeCondition, MultiLayerSpace, OptimizationConfiguration,
    OutputLayerSpace, RandomSearchGenerator, TestSetLossScoreFunction,
)
from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.nn import (Adam, ComputationGraph, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.nn.losses import LossFunctions

torch.set_num_threads(1)

LF = LossFunctions.LossFunction
LOSS_REL = 1e-5


def _xy(seed=0, n=64):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype("float32")
    y = (X.sum(1) > 0).astype(int)
    return X, np.eye(2, dtype="float32")[y]


def _data(seed=0, n=64):
    return DataSetIterator(*_xy(seed, n), 32)


def _ref_data(seed=0, n=64):
    return JIterator(*_xy(seed, n), 32)


def _builder(candidate):
    conf = (NeuralNetConfiguration.Builder()
            .seed(7).updater(Adam(candidate["lr"]))
            .list()
            .layer(DenseLayer(nIn=6, nOut=candidate.get("hidden", 8),
                              activation=candidate.get("act", "tanh")))
            .layer(OutputLayer(nOut=2, activation="softmax",
                               lossFunction=LF.MCXENT))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _mixed(mod):
    return {"lr": mod.ContinuousParameterSpace(1e-4, 1e-1, log=True),
            "act": mod.DiscreteParameterSpace("relu", "tanh"),
            "hidden": mod.IntegerParameterSpace(4, 16),
            "drop": mod.ContinuousParameterSpace(0.0, 0.5)}


class TestCandidateSequencesMatchTheReference:
    def test_random(self):
        import deeplearning4j_tpu_torch.arbiter as PA

        mine = RandomSearchGenerator(_mixed(PA), seed=13)
        ref = JA.RandomSearchGenerator(_mixed(JA), seed=13)
        assert [mine.next() for _ in range(25)] == \
            [ref.next() for _ in range(25)]

    def test_grid(self):
        import deeplearning4j_tpu_torch.arbiter as PA

        mine = GridSearchCandidateGenerator(_mixed(PA), discretizationCount=3)
        ref = JA.GridSearchCandidateGenerator(_mixed(JA),
                                              discretizationCount=3)
        assert len(mine) == len(ref) == 3 * 2 * 3 * 3
        got, want = [], []
        while mine.hasMore():
            got.append(mine.next())
        while ref.hasMore():
            want.append(ref.next())
        assert got == want

    def test_genetic_with_reported_scores(self):
        import deeplearning4j_tpu_torch.arbiter as PA

        mine = GeneticSearchCandidateGenerator(_mixed(PA), populationSize=6,
                                               seed=21)
        ref = JA.GeneticSearchCandidateGenerator(_mixed(JA),
                                                 populationSize=6, seed=21)
        for i in range(30):      # five generations, a failure among them
            c, w = mine.next(), ref.next()
            assert c == w, i
            score = (float("inf") if i == 4 else
                     math.log(c["lr"]) ** 2 + c["hidden"] / 16.0)
            mine.reportResult(c, score, True)
            ref.reportResult(w, score, True)
        assert mine.generation == ref.generation == 4


class TestCandidateScoreMatchesTheReference:
    def _pair(self):
        import deeplearning4j_tpu_torch.arbiter as PA
        from deeplearning4j_tpu.nn import InputType as JInputType

        def space(mod, input_type):
            return (mod.MultiLayerSpace.Builder().seed(7)
                    .learningRate(mod.ContinuousParameterSpace(
                        1e-3, 1e-1, log=True))
                    .addLayer(mod.DenseLayerSpace(
                        nIn=6, nOut=mod.IntegerParameterSpace(4, 16),
                        activation="tanh"))
                    .addLayer(mod.OutputLayerSpace(nOut=2,
                                                   activation="softmax"))
                    .setInputType(input_type))

        jb = space(JA, JInputType.feedForward(6))
        pb = space(PA, InputType.feedForward(6))
        cand = {"learningRate": 0.02, "0_nOut": 11}
        jn = jb.build().modelBuilder(cand)
        pn = pb.device("cpu").build().modelBuilder(cand)
        pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                                 jax.tree.map(np.asarray, jn._states))
        return jn, pn

    def test_loss_and_accuracy_before_and_after_fit(self):
        jn, pn = self._pair()
        for trained in (False, True):
            if trained:
                jn.fit(_ref_data(seed=0), epochs=2)
                pn.fit(_data(seed=0), epochs=2)
            want = JA.TestSetLossScoreFunction(_ref_data(seed=1)).score(jn)
            got = TestSetLossScoreFunction(_data(seed=1)).score(pn)
            assert abs(got - want) <= LOSS_REL * abs(want), (trained, got,
                                                             want)
            assert EvaluationScoreFunction(_data(seed=1)).score(pn) == \
                JA.EvaluationScoreFunction(_ref_data(seed=1)).score(jn)


# ----------------------------------------------------------------------
# tests/test_arbiter.py's cases on the port
# ----------------------------------------------------------------------

class TestSpaces:
    def test_continuous(self):
        rng = np.random.RandomState(0)
        s = ContinuousParameterSpace(0.1, 0.5)
        assert all(0.1 <= s.sample(rng) <= 0.5 for _ in range(100))
        assert s.grid(3) == [0.1, pytest.approx(0.3), 0.5]

    def test_continuous_log(self):
        rng = np.random.RandomState(0)
        s = ContinuousParameterSpace(1e-4, 1e-1, log=True)
        vals = [s.sample(rng) for _ in range(200)]
        assert all(1e-4 <= v <= 1e-1 for v in vals)
        frac = sum(v < 10 ** (-2.5) for v in vals) / len(vals)
        assert 0.35 < frac < 0.65
        g = s.grid(4)
        assert g[0] == pytest.approx(1e-4) and g[-1] == pytest.approx(1e-1)

    def test_discrete_and_integer(self):
        rng = np.random.RandomState(0)
        d = DiscreteParameterSpace("relu", "tanh")
        assert set(d.sample(rng) for _ in range(50)) == {"relu", "tanh"}
        i = IntegerParameterSpace(4, 16)
        vals = [i.sample(rng) for _ in range(100)]
        assert min(vals) >= 4 and max(vals) <= 16
        assert i.grid(3) == [4, 10, 16]
        assert i.grid(100) == list(range(4, 17))


class TestFromUnit:
    def test_endpoints_and_clamps(self):
        s = ContinuousParameterSpace(0.1, 0.5)
        assert s.from_unit(-0.3) == pytest.approx(0.1)
        assert s.from_unit(1.7) == pytest.approx(0.5)
        lg = ContinuousParameterSpace(1e-4, 1e-1, log=True)
        assert lg.from_unit(0.5) == pytest.approx(np.sqrt(1e-4 * 1e-1))
        d = DiscreteParameterSpace("a", "b", "c")
        assert [d.from_unit(u) for u in (0.0, 0.5, 1.0, -2.0)] == \
            ["a", "b", "c", "a"]
        i = IntegerParameterSpace(2, 5)
        assert (i.from_unit(0.0), i.from_unit(1.0), i.from_unit(-0.4)) == \
            (2, 5, 2)


class TestRunner:
    def test_random_search_finds_working_lr(self):
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(RandomSearchGenerator(
                    {"lr": ContinuousParameterSpace(1e-3, 1e-1, log=True)},
                    seed=1))
                .scoreFunction(TestSetLossScoreFunction(_data(seed=1)))
                .terminationConditions(MaxCandidatesCondition(5))
                .epochsPerCandidate(20)
                .build())
        result = LocalOptimizationRunner(conf, _builder,
                                         _data(seed=0)).execute()
        assert len(result.results) == 5
        assert result.bestScore() == min(r.score for r in result.results)
        assert result.bestScore() < 0.5
        assert result.bestModel() is not None

    def test_grid_search_accuracy_maximized(self):
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(GridSearchCandidateGenerator(
                    {"lr": DiscreteParameterSpace(1e-9, 3e-2),
                     "act": DiscreteParameterSpace("relu", "tanh")}))
                .scoreFunction(EvaluationScoreFunction(_data(seed=1),
                                                       "accuracy"))
                .terminationConditions(MaxCandidatesCondition(100))
                .epochsPerCandidate(15)
                .build())
        result = LocalOptimizationRunner(conf, _builder,
                                         _data(seed=0)).execute()
        assert len(result.results) == 4
        assert result.bestScore() == max(r.score for r in result.results)
        assert result.bestCandidate()["lr"] == pytest.approx(3e-2)

    def test_failed_candidate_does_not_kill_search(self):
        def builder(candidate):
            if candidate["hidden"] == 0:
                raise ValueError("bad config")
            return _builder({"lr": 1e-2, "hidden": candidate["hidden"]})

        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(GridSearchCandidateGenerator(
                    {"hidden": DiscreteParameterSpace(0, 8)}))
                .scoreFunction(TestSetLossScoreFunction(_data(seed=1)))
                .terminationConditions(MaxCandidatesCondition(10))
                .epochsPerCandidate(3)
                .build())
        result = LocalOptimizationRunner(conf, builder,
                                         _data(seed=0)).execute()
        assert len(result.results) == 2
        assert result.results[0].error is not None
        assert result.results[0].model is None
        assert result.bestCandidate() == {"hidden": 8}

    def test_a_kernel_larger_than_its_input_fails_only_its_candidate(self):
        from deeplearning4j_tpu_torch.arbiter import (ConvolutionLayerSpace,
                                                      LayerSpace)
        from deeplearning4j_tpu_torch.nn import GlobalPoolingLayer

        space = (MultiLayerSpace.Builder().seed(3).device("cpu")
                 .learningRate(1e-2)
                 .addLayer(ConvolutionLayerSpace(
                     nOut=4, kernelSize=DiscreteParameterSpace((1, 1),
                                                               (5, 5)),
                     activation="relu"))
                 .addLayer(LayerSpace(GlobalPoolingLayer,
                                      poolingType="avg"))
                 .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
                 .setInputType(InputType.convolutional(2, 2, 1)).build())
        rng = np.random.RandomState(0)
        x = rng.rand(8, 1, 2, 2).astype("float32")
        data = DataSetIterator(x, np.eye(2, dtype="float32")[
            rng.randint(0, 2, 8)], 4)
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(GridSearchCandidateGenerator(
                    space.parameterSpaces()))
                .scoreFunction(TestSetLossScoreFunction(data))
                .terminationConditions(MaxCandidatesCondition(10)).build())
        res = LocalOptimizationRunner(conf, space.modelBuilder,
                                      data).execute()
        assert [r.error is None for r in res.results] == [True, False]
        # the convolution's own shape check, raised in the first fit step
        assert "Kernel size" in str(res.results[1].error)
        assert res.bestCandidate() == {"0_kernelSize": (1, 1)}

    def test_max_time_condition(self):
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(RandomSearchGenerator(
                    {"lr": ContinuousParameterSpace(1e-3, 1e-1)}))
                .scoreFunction(TestSetLossScoreFunction(_data(seed=1)))
                .terminationConditions(MaxCandidatesCondition(3),
                                       MaxTimeCondition(0.0))
                .build())
        with pytest.raises(RuntimeError):
            LocalOptimizationRunner(conf, _builder, _data(seed=0)).execute()


class _FakeModel:
    def __init__(self, candidate):
        self.candidate = candidate

    def fit(self, data, epochs=1):
        pass


class _SphereScore:
    def __init__(self, targets):
        self.targets = targets

    def minimize(self):
        return True

    def score(self, model):
        return float(sum((model.candidate[k] - t) ** 2
                         for k, t in self.targets.items()))


class TestGeneticSearch:
    SPACES = {k: ContinuousParameterSpace(0.0, 1.0) for k in "abcd"}
    TARGETS = {"a": 0.31, "b": 0.77, "c": 0.12, "d": 0.58}

    def _run(self, gen, budget=120):
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(gen)
                .scoreFunction(_SphereScore(self.TARGETS))
                .terminationConditions(MaxCandidatesCondition(budget))
                .build())
        return LocalOptimizationRunner(conf, _FakeModel, None).execute()

    def test_beats_random_on_sphere(self):
        g_best = self._run(GeneticSearchCandidateGenerator(
            self.SPACES, populationSize=15, seed=11)).bestScore()
        r_best = self._run(RandomSearchGenerator(self.SPACES,
                                                 seed=11)).bestScore()
        assert g_best < r_best, (g_best, r_best)
        assert g_best < 0.01, g_best

    def test_generations_advance_and_improve(self):
        gen = GeneticSearchCandidateGenerator(self.SPACES, populationSize=10,
                                              seed=3)
        scores = [r.score for r in self._run(gen, budget=80).results]
        assert gen.generation >= 7
        assert np.mean(scores[-10:]) < np.mean(scores[:10])

    def test_breeding_without_feedback_raises(self):
        gen = GeneticSearchCandidateGenerator(self.SPACES, populationSize=2,
                                              seed=0)
        gen.next()
        gen.next()
        with pytest.raises(RuntimeError, match="reportResult"):
            gen.next()

    def test_failed_candidates_get_worst_fitness(self):
        gen = GeneticSearchCandidateGenerator(self.SPACES, populationSize=4,
                                              seed=0)
        c = gen.next()
        gen.reportResult(c, float("inf"), True)
        assert gen._scored[-1][1] == float("-inf")


class TestMultiLayerSpace:
    def _space(self):
        return (MultiLayerSpace.Builder().seed(7).device("cpu")
                .learningRate(ContinuousParameterSpace(1e-3, 1e-1, log=True))
                .addLayer(DenseLayerSpace(
                    nIn=6, nOut=IntegerParameterSpace(4, 16),
                    activation=DiscreteParameterSpace("relu", "tanh")))
                .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
                .build())

    def test_parameter_space_keys(self):
        assert set(self._space().parameterSpaces()) == {
            "learningRate", "0_nOut", "0_activation"}

    def test_model_builder_materializes_candidate(self):
        net = self._space().modelBuilder(
            {"learningRate": 0.01, "0_nOut": 9, "0_activation": "tanh"})
        assert net.getParam("0_W").shape() == (6, 9)
        assert net.getParam("1_W").shape() == (9, 2)
        assert net.device.type == "cpu"

    def test_random_search_over_space_finds_good_model(self):
        space = self._space()
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(RandomSearchGenerator(
                    space.parameterSpaces(), seed=4))
                .scoreFunction(EvaluationScoreFunction(_data(seed=1)))
                .terminationConditions(MaxCandidatesCondition(4))
                .epochsPerCandidate(8).build())
        res = LocalOptimizationRunner(conf, space.modelBuilder,
                                      _data(seed=0)).execute()
        assert res.bestScore() > 0.8
        assert set(res.bestCandidate()) == {"learningRate", "0_nOut",
                                            "0_activation"}

    def test_all_fixed_raises_and_type_check(self):
        space = (MultiLayerSpace.Builder()
                 .addLayer(DenseLayerSpace(nIn=4, nOut=8))
                 .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
                 .build())
        with pytest.raises(ValueError, match="nothing to search"):
            space.parameterSpaces()
        with pytest.raises(TypeError, match="LayerSpace"):
            MultiLayerSpace.Builder().addLayer(object())

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        space = (MultiLayerSpace.Builder()
                 .learningRate(ContinuousParameterSpace(1e-3, 1e-1))
                 .addLayer(DenseLayerSpace(nIn=4, nOut=8))
                 .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
                 .build())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            space.modelBuilder({"learningRate": 0.01})


class TestComputationGraphSpace:
    def _space(self):
        return (ComputationGraphSpace.Builder().seed(7).device("cpu")
                .learningRate(ContinuousParameterSpace(1e-3, 1e-1, log=True))
                .addInputs("in")
                .addLayer("dense", DenseLayerSpace(
                    nIn=6, nOut=IntegerParameterSpace(4, 16),
                    activation="tanh"), "in")
                .addLayer("out", OutputLayerSpace(nOut=2,
                                                  activation="softmax"),
                          "dense")
                .setOutputs("out")
                .setInputTypes(InputType.feedForward(6))
                .build())

    def test_keys_are_vertex_named(self):
        assert set(self._space().parameterSpaces()) == {"learningRate",
                                                        "dense_nOut"}

    def test_search_over_graph_space(self):
        space = self._space()
        conf = (OptimizationConfiguration.Builder()
                .candidateGenerator(RandomSearchGenerator(
                    space.parameterSpaces(), seed=3))
                .scoreFunction(EvaluationScoreFunction(_data(seed=1)))
                .terminationConditions(MaxCandidatesCondition(3))
                .epochsPerCandidate(8).build())
        res = LocalOptimizationRunner(conf, space.modelBuilder,
                                      _data(seed=0)).execute()
        assert res.bestScore() > 0.8
        assert isinstance(res.bestModel(), ComputationGraph)
