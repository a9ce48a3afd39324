"""Port parity for the listeners and early stopping
(deeplearning4j_tpu_torch/optimize/) against the JAX reference.

Mirrors tests/test_optimize.py's TestListeners and TestEarlyStopping on
the port. Where a case's numbers depend on training, the reference's toy
net and the port's start from the same weights (carried with
``load_reference_params``) and see the same batches, and the port is held
to the reference: iteration lists, epoch counts, termination reasons and
which epoch was best exactly; scores rel 1e-5 (f32, the two frameworks
sum in another order). EarlyStoppingParallelTrainer waits for the rest
of the data-parallel slice: its refusal is checked.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.optimize as JO
from deeplearning4j_tpu.data import DataSetIterator as JIterator
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.optimize as PO
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.optimize import (
    BestScoreEpochTerminationCondition, CheckpointListener,
    CollectScoresListener, DataSetLossCalculator, EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer, EarlyStoppingParallelTrainer,
    EarlyStoppingTrainer, EvaluativeListener, InMemoryModelSaver,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition, MetricsListener, NanScoreWatcher,
    PerformanceListener, ResilienceListener,
    ScoreImprovementEpochTerminationCondition, ScoreIterationListener,
    StatsListener, TerminationReason, TimeIterationListener,
)

torch.set_num_threads(1)
REL = 1e-5


def _conf(M, lr, seed):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Adam(lr)).list()
            .layer(M.DenseLayer(nIn=4, nOut=16, activation="tanh"))
            .layer(M.OutputLayer(nIn=16, nOut=2, activation="softmax",
                                 lossFunction="mcxent"))
            .build())


def _toy_net(lr=5e-2, seed=7):
    return P.MultiLayerNetwork(_conf(P, lr, seed), device="cpu").init()


def _toy_pair(lr=5e-2, seed=7):
    """The reference's toy net and the port's, from the same weights."""
    jn = J.MultiLayerNetwork(_conf(J, lr, seed)).init()
    pn = _toy_net(lr, seed)
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def _toy_arrays(n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype("float32")
    Y = np.eye(2, dtype="float32")[(X.sum(1) > 0).astype(int)]
    return X, Y


def _toy_data(n=64, seed=0):
    return DataSet(*_toy_arrays(n, seed))


def _iterator(n=64, batch=16, seed=0, M=None):
    X, Y = _toy_arrays(n, seed)
    return (M or DataSetIterator)(X, Y, batch)


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(b), 1e-6), (a, b)


class TestListeners:
    def test_collect_scores(self):
        jn, pn = _toy_pair()
        jc, pc = JO.CollectScoresListener(), CollectScoresListener()
        jn.setListeners(jc)
        pn.setListeners(pc)
        jn.fit(_iterator(M=JIterator), epochs=3)
        pn.fit(_iterator(), epochs=3)
        assert pc.iterations == jc.iterations == list(range(1, 13))
        for a, b in zip(pc.scores, jc.scores):
            _close(a, b)
        assert pc.scores[-1] < pc.scores[0]

    def test_score_iteration_listener_prints(self, capsys):
        net = _toy_net()
        net.setListeners(ScoreIterationListener(2))
        net.fit(_iterator(), epochs=1)
        out = capsys.readouterr().out
        assert "Score at iteration 2" in out
        assert "Score at iteration 4" in out

    def test_performance_listener(self, capsys):
        net = _toy_net()
        net.setListeners(PerformanceListener(frequency=2, reportScore=True))
        net.fit(_iterator(), epochs=2)
        assert "iterations/sec" in capsys.readouterr().out

    def test_evaluative_listener_epoch(self):
        jn, pn = _toy_pair()
        seen = {"j": [], "p": []}
        for tag, net, it, cls in (("j", jn, JIterator, JO.EvaluativeListener),
                                  ("p", pn, DataSetIterator,
                                   EvaluativeListener)):
            lst = cls(_iterator(seed=1, M=it), invocationType=cls.EPOCH)
            lst.callback = lambda e, t=tag: seen[t].append(e.accuracy())
            net.setListeners(lst)
            net.fit(_iterator(M=it), epochs=3)
        assert len(seen["p"]) == 3 and seen["p"][-1] >= 0.5
        assert seen["p"] == seen["j"]

    def test_checkpoint_listener_rotation(self, tmp_path):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        net = _toy_net()
        cl = CheckpointListener(tmp_path, saveEveryNIterations=2, keepLast=2)
        net.setListeners(cl)
        net.fit(_iterator(), epochs=2)
        assert len(os.listdir(tmp_path)) == 2
        assert cl.lastCheckpoint().endswith("checkpoint_iter_8.npz")
        restored = ModelSerializer.restoreMultiLayerNetwork(
            cl.lastCheckpoint(), device="cpu")
        assert restored.score(_toy_data()) == net.score(_toy_data())

    def test_stats_listener_jsonl(self, tmp_path):
        log = tmp_path / "stats.jsonl"
        net = _toy_net()
        net.setListeners(StatsListener(logFile=log, frequency=1,
                                       collectHistograms=True))
        net.fit(_iterator(), epochs=2)
        recs = [json.loads(x) for x in log.read_text().strip().splitlines()]
        assert sum(r["type"] == "stats" for r in recs) == 8
        assert sum(r["type"] == "epochEnd" for r in recs) == 2
        assert all("paramMeanAbs" in r for r in recs if r["type"] == "stats")
        assert "records" in StatsListener(logFile=log).summary()

    def test_nan_watcher_raises(self):
        net = _toy_net()
        net.setListeners(NanScoreWatcher())
        X, Y = _toy_arrays()
        X[0, 0] = np.nan
        with pytest.raises(FloatingPointError):
            net.fit(DataSet(X, Y))

    def test_time_metrics_and_resilience_listeners(self, capsys):
        from deeplearning4j_tpu_torch.runtime.telemetry import MetricsRegistry

        reg = MetricsRegistry()
        net = _toy_net()
        rl = ResilienceListener()
        net.setListeners(TimeIterationListener(8, frequency=2),
                         MetricsListener(registry=reg), rl)
        net.fit(_iterator(), epochs=2)
        assert "ETA" in capsys.readouterr().out
        text = reg.prometheus()
        assert "dl4j_train_iterations_total 8" in text
        assert "dl4j_train_epochs_total 2" in text
        assert rl.events == [] and rl.skippedSteps == 0


class TestEarlyStopping:
    def _conf(self, O, it_cls, *conds, saver=None, seed=1):
        b = (O.EarlyStoppingConfiguration.Builder()
             .epochTerminationConditions(*conds)
             .scoreCalculator(O.DataSetLossCalculator(
                 _iterator(seed=seed, M=it_cls))))
        if saver is not None:
            b = b.modelSaver(saver)
        return b.build()

    def test_max_epochs(self):
        jn, pn = _toy_pair()
        jr = JO.EarlyStoppingTrainer(
            self._conf(JO, JIterator, JO.MaxEpochsTerminationCondition(3)),
            jn, _iterator(M=JIterator)).fit()
        pr = EarlyStoppingTrainer(
            self._conf(PO, DataSetIterator, MaxEpochsTerminationCondition(3),
                       saver=InMemoryModelSaver()), pn, _iterator()).fit()
        assert pr.terminationReason == \
            TerminationReason.EpochTerminationCondition
        assert pr.terminationReason.value == jr.terminationReason.value
        assert pr.totalEpochs == jr.totalEpochs == 3
        assert sorted(pr.scoreVsEpoch) == sorted(jr.scoreVsEpoch)
        for e in pr.scoreVsEpoch:
            _close(pr.scoreVsEpoch[e], jr.scoreVsEpoch[e])
        assert pr.bestModelEpoch == jr.bestModelEpoch
        assert pr.getBestModel() is not None

    def test_score_improvement_stops_early(self):
        net = _toy_net(lr=0.0)
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(
                    MaxEpochsTerminationCondition(50),
                    ScoreImprovementEpochTerminationCondition(
                        2, minImprovement=1e-9))
                .scoreCalculator(DataSetLossCalculator(_iterator(seed=1)))
                .build())
        result = EarlyStoppingTrainer(conf, net, _iterator()).fit()
        assert result.terminationReason == \
            TerminationReason.EpochTerminationCondition
        assert "ScoreImprovement" in result.terminationDetails
        assert result.totalEpochs == 3

    def test_best_score_condition(self):
        jn, pn = _toy_pair()
        results = []
        for O, net, it in ((JO, jn, JIterator), (PO, pn, DataSetIterator)):
            conf = (O.EarlyStoppingConfiguration.Builder()
                    .epochTerminationConditions(
                        O.MaxEpochsTerminationCondition(200),
                        O.BestScoreEpochTerminationCondition(0.15))
                    .scoreCalculator(O.DataSetLossCalculator(
                        _iterator(seed=0, M=it))).build())
            results.append(O.EarlyStoppingTrainer(conf, net,
                                                  _iterator(M=it)).fit())
        jr, pr = results
        assert pr.bestModelScore <= 0.16
        assert pr.totalEpochs == jr.totalEpochs
        _close(pr.bestModelScore, jr.bestModelScore)

    def test_iteration_condition_score_explosion(self):
        net = _toy_net(lr=1e9)
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(MaxEpochsTerminationCondition(50))
                .iterationTerminationConditions(
                    MaxScoreIterationTerminationCondition(100.0))
                .scoreCalculator(DataSetLossCalculator(_iterator(seed=1)))
                .build())
        result = EarlyStoppingTrainer(conf, net, _iterator()).fit()
        assert result.terminationReason == \
            TerminationReason.IterationTerminationCondition
        assert net._listeners == []

    def test_max_time_condition(self):
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(
                    MaxEpochsTerminationCondition(100000))
                .iterationTerminationConditions(
                    MaxTimeIterationTerminationCondition(0.0))
                .scoreCalculator(DataSetLossCalculator(_iterator(seed=1)))
                .build())
        result = EarlyStoppingTrainer(conf, _toy_net(), _iterator()).fit()
        assert result.terminationReason == \
            TerminationReason.IterationTerminationCondition

    def test_best_model_is_restored_snapshot(self):
        net = _toy_net()
        val = _iterator(seed=1)
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(MaxEpochsTerminationCondition(5))
                .scoreCalculator(DataSetLossCalculator(val))
                .modelSaver(InMemoryModelSaver()).build())
        result = EarlyStoppingTrainer(conf, net, _iterator()).fit()
        best = result.getBestModel()
        assert DataSetLossCalculator(val).calculateScore(best) == \
            result.bestModelScore

    def test_snapshot_does_not_alias_live_buffers(self):
        net = _toy_net()
        saver = InMemoryModelSaver()
        saver.saveBestModel(net, 0.5)
        snap = saver.getBestModel()
        for live, saved in zip(net._params, snap._params):
            for k in live:
                assert live[k] is not saved[k]
                assert live[k].data_ptr() != saved[k].data_ptr()
        before = snap.params().tensor().clone()
        net.fit(_toy_data())
        assert torch.equal(snap.params().tensor(), before)

    def test_duck_typed_listener_without_epoch_hooks(self):
        class Minimal:
            seen = 0

            def iterationDone(self, model, it, ep):
                Minimal.seen += 1

        net = _toy_net()
        net.setListeners(Minimal())
        net.fit(_iterator(), epochs=1)
        net.fitDataSet(_iterator(), stepsPerSync=2)
        assert Minimal.seen == 8

    def test_skipped_eval_epochs_do_not_mix_metrics(self):
        class AccuracyCalc:
            def __init__(self, it):
                self.it = it

            def minimizeScore(self):
                return False

            def calculateScore(self, model):
                return model.evaluate(self.it).accuracy()

        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(
                    MaxEpochsTerminationCondition(6),
                    BestScoreEpochTerminationCondition(0.95))
                .scoreCalculator(AccuracyCalc(_iterator(seed=1)))
                .evaluateEveryNEpochs(5).build())
        result = EarlyStoppingTrainer(conf, _toy_net(lr=0.0),
                                      _iterator()).fit()
        assert result.totalEpochs == 6
        assert "MaxEpochs" in result.terminationDetails

    def test_local_file_saver_roundtrip(self, tmp_path):
        net = _toy_net()
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(MaxEpochsTerminationCondition(2))
                .scoreCalculator(DataSetLossCalculator(_iterator(seed=1)))
                .modelSaver(LocalFileModelSaver(tmp_path))
                .saveLastModel(True).build())
        result = EarlyStoppingTrainer(conf, net, _iterator()).fit()
        assert os.path.exists(tmp_path / "bestModel.npz")
        assert os.path.exists(tmp_path / "latestModel.npz")
        best = result.getBestModel()
        assert math.isfinite(best.score(_toy_data()))
        assert DataSetLossCalculator(_iterator(seed=1)).calculateScore(
            best) == result.bestModelScore

    def test_graph_trainer_on_a_computation_graph(self):
        g = (P.NeuralNetConfiguration.Builder().seed(0).updater(P.Adam(5e-2))
             .graphBuilder().addInputs("in")
             .addLayer("h", P.DenseLayer(nOut=8, activation="tanh"), "in")
             .addLayer("out", P.OutputLayer(nOut=2, activation="softmax"),
                       "h")
             .setOutputs("out").setInputTypes(P.InputType.feedForward(4))
             .build())
        net = P.ComputationGraph(g, device="cpu").init()
        conf = (EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(MaxEpochsTerminationCondition(2))
                .scoreCalculator(DataSetLossCalculator(_iterator(seed=1)))
                .build())
        result = EarlyStoppingGraphTrainer(conf, net, _iterator()).fit()
        assert result.totalEpochs == 2 and len(result.scoreVsEpoch) == 2


def test_parallel_early_stopping_waits_for_item_7():
    conf = (EarlyStoppingConfiguration.Builder()
            .epochTerminationConditions(MaxEpochsTerminationCondition(1))
            .build())
    with pytest.raises(NotImplementedError, match="item 7"):
        EarlyStoppingParallelTrainer(conf, _toy_net(), _iterator())
