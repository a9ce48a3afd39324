"""Port parity for the evaluation package (deeplearning4j_tpu_torch/
evaluation/) and the networks' doEvaluation/evaluate* against the JAX
reference.

Mirrors tests/test_eval.py case by case: every metric the case reads is
computed by both packages from the same seeded numpy labels and outputs
(masks included) and held to the reference's. Tolerances: counts
(confusion matrices, TP/FP/TN/FN, histograms) exactly; floats within
1e-12 absolute in f64 (both packages do the same numpy arithmetic, so in
practice they are equal). The original oracles (closed forms, the
rank-based AUC, numpy's corrcoef) are kept as well. The network cases
train the port's nets, then hold their doEvaluation/evaluate* to the
reference's evaluation classes over the same port outputs.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.evaluation as JE
import deeplearning4j_tpu_torch.evaluation as PE
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSetIterator

torch.set_num_threads(1)
TOL = 1e-12


def _pair(name, *args, **kw):
    return getattr(JE, name)(*args, **kw), getattr(PE, name)(*args, **kw)


def _eval(name, *data, ctor=(), **kw):
    j, p = _pair(name, *ctor, **kw)
    j.eval(*data)
    p.eval(*data)
    return j, p


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL, equal_nan=True)


def _auc_oracle(y, s):
    pos, neg = s[y == 1], s[y == 0]
    wins = (pos[:, None] > neg[None, :]).sum() \
        + 0.5 * (pos[:, None] == neg[None, :]).sum()
    return wins / (len(pos) * len(neg))


# ---------------------------------------------------------------- regression
class TestRegressionEvaluation:
    def test_known_values(self):
        y = np.array([[1.0], [2.0], [3.0], [4.0]])
        p = np.array([[1.5], [2.5], [2.5], [4.0]])
        j, e = _eval("RegressionEvaluation", y, p)
        err = p - y
        assert e.meanSquaredError(0) == pytest.approx(np.mean(err ** 2))
        for m in ("meanSquaredError", "meanAbsoluteError",
                  "rootMeanSquaredError"):
            _close(getattr(j, m)(0), getattr(e, m)(0))

    def test_r2_and_correlation_vs_numpy(self):
        rng = np.random.RandomState(7)
        y = rng.randn(200, 3)
        p = y + 0.3 * rng.randn(200, 3)
        j, e = _eval("RegressionEvaluation", y, p, nColumns=3)
        for c in range(3):
            assert e.pearsonCorrelation(c) == pytest.approx(
                np.corrcoef(y[:, c], p[:, c])[0, 1], abs=1e-9)
            _close(j.rSquared(c), e.rSquared(c))
            _close(j.pearsonCorrelation(c), e.pearsonCorrelation(c))

    def test_streaming_equals_single_batch(self):
        rng = np.random.RandomState(1)
        y, p = rng.randn(100, 2), rng.randn(100, 2)
        j, e = _pair("RegressionEvaluation")
        for i in range(0, 100, 17):
            j.eval(y[i:i + 17], p[i:i + 17])
            e.eval(y[i:i + 17], p[i:i + 17])
        single = PE.RegressionEvaluation().eval(y, p)
        for c in range(2):
            assert e.meanSquaredError(c) == pytest.approx(
                single.meanSquaredError(c))
            _close(j.pearsonCorrelation(c), e.pearsonCorrelation(c))
            _close(j.averageMeanSquaredError(), e.averageMeanSquaredError())

    def test_stats_renders(self):
        j, e = _eval("RegressionEvaluation", np.ones((4, 2)),
                     np.zeros((4, 2)), columnNames=["a", "b"])
        assert e.stats() == j.stats() and "MSE" in e.stats()

    def test_masked_rows(self):
        rng = np.random.RandomState(2)
        y, p = rng.randn(12, 2), rng.randn(12, 2)
        m = (rng.rand(12) > 0.3).astype(np.float32)
        j, e = _eval("RegressionEvaluation", y, p, m)
        for c in range(2):
            _close(j.meanSquaredError(c), e.meanSquaredError(c))


# ---------------------------------------------------------------------- ROC
class TestROC:
    def test_perfect_separation(self):
        y = np.array([0, 0, 1, 1])
        s = np.array([0.1, 0.2, 0.8, 0.9])
        assert PE.ROC().eval(y, s).calculateAUC() == pytest.approx(1.0)
        assert PE.ROC().eval(1 - y, s).calculateAUC() == pytest.approx(0.0)

    def test_exact_auc_vs_rank_oracle(self):
        rng = np.random.RandomState(3)
        y = (rng.rand(300) > 0.6).astype(np.int64)
        s = np.clip(0.35 * rng.randn(300) + 0.5 * y + 0.25, 0, 1)
        j, e = _eval("ROC", y, s)
        assert e.calculateAUC() == pytest.approx(_auc_oracle(y, s), abs=1e-9)
        _close(j.calculateAUC(), e.calculateAUC())
        _close(j.calculateAUCPR(), e.calculateAUCPR())

    def test_thresholded_close_to_exact(self):
        rng = np.random.RandomState(4)
        y = (rng.rand(500) > 0.5).astype(np.int64)
        s = np.clip(0.3 * rng.randn(500) + 0.4 * y + 0.3, 0, 1)
        j, e = _eval("ROC", y, s, ctor=(200,))
        assert e.calculateAUC() == pytest.approx(
            PE.ROC().eval(y, s).calculateAUC(), abs=0.01)
        _close(j.calculateAUC(), e.calculateAUC())

    def test_one_hot_two_column_labels(self):
        y1 = np.array([0, 1, 1, 0])
        s = np.array([0.2, 0.7, 0.6, 0.4])
        j, e = _eval("ROC", np.eye(2)[y1], np.stack([1 - s, s], axis=1))
        assert e.calculateAUC() == pytest.approx(
            PE.ROC().eval(y1, s).calculateAUC())
        _close(j.calculateAUC(), e.calculateAUC())

    def test_streaming(self):
        rng = np.random.RandomState(5)
        y = (rng.rand(200) > 0.5).astype(np.int64)
        s = rng.rand(200)
        j, e = _pair("ROC")
        for i in range(0, 200, 33):
            j.eval(y[i:i + 33], s[i:i + 33])
            e.eval(y[i:i + 33], s[i:i + 33])
        assert e.calculateAUC() == pytest.approx(
            PE.ROC().eval(y, s).calculateAUC())
        _close(j.calculateAUC(), e.calculateAUC())

    def test_aucpr_bounds(self):
        y = np.array([0, 0, 1, 1])
        s = np.array([0.1, 0.2, 0.8, 0.9])
        j, e = _eval("ROC", y, s)
        assert e.calculateAUCPR() == pytest.approx(1.0)
        _close(j.calculateAUCPR(), e.calculateAUCPR())


class TestROCMultiClass:
    def test_matches_binary_one_vs_all(self):
        rng = np.random.RandomState(6)
        n, c = 300, 4
        cls = rng.randint(0, c, n)
        y = np.eye(c)[cls]
        logits = rng.randn(n, c) + 2.0 * y
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        j, m = _eval("ROCMultiClass", y, p)
        for k in range(c):
            assert m.calculateAUC(k) == pytest.approx(
                _auc_oracle((cls == k).astype(np.int64), p[:, k]), abs=1e-9)
            _close(j.calculateAUC(k), m.calculateAUC(k))
        _close(j.calculateAverageAUC(), m.calculateAverageAUC())


class TestROCBinary:
    def test_per_column(self):
        rng = np.random.RandomState(8)
        y = (rng.rand(200, 3) > 0.5).astype(np.int64)
        s = np.clip(rng.rand(200, 3) * 0.5 + 0.5 * y, 0, 1)
        j, rb = _eval("ROCBinary", y, s)
        assert rb.numLabels() == j.numLabels() == 3
        for c in range(3):
            _close(j.calculateAUC(c), rb.calculateAUC(c))


# -------------------------------------------------------- EvaluationBinary
def _binary_counts(e, c):
    return (e.truePositives(c), e.falsePositives(c), e.trueNegatives(c),
            e.falseNegatives(c))


class TestEvaluationBinary:
    def test_counts_and_metrics(self):
        y = np.array([[1, 0], [1, 1], [0, 0], [0, 1]])
        p = np.array([[0.9, 0.2], [0.8, 0.4], [0.3, 0.1], [0.6, 0.9]])
        j, e = _eval("EvaluationBinary", y, p)
        assert _binary_counts(e, 0) == (2, 1, 1, 0)
        for c in range(2):
            assert _binary_counts(e, c) == _binary_counts(j, c)
            for m in ("accuracy", "precision", "recall", "f1"):
                _close(getattr(j, m)(c), getattr(e, m)(c))

    def test_custom_threshold(self):
        y, p = np.array([[1], [0]]), np.array([[0.4], [0.2]])
        for t, acc in ((0.3, 1.0), (0.5, 0.5)):
            j, e = _eval("EvaluationBinary", y, p, decisionThreshold=t)
            assert e.accuracy(0) == j.accuracy(0) == acc

    def test_mcc_perfect(self):
        y = np.array([[1], [1], [0], [0]])
        p = np.array([[0.9], [0.8], [0.1], [0.2]])
        j, e = _eval("EvaluationBinary", y, p)
        assert e.matthewsCorrelation(0) == pytest.approx(1.0)
        _close(j.matthewsCorrelation(0), e.matthewsCorrelation(0))


class TestEvaluationExisting:
    def test_eval_with_rnn_mask(self):
        y = np.zeros((1, 2, 3))
        y[0, 0, :] = 1.0
        p = np.zeros((1, 2, 3))
        p[0, 0, :2] = 1.0
        p[0, 1, 2] = 1.0
        mask = np.array([[1.0, 1.0, 0.0]])
        j, e = _eval("Evaluation", y, p, mask)
        assert e.accuracy() == pytest.approx(1.0)
        np.testing.assert_array_equal(e.getConfusionMatrix(),
                                      j.getConfusionMatrix())

    def test_classification_metrics_and_stats(self):
        rng = np.random.RandomState(9)
        y = np.eye(5)[rng.randint(0, 5, 80)]
        p = rng.rand(80, 5)
        m = (rng.rand(80) > 0.2).astype(np.float32)
        j, e = _eval("Evaluation", y, p, m)
        np.testing.assert_array_equal(e.getConfusionMatrix(),
                                      j.getConfusionMatrix())
        for name in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(j, name)(), getattr(e, name)())
        for c in range(5):
            _close(j.falsePositiveRate(c), e.falsePositiveRate(c))
            _close(j.precision(c), e.precision(c))
        assert e.stats() == j.stats()


class TestReviewRegressions:
    def test_binary_per_output_mask(self):
        y = np.array([[1, 0], [0, 1], [1, 1]])
        p = np.array([[0.9, 0.9], [0.1, 0.9], [0.9, 0.1]])
        mask = np.array([[1, 0], [1, 1], [1, 1]])
        j, e = _eval("EvaluationBinary", y, p, mask)
        assert e.truePositives(0) == 2 and e.trueNegatives(0) == 1
        for c in range(2):
            assert _binary_counts(e, c) == _binary_counts(j, c)
        jr, rb = _eval("ROCBinary", y.astype(float), p, mask)
        assert rb.numLabels() == jr.numLabels() == 2
        for c in range(2):
            _close(jr.calculateAUC(c), rb.calculateAUC(c))

    def test_binary_ncols_mismatch_raises(self):
        with pytest.raises(ValueError, match="outputs"):
            PE.EvaluationBinary(nOutputs=5).eval(np.ones((4, 3)),
                                                 np.ones((4, 3)))

    def test_ismax_tie_single_hot(self):
        from deeplearning4j_tpu_torch.ndarray import Nd4j, Transforms as T

        m = T.isMax(Nd4j.create([[2.0, 2.0]], device="cpu"), dimension=1)
        np.testing.assert_allclose(m.toNumpy(), [[1, 0]])
        g = T.isMax(Nd4j.create([[2.0, 2.0], [1.0, 2.0]], device="cpu"))
        assert g.toNumpy().sum() == 1.0

    def test_hardsigmoid_reference_formula(self):
        from deeplearning4j_tpu_torch.ndarray import Nd4j, Transforms as T

        x = np.array([-3.0, 0.0, 1.0, 3.0])
        np.testing.assert_allclose(
            T.hardSigmoid(Nd4j.create(x, device="cpu")).toNumpy(),
            np.clip(0.2 * x + 0.5, 0, 1), rtol=1e-6)


class TestResetLoudness:
    def test_regression_reset_drops_accumulators(self):
        e = PE.RegressionEvaluation()
        e.eval(np.ones((4, 2)), np.zeros((4, 2)))
        assert e.meanSquaredError(0) == 1.0
        e.reset()
        with pytest.raises((AttributeError, TypeError)):
            e.meanSquaredError(0)
        e.eval(np.ones((4, 2)), np.ones((4, 2)))
        assert e.meanSquaredError(0) == 0.0


class TestEvaluationCalibration:
    def test_perfectly_calibrated_predictions(self):
        rng = np.random.RandomState(0)
        n = 50000
        p1 = rng.rand(n)
        y1 = (rng.rand(n) < p1).astype("float32")
        preds = np.stack([1 - p1, p1], 1).astype("float32")
        labels = np.stack([1 - y1, y1], 1)
        j, ec = _eval("EvaluationCalibration", labels, preds)
        assert ec.expectedCalibrationError() < 0.02
        _close(j.expectedCalibrationError(), ec.expectedCalibrationError())
        for a, b in zip(j.getReliabilityDiagram(1),
                        ec.getReliabilityDiagram(1)):
            _close(a, b)

    def test_overconfident_predictions_flagged(self):
        rng = np.random.RandomState(1)
        n = 20000
        y1 = (rng.rand(n) < 0.5).astype("float32")
        p1 = np.where(rng.rand(n) < 0.5, 0.95, 0.05)
        preds = np.stack([1 - p1, p1], 1).astype("float32")
        labels = np.stack([1 - y1, y1], 1)
        j, ec = _eval("EvaluationCalibration", labels, preds)
        assert ec.expectedCalibrationError() > 0.3
        _close(j.expectedCalibrationError(), ec.expectedCalibrationError())

    def test_histograms_and_stats(self):
        preds = np.array([[0.9, 0.1], [0.2, 0.8]], "float32")
        labels = np.array([[1.0, 0.0], [0.0, 1.0]], "float32")
        j, ec = _eval("EvaluationCalibration", labels, preds,
                      histogramNumBins=5)
        assert ec.getProbabilityHistogram(0).sum() == 2
        np.testing.assert_array_equal(ec.getResidualPlot(),
                                      j.getResidualPlot())
        assert ec.stats() == j.stats()

    def test_accumulates_and_resets(self):
        preds = np.array([[0.7, 0.3]], "float32")
        labels = np.array([[1.0, 0.0]], "float32")
        ec = PE.EvaluationCalibration()
        ec.eval(labels, preds).eval(labels, preds)
        assert ec.getProbabilityHistogram(0).sum() == 2
        ec.reset()
        ec.eval(labels, preds)
        assert ec.getProbabilityHistogram(0).sum() == 1


# ----------------------------------------------------------- the networks
def _cls_net_and_iter():
    conf = (P.NeuralNetConfiguration.Builder().seed(0).updater(P.Adam(5e-2))
            .list().layer(P.DenseLayer(nOut=16, activation="tanh"))
            .layer(P.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(P.InputType.feedForward(4)).build())
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype("float32")
    y = np.eye(2, dtype="float32")[(x.sum(1) > 0).astype(int)]
    it = DataSetIterator(x, y, 16)
    net.fit(it, epochs=30)
    return net, it, x, y


class TestNetEvaluationVariants:
    def test_do_evaluation_multiple_and_roc(self):
        net, it, x, y = _cls_net_and_iter()
        e, roc = net.doEvaluation(it, PE.Evaluation(), PE.ROC())
        assert e.accuracy() > 0.9 and roc.calculateAUC() > 0.9
        out = net.output(x).toNumpy()
        je, jr = JE.Evaluation().eval(y, out), JE.ROC().eval(y, out)
        np.testing.assert_array_equal(e.getConfusionMatrix(),
                                      je.getConfusionMatrix())
        _close(jr.calculateAUC(), roc.calculateAUC())
        _close(jr.calculateAUC(), net.evaluateROC(it).calculateAUC())
        m = net.evaluateROCMultiClass(it)
        _close(JE.ROCMultiClass().eval(y, out).calculateAUC(1),
               m.calculateAUC(1))
        assert net.evaluate(it).accuracy() == e.accuracy()

    def test_evaluate_regression(self):
        conf = (P.NeuralNetConfiguration.Builder().seed(0)
                .updater(P.Adam(5e-2)).list()
                .layer(P.DenseLayer(nOut=8, activation="tanh"))
                .layer(P.OutputLayer(nOut=1, activation="identity",
                                     lossFunction="mse"))
                .setInputType(P.InputType.feedForward(3)).build())
        net = P.MultiLayerNetwork(conf, device="cpu").init()
        rng = np.random.RandomState(1)
        x = rng.randn(64, 3).astype("float32")
        y = (x @ np.array([[1.0], [-2.0], [0.5]])).astype("float32")
        it = DataSetIterator(x, y, 16)
        net.fit(it, epochs=60)
        r = net.evaluateRegression(it)
        assert r.averageMeanSquaredError() < 0.1
        j = JE.RegressionEvaluation().eval(y, net.output(x).toNumpy())
        _close(j.meanSquaredError(0), r.meanSquaredError(0))

    def test_graph_do_evaluation(self):
        g = (P.NeuralNetConfiguration.Builder().seed(0).updater(P.Adam(5e-2))
             .graphBuilder().addInputs("in")
             .addLayer("h", P.DenseLayer(nOut=16, activation="tanh"), "in")
             .addLayer("out", P.OutputLayer(nOut=2, activation="softmax"),
                       "h")
             .setOutputs("out").setInputTypes(P.InputType.feedForward(4))
             .build())
        net = P.ComputationGraph(g, device="cpu").init()
        rng = np.random.RandomState(0)
        x = rng.randn(64, 4).astype("float32")
        y = np.eye(2, dtype="float32")[(x.sum(1) > 0).astype(int)]
        it = DataSetIterator(x, y, 16)
        net.fit(it, epochs=30)
        e = net.doEvaluation(it, PE.Evaluation())
        assert e.accuracy() > 0.9
        np.testing.assert_array_equal(
            e.getConfusionMatrix(),
            JE.Evaluation().eval(y, net.output(x).toNumpy())
            .getConfusionMatrix())
        assert net.evaluateROC(it).calculateAUC() > 0.9

    def test_do_evaluation_rejects_empty_and_multi_output(self):
        net, it, _, _ = _cls_net_and_iter()
        with pytest.raises(ValueError, match="at least one"):
            net.doEvaluation(it)
        g = (P.NeuralNetConfiguration.Builder().seed(0).updater(P.Adam(1e-2))
             .graphBuilder().addInputs("in")
             .addLayer("h", P.DenseLayer(nOut=4), "in")
             .addLayer("o1", P.OutputLayer(nOut=2, activation="softmax"), "h")
             .addLayer("o2", P.OutputLayer(nOut=3, activation="softmax"), "h")
             .setOutputs("o1", "o2")
             .setInputTypes(P.InputType.feedForward(4)).build())
        multi = P.ComputationGraph(g, device="cpu").init()
        with pytest.raises(ValueError, match="single-output"):
            multi.doEvaluation(it, PE.Evaluation())

    def test_padded_final_batch_is_masked(self):
        """The iterator pads its last batch under a zero label mask; the
        evaluation counts each real example once."""
        net, _, x, y = _cls_net_and_iter()
        e = net.evaluate(DataSetIterator(x[:50], y[:50], 16))
        assert e.getConfusionMatrix().sum() == 50


class TestTopNAccuracy:
    def test_topn_counts(self):
        y = np.eye(4, dtype="float32")[[0, 1, 2, 3]]
        p = np.array([[0.3, 0.4, 0.2, 0.1],
                      [0.1, 0.3, 0.4, 0.2],
                      [0.1, 0.2, 0.3, 0.4],
                      [0.4, 0.3, 0.2, 0.1]], "float32")
        j, e = _eval("Evaluation", y, p, ctor=(4,), topN=2)
        assert e.accuracy() == 0.0 and e.topNAccuracy() == 0.75
        assert j.topNAccuracy() == e.topNAccuracy()
        assert PE.Evaluation(4, topN=4).eval(y, p).topNAccuracy() == 1.0

    def test_topn_1_equals_accuracy(self):
        rng = np.random.RandomState(0)
        y = np.eye(5, dtype="float32")[rng.randint(0, 5, 40)]
        p = rng.rand(40, 5).astype("float32")
        j, e = _eval("Evaluation", y, p, ctor=(5,))
        assert e.topNAccuracy() == e.accuracy() == j.accuracy()

    def test_reset_clears_topn(self):
        y = p = np.eye(3, dtype="float32")[[0, 1]]
        e = PE.Evaluation(3, topN=2)
        e.eval(y, p)
        e.reset()
        e.eval(y, p)
        assert e.topNAccuracy() == 1.0

    def test_positional_topn_reference_overload(self):
        y = np.eye(4, dtype="float32")[[0]]
        p = np.array([[0.3, 0.4, 0.2, 0.1]], "float32")
        j, e = _eval("Evaluation", y, p, ctor=(4, 2))
        assert e.topNAccuracy() == 1.0 and e.accuracy() == 0.0
        assert j.topNAccuracy() == e.topNAccuracy()

    def test_topn_unbatched_1d(self):
        j, e = _eval("Evaluation", np.array([0.0, 1.0, 0.0]),
                     np.array([0.5, 0.3, 0.2]), ctor=(3,), topN=2)
        assert e.topNAccuracy() == j.topNAccuracy() == 1.0

    def test_topn_from_tensors(self):
        """The port's evaluations also read tensors (a net's outputs)."""
        y = np.eye(4, dtype="float32")[[0, 1, 2, 3]]
        p = np.random.RandomState(3).rand(4, 4).astype("float32")
        e = PE.Evaluation(4, topN=2).eval(torch.from_numpy(y),
                                          torch.from_numpy(p))
        assert e.topNAccuracy() == \
            JE.Evaluation(4, topN=2).eval(y, p).topNAccuracy()
