"""Classification evaluation.

The counterpart of ``deeplearning4j_tpu/evaluation/evaluation.py``
(reference: org.nd4j.evaluation.classification.Evaluation): accuracy,
top-N accuracy, precision/recall/F1 (macro), the confusion matrix.
Counts accumulate on the host in numpy, in the reference's arithmetic;
predictions come from the device once a batch.
"""

from __future__ import annotations

import numpy as np


def _to_np(a):
    """An INDArray, tensor or array-like as numpy (the port's arrays may
    sit on the card: they are read to the host here, once a batch)."""
    from deeplearning4j_tpu_torch.data.dataset import _np

    return _np(a)


class Evaluation:
    def __init__(self, numClasses=None, labelsList=None, topN=1):
        # reference overload Evaluation(int numClasses, Integer topN):
        # an int second positional is topN, not a labels list
        if isinstance(labelsList, int):
            topN = labelsList
            labelsList = None
        self._n = numClasses
        self._labels = labelsList
        self._conf = None  # confusion matrix [actual, predicted]
        # reference: Evaluation(int numClasses, Integer topN) — track
        # how often the true class lands in the top-N scores
        self._topN = int(topN)
        self._topn_correct = 0
        self._topn_total = 0

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self._conf = None
        self._topn_correct = 0
        self._topn_total = 0

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 3:  # RNN [B,C,T] -> flatten time
            y = np.transpose(y, (0, 2, 1)).reshape(-1, y.shape[1])
            p = np.transpose(p, (0, 2, 1)).reshape(-1, p.shape[1])
            if mask is not None:
                m = _to_np(mask).reshape(-1) > 0
                y, p = y[m], p[m]
        elif mask is not None:
            m = _to_np(mask).reshape(-1) > 0
            y, p = y[m], p[m]
        n = y.shape[-1]
        if self._conf is None:
            self._n = self._n or n
            self._conf = np.zeros((self._n, self._n), np.int64)
        actual = np.argmax(y, axis=-1)
        pred = np.argmax(p, axis=-1)
        np.add.at(self._conf, (actual, pred), 1)
        if self._topN > 1:
            p2 = np.atleast_2d(p)          # unbatched 1-D eval() calls
            a2 = np.atleast_1d(actual)
            k = min(self._topN, p2.shape[-1])
            topk = np.argpartition(-p2, k - 1, axis=-1)[:, :k]
            self._topn_correct += int((topk == a2[:, None]).any(-1).sum())
            self._topn_total += len(a2)
        return self

    # ----- metrics ----------------------------------------------------
    def accuracy(self) -> float:
        c = self._conf
        return float(np.trace(c)) / max(1, c.sum())

    def topNAccuracy(self) -> float:
        """Fraction of examples whose true class was among the topN
        scores (reference: Evaluation.topNAccuracy). topN=1 collapses
        to accuracy()."""
        if self._topN <= 1:
            return self.accuracy()
        return self._topn_correct / max(1, self._topn_total)

    def _per_class(self):
        c = self._conf.astype(np.float64)
        tp = np.diag(c)
        fp = c.sum(axis=0) - tp
        fn = c.sum(axis=1) - tp
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        return prec, rec

    def precision(self, cls=None) -> float:
        prec, _ = self._per_class()
        if cls is not None:
            return float(prec[cls])
        present = self._conf.sum(axis=1) > 0
        return float(prec[present].mean()) if present.any() else 0.0

    def recall(self, cls=None) -> float:
        _, rec = self._per_class()
        if cls is not None:
            return float(rec[cls])
        present = self._conf.sum(axis=1) > 0
        return float(rec[present].mean()) if present.any() else 0.0

    def f1(self, cls=None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / max(p + r, 1e-12)

    def falsePositiveRate(self, cls) -> float:
        c = self._conf.astype(np.float64)
        tp = c[cls, cls]
        fp = c[:, cls].sum() - tp
        tn = np.trace(c) - tp
        neg = c.sum() - c[cls].sum()
        return float(fp / max(neg, 1))

    def getConfusionMatrix(self):
        return self._conf

    def confusionMatrix(self):
        return self._conf

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self._n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
            str(self._conf),
        ]
        return "\n".join(lines)
