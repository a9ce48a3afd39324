"""Multi-label binary evaluation.

The counterpart of ``deeplearning4j_tpu/evaluation/binary.py``.

Reference: org.nd4j.evaluation.classification.EvaluationBinary — per-output
TP/FP/TN/FN counts with a decision threshold (default 0.5), giving
accuracy / precision / recall / F1 / MCC per output column.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.evaluation import _to_np


class EvaluationBinary:
    def __init__(self, nOutputs=None, decisionThreshold=0.5):
        self._n = nOutputs
        self._thr = float(decisionThreshold)
        self._counts = None  # [n, 4] = tp, fp, tn, fn

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self._counts = None

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        if y.ndim == 3:
            y = np.transpose(y, (0, 2, 1)).reshape(-1, y.shape[1])
            p = np.transpose(p, (0, 2, 1)).reshape(-1, p.shape[1])
        keep = None  # [N, M] elementwise keep-mask
        if mask is not None:
            m = _to_np(mask)
            if m.shape == y.shape:  # per-output mask (reference supports both)
                keep = m > 0
            else:
                m = m.reshape(-1) > 0
                y, p = y[m], p[m]
        n = y.shape[1]
        if self._counts is None:
            self._n = self._n or n
            self._counts = np.zeros((self._n, 4), np.int64)
        if n != self._n:
            raise ValueError(f"EvaluationBinary configured for {self._n} outputs "
                             f"but data has {n} columns")
        pred = (p >= self._thr)
        act = (y >= 0.5)
        if keep is None:
            keep = np.ones_like(pred, bool)
        self._counts[:, 0] += (pred & act & keep).sum(0)
        self._counts[:, 1] += (pred & ~act & keep).sum(0)
        self._counts[:, 2] += (~pred & ~act & keep).sum(0)
        self._counts[:, 3] += (~pred & act & keep).sum(0)
        return self

    # ----- per-output metrics -----------------------------------------
    def truePositives(self, i=0):
        return int(self._counts[i, 0])

    def falsePositives(self, i=0):
        return int(self._counts[i, 1])

    def trueNegatives(self, i=0):
        return int(self._counts[i, 2])

    def falseNegatives(self, i=0):
        return int(self._counts[i, 3])

    def accuracy(self, i=0) -> float:
        tp, fp, tn, fn = self._counts[i]
        return float((tp + tn) / max(tp + fp + tn + fn, 1))

    def precision(self, i=0) -> float:
        tp, fp = self._counts[i, 0], self._counts[i, 1]
        return float(tp / max(tp + fp, 1))

    def recall(self, i=0) -> float:
        tp, fn = self._counts[i, 0], self._counts[i, 3]
        return float(tp / max(tp + fn, 1))

    def f1(self, i=0) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / max(p + r, 1e-12)

    def matthewsCorrelation(self, i=0) -> float:
        tp, fp, tn, fn = self._counts[i].astype(np.float64)
        denom = np.sqrt(max((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn), 1e-12))
        return float((tp * tn - fp * fn) / denom)

    def averageAccuracy(self) -> float:
        return float(np.mean([self.accuracy(i) for i in range(self._n)]))

    def averageF1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self._n)]))

    def numLabels(self) -> int:
        return self._n

    def stats(self) -> str:
        lines = ["==================Evaluation (binary)=================="]
        for i in range(self._n):
            lines.append(f" out {i}: acc={self.accuracy(i):.4f} "
                         f"prec={self.precision(i):.4f} rec={self.recall(i):.4f} "
                         f"f1={self.f1(i):.4f} mcc={self.matthewsCorrelation(i):.4f}")
        return "\n".join(lines)
