"""ROC / AUC evaluation.

The counterpart of ``deeplearning4j_tpu/evaluation/roc.py``.

Reference: org.nd4j.evaluation.classification.{ROC, ROCMultiClass, ROCBinary}.
The reference supports exact mode (store all probabilities) and thresholded
mode (fixed threshold bins). We keep both: exact computes AUROC/AUPRC by the
trapezoid rule over the full sorted score set; thresholded accumulates
TP/FP/TN/FN counts per threshold bin so memory stays O(thresholdSteps) over
any stream length.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.evaluation import _to_np


_trapz = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 fallback


def _auc(x, y):
    """Trapezoid area under a curve given as unordered (x, y) points."""
    order = np.argsort(x, kind="stable")
    return float(_trapz(np.asarray(y)[order], np.asarray(x)[order]))


class ROC:
    """Binary ROC. `eval(labels, scores)` where labels are {0,1} (single
    column) or one-hot 2-column, and scores are P(class=1)."""

    def __init__(self, thresholdSteps: int = 0):
        self._steps = int(thresholdSteps)
        if self._steps > 0:
            edges = np.linspace(0.0, 1.0, self._steps + 1)
            self._edges = edges
            self._tp = np.zeros(self._steps + 1, np.int64)
            self._fp = np.zeros(self._steps + 1, np.int64)
        else:
            self._scores = []
            self._labels = []
        self._n_pos = 0
        self._n_neg = 0

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self.__init__(self._steps)

    @staticmethod
    def _binary(labels, preds):
        y = _to_np(labels)
        p = _to_np(preds)
        if y.ndim == 2 and y.shape[1] == 2:
            y = y[:, 1]
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        return y.reshape(-1).astype(np.int64), p.reshape(-1).astype(np.float64)

    def eval(self, labels, predictions, mask=None):
        y, p = self._binary(labels, predictions)
        if mask is not None:
            m = _to_np(mask).reshape(-1) > 0
            y, p = y[m], p[m]
        self._n_pos += int((y == 1).sum())
        self._n_neg += int((y == 0).sum())
        if self._steps > 0:
            # prediction >= threshold counts as positive at that threshold;
            # one binning pass + reversed cumsum instead of a per-edge scan
            bins = np.clip(np.searchsorted(self._edges, p, side="right") - 1,
                           0, self._steps)
            tp_bins = np.bincount(bins[y == 1], minlength=self._steps + 1)
            fp_bins = np.bincount(bins[y == 0], minlength=self._steps + 1)
            self._tp += tp_bins[::-1].cumsum()[::-1]
            self._fp += fp_bins[::-1].cumsum()[::-1]
        else:
            self._scores.append(p)
            self._labels.append(y)
        return self

    def _exact_curve(self):
        y = np.concatenate(self._labels)
        p = np.concatenate(self._scores)
        order = np.argsort(-p, kind="stable")
        y, p = y[order], p[order]
        tps = np.cumsum(y == 1)
        fps = np.cumsum(y == 0)
        # take curve points only at distinct-score boundaries so tied groups
        # contribute a single diagonal segment (trapezoid = half credit)
        last_of_group = np.r_[p[1:] != p[:-1], True]
        tps, fps, thr = tps[last_of_group], fps[last_of_group], p[last_of_group]
        tpr = np.concatenate([[0.0], tps / max(self._n_pos, 1)])
        fpr = np.concatenate([[0.0], fps / max(self._n_neg, 1)])
        return fpr, tpr, np.concatenate([[np.inf], thr])

    def getRocCurve(self):
        """(fpr, tpr, thresholds) arrays."""
        if self._steps > 0:
            tpr = self._tp / max(self._n_pos, 1)
            fpr = self._fp / max(self._n_neg, 1)
            return fpr, tpr, self._edges
        return self._exact_curve()

    def calculateAUC(self) -> float:
        fpr, tpr, _ = self.getRocCurve()
        return _auc(fpr, tpr)

    def calculateAUCPR(self) -> float:
        if self._steps > 0:
            tp, fp = self._tp, self._fp
            fn = self._n_pos - tp
            prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 1.0)
            rec = tp / max(self._n_pos, 1)
            return _auc(rec, prec)
        y = np.concatenate(self._labels)
        p = np.concatenate(self._scores)
        order = np.argsort(-p, kind="stable")
        y, p = y[order], p[order]
        tps = np.cumsum(y == 1)
        last_of_group = np.r_[p[1:] != p[:-1], True]
        ranks = np.arange(1, len(y) + 1)[last_of_group]
        tps = tps[last_of_group]
        prec = tps / ranks
        rec = tps / max(self._n_pos, 1)
        return _auc(np.concatenate([[0.0], rec]), np.concatenate([[1.0], prec]))

    def stats(self) -> str:
        return (f"ROC (exact={self._steps == 0}): AUROC={self.calculateAUC():.4f}, "
                f"AUPRC={self.calculateAUCPR():.4f}, "
                f"pos={self._n_pos}, neg={self._n_neg}")


class ROCMultiClass:
    """One-vs-all ROC per class (reference: ROCMultiClass)."""

    def __init__(self, thresholdSteps: int = 0):
        self._steps = thresholdSteps
        self._rocs = None

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self._rocs = None

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 3:
            y = np.transpose(y, (0, 2, 1)).reshape(-1, y.shape[1])
            p = np.transpose(p, (0, 2, 1)).reshape(-1, p.shape[1])
        if mask is not None:
            m = _to_np(mask).reshape(-1) > 0
            y, p = y[m], p[m]
        n = y.shape[1]
        if self._rocs is None:
            self._rocs = [ROC(self._steps) for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval((y.argmax(-1) == c).astype(np.int64), p[:, c])
        return self

    def calculateAUC(self, classIdx: int) -> float:
        return self._rocs[classIdx].calculateAUC()

    def calculateAUCPR(self, classIdx: int) -> float:
        return self._rocs[classIdx].calculateAUCPR()

    def calculateAverageAUC(self) -> float:
        return float(np.mean([r.calculateAUC() for r in self._rocs]))

    def calculateAverageAUCPR(self) -> float:
        return float(np.mean([r.calculateAUCPR() for r in self._rocs]))

    def stats(self) -> str:
        lines = ["=====================ROCMultiClass====================="]
        for i, r in enumerate(self._rocs):
            lines.append(f" class {i}: AUROC={r.calculateAUC():.4f} "
                         f"AUPRC={r.calculateAUCPR():.4f}")
        lines.append(f" average AUROC: {self.calculateAverageAUC():.4f}")
        return "\n".join(lines)


class ROCBinary:
    """Per-output-column binary ROC for multi-label problems
    (reference: ROCBinary — labels [N, M] in {0,1}, scores [N, M])."""

    def __init__(self, thresholdSteps: int = 0):
        self._steps = thresholdSteps
        self._rocs = None

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self._rocs = None

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        keep = None
        if mask is not None:
            m = _to_np(mask)
            if m.shape == y.shape:  # per-output mask
                keep = m > 0
            else:
                m = m.reshape(-1) > 0
                y, p = y[m], p[m]
        if self._rocs is None:
            self._rocs = [ROC(self._steps) for _ in range(y.shape[1])]
        for c in range(y.shape[1]):
            if keep is None:
                self._rocs[c].eval(y[:, c], p[:, c])
            else:
                self._rocs[c].eval(y[keep[:, c], c], p[keep[:, c], c])
        return self

    def calculateAUC(self, outputNum: int = 0) -> float:
        return self._rocs[outputNum].calculateAUC()

    def calculateAUCPR(self, outputNum: int = 0) -> float:
        return self._rocs[outputNum].calculateAUCPR()

    def numLabels(self) -> int:
        return len(self._rocs)

    def stats(self) -> str:
        return "\n".join(f"output {i}: AUROC={r.calculateAUC():.4f}"
                         for i, r in enumerate(self._rocs))
