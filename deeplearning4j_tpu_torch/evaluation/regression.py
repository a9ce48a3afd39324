"""Regression evaluation.

The counterpart of ``deeplearning4j_tpu/evaluation/regression.py``.

Reference: org.nd4j.evaluation.regression.RegressionEvaluation — per-column
MSE, MAE, RMSE, RSE (relative squared error), Pearson correlation, R^2.
Sums accumulate on host across batches; metrics are derived at read time so
the class streams over arbitrarily many minibatches in O(columns) memory.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.evaluation import _to_np


class RegressionEvaluation:
    def __init__(self, nColumns=None, columnNames=None):
        self._names = list(columnNames) if columnNames else None
        if self._names and nColumns is None:
            nColumns = len(self._names)
        self._n_cols = nColumns
        self._initialized = False

    def reset(self):
        """Clear accumulated statistics (reference: IEvaluation.reset())."""
        self._initialized = False
        # drop the accumulators so a read between reset() and the next
        # eval() fails loudly instead of returning the discarded stats
        for a in ("_count", "_sum_err", "_sum_abs_err", "_sum_sq_err",
                  "_sum_label", "_sum_sq_label", "_sum_pred", "_sum_sq_pred",
                  "_sum_label_pred"):
            if hasattr(self, a):
                delattr(self, a)

    def _init(self, n):
        self._n_cols = n
        z = np.zeros(n, np.float64)
        self._count = z.copy()
        self._sum_err = z.copy()          # sum(pred - label)
        self._sum_abs_err = z.copy()      # sum|pred - label|
        self._sum_sq_err = z.copy()       # sum(pred - label)^2
        self._sum_label = z.copy()
        self._sum_sq_label = z.copy()
        self._sum_pred = z.copy()
        self._sum_sq_pred = z.copy()
        self._sum_label_pred = z.copy()   # sum(label * pred)
        self._initialized = True

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels).astype(np.float64)
        p = _to_np(predictions).astype(np.float64)
        if y.ndim == 3:  # RNN [B, C, T] -> [B*T, C]
            y = np.transpose(y, (0, 2, 1)).reshape(-1, y.shape[1])
            p = np.transpose(p, (0, 2, 1)).reshape(-1, p.shape[1])
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        if mask is not None:
            m = _to_np(mask).reshape(-1) > 0
            y, p = y[m], p[m]
        if not self._initialized:
            self._init(y.shape[1])
        err = p - y
        self._count += y.shape[0]
        self._sum_err += err.sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_sq_err += (err ** 2).sum(0)
        self._sum_label += y.sum(0)
        self._sum_sq_label += (y ** 2).sum(0)
        self._sum_pred += p.sum(0)
        self._sum_sq_pred += (p ** 2).sum(0)
        self._sum_label_pred += (y * p).sum(0)
        return self

    # ----- per-column metrics -----------------------------------------
    def meanSquaredError(self, col=0) -> float:
        return float(self._sum_sq_err[col] / max(self._count[col], 1))

    def meanAbsoluteError(self, col=0) -> float:
        return float(self._sum_abs_err[col] / max(self._count[col], 1))

    def rootMeanSquaredError(self, col=0) -> float:
        return float(np.sqrt(self.meanSquaredError(col)))

    def relativeSquaredError(self, col=0) -> float:
        n = max(self._count[col], 1)
        mean_label = self._sum_label[col] / n
        ss_tot = self._sum_sq_label[col] - n * mean_label ** 2
        return float(self._sum_sq_err[col] / max(ss_tot, 1e-12))

    def rSquared(self, col=0) -> float:
        return float(1.0 - self.relativeSquaredError(col))

    def pearsonCorrelation(self, col=0) -> float:
        n = max(self._count[col], 1)
        cov = self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col] / n
        var_l = self._sum_sq_label[col] - self._sum_label[col] ** 2 / n
        var_p = self._sum_sq_pred[col] - self._sum_pred[col] ** 2 / n
        return float(cov / max(np.sqrt(max(var_l * var_p, 0.0)), 1e-12))

    # ----- column averages (reference: average* methods) --------------
    def averageMeanSquaredError(self) -> float:
        return float(np.mean([self.meanSquaredError(i) for i in range(self._n_cols)]))

    def averageMeanAbsoluteError(self) -> float:
        return float(np.mean([self.meanAbsoluteError(i) for i in range(self._n_cols)]))

    def averagerootMeanSquaredError(self) -> float:
        return float(np.mean([self.rootMeanSquaredError(i) for i in range(self._n_cols)]))

    def averageRSquared(self) -> float:
        return float(np.mean([self.rSquared(i) for i in range(self._n_cols)]))

    def averagePearsonCorrelation(self) -> float:
        return float(np.mean([self.pearsonCorrelation(i) for i in range(self._n_cols)]))

    def numColumns(self) -> int:
        return self._n_cols

    def stats(self) -> str:
        name = lambda i: (self._names[i] if self._names else f"col_{i}")
        header = f"{'Column':<16}{'MSE':>12}{'MAE':>12}{'RMSE':>12}{'RSE':>12}{'PC':>12}{'R^2':>12}"
        rows = [f"{name(i):<16}{self.meanSquaredError(i):>12.5f}"
                f"{self.meanAbsoluteError(i):>12.5f}{self.rootMeanSquaredError(i):>12.5f}"
                f"{self.relativeSquaredError(i):>12.5f}{self.pearsonCorrelation(i):>12.5f}"
                f"{self.rSquared(i):>12.5f}"
                for i in range(self._n_cols)]
        return "\n".join(["==================Regression Evaluation==================",
                          header] + rows)
