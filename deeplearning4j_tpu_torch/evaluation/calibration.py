"""Probability calibration evaluation.

The counterpart of ``deeplearning4j_tpu/evaluation/calibration.py``.

Reference: org.nd4j.evaluation.classification.EvaluationCalibration —
reliability diagrams (predicted-probability bins vs observed frequency),
per-class probability histograms, residual plots, and the expected
calibration error derived from them.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.evaluation import _to_np


class EvaluationCalibration:
    def __init__(self, reliabilityDiagNumBins=10, histogramNumBins=10):
        self._rbins = int(reliabilityDiagNumBins)
        self._hbins = int(histogramNumBins)
        self._counts = None   # [C, rbins] predictions per bin, per class
        self._correct = None  # [C, rbins] positives per bin, per class
        self._psum = None     # [C, rbins] summed predicted prob per bin
        self._res_hist = None  # [hbins] |label - prob| residual histogram
        self._prob_hist = None  # [C, hbins] predicted-probability histogram

    def reset(self):
        self._counts = self._correct = self._psum = None
        self._res_hist = self._prob_hist = None

    def _ensure(self, C):
        if self._counts is None:
            self._counts = np.zeros((C, self._rbins), np.int64)
            self._correct = np.zeros((C, self._rbins), np.int64)
            self._psum = np.zeros((C, self._rbins), np.float64)
            self._res_hist = np.zeros(self._hbins, np.int64)
            self._prob_hist = np.zeros((C, self._hbins), np.int64)

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y, p = y[m], p[m]
        C = y.shape[-1]
        self._ensure(C)
        bins = np.clip((p * self._rbins).astype(int), 0, self._rbins - 1)
        hb = np.clip((p * self._hbins).astype(int), 0, self._hbins - 1)
        rb = np.clip((np.abs(y - p) * self._hbins).astype(int), 0,
                     self._hbins - 1)
        for c in range(C):
            np.add.at(self._counts[c], bins[:, c], 1)
            np.add.at(self._correct[c], bins[:, c], y[:, c] > 0.5)
            np.add.at(self._psum[c], bins[:, c], p[:, c])
            np.add.at(self._prob_hist[c], hb[:, c], 1)
        np.add.at(self._res_hist, rb.reshape(-1), 1)
        return self

    # ------------------------------------------------------------------
    def getReliabilityDiagram(self, classIdx):
        """(mean predicted prob per bin, observed frequency per bin) —
        empty bins are NaN (reference: ReliabilityDiagram)."""
        n = self._counts[classIdx]
        with np.errstate(invalid="ignore", divide="ignore"):
            meanp = np.where(n > 0, self._psum[classIdx] / n, np.nan)
            freq = np.where(n > 0, self._correct[classIdx] / n, np.nan)
        return meanp, freq

    def expectedCalibrationError(self, classIdx=None):
        """ECE = sum_bins (n_b/N) * |freq_b - meanp_b|; averaged over
        classes when classIdx is None."""
        idxs = range(self._counts.shape[0]) if classIdx is None else [classIdx]
        eces = []
        for c in idxs:
            n = self._counts[c]
            total = n.sum()
            if total == 0:
                continue
            meanp, freq = self.getReliabilityDiagram(c)
            valid = n > 0
            eces.append(float(np.sum(
                n[valid] / total * np.abs(freq[valid] - meanp[valid]))))
        return float(np.mean(eces)) if eces else float("nan")

    def getProbabilityHistogram(self, classIdx):
        return self._prob_hist[classIdx].copy()

    def getResidualPlot(self):
        """Histogram of |label - prediction| residuals (reference:
        EvaluationCalibration.getResidualPlotAllClasses)."""
        return self._res_hist.copy()

    def stats(self) -> str:
        C = self._counts.shape[0] if self._counts is not None else 0
        lines = [f"EvaluationCalibration ({C} classes, "
                 f"{self._rbins} reliability bins)"]
        for c in range(C):
            lines.append(f"  class {c}: ECE="
                         f"{self.expectedCalibrationError(c):.4f}")
        return "\n".join(lines)
