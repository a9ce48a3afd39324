"""MultiDataSet — multiple feature/label arrays for ComputationGraph.

The counterpart of ``deeplearning4j_tpu/data/multidataset.py``
(reference: org.nd4j.linalg.dataset.MultiDataSet). Arrays are held as
given, as ``DataSet`` holds them.
"""

from __future__ import annotations

import numpy as np



class MultiDataSet:
    def __init__(self, features, labels, featuresMasks=None, labelsMasks=None):
        self._features = list(self._as_list(features))
        self._labels = list(self._as_list(labels))
        self._fmasks = None if featuresMasks is None else list(self._as_list(featuresMasks))
        self._lmasks = None if labelsMasks is None else list(self._as_list(labelsMasks))

    @staticmethod
    def _as_list(x):
        return x if isinstance(x, (list, tuple)) else [x]

    def getFeatures(self, idx=None):
        return self._features if idx is None else self._features[idx]

    def getLabels(self, idx=None):
        return self._labels if idx is None else self._labels[idx]

    def getFeaturesMaskArrays(self):
        return self._fmasks

    def getLabelsMaskArrays(self):
        return self._lmasks

    def numExamples(self) -> int:
        return len(self._features[0])


class MultiDataSetIterator:
    """Fixed-shape batches over multiple feature/label arrays; the final
    partial batch is padded with repeated rows and zeroed label masks, so
    every batch has one shape (same design as DataSetIterator).
    """

    def __init__(self, featureArrays, labelArrays, batchSize,
                 featuresMasks=None, labelsMasks=None, pad_final=True):
        self._f = [np.asarray(f) for f in MultiDataSet._as_list(featureArrays)]
        self._l = [np.asarray(l) for l in MultiDataSet._as_list(labelArrays)]
        # per-array mask lists may carry None entries (reference:
        # MultiDataSet mask arrays are nullable per input/output — a
        # static input alongside a masked sequence input is the normal
        # multi-reader case)
        self._fm = None if featuresMasks is None else \
            [None if m is None else np.asarray(m)
             for m in MultiDataSet._as_list(featuresMasks)]
        self._lm = None if labelsMasks is None else \
            [None if m is None else np.asarray(m)
             for m in MultiDataSet._as_list(labelsMasks)]
        self._batch = int(batchSize)
        self._pad_final = pad_final
        self.reset()

    def reset(self):
        self._cursor = 0

    def hasNext(self):
        return self._cursor < len(self._f[0])

    @staticmethod
    def _pad(arrs, pad):
        return [None if a is None
                else np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                for a in arrs]

    def next(self) -> MultiDataSet:
        sl = slice(self._cursor, self._cursor + self._batch)
        self._cursor += self._batch
        f = [a[sl] for a in self._f]
        l = [a[sl] for a in self._l]
        fm = None if self._fm is None else \
            [None if a is None else a[sl] for a in self._fm]
        lm = None if self._lm is None else \
            [None if a is None else a[sl] for a in self._lm]
        short = self._batch - len(f[0])
        if self._pad_final and short > 0:
            f = self._pad(f, short)
            l = self._pad(l, short)
            if fm is not None:
                fm = self._pad(fm, short)
            def tail_mask(lab):
                m = np.ones((self._batch,)
                            + (() if lab.ndim == 2 else (lab.shape[2],)),
                            np.float32)
                m[-short:] = 0.0
                return m

            if lm is None:
                lm = [tail_mask(lab) for lab in l]
            else:
                # a None entry must ALSO gain a pad-zeroing mask: its
                # label was padded with duplicated rows like the rest,
                # and an unmasked duplicate would count in the loss
                lm = [tail_mask(lab) if m is None
                      else np.concatenate(
                          [m, np.zeros((short,) + m.shape[1:], m.dtype)])
                      for m, lab in zip(lm, l)]
        return MultiDataSet(f, l, fm, lm)
