"""DataSet / DataSetIterator.

The counterpart of ``deeplearning4j_tpu/data/dataset.py``'s ``DataSet``
and ``DataSetIterator``. A ``DataSet`` holds its arrays as given (numpy
arrays or tensors; the network moves them to its device), where the
reference wraps them as ``INDArray`` (that wrapper waits for the
ndarray slice, ROADMAP.md Queue 1 item 2). The iterator yields
fixed-shape batches in the reference's order: ``shuffle=True`` draws the
same numpy permutation (``RandomState(seed + epoch)``), and a short final
batch is padded with repeated last rows under a zero label mask, so the
padded rows add nothing to the loss. The rest of the reference's
``data/`` waits for the training-runtime slice (item 10).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataSet", "DataSetIterator"]


class DataSet:
    def __init__(self, features=None, labels=None, featuresMask=None,
                 labelsMask=None):
        self._features = features
        self._labels = labels
        self._fmask = featuresMask
        self._lmask = labelsMask

    def getFeatures(self):
        return self._features

    def getLabels(self):
        return self._labels

    def getFeaturesMaskArray(self):
        return self._fmask

    def getLabelsMaskArray(self):
        return self._lmask

    def setFeatures(self, f):
        self._features = f

    def setLabels(self, labels):
        self._labels = labels

    def numExamples(self) -> int:
        return 0 if self._features is None else len(self._features)


def _pad_batch(f, l, fm, lm, n):
    """Pad a short final batch to n rows with repeated last rows and a
    zero label mask over the pad (reference: ``_pad_batch``)."""
    pad = n - len(f)
    f = np.concatenate([f, np.repeat(f[-1:], pad, axis=0)])
    l = np.concatenate([l, np.repeat(l[-1:], pad, axis=0)])
    if fm is not None:
        fm = np.concatenate([fm, np.repeat(fm[-1:], pad, axis=0)])
    if lm is None:
        lm = np.ones((n,) + (() if l.ndim == 2 else (l.shape[2],)),
                     np.float32)
        lm[-pad:] = 0.0
    else:
        lm = np.concatenate([lm, np.zeros((pad,) + lm.shape[1:], lm.dtype)])
    return f, l, fm, lm


class DataSetIterator:
    """In-memory iterator over (features, labels) numpy arrays."""

    def __init__(self, features, labels, batchSize: int, shuffle=False,
                 seed=123, featuresMask=None, labelsMask=None,
                 pad_final=True):
        self._f = np.asarray(features)
        self._l = np.asarray(labels)
        self._fm = None if featuresMask is None else np.asarray(featuresMask)
        self._lm = None if labelsMask is None else np.asarray(labelsMask)
        self._batch = int(batchSize)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pad_final = pad_final
        self.reset()

    def reset(self):
        self._cursor = 0
        order = np.arange(len(self._f))
        if self._shuffle:
            np.random.RandomState(self._seed + self._epoch).shuffle(order)
        self._order = order
        self._epoch += 1

    def hasNext(self) -> bool:
        return self._cursor < len(self._f)

    def next(self, num=None) -> DataSet:
        n = num or self._batch
        idx = self._order[self._cursor:self._cursor + n]
        self._cursor += n
        f, l = self._f[idx], self._l[idx]
        fm = None if self._fm is None else self._fm[idx]
        lm = None if self._lm is None else self._lm[idx]
        if self._pad_final and len(idx) < n:
            f, l, fm, lm = _pad_batch(f, l, fm, lm, n)
        return DataSet(f, l, fm, lm)
