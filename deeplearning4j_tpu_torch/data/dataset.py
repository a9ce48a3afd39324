"""DataSet and the in-memory iterators.

The counterpart of ``deeplearning4j_tpu/data/dataset.py``: ``DataSet``,
``SplitTestAndTrain``, ``DataSetIterator`` and the iterators built on it
(``ListDataSetIterator``, ``ExistingDataSetIterator``, ``KFoldIterator``,
``MultipleEpochsIterator``, ``ViewIterator``, the disk-backed
``MiniBatchFileDataSetIterator`` / ``ExistingMiniBatchDataSetIterator``),
with the iterator preprocessor hook (``setPreProcessor``; a normalizer
is one). A ``DataSet`` holds its arrays as given (numpy arrays, tensors
or ``INDArray``s; the network moves them to its device), where the
reference wraps them as ``INDArray``; ``_np`` reads any of them to
numpy. The iterators yield fixed-shape batches in the reference's order:
``shuffle=True`` draws the same numpy permutation (``RandomState(seed +
epoch)``), and a short final batch is padded with repeated last rows
under a zero label mask, so the padded rows add nothing to the loss.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DataSet", "SplitTestAndTrain", "DataSetIterator",
           "ListDataSetIterator", "ExistingDataSetIterator", "KFoldIterator",
           "MultipleEpochsIterator", "ViewIterator",
           "MiniBatchFileDataSetIterator", "ExistingMiniBatchDataSetIterator"]


def _np(a):
    """An INDArray, tensor or array-like as a numpy array (None passes;
    bf16 widened to float32, exactly)."""
    if a is None:
        return None
    if hasattr(a, "toNumpy"):
        return a.toNumpy()
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


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

    def sample(self, n: int, seed=None) -> "DataSet":
        rng = np.random.RandomState(seed)
        idx = rng.choice(self.numExamples(), size=n, replace=False)
        return DataSet(_np(self._features)[idx], _np(self._labels)[idx])

    def splitTestAndTrain(self, fraction_or_n):
        n = self.numExamples()
        n_train = int(fraction_or_n * n) if isinstance(fraction_or_n, float) \
            else int(fraction_or_n)
        f, l = _np(self._features), _np(self._labels)
        return SplitTestAndTrain(DataSet(f[:n_train], l[:n_train]),
                                 DataSet(f[n_train:], l[n_train:]))

    def shuffle(self, seed=None):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.numExamples())
        self._features = _np(self._features)[idx]
        self._labels = _np(self._labels)[idx]

    def asList(self):
        f, l = _np(self._features), _np(self._labels)
        return [DataSet(f[i:i + 1], l[i:i + 1])
                for i in range(self.numExamples())]


class SplitTestAndTrain:
    def __init__(self, train, test):
        self._train, self._test = train, test

    def getTrain(self) -> DataSet:
        return self._train

    def getTest(self) -> DataSet:
        return self._test


def _pad_batch(f, l, fm, lm, n):
    """Pad a short final batch to n rows with repeated last rows and a
    zero label mask over the pad (reference: ``_pad_batch``): one batch
    shape an epoch, and the padded rows add nothing to the loss."""
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
    """Base in-memory iterator over (features, labels) arrays."""

    def __init__(self, features, labels, batchSize: int, shuffle=False, seed=123,
                 featuresMask=None, labelsMask=None, pad_final=True):
        self._f = np.asarray(features)
        self._l = np.asarray(labels)
        self._fm = None if featuresMask is None else np.asarray(featuresMask)
        self._lm = None if labelsMask is None else np.asarray(labelsMask)
        self._batch = int(batchSize)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pad_final = pad_final
        self._preprocessor = None
        self.reset()

    # ----- iterator protocol (reference names) ------------------------
    def reset(self):
        self._cursor = 0
        order = np.arange(len(self._f))
        if self._shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(order)
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
        ds = DataSet(f, l, fm, lm)
        if self._preprocessor is not None:
            self._preprocessor.preProcess(ds)
        return ds

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def _raw_batches(self):
        """Yield (features, labels) numpy batches with NO padding and NO
        preprocessor — the view statistics-fitting code must see (used by
        DataNormalization.fit so padded duplicate rows and an already-set
        preprocessor can't bias the stats)."""
        for i in range(0, len(self._f), self._batch):
            idx = self._order[i:i + self._batch]
            yield self._f[idx], self._l[idx]

    def batch(self) -> int:
        return self._batch

    def totalExamples(self) -> int:
        return len(self._f)

    def inputColumns(self) -> int:
        return int(np.prod(self._f.shape[1:]))

    def totalOutcomes(self) -> int:
        return int(self._l.shape[-1])

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def getPreProcessor(self):
        return self._preprocessor


class ListDataSetIterator(DataSetIterator):
    """Iterator over a list of DataSets (reference: ListDataSetIterator)."""

    def __init__(self, datasets, batchSize=None):
        f = np.concatenate([_np(d.getFeatures()) for d in datasets])
        l = np.concatenate([_np(d.getLabels()) for d in datasets])
        super().__init__(f, l, batchSize or len(f))


class ExistingDataSetIterator(DataSetIterator):
    def __init__(self, dataset: DataSet, batchSize=None):
        super().__init__(_np(dataset.getFeatures()),
                         _np(dataset.getLabels()),
                         batchSize or dataset.numExamples())


class KFoldIterator:
    """K-fold cross-validation splits over one DataSet (reference:
    org.deeplearning4j.datasets.iterator.KFoldIterator): next() yields
    the k-th TRAINING fold as a DataSet; testFold() returns the held-out
    fold for the split most recently emitted. Fold sizes follow the
    reference: the first N % k folds get one extra example."""

    def __init__(self, k: int, dataset: DataSet):
        if k < 2:
            raise ValueError("k must be >= 2")
        n = dataset.numExamples()
        if k > n:
            raise ValueError(f"k={k} exceeds the {n} examples")
        self.k = int(k)
        self._f = _np(dataset.getFeatures())
        self._l = _np(dataset.getLabels())
        base, extra = divmod(n, self.k)
        sizes = [base + (1 if i < extra else 0) for i in range(self.k)]
        bounds = np.cumsum([0] + sizes)
        self._folds = [(int(bounds[i]), int(bounds[i + 1]))
                       for i in range(self.k)]
        self.reset()

    def reset(self):
        self._i = 0
        # a stale held-out fold from a previous pass must not satisfy
        # testFold()'s call-next()-first contract
        if hasattr(self, "_test"):
            del self._test

    def hasNext(self) -> bool:
        return self._i < self.k

    def next(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        lo, hi = self._folds[self._i]
        self._test = DataSet(self._f[lo:hi], self._l[lo:hi])
        train_f = np.concatenate([self._f[:lo], self._f[hi:]])
        train_l = np.concatenate([self._l[:lo], self._l[hi:]])
        self._i += 1
        return DataSet(train_f, train_l)

    def testFold(self) -> DataSet:
        if not hasattr(self, "_test"):
            raise RuntimeError("call next() first")
        return self._test

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class MultipleEpochsIterator:
    """Replays an underlying iterator numEpochs times as one epoch
    (reference: org.deeplearning4j.datasets.iterator
    .MultipleEpochsIterator) — lets fit(iterator) run multi-epoch
    training without a fit(..., epochs=) argument."""

    def __init__(self, numEpochs: int, underlying):
        if numEpochs < 1:
            raise ValueError("numEpochs must be >= 1")
        self.numEpochs = int(numEpochs)
        self._it = underlying
        self.reset()

    def reset(self):
        self._epoch = 0
        self._it.reset()

    def hasNext(self) -> bool:
        if self._it.hasNext():
            return True
        # hasNext()==True must guarantee next() succeeds: an EMPTY
        # underlying iterator has no batch in ANY remaining epoch, so
        # advance epochs (reset + re-check) until a batch is actually
        # available (ADVICE r4 — remaining epochs alone don't imply a
        # remaining batch). next() below tolerates the advanced state.
        while self._epoch + 1 < self.numEpochs:
            self._epoch += 1
            self._it.reset()
            if self._it.hasNext():
                return True
        return False

    def next(self, num=None) -> DataSet:
        if not self._it.hasNext():
            if self._epoch + 1 >= self.numEpochs:
                raise StopIteration
            self._epoch += 1
            self._it.reset()
            if not self._it.hasNext():  # empty underlying: same contract
                raise StopIteration
        return self._it.next(num) if num is not None else self._it.next()

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def batch(self):
        return self._it.batch()

    def totalExamples(self):
        return self._it.totalExamples() * self.numEpochs

    def inputColumns(self):
        return self._it.inputColumns()

    def totalOutcomes(self):
        return self._it.totalOutcomes()

    def setPreProcessor(self, pp):
        self._it.setPreProcessor(pp)

    def getPreProcessor(self):
        return self._it.getPreProcessor()

    def _raw_batches(self):
        # normalizer statistics fitting: one UNPADDED pass over the
        # underlying data — replaying epochs or seeing pad rows would
        # bias the stats (see DataSetIterator._raw_batches)
        return self._it._raw_batches()


class ViewIterator(ExistingDataSetIterator):
    """Batched view over one DataSet (reference:
    org.deeplearning4j.datasets.iterator.impl.ViewIterator). Same
    unwrapping as ExistingDataSetIterator, but batchSize is required."""

    def __init__(self, dataset: DataSet, batchSize: int):
        super().__init__(dataset, int(batchSize))


class MiniBatchFileDataSetIterator:
    """Disk-backed minibatches (reference: org.deeplearning4j.datasets
    .iterator.MiniBatchFileDataSetIterator): splits a DataSet into one
    .npz file per batch under rootDir at construction, then streams
    them back one at a time — the host never holds more than one batch
    after the initial split, which is the point for datasets larger
    than host RAM that arrive batch-wise. Masks persist with their
    batches, and the final short batch pads like every other iterator
    here (fixed shapes)."""

    def __init__(self, dataset: DataSet, batchSize: int, rootDir=None,
                 delete_on_exhaust=False, pad_final=True):
        import os
        import tempfile

        self._dir = str(rootDir) if rootDir is not None \
            else tempfile.mkdtemp(prefix="minibatch_")
        os.makedirs(self._dir, exist_ok=True)
        self._batch = int(batchSize)
        self._delete = bool(delete_on_exhaust)
        self._pad_final = bool(pad_final)
        f = _np(dataset.getFeatures())
        l = _np(dataset.getLabels())
        fm = dataset.getFeaturesMaskArray()
        lm = dataset.getLabelsMaskArray()
        fm = None if fm is None else _np(fm)
        lm = None if lm is None else _np(lm)
        self._n = len(f)
        self._in_cols = int(np.prod(f.shape[1:]))
        self._outcomes = int(l.shape[-1])
        self._paths = []
        for i in range(0, len(f), self._batch):
            p = os.path.join(self._dir, f"dataset-{len(self._paths)}.npz")
            rec = {"features": f[i:i + self._batch],
                   "labels": l[i:i + self._batch]}
            if fm is not None:
                rec["features_mask"] = fm[i:i + self._batch]
            if lm is not None:
                rec["labels_mask"] = lm[i:i + self._batch]
            np.savez(p, **rec)
            self._paths.append(p)
        self._preprocessor = None
        self._exhausted_deleted = False
        self.reset()

    def rootDir(self):
        return self._dir

    def reset(self):
        if self._exhausted_deleted:
            raise RuntimeError(
                "this MiniBatchFileDataSetIterator was built with "
                "delete_on_exhaust=True and its batch files are gone — "
                "a reset would silently iterate zero batches")
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._paths)

    def _load(self, i):
        z = np.load(self._paths[i])
        return (z["features"], z["labels"],
                z["features_mask"] if "features_mask" in z.files else None,
                z["labels_mask"] if "labels_mask" in z.files else None)

    def next(self, num=None) -> DataSet:
        import os

        if num is not None and int(num) != self._batch:
            raise ValueError(
                f"batches were split to files at batchSize={self._batch}; "
                f"next({num}) cannot re-batch them")
        if not self.hasNext():
            raise StopIteration
        f, l, fm, lm = self._load(self._i)
        if self._pad_final and len(f) < self._batch:
            f, l, fm, lm = _pad_batch(f, l, fm, lm, self._batch)
        ds = DataSet(f, l, fm, lm)
        self._i += 1
        if self._delete and not self.hasNext():
            for p in self._paths:
                os.unlink(p)
            self._paths = []
            self._exhausted_deleted = True
        if self._preprocessor is not None:
            self._preprocessor.preProcess(ds)
        return ds

    def _raw_batches(self):
        # unpadded, preprocessor-free pass for normalizer statistics
        # (same contract as DataSetIterator._raw_batches)
        for i in range(len(self._paths)):
            f, l, _, _ = self._load(i)
            yield f, l

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def batch(self) -> int:
        return self._batch

    def totalExamples(self) -> int:
        return self._n

    def inputColumns(self) -> int:
        return self._in_cols

    def totalOutcomes(self) -> int:
        return self._outcomes

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def getPreProcessor(self):
        return self._preprocessor


def _npz_member_shapes(path, *names):
    """Shapes of arrays inside an .npz WITHOUT decompressing their data:
    one ZipFile open, parsing just each member's .npy format header."""
    import zipfile

    shapes = {}
    with zipfile.ZipFile(path) as zf:
        for name in names:
            with zf.open(name + ".npy") as fh:
                version = np.lib.format.read_magic(fh)
                if version == (1, 0):
                    shape, _, _ = np.lib.format.read_array_header_1_0(fh)
                else:
                    shape, _, _ = np.lib.format.read_array_header_2_0(fh)
            shapes[name] = shape
    return shapes


class ExistingMiniBatchDataSetIterator:
    """Streams previously saved minibatch files (reference:
    org.deeplearning4j.datasets.iterator.ExistingMiniBatchDataSetIterator)
    — the read-side pair of MiniBatchFileDataSetIterator: point it at a
    rootDir of dataset-*.npz files (any directory the writer produced,
    from this process or an earlier one)."""

    def __init__(self, rootDir, pattern="dataset-%d.npz", pad_final=True):
        import os
        import re

        self._dir = str(rootDir)
        if not os.path.isdir(self._dir):
            raise ValueError(f"{self._dir} is not a directory")
        rx = re.compile("^" + re.escape(pattern).replace("%d", r"(\d+)")
                        + "$")
        found = []
        for f in os.listdir(self._dir):
            m = rx.match(f)
            if m:
                found.append((int(m.group(1)), os.path.join(self._dir, f)))
        if not found:
            raise ValueError(
                f"no files matching {pattern!r} in {self._dir}")
        self._paths = [p for _, p in sorted(found)]
        self._pad_final = bool(pad_final)
        # batch size = the writer's (first file's) row count; total
        # examples = true rows on disk — the metadata sweep reads ONLY
        # each member's .npy header (ADVICE r4: np.load + touching the
        # array decompressed every full features buffer, O(dataset) I/O
        # at construction, against the streaming intent)
        first = _npz_member_shapes(self._paths[0], "features", "labels")
        self._in_cols = int(np.prod(first["features"][1:]))
        self._outcomes = int(first["labels"][-1])
        sizes = [first["features"][0]] + [
            int(_npz_member_shapes(p, "features")["features"][0])
            for p in self._paths[1:]]
        self._batch = sizes[0]
        self._n = sum(sizes)
        self._preprocessor = None
        self.reset()

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._paths)

    def _load(self, i):
        z = np.load(self._paths[i])
        return (z["features"], z["labels"],
                z["features_mask"] if "features_mask" in z.files else None,
                z["labels_mask"] if "labels_mask" in z.files else None)

    def next(self, num=None) -> DataSet:
        if num is not None and int(num) != self._batch:
            raise ValueError(
                f"batches were split to files at batchSize={self._batch}; "
                f"next({num}) cannot re-batch them")
        if not self.hasNext():
            raise StopIteration
        f, l, fm, lm = self._load(self._i)
        self._i += 1
        if self._pad_final and len(f) < self._batch:
            f, l, fm, lm = _pad_batch(f, l, fm, lm, self._batch)
        ds = DataSet(f, l, fm, lm)
        if self._preprocessor is not None:
            self._preprocessor.preProcess(ds)
        return ds

    def _raw_batches(self):
        # unpadded, preprocessor-free pass for normalizer statistics
        for i in range(len(self._paths)):
            f, l, _, _ = self._load(i)
            yield f, l

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def batch(self) -> int:
        return self._batch

    def totalExamples(self) -> int:
        return self._n

    def inputColumns(self) -> int:
        return self._in_cols

    def totalOutcomes(self) -> int:
        return self._outcomes

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def getPreProcessor(self):
        return self._preprocessor
