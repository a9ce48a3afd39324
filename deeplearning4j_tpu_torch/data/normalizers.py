"""Data normalization.

The counterpart of ``deeplearning4j_tpu/data/normalizers.py`` (reference:
org.nd4j.linalg.dataset.api.preprocessor: NormalizerStandardize,
NormalizerMinMaxScaler, ImagePreProcessingScaler, VGG16ImagePreProcessor).
Normalizers fit summary statistics from an iterator or DataSet, then act
as the iterator's preProcessor; the statistics are computed on the host
in fp64 (a one-pass streaming fit) and the transform is a vectorised
numpy op applied before the batch goes to the device. Their state
(numpy attributes) round-trips through ``ModelSerializer``'s
``normalizer=`` in the reference's format.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import _np


def _feat(x):
    return _np(x)


def _array(a):
    """A numpy result as a host ``INDArray`` (where the reference returns
    ``Nd4j.create``): normalizers work on the host, before a batch goes
    to the device."""
    from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray

    return INDArray(torch.from_numpy(np.ascontiguousarray(a)))


def _feature_axes(a: np.ndarray) -> tuple:
    """Axes to reduce over so stats are per-feature: examples for 2d [N,F];
    examples+time for 3d [N,F,T]; examples+spatial for 4d [N,C,H,W]."""
    if a.ndim == 2:
        return (0,)
    if a.ndim == 3:
        return (0, 2)
    if a.ndim == 4:
        return (0, 2, 3)
    return tuple(range(a.ndim - 1))


def _float_dtype(a: np.ndarray):
    """Keep float dtypes; promote ints/uint8 images to float32 so
    normalization never truncates or wraps."""
    return a.dtype if np.issubdtype(a.dtype, np.floating) else np.float32


def _expand(stat: np.ndarray, ndim: int) -> np.ndarray:
    """Reshape per-feature stats [F] for broadcasting against the data."""
    if ndim == 2:
        return stat
    shape = [1, len(stat)] + [1] * (ndim - 2)
    return stat.reshape(shape)


class DataNormalization:
    """Base: fit(data) then preProcess(ds) / transform / revert."""

    def __init__(self):
        self._fit_label = False

    def fitLabel(self, fitLabels: bool):
        self._fit_label = bool(fitLabels)
        return self

    def isFitLabel(self) -> bool:
        return self._fit_label

    # -- fitting -------------------------------------------------------
    def fit(self, data):
        """Accepts a DataSet or a DataSetIterator (streamed one-pass fit)."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        self._reset_stats()
        if isinstance(data, DataSet):
            self._accumulate(_feat(data.getFeatures()),
                             _feat(data.getLabels()) if self._fit_label and data.getLabels() is not None else None)
        elif hasattr(data, "_raw_batches"):
            # bypass the iterator's padding and any installed preprocessor —
            # stats must come from the raw data, once per real example
            data.reset()
            for f, l in data._raw_batches():
                self._accumulate(f, l if self._fit_label and l is not None else None)
            data.reset()
        else:
            data.reset()
            while data.hasNext():
                ds = data.next()
                self._accumulate(_feat(ds.getFeatures()),
                                 _feat(ds.getLabels()) if self._fit_label and ds.getLabels() is not None else None)
            data.reset()
        self._finalize_stats()
        return self

    # -- application ---------------------------------------------------
    def preProcess(self, ds):
        """In-place DataSet transform (DataSetPreProcessor interface)."""
        ds.setFeatures(self._apply(_feat(ds.getFeatures()), label=False))
        if self._fit_label and ds.getLabels() is not None:
            ds.setLabels(self._apply(_feat(ds.getLabels()), label=True))
        return ds

    def transform(self, ds_or_features):
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        if isinstance(ds_or_features, DataSet):
            return self.preProcess(ds_or_features)
        return _array(self._apply(_feat(ds_or_features), label=False))

    def revertFeatures(self, features):
        return _array(self._revert(_feat(features), label=False))

    def revertLabels(self, labels):
        return _array(self._revert(_feat(labels), label=True))

    def revert(self, ds):
        ds.setFeatures(self.revertFeatures(ds.getFeatures()))
        if self._fit_label and ds.getLabels() is not None:
            ds.setLabels(self.revertLabels(ds.getLabels()))
        return ds


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature (streamed Chan et al. merge)."""

    def _reset_stats(self):
        self._n = 0
        self._sum = None
        self._sumsq = None
        self._ln = 0
        self._lsum = None
        self._lsumsq = None

    def _accumulate(self, f, l):
        axes = _feature_axes(f)
        cnt = int(np.prod([f.shape[a] for a in axes]))
        s = f.sum(axis=axes, dtype=np.float64)
        ss = (f.astype(np.float64) ** 2).sum(axis=axes)
        if self._sum is None:
            self._sum, self._sumsq = s, ss
        else:
            self._sum += s
            self._sumsq += ss
        self._n += cnt
        if l is not None:
            laxes = _feature_axes(l)
            lcnt = int(np.prod([l.shape[a] for a in laxes]))
            ls = l.sum(axis=laxes, dtype=np.float64)
            lss = (l.astype(np.float64) ** 2).sum(axis=laxes)
            if self._lsum is None:
                self._lsum, self._lsumsq = ls, lss
            else:
                self._lsum += ls
                self._lsumsq += lss
            self._ln += lcnt

    def _finalize_stats(self):
        self._mean = self._sum / self._n
        var = self._sumsq / self._n - self._mean ** 2
        self._std = np.sqrt(np.maximum(var, 1e-12))
        if self._lsum is not None:
            self._lmean = self._lsum / self._ln
            lvar = self._lsumsq / self._ln - self._lmean ** 2
            self._lstd = np.sqrt(np.maximum(lvar, 1e-12))

    def _apply(self, a, label):
        mean = self._lmean if label else self._mean
        std = self._lstd if label else self._std
        return ((a - _expand(mean, a.ndim)) / _expand(std, a.ndim)).astype(_float_dtype(a))

    def _revert(self, a, label):
        mean = self._lmean if label else self._mean
        std = self._lstd if label else self._std
        return (a * _expand(std, a.ndim) + _expand(mean, a.ndim)).astype(_float_dtype(a))

    def getMean(self):
        return _array(self._mean)

    def getStd(self):
        return _array(self._std)

    # -- persistence (reference: NormalizerSerializer) -----------------
    def save(self, path):
        np.savez(path, kind=np.array("standardize"), mean=self._mean, std=self._std,
                 fit_label=self._fit_label,
                 lmean=getattr(self, "_lmean", np.zeros(0)),
                 lstd=getattr(self, "_lstd", np.zeros(0)))

    @staticmethod
    def load(path):
        z = np.load(path, allow_pickle=False)
        n = NormalizerStandardize()
        n._mean, n._std = z["mean"], z["std"]
        n._fit_label = bool(z["fit_label"])
        if z["lmean"].size:
            n._lmean, n._lstd = z["lmean"], z["lstd"]
        return n


class NormalizerMinMaxScaler(DataNormalization):
    """Scale each feature into [minRange, maxRange] (default [0, 1])."""

    def __init__(self, minRange: float = 0.0, maxRange: float = 1.0):
        super().__init__()
        self._lo, self._hi = float(minRange), float(maxRange)

    def _reset_stats(self):
        self._min = None
        self._max = None
        self._lmin = None
        self._lmax = None

    def _accumulate(self, f, l):
        axes = _feature_axes(f)
        mn, mx = f.min(axis=axes), f.max(axis=axes)
        self._min = mn if self._min is None else np.minimum(self._min, mn)
        self._max = mx if self._max is None else np.maximum(self._max, mx)
        if l is not None:
            laxes = _feature_axes(l)
            lmn, lmx = l.min(axis=laxes), l.max(axis=laxes)
            self._lmin = lmn if self._lmin is None else np.minimum(self._lmin, lmn)
            self._lmax = lmx if self._lmax is None else np.maximum(self._lmax, lmx)

    def _finalize_stats(self):
        pass

    def _apply(self, a, label):
        mn = self._lmin if label else self._min
        mx = self._lmax if label else self._max
        rng = np.maximum(mx - mn, 1e-12)
        unit = (a - _expand(mn, a.ndim)) / _expand(rng, a.ndim)
        return (unit * (self._hi - self._lo) + self._lo).astype(_float_dtype(a))

    def _revert(self, a, label):
        mn = self._lmin if label else self._min
        mx = self._lmax if label else self._max
        rng = np.maximum(mx - mn, 1e-12)
        unit = (a - self._lo) / (self._hi - self._lo)
        return (unit * _expand(rng, a.ndim) + _expand(mn, a.ndim)).astype(_float_dtype(a))

    def getMin(self):
        return _array(self._min)

    def getMax(self):
        return _array(self._max)

    def save(self, path):
        np.savez(path, kind=np.array("minmax"), min=self._min, max=self._max,
                 lo=self._lo, hi=self._hi, fit_label=self._fit_label,
                 lmin=(self._lmin if self._lmin is not None else np.zeros(0)),
                 lmax=(self._lmax if self._lmax is not None else np.zeros(0)))

    @staticmethod
    def load(path):
        z = np.load(path, allow_pickle=False)
        n = NormalizerMinMaxScaler(float(z["lo"]), float(z["hi"]))
        n._min, n._max = z["min"], z["max"]
        n._fit_label = bool(z["fit_label"])
        if z["lmin"].size:
            n._lmin, n._lmax = z["lmin"], z["lmax"]
        return n


class ImagePreProcessingScaler(DataNormalization):
    """Pixel scaler: [0, maxPixel] -> [minRange, maxRange]. Needs no fit
    (reference: ImagePreProcessingScaler, fit is a no-op)."""

    def __init__(self, minRange: float = 0.0, maxRange: float = 1.0,
                 maxPixelVal: float = 255.0):
        super().__init__()
        self._lo, self._hi = float(minRange), float(maxRange)
        self._maxpix = float(maxPixelVal)

    def fit(self, data):
        return self

    def _apply(self, a, label):
        return (a / self._maxpix * (self._hi - self._lo) + self._lo).astype(np.float32)

    def _revert(self, a, label):
        return ((a - self._lo) / (self._hi - self._lo) * self._maxpix).astype(np.float32)

    def preProcess(self, ds):
        ds.setFeatures(self._apply(_feat(ds.getFeatures()), label=False))
        return ds


class VGG16ImagePreProcessor(DataNormalization):
    """Subtract ImageNet channel means from [N, 3, H, W] (reference:
    VGG16ImagePreProcessor; BGR means 123.68/116.779/103.939 in RGB order)."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def fit(self, data):
        return self

    def _apply(self, a, label):
        return (a - self.MEANS.reshape(1, 3, 1, 1)).astype(np.float32)

    def _revert(self, a, label):
        return (a + self.MEANS.reshape(1, 3, 1, 1)).astype(np.float32)

    def preProcess(self, ds):
        ds.setFeatures(self._apply(_feat(ds.getFeatures()), label=False))
        return ds
