"""Built-in dataset iterators and the k-batch staging helpers.

The counterpart of ``deeplearning4j_tpu/data/iterators.py``: Iris,
MNIST, CIFAR-10, FashionMNIST, EMNIST and the lazy
``RandomDataSetIterator``, plus ``iter_stacks`` / ``stack_mask_group`` /
``stack_datasets``, the staging unit of ``fitDataSet(stepsPerSync=k)``.
Each dataset iterator resolves its data in the reference's order:

1. local files under ``$DL4J_TPU_DATA_DIR`` (default ``~/.deeplearning4j``)
   in the standard formats (MNIST idx / CIFAR-10 binary batches),
2. a bundled in-process copy (iris via sklearn's packaged CSV, where
   sklearn is installed),
3. the reference's deterministic synthetic generator with the same
   shapes, dtypes and class structure, byte for byte the reference's
   for the same seeds and flagged via ``.isSynthetic``.

Nothing here reaches the network: the reference's ``fetch_mnist``
download is not ported (ROADMAP.md Queue 1 item 10). Every iterator pads
its final partial batch under a zero label mask, so each batch has one
shape.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSetIterator, _np


def _data_dir() -> Path:
    return Path(os.environ.get("DL4J_TPU_DATA_DIR",
                               os.path.expanduser("~/.deeplearning4j")))


# ------------------------------------------------------- k-batch staging
def iter_stacks(iterator, k: int):
    """Yield lists of up to `k` consecutive batches from a
    DataSetIterator (or any object with hasNext/next, or a plain
    iterable). Every yielded list except possibly the last has exactly
    `k` entries — the staging unit of ``fitDataSet(stepsPerSync=k)``;
    the short final list is the ragged tail the caller runs through
    plain per-batch ``fit()``."""
    k = int(k)
    if k < 1:
        raise ValueError(f"stepsPerSync must be >= 1, got {k}")
    buf = []
    if hasattr(iterator, "hasNext"):
        while iterator.hasNext():
            buf.append(iterator.next())
            if len(buf) == k:
                yield buf
                buf = []
    else:
        for ds in iterator:
            buf.append(ds)
            if len(buf) == k:
                yield buf
                buf = []
    if buf:
        yield buf


def stack_mask_group(arrs, what):
    """Stack one mask component across a k-batch group. All-None stays
    None; mixed presence synthesises an all-ones mask for the maskless
    batches (semantically "nothing masked" — the padded final batch of
    an epoch is the one batch that carries a mask, and it must be able
    to share a stack with unmasked ones). Shapes must agree: the stack
    is one fixed-shape device buffer."""
    if all(a is None for a in arrs):
        return None
    template = next(a for a in arrs if a is not None)
    filled = [np.ones_like(template) if a is None else a for a in arrs]
    shapes = {a.shape for a in filled}
    if len(shapes) > 1:
        raise ValueError(
            f"fitDataSet stack has ragged {what} shapes {sorted(shapes)}: "
            "device staging needs one fixed shape per component (the "
            "built-in iterators pad their final batch already)")
    return np.stack(filled)


def stack_datasets(batches):
    """Stack k DataSets into one host-side [k, B, ...] stack per
    component -> (features, labels, featuresMask, labelsMask), masks
    None when absent everywhere. The stack is what
    ``fitDataSet(stepsPerSync=k)`` ships to the device in ONE transfer;
    step i of the block takes batch i of it."""

    def stack(getter, what):
        arrs = [_np(getattr(ds, getter)()) for ds in batches]
        if any(a is None for a in arrs):
            if all(a is None for a in arrs):
                return None
            raise ValueError(
                f"fitDataSet stack has batches with and without {what}")
        shapes = {a.shape for a in arrs}
        if len(shapes) > 1:
            raise ValueError(
                f"fitDataSet stack has ragged {what} shapes "
                f"{sorted(shapes)}: device staging needs one fixed shape "
                "per component (the built-in iterators pad their final "
                "batch already)")
        return np.stack(arrs)

    return (stack("getFeatures", "features"),
            stack("getLabels", "labels"),
            stack_mask_group([_np(ds.getFeaturesMaskArray())
                              for ds in batches], "features-mask"),
            stack_mask_group([_np(ds.getLabelsMaskArray())
                              for ds in batches], "labels-mask"))


# ------------------------------------------------------------------ IRIS
def _iris_arrays():
    try:  # sklearn ships the CSV inside the wheel — no network needed
        from sklearn.datasets import load_iris

        d = load_iris()
        return d.data.astype(np.float32), d.target.astype(np.int64), False
    except Exception:
        # synthetic stand-in: 3 Gaussian clusters in 4-d with iris-like
        # means/scales, 50 examples per class, fixed seed
        rng = np.random.RandomState(42)
        means = np.array([[5.0, 3.4, 1.5, 0.25], [5.9, 2.8, 4.3, 1.3],
                          [6.6, 3.0, 5.6, 2.0]], np.float32)
        scales = np.array([[0.35, 0.38, 0.17, 0.1], [0.51, 0.31, 0.47, 0.2],
                           [0.63, 0.32, 0.55, 0.27]], np.float32)
        f = np.concatenate([means[c] + scales[c] * rng.randn(50, 4)
                            for c in range(3)]).astype(np.float32)
        t = np.repeat(np.arange(3), 50)
        return f, t, True


class IrisDataSetIterator(DataSetIterator):
    """Reference: org.deeplearning4j.datasets.iterator.impl.IrisDataSetIterator."""

    def __init__(self, batchSize: int = 150, numExamples: int = 150,
                 shuffle=False, seed=123):
        f, t, synth = _iris_arrays()
        f, t = f[:numExamples], t[:numExamples]
        labels = np.eye(3, dtype=np.float32)[t]
        self.isSynthetic = synth
        super().__init__(f, labels, batchSize, shuffle=shuffle, seed=seed)


# ------------------------------------------------------------------ MNIST
def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        magic, = struct.unpack(">i", fh.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}i", fh.read(4 * ndim))
        return np.frombuffer(fh.read(), np.uint8).reshape(shape)


def _find_idx(base: Path, names: list[str]):
    for n in names:
        for cand in (base / n, base / (n + ".gz")):
            if cand.exists():
                return cand
    return None


def _synthetic_digits(n: int, classes: int, hw: int, channels: int,
                      template_seed: int, noise_seed: int):
    """Deterministic class-conditional images: each class is a fixed random
    low-frequency template; examples are the template plus pixel noise and
    a small random translation. Templates depend only on ``template_seed``
    so the train and test splits (different ``noise_seed``) draw from the
    SAME class distributions — a model trained on the synthetic train split
    generalises to the synthetic test split, like real MNIST."""
    trng = np.random.RandomState(template_seed)
    # low-freq templates: upsampled coarse grids, one per class
    coarse = trng.rand(classes, channels, 7, 7).astype(np.float32)
    reps = hw // 7 + 1
    templates = np.kron(coarse, np.ones((1, 1, reps, reps), np.float32))[:, :, :hw, :hw]
    rng = np.random.RandomState(noise_seed)
    labels = rng.randint(0, classes, n)
    out = np.empty((n, channels, hw, hw), np.float32)
    shifts = rng.randint(-2, 3, size=(n, 2))
    noise = rng.rand(n, channels, hw, hw).astype(np.float32)
    for i in range(n):
        img = np.roll(templates[labels[i]], tuple(shifts[i]), axis=(1, 2))
        out[i] = np.clip(0.75 * img + 0.25 * noise[i], 0, 1)
    return (out * 255).astype(np.uint8), labels


def _load_idx_or_synth(base, img_names, lbl_names, num_classes,
                       numExamples, seed, train, what):
    """Shared idx-or-synthetic loader behind the MNIST-family iterators:
    returns (uint8 images [N,1,28,28], int labels, isSynthetic)."""
    img_p = _find_idx(base, img_names)
    lbl_p = _find_idx(base, lbl_names)
    if img_p is not None and lbl_p is not None:
        return (_read_idx(img_p)[:, None, :, :],
                _read_idx(lbl_p).astype(np.int64), False)
    n = numExamples or 10000
    if not numExamples and train:
        import warnings

        warnings.warn(f"{what} idx files not found; using {n} synthetic "
                      f"examples (pass numExamples to override)",
                      stacklevel=3)
    imgs, labels = _synthetic_digits(n, num_classes, 28, 1,
                                     template_seed=seed,
                                     noise_seed=seed + (1 if train else 2))
    return imgs, labels, True


def _finish_mnist_like(self, imgs, labels, num_classes, numExamples,
                       batchSize, train, shuffle, seed, reshapeToCnn):
    """Shared truncate/scale/flatten/one-hot tail of the MNIST-family
    iterators."""
    if numExamples:
        imgs, labels = imgs[:numExamples], labels[:numExamples]
    f = imgs.astype(np.float32) / 255.0
    if not reshapeToCnn:
        f = f.reshape(len(f), -1)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    DataSetIterator.__init__(
        self, f, onehot, batchSize,
        shuffle=(train if shuffle is None else shuffle), seed=seed)


class MnistDataSetIterator(DataSetIterator):
    """Reference: MnistDataSetIterator — features [B, 784] float32 in [0, 1]
    (or [B, 1, 28, 28] with ``reshapeToCnn=True``), one-hot labels [B, 10].

    Looks for idx files (train-images-idx3-ubyte[.gz] etc.) under
    ``$DL4J_TPU_DATA_DIR/mnist``; synthesises digits otherwise — loudly."""

    NUM_CLASSES = 10

    _DIR = "mnist"

    def __init__(self, batchSize: int, train: bool = True, seed: int = 123,
                 numExamples: int = None, shuffle: bool = None,
                 reshapeToCnn: bool = False):
        base = _data_dir() / self._DIR
        tag = "train" if train else "t10k"
        imgs, labels, self.isSynthetic = _load_idx_or_synth(
            base,
            [f"{tag}-images-idx3-ubyte", f"{tag}-images.idx3-ubyte"],
            [f"{tag}-labels-idx1-ubyte", f"{tag}-labels.idx1-ubyte"],
            self.NUM_CLASSES, numExamples, seed, train, self._DIR)
        _finish_mnist_like(self, imgs, labels, self.NUM_CLASSES,
                           numExamples, batchSize, train, shuffle, seed,
                           reshapeToCnn)


class Cifar10DataSetIterator(DataSetIterator):
    """Reference: Cifar10DataSetIterator — features [B, 3, 32, 32] float32,
    one-hot labels [B, 10]. Reads CIFAR-10 binary batches
    (data_batch_*.bin / test_batch.bin) under ``$DL4J_TPU_DATA_DIR/cifar10``;
    synthesises otherwise."""

    def __init__(self, batchSize: int, train: bool = True, seed: int = 123,
                 numExamples: int = None, shuffle: bool = None):
        base = _data_dir() / "cifar10"
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [base / n for n in names]
        # the archive layout nests under cifar-10-batches-bin/
        nested = base / "cifar-10-batches-bin"
        if not all(p.exists() for p in paths) and nested.exists():
            paths = [nested / n for n in names]
        if all(p.exists() for p in paths):
            recs = np.concatenate([
                np.frombuffer(p.read_bytes(), np.uint8).reshape(-1, 3073)
                for p in paths])
            labels = recs[:, 0].astype(np.int64)
            imgs = recs[:, 1:].reshape(-1, 3, 32, 32)
            self.isSynthetic = False
        else:
            if numExamples:
                n = numExamples
            else:
                n = 10000
                if train:
                    import warnings

                    warnings.warn("CIFAR-10 batches not found; using 10000 "
                                  "synthetic examples (pass numExamples to "
                                  "override)", stacklevel=2)
            imgs, labels = _synthetic_digits(n, 10, 32, 3, template_seed=seed,
                                             noise_seed=seed + (1 if train else 2))
            self.isSynthetic = True
        if numExamples:
            imgs, labels = imgs[:numExamples], labels[:numExamples]
        f = imgs.astype(np.float32) / 255.0
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(f, onehot, batchSize,
                         shuffle=(train if shuffle is None else shuffle), seed=seed)


# legacy alias matching the reference's older class name
CifarDataSetIterator = Cifar10DataSetIterator


class RandomDataSetIterator:
    """Reference: org.nd4j RandomDataSetIterator (Values.RANDOM_UNIFORM etc.)
    — synthetic batches for smoke tests and benchmarks. Batches are
    generated lazily, one per ``next()`` (seeded by batch index), so
    bench-scale shapes use constant host memory."""

    def __init__(self, numBatches: int, featuresShape, labelsShape, seed: int = 123):
        self._num = int(numBatches)
        self._fshape = tuple(featuresShape)
        self._lshape = tuple(labelsShape)
        self._seed = seed
        self._i = 0
        self._preprocessor = None

    def reset(self):
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < self._num

    def next(self, num=None):
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        rng = np.random.RandomState(self._seed + self._i)
        self._i += 1
        ds = DataSet(rng.rand(*self._fshape).astype(np.float32),
                     rng.rand(*self._lshape).astype(np.float32))
        if self._preprocessor is not None:
            self._preprocessor.preProcess(ds)
        return ds

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def batch(self) -> int:
        return self._fshape[0]

    def totalExamples(self) -> int:
        return self._num * self._fshape[0]

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def getPreProcessor(self):
        return self._preprocessor


class FashionMnistDataSetIterator(MnistDataSetIterator):
    """Reference: FashionMnistDataSetIterator — identical idx format to
    MNIST (28x28, 10 classes), read from
    ``$DL4J_TPU_DATA_DIR/fashion-mnist``; synthesises loudly otherwise."""

    _DIR = "fashion-mnist"


class EmnistDataSetIterator(DataSetIterator):
    """Reference: EmnistDataSetIterator with its Set enum — the EMNIST
    splits share MNIST's idx format but differ in class count. Files
    ``emnist-<set>-{train,test}-{images,labels}-idx?-ubyte[.gz]`` under
    ``$DL4J_TPU_DATA_DIR/emnist``; synthetic fallback is loud."""

    SETS = {"complete": 62, "byclass": 62, "bymerge": 47, "balanced": 47,
            "letters": 26, "digits": 10, "mnist": 10}

    def __init__(self, dataSet: str, batchSize: int, train: bool = True,
                 seed: int = 123, numExamples: int = None,
                 shuffle: bool = None, reshapeToCnn: bool = False):
        key = str(dataSet).lower()
        if key not in self.SETS:
            raise ValueError(f"unknown EMNIST set {dataSet!r}; one of "
                             f"{sorted(self.SETS)}")
        self.numClasses = self.SETS[key]
        base = _data_dir() / "emnist"
        tag = "train" if train else "test"
        # "complete" is upstream's alias for the byclass files
        filekey = "byclass" if key == "complete" else key
        imgs, labels, self.isSynthetic = _load_idx_or_synth(
            base,
            [f"emnist-{filekey}-{tag}-images-idx3-ubyte"],
            [f"emnist-{filekey}-{tag}-labels-idx1-ubyte"],
            self.numClasses, numExamples, seed, train, f"EMNIST({key})")
        if not self.isSynthetic:
            if key == "letters":
                labels = labels - 1  # 1-based in the format
            # the official EMNIST idx files store images TRANSPOSED
            # relative to MNIST orientation; undo it so models/visuals
            # are orientation-compatible with MNIST (upstream does too)
            imgs = imgs.transpose(0, 1, 3, 2)
        _finish_mnist_like(self, imgs, labels, self.numClasses,
                           numExamples, batchSize, train, shuffle, seed,
                           reshapeToCnn)
