"""Port parity for the data pipeline (deeplearning4j_tpu_torch/data/:
dataset, multidataset, iterators, normalizers) against the JAX
reference.

Mirrors tests/test_data.py's normalizer, scaler, built-in iterator,
preprocessor wiring, iterator variant, utility, minibatch-file, existing
minibatch and multiple-epochs classes (not the record or transform
ones): each case runs the same seeded numpy inputs through both packages
and holds the port to the reference. Tolerance: exact. Both sides do the
same numpy arithmetic on the host, so every array, statistic, batch
order, pad row and label mask is bit for bit the reference's, and the
synthetic digits are byte-equal for the same seeds.
"""

import os

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as JD
import deeplearning4j_tpu.data.iterators as JI
import deeplearning4j_tpu_torch.data as PD
import deeplearning4j_tpu_torch.data.iterators as PI

torch.set_num_threads(1)


def _np(a):
    if a is None:
        return None
    return np.asarray(a.toNumpy() if hasattr(a, "toNumpy") else a)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _same_batches(jit, pit):
    jb, pb = list(jit), list(pit)
    assert len(jb) == len(pb)
    for j, p in zip(jb, pb):
        _same(j.getFeatures(), p.getFeatures())
        _same(j.getLabels(), p.getLabels())
        _same(j.getFeaturesMaskArray(), p.getFeaturesMaskArray())
        _same(j.getLabelsMaskArray(), p.getLabelsMaskArray())
    return pb


def _both(fn):
    """fn(module) for the reference's data package and the port's."""
    return fn(JD), fn(PD)


# ------------------------------------------------------------- normalizers
class TestNormalizerStandardize:
    def test_zero_mean_unit_var(self):
        rng = np.random.RandomState(0)
        f = (rng.randn(200, 5) * np.array([1, 2, 3, 4, 5.0])
             + np.arange(5)).astype(np.float32)

        def run(M):
            ds = M.DataSet(f.copy(), np.zeros((200, 2), np.float32))
            M.NormalizerStandardize().fit(ds).preProcess(ds)
            return ds.getFeatures()

        j, p = _both(run)
        _same(j, p)
        np.testing.assert_allclose(_np(p).mean(0), 0, atol=1e-4)

    def test_streaming_fit_equals_full_fit(self):
        rng = np.random.RandomState(1)
        f = rng.randn(120, 3).astype(np.float32) * 4 + 7
        l = np.zeros((120, 2), np.float32)

        def run(M):
            full = M.NormalizerStandardize().fit(M.DataSet(f, l))
            stream = M.NormalizerStandardize().fit(
                M.DataSetIterator(f, l, 32, pad_final=False))
            return full, stream

        (jf, js), (pf, ps) = _both(run)
        for a, b in ((jf, pf), (js, ps)):
            _same(a._mean, b._mean)
            _same(a._std, b._std)

    def test_revert_round_trip(self):
        rng = np.random.RandomState(2)
        f = (rng.randn(50, 4) * 3 + 1).astype(np.float32)

        def run(M):
            ds = M.DataSet(f.copy(), np.zeros((50, 2), np.float32))
            n = M.NormalizerStandardize().fit(ds)
            n.preProcess(ds)
            return n.revertFeatures(ds.getFeatures())

        j, p = _both(run)
        _same(j, p)
        np.testing.assert_allclose(_np(p), f, atol=1e-4)

    def test_cnn_4d_per_channel(self):
        rng = np.random.RandomState(3)
        f = rng.rand(20, 3, 8, 8).astype(np.float32) \
            * np.array([1, 10, 100], np.float32).reshape(1, 3, 1, 1)

        def run(M):
            ds = M.DataSet(f.copy(), np.zeros((20, 2), np.float32))
            M.NormalizerStandardize().fit(ds).preProcess(ds)
            return ds.getFeatures()

        _same(*_both(run))

    def test_fit_label(self):
        rng = np.random.RandomState(4)
        f = rng.randn(60, 2).astype(np.float32)
        l = (rng.randn(60, 1) * 9 + 5).astype(np.float32)

        def run(M):
            ds = M.DataSet(f, l.copy())
            M.NormalizerStandardize().fitLabel(True).fit(ds).preProcess(ds)
            return ds.getLabels()

        j, p = _both(run)
        _same(j, p)
        np.testing.assert_allclose(_np(p).mean(), 0, atol=1e-4)

    def test_save_load(self, tmp_path):
        rng = np.random.RandomState(5)
        f = rng.randn(30, 3).astype(np.float32)
        n = PD.NormalizerStandardize().fit(
            PD.DataSet(f, np.zeros((30, 1), np.float32)))
        p = str(tmp_path / "norm.npz")
        n.save(p)
        # the reference reads the port's file, and the port its own
        j2 = JD.NormalizerStandardize.load(p)
        p2 = PD.NormalizerStandardize.load(p)
        _same(j2._mean, p2._mean)
        _same(p2._std, n._std)


class TestMinMaxAndImageScalers:
    def test_minmax_range(self):
        rng = np.random.RandomState(6)
        f = (rng.randn(100, 4) * 5).astype(np.float32)

        def run(M):
            ds = M.DataSet(f.copy(), np.zeros((100, 1), np.float32))
            n = M.NormalizerMinMaxScaler(-1.0, 1.0).fit(ds)
            n.preProcess(ds)
            return ds.getFeatures(), n.revertFeatures(ds.getFeatures())

        (j, jb), (p, pb) = _both(run)
        _same(j, p)
        _same(jb, pb)
        np.testing.assert_allclose(_np(p).min(0), -1, atol=1e-5)

    def test_image_scaler(self):
        f = np.array([[0.0, 127.5, 255.0]], np.float32)

        def run(M):
            ds = M.DataSet(f.copy(), None)
            M.ImagePreProcessingScaler().fit(ds).preProcess(ds)
            return ds.getFeatures()

        j, p = _both(run)
        _same(j, p)
        np.testing.assert_allclose(_np(p), [[0, 0.5, 1.0]], atol=1e-5)

    def test_vgg_preprocessor(self):
        f = np.zeros((2, 3, 4, 4), np.float32)

        def run(M):
            ds = M.DataSet(f.copy(), None)
            M.VGG16ImagePreProcessor().preProcess(ds)
            return ds.getFeatures()

        _same(*_both(run))


# --------------------------------------------------------------- iterators
class TestBuiltinIterators:
    def test_iris(self):
        j, p = _both(lambda M: M.IrisDataSetIterator(batchSize=50))
        assert j.isSynthetic == p.isSynthetic
        assert p.totalExamples() == 150
        _same_batches(j, p)

    def test_mnist_shapes(self):
        j, p = _both(lambda M: M.MnistDataSetIterator(
            batchSize=32, train=True, numExamples=200))
        pb = _same_batches(j, p)
        assert _np(pb[0].getFeatures()).shape == (32, 784)
        assert _np(pb[0].getLabels()).shape == (32, 10)

    def test_mnist_cnn_shape(self):
        j, p = _both(lambda M: M.MnistDataSetIterator(
            batchSize=16, numExamples=64, reshapeToCnn=True))
        assert _np(_same_batches(j, p)[0].getFeatures()).shape == \
            (16, 1, 28, 28)

    def test_cifar_shapes(self):
        j, p = _both(lambda M: M.Cifar10DataSetIterator(batchSize=8,
                                                        numExamples=64))
        assert _np(_same_batches(j, p)[0].getFeatures()).shape == \
            (8, 3, 32, 32)

    def test_mnist_deterministic(self):
        a = PD.MnistDataSetIterator(16, numExamples=32, shuffle=False,
                                    seed=7)
        b = PD.MnistDataSetIterator(16, numExamples=32, shuffle=False,
                                    seed=7)
        _same(a.next().getFeatures(), b.next().getFeatures())

    def test_mnist_is_learnable(self):
        it = PD.MnistDataSetIterator(512, numExamples=512, shuffle=False)
        ds = it.next()
        f = _np(ds.getFeatures())
        y = _np(ds.getLabels()).argmax(-1)
        w = np.linalg.lstsq(np.c_[f, np.ones(len(f))], np.eye(10)[y],
                            rcond=None)[0]
        acc = (np.c_[f, np.ones(len(f))].dot(w).argmax(-1) == y).mean()
        assert acc > 0.5

    @pytest.mark.parametrize("seed", [0, 3, 123])
    @pytest.mark.parametrize("shape", [(10, 28, 1), (10, 32, 3)],
                             ids=["mnist", "cifar"])
    def test_synthetic_digits_byte_equal(self, seed, shape):
        classes, hw, ch = shape
        j = JI._synthetic_digits(40, classes, hw, ch, seed, seed + 1)
        p = PI._synthetic_digits(40, classes, hw, ch, seed, seed + 1)
        assert j[0].tobytes() == p[0].tobytes()
        assert j[1].tobytes() == p[1].tobytes()

    def test_shuffled_epochs_match(self):
        j, p = _both(lambda M: M.MnistDataSetIterator(
            batchSize=24, numExamples=100, shuffle=True, seed=5))
        for _ in range(2):      # RandomState(seed + epoch) each epoch
            _same_batches(j, p)


class TestIteratorPreprocessorWiring:
    def test_normalizer_as_preprocessor(self):
        rng = np.random.RandomState(9)
        f = (rng.randn(64, 3) * 10 + 4).astype(np.float32)
        l = np.zeros((64, 2), np.float32)

        def run(M):
            it = M.DataSetIterator(f, l, 16)
            it.setPreProcessor(M.NormalizerStandardize().fit(it))
            return it

        _same_batches(*_both(run))


class TestReviewRegressions:
    def test_fit_ignores_padding_and_preprocessor(self):
        rng = np.random.RandomState(10)
        f = (rng.randn(20, 3) * 5 + 2).astype(np.float32)
        l = np.zeros((20, 1), np.float32)
        it = PD.DataSetIterator(f, l, 16)
        n = PD.NormalizerStandardize().fit(it)
        np.testing.assert_allclose(n._mean, f.mean(0), rtol=1e-5)
        it.setPreProcessor(n)
        n2 = PD.NormalizerStandardize().fit(it)
        _same(n2._mean, n._mean)

    def test_synthetic_train_test_share_templates(self):
        tr = PD.MnistDataSetIterator(256, numExamples=256, train=True,
                                     shuffle=False, seed=3)
        te = PD.MnistDataSetIterator(256, numExamples=256, train=False,
                                     shuffle=False, seed=3)
        if not tr.isSynthetic:
            pytest.skip("real MNIST present")
        Xtr, Ytr = tr._f.reshape(256, -1), tr._l.argmax(-1)
        Xte, Yte = te._f.reshape(256, -1), te._l.argmax(-1)
        w = np.linalg.lstsq(np.c_[Xtr, np.ones(256)], np.eye(10)[Ytr],
                            rcond=None)[0]
        acc = (np.c_[Xte, np.ones(256)].dot(w).argmax(-1) == Yte).mean()
        assert acc > 0.4

    def test_normalizer_promotes_uint8(self):
        f = np.arange(12, dtype=np.uint8).reshape(4, 3)

        def run(M):
            n = M.NormalizerStandardize().fit(
                M.DataSet(f.astype(np.float32), np.zeros((4, 1), np.float32)))
            return n._apply(f, label=False)

        j, p = _both(run)
        _same(j, p)
        assert np.issubdtype(p.dtype, np.floating) and p.min() < 0

    def test_random_iterator_lazy_and_deterministic(self):
        j, p = _both(lambda M: M.RandomDataSetIterator(3, (4, 5), (4, 2),
                                                       seed=9))
        _same_batches(j, p)
        p.reset()
        b = [_np(p.next().getFeatures()) for _ in range(3)]
        assert not p.hasNext() and not np.array_equal(b[0], b[1])


class TestDatasetIteratorVariants:
    def test_fashion_mnist_shapes(self):
        j, p = _both(lambda M: M.FashionMnistDataSetIterator(
            32, train=True, numExamples=96))
        assert _np(_same_batches(j, p)[0].getLabels()).shape == (32, 10)

    def test_emnist_class_counts_and_validation(self):
        j, p = _both(lambda M: M.EmnistDataSetIterator(
            "letters", 16, numExamples=64, reshapeToCnn=True))
        pb = _same_batches(j, p)
        assert _np(pb[0].getLabels()).shape == (16, 26)
        assert _np(PD.EmnistDataSetIterator("balanced", 8, numExamples=16)
                   .next().getLabels()).shape == (8, 47)
        with pytest.raises(ValueError, match="unknown EMNIST"):
            PD.EmnistDataSetIterator("bogus", 8)


class TestUtilityIterators:
    def _arrays(self, n=10):
        f = np.arange(n * 3, dtype="float32").reshape(n, 3)
        l = np.eye(2, dtype="float32")[np.arange(n) % 2]
        return f, l

    def test_kfold_partition(self):
        f, l = self._arrays(10)
        j, p = _both(lambda M: M.KFoldIterator(3, M.DataSet(f, l)))
        folds = 0
        while p.hasNext():
            jt, pt = j.next(), p.next()
            _same(jt.getFeatures(), pt.getFeatures())
            _same(j.testFold().getFeatures(), p.testFold().getFeatures())
            folds += 1
        assert folds == 3 and not j.hasNext()

    def test_kfold_sizes_first_folds_larger(self):
        f, l = self._arrays(10)
        it = PD.KFoldIterator(3, PD.DataSet(f, l))
        assert [it.next().numExamples() for _ in range(3)] == [6, 7, 7]

    def test_kfold_validation(self):
        f, l = self._arrays(10)
        with pytest.raises(ValueError, match="k must be"):
            PD.KFoldIterator(1, PD.DataSet(f, l))
        with pytest.raises(ValueError, match="exceeds"):
            PD.KFoldIterator(20, PD.DataSet(f, l))

    def test_multiple_epochs_replays(self):
        f = np.arange(8, dtype="float32").reshape(4, 2)
        l = np.eye(2, dtype="float32")[[0, 1, 0, 1]]
        j, p = _both(lambda M: M.MultipleEpochsIterator(
            3, M.DataSetIterator(f, l, 2)))
        assert len(_same_batches(j, p)) == 6
        assert p.totalExamples() == 12
        assert len(list(p)) == 6

    def test_multiple_epochs_trains_like_epochs_arg(self):
        import deeplearning4j_tpu_torch.nn as P

        rng = np.random.RandomState(0)
        X = rng.randn(64, 4).astype("float32")
        Y = np.eye(2, dtype="float32")[(X.sum(1) > 0).astype(int)]

        def build():
            conf = (P.NeuralNetConfiguration.Builder().seed(3)
                    .updater(P.Adam(1e-2)).list()
                    .layer(P.DenseLayer(nIn=4, nOut=8, activation="tanh"))
                    .layer(P.OutputLayer(nOut=2, activation="softmax"))
                    .build())
            return P.MultiLayerNetwork(conf, device="cpu").init()

        a = build()
        a.fit(PD.DataSetIterator(X, Y, 32), epochs=4)
        b = build()
        b.fit(PD.MultipleEpochsIterator(4, PD.DataSetIterator(X, Y, 32)))
        assert a.score() == b.score()

    def test_view_iterator(self):
        f, l = self._arrays(10)
        _same_batches(*_both(lambda M: M.ViewIterator(M.DataSet(f, l), 4)))

    def test_kfold_reset_clears_test_fold(self):
        f, l = self._arrays(9)
        it = PD.KFoldIterator(3, PD.DataSet(f, l))
        while it.hasNext():
            it.next()
        it.reset()
        with pytest.raises(RuntimeError, match="next"):
            it.testFold()

    def test_multiple_epochs_normalizer_stats_unbiased(self):
        f = np.arange(10, dtype="float32").reshape(5, 2)
        l = np.eye(2, dtype="float32")[[0, 1, 0, 1, 0]]
        n1 = PD.NormalizerStandardize().fit(PD.DataSetIterator(f, l, 2))
        n2 = PD.NormalizerStandardize().fit(
            PD.MultipleEpochsIterator(3, PD.DataSetIterator(f, l, 2)))
        _same(n1._mean, n2._mean)
        _same(n1._std, n2._std)

    def test_list_and_existing_iterators(self):
        f, l = self._arrays(10)

        def run(M):
            parts = [M.DataSet(f[:4], l[:4]), M.DataSet(f[4:], l[4:])]
            return (M.ListDataSetIterator(parts, 3),
                    M.ExistingDataSetIterator(M.DataSet(f, l), 4))

        (j1, j2), (p1, p2) = _both(run)
        _same_batches(j1, p1)
        _same_batches(j2, p2)

    def test_dataset_split_sample_shuffle(self):
        f, l = self._arrays(10)

        def run(M):
            ds = M.DataSet(f.copy(), l.copy())
            st = ds.splitTestAndTrain(0.7)
            s = ds.sample(4, seed=2)
            ds.shuffle(seed=5)
            return (st.getTrain().getFeatures(), st.getTest().getFeatures(),
                    s.getFeatures(), ds.getFeatures(), len(ds.asList()))

        j, p = _both(run)
        for a, b in zip(j[:4], p[:4]):
            _same(a, b)
        assert j[4] == p[4] == 10


class TestMiniBatchFileIterator:
    def _ds(self, M, n=10):
        f = np.arange(n * 2, dtype="float32").reshape(n, 2)
        l = np.eye(2, dtype="float32")[np.arange(n) % 2]
        return M.DataSet(f, l)

    def test_batches_roundtrip_from_disk(self, tmp_path):
        j, p = JD.MiniBatchFileDataSetIterator(
            self._ds(JD), 4, rootDir=tmp_path / "j"), \
            PD.MiniBatchFileDataSetIterator(self._ds(PD), 4,
                                            rootDir=tmp_path / "p")
        assert len(os.listdir(p.rootDir())) == 3
        pb = _same_batches(j, p)
        np.testing.assert_allclose(_np(pb[-1].getLabelsMaskArray()),
                                   [1, 1, 0, 0])
        assert p.totalExamples() == 10
        assert p.inputColumns() == 2 and p.totalOutcomes() == 2
        assert len(list(p)) == 3
        # each package reads the other's files
        _same_batches(JD.ExistingMiniBatchDataSetIterator(tmp_path / "p"),
                      PD.ExistingMiniBatchDataSetIterator(tmp_path / "j"))

    def test_masks_persist(self, tmp_path):
        f = np.zeros((5, 2, 3), "float32")
        fm = np.arange(15, dtype="float32").reshape(5, 3)
        it = PD.MiniBatchFileDataSetIterator(
            PD.DataSet(f, f.copy(), featuresMask=fm), 5,
            rootDir=tmp_path / "mbm")
        _same(it.next().getFeaturesMaskArray(), fm)

    def test_composes_with_normalizer_and_epochs(self, tmp_path):
        ds = self._ds(PD)
        it = PD.MiniBatchFileDataSetIterator(ds, 4, rootDir=tmp_path / "m")
        n1 = PD.NormalizerStandardize().fit(PD.MultipleEpochsIterator(2, it))
        n2 = PD.NormalizerStandardize().fit(
            PD.DataSetIterator(ds.getFeatures(), ds.getLabels(), 4))
        _same(n1._mean, n2._mean)

    def test_next_num_rejected(self, tmp_path):
        it = PD.MiniBatchFileDataSetIterator(self._ds(PD, 8), 4,
                                             rootDir=tmp_path / "x")
        with pytest.raises(ValueError, match="re-batch"):
            it.next(3)

    def test_delete_on_exhaust(self, tmp_path):
        it = PD.MiniBatchFileDataSetIterator(self._ds(PD, 6), 3,
                                             rootDir=tmp_path / "d",
                                             delete_on_exhaust=True)
        list(it)
        assert os.listdir(it.rootDir()) == []

    def test_delete_on_exhaust_reset_raises(self, tmp_path):
        it = PD.MiniBatchFileDataSetIterator(self._ds(PD, 6), 3,
                                             rootDir=tmp_path / "r",
                                             delete_on_exhaust=True)
        assert len(list(it)) == 2
        with pytest.raises(RuntimeError, match="delete_on_exhaust"):
            it.reset()


class TestExistingMiniBatchIterator:
    def test_reads_writer_output(self, tmp_path):
        f = np.arange(12, dtype="float32").reshape(6, 2)
        l = np.eye(2, dtype="float32")[np.arange(6) % 2]
        PD.MiniBatchFileDataSetIterator(PD.DataSet(f, l), 3,
                                        rootDir=tmp_path / "mb")
        batches = list(PD.ExistingMiniBatchDataSetIterator(tmp_path / "mb"))
        assert len(batches) == 2
        _same(np.concatenate([_np(b.getFeatures()) for b in batches]), f)

    def test_missing_dir_and_empty(self, tmp_path):
        with pytest.raises(ValueError, match="not a directory"):
            PD.ExistingMiniBatchDataSetIterator(tmp_path / "nope")
        (tmp_path / "empty").mkdir()
        with pytest.raises(ValueError, match="no files matching"):
            PD.ExistingMiniBatchDataSetIterator(tmp_path / "empty")

    def test_interop_surface_and_padding(self, tmp_path):
        f = np.arange(14, dtype="float32").reshape(7, 2)
        l = np.eye(2, dtype="float32")[np.arange(7) % 2]
        PD.MiniBatchFileDataSetIterator(PD.DataSet(f, l), 3,
                                        rootDir=tmp_path / "mb7")
        it = PD.ExistingMiniBatchDataSetIterator(tmp_path / "mb7")
        assert it.batch() == 3 and it.totalExamples() == 7
        batches = list(it)
        assert [b.numExamples() for b in batches] == [3, 3, 3]
        _same(batches[-1].getLabelsMaskArray(),
              np.array([1, 0, 0], np.float32))
        assert PD.MultipleEpochsIterator(2, it).batch() == 3
        n1 = PD.NormalizerStandardize()
        it.setPreProcessor(n1)
        n1.fit(it)
        n2 = PD.NormalizerStandardize().fit(PD.DataSetIterator(f, l, 3))
        _same(n1._mean, n2._mean)
        with pytest.raises(ValueError, match="re-batch"):
            it.next(2)


class TestMultipleEpochsEmptyUnderlying:
    class _Empty:
        def reset(self):
            pass

        def hasNext(self):
            return False

        def next(self, num=None):
            raise StopIteration

    def test_empty_underlying_contract(self):
        it = PD.MultipleEpochsIterator(3, self._Empty())
        assert not it.hasNext()
        with pytest.raises(StopIteration):
            it.next()
        assert list(iter(it)) == []


class TestMultiDataSet:
    def test_padding_and_masks_match(self):
        rng = np.random.RandomState(12)
        f1 = rng.randn(7, 3).astype("float32")
        f2 = rng.randn(7, 2, 4).astype("float32")
        l1 = np.eye(2, dtype="float32")[rng.randint(0, 2, 7)]
        lm = [None]

        def run(M):
            from importlib import import_module

            mds = import_module(M.__name__ + ".multidataset")
            return mds.MultiDataSetIterator([f1, f2], [l1], 3,
                                            labelsMasks=lm)

        j, p = _both(run)
        while p.hasNext():
            a, b = j.next(), p.next()
            for x, y in zip(a.getFeatures(), b.getFeatures()):
                _same(x, y)
            _same(a.getLabels(0), b.getLabels(0))
            for x, y in zip(a.getLabelsMaskArrays(), b.getLabelsMaskArrays()):
                _same(x, y)
            assert b.numExamples() == 3
