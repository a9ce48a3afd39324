"""The port's native prefetch ring and async iterators against the
reference's (``deeplearning4j_tpu/runtime``): ``tests/test_runtime.py``
case by case, on both rings, plus the byte layout of ``pack_arrays``
(exact, both directions), the native build into ``_build/`` keyed by the
source's hash, and the stated deviation that a native ring which cannot
be built raises instead of quietly becoming the Python ring."""

import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.runtime as JR
from deeplearning4j_tpu.data import DataSetIterator as JDataSetIterator
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.runtime import (
    AsyncDataSetIterator, AsyncMultiDataSetIterator, NativeRingBuffer,
    PythonRingBuffer, make_ring, native_lib, pack_arrays, unpack_arrays,
    PF_CLOSED, PF_TIMEOUT, PF_TOO_BIG,
)
from deeplearning4j_tpu_torch.runtime import _native, ringbuffer

torch.set_num_threads(1)

_PACK_CASES = {
    "mixed": lambda: [np.arange(12, dtype=np.float32).reshape(3, 4), None,
                      np.array([[True, False]]),
                      np.arange(6, dtype=np.int64).reshape(1, 2, 3)],
    "empty": lambda: [np.zeros((0, 4), np.float32)],
    "all_dtypes": lambda: [np.arange(6).astype(d).reshape(2, 3) for d in
                           (np.float32, np.float64, np.int32, np.int64,
                            np.uint8, np.bool_, np.float16, np.int16,
                            np.int8, np.uint32, np.uint64)],
    "dataset_like": lambda: [
        np.random.RandomState(0).randn(8, 3, 5, 5).astype(np.float32),
        np.eye(4, dtype=np.float32)[np.arange(8) % 4], None,
        np.ones((8,), np.float32)],
    "noncontiguous": lambda: [np.arange(24, dtype=np.float32)
                              .reshape(4, 6)[:, ::2]],
}


@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_pack_bytes_equal_the_reference(case):
    arrs = _PACK_CASES[case]()
    got = pack_arrays(arrs)
    assert got == JR.pack_arrays(arrs)
    # each package unpacks the other's bytes to the same arrays
    for out in (unpack_arrays(JR.pack_arrays(arrs)), JR.unpack_arrays(got)):
        for a, b in zip(out, arrs):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ring_cls", [NativeRingBuffer, PythonRingBuffer])
class TestRingBuffer:
    def test_fifo_order_and_wrap(self, ring_cls):
        r = ring_cls(3, 1024)
        for round_ in range(3):  # force wrap-around
            for i in range(3):
                assert r.push(f"item-{round_}-{i}".encode()) == 0
            for i in range(3):
                assert r.pop() == f"item-{round_}-{i}".encode()

    def test_too_big_payload(self, ring_cls):
        r = ring_cls(3, 16)
        assert r.push(b"x" * 17) == PF_TOO_BIG

    def test_pop_timeout(self, ring_cls):
        assert ring_cls(3, 1024).pop(timeout_ms=30) == PF_TIMEOUT

    def test_backpressure_blocks_until_pop(self, ring_cls):
        r = ring_cls(2, 1024)
        assert r.push(b"a") == 0
        assert r.push(b"b") == 0
        done = threading.Event()

        def blocked_push():
            r.push(b"c")
            done.set()

        threading.Thread(target=blocked_push, daemon=True).start()
        time.sleep(0.05)
        assert not done.is_set()  # full -> producer blocked
        assert r.pop() == b"a"
        assert done.wait(2.0)
        assert r.pop() == b"b"
        assert r.pop() == b"c"

    def test_close_drains_then_reports_closed(self, ring_cls):
        r = ring_cls(3, 1024)
        r.push(b"left-over")
        r.close()
        assert r.pop() == b"left-over"
        assert r.pop(timeout_ms=100) == PF_CLOSED
        r.reopen()
        assert r.push(b"fresh") == 0
        assert r.pop() == b"fresh"

    def test_push_buffers_and_pop_into(self, ring_cls):
        """Any contiguous buffer pushes; pop_into fills a caller's buffer
        (a tensor, as the card's pinned buffers are)."""
        r = ring_cls(2, 64)
        payload = np.arange(10, dtype=np.float32)
        assert r.push(payload) == 0
        assert r.push(bytearray(b"xyz")) == 0
        out = torch.zeros(64, dtype=torch.uint8)
        n = r.pop_into(out)
        assert n == 40
        np.testing.assert_array_equal(out[:n].numpy().view(np.float32),
                                      payload)
        assert r.pop() == b"xyz"


def test_native_ring_is_the_default():
    assert isinstance(make_ring(2, 128), NativeRingBuffer)
    assert make_ring(2, 128).kind == "native"
    assert make_ring(2, 128, force_python=True).kind == "python"


def test_native_build_is_keyed_by_the_source_hash():
    native_lib()
    target = ringbuffer._loader.target()
    assert target.exists() and target.parent == _native.BUILD_DIR
    assert target.name.startswith("prefetch-") and target.suffix == ".so"


def test_no_compiler_raises_instead_of_a_python_ring():
    """Stated deviation: the reference's make_ring quietly takes the
    Python ring when its library cannot be built; the port raises, once
    recorded, with the reason."""
    loader = _native.NativeLoader("prefetch.cpp", ringbuffer._configure,
                                  compiler="no-such-compiler-x")
    loader.target = lambda: _native.BUILD_DIR / "never-built.so"
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no-such-compiler-x"):
            loader.lib()


def _data(n=50, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype("float32")
    Y = np.eye(3, dtype="float32")[rng.randint(0, 3, n)]
    return X, Y


def _iter(n=50, batch=8, seed=0):
    return DataSetIterator(*_data(n, seed), batch)


@pytest.mark.parametrize("force_python", [False, True])
class TestAsyncDataSetIterator:
    def test_matches_the_reference_async_iterator(self, force_python):
        X, Y = _data()
        ref = JR.AsyncDataSetIterator(JDataSetIterator(X, Y, 8), queueSize=3,
                                      forcePython=force_python)
        ait = AsyncDataSetIterator(_iter(), queueSize=3,
                                   forcePython=force_python, device="cpu")
        n = 0
        while ref.hasNext():
            assert ait.hasNext()
            a, b = ref.next(), ait.next()
            np.testing.assert_array_equal(a.getFeatures().toNumpy(),
                                          b.getFeatures())
            np.testing.assert_array_equal(a.getLabels().toNumpy(),
                                          b.getLabels())
            am, bm = a.getLabelsMaskArray(), b.getLabelsMaskArray()
            assert (am is None) == (bm is None)
            if am is not None:
                np.testing.assert_array_equal(am.toNumpy(), bm)
            n += 1
        assert not ait.hasNext()
        assert n == 7  # 50/8 -> 6 full + 1 padded batch

    def test_reset_for_multiple_epochs(self, force_python):
        ait = AsyncDataSetIterator(_iter(), queueSize=2,
                                   forcePython=force_python, device="cpu")
        for _ in range(3):
            ait.reset()
            count = 0
            while ait.hasNext():
                ait.next()
                count += 1
            assert count == 7

    def test_masks_survive(self, force_python):
        n, batch = 12, 4
        fm = (np.random.RandomState(1).rand(n, 5) > 0.3).astype("float32")

        class Masked:
            def __init__(self):
                self.it = _iter(n, batch)
                self.i = 0

            def reset(self):
                self.it.reset()
                self.i = 0

            def hasNext(self):
                return self.it.hasNext()

            def next(self):
                ds = self.it.next()
                sl = slice(self.i * batch, (self.i + 1) * batch)
                self.i += 1
                return DataSet(ds.getFeatures(), ds.getLabels(), fm[sl],
                               None)

        ait = AsyncDataSetIterator(Masked(), forcePython=force_python,
                                   device="cpu")
        got = []
        while ait.hasNext():
            got.append(ait.next().getFeaturesMaskArray())
        np.testing.assert_array_equal(np.concatenate(got), fm)

    def test_producer_exception_propagates(self, force_python):
        class Exploding:
            def __init__(self):
                self.n = 0

            def reset(self):
                self.n = 0

            def hasNext(self):
                return True

            def next(self):
                self.n += 1
                if self.n > 2:
                    raise RuntimeError("ETL failed")
                return DataSet(np.zeros((4, 2), np.float32),
                               np.zeros((4, 2), np.float32))

        ait = AsyncDataSetIterator(Exploding(), forcePython=force_python,
                                   device="cpu")
        with pytest.raises(RuntimeError, match="ETL failed"):
            while ait.hasNext():
                ait.next()

    def test_fit_through_async_is_fit_through_the_base(self, force_python):
        """Prefetch changes when the data arrives, never what it is: the
        losses and weights of fit(async) equal fit(iterator)'s bitwise."""
        from deeplearning4j_tpu_torch.nn import (
            Adam, DenseLayer, MultiLayerNetwork, NeuralNetConfiguration,
            OutputLayer,
        )

        def net():
            conf = (NeuralNetConfiguration.Builder()
                    .seed(3).updater(Adam(1e-2)).list()
                    .layer(DenseLayer(nIn=6, nOut=16, activation="tanh"))
                    .layer(OutputLayer(nOut=3, activation="softmax",
                                       lossFunction="MCXENT"))
                    .build())
            return MultiLayerNetwork(conf, device="cpu").init()

        a, b = net(), net()
        ait = AsyncDataSetIterator(_iter(), forcePython=force_python,
                                   device="cpu")
        scores = []
        for _ in range(3):
            a.fit(_iter())
            b.fit(ait)
            scores.append((a.score(), b.score()))
        assert all(x == y for x, y in scores)
        for pa, pb in zip(a._params, b._params):
            for k in pa:
                assert torch.equal(pa[k], pb[k])
        b2 = net()
        b2.fitDataSet(AsyncDataSetIterator(_iter(), device="cpu",
                                           forcePython=force_python),
                      stepsPerSync=3)
        a2 = net()
        a2.fit(_iter())
        for pa, pb in zip(a2._params, b2._params):
            for k in pa:
                assert torch.equal(pa[k], pb[k])


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fails_loudly():
    """A producer that ends without its sentinel or an error (killed, not
    raising an Exception) fails the consumer's next call."""
    class Dying:
        def __init__(self):
            self.n = 0

        def reset(self):
            self.n = 0

        def hasNext(self):
            return True

        def next(self):
            self.n += 1
            if self.n > 1:
                raise SystemExit   # ends the thread, past `except Exception`
            return DataSet(np.zeros((4, 2), np.float32),
                           np.zeros((4, 2), np.float32))

    ait = AsyncDataSetIterator(Dying(), device="cpu")
    assert ait.hasNext()
    ait.next()
    with pytest.raises(RuntimeError, match="died without"):
        ait.hasNext()


def _mds_iter(masks):
    from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet

    class MDSIter:
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def hasNext(self):
            return self.i < 3

        def next(self):
            self.i += 1
            rng = np.random.RandomState(self.i)
            if not masks:
                return MultiDataSet(
                    [rng.rand(4, 3).astype("f4"), rng.rand(4, 2).astype("f4")],
                    [rng.rand(4, 1).astype("f4")])
            return MultiDataSet(
                [rng.rand(4, 2, 5).astype("f4")],
                [rng.rand(4, 1, 5).astype("f4")],
                [(rng.rand(4, 5) > 0.5).astype("f4")],
                [(rng.rand(4, 5) > 0.5).astype("f4")])

    return MDSIter()


@pytest.mark.parametrize("masks", [False, True])
def test_async_multi_roundtrip(masks):
    ait = AsyncMultiDataSetIterator(_mds_iter(masks), device="cpu")
    want = _mds_iter(masks)
    n = 0
    while ait.hasNext():
        got, exp = ait.next(), want.next()
        for a, b in zip(got.getFeatures() + got.getLabels(),
                        exp.getFeatures() + exp.getLabels()):
            np.testing.assert_array_equal(a, b)
        if masks:
            np.testing.assert_array_equal(got.getFeaturesMaskArrays()[0],
                                          exp.getFeaturesMaskArrays()[0])
            np.testing.assert_array_equal(got.getLabelsMaskArrays()[0],
                                          exp.getLabelsMaskArrays()[0])
        else:
            assert got.getFeaturesMaskArrays() is None
        n += 1
    assert n == 3


def test_entry_points_take_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncDataSetIterator(_iter())
