"""The capture cache and its warm-start records (``runtime/aot.py``)
against the reference's ``tests/test_aot_cache.py`` (``TestKeys``,
``TestInvalidation``, ``TestBuckets``), on the CPU: the keys separate what
the reference's separate and join what they join; a version bump, a
corrupted or a truncated record is a counted miss, never a crash; the
bucket arithmetic equals the reference's. And what a CPU run can show of
the captured steps: the updaters read their hyperparameters from device
scalars bitwise as from host floats (every updater, every schedule); each
captured region reads no tensor on the host (MLN, CG, SameDiff,
``decode_paged``, ``rnnStepBatched``); an uncaptured dispatch is counted;
refusals name their reason; ``precompile`` of every entry point and the
``RetraceSentinel`` counter. No card: every network is on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.runtime import aot as ref_aot
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn import schedules as S
from deeplearning4j_tpu_torch.runtime import aot

torch.set_num_threads(1)

CPU = "cpu"


def _mln(seed=7, lr=0.1, nout=16, dtype=None, updater=None, drop=None):
    b = (P.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater if updater is not None else P.Nesterovs(lr, 0.9)))
    if dtype is not None:
        b = b.dataType(dtype)
    dense = P.DenseLayer(nOut=nout, activation="relu", dropOut=drop) \
        if drop else P.DenseLayer(nOut=nout, activation="relu")
    conf = (b.list().layer(dense)
            .layer(P.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.feedForward(8)).build())
    return P.MultiLayerNetwork(conf, device=CPU).init()


def _graph(seed=3):
    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Nesterovs(0.1, 0.9)).graphBuilder()
            .addInputs("in")
            .addLayer("d", P.DenseLayer(nOut=16, activation="relu"), "in")
            .addLayer("out", P.OutputLayer(nOut=4, activation="softmax",
                                           lossFunction="mcxent"), "d")
            .setOutputs("out")
            .setInputTypes(P.InputType.feedForward(8)).build())
    return P.ComputationGraph(conf, device=CPU).init()


def _samediff():
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        SameDiff, TrainingConfig,
    )

    sd = SameDiff.create(device=CPU)
    x = sd.placeHolder("x", torch.float64, 8, 5)
    y = sd.placeHolder("y", torch.float64, 8, 1)
    w = sd.var("w", np.zeros((5, 1)))
    sd.loss.meanSquaredError(y, sd.nn.linear(x, w, name="p"), name="l")
    sd.setTrainingConfig(TrainingConfig.Builder()
                         .updater(U.Adam(learningRate=0.05))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd


def _batch(n=8):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype("float32")
    y = np.eye(4, dtype="float32")[rng.randint(0, 4, n)]
    return x, y


def _params(net):
    return [t.detach().clone() for d in (net._params if isinstance(
        net._params, list) else net._params.values()) for t in d.values()]


@pytest.fixture
def fresh_cache(tmp_path):
    """A disk-backed session cache for the test (the previous one is put
    back after)."""
    prev = aot._SESSION
    cache = aot.enable(str(tmp_path / "records"))
    yield cache
    aot._SESSION = prev


# ----------------------------------------------------------------------
# keys (reference: TestKeys)
# ----------------------------------------------------------------------

class TestKeys:
    def test_equal_config_equal_key_different_config_miss(self,
                                                          fresh_cache):
        r1 = _mln(seed=7, lr=0.1).precompile(batchSize=8)
        r2 = _mln(seed=7, lr=0.1).precompile(batchSize=8)
        r3 = _mln(seed=7, lr=0.05).precompile(batchSize=8)
        assert r1["train_step"]["key"] == r2["train_step"]["key"]
        assert r2["train_step"]["status"] == "warm"
        assert r3["train_step"]["key"] != r1["train_step"]["key"]
        assert r3["train_step"]["status"] == "cold"

    def test_dtype_policy_change_misses(self, fresh_cache):
        k32 = _mln(dtype=P.DataType.FLOAT).precompile(
            batchSize=8)["train_step"]["key"]
        kbf = _mln(dtype=P.DataType.BFLOAT16).precompile(
            batchSize=8)["train_step"]["key"]
        assert k32 != kbf

    def test_tail_mode_toggle_misses(self, fresh_cache):
        from deeplearning4j_tpu_torch.nn import losses as _losses

        k_compute = _mln().precompile(batchSize=8)["train_step"]["key"]
        old = _losses._TAIL_MODE
        _losses._TAIL_MODE = "wide"
        try:
            k_wide = _mln().precompile(batchSize=8)["train_step"]["key"]
        finally:
            _losses._TAIL_MODE = old
        assert k_compute != k_wide

    def test_every_autotune_knob_separates_keys(self, fresh_cache):
        from deeplearning4j_tpu_torch.runtime import autotune as at

        base_key = _mln().precompile(batchSize=8)["train_step"]["key"]
        for knob in at.KNOBS:
            alt = next(c for c in knob.candidates if c != knob.get())
            with at.applied({knob.name: alt}):
                k = _mln().precompile(batchSize=8)["train_step"]["key"]
            assert k != base_key, knob.name

    def test_batch_signature_change_misses(self, fresh_cache):
        k8 = _mln().precompile(batchSize=8)["train_step"]["key"]
        k16 = _mln().precompile(batchSize=16)["train_step"]["key"]
        assert k8 != k16

    def test_ambient_names_torch_and_the_card_not_jax(self):
        amb = aot.ambient_fingerprint()
        assert amb["torch"] == torch.__version__
        assert amb["device"] == "cpu" and "jax" not in amb
        assert {"loss_tail", "bn_tail", "bn_epilogue", "maxpool_bwd",
                "global_maxpool_bwd", "flash_bwd"} <= set(amb)


# ----------------------------------------------------------------------
# records (reference: TestInvalidation) and the second process
# ----------------------------------------------------------------------

class TestInvalidation:
    def test_version_bump_invalidates_the_record(self, fresh_cache,
                                                  monkeypatch):
        key = _mln().precompile(batchSize=8)["train_step"]["key"]
        assert key in fresh_cache
        fresh_cache.clear_memory()
        monkeypatch.setattr(aot, "_package_version", lambda: "999.0")
        assert fresh_cache.get(key) is None
        assert fresh_cache.stats["stale"] == 1
        assert key not in fresh_cache

    def test_corrupted_record_is_a_miss_and_recaptures(self, fresh_cache):
        key = _mln().precompile(batchSize=8)["train_step"]["key"]
        with open(fresh_cache._path(key), "wb") as fh:
            fh.write(b"not json")
        fresh_cache.clear_memory()
        assert fresh_cache.get(key) is None
        assert fresh_cache.stats["corrupt"] == 1
        rep = _mln().precompile(batchSize=8)
        assert rep["train_step"]["status"] == "cold"
        x, y = _batch()
        _mln().fit(x, y)

    def test_truncated_record_is_corrupt_not_crash(self, fresh_cache):
        key = _mln().precompile(batchSize=8)["train_step"]["key"]
        path = fresh_cache._path(key)
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[: len(data) // 2])
        fresh_cache.clear_memory()
        assert fresh_cache.get(key) is None
        assert fresh_cache.stats["corrupt"] >= 1

    def test_a_record_holds_what_a_second_process_captures(self,
                                                           fresh_cache):
        key = _mln().precompile(batchSize=16)["train_step"]["key"]
        rec = json.load(open(fresh_cache._path(key)))
        assert rec["signature"][0] == {"shape": [16, 8], "dtype": "float32"}
        assert rec["buckets"] == [16] and rec["capture_seconds"] >= 0
        assert set(rec["knobs"]) >= {"maxpool_bwd", "bn_tail"}
        # the second process: the memory level gone, the directory read
        second = aot.ExecutableCache(fresh_cache.directory)
        net = _mln()
        rep = net.precompile(batchSize=8, cache=second)
        assert rep["train_step"]["status"] == "cold"
        assert any(v["key"] == key and v["status"] == "warm"
                   for v in rep.values())
        x, y = _batch(16)
        with aot.CompileWatch(second) as w:
            net.fit(x, y)
        w.assert_no_compiles("the recorded signature")


# ----------------------------------------------------------------------
# buckets (reference: TestBuckets)
# ----------------------------------------------------------------------

class TestBuckets:
    def test_bucket_batch_and_budget_equal_the_references(self):
        for n in range(1, 3000, 7):
            assert aot.bucket_batch(n) == ref_aot.bucket_batch(n)
            assert aot.bucket_batch(n, (1, 8, 64)) \
                == ref_aot.bucket_batch(n, (1, 8, 64))
        with pytest.raises(ValueError):
            aot.bucket_batch(0)
        for b, e in (((1, 8, 64), 1), ((1, 8, 64), 2), (None, 3)):
            args = (aot.DEFAULT_BATCH_BUCKETS if b is None else b, e)
            assert aot.sentinel_budget(*args) \
                == ref_aot.sentinel_budget(*args)
        assert aot.DEFAULT_BATCH_BUCKETS == ref_aot.DEFAULT_BATCH_BUCKETS

    def test_pad_batch_equals_the_references(self):
        a = np.arange(30, dtype=np.float32).reshape(3, 10)
        for bucket in (3, 4, 8):
            np.testing.assert_array_equal(aot.pad_batch(a, bucket),
                                          ref_aot.pad_batch(a, bucket))
        with pytest.raises(ValueError):
            aot.pad_batch(a, 2)

    def test_parallel_inference_takes_them_from_aot(self):
        from deeplearning4j_tpu_torch.parallel import inference as pi

        assert pi.bucket_batch is aot.bucket_batch
        assert pi.pad_batch is aot.pad_batch

    def test_parallel_inference_one_capture_per_bucket(self, fresh_cache):
        from deeplearning4j_tpu_torch.parallel.inference import \
            ParallelInference

        net = _mln()
        plain = ParallelInference(_mln(), batchBuckets=(8, 16))
        pi = ParallelInference(net, batchBuckets=(8, 16))
        assert set(pi.precompile()) == {8, 16}
        with aot.CompileWatch(fresh_cache) as w:
            for b in (3, 5, 8, 9, 12):
                x = np.random.RandomState(b).rand(b, 8).astype(np.float32)
                np.testing.assert_array_equal(pi.output(x).toNumpy(),
                                              plain.output(x).toNumpy())
        w.assert_no_compiles("served buckets")
        assert pi.cold_dispatches == 0


# ----------------------------------------------------------------------
# hyperparameters as device scalars
# ----------------------------------------------------------------------

_UPDATERS = {
    "Sgd": lambda: U.Sgd(0.1), "Nesterovs": lambda: U.Nesterovs(0.1, 0.9),
    "Adam": lambda: U.Adam(0.01), "AdamW": lambda: U.AdamW(0.01),
    "AdaMax": lambda: U.AdaMax(0.01), "Nadam": lambda: U.Nadam(0.01),
    "AMSGrad": lambda: U.AMSGrad(0.01), "AdaGrad": lambda: U.AdaGrad(0.1),
    "AdaDelta": lambda: U.AdaDelta(), "RmsProp": lambda: U.RmsProp(0.01),
    "NoOp": lambda: U.NoOp(),
}
_SCHEDULES = {
    "Step": lambda: S.StepSchedule("ITERATION", 0.05, 0.5, 2),
    "Exponential": lambda: S.ExponentialSchedule("ITERATION", 0.05, 0.9),
    "Inverse": lambda: S.InverseSchedule("ITERATION", 0.05, 0.1, 2.0),
    "Poly": lambda: S.PolySchedule("ITERATION", 0.05, 2.0, 10),
    "Sigmoid": lambda: S.SigmoidSchedule("ITERATION", 0.05, 0.5, 3),
    "Map": lambda: S.MapSchedule("ITERATION", {0: 0.05, 2: 0.01, 4: 0.1}),
    "Cycle": lambda: S.CycleSchedule("ITERATION", 0.01, 0.1, 6),
}


def _five_steps(make, captured, dtype=None):
    net = _mln(updater=make(), dtype=dtype)
    if captured:
        net.precompile(batchSize=8)
    x, y = _batch()
    losses = []
    for _ in range(5):
        net.fit(x, y)
        losses.append(net._score)
    return losses, _params(net)


def _bitwise(a, b):
    assert a[0] == b[0]
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_device_scalars_are_bitwise_the_host_floats(name):
    make = _UPDATERS[name]
    _bitwise(_five_steps(make, False), _five_steps(make, True))


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
@pytest.mark.parametrize("updater", ["Adam", "Nesterovs"])
def test_every_schedule_through_device_scalars(name, updater):
    def make():
        sched = _SCHEDULES[name]()
        return U.Adam(sched) if updater == "Adam" \
            else U.Nesterovs(sched, 0.9)

    _bitwise(_five_steps(make, False), _five_steps(make, True))


def test_device_scalars_in_double():
    make = _UPDATERS["Nadam"]
    _bitwise(_five_steps(make, False, P.DataType.DOUBLE),
             _five_steps(make, True, P.DataType.DOUBLE))


def test_hyper_scalars_hold_a_divisors_reciprocal_only_on_the_card():
    h = U.HyperScalars([U.Nadam(0.01)], torch.float32, "cpu")
    lr, c1, c2 = U.Nadam(0.01).scalars(3)
    assert h.values(3) == [lr, c1, c2]
    h.write(3)
    assert torch.equal(h.buffer, torch.tensor([lr, c1, c2],
                                              dtype=torch.float32))
    h._cuda = True     # the card's form, computed on the host
    got = h.values(3)
    assert got[1] == np.float32(1.0) / np.float32(c1)


# ----------------------------------------------------------------------
# the captured regions read nothing on the host
# ----------------------------------------------------------------------

def test_host_read_guard_refuses_item_and_allows_device_work():
    t = torch.ones(3)
    with aot.HostReadGuard("probe"):
        (t * 2).sum()
    with pytest.raises(aot.HostReadError, match="read on the host"):
        with aot.HostReadGuard("probe"):
            float(t.sum())


def _guarded(fn, *args, **kw):
    with aot.HostReadGuard("test region"):
        return fn(*args, **kw)


@pytest.mark.parametrize("what", ["mln", "cg", "samediff", "decode_paged",
                                  "rnnStepBatched", "dropout_mln"])
def test_each_captured_region_reads_nothing_on_the_host(what):
    x, y = _batch()
    if what in ("mln", "dropout_mln"):
        net = _mln(drop=0.5 if what == "dropout_mln" else None)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        _guarded(net._train_step, xt, yt, None, None, iteration=0,
                 hyper=net._hyper_scalars())
    elif what == "cg":
        net = _graph()
        _guarded(net._train_step, {"in": torch.from_numpy(x)},
                 [torch.from_numpy(y)], None, None, iteration=0,
                 hyper=net._hyper_scalars())
    elif what == "samediff":
        sd = _samediff()
        X = np.random.RandomState(1).rand(8, 5)
        phs = sd._batch_to_placeholders((X, X @ np.ones((5, 1))), sd._tc)
        tc, names, params, state = sd._fit_setup()
        _guarded(sd._step, tc, names, params, state, phs, 0,
                 hyper=sd._hyper_scalars())
    elif what == "decode_paged":
        from deeplearning4j_tpu_torch.nn.transformer import \
            CausalTransformerLM
        from deeplearning4j_tpu_torch.serving import (
            ManualClock, PagedSequenceScheduler,
        )

        lm = CausalTransformerLM(vocab=31, d_model=32, n_heads=2,
                                 n_layers=2, max_context=64, page_size=8,
                                 device=CPU)
        s = PagedSequenceScheduler(lm, num_pages=17, slot_buckets=(2,),
                                   clock=ManualClock(), start_thread=False)
        _, _, _, host, dev = s._staging_for(2)
        dev.copy_(host)
        _guarded(s._device_step, dev)
        s.close()
    else:
        from deeplearning4j_tpu_torch.serving import (
            ManualClock, SequenceScheduler,
        )

        conf = (P.NeuralNetConfiguration.Builder().seed(1).list()
                .layer(P.LSTM(nOut=8))
                .layer(P.RnnOutputLayer(nOut=5, activation="softmax",
                                        lossFunction="mcxent"))
                .setInputType(P.InputType.recurrent(5)).build())
        net = P.MultiLayerNetwork(conf, device=CPU).init()
        s = SequenceScheduler(net, slot_buckets=(4,), clock=ManualClock(),
                              start_thread=False)
        xh, ih, xd, idx = s._staging_for(4)
        s._stage_slots(ih, [0, 2])
        _guarded(s._device_step, xd, idx)
        s.close()


# ----------------------------------------------------------------------
# dispatch, counts and refusals
# ----------------------------------------------------------------------

class TestDispatch:
    def test_uncaptured_signature_is_counted_and_right(self, fresh_cache):
        net, ref = _mln(), _mln()
        net.precompile(batchSize=8)
        x, y = _batch(4)
        with aot.CompileWatch(fresh_cache) as w:
            net.fit(x, y)
        ref.fit(x, y)
        assert w.uncaptured == 1 and w.captures == 0
        with pytest.raises(RuntimeError, match="uncaptured"):
            w.assert_no_compiles()
        assert net._score == ref._score

    def test_rebound_params_run_eagerly_counted(self, fresh_cache):
        net = _mln()
        net.precompile(batchSize=8)
        x, y = _batch()
        net.init()
        net.fit(x, y)
        assert net._captured.uncaptured == 1

    def test_precompiled_fit_fitsteps_fitdataset_are_the_eager_ones(self):
        from deeplearning4j_tpu_torch.data import DataSetIterator

        rng = np.random.RandomState(2)
        xs = rng.randn(32, 8).astype("float32")
        ys = np.eye(4, dtype="float32")[rng.randint(0, 4, 32)]

        def run(pre):
            net = _mln(updater=U.Adam(0.01), drop=0.7)
            if pre:
                net.precompile(batchSize=8, stepsPerSync=2)
            net.fitDataSet(DataSetIterator(xs, ys, 8), stepsPerSync=2)
            net.fitSteps(xs[:8], ys[:8], numSteps=3)
            return [net._score], _params(net)

        _bitwise(run(False), run(True))

    def test_graph_and_samediff_precompile_bitwise(self):
        x, y = _batch()

        def graph(pre):
            g = _graph()
            if pre:
                assert g.precompile(batchSize=8)["train_step"]["status"] \
                    in ("cold", "warm")
            for _ in range(3):
                g.fit(x, y)
            return [g._score], _params(g)

        _bitwise(graph(False), graph(True))
        X = np.random.RandomState(1).rand(8, 5)
        Y = X @ np.ones((5, 1))

        def samediff(pre):
            sd = _samediff()
            if pre:
                sd.precompile(features=X, labels=Y)
            h = sd.fit(features=X, labels=Y, epochs=3)
            return h, [sd._arrays["w"].clone()]

        _bitwise(samediff(False), samediff(True))

    def test_parallel_wrapper_world_one_precompile_bitwise(self):
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper

        x, y = _batch()

        def run(pre):
            net = _mln(updater=U.Adam(0.01))
            pw = ParallelWrapper(net)
            if pre:
                rep = pw.precompile(batchSize=8)
                assert rep["pw_train_step"]["status"] in ("cold", "warm")
            for _ in range(3):
                pw.fit(x, y)
            return [net._score], _params(net)

        _bitwise(run(False), run(True))

    def test_train_step_signature_of_the_wrapper(self):
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper

        net = _mln()
        pw = ParallelWrapper(net)
        step = pw.trainStep()
        x, y = _batch()
        out = step(net._params, net._upd_states, net._states, 0,
                   torch.from_numpy(x), torch.from_numpy(y))
        assert out[0] is net._params and np.isfinite(float(out[3]))
        with pytest.raises(ValueError, match="in place"):
            step([], net._upd_states, net._states, 0, x, y)

    def test_refusals_name_their_reason(self):
        from deeplearning4j_tpu_torch.nn.conf.builder import BackpropType

        tb = (P.NeuralNetConfiguration.Builder().seed(1).list()
              .backpropType(BackpropType.TruncatedBPTT).tBPTTLength(4)
              .layer(P.LSTM(nOut=4))
              .layer(P.RnnOutputLayer(nOut=3, activation="softmax",
                                      lossFunction="mcxent"))
              .setInputType(P.InputType.recurrent(5, 8)).build())
        net = P.MultiLayerNetwork(tb, device=CPU).init()
        with pytest.raises(aot.CaptureRefused, match="truncated BPTT"):
            net.precompile(batchSize=2)
        lb = (P.NeuralNetConfiguration.Builder().seed(1)
              .optimizationAlgo("LBFGS").list()
              .layer(P.DenseLayer(nOut=4))
              .layer(P.OutputLayer(nOut=3, activation="softmax",
                                   lossFunction="mcxent"))
              .setInputType(P.InputType.feedForward(5)).build())
        with pytest.raises(aot.CaptureRefused, match="line-search"):
            P.MultiLayerNetwork(lb, device=CPU).init().precompile(
                batchSize=2)

    def test_samediff_if_cond_refuses_and_counts(self, fresh_cache):
        from deeplearning4j_tpu_torch.autodiff.samediff import (
            SameDiff, TrainingConfig,
        )

        sd = SameDiff.create(device=CPU)
        x = sd.placeHolder("x", torch.float32, 4, 3)
        y = sd.placeHolder("y", torch.float32, 4, 1)
        w = sd.var("w", np.ones((3, 1), np.float32))
        p = sd.nn.linear(x, w, name="p")
        pred = sd.math.gt(sd.math.sum(p), sd.constant(0.0))
        out = sd.ifCond(pred, lambda s, a: a * 2.0, lambda s, a: a * 3.0,
                        inputs=[p])
        sd.loss.meanSquaredError(y, out, name="l")
        sd.setTrainingConfig(TrainingConfig.Builder().updater(U.Sgd(0.01))
                             .dataSetFeatureMapping("x")
                             .dataSetLabelMapping("y").build())
        X = np.random.RandomState(0).rand(4, 3).astype(np.float32)
        Y = np.ones((4, 1), np.float32)
        with pytest.raises(aot.CaptureRefused, match="predicate"):
            sd.precompile(features=X, labels=Y)
        before = fresh_cache.stats["uncaptured"]
        sd.fit(features=X, labels=Y, epochs=2)
        assert fresh_cache.stats["uncaptured"] == before + 2


    @pytest.mark.parametrize("change", ["rebind", "knob"])
    def test_parallel_inference_counts_what_cannot_replay(self, fresh_cache,
                                                          change):
        from deeplearning4j_tpu_torch.ops import pooling
        from deeplearning4j_tpu_torch.parallel.inference import \
            ParallelInference

        net = _mln()
        pi = ParallelInference(net, batchBuckets=(8,))
        pi.precompile()
        x, _ = _batch()
        prev = pooling._BACKWARD_IMPL
        try:
            if change == "rebind":
                net.init()           # a fresh draw of the same seed
            else:
                pooling.set_maxpool_bwd("indices")
            with aot.CompileWatch(fresh_cache) as w:
                out = [pi.output(x).toNumpy() for _ in range(2)]
        finally:
            pooling.set_maxpool_bwd(prev)
        assert w.uncaptured == 2 and w.captures == 0
        assert pi._capture.uncaptured == 2
        plain = ParallelInference(_mln(), batchBuckets=(8,)).output(x)
        for o in out:
            np.testing.assert_array_equal(o, plain.toNumpy())

    @pytest.mark.parametrize("holder", ["inference", "train"])
    def test_eager_fit_writes_into_the_states_a_graph_holds(self,
                                                            fresh_cache,
                                                            holder):
        from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves
        from deeplearning4j_tpu_torch.parallel.inference import \
            ParallelInference

        def bn_net():
            conf = (P.NeuralNetConfiguration.Builder().seed(11)
                    .updater(P.Nesterovs(0.1, 0.9)).list()
                    .layer(P.DenseLayer(nOut=16, activation="relu"))
                    .layer(P.BatchNormalization())
                    .layer(P.OutputLayer(nOut=4, activation="softmax",
                                         lossFunction="mcxent"))
                    .setInputType(P.InputType.feedForward(8)).build())
            return P.MultiLayerNetwork(conf, device=CPU).init()

        def states(n):
            return [t for t in tree_leaves(n._states)
                    if isinstance(t, torch.Tensor)]

        net, twin = bn_net(), bn_net()
        held = states(net)
        pi = ParallelInference(net, batchBuckets=(8,))
        if holder == "inference":
            pi.precompile()
        else:                        # the warm-up writes them in place too
            net.precompile(batchSize=8)
        x, y = _batch()
        for _ in range(2):
            net.fit(x, y)
            twin.fit(x, y)
        assert held and all(a is b for a, b in zip(held, states(net)))
        for a, b in zip(states(net), states(twin)):
            assert torch.equal(a, b)
        with aot.CompileWatch(fresh_cache) as w:
            out = pi.output(x).toNumpy()
        if holder == "inference":
            w.assert_no_compiles("a forward after an eager fit")
        plain = ParallelInference(twin, batchBuckets=(8,)).output(x)
        np.testing.assert_array_equal(out, plain.toNumpy())


def test_a_launch_under_capture_goes_to_the_capturing_threads_tally(
        monkeypatch):
    """Launches on the capturing stream go to the capture's tally, from
    any thread (autograd's runs the backward on the forward's stream);
    launches on another stream while it captures are counted at once."""
    import threading
    import types

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    capture_stream = types.SimpleNamespace(cuda_stream=0x1234)
    serve_stream = types.SimpleNamespace(cuda_stream=0x5678)
    on = threading.local()
    capturing = threading.Event()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: getattr(on, "stream", serve_stream))
    monkeypatch.setattr(
        torch.cuda, "is_current_stream_capturing",
        lambda: capturing.is_set()
        and torch.cuda.current_stream() is capture_stream)
    tpa.reset_launches()

    def launch(n, stream=None):
        if stream is not None:
            on.stream = stream
        for _ in range(n):
            _kernels.count_launch(tpa.paged_flash_decode)

    with _kernels.capture_tally(capture_stream) as tally:
        capturing.set()
        threads = [threading.Thread(target=launch, args=(1000,)),
                   threading.Thread(target=launch,
                                    args=(7, capture_stream))]
        for t in threads:
            t.start()
        launch(5, capture_stream)
        for t in threads:
            t.join()
        capturing.clear()
    assert tally == {"paged_flash_decode": 12}
    assert tpa.paged_flash_decode.launches == 1000
    _kernels.add_launches(tpa.paged_flash_decode, 12)   # one replay
    assert tpa.paged_flash_decode.launches == 1012
    tpa.reset_launches()


def test_aot_off_keeps_records_nowhere(tmp_path, monkeypatch):
    monkeypatch.setenv(aot.AOT_ENV, "off")
    monkeypatch.setenv(aot.CACHE_DIR_ENV, str(tmp_path))
    prev = aot._SESSION, aot._SESSION_INIT
    try:
        aot.disable()
        aot.enable(str(tmp_path))
        assert aot.session_cache() is None
        net = _mln()
        rep = net.precompile(batchSize=8)
        assert rep["train_step"]["status"] == "cold"
        assert net._captured.cache().directory is None
        assert os.listdir(tmp_path) == []
        x, y = _batch()
        net.fit(x, y)
        assert net._captured.replays == 1
    finally:
        aot._SESSION, aot._SESSION_INIT = prev


class TestRetraceSentinel:
    def test_counts_captures_and_raises_past_its_budget(self):
        from deeplearning4j_tpu_torch.analysis import (
            RetraceError, RetraceSentinel,
        )

        net = _mln()
        sent = RetraceSentinel(max_compiles=1).install(net)
        x, y = _batch()
        for _ in range(3):
            net.fit(x, y)
        assert sent.compiles("train_step") == 1
        with pytest.raises(RetraceError, match="2th time"):
            net.fit(*_batch(4))

    def test_wrap_counts_a_function_per_signature(self):
        from deeplearning4j_tpu_torch.analysis import RetraceSentinel

        sent = RetraceSentinel(max_compiles=2)
        f = sent.wrap(lambda a: a * 2, "double")
        for n in (3, 3, 4, 4):
            f(torch.ones(n))
        assert sent.compiles("double") == 2


def test_executioner_and_entry():
    from deeplearning4j_tpu_torch.entry import entry
    from deeplearning4j_tpu_torch.ndarray import (
        TorchExecutioner, XlaExecutioner,
    )

    assert XlaExecutioner is TorchExecutioner
    assert XlaExecutioner.instance().exec(lambda a: a + 1,
                                          torch.ones(2)).tolist() == [2, 2]
    fwd, (params, x) = entry(device=CPU, batch=2, image=32)
    out = fwd(params, x)
    assert out.shape == (2, 1000) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="params"):
        fwd({}, x)


def test_records_go_only_where_enable_says(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prev = aot._SESSION
    try:
        aot.disable()
        cache = aot.enable(False)
        _mln().precompile(batchSize=8)
        assert cache.directory is None and os.listdir(tmp_path) == []
    finally:
        aot._SESSION = prev
