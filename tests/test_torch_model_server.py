"""The port's one-shot serving tier (deeplearning4j_tpu_torch/serving/
queue.py ``MicroBatcher``, parallel/inference.py ``ParallelInference``,
serving/host.py ``register``/``swap``/``submit``, serving/server.py
``:predict``, serving/loadgen.py): the reference's
tests/test_model_server.py case by case on the CPU, plus parity with the
reference's own BATCHED ``ParallelInference`` on carried weights.

Where the reference counts XLA compiles (CompileWatch, RetraceSentinel),
the port counts COLD DISPATCHES: forwards at a padded batch that no warm
ran (``ParallelInference.cold_dispatches``), and the warm report's
"cold"/"warm" status per bucket. Wall-clock gates (the reference's >= 3x
serial) become counts here: requests, dispatches, rows, occupancy; the
ratio is measured on the card (chip_smoke.py phase 18).

Parity with the reference (f32, the same seeded numpy requests): the
port's coalesced answers within rtol 1e-5 / atol 1e-6 of the reference's
coalesced answers; int8 top-1 equal to the reference's int8 top-1 and to
the port's f32 top-1.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.parallel.inference import \
    ParallelInference as RefParallelInference
from deeplearning4j_tpu.serving import ModelHost as RefModelHost
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.parallel.inference import (
    DEFAULT_BATCH_BUCKETS, WarmSignatures,
)
from deeplearning4j_tpu_torch.serving import (
    DeadlineExceededError, InferenceServer, ManualClock, MicroBatcher,
    ModelHost, QueueFullError, ServingClosedError, loadgen,
)

from _torch_parity import pair

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


# ----------------------------------------------------------------------
# subjects
# ----------------------------------------------------------------------

def _conf(M, seed=7, nout=16):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Nesterovs(0.1, 0.9)).list()
            .layer(M.DenseLayer(nOut=nout, activation="relu"))
            .layer(M.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.feedForward(8)).build())


def _graph_conf(M, seed=3):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Nesterovs(0.1, 0.9)).graphBuilder()
            .addInputs("in")
            .addLayer("d", M.DenseLayer(nOut=16, activation="relu"), "in")
            .addLayer("out", M.OutputLayer(nOut=4, activation="softmax",
                                           lossFunction="mcxent"), "d")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(8)).build())


def _mln(seed=7, nout=16):
    return P.MultiLayerNetwork(_conf(P, seed, nout), device="cpu").init()


def _scaled(net, factor):
    """`net` with every parameter multiplied by `factor` (a second
    version of the same shape)."""
    with torch.no_grad():
        for p in net._params:
            for t in p.values():
                t.mul_(factor)
    return net


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def _post(url, obj, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def _wait_ready(port, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            _get(f"http://127.0.0.1:{port}/healthz", timeout=5)
            return
        except urllib.error.HTTPError:
            time.sleep(0.02)
    pytest.fail("server never became ready")


def _until(cond, timeout=10):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


# ----------------------------------------------------------------------
# micro-batcher scheduler: deterministic (ManualClock, no thread)
# ----------------------------------------------------------------------

class TestMicroBatcherDeterministic:
    def _batcher(self, dispatch=None, **kw):
        kw.setdefault("max_rows", 8)
        kw.setdefault("queue_limit", 4)
        kw.setdefault("max_wait", 0.005)
        clk = kw.pop("clock", None) or ManualClock()
        mb = MicroBatcher(dispatch or (lambda f: f * 2.0),
                          clock=clk, start_thread=False, **kw)
        return mb, clk

    def test_coalesce_slice_and_occupancy(self):
        shapes = []
        mb, clk = self._batcher(
            lambda f: (shapes.append(f.shape), f * 2.0)[1])
        r1 = mb.submit(_rows(3, 1), wait=False)
        r2 = mb.submit(_rows(2, 2), wait=False)
        clk.advance(0.006)
        assert mb.poll() is None
        assert r1.done and r2.done
        np.testing.assert_array_equal(r1.result, _rows(3, 1) * 2.0)
        np.testing.assert_array_equal(r2.result, _rows(2, 2) * 2.0)
        assert shapes == [(5, 8)]          # ONE coalesced dispatch
        assert mb.stats["dispatches"] == 1 and mb.stats["coalesced"] == 2
        assert mb.occupancy == [(5, 5)]

    def test_max_wait_holds_partial_batches(self):
        mb, clk = self._batcher()
        r = mb.submit(_rows(1), wait=False)
        assert mb.poll() == pytest.approx(0.005)
        clk.advance(0.003)
        assert mb.poll() == pytest.approx(0.002) and not r.done
        clk.advance(0.0021)
        mb.poll()
        assert r.done

    def test_full_bucket_dispatches_without_waiting(self):
        mb, clk = self._batcher()
        r = mb.submit(_rows(8), wait=False)
        assert mb.poll() is None and r.done

    def test_fifo_prefix_respects_max_rows(self):
        mb, clk = self._batcher(queue_limit=8)
        rs = [mb.submit(_rows(3, i), wait=False) for i in range(3)]
        clk.advance(0.006)
        mb.poll()
        assert mb.stats["dispatches"] == 2
        assert mb.occupancy[0][0] == 6 and mb.occupancy[1][0] == 3
        assert all(r.done for r in rs)

    def test_oversized_request_dispatches_alone(self):
        mb, clk = self._batcher()
        small = mb.submit(_rows(2), wait=False)
        big = mb.submit(_rows(11), wait=False)
        clk.advance(0.006)
        mb.poll()
        assert small.done and big.done
        assert [r for r, _ in mb.occupancy] == [2, 11]

    def test_request_deadline_expires_instead_of_dispatching(self):
        mb, clk = self._batcher()
        doomed = mb.submit(_rows(2), deadline=clk() + 0.001, wait=False)
        alive = mb.submit(_rows(1), wait=False)
        clk.advance(0.006)
        mb.poll()
        assert isinstance(doomed.error, DeadlineExceededError)
        with pytest.raises(DeadlineExceededError):
            doomed.wait(0)
        assert alive.done and alive.error is None
        assert mb.stats["expired"] == 1
        assert mb.stats["dispatched_rows"] == 1

    def test_queue_full_raises_not_hangs(self):
        mb, _ = self._batcher()
        for i in range(4):
            mb.submit(_rows(1, i), wait=False)
        t0 = time.perf_counter()
        with pytest.raises(QueueFullError, match="queueLimit=4"):
            mb.submit(_rows(1, 9), wait=False)
        assert time.perf_counter() - t0 < 1.0
        assert mb.stats["rejected"] == 1

    def test_submit_contract_validation(self):
        mb, _ = self._batcher(trailing_shape=(8,),
                              feature_dtype=np.float32)
        with pytest.raises(ValueError, match="does not match"):
            mb.submit(np.zeros((2, 7), np.float32), wait=False)
        with pytest.raises(ValueError, match="rows >= 1"):
            mb.submit(np.zeros((0, 8), np.float32), wait=False)
        r = mb.submit(np.zeros((2, 8), np.float64), wait=False)
        assert r.features.dtype == np.float32

    def test_dispatch_failure_fails_whole_batch(self):
        def boom(f):
            raise RuntimeError("device on fire")

        mb, clk = self._batcher(boom)
        r1 = mb.submit(_rows(1, 1), wait=False)
        r2 = mb.submit(_rows(1, 2), wait=False)
        clk.advance(0.006)
        mb.poll()
        for r in (r1, r2):
            with pytest.raises(RuntimeError, match="device on fire"):
                r.wait(0)
        assert mb.stats["errors"] == 2

    def test_close_drain_false_fails_pending_and_rejects(self):
        mb, _ = self._batcher()
        r = mb.submit(_rows(1), wait=False)
        mb.close(drain=False)
        assert isinstance(r.error, ServingClosedError)
        with pytest.raises(ServingClosedError):
            mb.submit(_rows(1), wait=False)

    def test_flush_ignores_max_wait(self):
        mb, _ = self._batcher()
        r = mb.submit(_rows(2), wait=False)
        mb.flush()
        assert r.done

    def test_close_drain_true_completes_queued(self):
        mb, _ = self._batcher()
        rs = [mb.submit(_rows(2, i), wait=False) for i in range(3)]
        mb.close(drain=True)
        assert all(r.done and r.error is None for r in rs)
        assert mb.stats["dispatches"] == 1

    def test_cancelled_request_wastes_no_rows(self):
        mb, clk = self._batcher()
        a = mb.submit(_rows(3), wait=False)
        b = mb.submit(_rows(2), wait=False)
        assert b.cancel() and not b.cancel()
        clk.advance(0.006)
        mb.poll()
        assert a.done and a.error is None
        assert mb.occupancy == [(3, 3)]

    def test_instruments_read_through_and_detach_on_close(self):
        from deeplearning4j_tpu_torch.runtime import telemetry

        mb, clk = self._batcher(name="mb-instruments")
        mb.submit(_rows(3), wait=False)
        clk.advance(0.006)
        mb.poll()
        reg = telemetry.get_registry()
        fam = reg.get("dl4j_serving_dispatched_rows_total")
        assert fam.labels_get(model="mb-instruments").value == 3
        assert "dl4j_serving_batch_occupancy" in reg.prometheus()
        spans = [s["name"] for s in reg.trace.spans()
                 if s["args"].get("model") == "mb-instruments"]
        assert spans == ["serving.coalesce", "serving.dispatch",
                         "serving.reply"]
        mb.close()
        assert fam.labels_get(model="mb-instruments") is None
        assert mb.stats["dispatched_rows"] == 3


# ----------------------------------------------------------------------
# load generator
# ----------------------------------------------------------------------

class TestLoadGen:
    def test_arrival_offsets_seeded_and_poissonian(self):
        a = loadgen.arrival_offsets(100.0, 2000, seed=3)
        b = loadgen.arrival_offsets(100.0, 2000, seed=3)
        np.testing.assert_array_equal(a, b)
        gaps = np.diff(np.concatenate([[0.0], a]))
        assert abs(gaps.mean() - 0.01) < 0.002
        assert (gaps >= 0).all()
        with pytest.raises(ValueError):
            loadgen.arrival_offsets(0, 5)

    def test_arrival_offsets_equal_the_reference(self):
        from deeplearning4j_tpu.serving import loadgen as ref

        np.testing.assert_array_equal(
            loadgen.arrival_offsets(250.0, 64, seed=9),
            ref.arrival_offsets(250.0, 64, seed=9))

    def test_summarize_percentiles(self):
        lat = [i / 1000.0 for i in range(1, 101)]
        rec = loadgen.summarize(lat, duration_s=2.0)
        assert rec["requests_per_sec"] == 50.0
        assert rec["p50_ms"] == pytest.approx(50.5, abs=0.5)
        assert rec["p99_ms"] == pytest.approx(99.01, abs=0.5)
        assert rec["max_ms"] == 100.0

    def test_percentile_is_numpys_linear(self):
        v = np.random.RandomState(0).rand(37)
        for q in (0, 1, 50, 95, 99, 100):
            assert loadgen.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)), rel=1e-12)

    def test_open_loop_counts_errors_by_type(self):
        def submit(x):
            if int(x[0, 0]) % 3 == 0:
                raise QueueFullError("full")

        rec = loadgen.run_open_loop(
            submit, lambda i: np.full((1, 1), i, np.float32),
            rate=5000.0, n_requests=30, seed=0, max_clients=4)
        assert rec["errors"] == {"QueueFullError": 10}
        assert rec["completed"] == 20 and rec["requests"] == 30

    def test_occupancy_summary_math(self):
        mb = MicroBatcher(lambda f: f, max_rows=16, start_thread=False)
        mb.occupancy = [(4, 16), (16, 16), (9, 16)]
        s = mb.occupancy_summary()
        assert s["dispatches"] == 3
        assert s["mean_occupancy"] == pytest.approx(
            (0.25 + 1 + 0.5625) / 3, abs=1e-4)
        assert s["histogram"] == {"0-25%": 1, "25-50%": 0, "50-75%": 1,
                                  "75-100%": 1}


# ----------------------------------------------------------------------
# ParallelInference modes
# ----------------------------------------------------------------------

class TestInferenceModes:
    def test_unknown_mode_rejected_loudly(self):
        net = _mln()
        with pytest.raises(ValueError, match="unknown inferenceMode"):
            ParallelInference(net, inferenceMode="TURBO")
        with pytest.raises(ValueError, match="BATCHED"):
            (ParallelInference.Builder(net).workers(1)
             .inferenceMode("nope").build())
        with pytest.raises(ValueError, match="queueLimit"):
            ParallelInference(net, queueLimit=0)

    def test_more_than_one_device_waits_for_item_7(self):
        net = _mln()
        with pytest.raises(NotImplementedError, match="item 7"):
            ParallelInference.Builder(net).workers(2).build()
        with pytest.raises(NotImplementedError, match="item 7"):
            ParallelInference(net, mesh=["cpu", "cpu"])
        assert ParallelInference(net, mesh=["cpu"]).device.type == "cpu"

    def test_builder_wires_queue_limit_and_mode(self):
        pi = (ParallelInference.Builder(_mln()).workers(1)
              .inferenceMode("BATCHED").queueLimit(7)
              .batchBuckets(8, 16).build())
        try:
            assert pi.inferenceMode == "BATCHED"
            assert pi.queueLimit == 7
            assert pi._ensure_batcher().queue_limit == 7
            assert pi._ensure_batcher().max_rows == 16
        finally:
            pi.close()

    @pytest.mark.parametrize("mode", ["INPLACE", "SEQUENTIAL"])
    def test_sync_modes_stay_sync(self, mode):
        pi = ParallelInference(_mln(), batchBuckets=(8,),
                               inferenceMode=mode)
        out = pi.output(_rows(3))
        assert out.shape()[0] == 3
        assert pi._batcher is None
        assert pi.cold_dispatches == 1     # bucket 8 was never warmed

    def test_batched_mode_defaults_buckets(self):
        pi = ParallelInference(_mln(), inferenceMode="BATCHED")
        assert pi.batchBuckets == tuple(sorted(DEFAULT_BATCH_BUCKETS))

    def test_batch_limit_chunks_host_side(self):
        net = _mln()
        x = _rows(11, seed=5)
        whole = ParallelInference(net).output(x).toNumpy()
        pi = ParallelInference(net, batchLimit=4, batchBuckets=(4,))
        np.testing.assert_array_equal(pi.output(x).toNumpy(), whole)
        assert pi._warmed == {4}

    def test_batched_output_matches_sync_bitwise(self):
        net = _mln()
        sync = ParallelInference(net, batchBuckets=(8, 16))
        queued = ParallelInference(net, batchBuckets=(8, 16),
                                   inferenceMode="BATCHED", queueLimit=64,
                                   maxWaitMs=2.0)
        try:
            sizes = (5, 7, 3, 2, 6, 1)
            xs = [_rows(n, seed=n) for n in sizes]
            want = [sync.output(x).toNumpy() for x in xs]
            got = [None] * len(xs)

            def run(i):
                got[i] = queued.output(xs[i]).toNumpy()

            ts = [threading.Thread(target=run, args=(i,))
                  for i in range(len(xs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            st = queued._batcher.stats
            assert st["requests"] == len(xs)
            assert st["dispatches"] <= len(xs)
        finally:
            queued.close()


# ----------------------------------------------------------------------
# parity inside the port + cold-dispatch discipline
# ----------------------------------------------------------------------

class TestServingParity:
    def test_coalesced_bitwise_across_bucket_boundaries(self):
        """5, 7 and 3 rows coalesce into the 16 bucket; alone each pads
        into the 8 bucket. On the CPU the rows still agree bitwise (the
        card holds this only within a bucket: ROADMAP Queue 3). The run
        pays no cold dispatch after the warm."""
        net = _mln()
        pi = ParallelInference(net, batchBuckets=(8, 16))
        rep = pi.precompile()
        assert {b: r["status"] for b, r in rep.items()} == {8: "cold",
                                                            16: "cold"}
        xs = [_rows(n, seed=10 + n) for n in (5, 7, 3)]
        per = [pi.output(x).toNumpy() for x in xs]
        mb = MicroBatcher(pi._dispatch_coalesced, max_rows=16,
                          bucket_for=pi._target_batch,
                          clock=ManualClock(), start_thread=False)
        reqs = [mb.submit(x, wait=False) for x in xs]
        mb.flush()
        assert mb.occupancy == [(15, 16)]
        for r, w in zip(reqs, per):
            np.testing.assert_array_equal(r.result, w)
        assert pi.cold_dispatches == 0

    @pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0),
                                       (2, 0, 3, 1)])
    def test_same_bucket_coalescing_bitwise_wherever_the_row_sits(
            self, order):
        net = _mln()
        pi = ParallelInference(net, batchBuckets=(8,))
        xs = [_rows(n, seed=20 + n) for n in (3, 2, 1, 2)]
        want = [pi.output(x).toNumpy() for x in xs]
        mb = MicroBatcher(pi._dispatch_coalesced, max_rows=8,
                          bucket_for=pi._target_batch, clock=ManualClock(),
                          start_thread=False)
        reqs = {i: mb.submit(xs[i], wait=False) for i in order}
        mb.flush()
        assert mb.occupancy == [(8, 8)]
        for i in order:
            np.testing.assert_array_equal(reqs[i].result, want[i])

    def test_single_input_graph_coalesces_bitwise(self):
        net = P.ComputationGraph(_graph_conf(P), device="cpu").init()
        pi = ParallelInference(net, batchBuckets=(8,))
        per = [pi.output(_rows(n, seed=n)).toNumpy() for n in (3, 4)]
        mb = MicroBatcher(pi._dispatch_coalesced, max_rows=8,
                          clock=ManualClock(), start_thread=False)
        rs = [mb.submit(_rows(n, seed=n), wait=False) for n in (3, 4)]
        mb.flush()
        assert mb.stats["dispatches"] == 1
        for r, w in zip(rs, per):
            np.testing.assert_array_equal(r.result, w)

    def test_warm_signatures_report_cold_then_warm(self):
        sig = WarmSignatures()
        a = ParallelInference(_mln(), batchBuckets=(8,),
                              warmSignatures=sig)
        b = ParallelInference(_scaled(_mln(), 2.0), batchBuckets=(8, 4),
                              warmSignatures=sig)
        assert a.precompile()[8]["status"] == "cold"
        rep = b.precompile()
        assert (rep[8]["status"], rep[4]["status"]) == ("warm", "cold")
        assert rep[8]["key"] == a.precompile()[8]["key"]
        c = ParallelInference(_mln(nout=12), batchBuckets=(8,),
                              warmSignatures=sig)
        assert c.precompile()[8]["status"] == "cold"  # another shape


class TestReferenceParity:
    """The same configuration in both packages, the reference's weights
    carried into the port, the same coalesced requests through both
    BATCHED ParallelInferences."""

    def _coalesce(self, pi, xs, bucket_for):
        mb = MicroBatcher(pi._dispatch_coalesced, max_rows=16,
                          bucket_for=bucket_for, clock=ManualClock(),
                          start_thread=False)
        reqs = [mb.submit(x, wait=False) for x in xs]
        mb.flush()
        return [np.asarray(r.wait(0)) for r in reqs]

    @pytest.mark.parametrize("graph", [False, True],
                             ids=["multilayer", "graph"])
    def test_coalesced_answers_agree_with_the_reference(self, graph):
        from deeplearning4j_tpu.serving import (
            ManualClock as RefClock, MicroBatcher as RefBatcher,
        )

        jn, pn = pair(_graph_conf if graph else _conf, graph=graph)
        xs = [_rows(n, seed=40 + n) for n in (5, 7, 3, 1)]
        ref = RefParallelInference(jn, batchBuckets=(8, 16))
        mb = RefBatcher(ref._dispatch_coalesced, max_rows=16,
                        bucket_for=ref._target_batch, clock=RefClock(),
                        start_thread=False)
        want = [mb.submit(x, wait=False) for x in xs]
        mb.flush()
        pi = ParallelInference(pn, batchBuckets=(8, 16))
        got = self._coalesce(pi, xs, pi._target_batch)
        assert mb.occupancy == [(16, 16)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w.wait(0)),
                                       rtol=RTOL, atol=ATOL)

    def test_int8_top1_matches_the_reference_and_f32(self):
        jn, pn = pair(_conf)
        x = _rows(32, seed=4)
        rhost, host = RefModelHost(), ModelHost()
        try:
            rhost.register("q8", jn, batchBuckets=(32,), int8=True)
            host.register("q8", pn, batchBuckets=(32,), int8=True)
            host.register("fp", pn, batchBuckets=(32,))
            want = np.asarray(rhost.submit("q8", x))
            got = host.submit("q8", x)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            np.testing.assert_array_equal(
                got.argmax(-1), host.submit("fp", x).argmax(-1))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        finally:
            rhost.close()
            host.close()


# ----------------------------------------------------------------------
# host: register / swap / int8
# ----------------------------------------------------------------------

class TestModelHost:
    def test_register_policy_table_and_duplicate_rejection(self):
        host = ModelHost()
        try:
            rep = host.register("mlp", _mln(), batchBuckets=(8,),
                                queueLimit=32, maxWaitMs=1.5)
            assert rep["version"] == 1
            assert {b: d["status"] for b, d in rep["warm"].items()} \
                == {8: "cold"}
            pol = host.describe()["mlp"]
            assert pol["dtype"] == "float32" and pol["int8"] is False
            assert pol["batchBuckets"] == [8]
            assert pol["queueLimit"] == 32
            assert pol["exampleShape"] == [8]
            assert pol["device"] == "cpu"
            assert host.kind("mlp") == "oneshot" and "mlp" in host
            assert host.names() == ["mlp"]
            with pytest.raises(ValueError, match="swap"):
                host.register("mlp", _mln())
            with pytest.raises(KeyError, match="unknown model"):
                host.model("nope")
        finally:
            host.close()

    def test_int8_model_serves_with_top1_agreement(self):
        host = ModelHost()
        try:
            net = _mln()
            host.register("fp", net, batchBuckets=(8,))
            host.register("q8", net, batchBuckets=(8,), int8=True)
            assert host.describe()["q8"]["int8"] is True
            x = _rows(6, seed=4)
            fp = host.submit("fp", x)
            q8 = host.submit("q8", x)
            assert q8.shape == fp.shape
            np.testing.assert_array_equal(np.argmax(q8, -1),
                                          np.argmax(fp, -1))
        finally:
            host.close()

    def test_rolling_swap_zero_errors_zero_cold_dispatches(self):
        """Concurrent clients keep hitting the model while a new version
        warms and swaps in: every response is bitwise one of the two
        versions' oracles, no request fails, the new version's bucket
        warms "warm" (same shape) and no dispatch of either version is
        cold."""
        buckets = (8,)
        net1, net2 = _mln(), _scaled(_mln(), 1.5)
        o1 = ParallelInference(net1, batchBuckets=buckets)
        o2 = ParallelInference(net2, batchBuckets=buckets)
        n_threads, n_each = 4, 24
        feats = {(t, i): _rows(1 + (t + i) % 5, seed=100 + t * 1000 + i)
                 for t in range(n_threads) for i in range(n_each)}
        want1 = {k: o1.output(v).toNumpy() for k, v in feats.items()}
        want2 = {k: o2.output(v).toNumpy() for k, v in feats.items()}

        host = ModelHost()
        host.register("m", net1, batchBuckets=buckets, queueLimit=256,
                      maxWaitMs=1.0)
        v1 = host.model("m")
        failures, versions_seen = [], set()
        swap_at = threading.Event()

        def client(t):
            for i in range(n_each):
                if t == 0 and i == 4:
                    swap_at.set()
                k = (t, i)
                try:
                    got = host.submit("m", feats[k])
                except Exception as e:
                    failures.append((k, repr(e)))
                    continue
                if np.array_equal(got, want1[k]):
                    versions_seen.add(1)
                elif np.array_equal(got, want2[k]):
                    versions_seen.add(2)
                else:
                    failures.append((k, "matches NEITHER version"))

        ts = [threading.Thread(target=client, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        assert swap_at.wait(30)
        rep = host.swap("m", net2)
        for t in ts:
            t.join(timeout=60)
        v2 = host.model("m")
        host.close()
        assert not any(t.is_alive() for t in ts)
        assert not failures, failures[:5]
        assert rep["version"] == 2 and v2.version == 2
        assert {b: d["status"] for b, d in rep["warm"].items()} \
            == {8: "warm"}
        assert v1.pi.cold_dispatches == 0 and v2.pi.cold_dispatches == 0
        assert 2 in versions_seen

    def test_swap_unknown_model_raises(self):
        host = ModelHost()
        try:
            with pytest.raises(KeyError, match="register"):
                host.swap("ghost", _mln())
        finally:
            host.close()

    def test_metrics_snapshot_schema(self):
        host = ModelHost()
        try:
            host.register("m", _mln(), batchBuckets=(8,), maxWaitMs=0.5)
            host.register("idle", _mln(), batchBuckets=(8,))
            host.submit("m", _rows(3))
            snap = host.metrics_snapshot()
            assert set(snap) == {"registry", "models", "sequences"}
            assert set(snap["models"]["m"]) == {"version", "stats",
                                                "queue_depth", "occupancy"}
            assert snap["models"]["m"]["stats"]["rows"] == 3
            assert snap["models"]["idle"]["stats"] is None
            assert "dl4j_serving_requests_total" in snap["registry"]
            assert host.queued_work("m") == 0
            assert host.queued_work("ghost") is None
        finally:
            host.close()


# ----------------------------------------------------------------------
# HTTP front
# ----------------------------------------------------------------------

class TestInferenceServerHTTP:
    def _host(self, **kw):
        host = ModelHost()
        kw.setdefault("batchBuckets", (8,))
        kw.setdefault("maxWaitMs", 1.0)
        host.register("m", _mln(), **kw)
        return host

    def test_predict_roundtrip_and_policy_routes(self):
        host = self._host()
        srv = InferenceServer(host).start(port=0)
        try:
            _wait_ready(srv.port)
            base = f"http://127.0.0.1:{srv.port}"
            x = _rows(3, seed=5)
            want = host.submit("m", x)
            status, body = _post(base + "/v1/models/m:predict",
                                 {"instances": x.tolist()})
            assert status == 200
            assert set(body) == {"predictions", "model", "version", "rows"}
            assert body["model"] == "m" and body["version"] == 1
            assert body["rows"] == 3
            np.testing.assert_array_equal(
                np.asarray(body["predictions"], np.float32), want)
            status, table = _get(base + "/v1/models")
            assert table["models"]["m"]["batchBuckets"] == [8]
            status, pol = _get(base + "/v1/models/m")
            assert pol["model"] == "m"
        finally:
            srv.stop(close_host=True)

    @pytest.mark.parametrize("path,body,code", [
        ("/v1/models/ghost:predict", {"instances": [[0.0] * 8]}, 404),
        ("/v1/models/m:predict", {}, 400),
        ("/v1/models/m:predict", {"instances": [[0.0] * 7] * 2}, 400),
        ("/v1/models/m:predict", {"instances": [[0.0] * 8],
                                  "deadlineMs": "soon"}, 400),
        ("/v1/nothing", {"instances": []}, 404),
    ], ids=["unknown-model", "no-instances", "bad-shape", "bad-deadline",
            "no-route"])
    def test_client_errors_have_status_codes(self, path, body, code):
        host = self._host()
        srv = InferenceServer(host).start(port=0)
        try:
            _wait_ready(srv.port)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"http://127.0.0.1:{srv.port}{path}", body)
            assert ei.value.code == code
            assert "error" in json.loads(ei.value.read().decode())
        finally:
            srv.stop(close_host=True)

    def test_unknown_model_policy_is_404(self):
        host = self._host()
        srv = InferenceServer(host).start(port=0)
        try:
            _wait_ready(srv.port)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"http://127.0.0.1:{srv.port}/v1/models/ghost")
            assert ei.value.code == 404
        finally:
            srv.stop(close_host=True)

    def test_healthz_gated_on_model_warmup(self):
        host = ModelHost()
        host.register("m", _mln(), batchBuckets=(8,), precompile=False)
        gate = threading.Event()
        warmed = []

        def warmup():
            gate.wait(20)
            warmed.append(host.warm_all())

        srv = InferenceServer(host).start(port=0, warmup=warmup)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"http://127.0.0.1:{srv.port}/healthz")
            assert ei.value.code == 503
            gate.set()
            _wait_ready(srv.port)
            assert warmed and warmed[0]["m"][8]["status"] == "cold"
        finally:
            srv.stop(close_host=True)

    def test_queue_full_is_429_not_a_hang(self):
        host = self._host(queueLimit=2)
        srv = InferenceServer(host).start(port=0)
        release = threading.Event()
        try:
            _wait_ready(srv.port)
            base = f"http://127.0.0.1:{srv.port}"
            b = host.model("m").batcher
            orig = b._dispatch
            entered = threading.Event()

            def gated(f):
                entered.set()
                release.wait(30)
                return orig(f)

            b._dispatch = gated
            results = []

            def bg_post(i):
                try:
                    results.append(_post(base + "/v1/models/m:predict",
                                         {"instances":
                                          _rows(1, i).tolist()},
                                         timeout=60)[0])
                except urllib.error.HTTPError as e:
                    results.append(e.code)

            t1 = threading.Thread(target=bg_post, args=(0,))
            t1.start()
            assert entered.wait(20)
            t23 = [threading.Thread(target=bg_post, args=(i,))
                   for i in (1, 2)]
            for t in t23:
                t.start()
            assert _until(lambda: b.depth == 2)
            t0 = time.perf_counter()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:predict",
                      {"instances": _rows(1, 9).tolist()})
            assert ei.value.code == 429
            assert time.perf_counter() - t0 < 5.0
            release.set()
            for t in [t1] + t23:
                t.join(timeout=30)
            assert results.count(200) == 3
        finally:
            release.set()
            srv.stop(close_host=True)

    def test_per_request_deadline_is_504(self):
        host = self._host(queueLimit=8)
        srv = InferenceServer(host).start(port=0)
        release = threading.Event()
        try:
            _wait_ready(srv.port)
            base = f"http://127.0.0.1:{srv.port}"
            b = host.model("m").batcher
            orig = b._dispatch
            entered = threading.Event()
            b._dispatch = lambda f: (entered.set(), release.wait(30),
                                     orig(f))[2]
            threading.Thread(
                target=lambda: _post(base + "/v1/models/m:predict",
                                     {"instances": _rows(1).tolist()},
                                     timeout=60),
                daemon=True).start()
            assert entered.wait(20)
            t0 = time.perf_counter()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:predict",
                      {"instances": _rows(1, 2).tolist(),
                       "deadlineMs": 200})
            assert ei.value.code == 504
            assert time.perf_counter() - t0 < 5.0
        finally:
            release.set()
            srv.stop(close_host=True)

    def test_closed_host_is_503(self):
        host = self._host()
        srv = InferenceServer(host).start(port=0)
        try:
            _wait_ready(srv.port)
            host.model("m").pi.close()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"http://127.0.0.1:{srv.port}/v1/models/m:predict",
                      {"instances": _rows(1).tolist()})
            assert ei.value.code == 503
        finally:
            srv.stop(close_host=True)


# ----------------------------------------------------------------------
# load through the host: counts (the rate is the card's, phase 18)
# ----------------------------------------------------------------------

class TestLoadCounts:
    def test_open_loop_coalesces_with_no_error_and_no_cold_dispatch(self):
        host = ModelHost()
        host.register("mlp", _mln(), batchBuckets=(1, 8, 32),
                      queueLimit=2048, maxWaitMs=3.0)
        try:
            rec = loadgen.run_open_loop(
                lambda x: host.submit("mlp", x), lambda i: _rows(1, i),
                rate=4000.0, n_requests=192, seed=0, max_clients=16)
            sm = host.model("mlp")
            st = sm.batcher.stats
            assert rec["errors"] == {} and rec["completed"] == 192
            assert st["requests"] == st["coalesced"] == 192
            assert st["rows"] == st["dispatched_rows"] == 192
            assert st["dispatches"] < 192   # requests shared dispatches
            occ = sm.batcher.occupancy_summary()
            assert occ["dispatches"] == st["dispatches"]
            assert sum(occ["histogram"].values()) == st["dispatches"]
            assert sm.pi.cold_dispatches == 0
        finally:
            host.close()

    def test_concurrent_submitters_lose_no_update(self):
        """More submitting threads than cores, a short switch interval:
        every request gets its own rows back and the counters add up."""
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        mb = MicroBatcher(lambda f: f * 2.0, max_rows=8, queue_limit=1024,
                          max_wait=0.0005, name="mb-stress")
        wrong = []
        sizes = [[1 + (t + i) % 3 for i in range(25)] for t in range(16)]

        def client(t):
            for i, n in enumerate(sizes[t]):
                x = _rows(n, seed=1000 * t + i)
                if not np.array_equal(mb.submit(x, timeout=30), x * 2.0):
                    wrong.append((t, i))

        try:
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            rows = sum(map(sum, sizes))
            st = mb.stats
            assert not wrong
            assert st["requests"] == st["coalesced"] == 16 * 25
            assert st["rows"] == st["dispatched_rows"] == rows
            assert sum(r for r, _ in mb.occupancy) == rows
            assert mb.outstanding == 0 and mb.depth == 0
        finally:
            sys.setswitchinterval(old)
            mb.close()
