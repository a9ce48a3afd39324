"""The port's carry-slot sequence serving (deeplearning4j_tpu_torch/
serving/sequence.py ``SequenceScheduler``, nn/multilayer.py
``rnnStepBatched``, serving/host.py ``register_sequence`` /
``swap_sequence`` / ``submit_sequence``, serving/server.py ``:generate``
with a ``"steps"`` body): the reference's tests/test_sequence_serving.py
case by case, on the CPU, with a ManualClock and no thread where the
reference has them.

The reference asserts per-slot outputs BITWISE equal to serial
``rnnTimeStep``; that claim fails in the reference itself (1.49e-8 on 2 of
25 elements: a product's rounding depends on its row count). Those
assertions become the port's contract (serving/sequence.py):

- per-slot output within rtol 1e-6 / atol 1e-7 of serial batch-1
  ``rnnTimeStep`` in f32, within 1 bf16 ulp in bf16;
- bitwise where it is structural: the same submissions at the same
  buckets, run twice; the bf16 trajectory against the same bucket's
  functional drive;
- exact occupancy and dispatch counts, and the deterministic half of the
  reference's gate: gang admission needs >= 2x the dispatches of step
  admission on the straggler-skewed mix (the wall-clock half is a CPU
  timing and is left to the card).

The port's scheduler is also held against the REFERENCE's serial
``rnnTimeStep`` on carried weights (f32 rtol 1e-5 / atol 1e-6, the
cross-framework bar of tests/test_torch_recurrent_tbptt.py).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.serving import (
    DeadlineExceededError, InferenceServer, ManualClock, ModelHost,
    QueueFullError, SequenceScheduler, ServingClosedError,
    greedy_onehot_feedback,
)
from deeplearning4j_tpu_torch.serving import host as host_mod

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


# ----------------------------------------------------------------------
# subjects
# ----------------------------------------------------------------------

def _conf(M, layers, width, seed, dtype=None):
    b = M.NeuralNetConfiguration.Builder().seed(seed).updater(
        M.Nesterovs(0.1, 0.9))
    if dtype is not None:
        b = b.dataType(dtype)
    b = b.list()
    for layer in layers:
        b = b.layer(layer)
    return b.setInputType(M.InputType.recurrent(width, 6)).build()


def _rnn_layers(M):
    """LSTM + GRU + RnnOutputLayer: one carry of each shape."""
    return [M.LSTM(nOut=8), M.GRU(nOut=8),
            M.RnnOutputLayer(nOut=5, activation="softmax",
                             lossFunction="mcxent")]


def _rnn_net(seed=7, dtype=None):
    return P.MultiLayerNetwork(_conf(P, _rnn_layers(P), 4, seed, dtype),
                               device="cpu").init()


def _char_net(seed=3, vocab=5):
    """vocab-in/vocab-out char-RNN shape (generation feedback tests)."""
    layers = [P.LSTM(nOut=8),
              P.RnnOutputLayer(nOut=vocab, activation="softmax",
                               lossFunction="mcxent")]
    return P.MultiLayerNetwork(_conf(P, layers, vocab, seed),
                               device="cpu").init()


def _seqs(lens, seed=0, width=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, width).astype(np.float32) for t in lens]


def _serial_oracle(net, seqs):
    """Per-sequence serial batch-1 rnnTimeStep outputs."""
    outs = []
    for s in seqs:
        net.rnnClearPreviousState()
        outs.append(np.concatenate(
            [net.rnnTimeStep(s[t:t + 1]).toNumpy()
             for t in range(s.shape[0])], axis=0))
    net.rnnClearPreviousState()
    return outs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=RTOL, atol=ATOL)


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two float32 arrays of bf16 values."""
    def ordered(x):
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        bits = t.bfloat16().view(torch.int16).long() & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _sched(net, **kw):
    kw.setdefault("slot_buckets", (4,))
    kw.setdefault("queue_limit", 32)
    clk = kw.pop("clock", None) or ManualClock()
    return SequenceScheduler(net, clock=clk, start_thread=False,
                             **kw), clk


# ----------------------------------------------------------------------
# the functional slot-batched step (nn/multilayer.py)
# ----------------------------------------------------------------------

class TestCarryAPI:
    def test_carry_spec_shapes(self):
        net = _rnn_net()
        assert net.rnnCarrySpec() == (("h", "c"), ("h",), ())
        zeros = net.rnnCarryZeros(3)
        assert sorted(zeros[0]) == ["c", "h"]
        assert zeros[0]["h"].shape == (3, 8)
        assert sorted(zeros[1]) == ["h"] and zeros[2] == {}

    def test_non_stepwise_nets_rejected_loudly(self):
        bidi = P.MultiLayerNetwork(_conf(P, [
            P.Bidirectional(layer=P.LSTM(nOut=8)),
            P.RnnOutputLayer(nOut=4, activation="softmax",
                             lossFunction="mcxent")], 4, 1),
            device="cpu").init()
        with pytest.raises(ValueError, match="Bidirectional"):
            bidi.rnnCarrySpec()
        ff = P.MultiLayerNetwork(
            P.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(P.DenseLayer(nOut=8, activation="relu"))
            .layer(P.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.feedForward(4)).build(),
            device="cpu").init()
        with pytest.raises(ValueError, match="no recurrent layers"):
            ff.rnnCarrySpec()
        with pytest.raises(ValueError, match="no recurrent layers"):
            SequenceScheduler(ff)

    def test_step_batched_vs_rnn_time_step(self):
        """One slot-batched step == the stateful path within the
        contract's tolerance, carried state included."""
        net = _rnn_net()
        xs = np.random.RandomState(1).randn(3, 2, 4).astype(np.float32)
        net.rnnClearPreviousState()
        want = [net.rnnTimeStep(xs[:, t]).toNumpy() for t in range(2)]
        net.rnnClearPreviousState()
        carries = net.rnnCarryZeros(3)
        for t in range(2):
            out, carries = net.rnnStepBatched(xs[:, t], carries)
            _close(out.numpy(), want[t])


# ----------------------------------------------------------------------
# scheduler matrix: deterministic (ManualClock, no thread, no sleeps)
# ----------------------------------------------------------------------

class TestSchedulerDeterministic:
    def test_ragged_lengths_and_occupancy(self):
        net = _rnn_net()
        lens = [5, 2, 7, 1, 3, 4]
        seqs = _seqs(lens, seed=0)
        oracle = _serial_oracle(net, seqs)
        sched, _ = _sched(net)
        reqs = [sched.submit(s, wait=False) for s in seqs]
        polls = 0
        while sched.poll():
            polls += 1
        for r, want in zip(reqs, oracle):
            assert r.done and r.error is None
            assert r.result.shape == want.shape
            _close(r.result, want)
        st = sched.stats
        assert st["completed"] == len(seqs)
        # occupancy accounting is exact
        assert st["slot_steps"] == sum(lens)
        assert sum(n for n, _ in sched.occupancy) == sum(lens)
        assert all(b == 4 for _, b in sched.occupancy)
        assert st["dispatches"] == polls == len(sched.occupancy)
        assert st["refills"] >= 2
        assert len(sched._m["ttft"].samples) == len(seqs)
        sched.close()

    def test_same_buckets_are_bitwise_repeatable(self):
        """The structural half of the contract: the same submissions at
        the same buckets give bitwise-equal results."""
        seqs = _seqs([5, 2, 7, 1, 3, 4], seed=20)
        runs = []
        for _ in range(2):
            sched, _ = _sched(_rnn_net(), slot_buckets=(2, 4))
            reqs = [sched.submit(s, wait=False) for s in seqs]
            sched.drain()
            runs.append([r.result for r in reqs])
            sched.close()
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)

    def test_refill_mid_sequence_reuses_freed_slot(self):
        net = _rnn_net()
        seqs = _seqs([3, 1, 2], seed=1)
        oracle = _serial_oracle(net, seqs)
        sched, _ = _sched(net, slot_buckets=(2,))
        reqs = [sched.submit(s, wait=False) for s in seqs]
        assert sched.poll() == 2          # seqs 0,1 admitted; 1 done
        assert reqs[1].done and not reqs[0].done
        assert sched.active_slots == 1    # slot freed by early exit
        assert sched.poll() == 2          # seq 2 refilled MID-sequence
        assert sched.stats["refills"] == 1
        sched.drain()
        for r, want in zip(reqs, oracle):
            _close(r.result, want)
        sched.close()

    def test_deadline_expires_at_step_boundary_and_frees_slot(self):
        net = _rnn_net()
        sched, clk = _sched(net, slot_buckets=(1,))
        doomed = sched.submit(_seqs([6], seed=2)[0], wait=False,
                              deadline=clk() + 0.5)
        queued = sched.submit(_seqs([2], seed=3)[0], wait=False)
        assert sched.poll() == 1          # doomed steps once
        assert doomed.steps_done == 1 and not doomed.done
        clk.advance(1.0)                  # deadline passes MID-FLIGHT
        assert sched.poll() == 1          # expiry freed the slot; queued
        #                                   was admitted the same tick
        assert isinstance(doomed.error, DeadlineExceededError)
        assert "mid-sequence" in str(doomed.error)
        sched.drain()
        assert queued.done and queued.error is None
        st = sched.stats
        assert st["expired"] == 1 and st["completed"] == 1
        sched.close()

    def test_queued_deadline_expires_without_a_slot(self):
        net = _rnn_net()
        sched, clk = _sched(net, slot_buckets=(1,))
        hog = sched.submit(_seqs([4], seed=4)[0], wait=False)
        doomed = sched.submit(_seqs([1], seed=5)[0], wait=False,
                              deadline=clk() + 0.5)
        sched.poll()
        clk.advance(1.0)
        sched.drain()
        assert hog.done and hog.error is None
        assert isinstance(doomed.error, DeadlineExceededError)
        assert "before a slot" in str(doomed.error)
        assert sched.stats["slot_steps"] == 4   # doomed never dispatched
        sched.close()

    def test_queue_full_and_close_contracts(self):
        net = _rnn_net()
        sched, _ = _sched(net, queue_limit=2)
        r1 = sched.submit(_seqs([2], seed=6)[0], wait=False)
        sched.submit(_seqs([2], seed=7)[0], wait=False)
        with pytest.raises(QueueFullError, match="queueLimit=2"):
            sched.submit(_seqs([1], seed=8)[0], wait=False)
        assert sched.stats["rejected"] == 1
        sched.poll()                       # both admitted, one step in
        sched.close(drain=False)
        assert isinstance(r1.error, ServingClosedError)
        with pytest.raises(ServingClosedError):
            sched.submit(_seqs([1], seed=9)[0], wait=False)

    def test_submit_validation(self):
        net = _rnn_net()
        sched, _ = _sched(net)
        with pytest.raises(ValueError, match="feature width"):
            sched.submit(np.zeros((2, 3), np.float32), wait=False)
        with pytest.raises(ValueError, match="steps >= 1"):
            sched.submit(np.zeros((0, 4), np.float32), wait=False)
        with pytest.raises(ValueError, match="feedback"):
            sched.submit(np.zeros((2, 4), np.float32), wait=False,
                         extra_steps=3)
        with pytest.raises(ValueError, match="admission"):
            SequenceScheduler(net, admission="magic")
        sched.close()

    def test_dispatch_failure_fails_live_slots(self, monkeypatch):
        net = _rnn_net()
        sched, _ = _sched(net)
        reqs = [sched.submit(s, wait=False) for s in _seqs([3, 2],
                                                           seed=10)]
        sched.poll()

        def broken(x, carries):
            raise TypeError("step kaboom")

        monkeypatch.setattr(net, "rnnStepBatched", broken)
        assert sched.poll() == 0
        for r in reqs:
            assert isinstance(r.error, TypeError)
            with pytest.raises(TypeError):
                r.wait(0)
        assert sched.stats["errors"] == 2
        assert sched.active_slots == 0
        monkeypatch.undo()
        again = sched.submit(_seqs([2], seed=11)[0], wait=False)
        sched.drain()                      # the freed slots serve again
        assert again.result.shape == (2, 5)
        sched.close()

    def test_generation_feedback(self):
        """Closed-loop generation (prompt + extra_steps with greedy
        one-hot feedback) follows the serial rnnTimeStep + argmax loop:
        the same argmax path, every row within the tolerance."""
        net = _char_net()
        vocab = 5
        rng = np.random.RandomState(11)
        prompt = np.eye(vocab, dtype=np.float32)[rng.randint(0, vocab, 2)]
        extra = 3
        net.rnnClearPreviousState()
        outs, x = [], prompt[0]
        for t in range(2 + extra):
            y = net.rnnTimeStep(x[None, :]).toNumpy()[0]
            outs.append(y)
            x = prompt[t + 1] if t + 1 < 2 else \
                np.eye(vocab, dtype=np.float32)[int(np.argmax(y))]
        net.rnnClearPreviousState()
        sched, _ = _sched(net, feedback=greedy_onehot_feedback(vocab))
        req = sched.submit(prompt, wait=False, extra_steps=extra)
        sched.drain()
        assert req.result.shape == (2 + extra, vocab)
        want = np.stack(outs)
        np.testing.assert_array_equal(req.result.argmax(1), want.argmax(1))
        _close(req.result, want)
        sched.close()

    def test_raising_feedback_fails_request_not_scheduler(self):
        net = _char_net()
        vocab = 5
        prompt = np.eye(vocab, dtype=np.float32)[[0, 1]]
        sched, _ = _sched(net)
        good = sched.submit(prompt, wait=False)
        boom = sched.submit(prompt, wait=False, extra_steps=2,
                            feedback=lambda row: 1 / 0)
        wide = sched.submit(prompt, wait=False, extra_steps=1,
                            feedback=lambda row: np.zeros(
                                vocab + 3, np.float32))
        sched.drain()
        assert good.result.shape == (2, vocab)
        with pytest.raises(ZeroDivisionError):
            boom.wait(0)
        with pytest.raises(ValueError, match="feedback row"):
            wide.wait(0)
        assert sched.active_slots == 0 and sched.depth == 0
        assert sched.stats["errors"] == 2
        again = sched.submit(prompt, wait=False)
        sched.drain()
        assert again.result.shape == (2, vocab)
        sched.close()


class TestWarm:
    def test_warm_runs_every_bucket_and_keeps_the_pad_row_zero(self):
        """The compile-discipline case's counterpart: warm() steps every
        slot bucket once (no executable cache stands between the port
        and its kernels), and a ragged serve after it stays within the
        contract; the pad row of every carry stays zero."""
        net = _rnn_net()
        sched, _ = _sched(net, slot_buckets=(2, 4))
        rep = sched.warm()
        assert sorted(rep) == [2, 4] and all(v >= 0 for v in rep.values())
        seqs = _seqs([5, 1, 3, 2, 4, 1, 9], seed=12)
        oracle = _serial_oracle(net, seqs)
        reqs = [sched.submit(s, wait=False) for s in seqs]
        sched.drain()
        for r, want in zip(reqs, oracle):
            _close(r.result, want)
        assert {b for _, b in sched.occupancy} == {2, 4}
        for d in sched._carries:
            for c in d.values():
                # slots 0-3, the zero pad row 4, the pad rows' scratch row
                assert c.shape[0] == 6 and not c[4].any()
        assert sorted(sched._free) == [0, 1, 2, 3]
        sched.close()


    def test_threaded_scheduler_warms_on_its_own_thread(self):
        """warm() of a threaded scheduler runs on the thread that serves,
        so that thread's one-time set-up on the card is not paid on the
        first requests' clock."""
        net = _rnn_net()
        sched = SequenceScheduler(net, slot_buckets=(1, 2), name="warm-t")
        seen = []
        inner = sched._warm

        def recording():
            seen.append(threading.current_thread())
            return inner()

        sched._warm = recording
        try:
            rep = sched.warm()
            assert sorted(rep) == [1, 2]
            assert seen == [sched._thread]
        finally:
            sched.close()
        assert sched._thread is None
        assert sorted(sched.warm()) == [1, 2]   # closed: warms inline
        assert seen[-1] is threading.current_thread()


# ----------------------------------------------------------------------
# iteration-level vs run-to-completion
# ----------------------------------------------------------------------

class TestIterationVsGang:
    #: straggler-skewed workload: short sequences interleaved with long
    #: stragglers, so every gang batch pads its short members to a
    #: straggler's length
    LENS = [24, 2, 2, 2, 2, 2] * 4

    def _run(self, admission, seqs):
        net = _rnn_net()
        sched = SequenceScheduler(net, slot_buckets=(8,), queue_limit=64,
                                  admission=admission, clock=ManualClock(),
                                  start_thread=False)
        sched.warm()
        reqs = [sched.submit(s, wait=False) for s in seqs]
        sched.drain()
        assert all(r.done and r.error is None for r in reqs)
        st = sched.stats
        sched.close()
        return st, [r.result for r in reqs]

    def test_iteration_level_2x_fewer_dispatches_than_gang(self):
        seqs = _seqs(self.LENS, seed=13)
        oracle = _serial_oracle(_rnn_net(), seqs)
        st_step, res_step = self._run("step", seqs)
        st_gang, res_gang = self._run("gang", seqs)
        assert st_step["slot_steps"] == st_gang["slot_steps"] \
            == sum(self.LENS)
        for got, want in zip(res_step, oracle):
            _close(got, want)
        for got, want in zip(res_gang, oracle):
            _close(got, want)
        for a, b in zip(res_step, res_gang):
            _close(a, b)
        assert st_gang["dispatches"] >= 2 * st_step["dispatches"], \
            (st_step, st_gang)
        assert st_step["refills"] > 0
        assert st_gang["refills"] == 0


# ----------------------------------------------------------------------
# against the reference's serial rnnTimeStep, weights carried
# ----------------------------------------------------------------------

def test_scheduler_matches_the_reference_serial_oracle():
    jn = J.MultiLayerNetwork(_conf(J, _rnn_layers(J), 4, 7)).init()
    net = _rnn_net()
    net.load_reference_params(jax.tree.map(np.asarray, jn._params))
    seqs = _seqs([5, 2, 7, 3], seed=21)
    sched, _ = _sched(net)
    reqs = [sched.submit(s, wait=False) for s in seqs]
    sched.drain()
    for s, r in zip(seqs, reqs):
        jn.rnnClearPreviousState()
        want = np.concatenate([np.asarray(jn.rnnTimeStep(
            s[t:t + 1]).toNumpy()) for t in range(s.shape[0])])
        np.testing.assert_allclose(r.result, want, rtol=1e-5, atol=1e-6)
    sched.close()


# ----------------------------------------------------------------------
# host integration: sequence models behind ModelHost and HTTP
# ----------------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHostSequenceModels:
    def test_register_submit_policy(self):
        host = ModelHost()
        try:
            net = _rnn_net()
            rep = host.register_sequence("charlstm", net, slotBuckets=(4,))
            assert rep["version"] == 1 and sorted(rep["warm"]) == [4]
            pol = host.describe()["charlstm"]
            assert pol["kind"] == "sequence" and pol["dtype"] == "float32"
            assert pol["slotBuckets"] == [4] and pol["featureSize"] == 4
            assert "paged" not in pol
            with pytest.raises(ValueError, match="swap_sequence"):
                host.register_sequence("charlstm", net)
            seq = _seqs([4], seed=14)[0]
            want = _serial_oracle(net, [seq])[0]
            _close(host.submit_sequence("charlstm", seq), want)
            with pytest.raises(ValueError, match="token prompts"):
                host.generate("charlstm", [1, 2])
            assert host.queued_work("charlstm") == 0
            assert host.queued_work("ghost") is None
        finally:
            host.close()

    def test_swap_sequence_serves_new_weights(self):
        host = ModelHost()
        try:
            net1, net2 = _rnn_net(), _rnn_net()
            with torch.no_grad():
                for p in net2._params:
                    for t in p.values():
                        t.mul_(1.5)
            seq = _seqs([3], seed=15)[0]
            want2 = _serial_oracle(net2, [seq])[0]
            host.register_sequence("m", net1, slotBuckets=(4,))
            host.submit_sequence("m", seq)
            rep = host.swap_sequence("m", net2)
            assert rep["version"] == 2 and sorted(rep["warm"]) == [4]
            _close(host.submit_sequence("m", seq), want2)
            with pytest.raises(KeyError, match="register_sequence"):
                host.swap_sequence("ghost", net2)
        finally:
            host.close()

    def test_register_sequence_warm_failure_closes_scheduler(
            self, monkeypatch):
        net = _rnn_net()
        captured = {}

        def bad_warm(self):
            captured["sm"] = self
            raise RuntimeError("warm kaboom")

        monkeypatch.setattr(host_mod.ServedSequenceModel, "warm", bad_warm)
        host = ModelHost()
        try:
            with pytest.raises(RuntimeError, match="warm kaboom"):
                host.register_sequence("s", net, slotBuckets=(2,))
            assert captured["sm"].scheduler._thread is None  # joined
            monkeypatch.undo()
            host.register_sequence("s", net, slotBuckets=(2,))
            assert host.describe()["s"]["kind"] == "sequence"
        finally:
            host.close()

    def test_http_generate_route(self):
        host = ModelHost()
        net = _char_net()
        host.register_sequence("charlstm", net, slotBuckets=(4,),
                               feedback=greedy_onehot_feedback(5))
        srv = InferenceServer(host).start(port=0)
        try:
            prompt = np.eye(5, dtype=np.float32)[[0, 3, 1]]
            net.rnnClearPreviousState()
            want, x = [], prompt[0]
            for t in range(3 + 2):
                y = net.rnnTimeStep(x[None, :]).toNumpy()[0]
                want.append(y)
                x = prompt[t + 1] if t + 1 < 3 else \
                    np.eye(5, dtype=np.float32)[int(np.argmax(y))]
            net.rnnClearPreviousState()
            st, body = _post(srv.port, "/v1/models/charlstm:generate",
                             {"steps": prompt.tolist(), "extraSteps": 2,
                              "deadlineMs": 30000})
            assert st == 200 and body["steps"] == 5
            assert body["model"] == "charlstm" and body["version"] == 1
            _close(np.asarray(body["outputs"], np.float32), np.stack(want))
            st, body = _post(srv.port, "/v1/models/charlstm:generate",
                             {"steps": prompt.tolist()})
            assert st == 200 and body["steps"] == 3
            for obj, code in [({"steps": prompt.tolist()}, 404),
                              ({}, 400),
                              ({"steps": np.zeros((2, 3)).tolist()}, 400),
                              ({"steps": [["x"]]}, 400),
                              ({"tokens": [1, 2]}, 400)]:
                url = "/v1/models/ghost:generate" if code == 404 else \
                    "/v1/models/charlstm:generate"
                assert _post(srv.port, url, obj)[0] == code, obj
        finally:
            srv.stop(close_host=True)

    def test_http_queue_full_and_deadline_codes(self):
        """429 past the queue limit and 504 on a deadline, through a
        host whose scheduler has no thread (nothing is stepped)."""
        host = ModelHost(clock=ManualClock())
        host.register_sequence("m", _rnn_net(), slotBuckets=(1,),
                               queueLimit=1)
        srv = InferenceServer(host).start(port=0)
        try:
            seq = _seqs([2], seed=18)[0].tolist()
            st, body = _post(srv.port, "/v1/models/m:generate",
                             {"steps": seq, "deadlineMs": 50})
            assert st == 504, body          # queued, never stepped
            # the expired waiter's request still holds the one queue
            # place: the scheduler's clock never moved
            assert host.sequence_model("m").scheduler.depth == 1
            st, body = _post(srv.port, "/v1/models/m:generate",
                             {"steps": seq})
            assert st == 429 and "queueLimit=1" in body["error"]
        finally:
            srv.stop()
            host.close(drain=False)

    def test_threaded_scheduler_serves_blocking_submits(self):
        net = _rnn_net()
        host = ModelHost()
        host.register_sequence("m", net, slotBuckets=(4,))
        seqs = _seqs([3, 5, 2, 4], seed=17)
        oracle = _serial_oracle(net, seqs)
        got = [None] * len(seqs)

        def client(i):
            got[i] = host.submit_sequence("m", seqs[i], deadline_s=30.0)

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(seqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        try:
            assert not any(t.is_alive() for t in ts)
            for g, want in zip(got, oracle):
                assert g is not None
                _close(g, want)
        finally:
            host.close()


# ----------------------------------------------------------------------
# non-f32 dtype policies
# ----------------------------------------------------------------------

class TestNonF32Policies:
    def test_bf16_carries_live_in_compute_dtype(self):
        """Carries live in the compute dtype; the served trajectory is
        bitwise the solo functional drive through the same bucket, and
        within 1 bf16 ulp of serial batch-1 rnnTimeStep."""
        net = _rnn_net(dtype=P.DataType.BFLOAT16)
        sched, _ = _sched(net)
        assert sched._carry_dtype == torch.bfloat16
        assert all(c.dtype == torch.bfloat16 for d in sched._carries
                   for c in d.values())
        seqs = _seqs([3, 6, 4], seed=1)
        reqs = [sched.submit(s, wait=False) for s in seqs]
        sched.drain()
        got = [r.wait(5) for r in reqs]
        for s, g in zip(seqs, got):
            # every value is a bf16 value, widened exactly
            np.testing.assert_array_equal(
                torch.from_numpy(g).bfloat16().float().numpy(), g)
            S = sched.max_slots
            carry = net.rnnCarryZeros(S)
            ref = []
            for step in s:
                x = np.zeros((S, s.shape[1]), np.float32)
                x[0] = step
                y, carry = net.rnnStepBatched(x, carry)
                ref.append(y[0].float().numpy())
                for d in carry:
                    for c in d.values():
                        c[1:] = 0        # free slots re-zeroed
            np.testing.assert_array_equal(np.stack(ref), g)
            serial = _serial_oracle(net, [s])[0]
            assert _bf16_ulps(serial, g) <= 1
        sched.close()
