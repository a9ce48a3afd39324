"""Port parity for truncated BPTT and recurrent stepping
(deeplearning4j_tpu_torch/nn/multilayer.py ``run_tbptt``,
``rnnTimeStep``, ``rnnStepBatched``; nn/graph.py's truncated BPTT)
against the JAX reference, and mirrors of the reference's
tests/test_multilayer.py::TestRnn. The reference's initial parameters
are carried into the port by ``load_reference_params``; inputs are
seeded numpy float32.

Tolerances (f32):
- config 3 (bench.py bench_lstm_tbptt) at the reference's SMOKE sizes
  (V 20, B 4, T 40, L 20) with nOut 32: both tBPTT windows' losses, the
  carries handed from window 1 to window 2 and a 3-fit Adam trajectory,
  rel 1e-4 each (carries and parameters as rel L2).
- rnnTimeStep (2-d and 3-d input, stateful): rtol 1e-5 / atol 1e-6
  against the reference's rnnTimeStep.
- rnnStepBatched against rnnTimeStep: the serving contract's rtol 1e-6 /
  atol 1e-7 (serving/sequence.py).
"""

import numpy as np
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.ndarray import DataType as JDataType
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(1)

B, F, T = 4, 3, 6


def conf(M, layers, it, seed=7, updater=None, tbptt=None):
    b = (M.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater(M) if updater else M.Sgd(0.1))
         .dataType(JDataType.FLOAT if M is J else P.DataType.FLOAT).list())
    for layer in layers(M):
        b = b.layer(layer)
    b = b.setInputType(it(M))
    if tbptt:
        b = b.backpropType(M.BackpropType.TruncatedBPTT).tBPTTLength(tbptt)
    return b.build()


def pair(layers, it, **kw):
    jn = J.MultiLayerNetwork(conf(J, layers, it, **kw)).init()
    pn = P.MultiLayerNetwork(conf(P, layers, it, **kw), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def rnn_head(M, n=3):
    return M.RnnOutputLayer(nOut=n, activation="softmax",
                            lossFunction="mcxent")


def seq_data(seed=0, n=B, f=F, t=T, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f, t)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, (n, t))]
    return x, y.transpose(0, 2, 1)


def ragged_mask(seed=1, n=B, t=T):
    lens = np.random.default_rng(seed).integers(2, t + 1, n)
    lens[0] = t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ----------------------------------------------------------------------
# BASELINE config 3 at the reference's SMOKE sizes: truncated BPTT
# ----------------------------------------------------------------------

V3, B3, T3, L3, H3 = 20, 4, 40, 20, 32


def config3(M):
    return [M.GravesLSTM(nOut=H3), M.GravesLSTM(nOut=H3),
            M.RnnOutputLayer(nOut=V3, activation="softmax",
                             lossFunction="mcxent")]


def config3_data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V3, (B3, T3))
    x = np.eye(V3, dtype="float32")[ids].transpose(0, 2, 1)
    y = np.eye(V3, dtype="float32")[np.roll(ids, -1, 1)].transpose(0, 2, 1)
    return x, y


class RefRecorder:
    """A reference listener: each window's score and, after it, the
    carries the network holds."""

    def __init__(self):
        self.scores, self.states = [], []

    def iterationDone(self, net, iteration, epoch):
        self.scores.append(net.score())
        self.states.append(jax.tree.map(np.asarray, net._states))


def record_port(pn):
    """Wrap the port's step: each window's loss and the states after
    it."""
    scores, states = [], []
    step = pn._train_step

    def recorded(*a, **kw):
        loss = step(*a, **kw)
        scores.append(float(loss))
        states.append(pn._states)
        return loss

    pn._train_step = recorded
    return scores, states


def test_config3_tbptt_windows_carries_and_trajectory():
    jn, pn = pair(config3, lambda M: M.InputType.recurrent(V3, T3),
                  seed=12, updater=lambda M: M.Adam(2e-3), tbptt=L3)
    x, y = config3_data()
    rec = RefRecorder()
    jn.setListeners(rec)
    scores, states = record_port(pn)
    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
    assert len(scores) == len(rec.scores) == 6     # 2 windows a fit
    np.testing.assert_allclose(scores, rec.scores, rtol=1e-4, atol=0)
    assert pn.getIterationCount() == jn.getIterationCount() == 6
    assert pn.score() == scores[-1]
    # the carries handed from window 1 to window 2 of the first fit
    for i in (0, 1):
        for k in ("h", "c"):
            got = states[0][i][k]
            assert got.shape == (B3, H3) and not got.requires_grad
            assert rel_l2(got.numpy(), rec.states[0][i][k]) <= 1e-4
    # no carry outlives the fit
    assert all("h" not in s and "c" not in s for s in pn._states)
    got = params_to_reference(pn.layers, pn._params)
    for i, want in enumerate(jax.tree.map(np.asarray, jn._params)):
        for k in want:
            assert rel_l2(got[i][k], want[k]) <= 1e-4, (i, k)
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-5)


def test_tbptt_short_last_window_and_masks():
    """T 10 over windows of 4: 3 windows, the last of 2 steps; the masks
    are sliced with the features."""
    def layers(M):
        return [M.LSTM(nOut=5), rnn_head(M)]

    jn, pn = pair(layers, lambda M: M.InputType.recurrent(F, 10),
                  updater=lambda M: M.Adam(1e-2), tbptt=4)
    x, y = seq_data(t=10)
    fm, lm = ragged_mask(t=10), ragged_mask(seed=3, t=10)
    rec = RefRecorder()
    jn.setListeners(rec)
    scores, _ = record_port(pn)
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    jn.fit(JDataSet(x, y, featuresMask=fm, labelsMask=lm))
    pn.fit(DataSet(x, y, featuresMask=fm, labelsMask=lm))
    assert len(scores) == len(rec.scores) == 3
    np.testing.assert_allclose(scores, rec.scores, rtol=1e-4, atol=0)


def test_computation_graph_tbptt_matches():
    def graph(M):
        return (M.NeuralNetConfiguration.Builder().seed(5)
                .updater(M.Adam(1e-2)).graphBuilder().addInputs("in")
                .addLayer("rnn", M.GravesLSTM(nOut=6), "in")
                .addLayer("out", rnn_head(M), "rnn")
                .setOutputs("out")
                .setInputTypes(M.InputType.recurrent(F, 8))
                .backpropType("tbptt").tBPTTForwardLength(3)
                .tBPTTBackwardLength(3).build())

    jg = J.ComputationGraph(graph(J)).init()
    pg = P.ComputationGraph(graph(P), device="cpu").init()
    pg.load_reference_params(jax.tree.map(np.asarray, jg._params),
                             jax.tree.map(np.asarray, jg._states))
    x, y = seq_data(t=8)
    rec = RefRecorder()
    jg.setListeners(rec)
    scores, _ = record_port(pg)
    for _ in range(2):
        jg.fit(x, y)
        pg.fit(x, y)
    assert len(scores) == len(rec.scores) == 6     # 3 windows a fit
    np.testing.assert_allclose(scores, rec.scores, rtol=1e-4, atol=0)
    assert all("h" not in s for s in pg._states.values())
    np.testing.assert_allclose(pg.outputSingle(x).toNumpy(),
                               np.asarray(jg.outputSingle(x).toNumpy()),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# stateful and slot-batched stepping
# ----------------------------------------------------------------------

def step_net(M):
    return [M.LSTM(nOut=8), M.GRU(nOut=8), rnn_head(M, 5)]


def test_rnn_time_step_stateful_2d_and_3d():
    jn, pn = pair(step_net, lambda M: M.InputType.recurrent(4, 6))
    x = np.random.default_rng(3).standard_normal((3, 4, 6)).astype(
        np.float32)
    for net in (jn, pn):
        net.rnnClearPreviousState()
    for t in range(3):               # 2-d in, 2-d out
        got = pn.rnnTimeStep(x[:, :, t]).toNumpy()
        want = np.asarray(jn.rnnTimeStep(x[:, :, t]).toNumpy())
        assert got.shape == (3, 5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got = pn.rnnTimeStep(x[:, :, 3:]).toNumpy()    # 3-d: the rest at once
    want = np.asarray(jn.rnnTimeStep(x[:, :, 3:]).toNumpy())
    assert got.shape == (3, 5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # stepping the whole sequence ends where output() does
    full = pn.output(x).toNumpy()
    np.testing.assert_allclose(got[:, :, -1], full[:, :, -1], rtol=1e-5,
                               atol=1e-6)
    pn.rnnClearPreviousState()
    np.testing.assert_allclose(pn.rnnTimeStep(x[:, :, 0]).toNumpy(),
                               full[:, :, 0], rtol=1e-5, atol=1e-6)


def test_rnn_step_batched_against_rnn_time_step():
    _, pn = pair(step_net, lambda M: M.InputType.recurrent(4, 6))
    x = np.random.default_rng(4).standard_normal((3, 2, 4)).astype(
        np.float32)
    pn.rnnClearPreviousState()
    want = [pn.rnnTimeStep(x[:, t]).toNumpy() for t in range(2)]
    pn.rnnClearPreviousState()
    carries = pn.rnnCarryZeros(3)
    assert [sorted(c) for c in carries] == [["c", "h"], ["h"], []]
    assert carries[0]["h"].dtype == torch.float32
    for t in range(2):
        out, carries = pn.rnnStepBatched(x[:, t], carries)
        assert out.shape == (3, 5) and not out.requires_grad
        np.testing.assert_allclose(out.numpy(), want[t], rtol=1e-6,
                                   atol=1e-7)
    # one row at a time, serially, agrees with the batch
    for r in range(3):
        pn.rnnClearPreviousState()
        for t in range(2):
            row = pn.rnnTimeStep(x[r:r + 1, t]).toNumpy()
            np.testing.assert_allclose(row[0], want[t][r], rtol=1e-6,
                                       atol=1e-7)
    assert pn._rnn_state is not None and pn._states[0] == {}


# ----------------------------------------------------------------------
# mirrors of the reference's tests/test_multilayer.py::TestRnn
# ----------------------------------------------------------------------

class TestRnnMirror:
    def _seq_data(self, n=64, F=3, T=8, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.randn(n, F, T).astype("float32") * 0.1
        trend = rng.randint(0, 2, n)
        ramp = np.linspace(-1, 1, T)
        x[:, 0, :] += np.where(trend[:, None] == 1, ramp, -ramp)
        y = np.eye(2, dtype="float32")[trend]
        return x, np.repeat(y[:, :, None], T, axis=2), y, trend

    def _net(self, layers, T, updater, tbptt=None):
        c = conf(P, lambda M: [*layers(M), rnn_head(M, 2)],
                 lambda M: M.InputType.recurrent(3, T), updater=updater,
                 tbptt=tbptt)
        return P.MultiLayerNetwork(c, device="cpu").init()

    def test_lstm_fit_and_output_shape(self):
        x, yseq, y, trend = self._seq_data()
        net = self._net(lambda M: [M.LSTM(nOut=8)], 8,
                        lambda M: M.Adam(2e-2))
        for _ in range(80):
            net.fit(x, yseq)
        out = net.output(x)
        assert out.shape() == (64, 2, 8)
        acc = (out.toNumpy()[:, :, -1].argmax(1) == trend).mean()
        assert acc > 0.9

    def test_graves_lstm_has_peepholes(self):
        net = self._net(lambda M: [M.GravesLSTM(nOut=4)], 5,
                        lambda M: M.Sgd(0.1))
        assert "pi" in net._params[0] and "pf" in net._params[0]

    def test_bidirectional_concat_doubles_features(self):
        net = self._net(lambda M: [M.Bidirectional(M.LSTM(nOut=4))], 5,
                        lambda M: M.Sgd(0.1))
        assert net.conf.layers[1].nIn == 8
        x = np.random.RandomState(0).randn(4, 3, 5).astype("float32")
        assert net.output(x).shape() == (4, 2, 5)

    def test_tbptt(self):
        x, yseq, _, _ = self._seq_data(T=16)
        net = self._net(lambda M: [M.LSTM(nOut=8)], 16,
                        lambda M: M.Adam(5e-3), tbptt=8)
        losses = []
        for _ in range(10):
            net.fit(x, yseq)
            losses.append(net.score())
        assert losses[-1] < losses[0]
        assert net.getIterationCount() == 20

    def test_rnn_timestep_stateful(self):
        net = self._net(lambda M: [M.LSTM(nOut=4)], 6,
                        lambda M: M.Sgd(0.1))
        x = np.random.RandomState(0).randn(2, 3, 6).astype("float32")
        full = net.output(x).toNumpy()
        net.rnnClearPreviousState()
        steps = [net.rnnTimeStep(x[:, :, t:t + 1]).toNumpy()[:, :, 0]
                 for t in range(6)]
        np.testing.assert_allclose(full[:, :, -1], steps[-1], rtol=1e-4,
                                   atol=1e-5)

    def test_label_mask_ignores_padded_steps(self):
        x, yseq, _, _ = self._seq_data(n=16)
        net = self._net(lambda M: [M.LSTM(nOut=4)], 8,
                        lambda M: M.Sgd(0.1))
        lmask_full = np.ones((16, 8), np.float32)
        lmask_half = np.ones((16, 8), np.float32)
        lmask_half[:, 4:] = 0
        s_full = net.score(DataSet(x, yseq, labelsMask=lmask_full))
        s_half = net.score(DataSet(x, yseq, labelsMask=lmask_half))
        assert not np.isclose(s_full, s_half)
