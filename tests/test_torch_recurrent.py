"""Port parity for the recurrent layers (deeplearning4j_tpu_torch/nn/
conf/recurrent.py) through MultiLayerNetwork, and zoo TextGenerationLSTM,
against the JAX reference: both networks built by their own builders from
the same configuration, the reference's initial parameters carried into
the port by ``load_reference_params`` (nested wrapper trees included);
inputs are seeded numpy float32. Truncated BPTT and stepping are in
tests/test_torch_recurrent_tbptt.py.

Tolerances (f32), every layer (LSTM, GravesLSTM, SimpleRnn, GRU, a stack
of three), with and without feature and label masks: output max abs
1e-6, loss rel 1e-5, each gradient rel L2 1e-4 (the products sum in
another order). The wrappers are in tests/test_torch_recurrent_wrappers.py.
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.zoo as JZ
from deeplearning4j_tpu.ndarray import DataType as JDataType
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(1)

B, F, T = 4, 3, 6


def _dtype(M, name):
    return getattr(JDataType if M is J else P.DataType, name)


def conf(M, layers, it, seed=7, updater=None, dtype="FLOAT", tbptt=None):
    b = (M.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater(M) if updater else M.Sgd(0.1))
         .dataType(_dtype(M, dtype)).list())
    for layer in layers(M):
        b = b.layer(layer)
    b = b.setInputType(it(M))
    if tbptt:
        b = b.backpropType(M.BackpropType.TruncatedBPTT).tBPTTLength(tbptt)
    return b.build()


def pair(layers, it=None, **kw):
    it = it or (lambda M: M.InputType.recurrent(F, T))
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


def loss_and_grads(jn, pn, x, y, fmask=None, lmask=None):
    """(reference loss, port loss, reference grads, port grads in the
    reference's layout) of the training loss with these masks."""
    (jl, _), jg = jax.value_and_grad(jn._loss_fn, has_aux=True)(
        jn._params, jn._states, x, y, None, fmask, lmask, False)
    tm = None if fmask is None else torch.from_numpy(fmask)
    lm = None if lmask is None else torch.from_numpy(lmask)
    pl, _ = pn._loss_fn(pn._params, pn._states, x, y, tm, lm)
    flat = [t for p in pn._params for t in p.values()]
    gs = iter(torch.autograd.grad(pl, flat))
    pg = [{k: next(gs) for k in p} for p in pn._params]
    return float(jl), float(pl.detach()), jg, \
        params_to_reference(pn.layers, pg)


def assert_grads(jg, pg, tol=1e-4):
    jg = jax.tree.map(np.asarray, jg)
    assert len(jg) == len(pg)
    for i, (w, g) in enumerate(zip(jg, pg)):
        assert set(w) == set(g), (i, sorted(w), sorted(g))
        for k in w:
            if isinstance(w[k], dict):
                assert_grads([w[k]], [g[k]], tol)
                continue
            assert rel_l2(g[k], w[k]) <= tol, (i, k, rel_l2(g[k], w[k]))


LAYERS = {
    "lstm": lambda M: [M.LSTM(nOut=6), rnn_head(M)],
    "graves": lambda M: [M.GravesLSTM(nOut=6), rnn_head(M)],
    "simple": lambda M: [M.SimpleRnn(nOut=6), rnn_head(M)],
    "gru": lambda M: [M.GRU(nOut=6), rnn_head(M)],
    "stack": lambda M: [M.GravesLSTM(nOut=6), M.GRU(nOut=5),
                        M.SimpleRnn(nOut=4), rnn_head(M)],
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masks"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_output_loss_and_gradients_match(name, masked):
    jn, pn = pair(LAYERS[name])
    x, y = seq_data()
    fm = ragged_mask() if masked else None
    lm = ragged_mask(seed=2) if masked else None
    jl, pl, jg, pg = loss_and_grads(jn, pn, x, y, fm, lm)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert_grads(jg, pg)
    out = pn.output(x).toNumpy()
    np.testing.assert_allclose(out, np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-6)


def test_forget_gate_bias_and_tanh_default():
    _, pn = pair(LAYERS["graves"])
    layer = pn.layers[0]
    assert layer.activation == "tanh" and layer.gateActivationFn == "sigmoid"
    b = pn._params[0]["b"].detach()
    assert torch.equal(b[6:12], torch.ones(6))
    assert float(b[:6].abs().sum() + b[12:].abs().sum()) == 0.0
    for k in ("pi", "pf", "po"):
        assert pn._params[0][k].shape == (6,)


def test_carry_spec_refuses_wrapped_state_and_plain_nets():
    _, pn = pair(lambda M: [M.Bidirectional(M.LSTM(nOut=5)), rnn_head(M)])
    with pytest.raises(ValueError, match="Bidirectional"):
        pn.rnnCarrySpec()
    ff = P.MultiLayerNetwork(
        P.NeuralNetConfiguration.Builder().list()
        .layer(P.DenseLayer(nOut=4))
        .layer(P.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(P.InputType.feedForward(3)).build(),
        device="cpu").init()
    with pytest.raises(ValueError, match="no recurrent layers"):
        ff.rnnCarrySpec()


# ----------------------------------------------------------------------
# zoo, device policy and what still waits
# ----------------------------------------------------------------------

def test_text_generation_lstm_conf_matches_the_reference():
    jc = JZ.TextGenerationLSTM().conf()
    pc = PZ.TextGenerationLSTM(device="cpu").conf()
    assert [type(l).__name__ for l in pc.layers] == \
        [type(l).__name__ for l in jc.layers] == ["LSTM", "LSTM",
                                                  "RnnOutputLayer"]
    for a, b in zip(pc.layers, jc.layers):
        assert (a.nIn, a.nOut, a.activation, a.weightInit) == \
            (b.nIn, b.nOut, b.activation, b.weightInit)
    assert pc.inputType == P.InputType.recurrent(77, 40)
    assert pc.layers[0].updater.learningRate == \
        jc.layers[0].updater.learningRate == 2e-3
    net = PZ.TextGenerationLSTM(device="cpu").init()
    assert net.numParams() == JZ.TextGenerationLSTM().init().numParams()


def test_recurrent_path_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PZ.TextGenerationLSTM().init()


def test_dropout_and_fit_steps_wait_for_item_4():
    """Dropout under truncated BPTT trains since the CNN-zoo slice (it
    raised before): one key a window, so fitSteps(2) is two fit calls
    bit for bit, and the masks differ from a dropout-free run's."""
    def layers(M, p=0.5):
        return [M.LSTM(nOut=4, dropOut=p), rnn_head(M)]

    def net(p=0.5):
        return P.MultiLayerNetwork(conf(P, lambda M: layers(M, p),
                                        lambda M: M.InputType.recurrent(F, T),
                                        tbptt=3), device="cpu").init()

    x, y = seq_data()
    a, b, c = net(), net(), net(None)
    a.fit(x, y)
    a.fit(x, y)
    b.fitSteps(x, y, numSteps=2)
    c.fitSteps(x, y, numSteps=2)
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert a.getIterationCount() == b.getIterationCount()
    assert not torch.equal(b.params().tensor(), c.params().tensor())


