"""Port parity for the recurrent wrappers (deeplearning4j_tpu_torch/nn/
conf/recurrent.py ``Bidirectional`` in its 4 modes,
``GravesBidirectionalLSTM`` and ``LastTimeStep`` with a ragged mask)
through MultiLayerNetwork against the JAX reference: both networks built
by their own builders from the same configuration, the reference's nested
``{"fwd": {...}, "bwd": {...}}`` parameters carried into the port by
``load_reference_params``; inputs are seeded numpy float32.

Tolerances (f32), with and without feature and label masks: output max
abs 1e-6, loss rel 1e-5, each gradient rel L2 1e-4 (the products sum in
another order).
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.ndarray import DataType as JDataType
import deeplearning4j_tpu_torch.nn as P
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
    "bidi-concat": lambda M: [M.Bidirectional(M.LSTM(nOut=5)),
                              rnn_head(M)],
    "bidi-add": lambda M: [M.Bidirectional(M.GRU(nOut=5), mode="add"),
                           rnn_head(M)],
    "bidi-mul": lambda M: [M.Bidirectional(M.GravesLSTM(nOut=5),
                                           mode="mul"), rnn_head(M)],
    "bidi-average": lambda M: [M.Bidirectional(M.SimpleRnn(nOut=5),
                                               mode="average"),
                               rnn_head(M)],
    "graves-bidi": lambda M: [M.GravesBidirectionalLSTM(nOut=5),
                              rnn_head(M)],
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


@pytest.mark.parametrize("masked", [False, True], ids=["last", "ragged"])
def test_last_time_step_with_a_ragged_mask(masked):
    def layers(M):
        return [M.LastTimeStep(M.LSTM(nOut=6)),
                M.OutputLayer(nOut=3, activation="softmax",
                              lossFunction="mcxent")]

    jn, pn = pair(layers)
    x, _ = seq_data()
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    fm = ragged_mask() if masked else None
    jl, pl, jg, pg = loss_and_grads(jn, pn, x, y, fm)
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert_grads(jg, pg)
    assert pn.conf.layers[1].nIn == 6


def test_bidirectional_params_carry_nested():
    """Bidirectional's {"fwd": {...}, "bwd": {...}} tree comes across
    through params_from_reference and goes back nested."""
    jn, pn = pair(LAYERS["bidi-concat"])
    assert sorted(pn._params[0]) == sorted(
        f"{d}.{k}" for d in ("fwd", "bwd") for k in ("W", "RW", "b"))
    back = params_to_reference(pn.layers, pn._params)
    want = jax.tree.map(np.asarray, jn._params)
    for d in ("fwd", "bwd"):
        for k in ("W", "RW", "b"):
            np.testing.assert_array_equal(back[0][d][k], want[0][d][k])
    assert pn.conf.layers[1].nIn == 10


