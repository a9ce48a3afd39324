"""The port's line-search solvers against the reference's
(``deeplearning4j_tpu/nn/solvers.py``).

Solvers: L-BFGS (optax 0.2.6's lbfgs with the zoom line search) and
line gradient descent (optax's backtracking search) step for step in f64
within 1e-10 relative of the reference's iterates over 5 iterations, on
three seeds; in f32 within 1e-4 relative (the line search's scalars run
in f64 in the port). Newton-CG is held to the bar of
``tests/test_solvers.py::test_conjugate_gradient_converges`` (loss
< 5e-3 after 40 full-batch steps, below fixed-step SGD's), not to the
reference's output, since that reference test fails. Mirrors
``tests/test_solvers.py``; weight-only int8 inference is in
``tests/test_torch_quantize.py``."""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

from _torch_parity import pair, rel

torch.set_num_threads(1)


def _mlp(M, algo, dtype="float", act="tanh"):
    return (M.NeuralNetConfiguration.Builder().seed(3).dataType(dtype)
            .optimizationAlgo(algo).list()
            .layer(M.DenseLayer(nIn=5, nOut=4, activation=act))
            .layer(M.OutputLayer(nOut=2, activation="identity",
                                 lossFunction="MSE")).build())


def _regression(seed, n=32):
    """f32-representable data: the reference reads features as f32."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    W = rng.randn(5, 2).astype(np.float32)
    Y = (np.tanh(X @ W) + 0.01).astype(np.float32)
    return X, Y


def _worst_rel(jn, pn):
    want = jax.tree.map(np.asarray, jn._params)
    got = params_to_reference(pn.layers, pn._params)
    return max(rel(got[i][k], want[i][k])
               for i in range(len(want)) for k in want[i])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algo", ["LBFGS", "LINE_GRADIENT_DESCENT"])
def test_f64_iterates_match_optax(algo, seed):
    jn, pn = pair(lambda M: _mlp(M, algo, "double"))
    X, Y = _regression(seed)
    Xd, Yd = X.astype(np.float64), Y.astype(np.float64)
    for _ in range(5):
        jn.fit(Xd, Yd)
        pn.fit(torch.from_numpy(Xd), torch.from_numpy(Yd))
        assert _worst_rel(jn, pn) <= 1e-10
        assert abs(pn.score() - jn.score()) <= 1e-10 * abs(jn.score())


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("algo", ["LBFGS", "LINE_GRADIENT_DESCENT"])
def test_solver_state_carries_mid_trajectory(algo, graph):
    """Three reference steps, then the reference's params and solver
    state (L-BFGS's curvature pairs, the backtracking learning rate)
    carried into a fresh port net: two more steps each stay within
    1e-10 of the reference's in f64. (Newton-CG keeps no state, and its
    steps differ from the reference's by design: the module docstring.)"""
    def conf(M):
        b = (M.NeuralNetConfiguration.Builder().seed(3).dataType("double")
             .optimizationAlgo(algo))
        if not graph:
            return (b.list()
                    .layer(M.DenseLayer(nIn=5, nOut=4, activation="tanh"))
                    .layer(M.OutputLayer(nOut=2, activation="identity",
                                         lossFunction="MSE")).build())
        return (b.graphBuilder().addInputs("in")
                .addLayer("d", M.DenseLayer(nIn=5, nOut=4,
                                            activation="tanh"), "in")
                .addLayer("out", M.OutputLayer(nOut=2, activation="identity",
                                               lossFunction="MSE"), "d")
                .setOutputs("out").setInputTypes(M.InputType.feedForward(5))
                .build())

    jn, pn = pair(conf, graph=graph)
    X, Y = (a.astype(np.float64) for a in _regression(5))
    for _ in range(3):
        jn.fit(X, Y)
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    pn.load_reference_solver_state(jax.tree.map(np.asarray, jn._upd_states))
    for _ in range(2):
        jn.fit(X, Y)
        pn.fit(torch.from_numpy(X), torch.from_numpy(Y))
    want = jax.tree.map(np.asarray, jn._params)
    got = (g_to_reference(pn.conf, pn._params) if graph
           else params_to_reference(pn.layers, pn._params))
    keys = want if graph else range(len(want))
    for k in keys:
        for n in want[k]:
            assert rel(got[k][n], want[k][n]) <= 1e-10, (k, n)


@pytest.mark.parametrize("algo", ["LBFGS", "LINE_GRADIENT_DESCENT"])
def test_f32_iterates_within_the_band(algo):
    jn, pn = pair(lambda M: _mlp(M, algo))
    X, Y = _regression(4)
    for _ in range(5):
        jn.fit(X, Y)
        pn.fit(X, Y)
    assert _worst_rel(jn, pn) <= 1e-4


def _lsq_data(seed=0, n=64):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype("float32")
    W = rng.randn(5, 2).astype("float32")
    return X, X @ W + 0.01 * rng.randn(n, 2).astype("float32")


def _regression_net(algo=None, seed=3):
    b = P.NeuralNetConfiguration.Builder().seed(seed).updater(P.Sgd(0.1))
    if algo is not None:
        b = b.optimizationAlgo(algo)
    conf = (b.list()
            .layer(P.DenseLayer(nIn=5, nOut=2, activation="identity"))
            .layer(P.OutputLayer(nOut=2, activation="identity",
                                 lossFunction="MSE")).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _full_batch_fit(net, X, Y, iters):
    for _ in range(iters):
        net.fit(X, Y)
    return net.score()


def test_newton_cg_converges_on_the_reference_subject():
    X, Y = _lsq_data(seed=1)
    c_loss = _full_batch_fit(_regression_net("CONJUGATE_GRADIENT"), X, Y, 40)
    p_loss = _full_batch_fit(_regression_net(None), X, Y, 40)
    assert c_loss < 5e-3, c_loss
    assert c_loss < p_loss, (c_loss, p_loss)


def test_lbfgs_crushes_a_convex_problem():
    X, Y = _lsq_data()
    l_loss = _full_batch_fit(_regression_net("LBFGS"), X, Y, 15)
    s_loss = _full_batch_fit(_regression_net(None), X, Y, 15)
    assert l_loss < 1e-3 and l_loss < 0.5 * s_loss


def test_line_gradient_descent_is_monotone():
    X, Y = _lsq_data(seed=2)
    net = _regression_net("LINE_GRADIENT_DESCENT")
    losses = []
    for _ in range(12):
        net.fit(X, Y)
        losses.append(net.score())
    assert all(b <= a + 1e-7 for a, b in zip(losses, losses[1:]))
    assert losses[-1] < losses[0] * 0.1


def test_lbfgs_trains_a_nonconvex_classifier():
    rng = np.random.RandomState(5)
    X = rng.randn(96, 6).astype("float32")
    y = (X.sum(1) > 0).astype(int)
    conf = (P.NeuralNetConfiguration.Builder().seed(7)
            .optimizationAlgo("LBFGS").list()
            .layer(P.DenseLayer(nIn=6, nOut=16, activation="tanh"))
            .layer(P.OutputLayer(nOut=2, activation="softmax",
                                 lossFunction="MCXENT")).build())
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    for _ in range(30):
        net.fit(X, np.eye(2, dtype="float32")[y])
    assert (net.output(X).toNumpy().argmax(1) == y).mean() > 0.95


@pytest.mark.parametrize("algo", ["LBFGS", "CONJUGATE_GRADIENT",
                                  "LINE_GRADIENT_DESCENT"])
def test_frozen_layers_stay_frozen_under_a_solver(algo):
    X, Y = _lsq_data()
    net = _regression_net(algo)
    net.layers[0].frozen = True
    w0 = net._params[0]["W"].detach().clone()
    _full_batch_fit(net, X, Y, 4)
    assert torch.equal(net._params[0]["W"], w0)
    assert np.isfinite(net.score())


def test_graph_lbfgs_matches_the_reference_and_converges():
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(3)
                .dataType("double").optimizationAlgo("LBFGS")
                .graphBuilder().addInputs("in")
                .addLayer("d", M.DenseLayer(nIn=5, nOut=2,
                                            activation="identity"), "in")
                .addLayer("out", M.OutputLayer(nOut=2, activation="identity",
                                               lossFunction="MSE"), "d")
                .setOutputs("out").setInputTypes(M.InputType.feedForward(5))
                .build())

    jn, pn = pair(conf, graph=True)
    X, Y = _lsq_data(4)
    Xd, Yd = X.astype(np.float64), Y.astype(np.float64)
    for _ in range(5):
        jn.fit(Xd, Yd)
        pn.fit(torch.from_numpy(Xd), torch.from_numpy(Yd))
    want = jax.tree.map(np.asarray, jn._params)
    got = g_to_reference(pn.conf, pn._params)
    for name in want:
        for k in want[name]:
            assert rel(got[name][k], want[name][k]) <= 1e-10
    for _ in range(25):
        pn.fit(torch.from_numpy(Xd), torch.from_numpy(Yd))
    assert pn.score() < 1e-3


def test_solver_guards_as_the_reference():
    assert P.OptimizationAlgorithm.resolve("lbfgs") == "LBFGS"
    with pytest.raises(ValueError, match="unknown OptimizationAlgorithm"):
        P.OptimizationAlgorithm.resolve("newton")
    conf = (P.NeuralNetConfiguration.Builder().seed(3)
            .optimizationAlgo("LBFGS").maxNumLineSearchIterations(7).list()
            .layer(P.AutoEncoder(nIn=5, nOut=3))
            .layer(P.OutputLayer(nOut=2, activation="softmax",
                                 lossFunction="MCXENT")).build())
    assert conf.maxNumLineSearchIterations == 7
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    assert net._solver.zoom.max_steps == 7
    with pytest.raises(ValueError, match="optimizationAlgo"):
        net.pretrainLayer(0, np.zeros((4, 5), "float32"))
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    with pytest.raises(ValueError, match="STOCHASTIC_GRADIENT_DESCENT"):
        ParallelWrapper(_regression_net("LBFGS"))
    gconf = (P.NeuralNetConfiguration.Builder().seed(1)
             .optimizationAlgo("LBFGS")
             .gradientNormalization("ClipL2PerLayer")
             .gradientNormalizationThreshold(1.0).list()
             .layer(P.DenseLayer(nIn=5, nOut=2, activation="identity"))
             .layer(P.OutputLayer(nOut=2, activation="identity",
                                  lossFunction="MSE")).build())
    with pytest.warns(UserWarning, match="IGNORED"):
        P.MultiLayerNetwork(gconf, device="cpu")
    sgd = _regression_net(None)
    assert sgd._solver is None
    assert sgd.conf.optimizationAlgo == "STOCHASTIC_GRADIENT_DESCENT"


def test_minibatch_iterator_with_lbfgs():
    """From the reference's initial weights, minibatch L-BFGS through an
    iterator follows the reference's losses (the curvature pairs cross
    batches in both) and meets its bar."""
    import deeplearning4j_tpu.data as JD
    from deeplearning4j_tpu_torch.data import DataSetIterator

    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(3)
                .optimizationAlgo("LBFGS").list()
                .layer(M.DenseLayer(nIn=5, nOut=2, activation="identity"))
                .layer(M.OutputLayer(nOut=2, activation="identity",
                                     lossFunction="MSE")).build())

    X, Y = _lsq_data()
    jn, pn = pair(conf)
    ji, pi = JD.DataSetIterator(X, Y, 32), DataSetIterator(X, Y, 32)
    for _ in range(10):
        jn.fit(ji)
        pn.fit(pi)
        assert abs(pn.score() - jn.score()) <= 1e-3 * abs(jn.score())
    assert pn.score() < 0.05
