"""checkpointPolicy="save_conv_outputs" in the port
(``nn/multilayer.py`` ``remat_segment``; both networks), against the
stock path and the JAX reference. Mirrors tests/test_remat_policy.py.

The training forward runs in segments cut after each convolution and
dense product, each under ``torch.utils.checkpoint``, which keeps only a
segment's inputs (the product outputs before it); the backward
recomputes a segment when it reaches it. The contract, as the
reference's: the trajectory is the stock one (here bitwise: the
recompute runs the same ops on the same inputs, dropout re-seeds from its
key), BN's running statistics move once a step (the recompute's copies
are dropped), the forward really is cut at the products, the zoo threads
the option through both network types, and an unknown policy is
rejected. Synchronised BN
recomputes its all-reduces on two gloo ranks with the same result.
Against the reference's own remat trajectory (weights carried, Nesterovs):
params rtol 1e-5 / atol 1e-7 and the loss rel 1e-6 after 5 steps (f32;
the reference's own bar against its stock path).
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.nn import multilayer as ML
from deeplearning4j_tpu_torch.parallel import launch

import _torch_parallel_ranks as R

torch.set_num_threads(1)


def _gconf(M, policy, dropout=None, updater=None):
    """tests/test_remat_policy.py's graph (and a dropout on d1)."""
    b = (M.NeuralNetConfiguration.Builder().seed(11)
         .updater(updater or M.Adam(1e-2)).checkpointPolicy(policy))
    return (b.graphBuilder().addInputs("in")
            .addLayer("c1", M.ConvolutionLayer(nOut=6, kernelSize=(3, 3),
                                               padding=(1, 1),
                                               activation="identity"), "in")
            .addLayer("bn1", M.BatchNormalization(activation="relu"), "c1")
            .addLayer("p1", M.SubsamplingLayer(poolingType="max",
                                               kernelSize=(2, 2),
                                               stride=(2, 2)), "bn1")
            .addLayer("c2", M.ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                               padding=(1, 1),
                                               activation="identity"), "p1")
            .addLayer("bn2", M.BatchNormalization(activation="relu"), "c2")
            .addLayer("gap", M.GlobalPoolingLayer(poolingType="avg"), "bn2")
            .addLayer("d1", M.DenseLayer(nOut=16, activation="relu",
                                         dropOut=dropout), "gap")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                      "d1")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(8, 8, 2)).build())


def _mconf(M, policy, updater=None):
    """tests/test_remat_policy.py's MultiLayerNetwork."""
    b = (M.NeuralNetConfiguration.Builder().seed(9)
         .updater(updater or M.Adam(1e-2)).checkpointPolicy(policy))
    return (b.list()
            .layer(M.ConvolutionLayer(nOut=5, kernelSize=(3, 3),
                                      padding=(1, 1), activation="identity"))
            .layer(M.BatchNormalization(activation="relu"))
            .layer(M.GlobalPoolingLayer(poolingType="avg"))
            .layer(M.DenseLayer(nOut=8, activation="relu"))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.convolutional(6, 6, 2)).build())


def _data(seed=0, n=8, c=2, hw=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, hw, hw).astype("float32")
    return x, np.eye(3, dtype="float32")[rng.randint(0, 3, n)]


def _graph(policy, dropout=None):
    return P.ComputationGraph(_gconf(P, policy, dropout),
                              device="cpu").init()


@pytest.mark.parametrize("dropout", [None, 0.7], ids=["plain", "dropout"])
def test_trajectory_parity_with_stock(dropout):
    x, y = _data()
    stock, remat = _graph(None, dropout), _graph("save_conv_outputs",
                                                 dropout)
    assert remat.conf.checkpointPolicy == "save_conv_outputs"
    for _ in range(5):
        stock.fit(x, y)
        remat.fit(x, y)
        assert stock.score() == remat.score()
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    for n in ("bn1", "bn2"):
        for k in ("mean", "var"):
            assert torch.equal(stock._states[n][k], remat._states[n][k])


def test_bn_running_stats_track():
    """BN state leaves the checkpointed region as an output of the first
    forward; the recompute's copies are dropped, so the statistics move
    once a step: after one step, mean = (1 - decay) * batch mean."""
    x, y = _data(1)
    remat = _graph("save_conv_outputs")
    stock = _graph(None)
    for _ in range(3):
        stock.fit(x, y)
        remat.fit(x, y)
    assert torch.equal(stock._states["bn1"]["mean"],
                       remat._states["bn1"]["mean"])
    assert float(remat._states["bn1"]["mean"].abs().sum()) > 0
    one = _graph("save_conv_outputs")
    with torch.no_grad():
        c1 = torch.nn.functional.conv2d(
            torch.from_numpy(x), one._params["c1"]["W"],
            one._params["c1"]["b"], padding=1)
    one.fit(x, y)
    want = 0.1 * c1.double().mean((0, 2, 3))
    torch.testing.assert_close(one._states["bn1"]["mean"].double(), want,
                               rtol=1e-5, atol=1e-7)


def test_policy_cuts_a_segment_after_each_product(monkeypatch):
    """One checkpointed segment a product (c1, c2, d1, out), each fed
    only by the product output before it (or the network input)."""
    inputs = []
    real = ML.remat_segment

    def spy(fn, *args):
        inputs.append([tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor)])
        return real(fn, *args)

    from deeplearning4j_tpu_torch.nn import graph as G

    monkeypatch.setattr(G, "remat_segment", spy)
    x, y = _data(2)
    net = _graph("save_conv_outputs")
    net.fit(x, y)
    assert inputs == [[(8, 2, 8, 8)],       # the input -> c1
                      [(8, 6, 8, 8)],       # c1 -> bn1, p1, c2
                      [(8, 8, 4, 4)],       # c2 -> bn2, gap, d1
                      [(8, 16)]], inputs    # d1 -> out
    net.output(x)                           # inference runs no segment
    assert len(inputs) == 4


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="checkpointPolicy"):
        P.NeuralNetConfiguration.Builder().checkpointPolicy(
            "save_everything")
    with pytest.raises(ValueError, match="checkpointPolicy"):
        PZ.SimpleCNN(checkpointPolicy="everything", device="cpu").init()


def test_mln_trajectory_parity():
    rng = np.random.RandomState(4)
    x = rng.randn(8, 2, 6, 6).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, 8)]
    stock = P.MultiLayerNetwork(_mconf(P, None), device="cpu").init()
    remat = P.MultiLayerNetwork(_mconf(P, "save_conv_outputs"),
                                device="cpu").init()
    for _ in range(5):
        stock.fit(x, y)
        remat.fit(x, y)
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    assert stock.score() == remat.score()


def test_zoo_threads_the_policy_through_both_network_types():
    kw = dict(numClasses=3, device="cpu", checkpointPolicy="save_conv_outputs")
    for net in (PZ.SimpleCNN(inputShape=(3, 12, 12), **kw).init(),
                PZ.UNet(inputShape=(3, 8, 8), **kw).init()):
        assert net.conf.checkpointPolicy == "save_conv_outputs"
    x = np.random.RandomState(0).randn(2, 3, 12, 12).astype("float32")
    y = np.eye(3, dtype="float32")[[0, 2]]
    a = PZ.SimpleCNN(inputShape=(3, 12, 12), numClasses=3,
                     device="cpu").init()
    b = PZ.SimpleCNN(inputShape=(3, 12, 12), **kw).init()
    for _ in range(2):     # SimpleCNN trains with its DropoutLayer on
        a.fit(x, y)
        b.fit(x, y)
    assert torch.equal(a.params().tensor(), b.params().tensor())


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_matches_the_reference_remat_trajectory(kind):
    """Nesterovs here: Adam's first steps divide tiny gradients by their
    own magnitude, so two summation orders move a near-zero gradient's
    parameter by a whole step (observed 3e-3 apart after 5 steps)."""
    x, y = _data(3) if kind == "graph" else _data(3, hw=6)
    policy = "save_conv_outputs"
    if kind == "graph":
        jn = J.ComputationGraph(_gconf(J, policy, updater=J.Nesterovs(
            0.05, 0.9))).init()
        pn = P.ComputationGraph(_gconf(P, policy, updater=P.Nesterovs(
            0.05, 0.9)), device="cpu").init()
    else:
        jn = J.MultiLayerNetwork(_mconf(J, policy, J.Nesterovs(
            0.05, 0.9))).init()
        pn = P.MultiLayerNetwork(_mconf(P, policy, P.Nesterovs(0.05, 0.9)),
                                 device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    for _ in range(5):
        jn.fit(x, y)
        pn.fit(x, y)
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-7)
    assert abs(pn.score() - jn.score()) <= 1e-6 * abs(jn.score())


def test_sync_bn_recomputes_its_all_reduces_with_the_same_result():
    """Two gloo ranks, dense ParallelWrapper (synchronised BN): under the
    policy the recompute issues the BN all-reduces again, and every rank
    ends bitwise where the stock run ends."""
    ranks = launch(R.remat_sync_bn_rank, 2, device="cpu", timeout=240,
                   args=(3,))
    for r in ranks:
        s, m = r["stock"], r["save_conv_outputs"]
        np.testing.assert_array_equal(s["params"], m["params"])
        for n in s["bn"]:
            np.testing.assert_array_equal(s["bn"][n], m["bn"][n])
        assert s["losses"] == m["losses"]
        assert m["collectives"] > s["collectives"]
    np.testing.assert_array_equal(ranks[0]["stock"]["params"],
                                  ranks[1]["stock"]["params"])
