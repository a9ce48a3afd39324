"""The port's transfer learning against the reference's
(``deeplearning4j_tpu/nn/transfer.py``): each builder runs in both
packages on the same configuration, the reference's weights carried into
the port before and after the transfer; then a 5-step fit in f32 holds
the losses within rel 1e-5 of the reference's and the frozen parameters
bitwise unchanged. Mirrors ``tests/test_transfer.py``."""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

from _torch_parity import rel

torch.set_num_threads(1)

TRAJ_RTOL = 1e-5


def _carry(jn, pn):
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return pn


def _base(M, nOut=3, dropout=None, bn=False):
    b = (M.NeuralNetConfiguration.Builder().seed(42).updater(M.Adam(5e-2))
         .list().layer(M.DenseLayer(nIn=8, nOut=32, activation="relu",
                                    **({} if dropout is None
                                       else {"dropOut": dropout}))))
    if bn:
        b = b.layer(M.BatchNormalization())
    return (b.layer(M.DenseLayer(nOut=16, activation="relu"))
            .layer(M.OutputLayer(nOut=nOut, activation="softmax",
                                 lossFunction="MCXENT"))
            .setInputType(M.InputType.feedForward(8)).build())


def _cnn(M):
    return (M.NeuralNetConfiguration.Builder().seed(1).updater(M.Adam(1e-2))
            .list()
            .layer(M.ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                      stride=(1, 1)))
            .layer(M.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(M.DenseLayer(nOut=10, activation="tanh"))
            .layer(M.OutputLayer(nOut=3, activation="softmax",
                                 lossFunction="MCXENT"))
            .setInputType(M.InputType.convolutional(8, 8, 1)).build())


def _data(nIn=8, nOut=3, n=48, seed=0, cnn=False):
    rng = np.random.RandomState(seed)
    n = 24 if cnn else n
    X = (rng.rand(n, 1, 8, 8) if cnn else rng.randn(n, nIn)).astype(
        "float32")
    flat = X.reshape(n, -1)
    y = np.argmax(flat[:, :nOut], axis=1)
    return X, np.eye(nOut, dtype="float32")[y]


def _pair(conf, pre_steps=2, data=None):
    """(reference net, port net) of one configuration, the reference's
    weights carried, both trained `pre_steps` steps on the same data."""
    jn = J.MultiLayerNetwork(conf(J)).init()
    pn = _carry(jn, P.MultiLayerNetwork(conf(P), device="cpu").init())
    X, Y = data or _data()
    for _ in range(pre_steps):
        jn.fit(X, Y)
        pn.fit(X, Y)
    # start the transfer from identical weights
    return jn, _carry(jn, pn)


def _frozen_snapshot(net, idx):
    return {i: {k: t.detach().clone() for k, t in net._params[i].items()}
            for i in idx}


def _trajectory(jt, pt, X, Y, steps=5):
    jl, pl = [], []
    for _ in range(steps):
        jt.fit(X, Y)
        pt.fit(X, Y)
        jl.append(jt.score())
        pl.append(pt.score())
    return np.array(jl), np.array(pl)


_BUILDS = {
    "freeze_replace_head": (
        lambda M: _base(M),
        lambda M, net: (M.TransferLearning.Builder(net)
                        .setFeatureExtractor(1).nOutReplace(2, 5).build()),
        [0, 1], dict(nOut=5)),
    "replace_mid_layer": (
        lambda M: _base(M),
        lambda M, net: (M.TransferLearning.Builder(net)
                        .nOutReplace(1, 24).setFeatureExtractor(0).build()),
        [0], dict()),
    "remove_add_with_fine_tune": (
        lambda M: _base(M),
        lambda M, net: (M.TransferLearning.Builder(net)
                        .fineTuneConfiguration(
                            M.FineTuneConfiguration.Builder()
                            .updater(M.Sgd(5e-2)).l2(1e-4).seed(123).build())
                        .setFeatureExtractor(1).removeOutputLayer()
                        .addLayer(M.DenseLayer(nOut=12, activation="relu"))
                        .addLayer(M.OutputLayer(nOut=7, activation="softmax",
                                                lossFunction="MCXENT"))
                        .build()),
        [0, 1], dict(nOut=7)),
    "cnn_with_preprocessors": (
        lambda M: _cnn(M),
        lambda M, net: (M.TransferLearning.Builder(net)
                        .setFeatureExtractor(1).nOutReplace(3, 6).build()),
        [0], dict(nOut=6, cnn=True)),
    "frozen_bn_and_dropout": (
        lambda M: _base(M, dropout=0.5, bn=True),
        lambda M, net: (M.TransferLearning.Builder(net)
                        .setFeatureExtractor(1).build()),
        [0, 1], dict()),
}


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_transfer_builder_matches_the_reference(name):
    conf, build, frozen, dkw = _BUILDS[name]
    pre = _data(cnn=dkw.get("cnn", False))
    jn, pn = _pair(conf, data=pre)
    jt, pt = build(J, jn), build(P, pn)
    assert len(pt.layers) == len(jt.layers)
    for i, (a, b) in enumerate(zip(jt.layers, pt.layers)):
        assert getattr(a, "frozen", False) == getattr(b, "frozen", False)
    assert pt.conf.seed == jt.conf.seed
    # the grafted layers hold the original's weights
    for i in frozen:
        for k, t in pt._params[i].items():
            assert torch.equal(t, pn._params[i][k])
    _carry(jt, pt)
    snap = _frozen_snapshot(pt, frozen)
    bn_state = [{k: v.clone() for k, v in s.items()}
                for s in pt._states if s]
    X, Y = _data(nOut=dkw.get("nOut", 3), seed=1, cnn=dkw.get("cnn", False))
    jl, pl = _trajectory(jt, pt, X, Y)
    assert rel(pl, jl) <= TRAJ_RTOL, (pl, jl)
    for i, p in snap.items():
        for k, t in p.items():
            assert torch.equal(t, pt._params[i][k]), (i, k)
    # frozen BN runs in inference mode: its running statistics stay
    for before, after in zip(bn_state, [s for s in pt._states if s]):
        for k in before:
            assert torch.equal(before[k], after[k])


def test_frozen_layer_marker_and_fit():
    pn = P.MultiLayerNetwork(_base(P), device="cpu").init()
    P.FrozenLayer(pn.layers[0])
    w0 = pn._params[0]["W"].detach().clone()
    pn.fit(*_data())
    assert torch.equal(w0, pn._params[0]["W"])


def test_transferred_nets_train_independently_of_the_original():
    pn = P.MultiLayerNetwork(_base(P), device="cpu").init()
    pt = P.TransferLearning.Builder(pn).setFeatureExtractor(0).build()
    w = pn._params[1]["W"].detach().clone()
    for _ in range(3):
        pt.fit(*_data())
    assert torch.equal(w, pn._params[1]["W"])
    assert not torch.equal(w, pt._params[1]["W"])


def test_helper_featurize_and_fit_featurized_match_the_reference():
    jn, pn = _pair(lambda M: _base(M))
    jh = J.TransferLearningHelper(jn, frozenTill=1)
    ph = P.TransferLearningHelper(pn, frozenTill=1)
    X, Y = _data(seed=2)
    jf, pf = jh.featurize(JDataSet(X, Y)), ph.featurize(PDataSet(X, Y))
    assert rel(pf.getFeatures(), jf.getFeatures().toNumpy()) <= 1e-6
    # the featurized top reproduces the full forward
    np.testing.assert_allclose(
        ph.outputFromFeaturized(pf.getFeatures()).toNumpy(),
        pn.output(X).toNumpy(), rtol=2e-5, atol=2e-6)
    w0 = pn._params[0]["W"].detach().clone()
    for _ in range(5):
        jh.fitFeaturized(jf)
        ph.fitFeaturized(pf)
    assert torch.equal(w0, pn._params[0]["W"])
    want = jax.tree.map(np.asarray, jn._params)
    got = params_to_reference(pn.layers, pn._params)
    for i in (2,):
        for k in want[i]:
            assert rel(got[i][k], want[i][k]) <= TRAJ_RTOL
    assert ph.unfrozenMLN() is ph._top


def test_helper_featurizes_cnn_in_the_api_layout():
    pn = P.MultiLayerNetwork(_cnn(P), device="cpu").init()
    h = P.TransferLearningHelper(pn, frozenTill=0)
    X, Y = _data(cnn=True)
    feat = h.featurize(PDataSet(X, Y))
    assert tuple(feat.getFeatures().shape) == (24, 4, 6, 6)
    np.testing.assert_allclose(
        h.outputFromFeaturized(feat.getFeatures()).toNumpy(),
        pn.output(X).toNumpy(), rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------- GraphBuilder
def _graph(M, scale=False):
    g = (M.NeuralNetConfiguration.Builder().seed(5).updater(M.Adam(1e-2))
         .activation("tanh").graphBuilder().addInputs("in")
         .addLayer("trunk1", M.DenseLayer(nOut=12), "in"))
    if scale:
        from importlib import import_module

        SV = import_module(M.__name__ + ".conf.graph").ScaleVertex
        g = g.addVertex("scale", SV(0.5), "trunk1")
        prev = "scale"
    else:
        g = g.addLayer("trunk2", M.DenseLayer(nOut=10), "trunk1")
        prev = "trunk2"
    return (g.addLayer("head", M.OutputLayer(nOut=3, activation="softmax"),
                       prev)
            .setOutputs("head").setInputTypes(M.InputType.feedForward(6))
            .build())


def _gpair(scale=False):
    jn = J.ComputationGraph(_graph(J, scale)).init()
    pn = P.ComputationGraph(_graph(P, scale), device="cpu").init()
    _carry(jn, pn)
    return jn, pn


def _gdata(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 6).astype("float32"),
            np.eye(n, dtype="float32")[rng.randint(0, n, 16)])


_GBUILDS = {
    "replace_head": (False, lambda M, g: (
        M.TransferLearning.GraphBuilder(g).setFeatureExtractor("trunk2")
        .removeVertexKeepConnections("head")
        .addLayer("head", M.OutputLayer(nOut=5, activation="softmax"),
                  "trunk2").build()), 5, ["trunk1", "trunk2"]),
    "nout_replace": (False, lambda M, g: (
        M.TransferLearning.GraphBuilder(g).setFeatureExtractor("trunk1")
        .nOutReplace("trunk2", 20).build()), 3, ["trunk1"]),
    "through_a_vertex": (True, lambda M, g: (
        M.TransferLearning.GraphBuilder(g).nOutReplace("trunk1", 20)
        .build()), 3, []),
}


@pytest.mark.parametrize("name", sorted(_GBUILDS))
def test_graph_builder_matches_the_reference(name):
    scale, build, n, frozen = _GBUILDS[name]
    jn, pn = _gpair(scale)
    X, Y = _gdata(3, 0)
    for _ in range(3):
        jn.fit(X, Y)
        pn.fit(X, Y)
    _carry(jn, pn)
    jt, pt = build(J, jn), build(P, pn)
    for node in pt.conf.nodes.values():
        if node.kind == "layer":
            assert getattr(node.payload, "frozen", False) == \
                (node.name in frozen)
    for name_ in frozen:
        for k, t in pt._params[name_].items():
            assert torch.equal(t, pn._params[name_][k])
    _carry(jt, pt)
    snap = {f: {k: t.detach().clone() for k, t in pt._params[f].items()}
            for f in frozen}
    X, Y = _gdata(n, 1)
    jl, pl = _trajectory(jt, pt, X, Y)
    assert rel(pl, jl) <= TRAJ_RTOL, (pl, jl)
    for f, p in snap.items():
        for k, t in p.items():
            assert torch.equal(t, pt._params[f][k])
    want = jax.tree.map(np.asarray, jt._params)
    got = g_to_reference(pt.conf, pt._params)
    assert rel(got["head"]["W"], want["head"]["W"]) <= TRAJ_RTOL


def test_graph_builder_guards_as_the_reference():
    _, pn = _gpair()
    with pytest.raises(ValueError, match="removed vertex"):
        (P.TransferLearning.GraphBuilder(pn)
         .removeVertexAndConnections("trunk2").build())
    with pytest.raises(ValueError, match="setOutputs"):
        (P.TransferLearning.GraphBuilder(pn)
         .removeVertexAndConnections("head")
         .addLayer("newhead", P.OutputLayer(nOut=2, activation="softmax"),
                   "trunk2").build())
    with pytest.raises(ValueError, match="unknown layer"):
        P.TransferLearning.GraphBuilder(pn).nOutReplace("trnk1", 20)
    with pytest.raises(ValueError, match="unknown vertex"):
        P.TransferLearning.GraphBuilder(pn).setFeatureExtractor("nope")
    with pytest.raises(TypeError, match="ComputationGraph"):
        P.TransferLearning.GraphBuilder(
            P.MultiLayerNetwork(_base(P), device="cpu").init())
    with pytest.raises(ValueError, match="needs a"):
        (P.TransferLearning.GraphBuilder(pn)
         .removeVertexKeepConnections("head").build())


def test_graph_frozen_trunk_runs_no_backward():
    """Below the cut nothing requires grad: the frozen layers' params are
    cut from autograd in the loss, so their gradients never exist."""
    _, pn = _gpair()
    pt = (P.TransferLearning.GraphBuilder(pn).setFeatureExtractor("trunk2")
          .build())
    X, Y = _gdata(3, 0)
    loss, _ = pt._loss_fn(pt._params, pt._states, {"in": torch.from_numpy(X)},
                          [torch.from_numpy(Y)], None, None)
    loss.backward()
    assert pt._params["trunk1"]["W"].grad is None
    assert pt._params["trunk2"]["W"].grad is None
    assert pt._params["head"]["W"].grad is not None
