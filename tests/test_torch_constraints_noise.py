"""Port parity for the constraints, weight noise and per-parameter bias
updaters (deeplearning4j_tpu_torch/nn/conf/{constraint,weightnoise}.py,
nn/updaters.py ``BiasSplit``, the networks' update path), against the
JAX reference. Mirrors test_layers_ext.py's TestConstraints and
TestReviewRegressions and test_weightnoise.py.

The constraints norm per output unit: over every axis but the one the
layer's layout keeps its output units on, which in the port's conv
(OIHW), conv1d ([out, in, k]) and deconv ([in, out, kh, kw]) layouts is
not the last; each case holds the projection of the port's layout to
the reference's projection of its own (f64, rel 1e-12). Weight noise
runs under the reference's own draws, injected from the key's integers
(threefry and Philox never agree), and is held to the reference's
trajectory (f32: loss rel 1e-5, params rel 1e-5 + abs 1e-6); the port's
own draws are held to their moments. The biasUpdater is the port's
(the reference stores but does not apply it): held to the update rule it
names and to the reference with biasUpdater equal to the updater.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import constraint as JC
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.nn.conf import constraint as PC
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

from _torch_parity import check_net, pair, ref_key, rel

CONSTRAINTS = {
    "max": lambda M: M.MaxNormConstraint(maxNorm=0.3),
    "minmax": lambda M: M.MinMaxNormConstraint(minNorm=0.2, maxNorm=0.4,
                                               rate=0.7),
    "nonneg": lambda M: M.NonNegativeConstraint(),
    "unit": lambda M: M.UnitNormConstraint(),
}


# ----------------------------------------------------------------------
# the projections
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 4), (4,), (3, 2, 6)])
@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_projection_matches_the_reference(name, shape):
    p = np.random.default_rng(0).standard_normal(shape)
    want = np.asarray(CONSTRAINTS[name](J).apply(jnp.asarray(p)))
    got = CONSTRAINTS[name](P).apply(torch.from_numpy(p), len(shape) - 1)
    assert rel(got.numpy(), want) <= 1e-12


def _conv_layers():
    return {
        "conv2d": (P.ConvolutionLayer(nOut=5, kernelSize=(3, 2)),
                   (3, 2, 4, 5)),
        "conv1d": (P.Convolution1DLayer(nOut=5, kernelSize=3), (3, 4, 5)),
        "deconv": (P.Deconvolution2D(nOut=5, kernelSize=(2, 3)),
                   (2, 3, 4, 5)),
        "depthwise": (P.DepthwiseConvolution2D(depthMultiplier=2,
                                               kernelSize=(3, 3)),
                      (3, 3, 1, 8)),
        "capsules": (P.PrimaryCapsules(capsules=2, capsuleDimensions=3,
                                       kernelSize=(2, 2)), (2, 2, 4, 6)),
    }


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
@pytest.mark.parametrize("kind", sorted(_conv_layers()))
def test_constraints_norm_per_output_unit_in_the_port_layouts(kind, name):
    layer, shape = _conv_layers()[kind]
    w = np.random.default_rng(1).standard_normal(shape)
    want = np.asarray(CONSTRAINTS[name](J).apply(jnp.asarray(w)))
    t = layer.param_from_reference("W", torch.from_numpy(w))
    got = CONSTRAINTS[name](P).apply(t, layer.output_axis("W", t))
    out = layer.param_to_reference("W", got).numpy()
    assert rel(out, want) <= 1e-12
    if name in ("max", "unit"):
        # "all axes but the last" on the port's layout is another function
        naive = CONSTRAINTS[name](P).apply(t, t.dim() - 1)
        assert rel(layer.param_to_reference("W", naive).numpy(),
                   want) > 1e-3


def test_apply_constraints_skips_centers_and_alpha_and_biases():
    layer = P.DenseLayer(nOut=3)
    layer.constraints = [P.MaxNormConstraint(maxNorm=1e-3)]
    params = {k: torch.full((3, 3) if k == "W" else (3,), 5.0)
              for k in ("W", "b", "centers", "alpha")}
    PC.apply_constraints(layer, params)
    assert params["W"].abs().max() < 1e-2
    for k in ("b", "centers", "alpha"):
        assert torch.equal(params[k], torch.full((3,), 5.0))
    c = P.MaxNormConstraint()
    assert not c.appliesTo("centers") and not c.appliesTo("alpha")
    assert c.appliesTo("fwd.W") and not c.appliesTo("fwd.b")
    assert JC.MaxNormConstraint().appliesTo("W")


def test_constrain_chain_appends_copies():
    shared = P.MaxNormConstraint(maxNorm=1.0)
    b = (P.NeuralNetConfiguration.Builder()
         .constrainWeights(shared)
         .constrainBias(P.NonNegativeConstraint())
         .constrainAllParameters(P.UnitNormConstraint()))
    cs = b._d["constraints"]
    assert [type(c).__name__ for c in cs] == [
        "MaxNormConstraint", "NonNegativeConstraint", "UnitNormConstraint"]
    assert [(c.applyToWeights, c.applyToBiases) for c in cs] == [
        (True, False), (False, True), (True, True)]
    assert shared.applyToBiases is False and cs[0] is not shared


# ----------------------------------------------------------------------
# constraints in training
# ----------------------------------------------------------------------

def _constrained_cnn(M):
    return (M.NeuralNetConfiguration.Builder().seed(4).updater(M.Sgd(0.5))
            .constrainWeights(M.MaxNormConstraint(maxNorm=0.4))
            .constrainBias(M.NonNegativeConstraint()).list()
            .layer(M.ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                      activation="tanh"))
            .layer(M.DenseLayer(nOut=6, activation="relu"))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.convolutional(6, 6, 2)).build())


def _constrained_conv1d(M):
    return (M.NeuralNetConfiguration.Builder().seed(5).updater(M.Adam(5e-2))
            .constrainAllParameters(
                M.MinMaxNormConstraint(minNorm=0.1, maxNorm=0.5, rate=0.8))
            .list()
            .layer(M.Convolution1DLayer(nOut=4, kernelSize=3,
                                        activation="tanh"))
            .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(3, 8)).build())


def test_constraints_in_training_match_cnn():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 2, 6, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    jn, pn = check_net(_constrained_cnn, x, y, steps=4)
    w = pn._params[0]["W"].detach()
    norms = w.square().sum(dim=(1, 2, 3)).sqrt()
    assert norms.max() <= 0.4 + 1e-6
    assert (pn._params[0]["b"] >= 0).all()


def test_constraints_in_training_match_conv1d():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 8)).astype(np.float32)
    y = np.zeros((4, 2, 6), np.float32)
    y[:, 0, ::2] = 1
    y[:, 1, 1::2] = 1
    check_net(_constrained_conv1d, x, y, steps=4)


# ----------------------------------------------------------------------
# weight noise
# ----------------------------------------------------------------------

def _noisy(M, wn, bias_updater=None):
    b = (M.NeuralNetConfiguration.Builder().seed(6).updater(M.Adam(1e-2))
         .weightNoise(wn))
    if bias_updater is not None:
        b = b.biasUpdater(bias_updater)
    return (b.list()
            .layer(M.DenseLayer(nOut=5, activation="tanh"))
            .layer(M.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(M.InputType.feedForward(4)).build())


def _reference_draws(wn_ref):
    """A port ``draw`` that returns the reference's draw for the key."""
    def draw(v, key):
        k = ref_key(key)
        if hasattr(wn_ref, "p"):
            r = jax.random.bernoulli(k, wn_ref.p, tuple(v.shape))
        else:
            r = wn_ref.distribution.sample(k, tuple(v.shape), jnp.float32)
        return torch.from_numpy(np.array(r))
    return draw


@pytest.mark.parametrize("kind", ["dropconnect", "additive",
                                  "multiplicative", "bias"])
def test_weight_noise_under_the_reference_draws_matches(kind):
    def wn(M):
        return {"dropconnect": lambda: M.DropConnect(0.7),
                "additive": lambda: M.WeightNoise(
                    M.NormalDistribution(0.0, 0.1)),
                "multiplicative": lambda: M.WeightNoise(
                    M.UniformDistribution(0.8, 1.2), additive=False),
                "bias": lambda: M.DropConnect(0.6, applyToBias=True)}[kind]()

    jn, pn = pair(lambda M: _noisy(M, wn(M)))
    for layer, jl in zip(pn.layers, jn.layers):
        layer.weightNoise.draw = _reference_draws(jl.weightNoise)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    for _ in range(4):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)
    # inference stays clean
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               atol=1e-5)


def test_weight_noise_draws_and_moments():
    v = torch.ones(256, 512)
    key = StepKey(1, 2, 3)
    keep = P.DropConnect(0.7).draw(v, key)
    assert abs(keep.float().mean().item() - 0.7) < 5e-3
    assert torch.equal(keep, P.DropConnect(0.7).draw(v, key))
    assert not torch.equal(keep, P.DropConnect(0.7).draw(v, key.fold(1)))
    n = P.WeightNoise(P.NormalDistribution(0.5, 2.0)).draw(v, key)
    assert abs(n.mean().item() - 0.5) < 0.03
    assert abs(n.std().item() - 2.0) < 0.03
    u = P.WeightNoise(P.UniformDistribution(-1.0, 3.0)).draw(v, key)
    assert u.min() >= -1.0 and u.max() <= 3.0
    assert abs(u.mean().item() - 1.0) < 0.03


def test_drop_connect_one_is_identity_and_bad_probability_refused():
    p = {"W": torch.randn(3, 3)}
    assert P.DropConnect(1.0).apply(p, StepKey(0)) is p
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            P.DropConnect(bad)


def test_bias_untouched_by_default_and_builder_applies_to_every_layer():
    conf = _noisy(P, P.WeightNoise(P.NormalDistribution(0.0, 1.0)))
    assert all(l.weightNoise is not None for l in conf.layers)
    p = {"W": torch.zeros(3, 3), "b": torch.zeros(3)}
    out = conf.layers[0].weightNoise.apply(p, StepKey(1))
    assert out["W"].abs().sum() > 0 and torch.equal(out["b"], p["b"])


def test_nested_params_and_centers():
    bi = P.Bidirectional(P.LSTM(nOut=3))
    bi.mergeGlobals({})
    params, _ = bi.initialize(torch.Generator().manual_seed(0),
                              P.InputType.recurrent(2), torch.float32,
                              "cpu")
    wn = P.WeightNoise(P.NormalDistribution(0.0, 1.0))
    out = wn.apply(params, StepKey(3))
    for k in params:
        same = torch.equal(out[k], params[k])
        assert same == k.endswith(".b"), k
    centers = {"W": torch.ones(2, 2), "b": torch.ones(2),
               "centers": torch.ones(2, 2)}
    out = P.DropConnect(0.5, applyToBias=True).apply(centers, StepKey(4))
    assert torch.equal(out["centers"], centers["centers"])


# ----------------------------------------------------------------------
# the per-parameter bias updater
# ----------------------------------------------------------------------

def test_bias_updater_equal_to_the_updater_matches_the_reference():
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(8)
                .updater(M.Adam(1e-2)).biasUpdater(M.Adam(1e-2)).list()
                .layer(M.DenseLayer(nOut=5, activation="tanh"))
                .layer(M.OutputLayer(nOut=2, activation="softmax"))
                .setInputType(M.InputType.feedForward(4)).build())

    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    check_net(conf, x, y, steps=4)


def test_bias_updater_steps_the_biases_by_its_own_rule():
    def conf(bu):
        b = (P.NeuralNetConfiguration.Builder().seed(8)
             .updater(P.Adam(1e-2)))
        if bu is not None:
            b = b.biasUpdater(bu)
        return (b.list().layer(P.DenseLayer(nOut=5, activation="tanh"))
                .layer(P.OutputLayer(nOut=2, activation="softmax"))
                .setInputType(P.InputType.feedForward(4)).build())

    rng = np.random.default_rng(10)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    net = P.MultiLayerNetwork(conf(P.Sgd(0.3)), device="cpu").init()
    plain = P.MultiLayerNetwork(conf(None), device="cpu").init()
    plain.setParams(net.params())
    grads, _ = net.computeGradientAndScore(x, y)
    b0 = [p["b"].detach().clone() for p in net._params]
    w0 = [p["W"].detach().clone() for p in net._params]
    net.fit(x, y)
    plain.fit(x, y)
    for i in range(2):
        torch.testing.assert_close(net._params[i]["b"].detach(),
                                   b0[i] - 0.3 * grads[i]["b"], rtol=0,
                                   atol=1e-7)
        torch.testing.assert_close(net._params[i]["W"].detach(),
                                   plain._params[i]["W"].detach(), rtol=0,
                                   atol=0)
        assert not torch.equal(net._params[i]["W"].detach(), w0[i])
    assert set(net._upd_states[0]) == {"main", "bias"}


# ----------------------------------------------------------------------
# the bitwise block contract with all three
# ----------------------------------------------------------------------

def test_fit_dataset_blocks_bitwise_fit_with_constraints_noise_bias():
    def conf():
        return (P.NeuralNetConfiguration.Builder().seed(12)
                .updater(P.Adam(1e-2)).biasUpdater(P.Sgd(0.1))
                .weightNoise(P.DropConnect(0.8))
                .constrainWeights(P.MaxNormConstraint(maxNorm=0.5)).list()
                .layer(P.DenseLayer(nOut=6, activation="tanh"))
                .layer(P.OutputLayer(nOut=3, activation="softmax"))
                .setInputType(P.InputType.feedForward(5)).build())

    rng = np.random.default_rng(11)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    a = P.MultiLayerNetwork(conf(), device="cpu").init()
    b = copy.deepcopy(a)
    a.fit(DataSetIterator(x, y, 4))
    b.fitDataSet(DataSetIterator(x, y, 4), stepsPerSync=4)
    for pa, pb in zip(a._params, b._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a.getIterationCount() == b.getIterationCount() == 8
