"""Port parity for the variational autoencoder, the AutoEncoder and
layerwise pretraining (deeplearning4j_tpu_torch/nn/conf/variational.py,
nn/conf/layers.py AutoEncoder, MultiLayerNetwork/ComputationGraph
pretrain, pretrainLayer and reconstructionLogProbability), against the
JAX reference. Mirrors test_layers_ext.py's TestVAE and its AutoEncoder
case.

The reparameterisation noise and the AutoEncoder's corruption are drawn
by threefry in the reference and Philox in the port, so parity runs under
the reference's own draws, injected from the pretraining key's integers
(the reference's key(seed ^ 0xE1B0) folded with the iteration and the
sample). Tolerances (f32): the negative ELBO rel 1e-5, gradients rel L2
1e-4, a 4-step pretraining trajectory then 3 fit steps rel 1e-5 + abs
1e-6; reconstructionLogProbability max-abs 1e-4. The port's own draws are
held to their moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import DataSetIterator as JIterator
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.data import DataSetIterator as PIterator
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey
from deeplearning4j_tpu_torch.nn.multilayer import pretrain_key

from _torch_parity import check_grads, flat, pair, ref_key, rel


def _ref_eps(key, shape, device, dtype, n):
    return [torch.from_numpy(np.array(jax.random.normal(
        ref_key(key.fold(i)), tuple(shape), jnp.float32))).to(dtype)
        for i in range(n)]


def _inject(pn):
    for layer in pn.layers if hasattr(pn, "layers") else [
            pn.conf.nodes[n].payload for n in pn._layer_names]:
        if isinstance(layer, P.VariationalAutoencoder):
            layer.draw_eps = _ref_eps
        if isinstance(layer, P.AutoEncoder):
            layer.draw_keep = lambda x, key, lvl=layer.corruptionLevel: \
                torch.from_numpy(np.array(jax.random.bernoulli(
                    ref_key(key), 1.0 - lvl, tuple(x.shape))))


def _vae(M, dist="gaussian", samples=1, pzx="identity", below=False,
         l2=0.0):
    b = (M.NeuralNetConfiguration.Builder().seed(3).updater(M.Adam(1e-2))
         .l2(l2).list())
    if below:
        b = b.layer(M.DenseLayer(nOut=7, activation="tanh"))
    return (b.layer(M.VariationalAutoencoder(
                nOut=2, encoderLayerSizes=(5, 4), decoderLayerSizes=(4,),
                activation="tanh", pzxActivationFunction=pzx,
                reconstructionDistribution=dist, numSamples=samples))
            .layer(M.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(M.InputType.feedForward(6)).build())


def _x(seed=0, n=16, binary=False):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.random((n, 6)) > 0.5).astype(np.float32)
    return rng.standard_normal((n, 6)).astype(np.float32)


@pytest.mark.parametrize("dist,samples,pzx", [("gaussian", 1, "identity"),
                                              ("gaussian", 2, "tanh"),
                                              ("bernoulli", 1, "identity"),
                                              ("bernoulli", 3, "identity")])
def test_negative_elbo_and_gradients_match(dist, samples, pzx):
    jn, pn = pair(lambda M: _vae(M, dist, samples, pzx))
    _inject(pn)
    x = _x(1, binary=dist == "bernoulli")
    key = StepKey(7, 2)
    jv, pv = jn.layers[0], pn.layers[0]
    jl, jg = jax.value_and_grad(
        lambda p: jv.pretrain_loss(p, jnp.asarray(x), ref_key(key)))(
        jn._params[0])
    loss = pv.pretrain_loss(pn._params[0], torch.from_numpy(x), key)
    grads = torch.autograd.grad(loss, list(pn._params[0].values()))
    g = pn.layers[0]
    from deeplearning4j_tpu_torch.nn.multilayer import uncarry_layer

    pg = uncarry_layer(g, dict(zip(pn._params[0], grads)))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    check_grads(jax.tree.map(np.asarray, jg), pg, 1e-4)


@pytest.mark.parametrize("below", [False, True])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_pretrain_then_fit_trajectory_matches(dist, below):
    jn, pn = pair(lambda M: _vae(M, dist, 2, below=below))
    _inject(pn)
    x = _x(2, binary=dist == "bernoulli")
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    idx = 1 if below else 0
    jn.pretrainLayer(idx, x, epochs=4)
    pn.pretrainLayer(idx, x, epochs=4)
    assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    assert pn.getIterationCount() == jn._iteration == 4
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)
    assert pn._upd_states[idx]["m"]["pXZW"].abs().sum() > 0
    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score()) \
            + 1e-6
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)


def test_pretrain_over_an_iterator_matches():
    jn, pn = pair(lambda M: _vae(M, below=True))
    _inject(pn)
    x = _x(3, n=24)
    y = np.zeros((24, 2), np.float32)
    jn.pretrain(JIterator(x, y, 8), epochs=2)
    pn.pretrain(PIterator(x, y, 8), epochs=2)
    assert pn.getIterationCount() == 6
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)
    assert len(pn._pretrain_losses) == 6


def test_reconstruction_log_probability_matches():
    jn, pn = pair(lambda M: _vae(M, "gaussian", below=True))
    _inject(pn)
    x = _x(4, n=5)
    want = np.asarray(jn.reconstructionLogProbability(x, 4, layerIdx=1)
                      .toNumpy())
    got = pn.reconstructionLogProbability(x, 4, layerIdx=1).toNumpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="VariationalAutoencoder"):
        pn.reconstructionLogProbability(x, 2, layerIdx=0)


def test_vae_as_a_feature_layer_and_helpers():
    jn, pn = pair(lambda M: _vae(M, "bernoulli"))
    x = _x(5, binary=True)
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               atol=1e-6)
    assert pn.feedForward(x)[1].shape() == (16, 2)
    p = pn._params[0]
    rec = pn.layers[0].reconstruct(p, torch.from_numpy(x))
    want = np.asarray(jn.layers[0].reconstruct(jn._params[0],
                                               jnp.asarray(x)))
    np.testing.assert_allclose(rec.detach().numpy(), want, atol=1e-6)
    assert rec.min() >= 0 and rec.max() <= 1
    z = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pn.layers[0].generate(p, torch.from_numpy(z)).detach().numpy(),
        np.asarray(jn.layers[0].generate(jn._params[0], jnp.asarray(z))),
        atol=1e-6)


def test_supervised_fit_with_l2_runs_over_the_nested_params():
    """The reference's regularization walks a VAE's nested lists and
    raises on them; the port's flat params take l2 on every weight, the
    biases (".b" and the heads' "...B") left out."""
    pn = P.MultiLayerNetwork(_vae(P, l2=1e-3), device="cpu").init()
    x = _x(6)
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    pn.fit(x, y)
    assert np.isfinite(pn.score())
    reg = float(pn._regularization(pn._params).detach())
    want = 0.5e-3 * sum(float(t.detach().square().sum())
                        for layer in pn._params for k, t in layer.items()
                        if k.rsplit(".", 1)[-1] not in ("b",)
                        and not k.endswith("B"))
    assert abs(reg - want) <= 1e-6 * want


def test_pretraining_improves_the_elbo_with_the_ports_draws():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((64, 6)) * 0.3 + 2,
                        rng.standard_normal((64, 6)) * 0.3 - 2]).astype(
        np.float32)
    pn = P.MultiLayerNetwork(_vae(P), device="cpu").init()
    vae = pn.layers[0]
    key = StepKey(99)
    with torch.no_grad():
        l0 = float(vae.pretrain_loss(pn._params[0], torch.from_numpy(x),
                                     key))
    pn.pretrainLayer(0, x, epochs=150)
    with torch.no_grad():
        l1 = float(vae.pretrain_loss(pn._params[0], torch.from_numpy(x),
                                     key))
    assert l1 < l0 - 1.0, (l0, l1)
    eps = vae.draw_eps(pretrain_key(3, 0), (4096, 8), "cpu", torch.float32,
                       2)
    # 5 sigma at 32768 draws
    assert abs(eps[0].mean().item()) < 5 / np.sqrt(eps[0].numel())
    assert abs(eps[0].std().item() - 1.0) < 5 / np.sqrt(
        2 * eps[0].numel())
    assert not torch.equal(eps[0], eps[1])


def test_pretrain_refuses_a_layer_that_is_not_pretrainable():
    conf = (P.NeuralNetConfiguration.Builder().list()
            .layer(P.DenseLayer(nOut=4)).layer(P.OutputLayer(nOut=2))
            .setInputType(P.InputType.feedForward(3)).build())
    pn = P.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="pretrainable"):
        pn.pretrainLayer(0, np.zeros((2, 3), np.float32))
    pn.pretrain(PIterator(np.zeros((2, 3), np.float32),
                          np.zeros((2, 2), np.float32), 2))
    assert pn.getIterationCount() == 0


def _autoencoder(M, level):
    return (M.NeuralNetConfiguration.Builder().seed(4).updater(M.Sgd(0.1))
            .list()
            .layer(M.AutoEncoder(nOut=3, corruptionLevel=level,
                                 activation="sigmoid"))
            .layer(M.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(M.InputType.feedForward(6)).build())


@pytest.mark.parametrize("level", [0.0, 0.3])
def test_autoencoder_pretrain_matches(level):
    jn, pn = pair(lambda M: _autoencoder(M, level))
    _inject(pn)
    x = np.random.default_rng(7).random((16, 6)).astype(np.float32)
    jn.pretrainLayer(0, JDataSet(x, None), epochs=5)
    pn.pretrainLayer(0, PDataSet(x, None), epochs=5)
    assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)
    assert set(pn._params[0]) == {"W", "b", "vb"}


def _graph_vae(M):
    return (M.NeuralNetConfiguration.Builder().seed(5).updater(M.Adam(1e-2))
            .graphBuilder().addInputs("in")
            .addLayer("d", M.DenseLayer(nOut=7, activation="tanh"), "in")
            .addLayer("vae", M.VariationalAutoencoder(
                nOut=2, encoderLayerSizes=(5,), decoderLayerSizes=(5,),
                activation="tanh"), "d")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"),
                      "vae")
            .setOutputs("out").setInputTypes(M.InputType.feedForward(6))
            .build())


def test_graph_pretrain_matches():
    jn, pn = pair(_graph_vae, graph=True)
    _inject(pn)
    x = _x(8)
    y = np.zeros((16, 2), np.float32)
    jn.pretrain(JIterator(x, y, 8), epochs=2)
    pn.pretrain(PIterator(x, y, 8), epochs=2)
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)
    assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    with pytest.raises(ValueError, match="pretrainable"):
        pn.pretrainLayer("d", x)
