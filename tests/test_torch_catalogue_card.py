"""The rest of the layer catalogue on the card (``cuda`` marker): the
embedding's gradient is the same bit for bit from the same inputs, with
every row repeated a thousand times (an index's backward adds a row's
gradients one after another in sorted order), the time-series vertices and the CNN ->
RNN path give the CPU's answer, weight noise draws on the card without a
host sync and the same draw for the same key, the masked sequence
classifier's fitDataSet(2) is bitwise its fit, and the VAE's pretraining
step on the card in f64 is the CPU's.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_catalogue_card.py

Without a card every test skips. Tolerances: f64 on the card against f64
on the CPU, loss rel 1e-12 and gradients rel L2 1e-11; the vertices
exact.
"""

import copy

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.nn import (
    Adam, DataType, DropConnect, EmbeddingSequenceLayer, InputType,
    LastTimeStepVertex, LSTM, MultiLayerNetwork, NeuralNetConfiguration,
    OutputLayer, ReverseTimeSeriesVertex, RmsProp, RnnOutputLayer,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

pytestmark = pytest.mark.cuda

V, T, B = 300, 12, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these check the layers' kernels "
                    "and the card's generator, which exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _classifier(dtype=DataType.FLOAT):
    return (NeuralNetConfiguration.Builder().seed(1).updater(Adam(5e-3))
            .dataType(dtype).list()
            .layer(EmbeddingSequenceLayer(nIn=V, nOut=16))
            .layer(LSTM(nOut=10))
            .layer(RnnOutputLayer(nOut=2, activation="softmax",
                                  lossFunction="mcxent"))
            .setInputType(InputType.recurrent(1, T)).build())


def _reviews(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (n, T)).astype(np.float32)
    x[:, :4] = rng.integers(0, 8, (n, 4))     # repeated rows: a real sum
    lens = rng.integers(3, T + 1, n)
    fm = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    lm = np.zeros_like(fm)
    lm[np.arange(n), lens - 1] = 1
    y = np.zeros((n, 2, T), np.float32)
    y[np.arange(n), rng.integers(0, 2, n), :] = 1
    return x, y, fm, lm


def test_embedding_gradient_is_bitwise_repeatable(card):
    layer = EmbeddingSequenceLayer(nIn=V, nOut=64)
    layer.mergeGlobals({})
    W = torch.randn(V, 64, device=card, requires_grad=True)
    idx = torch.randint(0, 16, (64, 256), device=card).float()
    g = torch.randn(64, 64, 256, device=card)
    grads = []
    for _ in range(3):
        y, _ = layer.forward({"W": W}, {}, idx, False, None)
        grads.append(torch.autograd.grad(y, W, g)[0])
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], grads[2])


def test_sequence_classifier_f64_matches_the_cpu(card):
    x, y, fm, lm = _reviews()
    nets = [MultiLayerNetwork(_classifier(DataType.DOUBLE),
                              device=d).init() for d in (card, "cpu")]
    nets[0].load_reference_params(params_to_reference(nets[1].layers,
                                                      nets[1]._params))
    res = []
    for net in nets:
        t = [torch.from_numpy(a).to(net.device) for a in (x, y, fm, lm)]
        loss, _ = net._loss_fn(net._params, net._states, *t)
        ps = [p for layer in net._params for p in layer.values()]
        res.append((float(loss), torch.autograd.grad(loss, ps)))
    assert abs(res[0][0] - res[1][0]) <= 1e-12 * abs(res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert _rel(a, b) <= 1e-11


def test_fit_dataset_bitwise_fit_with_masks(card):
    x, y, fm, lm = _reviews(32, 1)
    a = MultiLayerNetwork(_classifier(), device=card).init()
    b = copy.deepcopy(a)
    a.fit(DataSetIterator(x, y, B, featuresMask=fm, labelsMask=lm))
    b.fitDataSet(DataSetIterator(x, y, B, featuresMask=fm, labelsMask=lm),
                 stepsPerSync=2)
    for pa, pb in zip(a._params, b._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k


def test_time_vertices_match_the_cpu(card):
    x = torch.randn(5, 3, 7, dtype=torch.float64)
    m = torch.tensor([[1] * 7, [1, 1, 0, 0, 0, 0, 0], [0] * 7,
                      [1] * 4 + [0] * 3, [1] + [0] * 6], dtype=torch.float64)
    for v in (ReverseTimeSeriesVertex(), LastTimeStepVertex()):
        got, _ = v.applyMasked([x.to(card)], [m.to(card)])
        want, _ = v.applyMasked([x], [m])
        assert torch.equal(got.cpu(), want)


def test_weight_noise_draws_on_the_card_without_a_sync(card):
    wn = DropConnect(0.7)
    p = {"W": torch.ones(512, 512, device=card)}
    key = StepKey(3, 4, 5)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = wn.apply(p, key)["W"]
        b = wn.apply(p, key)["W"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b)
    assert abs((a != 0).float().mean().item() - 0.7) < 0.01


def test_vae_pretrain_step_f64_matches_the_cpu(card):
    def conf():
        return (NeuralNetConfiguration.Builder().seed(2)
                .updater(RmsProp(1e-2)).dataType(DataType.DOUBLE).list()
                .layer(VariationalAutoencoder(
                    nOut=2, encoderLayerSizes=(16,), decoderLayerSizes=(16,),
                    activation="leakyrelu",
                    reconstructionDistribution="bernoulli"))
                .layer(OutputLayer(nOut=2, activation="softmax"))
                .setInputType(InputType.feedForward(10)).build())

    x = (np.random.default_rng(3).random((16, 10)) > 0.5).astype(np.float32)
    nets = [MultiLayerNetwork(conf(), device=d).init()
            for d in (card, "cpu")]
    nets[0].load_reference_params(params_to_reference(nets[1].layers,
                                                      nets[1]._params))
    for net in nets:
        f = net.layers[0].draw_eps
        net.layers[0].draw_eps = lambda k, s, d, dt, n, f=f: [
            e.to(d) for e in f(k, s, "cpu", dt, n)]
        net.pretrainLayer(0, DataSet(x, None), epochs=3)
    assert abs(nets[0].score() - nets[1].score()) <= 1e-12 * abs(
        nets[1].score())
    for k, t in nets[1]._params[0].items():
        assert _rel(nets[0]._params[0][k], t) <= 1e-11, k
