"""The CNN zoo slice on the card (``cuda`` marker): dropout draws on the
card from a generator seeded on the host (no host sync inside a
fitDataSet block, the same mask for the same key, fitDataSet bitwise
``fit`` with dropout on), the 2-d layers and the loss head on the card
against the same layers on the CPU, the s2d stem equal to the standard
one, and ``save_conv_outputs`` bitwise equal to the stock step with its
peak memory below it.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_zoo_card.py

Without a card every test skips. Tolerances: the same f64 network on
the card and on the CPU, loss rel 1e-10 and gradients rel L2 1e-9.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.nn import (
    ComputationGraph, ConvolutionLayer, Cropping2D, DataType,
    Deconvolution2D, DepthwiseConvolution2D, InputType,
    LocalResponseNormalization, MultiLayerNetwork, NeuralNetConfiguration,
    OutputLayer, SeparableConvolution2D, Sgd, SpaceToDepth, Upsampling2D,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf import dropout as D
from deeplearning4j_tpu_torch.nn.multilayer import (
    params_to_reference, sync_free_blocks,
)
from deeplearning4j_tpu_torch.zoo import ResNet50, SimpleCNN, UNet

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels behind these layers "
                    "and the card's generator exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def test_dropout_draws_on_the_card_without_a_sync(card):
    x = torch.ones(1 << 20, device=card)
    d = D.Dropout(0.7)
    key = D.step_key(3, 5).fold(1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = d.apply(x, key)
        b = d.apply(x, key)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert a.device.type == "cuda" and torch.equal(a, b)
    keep = float((a != 0).double().mean())
    assert abs(keep - 0.7) <= 5 * (0.21 / x.numel()) ** 0.5


def test_simple_cnn_fit_dataset_is_fit_with_dropout(card):
    rng = np.random.RandomState(1)
    x = rng.rand(40, 3, 48, 48).astype("float32")
    y = np.eye(10, dtype="float32")[rng.randint(0, 10, 40)]
    a = SimpleCNN(numClasses=10, seed=0, device=card).init()
    b = SimpleCNN(numClasses=10, seed=0, device=card).init()
    a.fit(DataSetIterator(x, y, 8))
    with sync_free_blocks():
        b.fitDataSet(DataSetIterator(x, y, 8), stepsPerSync=4)
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert a.score() == b.score()


def _layers_conf(layer, fmt="NCHW"):
    return (NeuralNetConfiguration.Builder().seed(5).updater(Sgd(0.1))
            .dataType(DataType.DOUBLE).list()
            .layer(ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                    convolutionMode="same",
                                    activation="tanh"))
            .layer(layer)
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.convolutional(8, 8, 2, format=fmt))
            .build())


LAYERS = {
    "lrn": lambda: LocalResponseNormalization(),
    "upsampling": lambda: Upsampling2D(size=(2, 3)),
    "zeropad": lambda: ZeroPaddingLayer(padding=(1, 0, 2, 1)),
    "cropping": lambda: Cropping2D(cropping=(1, 2)),
    "s2d": lambda: SpaceToDepth(blocks=2),
    "deconv": lambda: Deconvolution2D(nOut=3, kernelSize=(3, 3),
                                      stride=(2, 2),
                                      convolutionMode="same"),
    "depthwise": lambda: DepthwiseConvolution2D(depthMultiplier=2,
                                                kernelSize=(3, 3)),
    "separable": lambda: SeparableConvolution2D(nOut=5, kernelSize=(3, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_layer_on_the_card_matches_the_cpu(card, name, fmt):
    gpu = MultiLayerNetwork(_layers_conf(LAYERS[name](), fmt),
                            device=card).init()
    cpu = MultiLayerNetwork(_layers_conf(LAYERS[name](), fmt),
                            device="cpu").init()
    cpu.load_reference_params(params_to_reference(gpu.layers, gpu._params))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 8, 8))
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = np.eye(3)[[0, 2, 1]]
    gg, lg = gpu.computeGradientAndScore(x, y)
    gc, lc = cpu.computeGradientAndScore(x, y)
    assert abs(lg - lc) <= 1e-10 * abs(lc)
    for g, c in zip(gg, gc):
        for k in c:
            assert _rel(g[k], c[k]) <= 1e-9, k


def test_unet_trains_on_the_card(card):
    net = UNet(numClasses=1, seed=0, inputShape=(3, 32, 32),
               dataType=DataType.BFLOAT16, dataFormat="NHWC",
               device=card).init()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype("float32")).to(card)
    y = torch.from_numpy((rng.rand(4, 32, 32, 1) > 0.5).astype(
        "float32")).to(card)
    losses = []
    for _ in range(8):
        net.fit(x, y)
        losses.append(net.score())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert net.output(x).tensor().shape == (4, 32, 32, 1)


def test_s2d_stem_equals_the_standard_stem(card):
    kw = dict(numClasses=5, inputShape=(3, 64, 64), seed=0,
              dataType=DataType.DOUBLE, device=card)
    std = ResNet50(**kw).init()
    s2d = ResNet50(stemMode="space_to_depth", **kw).init()
    table = {k: v.toNumpy() for k, v in std.paramTable().items()}
    table["conv1_W"] = ResNet50.stem_weights_to_s2d(table["conv1_W"])
    s2d.setParamTable(table)
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64))
    assert _rel(s2d.output(x).tensor(), std.output(x).tensor()) <= 1e-10


def test_save_conv_outputs_is_stock_bitwise_with_less_memory(card):
    def run(policy):
        net = ResNet50(numClasses=10, inputShape=(3, 96, 96), seed=0,
                       dataType=DataType.BFLOAT16, dataFormat="NHWC",
                       checkpointPolicy=policy, device=card).init()
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.rand(16, 96, 96, 3).astype(
            "float32")).to(card, torch.bfloat16)
        y = torch.from_numpy(np.eye(10, dtype="float32")[
            rng.randint(0, 10, 16)]).to(card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = []
        for _ in range(3):
            net.fit(x, y)
            losses.append(net.score())
        peak = torch.cuda.max_memory_allocated() - base
        out = (losses, net.params().tensor().cpu(), peak)
        del net
        return out

    la, pa, peak_a = run(None)
    lb, pb, peak_b = run("save_conv_outputs")
    assert la == lb and torch.equal(pa, pb)
    assert peak_b < peak_a
