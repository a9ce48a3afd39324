"""Port parity for the 1-d, locally connected and small utility layers
(deeplearning4j_tpu_torch/nn/conf/layers.py: Convolution1DLayer over
ops/conv.py conv1d, Subsampling1DLayer, Upsampling1D, Cropping1D,
ZeroPadding1DLayer, RepeatVector, LocallyConnected1D/2D, PReLULayer,
ElementWiseMultiplicationLayer, SpaceToBatch), against the JAX
reference. Mirrors test_layers_ext.py's TestSpatialReshaping (but the
3-d cases), TestLocallyConnected, TestPReLU and TestSmallUtilityLayers.

Each layer sits in a small MultiLayerNetwork built in both packages, the
reference's weights carried across: loss rel 1e-5, every gradient rel L2
1e-4, the output max-abs 1e-5 and a 3-step trajectory rel 1e-5 + abs
1e-6 (f32). The ops alone, f64: rel 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.autodiff.ops_impl import OPS as JOPS
from deeplearning4j_tpu.ops import conv as jconv
from deeplearning4j_tpu_torch.ops import conv as pconv

from _torch_parity import check_net, rel

B, C, T = 3, 4, 10


@pytest.mark.parametrize("k,s,p,d", [(3, 1, 0, 1), (3, 2, 1, 1),
                                     (2, 1, "SAME", 1), (3, 3, "SAME", 2),
                                     (4, 2, 2, 1)])
def test_conv1d_matches(k, s, p, d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3))               # NWC
    w = rng.standard_normal((k, 3, 5))               # WIO
    b = rng.standard_normal(5)
    pad = "SAME" if p == "SAME" else ((p, p),)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), s, pad, d))
    layer = P.Convolution1DLayer(nOut=5, kernelSize=k)
    got = pconv.conv1d(torch.from_numpy(x).transpose(1, 2),
                       layer.param_from_reference("W", torch.from_numpy(w)),
                       torch.from_numpy(b), s, pad, d).transpose(1, 2)
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= 1e-12


def test_space_to_batch_matches():
    x = np.random.default_rng(1).standard_normal((2, 6, 4, 3))
    for pad in (((0, 0), (0, 0)), ((1, 1), (0, 2))):
        want = np.asarray(JOPS["spaceToBatch"](jnp.asarray(x), blockSize=2,
                                               padding=pad))
        got = pconv.space_to_batch(torch.from_numpy(x), 2, pad).numpy()
        np.testing.assert_array_equal(got, want)


def _seq_layers(M, name):
    return {
        "conv1d": M.Convolution1DLayer(nOut=5, kernelSize=3,
                                       activation="tanh"),
        "conv1d_same": M.Convolution1DLayer(nOut=5, kernelSize=4, stride=2,
                                            convolutionMode="same",
                                            dilation=1),
        "conv1d_pad": M.Convolution1DLayer(nOut=3, kernelSize=3, padding=2,
                                           dilation=2, activation="relu"),
        "sub1d_max": M.Subsampling1DLayer(poolingType="max", kernelSize=3,
                                          stride=2, padding=1),
        "sub1d_avg": M.Subsampling1DLayer(poolingType="avg", kernelSize=2,
                                          stride=2),
        "up1d": M.Upsampling1D(size=3),
        "crop1d": M.Cropping1D(cropping=(2, 1)),
        "zpad1d": M.ZeroPadding1DLayer(padding=(1, 3)),
        "lc1d": M.LocallyConnected1D(nOut=4, kernelSize=3, stride=2,
                                     padding=1, activation="tanh"),
        "prelu_rnn": M.PReLULayer(alphaInit=0.3),
    }[name]


SEQ = ["conv1d", "conv1d_same", "conv1d_pad", "sub1d_max", "sub1d_avg",
       "up1d", "crop1d", "zpad1d", "lc1d", "prelu_rnn"]


@pytest.mark.parametrize("name", SEQ)
def test_sequence_layer_in_a_network_matches(name):
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(21)
                .updater(M.Adam(1e-2)).list()
                .layer(M.Convolution1DLayer(nOut=C, kernelSize=1,
                                            activation="tanh"))
                .layer(_seq_layers(M, name))
                .layer(M.GlobalPoolingLayer(poolingType="avg"))
                .layer(M.OutputLayer(nOut=3, activation="softmax"))
                .setInputType(M.InputType.recurrent(2, T)).build())

    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 2, T)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    jn, pn = check_net(conf, x, y)
    jt, pt = jn.conf.layerInputTypes[2], pn.conf.layerInputTypes[2]
    assert (pt.kind, pt.dims) == (jt.kind, jt.dims)


def _cnn_layers(M, name):
    return {
        "lc2d": M.LocallyConnected2D(nOut=3, kernelSize=(3, 2),
                                     stride=(2, 1), padding=(1, 0),
                                     activation="tanh"),
        "prelu_cnn": M.PReLULayer(alphaInit=0.2),
        "prelu_shared": M.PReLULayer(sharedAxes=(2, 3), alphaInit=0.1),
        "prelu_shared_c": M.PReLULayer(sharedAxes=(1,), alphaInit=0.1),
        "s2b": M.SpaceToBatch(blocks=2),
    }[name]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", ["lc2d", "prelu_cnn", "prelu_shared",
                                  "prelu_shared_c"])
def test_cnn_layer_in_a_network_matches(name, fmt):
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(22)
                .updater(M.Adam(1e-2)).list()
                .layer(M.ConvolutionLayer(nOut=C, kernelSize=(3, 3),
                                          convolutionMode="same",
                                          activation="identity"))
                .layer(_cnn_layers(M, name))
                .layer(M.OutputLayer(nOut=3, activation="softmax"))
                .setInputType(M.InputType.convolutional(6, 5, 2,
                                                        format=fmt))
                .build())

    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 2, 6, 5)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    check_net(conf, x, y)


def test_space_to_batch_layer_forward_matches():
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 6)).astype(
        np.float32)
    for pad in (((0, 0), (0, 0)), ((1, 1), (1, 1))):
        pl = P.SpaceToBatch(blocks=2, padding=pad)
        jl = J.SpaceToBatch(blocks=2, padding=pad)
        got, _ = pl.forward({}, {}, torch.from_numpy(x), False, None)
        want, _ = jl.forward({}, {}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             False, None)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
        it = pl.getOutputType(P.InputType.convolutional(4, 6, 3))
        jt = jl.getOutputType(J.InputType.convolutional(4, 6, 3))
        assert it.dims == jt.dims
    with pytest.raises(ValueError, match="divide"):
        P.SpaceToBatch(blocks=4).getOutputType(
            P.InputType.convolutional(6, 6, 1))


@pytest.mark.parametrize("name", ["repeat", "ewm", "prelu_ff", "ewm_act"])
def test_feed_forward_utility_layers_match(name):
    def conf(M):
        layer = {"repeat": M.RepeatVector(n=4),
                 "ewm": M.ElementWiseMultiplicationLayer(nOut=5),
                 "ewm_act": M.ElementWiseMultiplicationLayer(
                     activation="tanh"),
                 "prelu_ff": M.PReLULayer(alphaInit=0.25)}[name]
        b = (M.NeuralNetConfiguration.Builder().seed(23)
             .updater(M.Adam(2e-2)).list()
             .layer(M.DenseLayer(nOut=5, activation="identity"))
             .layer(layer))
        if name == "repeat":
            b = b.layer(M.LSTM(nOut=3)).layer(
                M.RnnOutputLayer(nOut=2, activation="softmax",
                                 lossFunction="mcxent"))
        else:
            b = b.layer(M.OutputLayer(nOut=2, activation="softmax"))
        return b.setInputType(M.InputType.feedForward(4)).build()

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    if name == "repeat":
        y = np.zeros((6, 2, 4), np.float32)
        y[:, 0, ::2] = y[:, 1, 1::2] = 1
    else:
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    jn, pn = check_net(conf, x, y)
    if name.startswith("ewm"):
        assert not np.allclose(pn.getParam("1_W").toNumpy(), 1.0)


def test_width_and_length_refusals():
    with pytest.raises(ValueError, match="nIn == nOut"):
        P.ElementWiseMultiplicationLayer(nOut=3).getOutputType(
            P.InputType.feedForward(5))
    with pytest.raises(ValueError, match="fixed"):
        P.LocallyConnected1D(nOut=2).getOutputType(
            P.InputType.recurrent(3))
    with pytest.raises(ValueError, match="truncate"):
        P.LocallyConnected2D(nOut=2, convolutionMode="same")


def test_lc2d_equals_a_convolution_when_the_weights_are_shared():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 6, 6))
    k = rng.standard_normal((3, 3, 3, 4))            # HWIO
    layer = P.LocallyConnected2D(nOut=4, kernelSize=(3, 3), hasBias=False)
    layer.mergeGlobals({})
    layer.initialize(torch.Generator(), P.InputType.convolutional(6, 6, 3),
                     torch.float64, "cpu")
    W = torch.from_numpy(np.broadcast_to(k.reshape(1, 1, 27, 4),
                                         (4, 4, 27, 4)).copy())
    got, _ = layer.forward({"W": W}, {}, torch.from_numpy(x), False, None)
    want = pconv.conv2d(torch.from_numpy(x), torch.from_numpy(
        k.transpose(3, 2, 0, 1).copy()))
    assert rel(got.numpy(), want.numpy()) <= 1e-12
