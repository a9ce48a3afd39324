"""Port parity for the capsule layers, the output layers with their own
loss and the SameDiff custom layers (deeplearning4j_tpu_torch/nn/conf/
layers.py: PrimaryCapsules, CapsuleLayer, CapsuleStrengthLayer,
CenterLossOutputLayer, OCNNOutputLayer, SameDiffLambdaLayer,
SameDiffLayer), against the JAX reference. Mirrors test_layers_ext.py's
TestCapsNet, TestCenterLoss, TestOCNNOutputLayer,
TestSameDiffCustomLayers and TestReviewRegressions.

Each sits in a small MultiLayerNetwork built in both packages with the
reference's weights carried across: loss rel 1e-5, every gradient rel L2
1e-4 (1e-3 through the capsule routing, whose softmax-of-agreement
rounds compound the products' order), outputs max-abs 1e-5, a 3-step
trajectory rel 1e-5 + abs 1e-6 (f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.nn.conf.layers import LossLayer as JLossLayer

from _torch_parity import check_net, pair


def _loss_layer(M):
    return JLossLayer if M is J else P.LossLayer


def _capsnet(M, routings=3):
    return (M.NeuralNetConfiguration.Builder().seed(3)
            .updater(M.Adam(2e-3)).list()
            .layer(M.ConvolutionLayer(nOut=6, kernelSize=(3, 3),
                                      activation="relu"))
            .layer(M.PrimaryCapsules(capsules=3, capsuleDimensions=4,
                                     kernelSize=(3, 3), stride=(2, 2)))
            .layer(M.CapsuleLayer(capsules=3, capsuleDimensions=5,
                                  routings=routings))
            .layer(M.CapsuleStrengthLayer())
            .layer(_loss_layer(M)(lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(M.InputType.convolutional(10, 9, 2)).build())


@pytest.mark.parametrize("routings", [1, 3])
def test_capsule_net_matches(routings):
    rng = np.random.default_rng(0)
    x = rng.random((3, 2, 10, 9)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 3)]
    jn, pn = check_net(lambda M: _capsnet(M, routings), x, y,
                       grad_rtol=1e-3)
    out = pn.output(x).toNumpy()
    np.testing.assert_allclose(out.sum(1), np.ones(3), rtol=1e-5)


def test_routing_iterations_change_the_output():
    a = P.MultiLayerNetwork(_capsnet(P, 1), device="cpu").init()
    b = P.MultiLayerNetwork(_capsnet(P, 3), device="cpu").init()
    b.setParams(a.params())
    x = np.random.default_rng(1).random((2, 2, 10, 9)).astype(np.float32)
    assert not np.allclose(a.output(x).toNumpy(), b.output(x).toNumpy())


def test_capsule_shapes_and_refusals():
    with pytest.raises(ValueError, match="capsule"):
        (P.NeuralNetConfiguration.Builder().list()
         .layer(P.LSTM(nOut=8))
         .layer(P.CapsuleLayer(capsules=3, capsuleDimensions=4))
         .layer(P.LossLayer(lossFunction="mse"))
         .setInputType(P.InputType.recurrent(5)).build())
    with pytest.raises(ValueError, match="convolutional"):
        P.PrimaryCapsules().getOutputType(P.InputType.feedForward(3))
    s = np.zeros((2, 4, 3), np.float32)
    s[0, :, 1] = 0.5
    got, _ = P.CapsuleStrengthLayer().forward({}, {}, torch.from_numpy(s),
                                               False, None)
    want, _ = J.CapsuleStrengthLayer().forward({}, {}, jnp.asarray(s),
                                               False, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _center_loss(M):
    return (M.NeuralNetConfiguration.Builder().seed(4)
            .updater(M.Adam(1e-2)).l2(1e-3).list()
            .layer(M.DenseLayer(nOut=5, activation="tanh"))
            .layer(M.CenterLossOutputLayer(nOut=3, activation="softmax",
                                           lossFunction="mcxent",
                                           lambda_=0.5))
            .setInputType(M.InputType.feedForward(4)).build())


def test_center_loss_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jn, pn = check_net(_center_loss, x, y, steps=4)
    assert pn.output(x).shape() == (8, 3)
    assert pn._params[1]["centers"].detach().abs().sum() > 0


def _ocnn(M, nu=0.1):
    return (M.NeuralNetConfiguration.Builder().seed(5)
            .updater(M.Adam(5e-3)).list()
            .layer(M.DenseLayer(nOut=8, activation="tanh"))
            .layer(M.OCNNOutputLayer(hiddenSize=6, nu=nu,
                                     activation="sigmoid"))
            .setInputType(M.InputType.feedForward(4)).build())


def test_ocnn_matches_and_refuses():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    y = np.zeros((20, 1), np.float32)
    check_net(_ocnn, x, y, steps=4)
    for M in (J, P):
        with pytest.raises(ValueError, match="nu"):
            M.OCNNOutputLayer(nu=0.0)
        with pytest.raises(ValueError, match="nOut=1"):
            M.OCNNOutputLayer(nOut=2)


def test_regularization_skips_centers_and_alpha():
    for layer in (P.CenterLossOutputLayer(nOut=3), P.PReLULayer()):
        layer.l2, layer.l1 = 1.0, 1.0
        params = {"W": torch.ones(2, 2), "centers": torch.full((3, 2), 9.0),
                  "alpha": torch.full((2,), 9.0)}
        assert float(layer.regularization(params)) == 2.0 + 4.0


def _lambda(M):
    return (M.NeuralNetConfiguration.Builder().seed(1).updater(M.Adam(1e-2))
            .list()
            .layer(M.DenseLayer(nOut=8, activation="identity"))
            .layer(M.SameDiffLambdaLayer(
                lambdaFn=lambda sd, x: sd.math.mul(x, sd.nn.sigmoid(x))))
            .layer(M.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(M.InputType.feedForward(4)).build())


def test_lambda_layer_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    check_net(_lambda, x, y)


def _dense_class(M):
    class MyDense(M.SameDiffLayer):
        def __init__(self, nOut, **kw):
            super().__init__(**kw)
            self.nOut = nOut

        def defineParameters(self, inputType):
            return {"W": (inputType.size, self.nOut), "b": (self.nOut,)}

        def defineLayer(self, sd, x, p):
            return sd.math.tanh(sd.nn.linear(x, p["W"], p["b"]))

    return MyDense


def test_samediff_layer_matches_and_equals_the_builtin_dense():
    def conf(M, custom=True):
        return (M.NeuralNetConfiguration.Builder().seed(5)
                .updater(M.Adam(5e-2)).list()
                .layer(_dense_class(M)(nOut=6) if custom else
                       M.DenseLayer(nOut=6, activation="tanh"))
                .layer(M.OutputLayer(nOut=2, activation="softmax"))
                .setInputType(M.InputType.feedForward(4)).build())

    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    jn, pn = check_net(conf, x, y)
    builtin = P.MultiLayerNetwork(conf(P, False), device="cpu").init()
    builtin.setParams(pn.params())
    np.testing.assert_allclose(builtin.output(x).toNumpy(),
                               pn.output(x).toNumpy(), atol=1e-6)


def test_samediff_output_types_and_train_mode():
    from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

    l = P.SameDiffLambdaLayer(
        lambdaFn=lambda sd, x: sd.math.mean(x, 2, keepDims=True))
    out = l.getOutputType(P.InputType.recurrent(6, 10))
    assert out.kind == P.InputType.RNN and out.size == 6
    # a 4-d activation reaches the expression NHWC, as the reference's
    c = P.SameDiffLambdaLayer(lambdaFn=lambda sd, x: sd.math.mean(
        x, 3, keepDims=True))
    it = c.getOutputType(P.InputType.convolutional(5, 4, 3))
    jt = J.SameDiffLambdaLayer(lambdaFn=lambda sd, x: sd.math.mean(
        x, 3, keepDims=True)).getOutputType(
        J.InputType.convolutional(5, 4, 3))
    assert it.dims == jt.dims
    d = P.SameDiffLambdaLayer(lambdaFn=lambda sd, x: sd.nn.dropout(x, 0.5))
    x = torch.ones(4, 6)
    ev, _ = d.forward({}, {}, x, False, None)
    assert torch.equal(ev, x)
    tr, _ = d.forward({}, {}, x, True, StepKey(0))
    assert (tr == 0).any() and (tr == 2.0).any()
