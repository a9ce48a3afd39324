"""Port parity for the 3-d CNN family (deeplearning4j_tpu_torch/nn/conf/
layers.py: Convolution3D, Deconvolution3D, Subsampling3DLayer,
Upsampling3D, Cropping3D, ZeroPadding3D; GlobalPoolingLayer and
PReLULayer over 3-d input; ops/conv.py deconv3d, ops/pooling.py
max_pool3d/avg_pool3d) against the JAX reference. Mirrors
tests/test_layers_3d_misc.py's Test3DLayers and the 3-d cases of
tests/test_layers_ext.py.

The reference keeps 3-d activations NDHWC and kernels DHWIO; the port
NCDHW and OIDHW, so its activations are compared through a permute.
Networks are built in both packages, the reference's parameters
carried into the port, on seeded numpy inputs. f64 networks: loss rel
1e-10, gradients rel L2 1e-9, outputs within 1e-10 of the max-abs; f32
ops and their input gradients within 1e-5 of the max-abs. The port's
flatten of a 3-d activation into a dense layer reads [D, H, W, C] (the
reference refuses a dense layer after a 3-d one), which is Keras's
order and a reshape of the reference's NDHWC activation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.ndarray import DataType as JDataType
from deeplearning4j_tpu.ops import conv as jconv
from deeplearning4j_tpu.ops import pooling as jpool
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSer
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.ndarray.dtype import DataType as PDataType
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
from deeplearning4j_tpu_torch.ops import conv as pconv
from deeplearning4j_tpu_torch.ops import pooling as ppool
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer as PSer

torch.set_num_threads(2)
CPU = "cpu"


def _ndhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 4, 1)


def _net(M, layers, inputType, seed=7, dtype="DOUBLE", head=True,
         updater=None):
    b = (M.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater or M.Sgd(0.1))
         .dataType(getattr(JDataType if M is J else PDataType, dtype)))
    lb = b.list()
    for layer in layers(M):
        lb = lb.layer(layer)
    if head:
        lb = lb.layer(M.GlobalPoolingLayer(poolingType="avg")).layer(
            M.OutputLayer(nOut=3, activation="softmax"))
    conf = lb.setInputType(inputType(M)).build()
    return conf


def _pair(layers, inputType, **kw):
    jn = J.MultiLayerNetwork(_net(J, layers, inputType, **kw)).init()
    pn = P.MultiLayerNetwork(_net(P, layers, inputType, **kw),
                             device=CPU).init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def _check_net(jn, pn, x, y):
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-10 * abs(js)
    for want, got in zip(jg, params_to_reference(pn.layers, pg)):
        for k in want:
            w = np.asarray(want[k])
            assert np.linalg.norm(got[k] - w) <= 1e-9 * np.linalg.norm(w), k
    want = np.asarray(jn.output(x).toNumpy())
    np.testing.assert_allclose(pn.output(x).toNumpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def _xy(shape, seed=0, classes=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    return x, np.eye(classes)[rng.randint(0, classes, shape[0])]


LAYER_CASES = {
    "conv3d": (lambda M: [M.Convolution3D(nOut=4, kernelSize=(2, 2, 2),
                                          activation="relu")],
               (2, 5, 6, 7)),
    "conv3d_same_strided": (lambda M: [M.Convolution3D(
        nOut=3, kernelSize=(3, 2, 3), stride=(2, 1, 2),
        convolutionMode="same", activation="tanh")], (2, 5, 6, 7)),
    "conv3d_padded_dilated": (lambda M: [M.Convolution3D(
        nOut=3, kernelSize=(2, 2, 2), padding=(1, 0, 1), dilation=(1, 2, 1),
        activation="tanh")], (1, 4, 6, 5)),
    "deconv3d": (lambda M: [M.Convolution3D(nOut=4, kernelSize=2, stride=2),
                            M.Deconvolution3D(nOut=2, kernelSize=2,
                                              stride=2)], (2, 6, 6, 6)),
    "deconv3d_padded": (lambda M: [M.Deconvolution3D(
        nOut=2, kernelSize=(3, 2, 3), stride=(2, 2, 1), padding=(1, 0, 1),
        activation="tanh")], (2, 3, 4, 3)),
    "deconv3d_same": (lambda M: [M.Deconvolution3D(
        nOut=2, kernelSize=(3, 3, 2), stride=(2, 1, 2),
        convolutionMode="same")], (2, 3, 4, 3)),
    "maxpool3d": (lambda M: [M.Subsampling3DLayer(poolingType="max",
                                                  kernelSize=2, stride=2)],
                  (2, 6, 6, 6)),
    "avgpool3d_padded": (lambda M: [M.Subsampling3DLayer(
        poolingType="avg", kernelSize=(3, 2, 3), stride=(2, 2, 1),
        padding=(1, 0, 1))], (2, 5, 4, 5)),
    "avgpool3d_same": (lambda M: [M.Subsampling3DLayer(
        poolingType="avg", kernelSize=3, stride=2,
        convolutionMode="same")], (2, 5, 4, 5)),
    "maxpool3d_same": (lambda M: [M.Subsampling3DLayer(
        poolingType="max", kernelSize=(1, 2, 2), stride=(1, 2, 2),
        convolutionMode="same")], (2, 4, 5, 5)),
    "upsampling3d": (lambda M: [M.Upsampling3D((2, 1, 3)),
                                M.Convolution3D(nOut=2, kernelSize=2)],
                     (1, 2, 3, 4)),
    "cropping3d": (lambda M: [M.Cropping3D((1, 0, 1, 1, 0, 2)),
                              M.Convolution3D(nOut=2, kernelSize=2)],
                   (2, 4, 5, 6)),
    "zeropad3d": (lambda M: [M.ZeroPadding3D(padding=(1, 2, 0)),
                             M.Convolution3D(nOut=2, kernelSize=2)],
                  (2, 4, 4, 4)),
    "prelu3d": (lambda M: [M.Convolution3D(nOut=2, kernelSize=2),
                           M.PReLULayer(alphaInit=0.25)], (2, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_3d_layer_in_a_network_matches_the_reference(case):
    layers, (c, d, h, w) = LAYER_CASES[case]
    jn, pn = _pair(layers, lambda M: M.InputType.convolutional3D(d, h, w, c))
    x, y = _xy((3, c, d, h, w))
    _check_net(jn, pn, x, y)


@pytest.mark.parametrize("pooling", ["avg", "max", "sum", "pnorm"])
def test_global_pooling_over_3d_input(pooling):
    def layers(M):
        return [M.Convolution3D(nOut=4, kernelSize=2, activation="tanh"),
                M.GlobalPoolingLayer(poolingType=pooling),
                M.OutputLayer(nOut=3, activation="softmax")]
    jn, pn = _pair(layers, lambda M: M.InputType.convolutional3D(3, 4, 5, 2),
                   head=False)
    _check_net(jn, pn, *_xy((2, 2, 3, 4, 5)))


def test_global_pooling_keeps_dims_over_3d_input():
    layer = P.GlobalPoolingLayer(poolingType="max", collapseDimensions=False)
    it = layer.getOutputType(P.InputType.convolutional3D(2, 3, 4, 5))
    assert it == P.InputType.convolutional3D(1, 1, 1, 5)
    x = torch.randn(2, 5, 2, 3, 4, dtype=torch.float64)
    y, _ = layer.forward({}, {}, x, False, None)
    assert tuple(y.shape) == (2, 5, 1, 1, 1)
    np.testing.assert_allclose(y.numpy()[:, :, 0, 0, 0],
                               x.numpy().max(axis=(2, 3, 4)))


def test_3d_layers_shapes_and_oracles():
    """Test3DLayers: pooled shapes and the reshape oracle, zero padding's
    content, deconvolution restoring the conv's shape (NDHWC views of
    the port's activations)."""
    net = P.MultiLayerNetwork(_net(P, lambda M: [M.Subsampling3DLayer(
        poolingType="max", kernelSize=2, stride=2)],
        lambda M: M.InputType.convolutional3D(6, 6, 6, 2), dtype="FLOAT"),
        device=CPU).init()
    x = np.random.RandomState(0).rand(2, 2, 6, 6, 6).astype(np.float32)
    acts = net.feedForward(x)
    pooled, xi = _ndhwc(acts[1].toNumpy()), _ndhwc(acts[0].toNumpy())
    assert pooled.shape == (2, 3, 3, 3, 2)
    np.testing.assert_allclose(
        pooled, xi.reshape(2, 3, 2, 3, 2, 3, 2, 2).max((2, 4, 6)), atol=1e-6)
    net = P.MultiLayerNetwork(_net(P, lambda M: [M.ZeroPadding3D(
        padding=(1, 2, 0))], lambda M: M.InputType.convolutional3D(4, 4, 4, 2),
        dtype="FLOAT"), device=CPU).init()
    x = np.random.RandomState(1).rand(1, 2, 4, 4, 4).astype(np.float32)
    acts = net.feedForward(x)
    padded = _ndhwc(acts[1].toNumpy())
    assert padded.shape == (1, 6, 8, 4, 2)
    assert padded[0, 0].sum() == 0 and padded[0, -1].sum() == 0
    np.testing.assert_allclose(padded[0, 1:-1, 2:-2], _ndhwc(x)[0])


def test_deconv3d_inverts_conv_shape_and_trains():
    conf = _net(P, lambda M: [M.Convolution3D(nOut=4, kernelSize=2, stride=2),
                              M.Deconvolution3D(nOut=2, kernelSize=2,
                                                stride=2)],
                lambda M: M.InputType.convolutional3D(6, 6, 6, 2),
                dtype="FLOAT", updater=P.Adam(1e-3), seed=1)
    net = P.MultiLayerNetwork(conf, device=CPU).init()
    x = np.random.RandomState(2).rand(2, 2, 6, 6, 6).astype(np.float32)
    acts = net.feedForward(x)
    assert tuple(acts[1].shape()) == (2, 4, 3, 3, 3)
    assert tuple(acts[2].shape()) == (2, 2, 6, 6, 6)
    y = np.eye(3, dtype=np.float32)[np.random.RandomState(3).randint(0, 3, 2)]
    losses = []
    for _ in range(10):
        net.fit(x, y)
        losses.append(net.score())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_conv3d_gradcheck():
    """test_layers_ext TestConv3D.test_gradcheck: a central difference of
    the port's f64 loss against its gradient."""
    conf = _net(P, lambda M: [M.Convolution3D(nOut=2, kernelSize=(2, 2, 2),
                                              activation="tanh")],
                lambda M: M.InputType.convolutional3D(3, 3, 3, 1))
    net = P.MultiLayerNetwork(conf, device=CPU).init()
    x, y = _xy((2, 1, 3, 3, 3), classes=3)
    grads, _ = net.computeGradientAndScore(x, y)
    W = net._params[0]["W"]
    idx, eps = (1, 0, 0, 1, 0), 1e-6
    losses = []
    for sgn in (1, -1):
        with torch.no_grad():
            W[idx] += sgn * eps
        losses.append(net.computeGradientAndScore(x, y)[1])
        with torch.no_grad():
            W[idx] -= sgn * eps
    fd = (losses[0] - losses[1]) / (2 * eps)
    np.testing.assert_allclose(float(grads[0]["W"][idx]), fd, rtol=1e-4,
                               atol=1e-7)


def _ops_input(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("k,s,pad,count", [
    ((2, 2, 2), (2, 2, 2), ((0, 0),) * 3, True),
    ((3, 2, 3), (2, 1, 2), ((1, 1), (0, 1), (1, 0)), True),
    ((3, 2, 3), (2, 1, 2), ((1, 1), (0, 1), (1, 0)), False),
    ((3, 3, 3), (2, 2, 2), "SAME", True),
])
def test_pool3d_ops_and_gradients_match_the_reference(k, s, pad, count):
    """max_pool3d and avg_pool3d (with and without count_include_pad) in
    f32, and their input gradients under a seeded cotangent."""
    x = _ops_input((2, 5, 6, 7, 3), 0)            # NDHWC
    xt = torch.tensor(x.transpose(0, 4, 1, 2, 3), requires_grad=True)
    for name in ("max", "avg"):
        if name == "max":
            jf = lambda a: jpool.max_pool3d(a, k, s, pad)
            pf = lambda a: ppool.max_pool3d(a, k, s, pad)
        else:
            jf = lambda a: jpool.avg_pool3d(a, k, s, pad, count)
            pf = lambda a: ppool.avg_pool3d(a, k, s, pad, count)
        want, vjp = jax.vjp(jf, jnp.asarray(x))
        got = pf(xt)
        np.testing.assert_allclose(_ndhwc(got.detach()), np.asarray(want),
                                   rtol=0, atol=1e-5 * np.abs(want).max())
        ct = _ops_input(want.shape, 1)
        (jg,) = vjp(jnp.asarray(ct))
        (pg,) = torch.autograd.grad(
            got, xt, torch.tensor(ct.transpose(0, 4, 1, 2, 3)))
        np.testing.assert_allclose(_ndhwc(pg), np.asarray(jg), rtol=0,
                                   atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("mode,pad", [("truncate", (0, 1, 2)),
                                      ("same", (0, 0, 0))])
def test_deconv3d_op_matches_the_reference(mode, pad):
    k, s, d = (3, 2, 3), (2, 2, 1), (1, 1, 2)
    x = _ops_input((2, 3, 4, 5, 3), 2)            # NDHWC
    w = _ops_input(k + (3, 4), 3)                 # DHWIO, forward layout
    b = _ops_input((4,), 4)
    jp = jconv.deconv3d_explicit_padding(mode, pad, k, d)
    pp = pconv.deconv3d_explicit_padding(mode, pad, k, d)
    assert jp == pp
    want = np.asarray(jconv.deconv3d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), s, jp, d))
    layer = P.Deconvolution3D(nOut=4, kernelSize=k)
    wt = layer.param_from_reference("W", torch.tensor(w))
    got = pconv.deconv3d(torch.tensor(x.transpose(0, 4, 1, 2, 3)), wt,
                         torch.tensor(b), s, pp, d)
    np.testing.assert_allclose(_ndhwc(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(layer.param_to_reference("W", wt).numpy(),
                                  w)


def test_dense_after_3d_flattens_in_dhwc_order():
    """A dense layer after a 3-d conv reads the activation flattened in
    [D, H, W, C] order: the reference's NDHWC activation reshaped."""
    conf = _net(P, lambda M: [M.Convolution3D(nOut=3, kernelSize=2),
                              M.DenseLayer(nOut=4, activation="identity")],
                lambda M: M.InputType.convolutional3D(3, 3, 4, 2),
                head=False)
    net = P.MultiLayerNetwork(conf, device=CPU).init()
    assert type(conf.preprocessors[1]).__name__ == \
        "Cnn3DToFeedForwardPreProcessor"
    x = np.random.RandomState(0).randn(2, 2, 3, 3, 4)
    acts = net.feedForward(x)
    conv = _ndhwc(acts[1].toNumpy()).reshape(2, -1)
    p = net._params[1]
    want = conv @ p["W"].detach().numpy() + p["b"].detach().numpy()
    np.testing.assert_allclose(acts[2].toNumpy(), want, rtol=1e-12)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_3d_model_file_crosses_both_packages(writer, tmp_path):
    layers = LAYER_CASES["deconv3d"][0]
    jn, pn = _pair(lambda M: layers(M) + [M.PReLULayer()],
                   lambda M: M.InputType.convolutional3D(6, 6, 6, 2),
                   dtype="FLOAT")
    x = np.random.RandomState(4).rand(2, 2, 6, 6, 6).astype(np.float32)
    want = np.asarray(jn.output(x).toNumpy())
    path = str(tmp_path / "net3d.zip")
    if writer == "reference":
        JSer.writeModel(jn, path)
        got = PSer.restoreMultiLayerNetwork(path, device=CPU).output(
            x).toNumpy()
    else:
        PSer.writeModel(pn, path)
        got = np.asarray(JSer.restoreMultiLayerNetwork(path).output(
            x).toNumpy())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_prelu_3d_refuses_shared_axes():
    with pytest.raises(ValueError, match="3D input"):
        P.MultiLayerNetwork(_net(P, lambda M: [M.PReLULayer(sharedAxes=(1,))],
                                 lambda M: M.InputType.convolutional3D(
                                     2, 2, 2, 1)), device=CPU).init()
