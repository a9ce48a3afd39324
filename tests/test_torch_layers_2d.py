"""Port parity for the 2-d layers of the CNN-zoo slice
(deeplearning4j_tpu_torch/nn/conf/layers.py, ops/{norm,pooling,conv}.py):
LocalResponseNormalization, Upsampling2D, ZeroPaddingLayer, Cropping2D,
SpaceToDepth, Deconvolution2D, DepthwiseConvolution2D,
SeparableConvolution2D, DropoutLayer (inference), LossLayer,
CnnLossLayer (fit, output, score and per-pixel evaluate) and RnnLossLayer,
against the JAX reference.

Each layer sits in a small MultiLayerNetwork built in both packages (a
convolution before it, so its backward carries a gradient, and a dense
output after it, fed through the flatten preprocessor, so every spatial
position and channel order counts), the reference's parameters carried
into the port, seeded numpy inputs fed NCHW and NHWC. Held: the loss,
every parameter's gradient, the output; the layer's output type.
Tolerances (f32): loss rel 1e-5, gradients rel L2 1e-4, outputs max-abs
1e-5 (the convolutions sum in another order). The ops alone, f64: rel
1e-12 against the reference's functions and hand-written oracles (LRN's
window sum with alpha NOT divided by n, SpaceToDepth's (s, t, c) channel
order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.autodiff.ops_impl import OPS as JOPS
from deeplearning4j_tpu.ops import conv as jconv
from deeplearning4j_tpu.ops import norm as jnorm
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
from deeplearning4j_tpu_torch.ops import conv as pconv
from deeplearning4j_tpu_torch.ops import norm as pnorm

torch.set_num_threads(1)
B, C, H, W = 3, 4, 8, 8
CLASSES = 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ----------------------------------------------------------------------
# the ops alone
# ----------------------------------------------------------------------

def test_lrn_sums_the_window_and_does_not_divide_alpha_by_n():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 3))
    k, n, alpha, beta = 2.0, 5, 0.3, 0.75
    got = pnorm.lrn(torch.from_numpy(x), k, n, alpha, beta).numpy()
    sq = np.pad(x ** 2, ((0, 0), (2, 2), (0, 0), (0, 0)))
    s = sum(sq[:, i:i + 7] for i in range(n))
    want = x / (k + alpha * s) ** beta
    assert _rel(got, want) <= 1e-12
    ref = np.asarray(jnorm.lrn(jnp.asarray(np.moveaxis(x, 1, -1)), k, n,
                               alpha, beta))
    assert _rel(got, np.moveaxis(ref, -1, 1)) <= 1e-12
    # torch's local_response_norm averages the window: another function
    other = F.local_response_norm(torch.from_numpy(x), n, alpha, beta,
                                  k).numpy()
    assert _rel(other, want) > 1e-2


def test_space_to_depth_channel_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float64).reshape(2, 4, 6, 3)
    got = pconv.space_to_depth(torch.from_numpy(x), 2).numpy()
    # output channel (s*b + t)*C + c holds pixel (2i+s, 2j+t), channel c
    for s in range(2):
        for t in range(2):
            for c in range(3):
                np.testing.assert_array_equal(
                    got[:, :, :, (s * 2 + t) * 3 + c], x[:, s::2, t::2, c])
    np.testing.assert_array_equal(
        got, np.asarray(JOPS["spaceToDepth"](jnp.asarray(x), blockSize=2)))
    # pixel_unshuffle orders channels c*b*b + s*b + t: another layout
    pu = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert not np.array_equal(pu.permute(0, 2, 3, 1).numpy(), got)
    back = pconv.depth_to_space(torch.from_numpy(got), 2).numpy()
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("mode,k,s,p,d", [
    ("truncate", 3, 2, 0, 1), ("truncate", 4, 2, 1, 1),
    ("truncate", 3, 1, 1, 2), ("same", 3, 2, 0, 1), ("same", 2, 3, 0, 1),
    ("same", 4, 2, 0, 1), ("same", 5, 1, 0, 1)])
def test_deconv2d_matches_conv_transpose(mode, k, s, p, d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 3))            # NHWC
    w = rng.standard_normal((k, k, 3, 4))            # HWIO, unflipped
    pad = jconv.deconv_explicit_padding(mode, p, k, d)
    want = np.asarray(jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), None,
                                     (s, s), pad, (d, d)))
    layer = P.Deconvolution2D(nOut=4, kernelSize=(k, k))
    wt = layer.param_from_reference("W", torch.from_numpy(w))
    got = pconv.deconv2d(torch.from_numpy(x).permute(0, 3, 1, 2), wt, None,
                         (s, s), pconv.deconv_explicit_padding(mode, p, k, d),
                         (d, d)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == pconv.deconv_output_size(5, k, s, p, d, mode)
    assert _rel(got, want) <= 1e-12
    np.testing.assert_array_equal(layer.param_to_reference("W", wt).numpy(),
                                  w)


# ----------------------------------------------------------------------
# each layer inside a network
# ----------------------------------------------------------------------

def _layers(M, name):
    """The layer under test, by case name."""
    return {
        "lrn": M.LocalResponseNormalization(k=1.5, n=3, alpha=0.2,
                                            beta=0.6),
        "lrn_default": M.LocalResponseNormalization(),
        "upsampling": M.Upsampling2D(size=2),
        "upsampling_rect": M.Upsampling2D(size=(2, 3)),
        "zeropad": M.ZeroPaddingLayer(padding=(1, 2)),
        "zeropad4": M.ZeroPaddingLayer(padding=(1, 0, 2, 1)),
        "cropping": M.Cropping2D(cropping=(1, 2)),
        "cropping4": M.Cropping2D(cropping=(0, 1, 2, 1)),
        "s2d": M.SpaceToDepth(blocks=2),
        "deconv": M.Deconvolution2D(nOut=5, kernelSize=(3, 3),
                                    stride=(2, 2), activation="relu"),
        "deconv_same": M.Deconvolution2D(nOut=5, kernelSize=(3, 3),
                                         stride=(2, 2),
                                         convolutionMode="same"),
        "deconv_pad": M.Deconvolution2D(nOut=2, kernelSize=(4, 4),
                                        stride=(2, 2), padding=(1, 1)),
        "depthwise": M.DepthwiseConvolution2D(depthMultiplier=2,
                                              kernelSize=(3, 3)),
        "depthwise_same": M.DepthwiseConvolution2D(
            depthMultiplier=3, kernelSize=(3, 3), stride=(2, 2),
            convolutionMode="same", activation="tanh"),
        "separable": M.SeparableConvolution2D(nOut=6, depthMultiplier=2,
                                              kernelSize=(3, 3),
                                              padding=(1, 1)),
        "dropout_layer": M.DropoutLayer(dropOut=0.5),
    }[name]


LAYERS = ["lrn", "lrn_default", "upsampling", "upsampling_rect", "zeropad",
          "zeropad4", "cropping", "cropping4", "s2d", "deconv",
          "deconv_same", "deconv_pad", "depthwise", "depthwise_same",
          "separable", "dropout_layer"]


def _conf(M, name, fmt):
    return (M.NeuralNetConfiguration.Builder().seed(12)
            .updater(M.Sgd(0.05)).weightInit(M.WeightInit.XAVIER).list()
            .layer(M.ConvolutionLayer(nOut=C, kernelSize=(3, 3),
                                      convolutionMode="same",
                                      activation="tanh"))
            .layer(_layers(M, name))
            .layer(M.OutputLayer(nOut=CLASSES, activation="softmax"))
            .setInputType(M.InputType.convolutional(H, W, 2, format=fmt))
            .build())


def _data(fmt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 2, H, W)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, B)]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", LAYERS)
def test_layer_in_a_network_matches(name, fmt):
    jc, pc = _conf(J, name, fmt), _conf(P, name, fmt)
    pt, jt = pc.layerInputTypes[2], jc.layerInputTypes[2]
    assert (pt.kind, pt.dims) == (jt.kind, jt.dims)
    jn = J.MultiLayerNetwork(jc).init()
    pn = P.MultiLayerNetwork(pc, device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    x, y = _data(fmt)
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    got = params_to_reference(pn.layers, pg)
    for i, want in enumerate(jg):
        assert set(got[i]) == set(want)
        for k in want:
            assert _rel(got[i][k], want[k]) <= 1e-4, (i, k)
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-5)
    if name == "dropout_layer":
        return    # training draws masks, which differ by RNG
    # one training step each
    jn.fit(x, y)
    pn.fit(x, y)
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)


def test_space_to_depth_refuses_another_format_and_bad_blocks():
    with pytest.raises(ValueError, match="NCHW"):
        P.SpaceToDepth(blocks=2, dataFormat="NHWC")
    with pytest.raises(ValueError, match="divide"):
        P.SpaceToDepth(blocks=3).getOutputType(
            P.InputType.convolutional(8, 8, 2))


def test_output_types_match_the_reference():
    it = (8, 10, 3)
    for name in LAYERS:
        jl, pl = _layers(J, name), _layers(P, name)
        for l in (jl, pl):
            if hasattr(l, "inferNIn"):
                l.inferNIn((J if l is jl else P).InputType.convolutional(*it))
        jt = jl.getOutputType(J.InputType.convolutional(*it))
        pt = pl.getOutputType(P.InputType.convolutional(*it))
        assert (pt.kind, pt.dims) == (jt.kind, jt.dims), name


# ----------------------------------------------------------------------
# the loss layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("loss,act", [("mse", "identity"),
                                      ("mcxent", "softmax"),
                                      ("xent", "sigmoid")])
def test_loss_layer_after_a_dense_layer(loss, act):
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(4)
                .updater(M.Sgd(0.1)).list()
                .layer(M.DenseLayer(nOut=CLASSES, activation="identity"))
                .layer(M.LossLayer(lossFunction=loss, activation=act))
                .setInputType(M.InputType.feedForward(5)).build())

    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 6)]
    jn = J.MultiLayerNetwork(conf(J)).init()
    pn = P.MultiLayerNetwork(conf(P), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    assert not pn.layers[1].hasParams()
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-6)
    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())


def _cnn_loss_graph(M, fmt, loss, act):
    return (M.NeuralNetConfiguration.Builder().seed(6)
            .updater(M.Adam(1e-2)).graphBuilder().addInputs("in")
            .addLayer("c", M.ConvolutionLayer(nOut=CLASSES,
                                              kernelSize=(3, 3),
                                              convolutionMode="same",
                                              activation="identity"), "in")
            .addLayer("out", M.CnnLossLayer(lossFunction=loss,
                                            activation=act), "c")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(H, W, 2, format=fmt))
            .build())


def _seg_labels(fmt, loss, seed=3):
    rng = np.random.default_rng(seed)
    if loss == "mcxent":
        y = np.eye(CLASSES, dtype=np.float32)[
            rng.integers(0, CLASSES, (B, H, W))]          # [B,H,W,C]
    else:
        y = (rng.random((B, H, W, CLASSES)) > 0.5).astype(np.float32)
    return y if fmt == "NHWC" else np.ascontiguousarray(
        y.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("xent", "sigmoid")])
def test_cnn_loss_layer_in_a_graph(fmt, loss, act):
    """The loss sums over the pixels and classes and averages over the
    batch, as the reference's; a 4-d label is NHWC exactly when the
    input type says so; the output map comes back in the API's
    layout."""
    jn = J.ComputationGraph(_cnn_loss_graph(J, fmt, loss, act)).init()
    pn = P.ComputationGraph(_cnn_loss_graph(P, fmt, loss, act),
                            device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    x, _ = _data(fmt)
    y = _seg_labels(fmt, loss)
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    got = g_to_reference(pn.conf, pg)
    for k in jg["c"]:
        assert _rel(got["c"][k], jg["c"][k]) <= 1e-4
    out = pn.output(x).toNumpy()
    np.testing.assert_allclose(out, np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-5)
    assert out.shape == ((B, H, W, CLASSES) if fmt == "NHWC"
                         else (B, CLASSES, H, W))
    from deeplearning4j_tpu_torch.data import DataSet

    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    assert abs(pn.score(DataSet(x, y)) - jn.score(
        __import__("deeplearning4j_tpu.data", fromlist=["DataSet"])
        .DataSet(x, y))) <= 1e-5 * abs(jn.score())


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_cnn_loss_layer_in_a_multilayer_network(fmt):
    """The same head through MultiLayerNetwork. Deviation, stated: the
    reference's MultiLayerNetwork.output returns its internal NHWC map
    whatever the format; the port's returns the API's layout, as both
    packages' ComputationGraph do."""
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(9)
                .updater(M.Sgd(0.1)).list()
                .layer(M.ConvolutionLayer(nOut=CLASSES, kernelSize=(3, 3),
                                          convolutionMode="same",
                                          activation="identity"))
                .layer(M.CnnLossLayer(lossFunction="mcxent",
                                      activation="softmax"))
                .setInputType(M.InputType.convolutional(H, W, 2, format=fmt))
                .build())

    jn = J.MultiLayerNetwork(conf(J)).init()
    pn = P.MultiLayerNetwork(conf(P), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    x, _ = _data(fmt, 1)
    y = _seg_labels(fmt, "mcxent", 4)
    out = pn.output(x).toNumpy()
    ref = np.asarray(jn.output(x).toNumpy())          # NHWC, always
    np.testing.assert_allclose(out if fmt == "NHWC"
                               else out.transpose(0, 2, 3, 1), ref,
                               rtol=0, atol=1e-5)
    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())


def test_cnn_loss_layer_evaluates_per_pixel():
    """evaluate over a 4-d head counts every pixel by its class axis, in
    either format; for NHWC (the class axis last on both sides) the
    confusion matrix is the reference's. Deviation, stated: for NCHW the
    reference's Evaluation takes argmax over the last (width) axis."""
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu.data import \
        ListDataSetIterator as JListIterator
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator

    confs = {}
    for fmt in ("NCHW", "NHWC"):
        jn = J.ComputationGraph(_cnn_loss_graph(J, fmt, "mcxent",
                                                "softmax")).init()
        pn = P.ComputationGraph(_cnn_loss_graph(P, fmt, "mcxent",
                                                "softmax"),
                                device="cpu").init()
        pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
        x, _ = _data(fmt, 5)
        y = _seg_labels(fmt, "mcxent", 6)
        ev = pn.evaluate(ListDataSetIterator([DataSet(x, y)]))
        confs[fmt] = ev._conf
        assert ev._conf.sum() == B * H * W
        if fmt == "NHWC":
            jev = jn.evaluate(JListIterator([JDataSet(x, y)]))
            np.testing.assert_array_equal(ev._conf, jev._conf)
    np.testing.assert_array_equal(confs["NCHW"], confs["NHWC"])


def test_rnn_loss_layer_after_an_lstm():
    """RnnLossLayer: the per-timestep head without params over NCW
    activations, in fit, output and rnnTimeStep."""
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(3)
                .updater(M.Sgd(0.1)).list()
                .layer(M.LSTM(nOut=CLASSES, activation="tanh"))
                .layer(M.RnnLossLayer(lossFunction="mcxent",
                                      activation="softmax"))
                .setInputType(M.InputType.recurrent(4)).build())

    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (3, 5))]
    y = np.ascontiguousarray(y.transpose(0, 2, 1))
    jn = J.MultiLayerNetwork(conf(J)).init()
    pn = P.MultiLayerNetwork(conf(P), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    out = pn.output(x).toNumpy()
    np.testing.assert_allclose(out, np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-6)
    step = pn.rnnTimeStep(x[:, :, 0]).toNumpy()
    np.testing.assert_allclose(step, out[:, :, 0], rtol=0, atol=1e-6)
    for _ in range(2):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
