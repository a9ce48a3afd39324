"""Port parity for masked sequence classification
(deeplearning4j_tpu_torch/nn/conf/{layers,graph,preprocessors,builder}.py,
nn/{multilayer,graph}.py): EmbeddingLayer and EmbeddingSequenceLayer
with WeightInitEmbedding, MaskLayer, MaskZeroLayer,
FrozenLayerWithBackprop, the three time-series vertices with masks along
the graph's edges, the CNN <-> RNN preprocessors, against the JAX
reference. Mirrors test_layers_3d_misc.py (TestMaskLayers,
TestFrozenWithBackprop, TestWrapperRobustness), test_embedding_init.py
(its raw-array cases) and test_multilayer.py's label-mask case.

Tolerances (f32): loss rel 1e-5, gradients rel L2 1e-4, outputs max-abs
1e-5, 3-5-step trajectories rel 1e-5 + abs 1e-6 (the products sum in
another order). bf16: the sequence classifier's loss within 2e-2 rel of
the f32 reference. The vertices and preprocessors alone, f64: exact.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.nn.conf import preprocessors as JPP
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.nn.conf import preprocessors as PPP

from _torch_parity import check_net, pair, rel

V, D, H, T, B = 23, 6, 5, 7, 4


def _tokens(seed=0, batch=B, t=T, lo=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (batch, t)).astype(np.float32)
    lens = rng.integers(lo, t + 1, batch)
    fm = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    lm = np.zeros_like(fm)
    lm[np.arange(batch), lens - 1] = 1.0
    cls = rng.integers(0, 2, batch)
    y = np.zeros((batch, 2, t), np.float32)
    y[np.arange(batch), cls, :] = 1.0
    return x, y, fm, lm, lens, cls


# ----------------------------------------------------------------------
# the sequence classifier (the slice's path) and its graph form
# ----------------------------------------------------------------------

def _classifier(M, dtype=None):
    b = (M.NeuralNetConfiguration.Builder().seed(3).updater(M.Adam(5e-3))
         .l2(1e-5).weightInit(M.WeightInit.XAVIER)
         .gradientNormalization(
             M.GradientNormalization.ClipElementWiseAbsoluteValue)
         .gradientNormalizationThreshold(1.0))
    if dtype is not None:
        b = b.dataType(dtype)
    return (b.list()
            .layer(M.EmbeddingSequenceLayer(nIn=V, nOut=D))
            .layer(M.LSTM(nOut=H, activation="tanh"))
            .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(1, T)).build())


def test_sequence_classifier_masked_matches():
    x, y, fm, lm, _, _ = _tokens()
    check_net(_classifier, x, y, fm, lm, steps=5)


def test_sequence_classifier_bf16_within_band():
    x, y, fm, lm, _, _ = _tokens(1)
    jn, pn = pair(lambda M: _classifier(M, "bfloat16"))
    ref, _ = pair(_classifier)
    for _ in range(3):
        ref.fit(__import__("deeplearning4j_tpu.data", fromlist=["DataSet"])
                .DataSet(x, y, fm, lm))
        pn.fit(PDataSet(x, y, fm, lm))
        assert abs(pn.score() - ref.score()) <= 2e-2 * ref.score()


def _graph_classifier(M):
    return (M.NeuralNetConfiguration.Builder().seed(3).updater(M.Adam(5e-3))
            .l2(1e-5).graphBuilder().addInputs("tokens")
            .addLayer("emb", M.EmbeddingSequenceLayer(nIn=V, nOut=D),
                      "tokens")
            .addLayer("lstm", M.LSTM(nOut=H, activation="tanh"), "emb")
            .addVertex("last", M.LastTimeStepVertex(), "lstm")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax",
                                           lossFunction="mcxent"), "last")
            .setOutputs("out")
            .setInputTypes(M.InputType.recurrent(1, T)).build())


def test_graph_last_time_step_classifier_matches():
    x, _, fm, _, _, cls = _tokens(2)
    y = np.eye(2, dtype=np.float32)[cls]
    check_net(_graph_classifier, x, y, fm, None, steps=4, graph=True)


def test_graph_logits_equal_the_multilayer_last_valid_step():
    """The graph's head on the last valid step gives the MultiLayerNetwork's
    per-step output at that step, under shared weights."""
    x, _, fm, _, lens, _ = _tokens(3)
    mln = P.MultiLayerNetwork(_classifier(P), device="cpu").init()
    cg = P.ComputationGraph(_graph_classifier(P), device="cpu").init()
    cg.setParamTable({"emb_W": mln.getParam("0_W"),
                      "lstm_W": mln.getParam("1_W"),
                      "lstm_RW": mln.getParam("1_RW"),
                      "lstm_b": mln.getParam("1_b"),
                      "out_W": mln.getParam("2_W"),
                      "out_b": mln.getParam("2_b")})
    with torch.no_grad():
        seq, _ = mln._run_layers(mln._params, mln._states, x, False,
                                 torch.from_numpy(fm))
        acts, _, _ = cg._run_graph(cg._params, cg._states,
                                   {"tokens": x}, False, None,
                                   {"tokens": torch.from_numpy(fm)})
    want = seq[np.arange(B), :, lens - 1].numpy()
    got = acts["out"].numpy()
    np.testing.assert_allclose(got, torch.softmax(torch.from_numpy(want),
                                                  -1).numpy(), atol=1e-6)


def test_label_mask_ignores_padded_steps():
    """test_multilayer.py's case: a label mask over half the steps changes
    the score as the reference's does."""
    x, y, _, _, _, _ = _tokens(4)
    jn, pn = pair(_classifier)
    from deeplearning4j_tpu.data import DataSet as JDataSet

    half = np.ones((B, T), np.float32)
    half[:, T // 2:] = 0
    for m in (np.ones((B, T), np.float32), half):
        s_j = jn.score(JDataSet(x, y, labelsMask=m))
        s_p = pn.score(PDataSet(x, y, labelsMask=m))
        assert abs(s_p - s_j) <= 1e-5 * abs(s_j)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

def _embedding_ff(M, weightInit=None):
    kw = {} if weightInit is None else {"weightInit": weightInit}
    return (M.NeuralNetConfiguration.Builder().seed(5).updater(M.Sgd(0.1))
            .list()
            .layer(M.EmbeddingLayer(nIn=V, nOut=D, activation="tanh", **kw))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.feedForward(1)).build())


@pytest.mark.parametrize("shape", [(B,), (B, 1)])
def test_embedding_layer_matches(shape):
    rng = np.random.default_rng(6)
    x = rng.integers(0, V, B).astype(np.float32).reshape(shape)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    check_net(_embedding_ff, x, y)


@pytest.mark.parametrize("bias,act", [(False, "identity"), (True, "tanh")])
def test_embedding_sequence_layer_ncw_and_pooling(bias, act):
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(7)
                .updater(M.Adam(1e-2)).list()
                .layer(M.EmbeddingSequenceLayer(nIn=V, nOut=D, hasBias=bias,
                                                activation=act,
                                                inputLength=T))
                .layer(M.GlobalPoolingLayer(poolingType="avg"))
                .layer(M.OutputLayer(nOut=2, activation="softmax"))
                .setInputType(M.InputType.recurrent(1)).build())

    x, _, _, _, _, cls = _tokens(8)
    y = np.eye(2, dtype=np.float32)[cls]
    jn, pn = check_net(conf, x, y)
    it = P.EmbeddingSequenceLayer(nIn=V, nOut=D, inputLength=T) \
        .getOutputType(P.InputType.recurrent(1))
    assert (it.size, it.dims["timeSeriesLength"]) == (D, T)
    acts = pn.feedForward(x[:, None, :])       # [B, 1, T] input too
    assert acts[1].shape() == (B, D, T)


def test_embedding_nin_is_never_inferred():
    for M in (J, P):
        for cls in (M.EmbeddingLayer, M.EmbeddingSequenceLayer):
            with pytest.raises(ValueError, match="explicit nIn"):
                cls(nOut=4).inferNIn(M.InputType.recurrent(1))


def test_weight_init_embedding_raw_array_source():
    table = np.random.default_rng(3).standard_normal((V, D)).astype(
        np.float32)
    pn = P.MultiLayerNetwork(
        _embedding_ff(P, P.WeightInitEmbedding(table)), device="cpu").init()
    jn = J.MultiLayerNetwork(
        _embedding_ff(J, J.WeightInitEmbedding(table))).init()
    np.testing.assert_array_equal(pn.getParam("0_W").toNumpy(), table)
    np.testing.assert_array_equal(np.asarray(jn.getParam("0_W").toNumpy()),
                                  table)


def test_weight_init_embedding_refusals():
    bad = np.zeros((V + 3, 99), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        P.MultiLayerNetwork(_embedding_ff(P, P.WeightInitEmbedding(bad)),
                            device="cpu").init()

    class Vectors:   # a word-vector model's surface, V words
        vocab = {f"w{i}": i for i in range(V)}

        def getWordVector(self, w):
            return np.full(D, float(self.vocab[w]), np.float32)

    # a word-vector model is ported: its rows in vocabulary order
    net = P.MultiLayerNetwork(
        _embedding_ff(P, P.WeightInitEmbedding(Vectors())),
        device="cpu").init()
    np.testing.assert_array_equal(
        net.getParam("0_W").toNumpy(),
        np.repeat(np.arange(V, dtype=np.float32)[:, None], D, 1))


# ----------------------------------------------------------------------
# mask layers
# ----------------------------------------------------------------------

def test_mask_layer_zeroes_masked_steps():
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    act = np.random.default_rng(1).random((2, 6, 5)).astype(np.float32)
    out, _ = P.MaskLayer().forward({}, {}, torch.from_numpy(act), False,
                                   None, torch.from_numpy(mask))
    want, _ = J.MaskLayer().forward({}, {}, jnp.asarray(act), False, None,
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert out[0, :, 3:].abs().sum() == 0


def test_mask_layer_in_a_network_matches():
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(1)
                .updater(M.Adam(1e-2)).list()
                .layer(M.LSTM(nOut=6)).layer(M.MaskLayer())
                .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                        lossFunction="mcxent"))
                .setInputType(M.InputType.recurrent(3)).build())

    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 5)).astype(np.float32)
    fm = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    y = np.zeros((2, 2, 5), np.float32)
    y[:, 0] = 1
    check_net(conf, x, y, fm, fm)


def _mask_zero(M, l2=0.0):
    return (M.NeuralNetConfiguration.Builder().seed(2).updater(M.Adam(1e-2))
            .list()
            .layer(M.MaskZeroLayer(M.LSTM(nOut=4, l2=l2)))
            .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(3)).build())


def test_mask_zero_layer_derives_the_mask_and_matches():
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 6)).astype(np.float32)
    x[0, :, 4:] = 0.0
    y = np.zeros((2, 2, 6), np.float32)
    y[:, 1] = 1
    jn, pn = check_net(_mask_zero, x, y)
    full = pn.output(x).toNumpy()
    trunc = pn.output(x[:, :, :4]).toNumpy()
    np.testing.assert_allclose(full[0, :, :4], trunc[0], atol=1e-6)
    lstm_out = pn.feedForward(x)[1].toNumpy()
    assert np.abs(lstm_out[0, :, 4:]).max() == 0   # masked steps zeroed


def test_mask_zero_keeps_inner_regularization():
    pn = P.MultiLayerNetwork(_mask_zero(P, 0.5), device="cpu").init()
    assert float(pn._regularization(pn._params).detach()) > 0.0
    zero = P.MultiLayerNetwork(_mask_zero(P, 0.0), device="cpu").init()
    assert float(zero._regularization(pn._params)) == 0.0
    jn, pn = pair(lambda M: _mask_zero(M, 0.5))
    assert abs(float(pn._regularization(pn._params))
               - float(jn._regularization(jn._params))) <= 1e-6


# ----------------------------------------------------------------------
# FrozenLayerWithBackprop and wrapper robustness
# ----------------------------------------------------------------------

def _frozen(M, wrap):
    inner = M.DenseLayer(nOut=8, activation="tanh")
    return (M.NeuralNetConfiguration.Builder().seed(5).updater(M.Adam(1e-2))
            .l2(1e-3).list()
            .layer(M.FrozenLayerWithBackprop(inner) if wrap else inner)
            .layer(M.OutputLayer(nOut=2, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.feedForward(4)).build())


@pytest.mark.parametrize("wrap", [True, False])
def test_frozen_with_backprop_params_fixed_head_trains(wrap):
    rng = np.random.default_rng(0)
    x = rng.random((16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    jn, pn = check_net(lambda M: _frozen(M, wrap), x, y, steps=5)
    w0 = jn.getParam("0_W").toNumpy()
    if wrap:
        np.testing.assert_array_equal(pn.getParam("0_W").toNumpy(),
                                      np.asarray(w0))
    assert abs(float(pn._regularization(pn._params))
               - float(jn._regularization(jn._params))) <= 1e-6


def test_frozen_with_backprop_keeps_train_mode():
    from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

    wrapped = P.FrozenLayerWithBackprop(P.DropoutLayer(dropOut=0.5))
    conf = (P.NeuralNetConfiguration.Builder().seed(9).list()
            .layer(wrapped).layer(P.OutputLayer(nOut=2,
                                                activation="softmax"))
            .setInputType(P.InputType.feedForward(6)).build())
    pn = P.MultiLayerNetwork(conf, device="cpu").init()
    x = torch.ones(4, 6)
    act, _ = wrapped.forward({}, {}, x, True, StepKey(1), None)
    assert (act == 0).any()
    from deeplearning4j_tpu_torch.nn.multilayer import layer_trains

    assert layer_trains(pn.layers[0], True)
    plain = P.DropoutLayer(dropOut=0.5)
    plain.frozen = True
    assert not layer_trains(plain, True)


def test_wrappers_deepcopy_pickle_and_builder_unwraps():
    w = P.FrozenLayerWithBackprop(P.DenseLayer(nOut=4))
    assert copy.deepcopy(w).nOut == 4 and copy.deepcopy(w).frozen
    w3 = pickle.loads(pickle.dumps(w))
    assert w3.nOut == 4 and w3.frozenKeepTraining
    conf = (P.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(P.ConvolutionLayer(nOut=3, kernelSize=(3, 3),
                                      activation="relu"))
            .layer(P.FrozenLayerWithBackprop(P.DenseLayer(nOut=4)))
            .layer(P.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(P.InputType.convolutional(6, 6, 2)).build())
    out = P.MultiLayerNetwork(conf, device="cpu").init().output(
        np.random.default_rng(0).random((2, 2, 6, 6)).astype(np.float32))
    assert out.shape() == (2, 2)
    conf = (P.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(P.MaskZeroLayer(P.LSTM(nIn=3, nOut=4)))
            .layer(P.RnnOutputLayer(nIn=4, nOut=2, activation="softmax"))
            .build())
    assert conf.inputType.kind == P.InputType.RNN
    assert conf.inputType.size == 3


# ----------------------------------------------------------------------
# the time-series vertices
# ----------------------------------------------------------------------

_MASKS = [np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.float64),
          np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0]], np.float64),
          None]


@pytest.mark.parametrize("mi", range(len(_MASKS)))
@pytest.mark.parametrize("vertex", ["ReverseTimeSeriesVertex",
                                    "LastTimeStepVertex"])
def test_time_vertex_masked_matches(vertex, mi):
    """Includes a row whose mask is all zero: LastTimeStepVertex takes
    index -1 there, which the reference reads as the last step."""
    m = _MASKS[mi]
    x = np.random.default_rng(mi).standard_normal((3, 2, 4))
    got, gm = getattr(P, vertex)().applyMasked(
        [torch.from_numpy(x)], [None if m is None else torch.from_numpy(m)])
    want, wm = getattr(J, vertex)().applyMasked(
        [jnp.asarray(x)], [None if m is None else jnp.asarray(m)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (gm is None) == (wm is None)
    if mi == 1 and vertex == "LastTimeStepVertex":
        np.testing.assert_array_equal(got[1].numpy(), x[1, :, -1])


def test_duplicate_vertex_and_unmasked_apply():
    v = np.random.default_rng(0).standard_normal((3, 2))
    s = np.zeros((3, 5, 4))
    m = np.ones((3, 4))
    got, gm = P.DuplicateToTimeSeriesVertex().applyMasked(
        [torch.from_numpy(v), torch.from_numpy(s)],
        [None, torch.from_numpy(m)])
    want = np.asarray(J.DuplicateToTimeSeriesVertex().apply(
        [jnp.asarray(v), jnp.asarray(s)]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert gm is not None
    with pytest.raises(ValueError, match="two inputs"):
        P.DuplicateToTimeSeriesVertex().apply([torch.from_numpy(v)])
    x = np.random.default_rng(1).standard_normal((2, 3, 4))
    for name in ("ReverseTimeSeriesVertex", "LastTimeStepVertex"):
        np.testing.assert_array_equal(
            getattr(P, name)().apply([torch.from_numpy(x)]).numpy(),
            np.asarray(getattr(J, name)().apply([jnp.asarray(x)])))


def _seq2seq(M, tbptt=False):
    b = (M.NeuralNetConfiguration.Builder().seed(11).updater(M.Adam(1e-2))
         .graphBuilder().addInputs("in")
         .addLayer("enc", M.LSTM(nOut=H), "in")
         .addVertex("rev", M.ReverseTimeSeriesVertex(), "enc")
         .addVertex("last", M.LastTimeStepVertex(), "rev")
         .addVertex("dup", M.DuplicateToTimeSeriesVertex(), "last", "in")
         .addLayer("dec", M.LSTM(nOut=H), "dup")
         .addLayer("out", M.RnnOutputLayer(nOut=2, activation="softmax",
                                           lossFunction="mcxent"), "dec")
         .setOutputs("out").setInputTypes(M.InputType.recurrent(3, T)))
    if tbptt:
        b = b.backpropType("tbptt")
    return b.build()


def test_time_vertices_in_a_graph_match():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 3, T)).astype(np.float32)
    _, y, fm, _, _, _ = _tokens(12)
    check_net(_seq2seq, x, y, fm, fm, graph=True)


def test_time_vertices_refuse_truncated_bptt():
    for M in (J, P):
        with pytest.raises(ValueError, match="truncated BPTT"):
            _seq2seq(M, tbptt=True)


# ----------------------------------------------------------------------
# CNN <-> RNN preprocessors
# ----------------------------------------------------------------------

def test_cnn_rnn_preprocessors_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3 * 4 * 5, 6))       # [B, C*H*W, T]
    j = JPP.RnnToCnnPreProcessor(4, 5, 3).preProcess(jnp.asarray(x))
    p = PPP.RnnToCnnPreProcessor(4, 5, 3).preProcess(torch.from_numpy(x))
    np.testing.assert_array_equal(p.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j))
    jb, pb = JPP.CnnToRnnPreProcessor(4, 5, 3), PPP.CnnToRnnPreProcessor(
        4, 5, 3)
    jb.batch = pb.batch = 2
    np.testing.assert_array_equal(pb.preProcess(p).numpy(),
                                  np.asarray(jb.preProcess(j)))
    np.testing.assert_array_equal(pb.preProcess(p).numpy(), x)


def _conv_rnn(M):
    return (M.NeuralNetConfiguration.Builder().seed(13)
            .updater(M.Adam(1e-2)).list()
            .inputPreProcessor(0, (JPP if M is J else PPP)
                               .RnnToCnnPreProcessor(5, 5, 2))
            .layer(M.ConvolutionLayer(nOut=3, kernelSize=(3, 3),
                                      activation="relu"))
            .layer(M.LSTM(nOut=H))
            .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(50, T)).build())


def test_conv_cnn_to_rnn_lstm_at_t_above_one():
    conf = _conv_rnn(P)
    assert isinstance(conf.preprocessors[1], P.CnnToRnnPreProcessor)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 50, T)).astype(np.float32)
    y = np.zeros((3, 2, T), np.float32)
    y[:, 0, ::2] = 1
    y[:, 1, 1::2] = 1
    jn, pn = check_net(_conv_rnn, x, y)
    assert pn.output(x).shape() == (3, 2, T)
