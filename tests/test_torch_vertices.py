"""Port parity for the graph vertices of the CNN-zoo slice
(deeplearning4j_tpu_torch/nn/conf/graph.py): MergeVertex, SubsetVertex,
StackVertex, UnstackVertex, ScaleVertex, ShiftVertex (scalar and
per-channel), L2NormalizeVertex, L2Vertex, DotProductVertex and
ReshapeVertex, against the JAX reference. Mirrors tests/test_compgraph.py
(merge shape inference, the one-vertex nets, stack/unstack, the CNN
branch merge, the siamese distance vertices).

Each case is a small ComputationGraph built in both packages, the
reference's parameters carried into the port, seeded numpy inputs (CNN
inputs fed NCHW and NHWC). Held: every node's output type, the loss and
every parameter's gradient (the vertex's backward), the outputs, every
vertex's activation from ``feedForward`` (4-d ones in the API's layout),
two training steps, and the conf JSON read by the other package.
Tolerances (f32): loss and step losses rel 1e-5, gradients rel L2 1e-4,
activations max-abs 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.nn.conf.graph import \
    ComputationGraphConfiguration as JConf
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as PConf
from deeplearning4j_tpu_torch.nn.graph import params_to_reference

torch.set_num_threads(1)
B = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _builder(M):
    return (M.NeuralNetConfiguration.Builder().seed(1)
            .updater(M.Adam(1e-2)).weightInit(M.WeightInit.XAVIER)
            .graphBuilder())


def _ff_one(M, vertex, n=6):
    """tests/test_compgraph.py's one-vertex net."""
    return (_builder(M).addInputs("in")
            .addLayer("d", M.DenseLayer(nOut=n, activation="tanh"), "in")
            .addVertex("v", vertex(M), "d")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"), "v")
            .setOutputs("out").setInputTypes(M.InputType.feedForward(4))
            .build())


def _cnn_one(M, vertex, fmt, n=4):
    return (_builder(M).addInputs("in")
            .addLayer("c", M.ConvolutionLayer(nOut=n, kernelSize=(3, 3),
                                              convolutionMode="same",
                                              activation="tanh"), "in")
            .addVertex("v", vertex(M), "c")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"), "v")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(5, 6, 2, format=fmt))
            .build())


def _merge_ff(M, fmt):
    return (_builder(M).addInputs("a", "b")
            .addLayer("da", M.DenseLayer(nOut=8, activation="relu"), "a")
            .addLayer("db", M.DenseLayer(nOut=5, activation="relu"), "b")
            .addVertex("m", M.MergeVertex(), "da", "db")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"), "m")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(3),
                           M.InputType.feedForward(5)).build())


def _merge_cnn(M, fmt):
    """tests/test_compgraph.py's CNN branch merge, flattened after."""
    return (_builder(M).addInputs("img")
            .addLayer("c3", M.ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                               convolutionMode="same",
                                               activation="relu"), "img")
            .addLayer("c5", M.ConvolutionLayer(nOut=3, kernelSize=(5, 5),
                                               convolutionMode="same",
                                               activation="relu"), "img")
            .addVertex("m", M.MergeVertex(), "c3", "c5")
            .addLayer("c", M.ConvolutionLayer(nOut=2, kernelSize=(1, 1),
                                              activation="identity"), "m")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"), "c")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(6, 6, 1, format=fmt))
            .build())


def _merge_rnn(M, fmt):
    return (_builder(M).addInputs("s")
            .addLayer("l1", M.LSTM(nOut=3), "s")
            .addLayer("l2", M.SimpleRnn(nOut=2), "s")
            .addVertex("m", M.MergeVertex(), "l1", "l2")
            .addLayer("out", M.RnnOutputLayer(nOut=3, activation="softmax"),
                      "m")
            .setOutputs("out").setInputTypes(M.InputType.recurrent(4, 5))
            .build())


def _stack(M, fmt):
    return (_builder(M).addInputs("a", "b")
            .addVertex("s", M.StackVertex(), "a", "b")
            .addLayer("d", M.DenseLayer(nOut=5, activation="tanh"), "s")
            .addVertex("u0", M.UnstackVertex(0, 2), "d")
            .addVertex("u1", M.UnstackVertex(1, 2), "d")
            .addVertex("e", M.ElementWiseVertex("subtract"), "u0", "u1")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"), "e")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(3),
                           M.InputType.feedForward(3)).build())


def _siamese(M, fmt):
    """tests/test_compgraph.py's siamese distance vertices."""
    return (_builder(M).addInputs("a", "b")
            .addLayer("ea", M.DenseLayer(nOut=6, activation="tanh"), "a")
            .addLayer("eb", M.DenseLayer(nOut=6, activation="tanh"), "b")
            .addVertex("l2", M.L2Vertex(), "ea", "eb")
            .addVertex("dot", M.DotProductVertex(), "ea", "eb")
            .addVertex("feat", M.MergeVertex(), "l2", "dot")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"),
                      "feat")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(4),
                           M.InputType.feedForward(4)).build())


def _siamese_cnn(M, fmt):
    return (_builder(M).addInputs("a")
            .addLayer("c1", M.ConvolutionLayer(nOut=3, kernelSize=(3, 3),
                                               activation="tanh"), "a")
            .addLayer("c2", M.ConvolutionLayer(nOut=3, kernelSize=(3, 3),
                                               activation="sigmoid"), "a")
            .addVertex("l2", M.L2Vertex(), "c1", "c2")
            .addVertex("dot", M.DotProductVertex(), "c1", "c2")
            .addVertex("feat", M.MergeVertex(), "l2", "dot")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"),
                      "feat")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(5, 5, 2, format=fmt))
            .build())


def _reshape(M, fmt):
    """ff -> 4-d (in the reference's NHWC order) -> conv -> 2-d."""
    return (_builder(M).addInputs("in")
            .addLayer("d", M.DenseLayer(nOut=24, activation="tanh"), "in")
            .addVertex("r", M.ReshapeVertex(-1, 2, 4, 3), "d")
            .addLayer("c", M.ConvolutionLayer(nOut=2, kernelSize=(2, 2),
                                              activation="tanh"), "r")
            .addVertex("f", M.ReshapeVertex(-1, 6), "c")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"), "f")
            .setOutputs("out").setInputTypes(M.InputType.feedForward(4))
            .build())


CASES = {
    "merge_ff": _merge_ff,
    "merge_cnn": _merge_cnn,
    "merge_rnn": _merge_rnn,
    "subset_ff": lambda M, f: _ff_one(M, lambda M: M.SubsetVertex(1, 3)),
    "subset_cnn": lambda M, f: _cnn_one(M, lambda M: M.SubsetVertex(1, 2),
                                        f),
    "stack_unstack": _stack,
    "scale": lambda M, f: _ff_one(M, lambda M: M.ScaleVertex(2.0)),
    "shift": lambda M, f: _ff_one(M, lambda M: M.ShiftVertex(1.0)),
    "scale_per_feature": lambda M, f: _ff_one(
        M, lambda M: M.ScaleVertex([0.5, 1.0, 2.0, -1.0, 3.0, 0.1])),
    "scale_per_channel": lambda M, f: _cnn_one(
        M, lambda M: M.ScaleVertex(np.array([0.5, 2.0, -1.0, 3.0])), f),
    "shift_per_channel": lambda M, f: _cnn_one(
        M, lambda M: M.ShiftVertex((0.1, -0.2, 0.3, 0.0)), f),
    "l2normalize_ff": lambda M, f: _ff_one(M, lambda M:
                                           M.L2NormalizeVertex()),
    "l2normalize_cnn": lambda M, f: _cnn_one(M, lambda M:
                                             M.L2NormalizeVertex(), f),
    "siamese": _siamese,
    "siamese_cnn": _siamese_cnn,
    "reshape": _reshape,
}
CNN = {"merge_cnn", "subset_cnn", "scale_per_channel", "shift_per_channel",
       "l2normalize_cnn", "siamese_cnn"}
PARAMS = [(c, f) for c in CASES for f in (["NCHW", "NHWC"] if c in CNN
                                          else ["NCHW"])]


def _inputs(conf, name, fmt, rng):
    xs = []
    for i in conf.networkInputs:
        it = conf.inputTypes[i]
        if it.kind == "convolutional":
            x = rng.standard_normal((B, it.channels, it.height, it.width))
            if fmt == "NHWC":
                x = x.transpose(0, 2, 3, 1)
        elif it.kind == "recurrent":
            x = rng.standard_normal((B, it.size, it.timeSeriesLength))
        else:
            x = rng.standard_normal((B, it.size))
        xs.append(np.ascontiguousarray(x, dtype=np.float32))
    out = conf.nodes[conf.networkOutputs[0]].payload
    if name == "merge_rnn":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, 5))]
        y = np.ascontiguousarray(y.transpose(0, 2, 1))
    else:
        y = np.eye(out.nOut, dtype=np.float32)[rng.integers(0, out.nOut, B)]
    return xs, y


def _pair(name, fmt):
    jc, pc = CASES[name](J, fmt), CASES[name](P, fmt)
    jn = J.ComputationGraph(jc).init()
    pn = P.ComputationGraph(pc, device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


@pytest.mark.parametrize("name,fmt", PARAMS)
def test_vertex_graph_matches(name, fmt):
    jn, pn = _pair(name, fmt)
    for n, node in pn.conf.nodes.items():
        jt, pt = jn.conf.nodes[n].inputType, node.inputType
        assert (pt.kind, pt.dims) == (jt.kind, jt.dims), n
    xs, y = _inputs(pn.conf, name, fmt, np.random.default_rng(0))
    feed = xs if len(xs) > 1 else xs[0]
    jg, js = jn.computeGradientAndScore(feed, y)
    pg, ps = pn.computeGradientAndScore(feed, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    got = params_to_reference(pn.conf, pg)
    for layer, want in jg.items():
        for k in want:
            assert _rel(got[layer][k], want[k]) <= 1e-4, (layer, k)
    ja = jn.feedForward(xs)
    pa = pn.feedForward(xs)
    for v, node in pn.conf.nodes.items():
        if node.kind != "vertex":
            continue
        # both in the API's layout
        np.testing.assert_allclose(pa[v].toNumpy(),
                                   np.asarray(ja[v].toNumpy()), rtol=0,
                                   atol=1e-5, err_msg=v)
    np.testing.assert_allclose(pn.output(*xs).toNumpy(),
                               np.asarray(jn.output(*xs).toNumpy()),
                               rtol=0, atol=1e-5)
    for _ in range(2):
        jn.fit(feed, y)
        pn.fit(feed, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())


@pytest.mark.parametrize("name", sorted(CASES))
def test_vertex_conf_json_crosses_both_ways(name):
    jc, pc = CASES[name](J, "NCHW"), CASES[name](P, "NCHW")
    assert json.loads(PConf.fromJson(jc.toJson()).toJson()) == \
        json.loads(jc.toJson())
    assert json.loads(JConf.fromJson(pc.toJson()).toJson()) == \
        json.loads(pc.toJson())
    P.ComputationGraph(PConf.fromJson(jc.toJson()), device="cpu").init()


def test_merge_shape_inference():
    conf = _merge_ff(P, None)
    assert conf.nodes["out"].payload.nIn == 13
    conf = _merge_cnn(P, "NCHW")
    assert conf.nodes["m"].inputType.channels == 7


def test_per_channel_factor_refused_on_sequences():
    for v in (P.ScaleVertex((1.0, 2.0)), P.ShiftVertex([1.0, 2.0])):
        with pytest.raises(ValueError, match="recurrent"):
            v.getOutputType(P.InputType.recurrent(2, 3))
        with pytest.raises(ValueError, match="NCW"):
            v.apply([torch.ones(1, 2, 3)])
    with pytest.raises(ValueError, match="1-d"):
        P.ScaleVertex(np.ones((2, 2)))
    assert P.ScaleVertex(np.float32(2.0)).scaleFactor == 2.0


def test_unstack_takes_equal_batch_blocks():
    v = P.UnstackVertex(1, 3)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(v.apply([x]), x[2:4])
    assert torch.equal(P.StackVertex().apply([x, x]), torch.cat([x, x]))
