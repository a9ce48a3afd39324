"""Port parity for the CNN zoo of the CNN-zoo slice
(deeplearning4j_tpu_torch/zoo/models.py): SimpleCNN, AlexNet (LRN),
VGG16, VGG19 and UNet (CnnLossLayer, MergeVertex, Upsampling2D) at cut
input sizes, and ResNet50 with ``stemMode="space_to_depth"``, against
the JAX reference. Mirrors tests/test_zoo.py.

Each model is built by its own zoo class in both packages at its full
width, the input cut (SimpleCNN and UNet 16x16, AlexNet 67x67, the
smallest its three pools take, VGG 32x32, ResNet-50 64x64), dropout set
off in both confs (the masks differ by RNG; tests/test_torch_dropout.py
holds them under injection), the reference's parameters carried into
the port, seeded numpy inputs. Held: the parameter count, the loss and
every parameter's gradient, the output, and a 3-step fit trajectory
(each step's loss and the params after it). f32 is well conditioned for
these nets at these sizes (observed: gradients within 3.2e-6 rel L2,
losses within 6e-7); ResNet-50 is not (tests/test_torch_zoo_resnet.py),
so its s2d stem is held in f64, as there.

Tolerances: f32 loss rel 1e-5, gradients rel L2 1e-4, outputs max-abs
1e-5, trajectory losses rel 1e-4 and params within 1e-4 of each
tensor's max-abs; f64 loss rel 1e-10, gradients rel L2 1e-9, outputs
1e-10. The conf JSON (dropout on) crosses both packages unchanged, and
an s2d net built from a standard net's stem through
``stem_weights_to_s2d`` computes the standard net's outputs (f64: 1e-10).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.zoo as JZ
from deeplearning4j_tpu.ndarray import DataType as JDataType
from deeplearning4j_tpu.nn.conf.graph import \
    ComputationGraphConfiguration as JGConf
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as PGConf
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(2)

#: model -> (input shape, classes, updater factory, batch)
MODELS = {
    "SimpleCNN": ((3, 16, 16), 5, lambda M: M.Adam(1e-3), 4),
    "AlexNet": ((3, 67, 67), 5, lambda M: M.Nesterovs(1e-3, 0.9), 2),
    "VGG16": ((3, 32, 32), 5, lambda M: M.Nesterovs(1e-3, 0.9), 2),
    "VGG19": ((3, 32, 32), 4, lambda M: M.Nesterovs(1e-3, 0.9), 2),
    "UNet": ((3, 16, 16), 1, lambda M: M.Adam(1e-3), 2),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _layers(conf):
    if hasattr(conf, "layers"):
        return conf.layers
    return [n.payload for n in conf.nodes.values() if n.kind == "layer"]


def _no_dropout(conf):
    for layer in _layers(conf):
        layer.dropOut = None
    return conf


def _zoo(Z, M, name, **kw):
    shape, classes, upd, _ = MODELS[name]
    return getattr(Z, name)(numClasses=classes, inputShape=shape,
                            updater=upd(M), **kw)


def _data(name, seed=0):
    shape, classes, _, b = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b,) + shape).astype(np.float32)
    if name == "UNet":
        y = (rng.random((b, classes) + shape[1:]) > 0.5).astype(np.float32)
    else:
        y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
    return x, y


def _pair(name):
    jc = _no_dropout(_zoo(JZ, J, name).conf())
    pc = _no_dropout(_zoo(PZ, P, name, device="cpu").conf())
    graph = hasattr(jc, "nodes")
    jn = (J.ComputationGraph if graph else J.MultiLayerNetwork)(jc).init()
    pn = (P.ComputationGraph if graph else P.MultiLayerNetwork)(
        pc, device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn, graph


def _grads_to_reference(pn, graph, pg):
    if graph:
        return g_to_reference(pn.conf, pg)
    return dict(enumerate(params_to_reference(pn.layers, pg)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_the_reference(name):
    jn, pn, graph = _pair(name)
    assert pn.numParams() == jn.numParams()
    x, y = _data(name)
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    got = _grads_to_reference(pn, graph, pg)
    want_all = jg if graph else dict(enumerate(jg))
    for k, want in want_all.items():
        for n in want:
            assert _rel(got[k][n], want[n]) <= 1e-4, (k, n)
    np.testing.assert_allclose(pn.output(x).toNumpy(),
                               np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-5)
    for _ in range(3):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-4 * abs(jn.score())
    got = pn.params().toNumpy()
    want = np.asarray(jn.params().toNumpy())
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


ALL = sorted(MODELS) + ["ResNet50-s2d"]


def _confs(name):
    if name == "ResNet50-s2d":
        kw = dict(numClasses=7, inputShape=(3, 32, 32),
                  stemMode="space_to_depth")
        return JZ.ResNet50(**kw).conf(), PZ.ResNet50(device="cpu",
                                                     **kw).conf()
    return _zoo(JZ, J, name).conf(), _zoo(PZ, P, name, device="cpu").conf()


def _without_mode(tree):
    """A JSON tree without GlobalPoolingLayer's ``_mode``, derived state
    the reference keeps and the port does not (tests/test_torch_serde.py)."""
    if isinstance(tree, dict):
        return {k: _without_mode(v) for k, v in tree.items() if k != "_mode"}
    if isinstance(tree, list):
        return [_without_mode(v) for v in tree]
    return tree


@pytest.mark.parametrize("name", ALL)
def test_zoo_conf_json_crosses_both_ways(name):
    jc, pc = _confs(name)
    assert _without_mode(json.loads(jc.toJson())) == \
        _without_mode(json.loads(pc.toJson()))
    graph = hasattr(jc, "nodes")
    pcls = PGConf if graph else P.MultiLayerConfiguration
    jcls = JGConf if graph else J.MultiLayerConfiguration
    assert json.loads(pcls.fromJson(jc.toJson()).toJson()) == \
        json.loads(jc.toJson())
    assert json.loads(jcls.fromJson(pc.toJson()).toJson()) == \
        json.loads(pc.toJson())


def test_simple_cnn_and_alexnet_train_with_dropout():
    """tests/test_zoo.py's SimpleCNN case, and AlexNet with its dropout
    and LRN on: the loss over a repeated batch falls."""
    for name in ("SimpleCNN", "AlexNet"):
        net = _zoo(PZ, P, name, device="cpu").init()
        x, y = _data(name, 1)
        losses = []
        for _ in range(6):
            net.fit(x, y)
            losses.append(net.score())
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], name


def test_unet_output_is_a_probability_map():
    net = _zoo(PZ, P, "UNet", device="cpu").init()
    x, _ = _data("UNet")
    out = net.output(x).toNumpy()
    assert out.shape == (2, 1, 16, 16)
    assert (out > 0).all() and (out < 1).all()
    nhwc = PZ.UNet(numClasses=1, inputShape=(3, 16, 16), dataFormat="NHWC",
                   device="cpu").init()
    nhwc.setParams(net.params())
    np.testing.assert_allclose(
        nhwc.output(x.transpose(0, 2, 3, 1)).toNumpy(),
        out.transpose(0, 2, 3, 1), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# ResNet-50's space-to-depth stem
# ----------------------------------------------------------------------

#: 64x64, as tests/test_torch_zoo_resnet.py: at 32x32 the last stage's BN
#: normalises 2 values a channel and f64 training mode loses 7 digits
S2D = dict(numClasses=5, inputShape=(3, 64, 64))


def test_s2d_stem_computes_the_standard_stem():
    """tests/test_zoo.py's exact-parity case, on the port: the standard
    net's parameters carried across, conv1 through stem_weights_to_s2d
    (the reference's HWIO arrays) and param_from_reference."""
    kw = dict(S2D, dataType=P.DataType.DOUBLE, device="cpu")
    std = PZ.ResNet50(**kw).init()
    s2d = PZ.ResNet50(stemMode="space_to_depth", **kw).init()
    table = {k: v.toNumpy() for k, v in std.paramTable().items()}
    table["conv1_W"] = PZ.ResNet50.stem_weights_to_s2d(table["conv1_W"])
    np.testing.assert_array_equal(
        table["conv1_W"],
        JZ.ResNet50.stem_weights_to_s2d(std.getParam("conv1_W").toNumpy()))
    s2d.setParamTable(table)
    x = np.random.default_rng(0).standard_normal((4, 3, 64, 64))
    a = std.output(x).toNumpy()
    b = s2d.output(x).toNumpy()
    assert np.max(np.abs(a - b)) <= 1e-10
    # and in training mode, the loss and every shared gradient
    y = np.eye(5)[[1, 3, 0, 2]]
    ga, la = std.computeGradientAndScore(x, y)
    gb, lb = s2d.computeGradientAndScore(x, y)
    assert abs(la - lb) <= 1e-10 * abs(la)
    for n in ga:
        if n != "conv1":
            for k in ga[n]:
                assert _rel(gb[n][k].numpy(), ga[n][k].numpy()) <= 1e-8, n


def test_s2d_net_matches_the_reference_f64():
    """The reference's s2d ResNet-50 (He-normal numpy draws in its own
    shapes, set with initFrom) carried into the port: f64 training-mode
    loss and gradients, and one Nesterovs step."""
    jconf = JZ.ResNet50(stemMode="space_to_depth",
                        dataType=JDataType.DOUBLE, **S2D).conf()
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    shapes = jax.eval_shape(lambda: (lambda n: (n._params, n._states))(
        JGraph(jconf).init()))
    rng = np.random.default_rng(1)

    def draw(name, s):
        if name == "W":
            return rng.standard_normal(s.shape) * np.sqrt(
                2.0 / np.prod(s.shape[:-1]))
        return np.full(s.shape, 1.0 if name in ("gamma", "var") else 0.0)

    params, states = ({n: {k: draw(k, s) for k, s in d.items()}
                       for n, d in tree.items()} for tree in shapes)
    jn = JGraph(jconf).initFrom(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params),
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), states))
    pn = PZ.ResNet50(stemMode="space_to_depth", dataType=P.DataType.DOUBLE,
                     device="cpu", **S2D).init().load_reference_params(
        params, jax.tree.map(lambda a: np.asarray(a, np.float32), states))
    x = np.random.default_rng(2).standard_normal((4, 3, 64, 64))
    y = np.eye(5)[[0, 4, 2, 2]]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jn._loss_fn(p, jn._states, {"input": jnp.asarray(x)},
                              [jnp.asarray(y)], None, None, None),
        has_aux=True))(jn._params)
    pg, pl = pn.computeGradientAndScore(x, y)
    assert abs(pl - float(jl)) <= 1e-10 * abs(float(jl))
    got = g_to_reference(pn.conf, pg)
    for n, want in jg.items():
        for k in want:
            assert _rel(got[n][k], want[k]) <= 1e-9, (n, k)
    jn.fit(x, y)
    pn.fit(x, y)
    got = pn.reference_state(saveUpdater=False)["params"]   # f64
    for n, want in jn._params.items():
        for k in want:
            w = np.asarray(want[k])
            assert np.max(np.abs(got[n][k] - w)) <= 1e-10 * np.max(np.abs(w))
