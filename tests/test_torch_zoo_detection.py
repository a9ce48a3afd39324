"""Port parity for the rest of the zoo (deeplearning4j_tpu_torch/zoo/
models.py): Darknet19, TinyYOLO and YOLO2 (with the Yolo2OutputLayer
head and YOLO2's passthrough route), SqueezeNet, Xception,
InceptionResNetV1, FaceNetNN4Small2 and NASNet, against the JAX
reference. Mirrors tests/test_zoo.py's TestZooDetectionAndSeparable,
TestZooTailConvergence and TestZooUpstreamTail, and SqueezeNet's case
of tests/test_remat_policy.py.

Each model is built by its own zoo class in both packages at the cut
sizes of the reference's tests (input 32-96 px; Xception with one
middle-flow block at 32 px, NASNet one cell a stack), dropout off in both confs,
the reference's parameters carried into the port, seeded numpy inputs
and labels (the YOLO heads' labels are NCHW boxes in grid units).
The parity runs in f64 at batch 4: these nets' train-mode BN over 1x1
maps makes their f32 loss reproducible only to ~4e-5 (Darknet19's, rel)
across summation orders, as ResNet-50's is
(tests/test_torch_zoo_resnet.py), and at batch 2 BN over two values is
degenerate (the reference's own jitted and eager gradients differ by
2.6e-6 there, InceptionResNetV1). The reference's gradients are its
``computeGradientAndScore`` under ``jax.jit``: FaceNetNN4Small2's pnorm
pools meet all-zero windows, where the compiled step's gradient is 0
and the eager one NaN; the port gives 0 (``ops/pooling.py`` ``_root``). The port's seeded weights are carried
into the reference (``initFrom``), and the port's Sgd(1.0)
step is held to the reference's gradient. Convergence runs on the port
alone, as the reference's tests run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.zoo as JZ
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.ndarray import DataType as JDataType
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.ndarray.dtype import DataType as PDataType
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(2)


B = 4


def _onehot(classes, n=B, seed=1):
    return np.eye(classes, dtype=np.float32)[
        np.random.RandomState(seed).randint(0, classes, n)]


def _yolo_labels(classes, grid, n=B):
    lab = np.zeros((n, 4 + classes, grid, grid), np.float32)
    lab[0, 0:4, 0, 0] = (0.1, 0.1, 0.9, 0.9)
    lab[0, 4, 0, 0] = 1.0
    if grid > 1:
        lab[1, 0:4, 0, 1] = (1.1, 0.1, 1.9, 0.4)
        lab[1, 4 + classes - 1, 0, 1] = 1.0
    return lab


#: name -> (zoo class name, constructor kwargs, input shape, labels)
CASES = {
    "Darknet19": ("Darknet19", dict(numClasses=10), (3, 32, 32),
                  lambda: _onehot(10)),
    "TinyYOLO": ("TinyYOLO", dict(numClasses=4), (3, 64, 64),
                 lambda: _yolo_labels(4, 2)),
    "YOLO2": ("YOLO2", dict(numClasses=3, anchors=((1.0, 1.0), (2.0, 2.0))),
              (3, 64, 64), lambda: _yolo_labels(3, 2)),
    "SqueezeNet": ("SqueezeNet", dict(numClasses=7), (3, 64, 64),
                   lambda: _onehot(7)),
    "Xception": ("Xception", dict(numClasses=5, middleFlowBlocks=1),
                 (3, 32, 32), lambda: _onehot(5)),
    "InceptionResNetV1": ("InceptionResNetV1",
                          dict(numClasses=5, embeddingSize=16),
                          (3, 96, 96), lambda: _onehot(5)),
    "FaceNetNN4Small2": ("FaceNetNN4Small2",
                         dict(numClasses=6, embeddingSize=16), (3, 64, 64),
                         lambda: _onehot(6)),
    "NASNet": ("NASNet", dict(numClasses=4, numCells=1,
                              penultimateFilters=96, stemFilters=8),
               (3, 64, 64), lambda: _onehot(4)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _no_dropout(conf):
    layers = conf.layers if hasattr(conf, "layers") else [
        n.payload for n in conf.nodes.values() if n.kind == "layer"]
    for layer in layers:
        layer.dropOut = None
    return conf


def _pair(name):
    """The model in both packages in f64 under Sgd(1.0), the port's
    seeded initial weights carried into the reference (``initFrom``, no
    eager reference init)."""
    cls, kw, shape, _ = CASES[name]
    jc = _no_dropout(getattr(JZ, cls)(
        inputShape=shape, updater=J.Sgd(1.0), dataType=JDataType.DOUBLE,
        **kw).conf())
    pc = _no_dropout(getattr(PZ, cls)(
        inputShape=shape, updater=P.Sgd(1.0), dataType=PDataType.DOUBLE,
        device="cpu", **kw).conf())
    graph = hasattr(jc, "nodes")
    pn = (P.ComputationGraph if graph else P.MultiLayerNetwork)(
        pc, device="cpu").init()
    if graph:
        params = g_to_reference(pn.conf, pn._params)
        states = {n: {k: t.numpy() for k, t in st.items()}
                  for n, st in pn._states.items()}
    else:
        params = params_to_reference(pn.layers, pn._params)
        states = [{k: t.numpy() for k, t in st.items()}
                  for st in pn._states]
    jn = (J.ComputationGraph if graph else J.MultiLayerNetwork)(jc).initFrom(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, states))
    return jn, pn, graph


def _flat_params(net, graph, port):
    """{key: reference-layout f64 array} of a network's parameters."""
    if port:
        tree = g_to_reference(net.conf, net._params) if graph else \
            dict(enumerate(params_to_reference(net.layers, net._params)))
    else:
        tree = net._params if graph else dict(enumerate(net._params))
    return {(k, n): np.array(a, np.float64, copy=True)
            for k, d in tree.items()
            for n, a in d.items()}


def _reference_grads(jn, graph, x, y):
    """The reference's ``computeGradientAndScore`` under ``jax.jit``
    (its eager form dispatches op by op)."""
    if graph:
        feed = {jn.conf.networkInputs[0]: jnp.asarray(x)}

        def f(p):
            return jn._loss_fn(p, jn._states, feed, [jnp.asarray(y)], None,
                               None, None, False)
    else:
        def f(p):
            return jn._loss_fn(p, jn._states, jnp.asarray(x),
                               jnp.asarray(y), None, None, None, False)
    (loss, _), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jn._params)
    g = g if graph else dict(enumerate(g))
    return {(k, n): np.asarray(a, np.float64) for k, d in g.items()
            for n, a in d.items()}, float(loss)


def _port_grads(pn, graph, x, y):
    g, score = pn.computeGradientAndScore(x, y)
    g = g_to_reference(pn.conf, g) if graph else \
        dict(enumerate(params_to_reference(pn.layers, g)))
    return {(k, n): np.asarray(a, np.float64) for k, d in g.items()
            for n, a in d.items()}, score


#: NASNet's first reduction cell has near-cancelling gradients: the
#: reference's own jitted and eager evaluations differ there by up to
#: 1.3e-3 (rel L2, stem_r1_y5a_s1's pW, f64), so its parameters are held
#: to 1e-8 of the whole gradient's L2 norm
GLOBAL_NORM = {"NASNet"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_model_matches_the_reference(name):
    """f64, batch 4: the inference output (within 1e-10 of its max-abs),
    the loss (rel 1e-9) and each parameter's gradient (rel L2 1e-8)
    against the reference's, and the port's Sgd(1.0) step: each
    parameter moves by its gradient (within 1e-8 of the gradient's
    max-abs)."""
    jn, pn, graph = _pair(name)
    assert pn.numParams() == jn.numParams()
    x = np.random.RandomState(0).rand(B, *CASES[name][2])
    y = CASES[name][3]().astype(np.float64)
    want = np.asarray(jn.output(x).toNumpy())
    got = pn.output(x).toNumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    jg, js = _reference_grads(jn, graph, x, y)
    pg, ps = _port_grads(pn, graph, x, y)
    assert abs(ps - js) <= 1e-9 * abs(js)
    whole = np.sqrt(sum(np.sum(g ** 2) for g in jg.values()))
    for k, want in jg.items():
        err = np.linalg.norm(pg[k] - want)
        scale = whole if name in GLOBAL_NORM else np.linalg.norm(want)
        assert err <= 1e-8 * scale or err <= 1e-12, (k, err, scale)
    p0 = _flat_params(pn, graph, True)
    pn.fit(x, y)
    assert abs(pn.score() - ps) <= 1e-12 * abs(ps)
    for k, p in _flat_params(pn, graph, True).items():
        step = p0[k] - pg[k]
        np.testing.assert_allclose(
            p, step, rtol=0,
            atol=1e-8 * max(np.abs(pg[k]).max(), 1e-30), err_msg=str(k))


def test_tiny_yolo_output_is_the_raw_nhwc_map():
    """TinyYOLO (a MultiLayerNetwork) returns its head's raw map NHWC,
    [B, grid, grid, A·(5+C)], as the reference's (test_tiny_yolo)."""
    net = PZ.TinyYOLO(numClasses=4, inputShape=(3, 64, 64),
                      device="cpu").init()
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    assert net.output(x).shape() == (2, 2, 2, 5 * 9)
    ds = PDataSet(x, _yolo_labels(4, 2, n=2))
    s0 = net.score(ds)
    net.fit(ds)
    assert np.isfinite(s0) and np.isfinite(net.score(ds))


def test_yolo2_output_and_passthrough_wiring():
    """YOLO2 (a ComputationGraph) returns the map in the API's layout,
    NCHW here, as the reference's graph does; the passthrough route's
    s2d and merge nodes are there (test_yolo2_builds_and_fits,
    test_yolo2_passthrough_wiring)."""
    model = PZ.YOLO2(numClasses=3, inputShape=(3, 64, 64),
                     anchors=((1.0, 1.0), (2.0, 2.0)), device="cpu")
    assert {"route_s2d", "route_cat"} <= set(model.conf().nodes)
    net = model.init()
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    assert net.output(x).shape() == (2, 2 * 8, 2, 2)
    ds = PDataSet(x, _yolo_labels(3, 2, n=2))
    net.fit(ds)
    assert np.isfinite(net.score(ds))


def test_yolo2_nhwc_network_takes_nhwc_labels_like_the_reference():
    """An NHWC-format YOLO2 takes NHWC features and labels; the loss
    permutes the labels back to NCHW, as the reference's networks do."""
    kw = dict(numClasses=3, inputShape=(3, 32, 32),
              anchors=((1.0, 1.0), (2.0, 2.0)), dataFormat="NHWC")
    jn = JZ.YOLO2(**kw).init()
    pn = PZ.YOLO2(device="cpu", **kw).init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    y = _yolo_labels(3, 1, n=2).transpose(0, 2, 3, 1).copy()
    js = jn.score(JDataSet(x, y))
    ps = pn.score(PDataSet(x, y))
    assert abs(ps - js) <= 1e-5 * abs(js)
    want = np.asarray(jn.output(x).toNumpy())
    got = pn.output(x).toNumpy()
    assert got.shape == want.shape == (2, 1, 1, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _cluster(n, hw, classes, seed=0):
    rng = np.random.RandomState(seed)
    templates = rng.rand(classes, 3, hw, hw).astype(np.float32)
    yi = rng.randint(0, classes, n)
    x = 0.8 * templates[yi] + 0.2 * rng.rand(n, 3, hw, hw).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[yi]


@pytest.mark.parametrize("name,hw,lr,iters,factor", [
    ("Darknet19", 32, 3e-4, 12, 0.7),
    ("SqueezeNet", 64, 5e-4, 20, 0.7),
    ("Xception", 32, 3e-4, 12, 0.7),
    ("FaceNetNN4Small2", 64, 3e-4, 10, 0.6),
])
def test_zoo_model_converges(name, hw, lr, iters, factor):
    """TestZooTailConvergence and test_facenet_converges on the port."""
    kw = {"FaceNetNN4Small2": dict(embeddingSize=16),
          "Xception": dict(middleFlowBlocks=1)}.get(name, {})
    net = getattr(PZ, name)(numClasses=3, inputShape=(3, hw, hw),
                            updater=P.Adam(lr), device="cpu", **kw).init()
    x, y = _cluster(8, hw, 3)
    first = None
    for _ in range(iters):
        net.fit(x, y)
        first = first if first is not None else net.score()
    assert np.isfinite(net.score()) and net.score() < factor * first, \
        (first, net.score())


def test_tiny_yolo_converges():
    """test_tiny_yolo_converges: the best loss of 20 fits falls below 0.7
    of the first."""
    net = PZ.TinyYOLO(numClasses=2, inputShape=(3, 32, 32),
                      updater=P.Adam(1e-3), device="cpu").init()
    x = np.random.RandomState(0).rand(4, 3, 32, 32).astype(np.float32)
    lab = np.zeros((4, 6, 1, 1), np.float32)
    for i in range(4):
        lab[i, 0:4, 0, 0] = (0.2, 0.2, 0.8, 0.8)
        lab[i, 4 + (i % 2), 0, 0] = 1.0
    ds = PDataSet(x, lab)
    losses = [net.score(ds)]
    for _ in range(20):
        net.fit(ds)
        losses.append(net.score(ds))
    assert all(np.isfinite(v) for v in losses)
    assert min(losses) < 0.7 * losses[0], losses


def test_squeezenet_threads_the_remat_policy():
    """test_remat_policy's SqueezeNet case: the policy reaches the conf,
    and the remat trajectory equals the stock one."""
    kw = dict(numClasses=5, inputShape=(3, 48, 48), device="cpu")
    sq = PZ.SqueezeNet(checkpointPolicy="save_conv_outputs", **kw)
    net = sq.init()
    assert net.conf.checkpointPolicy == "save_conv_outputs"
    stock = PZ.SqueezeNet(**kw).init()
    stock.setParams(net.params())
    _no_dropout(net.conf)
    _no_dropout(stock.conf)
    x, y = _cluster(2, 48, 5)
    for _ in range(2):
        net.fit(x, y)
        stock.fit(x, y)
    np.testing.assert_allclose(net.params().toNumpy(),
                               stock.params().toNumpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name,kw,shape,classes", [
    ("Darknet19", {}, (3, 32, 32), 10),
    ("SqueezeNet", {}, (3, 64, 64), 7),
    ("Xception", dict(middleFlowBlocks=1), (3, 64, 64), 5),
    ("InceptionResNetV1", dict(embeddingSize=16), (3, 96, 96), 5),
    ("FaceNetNN4Small2", dict(embeddingSize=16), (3, 64, 64), 6),
    ("NASNet", dict(numCells=1, penultimateFilters=96, stemFilters=8),
     (3, 64, 64), 4),
])
def test_zoo_outputs_are_probabilities_and_fit(name, kw, shape, classes):
    """The reference tests' checks on each classifier: the output rows
    are probabilities, the face models' embeddings have unit L2 norm, a
    fit step's loss is finite (test_darknet19, test_squeezenet,
    test_xception, test_inception_resnet_v1, test_facenet_nn4_small2,
    test_nasnet)."""
    net = getattr(PZ, name)(numClasses=classes, inputShape=shape,
                            device="cpu", **kw).init()
    x = np.random.RandomState(0).rand(2, *shape).astype(np.float32)
    out = net.output(x)
    out = out if not isinstance(out, list) else out[0]
    assert out.shape() == (2, classes)
    np.testing.assert_allclose(out.toNumpy().sum(1), np.ones(2), rtol=1e-3)
    if "embeddingSize" in kw:
        emb = net.feedForward(x)["embeddings"].toNumpy()
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), np.ones(2),
                                   rtol=1e-3)
    net.fit(x, _onehot(classes, 2))
    assert np.isfinite(net.score())
