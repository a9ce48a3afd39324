"""Port parity for the YOLOv2 head (deeplearning4j_tpu_torch/nn/
objdetect.py): Yolo2OutputLayer's loss and its gradient against the
reference's ``computeLoss`` under ``jax.grad``, in f32 and bf16, the
decode, the IOUs, ``getPredictedObjects`` and ``nonMaxSuppression``, the
head inside a MultiLayerNetwork and a ComputationGraph, and a model
file with a Yolo2 head across both packages. Mirrors
tests/test_objdetect.py.

Inputs are seeded numpy draws: a raw map [B, H, W, A·(5+C)] and NCHW
labels [B, 4+C, H, W] with 1-3 boxes an image, corners in grid units,
each in the cell of its center; one label box ties two anchors (the
first must be taken) and empty cells hold zero-width boxes. Bands:
f32 loss rel 1e-6 and gradient within 1e-6 of its max-abs; bf16 (the
reference computes in the prediction's dtype, and so does the port's
``computeLoss``) loss rel 2e-2 and gradient within 5e-2 of its max-abs,
about four bf16 ulps of the loss's ~10 terms; detections equal in count
and class, boxes and confidences within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.nn.objdetect import (
    DetectedObject as JDetected,
    Yolo2OutputLayer as JYolo,
    YoloUtils as JUtils,
)
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSer
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.objdetect import (
    DetectedObject,
    Yolo2OutputLayer,
    YoloUtils,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer as PSer

torch.set_num_threads(2)

ANCHORS = ((1.0, 1.0), (2.5, 2.5), (1.5, 1.5))
C, G, B = 3, 4, 3
CPU = "cpu"


def _labels(seed=0, b=B, tie=True):
    rng = np.random.default_rng(seed)
    lab = np.zeros((b, 4 + C, G, G), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 4)):
            w, h = rng.uniform(0.3, 2.5, 2)
            cx, cy = rng.uniform(0.2, G - 0.2, 2)
            gx, gy = int(cx), int(cy)
            lab[i, 0:4, gy, gx] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                   cy + h / 2)
            lab[i, 4:, gy, gx] = 0
            lab[i, 4 + rng.integers(0, C), gy, gx] = 1.0
    if tie:   # a 1.0 x 1.0 box: IOU 1 with anchor 0, ties none; a 0 box
        lab[0, :, 0, 0] = 0
        lab[0, 0:4, 0, 0] = (0.0, 0.0, 1.0, 1.0)
        lab[0, 4, 0, 0] = 1.0
    return lab


def _pre(seed=1, b=B, scale=1.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(
        (b, G, G, len(ANCHORS) * (5 + C)))).astype(np.float32)


def _ref_loss_and_grad(pre, lab, dtype=jnp.float32):
    layer = JYolo(boundingBoxes=ANCHORS)
    f = lambda p: layer.computeLoss(p, jnp.asarray(lab))
    loss, g = jax.value_and_grad(f)(jnp.asarray(pre, dtype))
    return float(loss), np.asarray(g.astype(jnp.float32))


def _port_loss_and_grad(pre, lab, dtype=torch.float32):
    layer = Yolo2OutputLayer(boundingBoxes=ANCHORS)
    p = torch.tensor(pre).to(dtype).requires_grad_(True)
    loss = layer.computeLoss(p, torch.tensor(lab))
    loss.backward()
    return float(loss), p.grad.float().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_gradient_match_the_reference_f32(seed):
    pre, lab = _pre(seed + 10), _labels(seed)
    jl, jg = _ref_loss_and_grad(pre, lab)
    pl, pg = _port_loss_and_grad(pre, lab)
    assert abs(pl - jl) <= 1e-6 * abs(jl)
    np.testing.assert_allclose(pg, jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())


def test_loss_and_gradient_match_the_reference_bf16():
    pre, lab = _pre(7), _labels(3)
    jl, jg = _ref_loss_and_grad(pre, lab, jnp.bfloat16)
    pl, pg = _port_loss_and_grad(pre, lab, torch.bfloat16)
    assert abs(pl - jl) <= 2e-2 * abs(jl)
    np.testing.assert_allclose(pg, jg, rtol=0,
                               atol=5e-2 * np.abs(jg).max())


def test_the_first_anchor_is_taken_on_ties_and_empty_cells_are_zero():
    """A box whose IOU ties two anchors trains the first; a cell with no
    object has no coordinate, objectness or class gradient but the
    no-object term's, as the reference's."""
    anchors = ((1.0, 1.0), (1.0, 1.0))
    lab = np.zeros((1, 4 + C, 2, 2), np.float32)
    lab[0, 0:4, 0, 0] = (0.0, 0.0, 1.0, 1.0)
    lab[0, 4 + 1, 0, 0] = 1.0
    pre = _pre(3, b=1)[:, :2, :2, :2 * (5 + C)]
    jl = JYolo(boundingBoxes=anchors)
    pl = Yolo2OutputLayer(boundingBoxes=anchors)
    jg = np.asarray(jax.grad(lambda p: jl.computeLoss(
        p, jnp.asarray(lab)))(jnp.asarray(pre)))
    p = torch.tensor(pre, requires_grad=True)
    pl.computeLoss(p, torch.tensor(lab)).backward()
    g = p.grad.numpy().reshape(1, 2, 2, 2, 5 + C)
    np.testing.assert_allclose(g.reshape(jg.shape), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    assert np.abs(g[0, 0, 0, 0, [0, 1, 2, 3, 5, 6, 7]]).max() > 0
    assert np.abs(g[0, 0, 0, 1, [0, 1, 2, 3, 5, 6, 7]]).max() == 0
    assert np.abs(g[0, 1, 1, :, [0, 1, 2, 3, 5, 6, 7]]).max() == 0


def test_decode_and_ious_match_the_reference():
    pre = _pre(5)
    jl, pl = JYolo(boundingBoxes=ANCHORS), Yolo2OutputLayer(
        boundingBoxes=ANCHORS)
    for a, b in zip(jl._decode(jnp.asarray(pre)),
                    pl._decode(torch.tensor(pre))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    rng = np.random.default_rng(0)
    xy_a, wh_a, xy_b, wh_b = (rng.uniform(0.1, 3, (5, 4, 2)).astype(
        np.float32) for _ in range(4))
    np.testing.assert_allclose(
        Yolo2OutputLayer._iou_boxes(*map(torch.tensor,
                                         (xy_a, wh_a, xy_b, wh_b))).numpy(),
        np.asarray(JYolo._iou_boxes(xy_a, wh_a, xy_b, wh_b)), rtol=1e-6)
    np.testing.assert_allclose(
        Yolo2OutputLayer._iou_wh(torch.tensor(wh_a),
                                 torch.tensor(wh_b)).numpy(),
        np.asarray(JYolo._iou_wh(wh_a, wh_b)), rtol=1e-6)


def _same_detections(got, want):
    assert len(got) == len(want)
    key = lambda d: (d.exampleNumber, d.predictedClass, -d.confidence)
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (a.exampleNumber, a.predictedClass) == \
            (b.exampleNumber, b.predictedClass)
        np.testing.assert_allclose(
            [a.centerX, a.centerY, a.width, a.height, a.confidence],
            [b.centerX, b.centerY, b.width, b.height, b.confidence],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold,nms", [(0.5, 0.4), (0.3, 0.6),
                                           (0.7, 0.2)])
def test_predicted_objects_match_the_reference(threshold, nms):
    pre = _pre(11, scale=2.0)
    got = YoloUtils.getPredictedObjects(
        Yolo2OutputLayer(boundingBoxes=ANCHORS), pre, threshold, nms)
    want = JUtils.getPredictedObjects(JYolo(boundingBoxes=ANCHORS), pre,
                                      threshold, nms)
    assert got
    _same_detections(got, want)


def _det(cls, cx, cy, w, h, conf, mod):
    return mod(0, cx, cy, w, h, cls, None, conf)


def test_iou_nms_and_corners_as_the_reference():
    """TestYoloUtils: the IOUs, per-class greedy NMS in the reference's
    order, and the corner accessors."""
    boxes = [(0, 1.0, 1.0, 2.0, 2.0, 0.9), (0, 1.1, 1.0, 2.0, 2.0, 0.7),
             (1, 1.1, 1.0, 2.0, 2.0, 0.6), (0, 5.0, 5.0, 2.0, 2.0, 0.8),
             (1, 1.3, 1.2, 2.0, 1.5, 0.65), (2, 3.0, 3.0, 1.0, 1.0, 0.5)]
    mine = [_det(*b, DetectedObject) for b in boxes]
    ref = [_det(*b, JDetected) for b in boxes]
    for i in range(len(boxes)):
        for j in range(len(boxes)):
            assert YoloUtils.iou(mine[i], mine[j]) == pytest.approx(
                JUtils.iou(ref[i], ref[j]), abs=1e-12)
    keep = YoloUtils.nonMaxSuppression(mine, 0.4)
    want = JUtils.nonMaxSuppression(ref, 0.4)
    assert [boxes[mine.index(d)] for d in keep] == \
        [boxes[ref.index(d)] for d in want]
    a = _det(0, 1.0, 1.0, 2.0, 2.0, 0.9, DetectedObject)
    assert YoloUtils.iou(a, a) == pytest.approx(1.0)
    assert YoloUtils.iou(a, _det(0, 3.0, 1.0, 2.0, 2.0, 0.9,
                                 DetectedObject)) == pytest.approx(0.0)
    assert YoloUtils.iou(a, _det(0, 2.0, 1.0, 2.0, 2.0, 0.9,
                                 DetectedObject)) == pytest.approx(1 / 3)
    d = _det(0, 2.0, 3.0, 2.0, 4.0, 0.9, DetectedObject)
    assert d.getTopLeftXY() == (1.0, 1.0)
    assert d.getBottomRightXY() == (3.0, 5.0)
    assert d.getPredictedClass() == 0 and d.getConfidence() == 0.9


IN = 16


def _conf(M, seed=7, lr=1e-2):
    return (M.NeuralNetConfiguration.Builder()
            .seed(seed).updater(M.Adam(lr))
            .list()
            .layer(M.ConvolutionLayer(nOut=16, kernelSize=(3, 3),
                                      convolutionMode="same",
                                      activation="relu"))
            .layer(M.ConvolutionLayer(nOut=16, kernelSize=(4, 4),
                                      stride=(4, 4), activation="relu"))
            .layer(M.ConvolutionLayer(nOut=len(ANCHORS[:2]) * (5 + C),
                                      kernelSize=(1, 1),
                                      activation="identity"))
            .layer((JYolo if M is J else Yolo2OutputLayer)(
                boundingBoxes=ANCHORS[:2]))
            .setInputType(M.InputType.convolutional(IN, IN, 1))
            .build())


def _mln_labels(boxes):
    lab = np.zeros((2, 4 + C, G, G), np.float32)
    for (b, x1, y1, x2, y2, cls) in boxes:
        cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
        lab[b, 0:4, cy, cx] = (x1, y1, x2, y2)
        lab[b, 4 + cls, cy, cx] = 1.0
    return lab


def test_head_in_a_network_matches_the_reference():
    """The head behind three convs in a MultiLayerNetwork: score,
    gradients, the raw NHWC output and 5 Adam steps, f32 (loss rel 1e-5,
    gradients rel L2 1e-4, params within 1e-5 of the max-abs)."""
    jn = J.MultiLayerNetwork(_conf(J)).init()
    pn = P.MultiLayerNetwork(_conf(P), device=CPU).init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    x = np.random.RandomState(0).rand(2, 1, IN, IN).astype(np.float32)
    y = _mln_labels([(0, 0.2, 0.3, 1.4, 1.8, 0), (1, 2.0, 2.0, 3.5, 3.9, 2)])
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
    for want, got in zip(jg, params_to_reference(pn.layers, pg)):
        for k in want:
            w, g = np.asarray(want[k]), got[k]
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
    want = np.asarray(jn.output(x).toNumpy())
    got = pn.output(x).toNumpy()
    assert got.shape == want.shape == (2, G, G, 2 * (5 + C))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for _ in range(5):
        jn.fit(x, y)
        pn.fit(x, y)
    want = np.asarray(jn.params().toNumpy())
    assert np.abs(pn.params().toNumpy() - want).max() <= \
        1e-5 * np.abs(want).max()


def test_training_decreases_loss_and_empty_labels_score():
    """test_training_decreases_loss, test_no_objects_only_noobj_term,
    test_gradients_flow."""
    net = P.MultiLayerNetwork(_conf(P), device=CPU).init()
    x = np.random.RandomState(0).rand(2, 1, IN, IN).astype(np.float32)
    y = _mln_labels([(0, 0.2, 0.3, 1.4, 1.8, 0), (1, 2.0, 2.0, 3.5, 3.9, 2)])
    ds = DataSet(x, y)
    s0 = net.score(ds)
    assert np.isfinite(s0) and s0 > 0
    empty = net.score(DataSet(x, np.zeros_like(y)))
    assert np.isfinite(empty) and empty >= 0
    grads, _ = net.computeGradientAndScore(x, y)
    flat = [g.numpy() for layer in grads for g in layer.values()]
    assert all(np.isfinite(g).all() for g in flat)
    assert any(np.abs(g).max() > 0 for g in flat)
    for _ in range(60):
        net.fit(ds)
    assert net.score(ds) < 0.5 * s0


def test_overfit_then_detect():
    """test_overfit_then_detect: after 250 steps on one batch the head
    localizes example 0's box with its class."""
    net = P.MultiLayerNetwork(_conf(P, lr=5e-2), device=CPU).init()
    rng = np.random.RandomState(1)
    x = rng.rand(2, 1, IN, IN).astype(np.float32)
    y = _mln_labels([(0, 1.0, 1.0, 2.0, 2.0, 1), (1, 2.2, 0.1, 3.8, 1.9, 2)])
    ds = DataSet(x, y)
    for _ in range(250):
        net.fit(ds)
    dets = YoloUtils.getPredictedObjects(net.layers[-1], net.output(x),
                                         threshold=0.5, nmsThreshold=0.4)
    ex0 = [d for d in dets if d.exampleNumber == 0]
    assert ex0, "no detections for example 0"
    best = max(ex0, key=lambda d: d.confidence)
    assert best.predictedClass == 1
    assert abs(best.centerX - 1.5) < 0.5 and abs(best.centerY - 1.5) < 0.5


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_yolo_model_file_crosses_both_packages(writer, tmp_path):
    """A MultiLayerNetwork with a Yolo2 head saved by either package
    restores in the other with the same output (f32, 1e-6 of the
    max-abs) and the same anchors."""
    jn = J.MultiLayerNetwork(_conf(J)).init()
    pn = P.MultiLayerNetwork(_conf(P), device=CPU).init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    path = str(tmp_path / "yolo.zip")
    x = np.random.RandomState(2).rand(2, 1, IN, IN).astype(np.float32)
    want = np.asarray(jn.output(x).toNumpy())
    if writer == "reference":
        JSer.writeModel(jn, path)
        net = PSer.restoreMultiLayerNetwork(path, device=CPU)
        got = net.output(x).toNumpy()
        anchors = np.asarray(net.layers[-1].anchors)
    else:
        PSer.writeModel(pn, path)
        net = JSer.restoreMultiLayerNetwork(path)
        got = np.asarray(net.output(x).toNumpy())
        anchors = np.asarray(net.layers[-1].anchors)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(anchors, np.asarray(ANCHORS[:2],
                                                      np.float32))


def test_builder_and_refusals():
    layer = (Yolo2OutputLayer.Builder()
             .boundingBoxePriors(np.asarray(ANCHORS))
             .lambdaCoord(2.0).lambdaNoObj(0.25).build())
    assert layer.lambdaCoord == 2.0 and layer.lambdaNoObj == 0.25
    assert layer.anchors.shape == (3, 2)
    with pytest.raises(ValueError, match="boundingBoxes"):
        Yolo2OutputLayer()
