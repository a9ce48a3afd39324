"""Object detection: the YOLOv2 output layer and its inference utilities.

The counterpart of ``deeplearning4j_tpu/nn/objdetect.py`` (reference:
org.deeplearning4j.nn.layers.objdetect — Yolo2OutputLayer,
DetectedObject, YoloUtils). Labels are the reference's NCHW ``[B, 4+C,
H, W]``: (x1, y1, x2, y2) corners in grid units and a per-cell one-hot
class map; a cell holds an object iff its class vector is non-zero. The
head's input is a conv map of A·(5+C) channels for A anchors.

Layouts: the loss reads the prediction as NHWC ``[B, H, W, A·(5+C)]``,
as the reference's does; the networks hand it the NHWC view of their
NCHW-logical map and the labels in NCHW (an NHWC-format network's
labels are permuted back first, as the reference does).
``MultiLayerNetwork.output`` returns the raw map NHWC, as the
reference's does for every 4-d head, which ``getPredictedObjects``
reshapes to ``[B, H, W, A, 5+C]``; a ComputationGraph returns it in the
API's layout, as the reference's graph does.

dtype: ``computeLoss`` computes in the prediction's dtype, as the
reference's; the networks widen a bf16 prediction to f32 before it (as
the reference's networks do for every head with its own loss). The
whole loss is one vectorized expression over ``[B, H, W, A, ...]``;
``getPredictedObjects`` and ``nonMaxSuppression`` run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.layers import LossLayer

__all__ = ["Yolo2OutputLayer", "DetectedObject", "YoloUtils"]

#: the anchor priors on each device and dtype (``Yolo2OutputLayer._anchors``)
_ANCHORS = {}


class Yolo2OutputLayer(LossLayer):
    """YOLOv2 detection loss head (reference:
    conf.layers.objdetect.Yolo2OutputLayer). boundingBoxes: [A, 2]
    anchor priors (w, h) in grid units."""

    #: MultiLayerNetwork.output returns this head's map NHWC
    mlnOutputNHWC = True

    def __init__(self, boundingBoxes=None, lambdaCoord=5.0, lambdaNoObj=0.5,
                 **kw):
        super().__init__(lossFunction="yolo2", **kw)
        if boundingBoxes is None:
            raise ValueError("Yolo2OutputLayer requires anchor boundingBoxes")
        self.anchors = np.asarray(_host(boundingBoxes),
                                  np.float32).reshape(-1, 2)
        self.lambdaCoord = float(lambdaCoord)
        self.lambdaNoObj = float(lambdaNoObj)

    class Builder:
        def __init__(self):
            self._kw = {}

        def boundingBoxePriors(self, priors):
            self._kw["boundingBoxes"] = _host(priors)
            return self

        def lambdaCoord(self, v):
            self._kw["lambdaCoord"] = v
            return self

        def lambdaNoObj(self, v):
            self._kw["lambdaNoObj"] = v
            return self

        def build(self):
            return Yolo2OutputLayer(**self._kw)

    def _anchors(self, like):
        """The priors on `like`'s device and dtype, copied there once
        (kept outside the conf, which stays array-free of tensors): a
        step makes no host-to-device copy, so a captured step replays."""
        a = np.asarray(_host(self.anchors), np.float32)
        key = (a.tobytes(), a.shape, str(like.device), like.dtype)
        t = _ANCHORS.get(key)
        if t is None:
            t = _ANCHORS[key] = torch.as_tensor(
                a, device=like.device).to(like.dtype)
        return t

    # ----- geometry ---------------------------------------------------
    def _decode(self, pre):
        """Raw map [B,H,W,A*(5+C)] -> (xy, wh in grid units, conf, class
        logits), each [B,H,W,A,...]."""
        B, H, W, D = pre.shape
        anchors = self._anchors(pre)
        A = anchors.shape[0]
        p = pre.reshape(B, H, W, A, D // A)
        cx = torch.arange(W, dtype=p.dtype, device=p.device)[None, None, :,
                                                              None]
        cy = torch.arange(H, dtype=p.dtype, device=p.device)[None, :, None,
                                                              None]
        xy = torch.stack([torch.sigmoid(p[..., 0]) + cx,
                          torch.sigmoid(p[..., 1]) + cy], dim=-1)
        wh = anchors * torch.exp(torch.clamp(p[..., 2:4], -10.0, 10.0))
        conf = torch.sigmoid(p[..., 4])
        return xy, wh, conf, p[..., 5:]

    @staticmethod
    def _iou_wh(wh_a, wh_b):
        """IOU of boxes sharing a center; shapes broadcast to [..., 2]."""
        inter = torch.minimum(wh_a[..., 0], wh_b[..., 0]) * \
            torch.minimum(wh_a[..., 1], wh_b[..., 1])
        union = wh_a[..., 0] * wh_a[..., 1] + wh_b[..., 0] * wh_b[..., 1] \
            - inter
        return inter / torch.clamp(union, min=1e-9)

    @staticmethod
    def _iou_boxes(xy_a, wh_a, xy_b, wh_b):
        lo = torch.maximum(xy_a - wh_a / 2, xy_b - wh_b / 2)
        hi = torch.minimum(xy_a + wh_a / 2, xy_b + wh_b / 2)
        inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
        union = torch.prod(wh_a, -1) + torch.prod(wh_b, -1) - inter
        return inter / torch.clamp(union, min=1e-9)

    # ----- loss -------------------------------------------------------
    def computeLoss(self, pre, labels, mask=None, params=None):
        """The mean detection loss of NHWC `pre` against NCHW `labels`
        (reference: ``computeLoss``, term by term)."""
        lab = labels.permute(0, 2, 3, 1).to(pre.dtype)        # [B,H,W,4+C]
        box, cls_lab = lab[..., :4], lab[..., 4:]
        obj = (cls_lab.sum(-1) > 0).to(pre.dtype)              # [B,H,W]
        xy_p, wh_p, conf, cls_logits = self._decode(pre)
        xy_l = torch.stack([(box[..., 0] + box[..., 2]) / 2,
                            (box[..., 1] + box[..., 3]) / 2], -1)
        wh_l = torch.stack([box[..., 2] - box[..., 0],
                            box[..., 3] - box[..., 1]], -1)
        # the responsible anchor: the best shape-IOU prior, the first on
        # ties (a cell with no object has IOU 0 with every prior)
        anchors = self._anchors(pre)
        prior_iou = self._iou_wh(wh_l[..., None, :], anchors)   # [B,H,W,A]
        # one-hot by comparison: F.one_hot checks its indices on the host
        # (a sync a step, and refused inside a captured step)
        resp = (prior_iou.argmax(-1)[..., None] == torch.arange(
            anchors.shape[0], device=pre.device)).to(pre.dtype)
        resp = resp * obj[..., None]
        n_obj = torch.clamp(obj.sum(), min=1.0)
        d_xy = (xy_p - xy_l[..., None, :]).square().sum(-1)
        d_wh = (torch.sqrt(torch.clamp(wh_p, min=1e-9))
                - torch.sqrt(torch.clamp(wh_l[..., None, :], min=1e-9))
                ).square().sum(-1)
        loss_coord = self.lambdaCoord * (resp * (d_xy + d_wh)).sum() / n_obj
        iou = self._iou_boxes(xy_p, wh_p, xy_l[..., None, :],
                              wh_l[..., None, :]).detach()
        loss_obj = (resp * (conf - iou).square()).sum() / n_obj
        loss_noobj = self.lambdaNoObj * ((1.0 - resp) * conf.square()).sum() \
            / torch.clamp((1.0 - resp).sum(), min=1.0)
        logp = torch.log_softmax(cls_logits, -1)
        ce = -(cls_lab[..., None, :] * logp).sum(-1)            # [B,H,W,A]
        loss_cls = (resp * ce).sum() / n_obj
        return loss_coord + loss_obj + loss_noobj + loss_cls

    def forward(self, params, state, x, train, key, mask=None):
        return x, state   # the raw map; YoloUtils decodes it


def _host(v):
    """An INDArray, tensor or array-like -> numpy (or as it is)."""
    if hasattr(v, "toNumpy"):
        return v.toNumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return v


class DetectedObject:
    """One detection (reference: objdetect.DetectedObject); coordinates
    in grid units."""

    def __init__(self, exampleNumber, centerX, centerY, width, height,
                 predictedClass, classPredictions, confidence):
        self.exampleNumber = exampleNumber
        self.centerX, self.centerY = centerX, centerY
        self.width, self.height = width, height
        self.predictedClass = predictedClass
        self.classPredictions = classPredictions
        self.confidence = confidence

    def getTopLeftXY(self):
        return (self.centerX - self.width / 2, self.centerY - self.height / 2)

    def getBottomRightXY(self):
        return (self.centerX + self.width / 2, self.centerY + self.height / 2)

    def getPredictedClass(self):
        return self.predictedClass

    def getConfidence(self):
        return self.confidence

    def __repr__(self):
        return (f"DetectedObject(ex={self.exampleNumber}, "
                f"cls={self.predictedClass}, conf={self.confidence:.3f}, "
                f"xywh=({self.centerX:.2f}, {self.centerY:.2f}, "
                f"{self.width:.2f}, {self.height:.2f}))")


class YoloUtils:
    """Host-side decode and NMS (reference: objdetect.YoloUtils)."""

    @staticmethod
    def getPredictedObjects(layer, networkOutput, threshold=0.5,
                            nmsThreshold=0.4):
        """networkOutput: the raw map [B,H,W,A*(5+C)] of a Yolo2 head.
        Returns the DetectedObjects of every example, each example's
        after greedy per-class NMS."""
        out = torch.as_tensor(np.asarray(_host(networkOutput)))
        with torch.no_grad():
            xy, wh, conf, cls_logits = layer._decode(out)
            cls_prob = torch.softmax(cls_logits, -1)
        xy, wh, conf, cls_prob = (t.numpy() for t in (xy, wh, conf,
                                                      cls_prob))
        dets = []
        for b in range(out.shape[0]):
            cand = []
            for (i, j, a) in np.argwhere(conf[b] >= threshold):
                cand.append(DetectedObject(
                    b, float(xy[b, i, j, a, 0]), float(xy[b, i, j, a, 1]),
                    float(wh[b, i, j, a, 0]), float(wh[b, i, j, a, 1]),
                    int(np.argmax(cls_prob[b, i, j, a])),
                    cls_prob[b, i, j, a], float(conf[b, i, j, a])))
            dets.extend(YoloUtils.nonMaxSuppression(cand, nmsThreshold))
        return dets

    @staticmethod
    def iou(d1, d2):
        x1, y1 = d1.getTopLeftXY()
        x2, y2 = d1.getBottomRightXY()
        u1, v1 = d2.getTopLeftXY()
        u2, v2 = d2.getBottomRightXY()
        iw = max(0.0, min(x2, u2) - max(x1, u1))
        ih = max(0.0, min(y2, v2) - max(y1, v1))
        inter = iw * ih
        union = d1.width * d1.height + d2.width * d2.height - inter
        return inter / union if union > 0 else 0.0

    @staticmethod
    def nonMaxSuppression(dets, nmsThreshold=0.4):
        """Greedy per-class NMS in the reference's order (classes in the
        order first seen, each by falling confidence)."""
        keep = []
        by_class = {}
        for d in dets:
            by_class.setdefault(d.predictedClass, []).append(d)
        for ds in by_class.values():
            ds = sorted(ds, key=lambda d: -d.confidence)
            while ds:
                best = ds.pop(0)
                keep.append(best)
                ds = [d for d in ds if YoloUtils.iou(best, d) < nmsThreshold]
        return keep
