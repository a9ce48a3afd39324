"""Network configuration builders.

The counterpart of ``deeplearning4j_tpu/nn/conf/builder.py`` for graphs:
``NeuralNetConfiguration.Builder`` with the global defaults the encoder
slice reads (seed, updater, dataType, weightInit, activation, l1/l2,
weight decay, gradient normalization) and ``graphBuilder()``; the
automatic format preprocessor; ``GradientNormalization``. ``list()`` and
``MultiLayerConfiguration`` wait for the LeNet slice (ROADMAP.md Queue 1
item 4).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as PP
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["BackpropType", "GradientNormalization", "NeuralNetConfiguration",
           "auto_preprocessor"]


class BackpropType:
    Standard = "standard"
    TruncatedBPTT = "tbptt"


class GradientNormalization:
    NoNormalization = None
    RenormalizeL2PerLayer = "renormalize_l2_per_layer"
    RenormalizeL2PerParamType = "renormalize_l2_per_param_type"
    ClipElementWiseAbsoluteValue = "clip_elementwise"
    ClipL2PerLayer = "clip_l2_per_layer"
    ClipL2PerParamType = "clip_l2_per_param_type"


def _wants(layer):
    """The input format a layer needs (None: any)."""
    if isinstance(layer, L.RnnOutputLayer):
        return InputType.RNN
    if isinstance(layer, (L.DenseLayer, L.BaseOutputLayer)):
        return InputType.FF
    return None


def auto_preprocessor(layer, cur):
    """(preprocessor or None, the InputType after it) for a layer given
    the incoming InputType."""
    wants = _wants(layer)
    if wants is None or cur.kind == wants:
        return None, cur
    if cur.kind == InputType.RNN and wants == InputType.FF:
        pp = PP.RnnToFeedForwardPreProcessor()
        return pp, pp.getOutputType(cur)
    if cur.kind == InputType.FF and wants == InputType.RNN:
        pp = PP.FeedForwardToRnnPreProcessor()
        return pp, pp.getOutputType(cur)
    raise NotImplementedError(
        f"No preprocessor for {cur.kind} -> {wants} (layer "
        f"{type(layer).__name__}): the CNN preprocessors wait for the CNN "
        "slice (ROADMAP.md Queue 1 item 4)")


class NeuralNetConfiguration:
    class Builder:
        def __init__(self):
            self._d = {}

        def seed(self, s):
            self._d["seed"] = int(s)
            return self

        def updater(self, u):
            self._d["updater"] = _upd.resolve(u)
            return self

        def weightInit(self, w):
            self._d["weightInit"] = w
            return self

        def dist(self, distribution):
            self._d["distribution"] = distribution
            self._d["weightInit"] = "distribution"
            return self

        def activation(self, a):
            self._d["activation"] = a
            return self

        def l1(self, v):
            self._d["l1"] = float(v)
            return self

        def l2(self, v):
            self._d["l2"] = float(v)
            return self

        def l1Bias(self, v):
            self._d["l1Bias"] = float(v)
            return self

        def l2Bias(self, v):
            self._d["l2Bias"] = float(v)
            return self

        def weightDecay(self, v):
            self._d["weightDecay"] = float(v)
            return self

        def dataType(self, dt):
            self._d["dataType"] = DataType.from_dtype(dt)
            return self

        def gradientNormalization(self, gn):
            self._d["gradientNormalization"] = gn
            return self

        def gradientNormalizationThreshold(self, t):
            self._d["gradientNormalizationThreshold"] = float(t)
            return self

        def list(self):
            raise NotImplementedError(
                "list() / MultiLayerConfiguration wait for the LeNet slice "
                "(ROADMAP.md Queue 1 item 4); use graphBuilder()")

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

            return GraphBuilder(dict(self._d))
