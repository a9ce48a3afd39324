"""Network configuration builders.

The counterpart of ``deeplearning4j_tpu/nn/conf/builder.py``:
``NeuralNetConfiguration.Builder`` with its global defaults (seed,
updater, biasUpdater, dataType, weightInit, activation, l1/l2, weight
decay, dropout, weight noise, the constraints, gradient normalization,
checkpointPolicy), ``list()`` ->
``ListBuilder`` -> ``MultiLayerConfiguration`` (the sequential network's
shape-inference walk, which infers each layer's nIn and inserts the
format preprocessors) and ``graphBuilder()``; the automatic format
preprocessor; ``GradientNormalization``.

``checkpointPolicy`` is validated and stored as the reference does; the
networks run their training forward under it (``nn/multilayer.py``
``remat_segment``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as PP
from deeplearning4j_tpu_torch.nn.conf import recurrent as R
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["BackpropType", "GradientNormalization", "NeuralNetConfiguration",
           "MultiLayerConfiguration", "ListBuilder", "auto_preprocessor",
           "CHECKPOINT_POLICIES"]


class BackpropType:
    Standard = "standard"
    TruncatedBPTT = "tbptt"


#: the reference's named rematerialisation policies
CHECKPOINT_POLICIES = (None, "save_conv_outputs")


class GradientNormalization:
    NoNormalization = None
    RenormalizeL2PerLayer = "renormalize_l2_per_layer"
    RenormalizeL2PerParamType = "renormalize_l2_per_param_type"
    ClipElementWiseAbsoluteValue = "clip_elementwise"
    ClipL2PerLayer = "clip_l2_per_layer"
    ClipL2PerParamType = "clip_l2_per_param_type"


class MultiLayerConfiguration:
    """Reference: MultiLayerConfiguration (built by ListBuilder)."""

    def __init__(self, layers, defaults, seed, dataType, inputType,
                 preprocessors, backpropType, tbpttFwdLength,
                 tbpttBackLength, gradientNormalization=None,
                 gradientNormalizationThreshold=1.0):
        self.layers = layers
        self.defaults = defaults
        self.seed = seed
        self.dataType = dataType
        self.inputType = inputType
        self.preprocessors = preprocessors  # {layer_index: preprocessor}
        self.backpropType = backpropType
        self.tbpttFwdLength = tbpttFwdLength
        self.tbpttBackLength = tbpttBackLength
        self.gradientNormalization = gradientNormalization
        self.gradientNormalizationThreshold = gradientNormalizationThreshold
        self.optimizationAlgo = defaults.get(
            "optimizationAlgo", "STOCHASTIC_GRADIENT_DESCENT")
        self.maxNumLineSearchIterations = defaults.get(
            "maxNumLineSearchIterations", 20)
        self.checkpointPolicy = defaults.get("checkpointPolicy")
        self.layerInputTypes = []   # resolved per layer by inferShapes

    def toJson(self) -> str:
        """Config-only JSON in the reference's format (reference:
        MultiLayerConfiguration.toJson; ``util.serde``)."""
        from deeplearning4j_tpu_torch.util import serde

        return serde.to_json(self)

    @staticmethod
    def fromJson(text: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.util import serde

        return serde.from_json(text, MultiLayerConfiguration)

    def inferShapes(self):
        """Propagate the InputType through the layers, inferring nIn and
        inserting preprocessors (reference: ``inferShapes``)."""
        cur = self.inputType
        if cur.kind == InputType.CNN_FLAT:
            if isinstance(self.layers[0], (L.ConvolutionLayer,
                                           L.SubsamplingLayer,
                                           L.BatchNormalization)):
                self.preprocessors.setdefault(
                    0, PP.FeedForwardToCnnPreProcessor(
                        cur.height, cur.width, cur.channels))
                cur = InputType.convolutional(cur.height, cur.width,
                                              cur.channels)
            else:
                cur = InputType.feedForward(cur.arrayElementsPerExample())
        self.layerInputTypes = []
        for i, layer in enumerate(self.layers):
            layer.mergeGlobals(self.defaults)
            if i in self.preprocessors:
                cur = self.preprocessors[i].getOutputType(cur)
            else:
                pp, cur2 = auto_preprocessor(layer, cur)
                if pp is not None:
                    self.preprocessors[i] = pp
                    cur = cur2
            if hasattr(layer, "inferNIn"):
                layer.inferNIn(cur)
            self.layerInputTypes.append(cur)
            cur = layer.getOutputType(cur)
        self.outputType = cur
        return self


def _unwrap_layer(layer):
    """The layer a delegating wrapper holds (MaskZeroLayer.underlying,
    FrozenLayerWithBackprop.layer), for format and nIn inference;
    Bidirectional declares its own format and is not looked through."""
    for _ in range(8):
        inner = layer.__dict__.get("underlying") or layer.__dict__.get(
            "layer")
        if inner is None or isinstance(layer, R.Bidirectional):
            return layer
        layer = inner
    return layer


def _wants(layer):
    """The input format a layer needs (None: any)."""
    layer = _unwrap_layer(layer)
    if isinstance(layer, (R.BaseRecurrentLayer, R.Bidirectional,
                          R.LastTimeStep, L.RnnOutputLayer,
                          L.Convolution1DLayer, L.EmbeddingSequenceLayer)):
        return InputType.RNN
    if isinstance(layer, (L.ConvolutionLayer, L.SubsamplingLayer,
                          L.Upsampling2D, L.ZeroPaddingLayer, L.Cropping2D,
                          L.LocalResponseNormalization)):
        return InputType.CNN
    if isinstance(layer, (L.DenseLayer, L.BaseOutputLayer,
                          L.EmbeddingLayer)):
        return InputType.FF
    return None


def input_type_from_first_layer(layers):
    """The input type an explicit first-layer nIn implies when no
    setInputType(...) was given (looking through wrappers), or None."""
    first = _unwrap_layer(layers[0])
    if getattr(first, "nIn", None) is None:
        return None
    if isinstance(first, (R.BaseRecurrentLayer, R.Bidirectional,
                          L.RnnOutputLayer)):
        return InputType.recurrent(first.nIn)
    return InputType.feedForward(first.nIn)


def auto_preprocessor(layer, cur):
    """(preprocessor or None, the InputType after it) for a layer given
    the incoming InputType."""
    wants = _wants(layer)
    if wants is None or cur.kind == wants:
        return None, cur
    if cur.kind == InputType.CNN and wants == InputType.FF:
        pp = PP.CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                             cur.channels)
        return pp, pp.getOutputType(cur)
    if cur.kind == InputType.RNN and wants == InputType.FF:
        pp = PP.RnnToFeedForwardPreProcessor()
        return pp, pp.getOutputType(cur)
    if cur.kind == InputType.FF and wants == InputType.RNN:
        pp = PP.FeedForwardToRnnPreProcessor()
        return pp, pp.getOutputType(cur)
    if cur.kind == InputType.CNN and wants == InputType.RNN:
        pp = PP.CnnToRnnPreProcessor(cur.height, cur.width, cur.channels)
        return pp, pp.getOutputType(cur)
    raise ValueError(f"No preprocessor for {cur.kind} -> {wants} (layer "
                     f"{type(layer).__name__})")


class ListBuilder:
    """Reference: NeuralNetConfiguration.ListBuilder."""

    def __init__(self, defaults):
        self._defaults = defaults
        self._layers = []
        self._preprocessors = {}
        self._inputType = None
        self._backpropType = BackpropType.Standard
        self._tbpttFwd = self._tbpttBack = 20

    def layer(self, *args):
        """layer(l) or layer(index, l), as the reference."""
        if len(args) == 2:
            idx, layer = args
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = layer
        else:
            self._layers.append(args[0])
        return self

    def setInputType(self, it):
        self._inputType = it
        return self

    def inputPreProcessor(self, idx, pp):
        self._preprocessors[idx] = pp
        return self

    def backpropType(self, bp):
        self._backpropType = bp
        return self

    def tBPTTForwardLength(self, n):
        self._tbpttFwd = n
        return self

    def tBPTTBackwardLength(self, n):
        self._tbpttBack = n
        return self

    def tBPTTLength(self, n):
        self._tbpttFwd = self._tbpttBack = n
        return self

    def build(self) -> MultiLayerConfiguration:
        if any(layer is None for layer in self._layers):
            raise ValueError("Gap in layer indices")
        d = self._defaults
        conf = MultiLayerConfiguration(
            layers=self._layers, defaults=d, seed=d.get("seed", 12345),
            dataType=d.get("dataType", DataType.FLOAT),
            inputType=self._inputType,
            preprocessors=dict(self._preprocessors),
            backpropType=self._backpropType,
            tbpttFwdLength=self._tbpttFwd, tbpttBackLength=self._tbpttBack,
            gradientNormalization=d.get("gradientNormalization"),
            gradientNormalizationThreshold=d.get(
                "gradientNormalizationThreshold", 1.0))
        if conf.inputType is None:
            # every nIn set explicitly: the input type of the first layer
            conf.inputType = input_type_from_first_layer(self._layers)
            if conf.inputType is None:
                raise ValueError(
                    "Either setInputType(...) or nIn on the first layer")
        return conf.inferShapes()


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

        def biasUpdater(self, u):
            """The biases' own updater (reference: Builder.biasUpdater):
            each layer's biases step with it and keep its state."""
            self._d["biasUpdater"] = _upd.resolve(u)
            return self

        def weightNoise(self, wn):
            """DropConnect or WeightNoise on every layer's weights in
            training (reference: Builder.weightNoise)."""
            self._d["weightNoise"] = wn
            return self

        def dropOut(self, v):
            """Every layer's input dropout: a retain probability or an
            ``IDropout`` (reference: Builder.dropOut)."""
            self._d["dropOut"] = float(v) if isinstance(v, (int, float)) \
                else v
            return self

        def _add_constraints(self, constraints, weights, biases):
            import copy

            # configured copies: a constraint shared between builders
            # keeps its own flags
            cs = []
            for c in constraints:
                c = copy.copy(c)
                c.applyToWeights, c.applyToBiases = weights, biases
                cs.append(c)
            self._d["constraints"] = (self._d.get("constraints") or []) + cs
            return self

        def constrainWeights(self, *constraints):
            """Project every layer's weights after each update (reference:
            Builder.constrainWeights)."""
            return self._add_constraints(constraints, True, False)

        def constrainBias(self, *constraints):
            return self._add_constraints(constraints, False, True)

        def constrainAllParameters(self, *constraints):
            return self._add_constraints(constraints, True, True)

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

        def optimizationAlgo(self, algo):
            """Reference: NeuralNetConfiguration.Builder.optimizationAlgo
            (OptimizationAlgorithm): STOCHASTIC_GRADIENT_DESCENT (the
            default, per-layer updaters), LINE_GRADIENT_DESCENT,
            CONJUGATE_GRADIENT or LBFGS (``nn/solvers.py``: one
            whole-parameter step with its line search)."""
            from deeplearning4j_tpu_torch.nn.solvers import \
                OptimizationAlgorithm

            self._d["optimizationAlgo"] = OptimizationAlgorithm.resolve(algo)
            return self

        def maxNumLineSearchIterations(self, n):
            """Line-search iteration cap for the non-SGD algorithms
            (reference: Builder.maxNumLineSearchIterations)."""
            self._d["maxNumLineSearchIterations"] = int(n)
            return self

        def checkpointPolicy(self, policy):
            """The reference's named remat policy ("save_conv_outputs"
            or None), validated and stored; see the module docstring."""
            if policy not in CHECKPOINT_POLICIES:
                raise ValueError(f"unknown checkpointPolicy {policy!r}")
            self._d["checkpointPolicy"] = policy
            return self

        def list(self):
            return ListBuilder(dict(self._d))

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

            return GraphBuilder(dict(self._d))
