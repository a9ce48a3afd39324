"""Network configuration spaces — the arbiter DSL over layer configs.

The counterpart of ``deeplearning4j_tpu/arbiter/layerspace.py``; the
built networks are the port's, on the device the space's builder names
(``.device(...)``, default the card). Reference: arbiter-deeplearning4j
org.deeplearning4j.arbiter.MultiLayerSpace +
layers.DenseLayerSpace/OutputLayerSpace/ConvolutionLayerSpace (Builder DSL where any hyperparameter can be a
fixed value or a ParameterSpace). Upstream materializes a
MultiLayerConfiguration from a double[] chromosome; here the space
flattens to the SAME named-ParameterSpace dict every generator
(random/grid/genetic) already consumes, and `modelBuilder` closes the
loop for LocalOptimizationRunner — so one DSL serves all three search
strategies with no chromosome plumbing.

    space = (MultiLayerSpace.Builder()
             .seed(7)
             .learningRate(ContinuousParameterSpace(1e-4, 1e-1, log=True))
             .addLayer(DenseLayerSpace(nIn=6,
                                       nOut=IntegerParameterSpace(4, 32),
                                       activation=DiscreteParameterSpace(
                                           "relu", "tanh")))
             .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
             .build())
    gen = RandomSearchGenerator(space.parameterSpaces())
    runner = LocalOptimizationRunner(conf, space.modelBuilder, train)
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.arbiter.spaces import ParameterSpace


class LayerSpace:
    """One layer whose constructor kwargs may be fixed values or
    ParameterSpaces. Generic form: LayerSpace(DenseLayer, nOut=...);
    the named subclasses below mirror the upstream class names."""

    def __init__(self, layer_cls, **kwargs):
        self.layer_cls = layer_cls
        self.kwargs = kwargs

    def _spaces(self, index):
        return {f"{index}_{k}": v for k, v in self.kwargs.items()
                if isinstance(v, ParameterSpace)}

    def materialize(self, index, candidate):
        kw = {k: (candidate[f"{index}_{k}"]
                  if isinstance(v, ParameterSpace) else v)
              for k, v in self.kwargs.items()}
        return self.layer_cls(**kw)


class DenseLayerSpace(LayerSpace):
    def __init__(self, **kwargs):
        from deeplearning4j_tpu_torch.nn import DenseLayer

        super().__init__(DenseLayer, **kwargs)


class OutputLayerSpace(LayerSpace):
    def __init__(self, **kwargs):
        from deeplearning4j_tpu_torch.nn import OutputLayer

        super().__init__(OutputLayer, **kwargs)


class ConvolutionLayerSpace(LayerSpace):
    def __init__(self, **kwargs):
        from deeplearning4j_tpu_torch.nn import ConvolutionLayer

        super().__init__(ConvolutionLayer, **kwargs)


class MultiLayerSpace:
    """Built space: parameterSpaces() feeds any candidate generator;
    modelBuilder(candidate) is the LocalOptimizationRunner callback."""

    class Builder:
        def __init__(self):
            self._layers = []
            self._seed = 12345
            self._lr = 1e-3
            self._updater_factory = None
            self._input_type = None
            self._device = None

        def seed(self, s):
            self._seed = int(s)
            return self

        def learningRate(self, lr):
            """Fixed float or a ParameterSpace (exposed as 'learningRate'
            in the candidate dict)."""
            self._lr = lr
            return self

        def updater(self, factory):
            """Callable lr -> updater instance (default: Adam)."""
            self._updater_factory = factory
            return self

        def device(self, device):
            """Where the built networks live (default: the card)."""
            self._device = device
            return self

        def addLayer(self, layer_space):
            if not isinstance(layer_space, LayerSpace):
                raise TypeError("addLayer expects a LayerSpace")
            self._layers.append(layer_space)
            return self

        def setInputType(self, input_type):
            self._input_type = input_type
            return self

        def build(self):
            if not self._layers:
                raise ValueError("MultiLayerSpace needs at least one layer")
            return MultiLayerSpace(self)

    def __init__(self, b):
        self._layers = list(b._layers)
        self._seed = b._seed
        self._lr = b._lr
        self._updater_factory = b._updater_factory
        self._input_type = b._input_type
        self._device = b._device

    def parameterSpaces(self) -> dict:
        out = {}
        if isinstance(self._lr, ParameterSpace):
            out["learningRate"] = self._lr
        for i, ls in enumerate(self._layers):
            out.update(ls._spaces(i))
        if not out:
            raise ValueError(
                "no ParameterSpaces in this MultiLayerSpace — every "
                "hyperparameter is fixed, there is nothing to search")
        return out

    def modelBuilder(self, candidate: dict):
        from deeplearning4j_tpu_torch.nn import (
            Adam, MultiLayerNetwork, NeuralNetConfiguration)

        lr = candidate.get("learningRate", self._lr)
        factory = self._updater_factory or Adam
        builder = (NeuralNetConfiguration.Builder()
                   .seed(self._seed).updater(factory(lr)).list())
        for i, ls in enumerate(self._layers):
            builder.layer(ls.materialize(i, candidate))
        if self._input_type is not None:
            builder.setInputType(self._input_type)
        return MultiLayerNetwork(builder.build(),
                                 device=self._device).init()


class ComputationGraphSpace:
    """Graph-topology search space (reference: arbiter-deeplearning4j
    org.deeplearning4j.arbiter.ComputationGraphSpace). Same flattening
    contract as MultiLayerSpace, but hyperparameters are keyed by vertex
    NAME ("dense_nOut") instead of layer index."""

    class Builder:
        def __init__(self):
            self._inputs = []
            self._layers = []      # (name, LayerSpace, input names)
            self._outputs = []
            self._input_types = None
            self._seed = 12345
            self._lr = 1e-3
            self._updater_factory = None
            self._device = None

        def seed(self, s):
            self._seed = int(s)
            return self

        def learningRate(self, lr):
            self._lr = lr
            return self

        def updater(self, factory):
            self._updater_factory = factory
            return self

        def device(self, device):
            """Where the built graphs live (default: the card)."""
            self._device = device
            return self

        def addInputs(self, *names):
            self._inputs.extend(names)
            return self

        def addLayer(self, name, layer_space, *inputs):
            if not isinstance(layer_space, LayerSpace):
                raise TypeError("addLayer expects a LayerSpace")
            self._layers.append((name, layer_space, inputs))
            return self

        def setOutputs(self, *names):
            self._outputs = list(names)
            return self

        def setInputTypes(self, *types):
            self._input_types = types
            return self

        def build(self):
            if not self._inputs or not self._outputs or not self._layers:
                raise ValueError("ComputationGraphSpace needs addInputs, "
                                 "addLayer, and setOutputs")
            return ComputationGraphSpace(self)

    def __init__(self, b):
        self._inputs = list(b._inputs)
        self._layers = list(b._layers)
        self._outputs = list(b._outputs)
        self._input_types = b._input_types
        self._seed = b._seed
        self._lr = b._lr
        self._updater_factory = b._updater_factory
        self._device = b._device

    def parameterSpaces(self) -> dict:
        out = {}
        if isinstance(self._lr, ParameterSpace):
            out["learningRate"] = self._lr
        for name, ls, _ in self._layers:
            out.update(ls._spaces(name))
        if not out:
            raise ValueError(
                "no ParameterSpaces in this ComputationGraphSpace — every "
                "hyperparameter is fixed, there is nothing to search")
        return out

    def modelBuilder(self, candidate: dict):
        from deeplearning4j_tpu_torch.nn import (
            Adam, ComputationGraph, NeuralNetConfiguration)

        lr = candidate.get("learningRate", self._lr)
        factory = self._updater_factory or Adam
        gb = (NeuralNetConfiguration.Builder()
              .seed(self._seed).updater(factory(lr)).graphBuilder()
              .addInputs(*self._inputs))
        for name, ls, inputs in self._layers:
            gb.addLayer(name, ls.materialize(name, candidate), *inputs)
        gb.setOutputs(*self._outputs)
        if self._input_types is not None:
            gb.setInputTypes(*self._input_types)
        return ComputationGraph(gb.build(), device=self._device).init()
