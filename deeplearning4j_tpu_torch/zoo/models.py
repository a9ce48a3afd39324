"""Zoo model definitions.

The counterpart of ``deeplearning4j_tpu/zoo/models.py`` for the headline
networks: ``ZooModel``, ``LeNet`` (through ``MultiLayerNetwork``),
``ResNet50`` with the standard stem (through ``ComputationGraph``) and
the char-RNN ``TextGenerationLSTM`` (through ``MultiLayerNetwork``), with
the reference's architectures, defaults and layer names, so the
reference's parameters carry across by name. ``dataType=BFLOAT16``
computes in bf16 over fp32 master weights; ``dataFormat="NHWC"`` makes
fit/output take [B,H,W,C] features. ``device`` follows the port's device
policy: the card unless ``"cpu"`` is asked for.

Waiting for their slices: the ``space_to_depth`` stem and
``checkpointPolicy`` (ROADMAP.md Queue 1 item 5), loading pretrained
weights from a file (item 12), and the other zoo models.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration, ElementWiseVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, OutputLayer, RnnOutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.nn.weights import WeightInit

__all__ = ["ZooModel", "LeNet", "ResNet50", "TextGenerationLSTM"]


class ZooModel:
    def __init__(self, numClasses=1000, seed=123, inputShape=None,
                 updater=None, cacheMode=None, workspaceMode=None,
                 dataType=None, dataFormat="NCHW", checkpointPolicy=None,
                 device=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape or self.defaultInputShape()
        self.updater = updater
        self.dataType = dataType or DataType.FLOAT
        self.checkpointPolicy = checkpointPolicy
        # inputShape stays the logical (C, H, W) either way; "NHWC" means
        # fit/output receive [B,H,W,C] arrays
        self.dataFormat = str(dataFormat).upper()
        self.device = device

    @staticmethod
    def defaultInputShape():
        return (3, 224, 224)

    def conf(self):
        raise NotImplementedError

    def init(self):
        conf = self.conf()
        if self.checkpointPolicy is not None:
            if self.checkpointPolicy != "save_conv_outputs":
                raise ValueError(
                    f"unknown checkpointPolicy {self.checkpointPolicy!r}")
            conf.checkpointPolicy = self.checkpointPolicy
        net = (ComputationGraph(conf, self.device)
               if isinstance(conf, ComputationGraphConfiguration)
               else MultiLayerNetwork(conf, self.device))
        return net.init()

    def initPretrained(self, pretrainedType="imagenet", localFile=None):
        """Pretrained weights come from a local file in the reference;
        none is bundled, and loading one waits for its slice."""
        if localFile is None:
            raise NotImplementedError(
                f"Pretrained '{pretrainedType}' weights are not bundled in "
                "this build (no network egress). Pass localFile=<path> to "
                "a locally-supplied file, or train from scratch.")
        raise NotImplementedError(
            "loading pretrained weights from a file waits for the "
            "remaining-workloads slice (ROADMAP.md Queue 1 item 12)")


class LeNet(ZooModel):
    """Reference: zoo.model.LeNet (LeCun's MNIST CNN)."""

    @staticmethod
    def defaultInputShape():
        return (1, 28, 28)

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .weightInit(WeightInit.XAVIER)
                .dataType(self.dataType)
                .list()
                .layer(ConvolutionLayer(nOut=20, kernelSize=(5, 5),
                                        stride=(1, 1), activation="relu"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=50, kernelSize=(5, 5),
                                        activation="relu"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(nOut=500, activation="relu"))
                .layer(OutputLayer(nOut=self.numClasses, activation="softmax",
                                   lossFunction="mcxent"))
                .setInputType(InputType.convolutionalFlat(h, w, c))
                .build())


class ResNet50(ZooModel):
    """Reference: zoo.model.ResNet50 (He et al.'s bottleneck-v1 graph),
    the standard 7x7/s2 stem."""

    def __init__(self, stemMode="standard", **kw):
        super().__init__(**kw)
        if stemMode == "space_to_depth":
            raise NotImplementedError(
                "stemMode='space_to_depth' (ZeroPadding + SpaceToDepth "
                "stem) waits for the ResNet slice's remaining layers "
                "(ROADMAP.md Queue 1 item 5)")
        if stemMode != "standard":
            raise ValueError(f"unknown stemMode {stemMode!r}")
        self.stemMode = stemMode

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-1, 0.9))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .checkpointPolicy(self.checkpointPolicy)
             .graphBuilder()
             .addInputs("input"))
        g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(7, 7),
                                             stride=(2, 2), padding=(3, 3),
                                             activation="identity",
                                             hasBias=False), "input")
        g.addLayer("bn1", BatchNormalization(activation="relu"), "conv1")
        g.addLayer("pool1", SubsamplingLayer(poolingType="max",
                                             kernelSize=(3, 3), stride=(2, 2),
                                             padding=(1, 1)), "bn1")
        prev = "pool1"
        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                  (3, 512, 2048, 2)]
        for si, (blocks, mid, out, stride0) in enumerate(stages):
            for bi in range(blocks):
                prev = self._bottleneck(g, f"s{si}b{bi}", prev, mid, out,
                                        stride0 if bi == 0 else 1,
                                        project=(bi == 0))
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), prev)
        g.addLayer("fc", OutputLayer(nOut=self.numClasses,
                                     activation="softmax",
                                     lossFunction="mcxent"), "gap")
        return (g.setOutputs("fc")
                .setInputTypes(InputType.convolutional(
                    h, w, c, format=self.dataFormat))
                .build())

    @staticmethod
    def _bottleneck(g, name, inp, mid, out, stride, project):
        def conv(n, k, s=1, mode="truncate"):
            return ConvolutionLayer(nOut=n, kernelSize=(k, k),
                                    stride=(s, s), convolutionMode=mode,
                                    activation="identity", hasBias=False)

        g.addLayer(f"{name}_c1", conv(mid, 1, stride), inp)
        g.addLayer(f"{name}_b1", BatchNormalization(activation="relu"),
                   f"{name}_c1")
        g.addLayer(f"{name}_c2", conv(mid, 3, mode="same"), f"{name}_b1")
        g.addLayer(f"{name}_b2", BatchNormalization(activation="relu"),
                   f"{name}_c2")
        g.addLayer(f"{name}_c3", conv(out, 1), f"{name}_b2")
        g.addLayer(f"{name}_b3", BatchNormalization(activation="identity"),
                   f"{name}_c3")
        if project:
            g.addLayer(f"{name}_proj", conv(out, 1, stride), inp)
            g.addLayer(f"{name}_projbn",
                       BatchNormalization(activation="identity"),
                       f"{name}_proj")
            shortcut = f"{name}_projbn"
        else:
            shortcut = inp
        g.addVertex(f"{name}_add", ElementWiseVertex("add"), f"{name}_b3",
                    shortcut)
        g.addLayer(f"{name}_relu", ActivationLayer(activation="relu"),
                   f"{name}_add")
        return f"{name}_relu"


class TextGenerationLSTM(ZooModel):
    """Reference: zoo.model.TextGenerationLSTM (a char-RNN): LSTM(256) ->
    LSTM(256) -> RnnOutputLayer(softmax, MCXENT) over a one-hot vocab."""

    def __init__(self, totalUniqueCharacters=77, maxLength=40, **kw):
        kw.setdefault("numClasses", totalUniqueCharacters)
        super().__init__(**kw)
        self.vocab = totalUniqueCharacters
        self.maxLength = maxLength

    @staticmethod
    def defaultInputShape():
        return None

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(2e-3))
                .weightInit(WeightInit.XAVIER)
                .dataType(self.dataType)
                .list()
                .layer(LSTM(nOut=256))
                .layer(LSTM(nOut=256))
                .layer(RnnOutputLayer(nOut=self.vocab, activation="softmax",
                                      lossFunction="mcxent"))
                .setInputType(InputType.recurrent(self.vocab,
                                                  self.maxLength))
                .build())
