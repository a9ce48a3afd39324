"""Zoo model definitions.

The counterpart of ``deeplearning4j_tpu/zoo/models.py`` for the
classifier and segmentation families: ``ZooModel``, ``LeNet``,
``SimpleCNN``, ``AlexNet`` (with LRN), ``VGG16``, ``VGG19`` and the
char-RNN ``TextGenerationLSTM`` (through ``MultiLayerNetwork``),
``ResNet50`` with the standard or the space-to-depth stem and ``UNet``
(through ``ComputationGraph``), with the reference's architectures,
defaults and layer names, so the reference's parameters carry across by
name and each configuration writes the reference's JSON.
``dataType=BFLOAT16`` computes in bf16 over fp32 master weights;
``dataFormat="NHWC"`` makes fit/output take [B,H,W,C] features;
``checkpointPolicy="save_conv_outputs"`` applies to every model
(``ZooModel.init``). ``device`` follows the port's device policy: the
card unless ``"cpu"`` is asked for.

Waiting for their slices: loading pretrained weights from a file
(ROADMAP.md Queue 1 item 12) and the other zoo families (Darknet/YOLO,
SqueezeNet, Xception, Inception, NASNet: item 12).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration, ElementWiseVertex, MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, CnnLossLayer, ConvolutionLayer,
    DenseLayer, DropoutLayer, GlobalPoolingLayer, LocalResponseNormalization,
    OutputLayer, RnnOutputLayer, SpaceToDepth, SubsamplingLayer,
    Upsampling2D, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.nn.weights import WeightInit

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "UNet", "TextGenerationLSTM"]


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


class SimpleCNN(ZooModel):
    """Reference: zoo.model.SimpleCNN."""

    @staticmethod
    def defaultInputShape():
        return (3, 48, 48)

    def conf(self):
        c, h, w = self.inputShape

        def conv(n):
            return ConvolutionLayer(nOut=n, kernelSize=(3, 3),
                                    activation="relu",
                                    convolutionMode="same")

        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .weightInit(WeightInit.RELU)
                .dataType(self.dataType)
                .list()
                .layer(conv(16))
                .layer(BatchNormalization())
                .layer(conv(16))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(conv(32))
                .layer(BatchNormalization())
                .layer(conv(32))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(DropoutLayer(dropOut=0.5))
                .layer(GlobalPoolingLayer(poolingType="avg"))
                .layer(OutputLayer(nOut=self.numClasses, activation="softmax"))
                .setInputType(InputType.convolutional(
                    h, w, c, format=self.dataFormat))
                .build())


class AlexNet(ZooModel):
    """Reference: zoo.model.AlexNet (one-tower, with LRN)."""

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(1e-2, 0.9))
                .weightInit(WeightInit.NORMAL)
                .dataType(self.dataType)
                .list()
                .layer(ConvolutionLayer(nOut=96, kernelSize=(11, 11),
                                        stride=(4, 4), activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=256, kernelSize=(5, 5),
                                        stride=(1, 1), padding=(2, 2),
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=384, kernelSize=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(nOut=384, kernelSize=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(nOut=256, kernelSize=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                .layer(OutputLayer(nOut=self.numClasses, activation="softmax"))
                .setInputType(InputType.convolutional(
                    h, w, c, format=self.dataFormat))
                .build())


def _vgg_blocks(builder, cfg):
    for item in cfg:
        if item == "M":
            builder.layer(SubsamplingLayer(poolingType="max",
                                           kernelSize=(2, 2), stride=(2, 2)))
        else:
            builder.layer(ConvolutionLayer(nOut=item, kernelSize=(3, 3),
                                           convolutionMode="same",
                                           activation="relu"))
    return builder


class VGG16(ZooModel):
    """Reference: zoo.model.VGG16."""

    _CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .list())
        _vgg_blocks(b, self._CFG)
        return (b.layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                 .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                 .layer(OutputLayer(nOut=self.numClasses,
                                    activation="softmax"))
                 .setInputType(InputType.convolutional(
                     h, w, c, format=self.dataFormat))
                 .build())


class VGG19(VGG16):
    """Reference: zoo.model.VGG19."""

    _CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class ResNet50(ZooModel):
    """Reference: zoo.model.ResNet50 (He et al.'s bottleneck-v1 graph).

    ``stemMode="space_to_depth"`` replaces the 7x7/s2 stem convolution
    with the reference's equivalent: zero-pad 3, space-to-depth 2, a
    4x4/s1 convolution over 12 channels; ``stem_weights_to_s2d`` maps a
    standard stem's weights onto it."""

    def __init__(self, stemMode="standard", **kw):
        super().__init__(**kw)
        if stemMode not in ("standard", "space_to_depth"):
            raise ValueError(f"unknown stemMode {stemMode!r}")
        self.stemMode = stemMode

    @staticmethod
    def stem_weights_to_s2d(W):
        """The reference's [7,7,C,O] HWIO standard conv1 weights ->
        [4,4,4C,O] HWIO space-to-depth stem weights computing the same
        function: zero-padded to 8x8, each 2x2 pixel block regrouped
        into channels in SpaceToDepth's (s, t, c) order (reference:
        ``stem_weights_to_s2d``). Numpy in, numpy out; a network takes
        the result through ``setParamTable`` (``param_from_reference``)."""
        import numpy as np

        W = np.asarray(W)
        C, O = W.shape[2], W.shape[3]
        W8 = np.zeros((8, 8, C, O), W.dtype)
        W8[:7, :7] = W
        W8 = W8.reshape(4, 2, 4, 2, C, O).transpose(0, 2, 1, 3, 4, 5)
        return W8.reshape(4, 4, 4 * C, O)

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
        if self.stemMode == "space_to_depth":
            g.addLayer("pad1", ZeroPaddingLayer(padding=(3, 3)), "input")
            g.addLayer("s2d", SpaceToDepth(blocks=2), "pad1")
            g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(4, 4),
                                                 stride=(1, 1),
                                                 padding=(0, 0),
                                                 activation="identity",
                                                 hasBias=False), "s2d")
        else:
            g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(7, 7),
                                                 stride=(2, 2),
                                                 padding=(3, 3),
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


class UNet(ZooModel):
    """Reference: zoo.model.UNet (a two-level encoder/decoder for
    segmentation): a per-pixel sigmoid + XENT head through a
    CnnLossLayer."""

    @staticmethod
    def defaultInputShape():
        return (3, 128, 128)

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))

        def double_conv(name, inp, nout):
            for i, src in ((1, inp), (2, f"{name}_c1")):
                g.addLayer(f"{name}_c{i}", ConvolutionLayer(
                    nOut=nout, kernelSize=(3, 3), convolutionMode="same",
                    activation="relu"), src)
            return f"{name}_c2"

        enc1 = double_conv("enc1", "input", 32)
        g.addLayer("p1", SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)),
                   enc1)
        enc2 = double_conv("enc2", "p1", 64)
        g.addLayer("p2", SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)),
                   enc2)
        mid = double_conv("mid", "p2", 128)
        g.addLayer("up2", Upsampling2D(size=2), mid)
        g.addVertex("cat2", MergeVertex(), "up2", enc2)
        dec2 = double_conv("dec2", "cat2", 64)
        g.addLayer("up1", Upsampling2D(size=2), dec2)
        g.addVertex("cat1", MergeVertex(), "up1", enc1)
        dec1 = double_conv("dec1", "cat1", 32)
        g.addLayer("segment", ConvolutionLayer(
            nOut=self.numClasses, kernelSize=(1, 1), activation="identity"),
            dec1)
        g.addLayer("out", CnnLossLayer(lossFunction="xent",
                                       activation="sigmoid"), "segment")
        return (g.setOutputs("out")
                .setInputTypes(InputType.convolutional(
                    h, w, c, format=self.dataFormat))
                .build())


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
