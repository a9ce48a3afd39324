"""Zoo model definitions.

The counterpart of ``deeplearning4j_tpu/zoo/models.py``: ``ZooModel``,
``LeNet``, ``SimpleCNN``, ``AlexNet`` (with LRN), ``VGG16``, ``VGG19``,
the char-RNN ``TextGenerationLSTM``, ``Darknet19`` and ``TinyYOLO``
(through ``MultiLayerNetwork``), ``ResNet50`` with the standard or the
space-to-depth stem, ``UNet``, ``YOLO2`` (with its passthrough route),
``SqueezeNet``, ``Xception``, ``InceptionResNetV1``,
``FaceNetNN4Small2`` and ``NASNet`` (through ``ComputationGraph``), with
the reference's architectures,
defaults and layer names, so the reference's parameters carry across by
name and each configuration writes the reference's JSON.
``dataType=BFLOAT16`` computes in bf16 over fp32 master weights;
``dataFormat="NHWC"`` makes fit/output take [B,H,W,C] features;
``checkpointPolicy="save_conv_outputs"`` applies to every model
(``ZooModel.init``). ``device`` follows the port's device policy: the
card unless ``"cpu"`` is asked for. ``initPretrained(localFile=)``
maps a local Keras-applications ``.h5``/``.keras`` file
(``zoo/pretrained.py``) or restores a model file; nothing is downloaded.
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
    LossLayer, OutputLayer, RnnOutputLayer, SpaceToDepth, SubsamplingLayer,
    Upsampling2D, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.nn.weights import WeightInit

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "UNet", "TextGenerationLSTM", "Darknet19", "TinyYOLO",
           "YOLO2", "SqueezeNet", "Xception", "InceptionResNetV1",
           "FaceNetNN4Small2", "NASNet"]


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
        """Initialise with pretrained weights from a LOCAL file
        (reference: ``ZooModel.initPretrained``): a Keras-applications
        ``.h5``/``.hdf5``/``.keras`` file is mapped onto the zoo graph
        (``zoo.pretrained``), anything else is restored as a model file
        by ``ModelSerializer``. Nothing is downloaded."""
        import os

        if localFile is None:
            raise NotImplementedError(
                f"Pretrained '{pretrainedType}' weights are not bundled in "
                "this build (no network egress). Pass localFile=<path> to "
                "a locally-supplied Keras-applications .h5 or a native "
                "checkpoint, or train from scratch.")
        path = str(localFile)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"initPretrained localFile does not exist: {path}")
        if path.endswith((".h5", ".hdf5", ".keras")):
            from deeplearning4j_tpu_torch.zoo.pretrained import (
                loadKerasApplicationsWeights,
            )

            return loadKerasApplicationsWeights(self, self.init(), path)
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        return ModelSerializer.restore(path, device=self.device)


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


class Darknet19(ZooModel):
    """Reference: zoo.model.Darknet19 (Redmon's 19-conv classifier, the
    YOLOv2 backbone)."""

    def conf(self):
        c, h, w = self.inputShape
        lb = (NeuralNetConfiguration.Builder()
              .seed(self.seed)
              .updater(self.updater or Nesterovs(1e-3, 0.9))
              .weightInit(WeightInit.RELU)
              .dataType(self.dataType)
              .list())

        def conv_bn(nout, k):
            lb.layer(ConvolutionLayer(nOut=nout, kernelSize=(k, k),
                                      convolutionMode="same",
                                      activation="identity", hasBias=False))
            lb.layer(BatchNormalization(activation="leakyrelu"))

        def pool():
            lb.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))

        conv_bn(32, 3); pool()
        conv_bn(64, 3); pool()
        conv_bn(128, 3); conv_bn(64, 1); conv_bn(128, 3); pool()
        conv_bn(256, 3); conv_bn(128, 1); conv_bn(256, 3); pool()
        conv_bn(512, 3); conv_bn(256, 1); conv_bn(512, 3)
        conv_bn(256, 1); conv_bn(512, 3); pool()
        conv_bn(1024, 3); conv_bn(512, 1); conv_bn(1024, 3)
        conv_bn(512, 1); conv_bn(1024, 3)
        lb.layer(ConvolutionLayer(nOut=self.numClasses, kernelSize=(1, 1),
                                  convolutionMode="same", activation="identity"))
        lb.layer(GlobalPoolingLayer(poolingType="avg"))
        lb.layer(LossLayer(lossFunction="mcxent", activation="softmax"))
        return (lb.setInputType(InputType.convolutional(h, w, c, format=self.dataFormat)).build())


class TinyYOLO(ZooModel):
    """Reference: zoo.model.TinyYOLO — tiny-Darknet backbone + YOLOv2
    detection head (objdetect.Yolo2OutputLayer). Default anchors are the
    reference's VOC priors in 13x13-grid units."""

    DEFAULT_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                       (9.42, 5.11), (16.62, 10.52))

    def __init__(self, numClasses=20, anchors=None, **kw):
        kw.setdefault("inputShape", (3, 416, 416))
        super().__init__(numClasses=numClasses, **kw)
        self.anchors = anchors or self.DEFAULT_ANCHORS

    @staticmethod
    def defaultInputShape():
        return (3, 416, 416)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer

        c, h, w = self.inputShape
        A = len(self.anchors)
        lb = (NeuralNetConfiguration.Builder()
              .seed(self.seed)
              .updater(self.updater or Adam(1e-3))
              .weightInit(WeightInit.RELU)
              .dataType(self.dataType)
              .list())

        def conv_bn(nout):
            lb.layer(ConvolutionLayer(nOut=nout, kernelSize=(3, 3),
                                      convolutionMode="same",
                                      activation="identity", hasBias=False))
            lb.layer(BatchNormalization(activation="leakyrelu"))

        for i, nout in enumerate((16, 32, 64, 128, 256)):
            conv_bn(nout)
            lb.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))
        conv_bn(512)
        # reference keeps 13x13 from here: stride-1 'same' max pool
        lb.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                  stride=(1, 1), convolutionMode="same"))
        conv_bn(1024)
        lb.layer(ConvolutionLayer(nOut=A * (5 + self.numClasses),
                                  kernelSize=(1, 1), activation="identity"))
        lb.layer(Yolo2OutputLayer(boundingBoxes=self.anchors))
        return (lb.setInputType(InputType.convolutional(h, w, c, format=self.dataFormat)).build())


class SqueezeNet(ZooModel):
    """Reference: zoo.model.SqueezeNet (v1.1 fire modules)."""

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))
        g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(3, 3),
                                             stride=(2, 2), activation="relu"),
                   "input")
        g.addLayer("pool1", SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                             stride=(2, 2)), "conv1")

        def fire(name, inp, squeeze, expand):
            g.addLayer(f"{name}_sq", ConvolutionLayer(nOut=squeeze, kernelSize=(1, 1),
                                                      activation="relu"), inp)
            g.addLayer(f"{name}_e1", ConvolutionLayer(nOut=expand, kernelSize=(1, 1),
                                                      activation="relu"), f"{name}_sq")
            g.addLayer(f"{name}_e3", ConvolutionLayer(nOut=expand, kernelSize=(3, 3),
                                                      convolutionMode="same",
                                                      activation="relu"), f"{name}_sq")
            g.addVertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
            return f"{name}_cat"

        x = fire("fire2", "pool1", 16, 64)
        x = fire("fire3", x, 16, 64)
        g.addLayer("pool3", SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                             stride=(2, 2)), x)
        x = fire("fire4", "pool3", 32, 128)
        x = fire("fire5", x, 32, 128)
        g.addLayer("pool5", SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                             stride=(2, 2)), x)
        x = fire("fire6", "pool5", 48, 192)
        x = fire("fire7", x, 48, 192)
        x = fire("fire8", x, 64, 256)
        x = fire("fire9", x, 64, 256)
        g.addLayer("drop", DropoutLayer(dropOut=0.5), x)
        g.addLayer("conv10", ConvolutionLayer(nOut=self.numClasses, kernelSize=(1, 1),
                                              activation="relu"), "drop")
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), "conv10")
        g.addLayer("out", LossLayer(lossFunction="mcxent", activation="softmax"), "gap")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())


class Xception(ZooModel):
    """Reference: zoo.model.Xception (Chollet; depthwise-separable towers).
    Entry/middle/exit flow with residual connections; middle-flow depth is
    configurable (reference uses 8)."""

    def __init__(self, middleFlowBlocks=8, **kw):
        kw.setdefault("inputShape", (3, 299, 299))
        super().__init__(**kw)
        self.middleFlowBlocks = middleFlowBlocks

    @staticmethod
    def defaultInputShape():
        return (3, 299, 299)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import SeparableConvolution2D

        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))

        def conv_bn(name, inp, nout, k, stride=1, act="relu"):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=nout, kernelSize=(k, k), stride=(stride, stride),
                convolutionMode="same", activation="identity", hasBias=False), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act), f"{name}_c")
            return f"{name}_bn"

        def sepconv_bn(name, inp, nout, act="relu"):
            g.addLayer(f"{name}_s", SeparableConvolution2D(
                nOut=nout, kernelSize=(3, 3), convolutionMode="same",
                activation="identity", hasBias=False), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act), f"{name}_s")
            return f"{name}_bn"

        def entry_block(name, inp, nout, first_relu=True):
            x = inp
            if first_relu:
                g.addLayer(f"{name}_r", ActivationLayer(activation="relu"), x)
                x = f"{name}_r"
            x = sepconv_bn(f"{name}_s1", x, nout)
            x = sepconv_bn(f"{name}_s2", x, nout, act="identity")
            g.addLayer(f"{name}_p", SubsamplingLayer(
                poolingType="max", kernelSize=(3, 3), stride=(2, 2),
                convolutionMode="same"), x)
            proj = conv_bn(f"{name}_proj", inp, nout, 1, stride=2, act="identity")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), f"{name}_p", proj)
            return f"{name}_add"

        x = conv_bn("stem1", "input", 32, 3, stride=2)
        x = conv_bn("stem2", x, 64, 3)
        x = entry_block("entry1", x, 128, first_relu=False)
        x = entry_block("entry2", x, 256)
        x = entry_block("entry3", x, 728)

        for i in range(self.middleFlowBlocks):
            inp = x
            y = x
            for j in range(3):
                g.addLayer(f"mid{i}_r{j}", ActivationLayer(activation="relu"), y)
                y = sepconv_bn(f"mid{i}_s{j}", f"mid{i}_r{j}", 728, act="identity")
            g.addVertex(f"mid{i}_add", ElementWiseVertex("add"), y, inp)
            x = f"mid{i}_add"

        x = entry_block("exit1", x, 1024)
        x = sepconv_bn("exit2", x, 1536)
        x = sepconv_bn("exit3", x, 2048)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("out", OutputLayer(nOut=self.numClasses, activation="softmax",
                                      lossFunction="mcxent"), "gap")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())


class YOLO2(ZooModel):
    """Reference: zoo.model.YOLO2 — the full YOLOv2 detector: Darknet19
    backbone, passthrough route (conv13 features space-to-depth'd into
    the 13x13 head), and the Yolo2OutputLayer detection loss. Default
    anchors are the reference's COCO priors in grid units."""

    DEFAULT_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253),
                       (3.33843, 5.47434), (7.88282, 3.52778),
                       (9.77052, 9.16828))

    def __init__(self, numClasses=80, anchors=None, **kw):
        kw.setdefault("inputShape", (3, 416, 416))
        super().__init__(numClasses=numClasses, **kw)
        self.anchors = anchors or self.DEFAULT_ANCHORS

    @staticmethod
    def defaultInputShape():
        return (3, 416, 416)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer

        c, h, w = self.inputShape
        A = len(self.anchors)
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))
        n = [0]

        def conv_bn(inp, nout, k):
            n[0] += 1
            name = f"conv{n[0]}"
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=nout, kernelSize=(k, k), convolutionMode="same",
                activation="identity", hasBias=False), inp)
            g.addLayer(name, BatchNormalization(activation="leakyrelu"),
                       f"{name}_c")
            return name

        def pool(inp):
            name = f"pool{n[0]}"
            g.addLayer(name, SubsamplingLayer(
                poolingType="max", kernelSize=(2, 2), stride=(2, 2)), inp)
            return name

        # Darknet19 backbone (convs 1-18); conv13 output is the
        # passthrough tap (512 channels at 2x the head's grid)
        x = pool(conv_bn("input", 32, 3))
        x = pool(conv_bn(x, 64, 3))
        x = conv_bn(conv_bn(conv_bn(x, 128, 3), 64, 1), 128, 3)
        x = pool(x)
        x = conv_bn(conv_bn(conv_bn(x, 256, 3), 128, 1), 256, 3)
        x = pool(x)
        x = conv_bn(conv_bn(conv_bn(x, 512, 3), 256, 1), 512, 3)
        x = conv_bn(conv_bn(x, 256, 1), 512, 3)
        route = x  # conv13
        x = pool(x)
        x = conv_bn(conv_bn(conv_bn(x, 1024, 3), 512, 1), 1024, 3)
        x = conv_bn(conv_bn(x, 512, 1), 1024, 3)
        # detection head
        x = conv_bn(conv_bn(x, 1024, 3), 1024, 3)
        # passthrough: 512x(2S)x(2S) -> 64ch 1x1 -> space-to-depth ->
        # 256xSxS, concatenated with the 1024-ch head
        r = conv_bn(route, 64, 1)
        g.addLayer("route_s2d", SpaceToDepth(blocks=2), r)
        g.addVertex("route_cat", MergeVertex(), "route_s2d", x)
        x = conv_bn("route_cat", 1024, 3)
        g.addLayer("pred", ConvolutionLayer(
            nOut=A * (5 + self.numClasses), kernelSize=(1, 1),
            activation="identity"), x)
        g.addLayer("out", Yolo2OutputLayer(boundingBoxes=self.anchors),
                   "pred")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())


class InceptionResNetV1(ZooModel):
    """Reference: zoo.model.InceptionResNetV1 (Szegedy et al. 2016; the
    FaceNet trunk). Stem -> 5x block35 (A, scale .17) -> reduction-A ->
    10x block17 (B, scale .10) -> reduction-B -> 5x block8 (C, scale
    .20) -> global avg pool -> 128-d embedding, L2-normalized, trained
    with the reference's softmax+center loss head. Residual scaling uses
    ScaleVertex; asymmetric 1x7/7x1 kernels run as 'same' convs."""

    def __init__(self, numClasses=1001, embeddingSize=128, **kw):
        kw.setdefault("inputShape", (3, 160, 160))
        super().__init__(numClasses=numClasses, **kw)
        self.embeddingSize = embeddingSize

    @staticmethod
    def defaultInputShape():
        return (3, 160, 160)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import ScaleVertex
        from deeplearning4j_tpu_torch.nn.conf.layers import CenterLossOutputLayer

        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))

        def conv_bn(name, inp, nout, kh, kw_, stride=1, pad="same",
                    act="relu"):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=nout, kernelSize=(kh, kw_), stride=(stride, stride),
                convolutionMode=pad, activation="identity",
                hasBias=False), inp)
            g.addLayer(name, BatchNormalization(activation=act), f"{name}_c")
            return name

        # stem (slimmed strides follow the reference's 160x160 facenet use)
        x = conv_bn("stem1", "input", 32, 3, 3, stride=2, pad="truncate")
        x = conv_bn("stem2", x, 32, 3, 3, pad="truncate")
        x = conv_bn("stem3", x, 64, 3, 3)
        g.addLayer("stem_pool", SubsamplingLayer(
            poolingType="max", kernelSize=(3, 3), stride=(2, 2)), x)
        x = conv_bn("stem4", "stem_pool", 80, 1, 1)
        x = conv_bn("stem5", x, 192, 3, 3, pad="truncate")
        x = conv_bn("stem6", x, 256, 3, 3, stride=2, pad="truncate")

        def block35(name, inp):  # Inception-ResNet-A, 256ch
            b0 = conv_bn(f"{name}_b0", inp, 32, 1, 1)
            b1 = conv_bn(f"{name}_b1b", conv_bn(f"{name}_b1a", inp, 32, 1, 1),
                         32, 3, 3)
            b2a = conv_bn(f"{name}_b2a", inp, 32, 1, 1)
            b2 = conv_bn(f"{name}_b2c", conv_bn(f"{name}_b2b", b2a, 32, 3, 3),
                         32, 3, 3)
            g.addVertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
            g.addLayer(f"{name}_up", ConvolutionLayer(
                nOut=256, kernelSize=(1, 1), activation="identity"),
                f"{name}_cat")
            g.addVertex(f"{name}_scale", ScaleVertex(0.17), f"{name}_up")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), inp,
                        f"{name}_scale")
            g.addLayer(f"{name}", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return name

        def block17(name, inp):  # Inception-ResNet-B, 896ch
            b0 = conv_bn(f"{name}_b0", inp, 128, 1, 1)
            b1 = conv_bn(f"{name}_b1c", conv_bn(
                f"{name}_b1b", conv_bn(f"{name}_b1a", inp, 128, 1, 1),
                128, 1, 7), 128, 7, 1)
            g.addVertex(f"{name}_cat", MergeVertex(), b0, b1)
            g.addLayer(f"{name}_up", ConvolutionLayer(
                nOut=896, kernelSize=(1, 1), activation="identity"),
                f"{name}_cat")
            g.addVertex(f"{name}_scale", ScaleVertex(0.10), f"{name}_up")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), inp,
                        f"{name}_scale")
            g.addLayer(f"{name}", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return name

        def block8(name, inp):  # Inception-ResNet-C, 1792ch
            b0 = conv_bn(f"{name}_b0", inp, 192, 1, 1)
            b1 = conv_bn(f"{name}_b1c", conv_bn(
                f"{name}_b1b", conv_bn(f"{name}_b1a", inp, 192, 1, 1),
                192, 1, 3), 192, 3, 1)
            g.addVertex(f"{name}_cat", MergeVertex(), b0, b1)
            g.addLayer(f"{name}_up", ConvolutionLayer(
                nOut=1792, kernelSize=(1, 1), activation="identity"),
                f"{name}_cat")
            g.addVertex(f"{name}_scale", ScaleVertex(0.20), f"{name}_up")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), inp,
                        f"{name}_scale")
            g.addLayer(f"{name}", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return name

        for i in range(5):
            x = block35(f"a{i}", x)
        # reduction-A: 256 -> 896
        g.addLayer("redA_pool", SubsamplingLayer(
            poolingType="max", kernelSize=(3, 3), stride=(2, 2)), x)
        rA1 = conv_bn("redA_b1", x, 384, 3, 3, stride=2, pad="truncate")
        rA2 = conv_bn("redA_b2c", conv_bn(
            "redA_b2b", conv_bn("redA_b2a", x, 192, 1, 1), 192, 3, 3),
            256, 3, 3, stride=2, pad="truncate")
        g.addVertex("redA", MergeVertex(), "redA_pool", rA1, rA2)
        x = "redA"
        for i in range(10):
            x = block17(f"b{i}", x)
        # reduction-B: 896 -> 1792
        g.addLayer("redB_pool", SubsamplingLayer(
            poolingType="max", kernelSize=(3, 3), stride=(2, 2)), x)
        rB1 = conv_bn("redB_b1b", conv_bn("redB_b1a", x, 256, 1, 1),
                      384, 3, 3, stride=2, pad="truncate")
        rB2 = conv_bn("redB_b2b", conv_bn("redB_b2a", x, 256, 1, 1),
                      256, 3, 3, stride=2, pad="truncate")
        rB3 = conv_bn("redB_b3c", conv_bn(
            "redB_b3b", conv_bn("redB_b3a", x, 256, 1, 1), 256, 3, 3),
            256, 3, 3, stride=2, pad="truncate")
        g.addVertex("redB", MergeVertex(), "redB_pool", rB1, rB2, rB3)
        x = "redB"
        for i in range(5):
            x = block8(f"c{i}", x)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("drop", DropoutLayer(dropOut=0.8), "gap")
        g.addLayer("embed", DenseLayer(nOut=self.embeddingSize,
                                       activation="identity"), "drop")
        from deeplearning4j_tpu_torch.nn.conf.graph import L2NormalizeVertex
        g.addVertex("embeddings", L2NormalizeVertex(), "embed")
        g.addLayer("out", CenterLossOutputLayer(
            nOut=self.numClasses, activation="softmax",
            lossFunction="mcxent"), "embeddings")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())


class FaceNetNN4Small2(ZooModel):
    """Reference: zoo.model.FaceNetNN4Small2 (OpenFace nn4.small2:
    GoogLeNet-style inception trunk with 3x3/5x5 branches and p-norm
    pooling branches, 128-d L2-normalized embedding, softmax+center
    loss). Branch widths follow the reference's nn4.small2 table."""

    def __init__(self, numClasses=5749, embeddingSize=128, **kw):
        kw.setdefault("inputShape", (3, 96, 96))
        super().__init__(numClasses=numClasses, **kw)
        self.embeddingSize = embeddingSize

    @staticmethod
    def defaultInputShape():
        return (3, 96, 96)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import L2NormalizeVertex
        from deeplearning4j_tpu_torch.nn.conf.layers import CenterLossOutputLayer

        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))

        def conv_bn(name, inp, nout, k, stride=1):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=nout, kernelSize=(k, k), stride=(stride, stride),
                convolutionMode="same", activation="identity",
                hasBias=False), inp)
            g.addLayer(name, BatchNormalization(activation="relu"),
                       f"{name}_c")
            return name

        def inception(name, inp, c1, c3r, c3, c5r, c5, pool_type, cp,
                      pool_stride=1):
            """One nn4 inception module. Branches with width 0 are
            omitted (matches the reference's tables); pool branch is
            max or pnorm(L2), optionally projected to cp channels."""
            outs = []
            if c1:
                outs.append(conv_bn(f"{name}_1x1", inp, c1, 1))
            if c3:
                outs.append(conv_bn(f"{name}_3x3",
                                    conv_bn(f"{name}_3x3r", inp, c3r, 1),
                                    c3, 3, stride=pool_stride))
            if c5:
                outs.append(conv_bn(f"{name}_5x5",
                                    conv_bn(f"{name}_5x5r", inp, c5r, 1),
                                    c5, 5, stride=pool_stride))
            g.addLayer(f"{name}_pool", SubsamplingLayer(
                poolingType=pool_type, kernelSize=(3, 3),
                stride=(pool_stride if pool_stride > 1 else 1,) * 2,
                convolutionMode="same"), inp)
            if cp:
                outs.append(conv_bn(f"{name}_poolproj", f"{name}_pool", cp, 1))
            else:
                outs.append(f"{name}_pool")
            g.addVertex(name, MergeVertex(), *outs)
            return name

        x = conv_bn("conv1", "input", 64, 7, stride=2)
        g.addLayer("pool1", SubsamplingLayer(
            poolingType="max", kernelSize=(3, 3), stride=(2, 2),
            convolutionMode="same"), x)
        x = conv_bn("conv2", "pool1", 64, 1)
        x = conv_bn("conv3", x, 192, 3)
        g.addLayer("pool3", SubsamplingLayer(
            poolingType="max", kernelSize=(3, 3), stride=(2, 2),
            convolutionMode="same"), x)
        x = inception("in3a", "pool3", 64, 96, 128, 16, 32, "max", 32)
        x = inception("in3b", x, 64, 96, 128, 32, 64, "pnorm", 64)
        x = inception("in3c", x, 0, 128, 256, 32, 64, "max", 0,
                      pool_stride=2)
        x = inception("in4a", x, 256, 96, 192, 32, 64, "pnorm", 128)
        x = inception("in4e", x, 0, 160, 256, 64, 128, "max", 0,
                      pool_stride=2)
        x = inception("in5a", x, 256, 96, 384, 0, 0, "pnorm", 96)
        x = inception("in5b", x, 256, 96, 384, 0, 0, "max", 96)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("embed", DenseLayer(nOut=self.embeddingSize,
                                       activation="identity"), "gap")
        g.addVertex("embeddings", L2NormalizeVertex(), "embed")
        g.addLayer("out", CenterLossOutputLayer(
            nOut=self.numClasses, activation="softmax",
            lossFunction="mcxent"), "embeddings")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())


class NASNet(ZooModel):
    """Reference: zoo.model.NASNet (Zoph et al. NASNet-A, mobile
    configuration). Normal cells combine the two previous cell outputs
    through separable-conv/pool/identity branches; reduction cells halve
    the grid. The two-input cell wiring (h_i, h_{i-1}) including the
    factorized-reduction shape fix-up when h_{i-1} has stale spatial
    dims is the reference's; penultimate-filter scaling follows the
    mobile preset (penultimate 1056, 4 cells per stack)."""

    def __init__(self, numCells=4, penultimateFilters=1056, stemFilters=32,
                 filterMultiplier=2, **kw):
        kw.setdefault("inputShape", (3, 224, 224))
        super().__init__(**kw)
        self.numCells = numCells
        self.filters = penultimateFilters // 24  # mobile: 44
        self.stemFilters = stemFilters
        self.mult = filterMultiplier

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit(WeightInit.RELU)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input"))

        def sep_bn(name, inp, nout, k, stride=1):
            """relu -> sepconv(k,stride) -> BN -> relu -> sepconv(k) -> BN
            (the reference's doubled separable stack)."""
            from deeplearning4j_tpu_torch.nn.conf.layers import SeparableConvolution2D
            g.addLayer(f"{name}_r1", ActivationLayer(activation="relu"), inp)
            g.addLayer(f"{name}_s1", SeparableConvolution2D(
                nOut=nout, kernelSize=(k, k), stride=(stride, stride),
                convolutionMode="same", activation="identity",
                hasBias=False), f"{name}_r1")
            g.addLayer(f"{name}_b1", BatchNormalization(activation="relu"),
                       f"{name}_s1")
            g.addLayer(f"{name}_s2", SeparableConvolution2D(
                nOut=nout, kernelSize=(k, k), convolutionMode="same",
                activation="identity", hasBias=False), f"{name}_b1")
            g.addLayer(name, BatchNormalization(activation="identity"),
                       f"{name}_s2")
            return name

        def fit_1x1(name, inp, nout, stride=1):
            """relu -> 1x1 conv (stride for factorized reduction) -> BN:
            aligns channel/spatial dims of a cell input."""
            g.addLayer(f"{name}_r", ActivationLayer(activation="relu"), inp)
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=nout, kernelSize=(1, 1), stride=(stride, stride),
                activation="identity", hasBias=False), f"{name}_r")
            g.addLayer(name, BatchNormalization(activation="identity"),
                       f"{name}_c")
            return name

        def pool(name, inp, ptype, stride):
            g.addLayer(name, SubsamplingLayer(
                poolingType=ptype, kernelSize=(3, 3),
                stride=(stride, stride), convolutionMode="same"), inp)
            return name

        def normal_cell(name, x, x_prev, f, prev_stale):
            hp = fit_1x1(f"{name}_fitp", x_prev, f,
                         stride=2 if prev_stale else 1)
            hc = fit_1x1(f"{name}_fitc", x, f)
            # NASNet-A normal cell's 5 branch-pairs
            y1a = sep_bn(f"{name}_y1a", hc, f, 3)
            g.addVertex(f"{name}_y1", ElementWiseVertex("add"), y1a, hc)
            y2a = sep_bn(f"{name}_y2a", hp, f, 3)
            y2b = sep_bn(f"{name}_y2b", hc, f, 5)
            g.addVertex(f"{name}_y2", ElementWiseVertex("add"), y2a, y2b)
            y3a = pool(f"{name}_y3a", hc, "avg", 1)
            g.addVertex(f"{name}_y3", ElementWiseVertex("add"), y3a, hp)
            y4a = pool(f"{name}_y4a", hp, "avg", 1)
            y4b = pool(f"{name}_y4b", hp, "avg", 1)
            g.addVertex(f"{name}_y4", ElementWiseVertex("add"), y4a, y4b)
            y5a = sep_bn(f"{name}_y5a", hp, f, 5)
            y5b = sep_bn(f"{name}_y5b", hp, f, 3)
            g.addVertex(f"{name}_y5", ElementWiseVertex("add"), y5a, y5b)
            g.addVertex(name, MergeVertex(), hp, f"{name}_y1", f"{name}_y2",
                        f"{name}_y3", f"{name}_y4", f"{name}_y5")
            return name

        def reduction_cell(name, x, x_prev, f, prev_stale):
            hp = fit_1x1(f"{name}_fitp", x_prev, f,
                         stride=2 if prev_stale else 1)
            hc = fit_1x1(f"{name}_fitc", x, f)
            y1a = sep_bn(f"{name}_y1a", hc, f, 5, stride=2)
            y1b = sep_bn(f"{name}_y1b", hp, f, 7, stride=2)
            g.addVertex(f"{name}_y1", ElementWiseVertex("add"), y1a, y1b)
            y2a = pool(f"{name}_y2a", hc, "max", 2)
            y2b = sep_bn(f"{name}_y2b", hp, f, 7, stride=2)
            g.addVertex(f"{name}_y2", ElementWiseVertex("add"), y2a, y2b)
            y3a = pool(f"{name}_y3a", hc, "avg", 2)
            y3b = sep_bn(f"{name}_y3b", hp, f, 5, stride=2)
            g.addVertex(f"{name}_y3", ElementWiseVertex("add"), y3a, y3b)
            y4a = pool(f"{name}_y4a", f"{name}_y1", "avg", 1)
            g.addVertex(f"{name}_y4", ElementWiseVertex("add"), y4a,
                        f"{name}_y2")
            y5a = sep_bn(f"{name}_y5a", f"{name}_y1", f, 3)
            y5b = pool(f"{name}_y5b", hc, "max", 2)
            g.addVertex(f"{name}_y5", ElementWiseVertex("add"), y5a, y5b)
            g.addVertex(name, MergeVertex(), f"{name}_y2", f"{name}_y3",
                        f"{name}_y4", f"{name}_y5")
            return name

        f0 = self.filters
        g.addLayer("stem_c", ConvolutionLayer(
            nOut=self.stemFilters, kernelSize=(3, 3), stride=(2, 2),
            convolutionMode="truncate", activation="identity",
            hasBias=False), "input")
        g.addLayer("stem", BatchNormalization(activation="identity"),
                   "stem_c")
        # two stem reduction cells bring 112 -> 56 -> 28
        prev, cur = "stem", reduction_cell("stem_r1", "stem", "stem",
                                           f0 // 4, False)
        prev, cur = cur, reduction_cell("stem_r2", cur, prev, f0 // 2, True)
        stale = True
        for stack, f in [(0, f0), (1, f0 * self.mult),
                         (2, f0 * self.mult ** 2)]:
            if stack:
                prev, cur = cur, reduction_cell(f"red{stack}", cur, prev,
                                                f, stale)
                stale = True
            for i in range(self.numCells):
                prev, cur = cur, normal_cell(f"n{stack}_{i}", cur, prev, f,
                                             stale)
                stale = False
        g.addLayer("relu_out", ActivationLayer(activation="relu"), cur)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), "relu_out")
        g.addLayer("out", OutputLayer(nOut=self.numClasses,
                                      activation="softmax",
                                      lossFunction="mcxent"), "gap")
        return (g.setOutputs("out")
                 .setInputTypes(InputType.convolutional(h, w, c, format=self.dataFormat))
                 .build())
