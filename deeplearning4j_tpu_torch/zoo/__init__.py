"""Model zoo (reference: ``deeplearning4j_tpu/zoo``): every zoo model of
the reference, each a configuration factory whose ``init()`` returns a
ready network, and ``zoo.pretrained``'s local-file weight mapping."""

from deeplearning4j_tpu_torch.zoo.models import (
    VGG16, VGG19, AlexNet, Darknet19, FaceNetNN4Small2, InceptionResNetV1,
    LeNet, NASNet, ResNet50, SimpleCNN, SqueezeNet, TextGenerationLSTM,
    TinyYOLO, UNet, Xception, YOLO2, ZooModel,
)
from deeplearning4j_tpu_torch.zoo.pretrained import (
    convertPretrained, loadKerasApplicationsWeights,
)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "UNet", "TextGenerationLSTM", "Darknet19", "TinyYOLO",
           "YOLO2", "SqueezeNet", "Xception", "InceptionResNetV1",
           "FaceNetNN4Small2", "NASNet", "convertPretrained",
           "loadKerasApplicationsWeights"]
