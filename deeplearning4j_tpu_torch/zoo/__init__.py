"""Zoo models: ``LeNet``, ``SimpleCNN``, ``AlexNet``, ``VGG16``,
``VGG19`` and ``TextGenerationLSTM`` (``MultiLayerNetwork``s), ``ResNet50``
and ``UNet`` (``ComputationGraph``s)."""

from deeplearning4j_tpu_torch.zoo.models import (
    VGG16, VGG19, AlexNet, LeNet, ResNet50, SimpleCNN, TextGenerationLSTM,
    UNet, ZooModel,
)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "UNet", "TextGenerationLSTM"]
