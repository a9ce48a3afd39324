"""Zoo models: ``LeNet`` and ``TextGenerationLSTM`` (``MultiLayerNetwork``s)
and ``ResNet50`` (a ``ComputationGraph``)."""

from deeplearning4j_tpu_torch.zoo.models import (
    LeNet, ResNet50, TextGenerationLSTM, ZooModel,
)

__all__ = ["ZooModel", "LeNet", "ResNet50", "TextGenerationLSTM"]
