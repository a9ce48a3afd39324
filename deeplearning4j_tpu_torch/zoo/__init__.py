"""Zoo models: ``LeNet`` (a ``MultiLayerNetwork``) and ``ResNet50`` (a
``ComputationGraph``)."""

from deeplearning4j_tpu_torch.zoo.models import LeNet, ResNet50, ZooModel

__all__ = ["ZooModel", "LeNet", "ResNet50"]
