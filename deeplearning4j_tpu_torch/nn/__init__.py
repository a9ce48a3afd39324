"""The port's networks, layers and their configuration.

So far: the paged-KV serving model (``nn.transformer``) and the
``ComputationGraph`` training path with the attention layers
(``nn.graph``, ``nn.conf.*``).
"""

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.attention import (
    AttentionVertex, LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.builder import (
    GradientNormalization, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex, PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, DenseLayer, GlobalPoolingLayer, OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    FeedForwardToRnnPreProcessor, RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import LossFunctions
from deeplearning4j_tpu_torch.nn.updaters import Adam, NoOp, Sgd
from deeplearning4j_tpu_torch.nn.weights import WeightInit

__all__ = [
    "DataType", "Activation", "AttentionVertex", "LearnedSelfAttentionLayer",
    "RecurrentAttentionLayer", "SelfAttentionLayer", "GradientNormalization",
    "NeuralNetConfiguration", "ElementWiseVertex", "PreprocessorVertex",
    "InputType", "ActivationLayer", "DenseLayer", "GlobalPoolingLayer",
    "OutputLayer", "RnnOutputLayer", "FeedForwardToRnnPreProcessor",
    "RnnToFeedForwardPreProcessor", "ComputationGraph", "LossFunctions",
    "Adam", "NoOp", "Sgd", "WeightInit",
]
