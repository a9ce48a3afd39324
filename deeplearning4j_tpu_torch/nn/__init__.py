"""The port's networks, layers and their configuration.

So far: the paged-KV serving model (``nn.transformer``), the
``ComputationGraph`` training path with the attention layers
(``nn.graph``, ``nn.conf.*``) and the CNN path: ``MultiLayerNetwork``
(``nn.multilayer``) and the convolution, subsampling, global pooling and
batch-norm layers.
"""

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.attention import (
    AttentionVertex, LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.builder import (
    GradientNormalization, MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex, PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, OutputLayer, RnnOutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor, RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import LossFunctions
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs, NoOp, Sgd
from deeplearning4j_tpu_torch.nn.weights import WeightInit

__all__ = [
    "DataType", "Activation", "AttentionVertex", "LearnedSelfAttentionLayer",
    "RecurrentAttentionLayer", "SelfAttentionLayer", "GradientNormalization",
    "MultiLayerConfiguration", "NeuralNetConfiguration", "ElementWiseVertex",
    "PreprocessorVertex", "InputType", "ActivationLayer",
    "BatchNormalization", "ConvolutionLayer", "DenseLayer",
    "GlobalPoolingLayer", "OutputLayer", "RnnOutputLayer",
    "SubsamplingLayer", "CnnToFeedForwardPreProcessor",
    "FeedForwardToCnnPreProcessor", "FeedForwardToRnnPreProcessor",
    "RnnToFeedForwardPreProcessor", "ComputationGraph", "LossFunctions",
    "MultiLayerNetwork", "Adam", "Nesterovs", "NoOp", "Sgd", "WeightInit",
]
