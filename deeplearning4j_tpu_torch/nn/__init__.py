"""The port's networks, layers and their configuration.

So far: the paged-KV serving model (``nn.transformer``), the
``ComputationGraph`` training path with the attention layers
(``nn.graph``, ``nn.conf.*``), the CNN path: ``MultiLayerNetwork``
(``nn.multilayer``) and the convolution, subsampling, global pooling and
batch-norm layers, and the recurrent layers (``nn.conf.recurrent``) with
truncated BPTT and stateful stepping.
"""

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.attention import (
    AttentionVertex, LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.builder import (
    BackpropType, GradientNormalization, MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex, PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, OutputLayer, RnnOutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    GRU, LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
    LastTimeStep, SimpleRnn,
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
    "RecurrentAttentionLayer", "SelfAttentionLayer", "BackpropType",
    "GradientNormalization",
    "MultiLayerConfiguration", "NeuralNetConfiguration", "ElementWiseVertex",
    "PreprocessorVertex", "InputType", "ActivationLayer",
    "BatchNormalization", "ConvolutionLayer", "DenseLayer",
    "GlobalPoolingLayer", "OutputLayer", "RnnOutputLayer",
    "SubsamplingLayer", "CnnToFeedForwardPreProcessor",
    "FeedForwardToCnnPreProcessor", "FeedForwardToRnnPreProcessor",
    "RnnToFeedForwardPreProcessor", "ComputationGraph", "LossFunctions",
    "MultiLayerNetwork", "Adam", "Nesterovs", "NoOp", "Sgd", "WeightInit",
    "LSTM", "GravesLSTM", "SimpleRnn", "GRU", "Bidirectional",
    "GravesBidirectionalLSTM", "LastTimeStep",
]
