"""The port's networks, layers and their configuration.

So far: the paged-KV serving model (``nn.transformer``), the
``ComputationGraph`` training path with the attention layers and the
graph vertices (``nn.graph``, ``nn.conf.*``), the CNN path:
``MultiLayerNetwork`` (``nn.multilayer``) and the 2-d convolution,
pooling, padding, cropping, upsampling, space-to-depth, LRN, dropout,
batch-norm and loss layers, the recurrent layers (``nn.conf.recurrent``)
with truncated BPTT and stateful stepping, every updater, schedule, loss
and dropout of the reference.
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
from deeplearning4j_tpu_torch.nn.conf.dropout import (
    AlphaDropout, Dropout, GaussianDropout, GaussianNoise, SpatialDropout,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    DotProductVertex, ElementWiseVertex, L2NormalizeVertex, L2Vertex,
    MergeVertex, PreprocessorVertex, ReshapeVertex, ScaleVertex,
    ShiftVertex, StackVertex, SubsetVertex, UnstackVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, CnnLossLayer, ConvolutionLayer,
    Cropping2D, Deconvolution2D, DenseLayer, DepthwiseConvolution2D,
    DropoutLayer, GlobalPoolingLayer, LocalResponseNormalization, LossLayer,
    OutputLayer, RnnLossLayer, RnnOutputLayer, SeparableConvolution2D,
    SpaceToDepth, SubsamplingLayer, Upsampling2D, ZeroPaddingLayer,
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
from deeplearning4j_tpu_torch.nn.updaters import (
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, Nadam, Nesterovs, NoOp,
    RmsProp, Sgd,
)
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
    "AlphaDropout", "Dropout", "GaussianDropout", "GaussianNoise",
    "SpatialDropout", "DotProductVertex", "L2NormalizeVertex", "L2Vertex",
    "MergeVertex", "ReshapeVertex", "ScaleVertex", "ShiftVertex",
    "StackVertex", "SubsetVertex", "UnstackVertex", "CnnLossLayer",
    "Cropping2D", "Deconvolution2D", "DepthwiseConvolution2D",
    "DropoutLayer", "LocalResponseNormalization", "LossLayer",
    "RnnLossLayer", "SeparableConvolution2D", "SpaceToDepth",
    "Upsampling2D", "ZeroPaddingLayer", "AdaDelta", "AdaGrad", "AdaMax",
    "AdamW", "AMSGrad", "Nadam", "RmsProp",
]
