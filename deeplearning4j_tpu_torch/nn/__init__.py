"""The port's networks, layers and their configuration.

The paged-KV serving model (``nn.transformer``), ``MultiLayerNetwork``
and ``ComputationGraph`` (``nn.multilayer``, ``nn.graph``) with every
layer, vertex and preprocessor of the reference's catalogue but the 3-d
layers (ROADMAP.md Queue 1 item 12): the attention, convolutional,
recurrent, embedding, mask, 1-d, locally connected, capsule, utility,
loss, SameDiff and pretrainable layers (``nn.conf.*``), with truncated
BPTT, stateful stepping and layerwise pretraining; every updater,
schedule, loss, dropout, constraint and weight noise of the reference;
the line-search solvers (``nn.solvers``), transfer learning
(``nn.transfer``) and weight-only int8 inference (``nn.quantize``).
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
from deeplearning4j_tpu_torch.nn.conf.constraint import (
    MaxNormConstraint, MinMaxNormConstraint, NonNegativeConstraint,
    UnitNormConstraint,
)
from deeplearning4j_tpu_torch.nn.conf.dropout import (
    AlphaDropout, Dropout, GaussianDropout, GaussianNoise, SpatialDropout,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration, DotProductVertex,
    DuplicateToTimeSeriesVertex, ElementWiseVertex, GraphBuilder,
    L2NormalizeVertex, L2Vertex, LastTimeStepVertex, MergeVertex,
    PreprocessorVertex, ReshapeVertex, ReverseTimeSeriesVertex, ScaleVertex,
    ShiftVertex, StackVertex, SubsetVertex, UnstackVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, AutoEncoder, BatchNormalization, CapsuleLayer,
    CapsuleStrengthLayer, CenterLossOutputLayer, CnnLossLayer,
    Convolution1DLayer, ConvolutionLayer, Cropping1D, Cropping2D,
    Deconvolution2D, DenseLayer, DepthwiseConvolution2D, DropoutLayer,
    ElementWiseMultiplicationLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    FrozenLayerWithBackprop, GlobalPoolingLayer, LocallyConnected1D,
    LocallyConnected2D, LocalResponseNormalization, LossLayer, MaskLayer,
    MaskZeroLayer, OCNNOutputLayer, OutputLayer, PReLULayer,
    PrimaryCapsules, RepeatVector, RnnLossLayer, RnnOutputLayer,
    SameDiffLambdaLayer, SameDiffLayer, SeparableConvolution2D,
    SpaceToBatch, SpaceToDepth, Subsampling1DLayer, SubsamplingLayer,
    Upsampling1D, Upsampling2D, ZeroPadding1DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    GRU, LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
    LastTimeStep, SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
    RnnToCnnPreProcessor, RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.conf.variational import \
    VariationalAutoencoder
from deeplearning4j_tpu_torch.nn.conf.weightnoise import (
    DropConnect, WeightNoise,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import LossFunctions
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.solvers import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.transfer import (
    FineTuneConfiguration, FrozenLayer, TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.nn.updaters import (
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, Nadam, Nesterovs, NoOp,
    RmsProp, Sgd,
)
from deeplearning4j_tpu_torch.nn.weights import (
    NormalDistribution, UniformDistribution, WeightInit, WeightInitEmbedding,
)

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
    "AdamW", "AMSGrad", "Nadam", "RmsProp", "MaxNormConstraint",
    "MinMaxNormConstraint", "NonNegativeConstraint", "UnitNormConstraint",
    "ComputationGraphConfiguration", "GraphBuilder",
    "DuplicateToTimeSeriesVertex", "LastTimeStepVertex",
    "ReverseTimeSeriesVertex", "AutoEncoder", "CapsuleLayer",
    "CapsuleStrengthLayer", "CenterLossOutputLayer", "Convolution1DLayer",
    "Cropping1D", "ElementWiseMultiplicationLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "FrozenLayerWithBackprop",
    "LocallyConnected1D", "LocallyConnected2D", "MaskLayer",
    "MaskZeroLayer", "OCNNOutputLayer", "PReLULayer", "PrimaryCapsules",
    "RepeatVector", "SameDiffLambdaLayer", "SameDiffLayer", "SpaceToBatch",
    "Subsampling1DLayer", "Upsampling1D", "ZeroPadding1DLayer",
    "CnnToRnnPreProcessor", "RnnToCnnPreProcessor",
    "VariationalAutoencoder", "DropConnect", "WeightNoise",
    "NormalDistribution", "UniformDistribution", "WeightInitEmbedding",
    "OptimizationAlgorithm", "TransferLearning", "FineTuneConfiguration",
    "FrozenLayer", "TransferLearningHelper",
]
