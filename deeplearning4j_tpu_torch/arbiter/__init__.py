"""Arbiter — hyperparameter optimization; the counterpart of
``deeplearning4j_tpu/arbiter``, building the port's networks.

Reference: the Arbiter module (org.deeplearning4j.arbiter): ParameterSpace,
CandidateGenerator (random/grid/genetic), ScoreFunction, termination conditions and
LocalOptimizationRunner.
"""

from deeplearning4j_tpu_torch.arbiter.spaces import (
    ParameterSpace,
    ContinuousParameterSpace,
    DiscreteParameterSpace,
    IntegerParameterSpace,
)
from deeplearning4j_tpu_torch.arbiter.layerspace import (
    LayerSpace,
    DenseLayerSpace,
    OutputLayerSpace,
    ConvolutionLayerSpace,
    MultiLayerSpace,
    ComputationGraphSpace,
)
from deeplearning4j_tpu_torch.arbiter.optimize import (
    RandomSearchGenerator,
    GridSearchCandidateGenerator,
    GeneticSearchCandidateGenerator,
    TestSetLossScoreFunction,
    EvaluationScoreFunction,
    MaxCandidatesCondition,
    MaxTimeCondition,
    OptimizationConfiguration,
    LocalOptimizationRunner,
    OptimizationResult,
    CandidateResult,
)

__all__ = [
    "ParameterSpace", "ContinuousParameterSpace", "DiscreteParameterSpace",
    "IntegerParameterSpace", "RandomSearchGenerator",
    "GridSearchCandidateGenerator", "GeneticSearchCandidateGenerator",
    "TestSetLossScoreFunction",
    "EvaluationScoreFunction", "MaxCandidatesCondition", "MaxTimeCondition",
    "OptimizationConfiguration", "LocalOptimizationRunner",
    "OptimizationResult", "CandidateResult", "LayerSpace",
    "DenseLayerSpace", "OutputLayerSpace", "ConvolutionLayerSpace",
    "MultiLayerSpace", "ComputationGraphSpace",
]
