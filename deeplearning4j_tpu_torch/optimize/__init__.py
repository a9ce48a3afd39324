"""Training-loop orchestration: listeners and early stopping.

The counterpart of ``deeplearning4j_tpu/optimize`` (reference:
org.deeplearning4j.optimize listeners and org.deeplearning4j.earlystopping);
``optimize/ui.py`` waits for ROADMAP.md Queue 1 item 10.
"""

from deeplearning4j_tpu_torch.optimize.listeners import (
    TrainingListener,
    ScoreIterationListener,
    PerformanceListener,
    EvaluativeListener,
    CheckpointListener,
    CollectScoresListener,
    TimeIterationListener,
    StatsListener,
    NanScoreWatcher,
    ResilienceListener,
    MetricsListener,
)
from deeplearning4j_tpu_torch.optimize.earlystopping import (
    EarlyStoppingParallelTrainer,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    EarlyStoppingGraphTrainer,
    EarlyStoppingResult,
    TerminationReason,
    MaxEpochsTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    BestScoreEpochTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    DataSetLossCalculator,
    InMemoryModelSaver,
    LocalFileModelSaver,
)

__all__ = [
    "TrainingListener", "ScoreIterationListener", "PerformanceListener",
    "EvaluativeListener", "CheckpointListener", "CollectScoresListener",
    "TimeIterationListener", "StatsListener", "NanScoreWatcher",
    "ResilienceListener", "MetricsListener",
    "EarlyStoppingConfiguration", "EarlyStoppingTrainer",
    "EarlyStoppingGraphTrainer", "EarlyStoppingResult", "TerminationReason",
    "MaxEpochsTerminationCondition", "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition", "MaxScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition", "DataSetLossCalculator",
    "InMemoryModelSaver", "LocalFileModelSaver",
    "EarlyStoppingParallelTrainer",
]
