"""Training-loop orchestration: listeners, early stopping and the
training report.

The counterpart of ``deeplearning4j_tpu/optimize`` (reference:
org.deeplearning4j.optimize listeners, org.deeplearning4j.earlystopping
and deeplearning4j-ui's report and UIServer, ``optimize/ui.py``).
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
from deeplearning4j_tpu_torch.optimize.ui import UIServer, render_report

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
    "EarlyStoppingParallelTrainer", "UIServer", "render_report",
]
