"""Evaluation metrics.

The counterpart of ``deeplearning4j_tpu/evaluation`` (numpy on the
host, the reference's arithmetic). Reference: org.nd4j.evaluation (Evaluation, RegressionEvaluation, ROC,
ROCMultiClass, ROCBinary, EvaluationBinary).
"""

from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCMultiClass, ROCBinary
from deeplearning4j_tpu_torch.evaluation.binary import EvaluationBinary
from deeplearning4j_tpu_torch.evaluation.calibration import EvaluationCalibration

__all__ = ["Evaluation", "RegressionEvaluation", "ROC", "ROCMultiClass",
           "ROCBinary", "EvaluationBinary", "EvaluationCalibration"]
