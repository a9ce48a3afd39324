"""SameDiff: define-then-run graphs with autodiff, over torch.

The counterpart of ``deeplearning4j_tpu/autodiff/`` (reference:
org.nd4j.autodiff.samediff): ``SameDiff``, ``SDVariable``,
``TrainingConfig`` and ``VariableType``, with the op registry in
``ops_impl``.
"""

from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff, SDVariable, TrainingConfig, VariableType,
)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType"]
