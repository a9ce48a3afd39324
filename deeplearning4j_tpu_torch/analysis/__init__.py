"""Static analysis of the port's graphs (reference:
``deeplearning4j_tpu/analysis``).

Ported: the diagnostic model (``Diagnostic``, ``Report``) and the
SameDiff graph validator (``validate_samediff``: GRF01-06, DTY02). The
other passes (shapes, purity, partitioning, retracing, collectives,
threads, faults, HBM attribution) wait for ROADMAP.md Queue 1 item 13.
"""

from deeplearning4j_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ALL_CODES, ERROR, WARNING, Diagnostic, Report,
)
from deeplearning4j_tpu_torch.analysis.samediff_check import (  # noqa: F401
    validate_samediff,
)

__all__ = ["ALL_CODES", "ERROR", "WARNING", "Diagnostic", "Report",
           "validate_samediff"]
