"""Static analysis of the port's graphs (reference:
``deeplearning4j_tpu/analysis``).

Ported: the diagnostic model (``Diagnostic``, ``Report``), the SameDiff
graph validator (``validate_samediff``: GRF01-06, DTY02), the runtime
half of the retrace pass (``RetraceError``, ``RetraceSentinel``: a
capture counter) and the memory-traffic attribution (``analysis.hbm``
over ``util.hbm_ledger``). The static passes (shapes, purity,
partitioning, the retrace lint, collectives, threads, faults) and the
CLI wait for ROADMAP.md Queue 1 item 13's analysis slice.
"""

from deeplearning4j_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ALL_CODES, ERROR, WARNING, Diagnostic, Report,
)
from deeplearning4j_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceError, RetraceSentinel,
)
from deeplearning4j_tpu_torch.analysis.samediff_check import (  # noqa: F401
    validate_samediff,
)

__all__ = ["ALL_CODES", "ERROR", "WARNING", "Diagnostic", "Report",
           "validate_samediff", "RetraceError", "RetraceSentinel"]
