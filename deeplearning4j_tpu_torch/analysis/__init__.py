"""Static analysis of the port's models, plans and sources (reference:
``deeplearning4j_tpu/analysis``): the reference's passes, codes and CLI
(``python -m deeplearning4j_tpu_torch.analysis``), pointed at the port's
own objects and sources.

- shape/dtype inference over model configs (``shapes.validate_model``),
  on the meta device where the reference uses ``jax.eval_shape``
- SameDiff graph validation (``samediff_check.validate_samediff``)
- capture purity (``purity.lint_paths``): the side effects a CUDA-graph
  capture runs once, as the reference's lints what a jit trace runs once
- partition-plan validation (``partitioning.validate_plan``, CLI
  ``--parallel``); PAR06 predicts the port's own high-water mark (an
  eager step run on meta tensors), not the reference's XLA residency
- recapture hazards (``retrace.lint_retrace_paths``) and the runtime
  capture counter (``retrace.RetraceSentinel``)
- memory-traffic attribution (``hbm.run_attribution``, CLI
  ``--attribution``)
- collective safety (``collectives.verify_program``, COL01-06) over the
  signature the port's one collective choke point
  (``parallel.collectives``) records, where the reference walks a jaxpr
- host thread safety (``threads.lint_thread_paths``, THR01-04, CLI
  ``--concurrency``) and fail paths with chaos-seam coverage
  (``faults.lint_fault_paths``/``faults.seam_coverage``, FLT01-06, CLI
  ``--failpaths``) over the threaded tier

Suppressions: ``purity-ok[...]``, ``thread-ok[...]`` and
``fault-ok[...]`` with a required justification.
``MultiLayerNetwork.init(validate=True)`` and
``ComputationGraph.init(validate=True)`` run the shape pass before any
parameter is drawn and raise ConfigValidationError; ``mesh=`` or
``hbm_gb=`` extend the gate with the partition-plan passes.
"""

from deeplearning4j_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ALL_CODES, ERROR, WARNING, ConfigValidationError, Diagnostic, Report,
)
from deeplearning4j_tpu_torch.analysis.shapes import (  # noqa: F401
    validate_model,
)
from deeplearning4j_tpu_torch.analysis.samediff_check import (  # noqa: F401
    validate_samediff,
)
from deeplearning4j_tpu_torch.analysis.purity import (  # noqa: F401
    lint_paths, lint_source,
)
from deeplearning4j_tpu_torch.analysis.partitioning import (  # noqa: F401
    ShardingPlan, check_collectives, validate_plan,
)
from deeplearning4j_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceError, RetraceSentinel, lint_retrace, lint_retrace_paths,
)
from deeplearning4j_tpu_torch.analysis.collectives import (  # noqa: F401
    CollectiveContract, CollectiveSignature, check_acc_dtype, check_bill,
    check_signature, collective_counts, collective_signature,
    compression_contract, linalg_contract, verify_program,
)
from deeplearning4j_tpu_torch.analysis.threads import (  # noqa: F401
    THREADED_TIER, lint_thread_paths, lint_thread_source,
)
from deeplearning4j_tpu_torch.analysis.faults import (  # noqa: F401
    coverage_gaps, lint_fault_paths, lint_fault_source, seam_coverage,
)

__all__ = ["ALL_CODES", "ERROR", "WARNING", "ConfigValidationError",
           "Diagnostic", "Report",
           "validate_model", "validate_or_raise", "validate_samediff",
           "validate_plan", "ShardingPlan", "check_collectives",
           "RetraceError", "RetraceSentinel", "lint_retrace",
           "lint_retrace_paths",
           "lint_paths", "lint_source", "zoo_corpus",
           "CollectiveContract", "CollectiveSignature",
           "collective_counts", "collective_signature",
           "check_signature", "check_acc_dtype", "check_bill",
           "compression_contract", "linalg_contract", "verify_program",
           "THREADED_TIER", "lint_thread_paths", "lint_thread_source",
           "lint_fault_paths", "lint_fault_source", "seam_coverage",
           "coverage_gaps"]


def validate_or_raise(conf, batchSize=32, mesh=None, hbm_gb=None,
                      plan=None):
    """The eager-check contract behind init(validate=True), shared by
    MultiLayerNetwork and ComputationGraph. With a `mesh`, or an
    `hbm_gb` budget (then on the one-card mesh ``{"data": 1}``), the
    partition-plan passes run too (validate_plan subsumes the shape
    pass). Returns the Report on success; raises ConfigValidationError
    with every finding otherwise."""
    if mesh is not None or hbm_gb is not None:
        report = validate_plan(conf, mesh if mesh is not None
                               else {"data": 1}, plan=plan,
                               batchSize=batchSize, hbm_gb=hbm_gb)
    else:
        report = validate_model(conf, batchSize=batchSize)
    if not report.ok:
        raise ConfigValidationError(report)
    return report


def zoo_corpus():
    """Every zoo model (default construction) as (name, ZooModel) pairs:
    the corpus of ``--zoo`` and the self-check tests, enumerated from
    ``zoo.models`` (every ZooModel subclass defined there), so a model
    added there joins the gate."""
    import inspect

    from deeplearning4j_tpu_torch.zoo import models as Z

    classes = [
        cls for _, cls in sorted(vars(Z).items())
        if inspect.isclass(cls) and issubclass(cls, Z.ZooModel)
        and cls is not Z.ZooModel and cls.__module__ == Z.__name__
    ]
    return [(cls.__name__, cls()) for cls in classes]
