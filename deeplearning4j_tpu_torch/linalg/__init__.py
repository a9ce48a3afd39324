"""Distributed linear algebra on mesh-sharded matrices.

The counterpart of ``deeplearning4j_tpu/linalg/``: dense operands live
block-sharded over the ranks of a ``parallel.mesh`` (one rank a process
over ``torch.distributed``), and every routine runs the same block program
on every rank with its collectives made through ``parallel.collectives``
(recorded, so ``analysis.collectives`` checks them).

  DistributedMatrix      this rank's block of a global matrix (row/col/2-D
                         layouts, the never-pad PAR03 contract)
  matmul / gram /        SUMMA GEMM (+ transpose-fused variants),
  covariance             Gram/covariance reduced over the sharded rows
  rsvd / pca             randomized SVD / PCA, small factors replicated
  cg / lstsq             matrix-free solvers with convergence diagnostics
                         (nn.solvers' CONJUGATE_GRADIENT solves through cg)
  validate_linalg_plan   PAR01/03/04/06 pre-flight and per-rank byte bills
                         (CLI: analysis --linalg)
  precompile             capture of the public entries (runtime.aot)
"""

from deeplearning4j_tpu_torch.linalg.distributed import (  # noqa: F401
    COL_AXIS, ROW_AXIS, DistributedMatrix, collective_counts, covariance,
    gram, install_retrace_sentinel, matmul, pairwise_sq_dists,
    precompile, sq_dists,
)
from deeplearning4j_tpu_torch.linalg.solvers import (  # noqa: F401
    CGResult, cg, lstsq,
)
from deeplearning4j_tpu_torch.linalg.randomized import pca, rsvd  # noqa: F401
from deeplearning4j_tpu_torch.linalg.plan import (  # noqa: F401
    CANONICAL_LINALG_MESH, CANONICAL_LINALG_PLANS, gram_plan, lstsq_plan,
    matmul_plan, rsvd_plan, validate_linalg_plan,
)

__all__ = [
    "DistributedMatrix", "ROW_AXIS", "COL_AXIS", "matmul", "gram",
    "covariance", "pairwise_sq_dists", "sq_dists", "rsvd", "pca", "cg",
    "lstsq", "CGResult", "collective_counts", "install_retrace_sentinel",
    "precompile", "matmul_plan", "gram_plan", "rsvd_plan", "lstsq_plan",
    "CANONICAL_LINALG_MESH", "CANONICAL_LINALG_PLANS",
    "validate_linalg_plan",
]
