"""Shared host-side utilities of the port: the HTTP helpers, the
tagged-tree codec (``serde``), model files (``serializer``), directory
checkpoints (``sharded_checkpoint``), the workspace shim
(``workspace``), the profiler (``profiler``: ``OpProfiler``, ``trace``
and ``annotate`` over ``torch.profiler``, ``compiled_cost`` and
``mfu``), tree copies (``pytree``) and the draws seam (``draws``)."""

from deeplearning4j_tpu_torch.util.serializer import (
    ModelSerializer, TrainingCheckpoint,
)
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    ShardedModelSerializer, gc_checkpoints, latest_step, read_manifest,
    step_path,
)
from deeplearning4j_tpu_torch.util.workspace import (
    MemoryWorkspace, WorkspaceConfiguration, WorkspaceManager,
)
from deeplearning4j_tpu_torch.util.profiler import OpProfiler, annotate, trace

__all__ = ["ModelSerializer", "TrainingCheckpoint", "ShardedModelSerializer",
           "latest_step", "gc_checkpoints", "step_path", "read_manifest",
           "MemoryWorkspace",
           "WorkspaceConfiguration", "WorkspaceManager", "OpProfiler",
           "trace", "annotate"]
