"""Shared host-side utilities of the port: the HTTP helpers, the
tagged-tree codec (``serde``), model files (``serializer``) and
directory checkpoints (``sharded_checkpoint``). The reference's
workspace and profiler names wait for ROADMAP.md Queue 1 item 13."""

from deeplearning4j_tpu_torch.util.serializer import (
    ModelSerializer, TrainingCheckpoint,
)
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    ShardedModelSerializer, gc_checkpoints, latest_step, read_manifest,
    step_path,
)

__all__ = ["ModelSerializer", "TrainingCheckpoint", "ShardedModelSerializer",
           "latest_step", "gc_checkpoints", "step_path", "read_manifest"]
