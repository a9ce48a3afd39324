"""Distributed training over ``torch.distributed``: the data, model,
sequence and pipeline mesh axes.

The counterpart of ``deeplearning4j_tpu/parallel/`` (reference
subsystems: deeplearning4j-parallel-wrapper and the dl4j-spark
SharedTrainingMaster / parameter averaging): the mesh and its axes'
groups (``mesh``), starting ranks and ``hybrid_mesh`` (``multihost``),
the collectives and the axes' autograd exchanges (``collectives``), the
compressed exchanges and their bill, ``shard_params`` and
``replicate_params`` (``sharding``), the tensor-parallel layer rule
(``tensor``), ring and Ulysses attention over the "seq" axis
(``sequence``), the GPipe ``PipelineParallel`` over the "pipe" axis
(``pipeline``), the data-parallel trainers (``trainer``), the Spark
facades (``spark``), the multi-chip dry run's legs (``dryrun``) and
``ParallelInference`` on one device (``inference``). The ZeRO weight
update and the hierarchical 2-hop exchange are in ``sharding``.
``ParallelInference``'s replica split over cards, the overlap planner
and cost model, ``EarlyStoppingParallelTrainer`` and NCCL capture wait
for ROADMAP Queue 1 item 7.
"""

from deeplearning4j_tpu_torch.parallel.inference import (
    INFERENCE_MODES, ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, GROUP_AXIS, INTRA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
    DataGroup, Mesh, batch_sharded, build_mesh, data_parallel_mesh,
    replicated,
)
from deeplearning4j_tpu_torch.parallel.multihost import (
    hybrid_mesh, initialize as initializeMultiHost, is_coordinator, launch,
    num_hosts,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    PipelineParallel, partition_stages,
)
from deeplearning4j_tpu_torch.parallel.sharding import (
    COMPRESSION_MODES, DEFAULT_COMPRESSION_BLOCK, DEFAULT_COMPRESSION_GROUP,
    DEFAULT_ENCODING_CAPACITY, ManualZeroUpdate, ZeroShardedUpdate,
    compressed_wire_bytes, default_compression_group,
    dp_weight_update_bytes, hierarchical_grad_exchange, hierarchical_mesh,
    hierarchical_shard_elems, replicate_params, shard_params,
    spec_for_param,
)
from deeplearning4j_tpu_torch.parallel.sequence import (
    ring_attention, ulysses_attention,
)
from deeplearning4j_tpu_torch.parallel.spark import (
    ParameterAveragingTrainingMasterBuilder, SharedTrainingMasterBuilder,
    SparkComputationGraph, SparkDl4jMultiLayer,
)
from deeplearning4j_tpu_torch.parallel.trainer import (
    AdaptiveThresholdAlgorithm, FixedThresholdAlgorithm, ParallelWrapper,
    ParameterAveragingTrainingMaster, ResidualClippingPostProcessor,
    SharedTrainingMaster, TargetSparsityThresholdAlgorithm,
)

__all__ = [
    "build_mesh", "data_parallel_mesh", "DataGroup", "Mesh", "replicated",
    "batch_sharded", "shard_params", "replicate_params", "ring_attention",
    "ulysses_attention", "DATA_AXIS",
    "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "GROUP_AXIS", "INTRA_AXIS",
    "ParallelWrapper", "SharedTrainingMaster",
    "ParameterAveragingTrainingMaster", "FixedThresholdAlgorithm",
    "AdaptiveThresholdAlgorithm", "TargetSparsityThresholdAlgorithm",
    "ResidualClippingPostProcessor", "compressed_wire_bytes",
    "COMPRESSION_MODES", "DEFAULT_COMPRESSION_BLOCK",
    "DEFAULT_COMPRESSION_GROUP", "DEFAULT_ENCODING_CAPACITY",
    "default_compression_group", "hierarchical_shard_elems",
    "ZeroShardedUpdate", "ManualZeroUpdate", "dp_weight_update_bytes",
    "hierarchical_grad_exchange", "hierarchical_mesh",
    "initializeMultiHost", "hybrid_mesh", "is_coordinator", "num_hosts",
    "launch", "SparkDl4jMultiLayer", "SparkComputationGraph",
    "ParameterAveragingTrainingMasterBuilder", "SharedTrainingMasterBuilder",
    "ParallelInference", "INFERENCE_MODES",
    "PipelineParallel", "partition_stages", "spec_for_param",
]
