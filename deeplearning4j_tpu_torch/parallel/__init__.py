"""Data-parallel training over ``torch.distributed``.

The counterpart of ``deeplearning4j_tpu/parallel/``'s data-parallel
core (reference subsystems: deeplearning4j-parallel-wrapper and the
dl4j-spark SharedTrainingMaster / parameter averaging): the data group
(``mesh``), starting ranks (``multihost``), the collectives
(``collectives``), the compressed exchanges and their bill
(``sharding``), the trainers (``trainer``), the Spark facades
(``spark``) and the data-parallel legs of the multi-chip dry run
(``dryrun``), and ``ParallelInference`` on one device (``inference``).
The ZeRO weight update (``ZeroShardedUpdate``, ``weight_update=
"sharded"``) and the hierarchical 2-hop exchange (``hierarchical_mesh``,
``gradient_compression="hierarchical"``) are in ``sharding``. The
planning functions the partition-plan analyzer needs are here too:
``spec_for_param`` (``sharding``) and ``partition_stages``
(``pipeline``). Executing tensor, sequence and pipeline parallelism
(``PipelineParallel`` raises), ``ParallelInference``'s replica split
over cards and the cost model wait for ROADMAP Queue 1 item 7.
"""

from deeplearning4j_tpu_torch.parallel.inference import (
    INFERENCE_MODES, ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, GROUP_AXIS, INTRA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
    DataGroup, build_mesh, data_parallel_mesh,
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
    hierarchical_shard_elems, spec_for_param,
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
    "build_mesh", "data_parallel_mesh", "DataGroup", "DATA_AXIS",
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
