"""The port's serving tier: one-shot models behind a micro-batcher
(``:predict``), paged-KV token generation and carry-slot recurrent
sequences (``:generate``), behind a model host, an HTTP server and the
fleet router with its failure-domain primitives.

* ``queue``    — bounded request queue + dynamic micro-batcher, and the
  tier's error types and injectable clock.
* ``sequence`` — iteration-level slot schedulers: the carry-slot
  ``SequenceScheduler`` and the KV-slot ``PagedSequenceScheduler``.
* ``kvcache``  — the paged KV cache (``KVCacheFullError`` is a 429).
* ``sampling`` — host-side decode samplers.
* ``host``     — multi-model host with rolling swaps, one-shot and
  sequence tables.
* ``fleet``    — N hosts behind a least-loaded router: SLOs, autoscale
  decisions, fleet-wide swaps, load scenarios.
* ``breaker``  — circuit breaker, quarantine, retry budget, brownout.
* ``server``   — the HTTP front.
* ``loadgen``  — open- and closed-loop load generators.
"""

from deeplearning4j_tpu_torch.serving.breaker import (
    BrownoutController, CircuitBreaker, ReplicaHealth, RetryBudget,
)
from deeplearning4j_tpu_torch.serving.queue import (
    DeadlineExceededError, InferenceRequest, ManualClock, MicroBatcher,
    QueueFullError, RequestCancelledError, ServingClosedError,
)
from deeplearning4j_tpu_torch.serving.kvcache import (
    KVCacheFullError, PagedKVCache,
)
from deeplearning4j_tpu_torch.serving.sampling import (
    greedy_sampler, sampled_onehot_feedback, stream_rng,
    temperature_sampler,
)
from deeplearning4j_tpu_torch.serving.sequence import (
    GenerationRequest, PagedSequenceScheduler, SequenceRequest,
    SequenceScheduler, greedy_onehot_feedback,
)
from deeplearning4j_tpu_torch.serving.host import (
    ModelHost, ServedModel, ServedSequenceModel,
)
from deeplearning4j_tpu_torch.serving.fleet import FleetRouter, ModelSLO
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.serving import loadgen

__all__ = ["DeadlineExceededError", "InferenceRequest", "ManualClock",
           "MicroBatcher", "QueueFullError", "RequestCancelledError",
           "ServingClosedError", "SequenceRequest", "SequenceScheduler",
           "greedy_onehot_feedback", "GenerationRequest",
           "PagedSequenceScheduler", "KVCacheFullError", "PagedKVCache",
           "greedy_sampler", "temperature_sampler", "stream_rng",
           "sampled_onehot_feedback", "ModelHost", "ServedModel", "ServedSequenceModel",
           "FleetRouter", "ModelSLO", "InferenceServer",
           "BrownoutController", "CircuitBreaker", "ReplicaHealth",
           "RetryBudget", "loadgen"]
