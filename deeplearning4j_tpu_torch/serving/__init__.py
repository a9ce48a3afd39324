"""The port's serving tier: paged-KV token generation and carry-slot
recurrent sequences behind a model host and an HTTP server."""

from deeplearning4j_tpu_torch.serving.host import ModelHost, ServedSequenceModel
from deeplearning4j_tpu_torch.serving.kvcache import (
    KVCacheFullError, PagedKVCache,
)
from deeplearning4j_tpu_torch.serving.queue import (
    DeadlineExceededError, ManualClock, QueueFullError,
    RequestCancelledError, ServingClosedError,
)
from deeplearning4j_tpu_torch.serving.sampling import (
    greedy_sampler, stream_rng, temperature_sampler,
)
from deeplearning4j_tpu_torch.serving.sequence import (
    GenerationRequest, PagedSequenceScheduler, SequenceRequest,
    SequenceScheduler, greedy_onehot_feedback,
)
from deeplearning4j_tpu_torch.serving.server import InferenceServer

__all__ = ["ModelHost", "ServedSequenceModel", "KVCacheFullError",
           "PagedKVCache", "DeadlineExceededError", "ManualClock",
           "QueueFullError", "RequestCancelledError", "ServingClosedError",
           "greedy_sampler", "stream_rng", "temperature_sampler",
           "GenerationRequest", "PagedSequenceScheduler", "SequenceRequest",
           "SequenceScheduler", "greedy_onehot_feedback", "InferenceServer"]
