"""Runtime services of the port: the native prefetch ring and the async
iterators over it, telemetry, fault seams and the resilient training
harness (``resilience``)."""

from deeplearning4j_tpu_torch.runtime.ringbuffer import (
    NativeRingBuffer, PythonRingBuffer, make_ring, native_lib,
    PF_OK, PF_TIMEOUT, PF_CLOSED, PF_TOO_BIG,
)
from deeplearning4j_tpu_torch.runtime.async_iterator import (
    AsyncDataSetIterator, AsyncMultiDataSetIterator, pack_arrays,
    unpack_arrays,
)
from deeplearning4j_tpu_torch.runtime.resilience import (
    FaultInjector, NonFiniteStepError, Preemption, ResilientFit,
    RetryPolicy, non_finite_guard, retry,
)
from deeplearning4j_tpu_torch.runtime.chaos import (
    ChaosError, ChaosPlan, fault_point,
)

__all__ = [
    "NativeRingBuffer", "PythonRingBuffer", "make_ring", "native_lib",
    "AsyncDataSetIterator", "AsyncMultiDataSetIterator",
    "pack_arrays", "unpack_arrays",
    "PF_OK", "PF_TIMEOUT", "PF_CLOSED", "PF_TOO_BIG",
    "RetryPolicy", "retry", "FaultInjector", "Preemption", "ResilientFit",
    "NonFiniteStepError", "non_finite_guard",
    "ChaosError", "ChaosPlan", "fault_point",
]
