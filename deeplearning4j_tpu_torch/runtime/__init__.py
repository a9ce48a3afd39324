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

__all__ = [
    "NativeRingBuffer", "PythonRingBuffer", "make_ring", "native_lib",
    "AsyncDataSetIterator", "AsyncMultiDataSetIterator",
    "pack_arrays", "unpack_arrays",
    "PF_OK", "PF_TIMEOUT", "PF_CLOSED", "PF_TOO_BIG",
]
