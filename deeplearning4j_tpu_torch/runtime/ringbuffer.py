"""ctypes binding for the native prefetch ring buffer, and the Python ring.

The counterpart of ``deeplearning4j_tpu/runtime/ringbuffer.py``
(reference: the bounded blocking queue inside
org.nd4j.linalg.dataset.AsyncDataSetIterator). The native ring
(``csrc/prefetch.cpp``, a copy of the reference's) memcpys payloads
while ctypes has dropped the GIL, so the ETL thread and the feed loop
overlap. ``make_ring`` builds the native ring; when it cannot be built
it raises (``runtime/_native.py``). The Python ring, with the same
interface and semantics, runs only when the caller asks for it
(``force_python=True``).

Beyond the reference's ``push(bytes)``/``pop() -> bytes``, both rings
take any contiguous buffer to push (bytes, bytearray, a numpy array, a
CPU tensor) and pop straight into a caller's buffer (``pop_into``: a
pinned tensor, say), so a payload is copied once into the ring and once
out of it.
"""

from __future__ import annotations

import ctypes
import queue
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime._native import NativeLoader

__all__ = ["NativeRingBuffer", "PythonRingBuffer", "make_ring", "native_lib",
           "PF_OK", "PF_TIMEOUT", "PF_CLOSED", "PF_TOO_BIG"]

PF_OK, PF_TIMEOUT, PF_CLOSED, PF_TOO_BIG = 0, -1, -2, -3


def _configure(lib):
    lib.pf_create.restype = ctypes.c_void_p
    lib.pf_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    lib.pf_capacity.restype = ctypes.c_size_t
    lib.pf_capacity.argtypes = [ctypes.c_void_p]
    lib.pf_slot_bytes.restype = ctypes.c_size_t
    lib.pf_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.pf_count.restype = ctypes.c_size_t
    lib.pf_count.argtypes = [ctypes.c_void_p]
    lib.pf_push.restype = ctypes.c_long
    lib.pf_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_long]
    lib.pf_pop.restype = ctypes.c_long
    lib.pf_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_long]
    lib.pf_close.argtypes = [ctypes.c_void_p]
    lib.pf_reopen.argtypes = [ctypes.c_void_p]


_loader = NativeLoader("prefetch.cpp", _configure, extra_flags=("-pthread",))


def native_lib():
    """The native library, built on first use; raises when it cannot be
    built."""
    return _loader.lib()


def _as_bytes_view(buf):
    """A contiguous buffer as a flat uint8 numpy view (no copy): bytes,
    bytearray, memoryview, a numpy array or a CPU tensor."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("ring buffers take contiguous CPU memory")
        return buf.view(-1).view(torch.uint8).numpy()
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("ring buffers take contiguous memory")
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


class NativeRingBuffer:
    """Bounded blocking byte-payload ring over the C++ implementation."""

    kind = "native"

    def __init__(self, capacity: int, slot_bytes: int):
        lib = native_lib()
        self._lib = lib
        self._h = lib.pf_create(capacity, slot_bytes)
        if not self._h:
            raise ValueError("bad ring parameters")
        self.slot_bytes = slot_bytes
        self._out = None

    def push(self, payload, timeout_ms: int = -1) -> int:
        if isinstance(payload, bytes):
            ptr, n = ctypes.cast(ctypes.c_char_p(payload),
                                 ctypes.c_void_p), len(payload)
            return self._lib.pf_push(self._h, ptr, n, timeout_ms)
        view = _as_bytes_view(payload)
        if view.size == 0:
            return self._lib.pf_push(self._h, None, 0, timeout_ms)
        return self._lib.pf_push(self._h, view.ctypes.data, view.size,
                                 timeout_ms)

    def pop(self, timeout_ms: int = -1):
        """bytes | PF_TIMEOUT | PF_CLOSED."""
        if self._out is None:
            self._out = np.empty(self.slot_bytes, np.uint8)
        n = self._lib.pf_pop(self._h, self._out.ctypes.data,
                             self.slot_bytes, timeout_ms)
        if n < 0:
            return int(n)
        return self._out[:n].tobytes()

    def pop_into(self, out, timeout_ms: int = -1) -> int:
        """Pop the next payload into `out` (a contiguous buffer of at
        least ``slot_bytes``): its byte count, or a PF_* code."""
        view = _as_bytes_view(out)
        return int(self._lib.pf_pop(self._h, view.ctypes.data, view.size,
                                    timeout_ms))

    def count(self) -> int:
        return int(self._lib.pf_count(self._h))

    def close(self):
        self._lib.pf_close(self._h)

    def reopen(self):
        self._lib.pf_reopen(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pf_destroy(self._h)
                self._h = None
        except Exception:
            pass


class PythonRingBuffer:
    """queue.Queue ring with the same interface and semantics."""

    kind = "python"

    def __init__(self, capacity: int, slot_bytes: int):
        self.slot_bytes = slot_bytes
        self._cap = capacity
        self._q = queue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    def push(self, payload, timeout_ms: int = -1) -> int:
        payload = bytes(payload) if not isinstance(payload, bytes) \
            else payload
        if len(payload) > self.slot_bytes:
            return PF_TOO_BIG
        deadline = None if timeout_ms < 0 else timeout_ms / 1000.0
        while not self._closed.is_set():
            try:
                self._q.put(payload,
                            timeout=0.05 if deadline is None else deadline)
                return PF_OK
            except queue.Full:
                if deadline is not None:
                    return PF_TIMEOUT
        return PF_CLOSED

    def pop(self, timeout_ms: int = -1):
        deadline = None if timeout_ms < 0 else timeout_ms / 1000.0
        while True:
            try:
                return self._q.get(
                    timeout=0.05 if deadline is None else deadline)
            except queue.Empty:
                if self._closed.is_set():
                    return PF_CLOSED
                if deadline is not None:
                    return PF_TIMEOUT

    def pop_into(self, out, timeout_ms: int = -1) -> int:
        got = self.pop(timeout_ms)
        if isinstance(got, int):
            return got
        view = _as_bytes_view(out)
        if len(got) > view.size:
            return PF_TOO_BIG
        view[:len(got)] = np.frombuffer(got, np.uint8)
        return len(got)

    def count(self) -> int:
        return self._q.qsize()

    def close(self):
        self._closed.set()

    def reopen(self):
        self._closed.clear()
        self._q = queue.Queue(maxsize=self._cap)


def make_ring(capacity: int, slot_bytes: int, force_python: bool = False):
    """The native ring (raises when it cannot be built), or the Python
    ring when the caller asks for it."""
    if force_python:
        return PythonRingBuffer(capacity, slot_bytes)
    return NativeRingBuffer(capacity, slot_bytes)
