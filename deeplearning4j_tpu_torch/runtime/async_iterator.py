"""Async prefetching iterators.

The counterpart of ``deeplearning4j_tpu/runtime/async_iterator.py``
(reference: org.nd4j.linalg.dataset.AsyncDataSetIterator /
AsyncMultiDataSetIterator): a background ETL thread keeps a bounded ring
of ready batches so ``fit`` does not wait on host-side data work. The
ring is the native one (``csrc/prefetch.cpp``); batches cross it as
bytes in the reference's layout (``pack_arrays``), and the producer
contract is the reference's: a producer error surfaces on the next
consumer call, before any batch still queued; a worker that dies without
a sentinel or an error fails loudly; ``reset`` starts a fresh epoch; the
masks survive.

The consumer hands a batch to its device the way ``fitDataSet``'s
``BlockStager`` does. On the card each batch is popped straight into one
of a few pinned host buffers and copied from there with ``non_blocking``
on a side stream, behind an event the compute stream waits on; a pinned
buffer is refilled only after the event of the copy out of it has
completed, so a copy still in flight is never overwritten. A batch then
makes three host copies between the producer and the pinned buffer: the
pack, the push into the ring and the pop out of it (``HOST_COPIES``).
On the CPU a batch is popped as bytes and its arrays are numpy views of
them, as in the reference.

Spans (``runtime.telemetry``): the producer's ``prefetch.next`` (the
wrapped iterator's ETL), ``prefetch.pack`` and ``prefetch.push`` (the
wait for a free slot and the copy into it), the consumer's
``prefetch.pop`` (the wait for a batch and the copy out) and
``prefetch.stage`` (the copies to the device, enqueued).
"""

from __future__ import annotations

import struct
import threading
import time as _time
import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import _np as _to_np
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.ringbuffer import (
    PF_CLOSED, PF_TIMEOUT, PF_TOO_BIG, make_ring,
)

__all__ = ["AsyncDataSetIterator", "AsyncMultiDataSetIterator",
           "pack_arrays", "unpack_arrays", "HOST_COPIES"]

#: host copies of a batch between the producer and the pinned buffer
#: on the card: the pack, the push into the ring, the pop out of it
HOST_COPIES = 3
#: pinned host buffers a device consumer cycles through
PINNED_BUFFERS = 2

_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
           np.float16, np.int16, np.int8, np.uint32, np.uint64]
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}


def _pack(arrays, out=None) -> np.ndarray:
    """``pack_arrays``'s bytes as one uint8 array, each array copied
    once into it: into `out` (a reused buffer, whose pages are already
    mapped) where it is large enough, else into a new one."""
    head = [struct.pack("<I", len(arrays))]
    body = []
    for a in arrays:
        if a is None:
            head.append(struct.pack("<B", 0))
            continue
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"unsupported dtype {a.dtype}")
        head.append(struct.pack(f"<BBB{a.ndim}I", 1, code, a.ndim, *a.shape))
        body.append(a)
    head = b"".join(head)
    n = len(head) + sum(a.nbytes for a in body)
    out = np.empty(n, np.uint8) if out is None or out.size < n else out[:n]
    out[:len(head)] = np.frombuffer(head, np.uint8)
    off = len(head)
    for a in body:
        out[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        off += a.nbytes
    return out


def pack_arrays(arrays) -> bytes:
    """[np.ndarray | None, ...] -> bytes. Header: u32 count; per array:
    u8 present, u8 dtype, u8 ndim, u32 dims[ndim]; payloads follow in
    order (the reference's layout, byte for byte)."""
    return _pack(arrays).tobytes()


def _metas(buf):
    """The header of a packed buffer: [(dtype, shape, offset) | None]."""
    (count,) = struct.unpack_from("<I", buf, 0)
    off = 4
    metas = []
    for _ in range(count):
        (present,) = struct.unpack_from("<B", buf, off)
        off += 1
        if not present:
            metas.append(None)
            continue
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        metas.append([np.dtype(_DTYPES[code]), tuple(shape)])
    for m in metas:
        if m is not None:
            m.append(off)
            off += int(np.prod(m[1], dtype=np.int64)) * m[0].itemsize
    return metas


def unpack_arrays(buf):
    """Inverse of pack_arrays; array payloads are zero-copy views of buf."""
    out = []
    for m in _metas(buf):
        if m is None:
            out.append(None)
            continue
        dt, shape, off = m
        out.append(np.frombuffer(
            buf, dt, count=int(np.prod(shape, dtype=np.int64)),
            offset=off).reshape(shape))
    return out


def _span(name, t0):
    """Record a prefetch span from `t0` (perf_counter) to now."""
    t1 = _time.perf_counter()
    telemetry.get_registry().add_span(name, "data", t0, t1 - t0)
    return t1


def _pack_dataset(ds, out=None) -> np.ndarray:
    return _pack([_to_np(ds.getFeatures()), _to_np(ds.getLabels()),
                  _to_np(ds.getFeaturesMaskArray()),
                  _to_np(ds.getLabelsMaskArray())], out)


class _DeviceFeed:
    """Pinned host buffers and the side stream that carry popped batches
    to the card (module docstring). Handing numpy views to the network
    instead, for ``fit`` or ``fitDataSet``'s stager to copy, costs the
    training thread more (``scripts/prefetch_ab.py``'s ``async_cpu`` and
    ``fds_async_cpu``)."""

    def __init__(self, device, slot_bytes):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pinned = [torch.empty(slot_bytes, dtype=torch.uint8,
                                   pin_memory=True)
                       for _ in range(PINNED_BUFFERS)]
        self.events = [None] * PINNED_BUFFERS
        self.next = 0

    def pop(self, ring, timeout_ms):
        """Pop into the next free pinned buffer: (buffer index, n) or a
        PF_* code."""
        i = self.next
        if self.events[i] is not None:
            self.events[i].synchronize()   # its last copy has left
            self.events[i] = None
        n = ring.pop_into(self.pinned[i], timeout_ms)
        if n < 0:
            return n
        self.next = (i + 1) % PINNED_BUFFERS
        return i, n

    def arrays(self, i, n, host_first=False):
        """The packed batch in pinned buffer i as device tensors, copied
        on the side stream; the compute stream waits for the copies.
        `host_first` keeps the first array on the host (a copy: the
        MultiDataSet's counts)."""
        buf = self.pinned[i][:n]
        cur = torch.cuda.current_stream(self.device)
        out = []
        with torch.cuda.stream(self.stream):
            for j, m in enumerate(_metas(buf.numpy())):
                if m is None:
                    out.append(None)
                    continue
                dt, shape, off = m
                nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
                if j == 0 and host_first:
                    out.append(buf[off:off + nb].numpy().view(dt)
                               .reshape(shape).copy())
                    continue
                t = torch.empty(nb, dtype=torch.uint8, device=self.device)
                t.copy_(buf[off:off + nb], non_blocking=True)
                out.append(t.view(torch.from_numpy(np.empty(0, dt)).dtype)
                           .view(shape))
        ev = torch.cuda.Event()
        ev.record(self.stream)
        self.events[i] = ev
        cur.wait_event(ev)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        return out


class AsyncDataSetIterator:
    """Wraps any DataSetIterator with background prefetch (reference:
    AsyncDataSetIterator(backedIterator, queueSize)).

    The producer thread runs the wrapped iterator (record reading,
    normalization, any Python or native ETL) and pushes packed batches
    into the ring; the training loop pops ready batches. An end-of-epoch
    sentinel (an empty payload) closes each pass. ``forcePython`` takes
    the Python ring; ``device`` is where the batches are handed (the
    card unless ``"cpu"`` is asked for).
    """

    _SENTINEL = b""

    def __init__(self, backedIterator, queueSize: int = 4,
                 forcePython: bool = False, device=None):
        self._base = backedIterator
        self._queueSize = max(2, int(queueSize))
        self._forcePython = forcePython
        self.device = resolve_device(device)
        self._ring = None
        self._feed = None
        self._thread = None
        self._error = None
        self._pending = None
        self._exhausted = False
        self._start_epoch()

    @property
    def ring(self):
        """The ring in use (its ``kind`` is "native" or "python")."""
        return self._ring

    # ----- producer ---------------------------------------------------
    def _pack_next(self, out=None):
        t0 = _time.perf_counter()
        ds = self._base.next()
        t0 = _span("prefetch.next", t0)
        payload = _pack_dataset(ds, out)
        _span("prefetch.pack", t0)
        return payload

    def _producer(self, ring):  # fault-ok[FLT02]: data-layer faults are FaultInjector's domain (runtime/resilience.py wraps the base iterator); the chaos seams cover the serving tier
        # one pack buffer a pass: the push copies each payload into the
        # ring, so the buffer is free again when it returns
        buf = np.empty(ring.slot_bytes, np.uint8)
        try:
            while self._base.hasNext():
                payload = self._pack_next(buf)
                t0 = _time.perf_counter()
                rc = ring.push(payload)
                _span("prefetch.push", t0)
                if rc == PF_CLOSED:
                    return  # consumer reset/shut down
                if rc == PF_TOO_BIG:
                    raise ValueError(
                        f"batch of {payload.size} bytes exceeds ring slot "
                        f"{ring.slot_bytes}")
            ring.push(self._SENTINEL)
        except Exception as e:  # surface in the consumer
            if ring is self._ring:
                self._error = e
            # else: an abandoned worker of an earlier epoch; its failure
            # must not poison the current epoch's fresh ring
            ring.close()

    def _start_epoch(self):
        self._base.reset()
        self._error = None
        self._pending = None
        self._exhausted = False
        if not self._base.hasNext():
            self._exhausted = True
            return
        # size slots from the first batch (uniform batches; the final
        # partial batch is only ever smaller)
        first = self._pack_next()
        if self._ring is None:
            # 2x + header margin: a padded final minibatch can carry mask
            # arrays the first batch lacks
            self._ring = make_ring(self._queueSize, 2 * first.size + 1024,  # thread-ok[THR04]: single-consumer contract: only the consumer thread starts an epoch; the producer gets the ring as an argument
                                   force_python=self._forcePython)
            if self.device.type == "cuda":
                self._feed = _DeviceFeed(self.device, self._ring.slot_bytes)
        else:
            self._ring.reopen()
        self._ring.push(first)
        self._thread = threading.Thread(target=self._producer,
                                        args=(self._ring,), daemon=True)
        self._thread.start()

    # ----- consumer (DataSetIterator surface) -------------------------
    def _pop(self, timeout_ms):
        """The next payload: (buffer index, n) on the card, bytes on the
        CPU (b"" is the sentinel), or a PF_* code."""
        t0 = _time.perf_counter()
        got = self._pop_raw(timeout_ms)
        if got != PF_TIMEOUT:
            _span("prefetch.pop", t0)
        return got

    def _pop_raw(self, timeout_ms):
        if self._feed is not None:
            got = self._feed.pop(self._ring, timeout_ms)
            if isinstance(got, tuple) and got[1] == 0:
                return self._SENTINEL
            return got
        return self._ring.pop(timeout_ms)

    def _fill(self):
        """Stage the next batch. A producer error propagates on the very
        next consumer call, before any batch still queued in the ring,
        and never stalls the loop: the pop runs on a short timeout, so a
        raise that a missed close() wakeup would hide is seen within
        ~100 ms."""
        if self._pending is not None or self._exhausted:
            return
        while True:
            if self._error is not None:
                self._finish(drain=True)
                raise self._error
            got = self._pop(100)
            if got == PF_TIMEOUT:
                t = self._thread
                if (t is not None and not t.is_alive()
                        and self._error is None
                        and self._ring.count() == 0):
                    # worker died without sentinel or error: fail loudly
                    self._exhausted = True
                    self._thread = None
                    raise RuntimeError(
                        "async prefetch worker died without signaling "
                        "end-of-epoch or an error")
                continue  # re-check the error flag, then keep waiting
            if isinstance(got, int) or got == self._SENTINEL:
                # PF_CLOSED after an error or shutdown, or the sentinel
                self._finish()
                if self._error is not None:
                    raise self._error
                return
            self._pending = got
            return

    def _finish(self, drain=False):
        """End-of-pass bookkeeping: mark exhausted and join the producer
        so a raising worker never leaks its daemon thread (it has either
        pushed the sentinel or closed the ring, so it is exiting)."""
        self._exhausted = True
        if drain:
            self._ring.close()  # unstick a producer blocked on push
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if t is not None and not t.is_alive():
            self._thread = None

    def _take(self, host_first=False):
        """The pending payload's arrays (device tensors on the card,
        numpy views on the CPU)."""
        self._fill()
        if self._pending is None:
            if self._error is not None:
                raise self._error
            raise StopIteration("iterator exhausted")
        got, self._pending = self._pending, None
        if self._feed is not None:
            t0 = _time.perf_counter()
            out = self._feed.arrays(*got, host_first=host_first)
            _span("prefetch.stage", t0)
            return out
        return unpack_arrays(got)

    def hasNext(self) -> bool:
        self._fill()
        return self._pending is not None

    def next(self, num=None):
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        f, l, fm, lm = self._take()
        return DataSet(f, l, fm, lm)

    def reset(self):
        self._shutdown()
        self._start_epoch()

    def _shutdown(self):
        if self._ring is not None:
            self._ring.close()
        t = self._thread
        if t is not None and t.is_alive():
            # drain so a blocked producer can observe the close; bounded
            # so a base iterator stuck in I/O cannot hang reset()/close()
            deadline = _time.monotonic() + 5.0
            while t.is_alive() and _time.monotonic() < deadline:
                self._ring.pop(timeout_ms=10)
                t.join(timeout=0.05)
            if t.is_alive():
                warnings.warn(
                    "async prefetch worker did not exit within 5s "
                    "(base iterator stuck in I/O?); abandoning the "
                    "daemon thread and its ring: when its blocking "
                    "call returns it may consume one more base batch, "
                    "then sees the closed ring and exits", stacklevel=3)
                # never reuse this ring: the zombie would push a stale
                # batch or sentinel into the next epoch after reopen()
                self._ring = None
                self._feed = None
        self._thread = None

    def close(self):
        self._shutdown()

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    # passthrough metadata
    def batch(self):
        return self._base.batch()

    def totalExamples(self):
        return self._base.totalExamples()

    def inputColumns(self):
        return self._base.inputColumns()

    def totalOutcomes(self):
        return self._base.totalOutcomes()

    def setPreProcessor(self, pp):
        self._base.setPreProcessor(pp)

    def getPreProcessor(self):
        return self._base.getPreProcessor()


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Async wrapper for a MultiDataSetIterator (reference:
    AsyncMultiDataSetIterator). Packs the flattened feature/label/mask
    lists instead of the DataSet's four slots."""

    @staticmethod
    def _pack_mds(mds, out=None) -> np.ndarray:
        def to_np_list(xs):
            return [_to_np(x) for x in (xs or [])]

        feats = to_np_list(mds.getFeatures())
        labs = to_np_list(mds.getLabels())
        fmasks = to_np_list(mds.getFeaturesMaskArrays())
        lmasks = to_np_list(mds.getLabelsMaskArrays())
        # mask lists are positional: pad with None slots to the arity of
        # their array lists so unpacking stays index-aligned
        fmasks += [None] * (len(feats) - len(fmasks))
        lmasks += [None] * (len(labs) - len(lmasks))
        counts = np.array([len(feats), len(labs)], np.uint32)
        return _pack([counts] + feats + labs + fmasks + lmasks, out)

    def _pack_next(self, out=None):
        t0 = _time.perf_counter()
        mds = self._base.next()
        t0 = _span("prefetch.next", t0)
        payload = self._pack_mds(mds, out)
        _span("prefetch.pack", t0)
        return payload

    def next(self, num=None):
        from deeplearning4j_tpu_torch.data.multidataset import MultiDataSet

        arrays = self._take(host_first=True)
        nf, nl = int(arrays[0][0]), int(arrays[0][1])
        feats = arrays[1:1 + nf]
        labs = arrays[1 + nf:1 + nf + nl]
        fmasks = arrays[1 + nf + nl:1 + 2 * nf + nl]
        lmasks = arrays[1 + 2 * nf + nl:1 + 2 * nf + 2 * nl]
        return MultiDataSet(feats, labs,
                            fmasks if any(m is not None for m in fmasks)
                            else None,
                            lmasks if any(m is not None for m in lmasks)
                            else None)
