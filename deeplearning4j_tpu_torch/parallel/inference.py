"""Batch inference on the network's device, synchronous or queued.

The counterpart of ``deeplearning4j_tpu/parallel/inference.py``
(reference: org.deeplearning4j.parallelism.ParallelInference). The
reference splits a batch over a mesh with one sharded executable per
batch bucket. This port serves from ONE device, the network's (the card
unless the network was built with ``device="cpu"``); a mesh or device
list of more than one card raises until ROADMAP Queue 1 item 7 brings
the replica split.

The modes:

* ``INPLACE`` / ``SEQUENTIAL``: every ``output()`` call is one forward
  (padded up to its batch bucket when ``batchBuckets`` is set; chunked
  host-side by ``batchLimit``).
* ``BATCHED``: concurrent ``output()`` callers feed a bounded queue
  (``queueLimit``) and a ``MicroBatcher`` coalesces them into ONE padded
  forward per micro-batch. Overflow raises ``QueueFullError``.

Every dispatch copies its padded batch to the device once, runs the
inference forward under ``torch.no_grad()`` (set in the dispatching
thread: grad mode is thread-local) and brings the output back to the
host once; callers' rows are sliced there.

Where the reference compiles an executable per bucket, the port
CAPTURES one: ``precompile`` captures the inference forward of each
bucket as a CUDA graph (``runtime.aot``; on the CPU the same forward runs
eagerly, with its key) and a dispatch at a captured bucket copies its
rows into the graph's static input, replays it and copies the static
output back, under one lock (concurrent callers share the buffers).
Once precompiled, every dispatch goes through the capture: one that
cannot replay (a bucket never captured, a model rebound by ``init`` or
a load, other knob values) runs eagerly and is counted
(``dl4j_capture_uncaptured_total``). ``cold_dispatches`` counts request-path forwards at a padded batch this
instance never warmed (or ran before): the analog of the reference's
"zero request-path compiles", and the serving gate. ``WarmSignatures``
reports a bucket "warm" when its signature was seen before by its owner
(another instance, a swapped-out version).

``int8=True`` serves through ``nn/quantize.int8_infer_fn``: the weights
are quantized once here and dequantized to the compute dtype in every
forward.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.runtime import aot, telemetry
from deeplearning4j_tpu_torch.runtime.aot import (  # noqa: F401
    DEFAULT_BATCH_BUCKETS, bucket_batch, pad_batch,
)

__all__ = ["ParallelInference", "INFERENCE_MODES", "DEFAULT_BATCH_BUCKETS",
           "WarmSignatures", "bucket_batch", "pad_batch",
           "shape_for_input_type"]

#: upstream InferenceMode names; anything else is rejected at
#: construction
INFERENCE_MODES = ("INPLACE", "SEQUENTIAL", "BATCHED")

_PI_SEQ = itertools.count(1)


def shape_for_input_type(it, batchSize):
    """The API-layout feature shape of `batchSize` examples of one
    InputType (reference: nn/multilayer.py shape_for_input_type)."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as IT

    B = int(batchSize)
    if it is None:
        raise ValueError("a conf with no declared InputType needs "
                         "featuresShape=...")
    if it.kind == IT.FF:
        return (B, it.size)
    if it.kind == IT.CNN_FLAT:
        return (B, it.channels, it.height, it.width)
    if it.kind == IT.CNN:
        return (B, it.height, it.width, it.channels) \
            if getattr(it, "format", "NCHW") == "NHWC" \
            else (B, it.channels, it.height, it.width)
    if it.kind == IT.CNN3D:
        return (B, it.channels, it.depth, it.height, it.width)
    if it.kind == IT.RNN:
        T = it.dims.get("timeSeriesLength")
        if not T:
            raise ValueError("a recurrent InputType with no "
                             "timeSeriesLength needs featuresShape=...")
        return (B, it.size, T)
    raise ValueError(f"unsupported InputType {it!r}; pass featuresShape")


class WarmSignatures(aot.ExecutableCache):
    """A memory-only capture cache an owner shares among its
    ParallelInference instances: a bucket's capture reports "cold" the
    first time its key (the network's configuration, the padded batch,
    the card, the knobs, int8) is captured into it while no other graph
    of that key lives, "warm" after. ``ModelHost`` keeps one for all its
    versions, so a swap to a network of the same configuration warms
    "warm", as the reference's AOT cache reports a hit."""

    def __init__(self):
        super().__init__(None)


def _graph(model):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return isinstance(model, ComputationGraph)


def _host(x):
    """An INDArray, tensor or array-like as a host numpy array."""
    if isinstance(x, INDArray):
        x = x.tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _one_device(model, mesh):
    if mesh is None:
        return model.device
    devs = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
    if len(devs) != 1:
        raise NotImplementedError(
            f"ParallelInference over {len(devs)} devices waits for the "
            "replica split of ROADMAP Queue 1 item 7; the port serves "
            "from the network's one device")
    if torch.device(devs[0]) != model.device:
        raise ValueError(f"ParallelInference runs on the network's device "
                         f"({model.device}), not {devs[0]}")
    return model.device


class ParallelInference:
    """output() on the network's device (module docstring).

    model: an initialised MultiLayerNetwork or ComputationGraph.
    mesh: None, or one device (the network's); more raise.
    batchLimit: max examples per dispatch; larger inputs are chunked
        host-side.
    batchBuckets: padded batch sizes; a request batch is padded up to
        the nearest, so the forward runs at a few warm shapes only.
    inferenceMode: INPLACE/SEQUENTIAL (sync) or BATCHED (queued).
    queueLimit / maxWaitMs: the BATCHED queue's bound and hold time.
    int8: weight-only int8 serving (nn/quantize).
    clock: injectable clock for the BATCHED queue; with one, the queue
        runs no thread and the owner drives ``poll()``/``flush()``.
    metricsName: the `model` label of the queue's instruments.
    warmSignatures: the ``WarmSignatures`` (capture cache) the buckets'
        captures and the warm report use (the session cache by default).
    """

    def __init__(self, model, mesh=None, batchLimit=0, batchBuckets=None,
                 inferenceMode="INPLACE", queueLimit=64, maxWaitMs=2.0,
                 int8=False, clock=None, metricsName=None,
                 warmSignatures=None):
        if getattr(model, "kind", None) == "paged_lm":
            raise ValueError(
                "a paged LM generates tokens step by step: serve it "
                "through ModelHost.register_sequence (:generate), not "
                "one-shot output()")
        model._require_init()
        mode = str(inferenceMode).upper()
        if mode not in INFERENCE_MODES:
            raise ValueError(
                f"unknown inferenceMode {inferenceMode!r}: supported "
                f"modes are {INFERENCE_MODES} (INPLACE/SEQUENTIAL = one "
                "sync dispatch per output() call, BATCHED = queued "
                "dynamic micro-batching)")
        if int(queueLimit) < 1:
            raise ValueError(f"queueLimit must be >= 1, got {queueLimit}")
        self.model = model
        self.device = _one_device(model, mesh)
        self.batchLimit = int(batchLimit)
        self.inferenceMode = mode
        self.queueLimit = int(queueLimit)
        self.maxWaitMs = float(maxWaitMs)
        self._clock = clock
        self.metricsName = metricsName or f"pi{next(_PI_SEQ)}"
        self._batcher = None
        self._batcher_lock = threading.Lock()
        self._capture_lock = threading.Lock()
        self._closed = False
        if batchBuckets is None and mode == "BATCHED":
            # unbounded per-coalesced-size shapes would pay plan
            # selection on the request path
            batchBuckets = DEFAULT_BATCH_BUCKETS
        self.batchBuckets = None if batchBuckets is None else \
            tuple(sorted(int(b) for b in batchBuckets))
        self._int8 = bool(int8)
        if self._int8:
            from deeplearning4j_tpu_torch.nn.quantize import int8_infer_fn

            self._infer, self._qp, self._sc = int8_infer_fn(model)
        #: the cache the buckets' captures go to (None: the session's)
        self._signatures = warmSignatures
        self._warm_lock = threading.Lock()
        self._warmed = set()       # padded batches this instance ran
        self._capture = None       # the forward's CapturedStep
        self._replay_lock = threading.Lock()
        #: request-path forwards at a padded batch never warmed or run
        self.cold_dispatches = 0
        self._m_cold = telemetry.get_registry().counter(
            "dl4j_serving_cold_dispatches_total",
            "forwards at a padded batch the instance never warmed",
            labels=("model",)).labels(model=self.metricsName)

    # upstream builder-pattern compatibility ---------------------------
    class Builder:
        def __init__(self, model):
            self._model = model
            self._mesh = None
            self._batchLimit = 0
            self._batchBuckets = None
            self._inferenceMode = "INPLACE"
            self._queueLimit = 64

        def workers(self, n):
            """The reference's mesh size; the port serves from one
            device, so more than one raises at build()."""
            self._mesh = [self._model.device] * int(n)
            return self

        def batchLimit(self, n):
            self._batchLimit = int(n)
            return self

        def batchBuckets(self, *sizes):
            self._batchBuckets = tuple(int(s) for s in sizes)
            return self

        def inferenceMode(self, mode):
            self._inferenceMode = mode
            return self

        def queueLimit(self, n):
            self._queueLimit = int(n)
            return self

        def build(self):
            return ParallelInference(self._model, mesh=self._mesh,
                                     batchLimit=self._batchLimit,
                                     batchBuckets=self._batchBuckets,
                                     inferenceMode=self._inferenceMode,
                                     queueLimit=self._queueLimit)

    # -----------------------------------------------------------------
    def _target_batch(self, B):
        """The padded batch for B requested rows (the bucket when
        batchBuckets is set)."""
        return bucket_batch(B, self.batchBuckets) if self.batchBuckets \
            else int(B)

    def _pad(self, a, B):
        return pad_batch(a, self._target_batch(B))

    def _input_shape(self, B, featuresShape=None):
        if featuresShape is not None:
            return (B,) + tuple(featuresShape)
        if _graph(self.model):
            it = self.model.conf.inputTypes.get(
                self.model.conf.networkInputs[0])
        else:
            it = self.model.conf.inputType
        return shape_for_input_type(it, B)

    def precompile(self, batchSizes=None, featuresShape=None):
        """Warm every batch bucket (or the given batchSizes): one
        forward each on the network's device, so the first request at
        each finds its plans chosen and its memory allocated.
        featuresShape overrides the per-example shape derived from the
        conf's InputType. Returns {batch: {key, status, seconds}}:
        status "cold" for a key new to the capture cache (the
        WarmSignatures given, else the session cache), "warm" for a key
        it holds."""
        sizes = tuple(batchSizes) if batchSizes is not None else \
            (self.batchBuckets or ())
        if not sizes:
            raise ValueError(
                "precompile needs batchSizes=... or batchBuckets set at "
                "construction")
        if _graph(self.model) and len(self.model.conf.networkInputs) != 1:
            raise ValueError(
                "precompile supports single-input ComputationGraphs; "
                "warm a multi-input graph by running one real batch "
                "through output()")
        report = {}
        cap = self._forward_capture()
        for B in sizes:
            Bt = self._target_batch(int(B))
            x = np.zeros(self._input_shape(Bt, featuresShape), np.float32)
            t0 = time.perf_counter()
            feed = (torch.from_numpy(x).to(self.device),)
            if cap.captured(feed):
                key, status = cap.key_for(feed), "warm"
            else:
                with torch.no_grad(), _on(self.device):
                    key, status, _ = cap.capture(feed)
            with self._warm_lock:
                self._warmed.add(Bt)
            secs = time.perf_counter() - t0
            report[int(B)] = {"key": key[:16], "status": status,
                              "seconds": round(secs, 3)}
        return report

    def _forward_capture(self):
        """The inference forward's ``CapturedStep`` (one graph a
        bucket)."""
        cap = self._capture  # thread-ok[THR01]: atomic reference read: the double-checked fast path
        if cap is not None:
            return cap
        with self._capture_lock:
            if self._capture is None:
                def body(*feed):
                    with torch.no_grad():
                        return self._infer_feed(list(feed))

                self._capture = aot.CapturedStep(
                    body, owner=self.model, entry="forward_infer",
                    extra=f"|int8={self._int8}", cache=self._signatures)
            return self._capture

    def _infer_feed(self, feed):
        feed = feed if _graph(self.model) and len(feed) > 1 else feed[0]
        if self._int8:
            return self._infer(self._qp, self._sc, feed)
        return self.model._forward_infer(self.model._params, feed)

    def example_shape(self):
        """Per-example feature shape from the conf's InputType, or None
        when it cannot be derived (multi-input graphs, a recurrent type
        with no length): the request contract the queue checks."""
        if _graph(self.model) and len(self.model.conf.networkInputs) != 1:
            return None
        try:
            return tuple(self._input_shape(1)[1:])
        except (ValueError, AttributeError, KeyError):
            return None

    def _forward(self, arrays, B, warm=False):
        """One dispatch: the padded host arrays (one per network input)
        to the device in one copy each, the inference forward, the
        outputs back to the host in one copy each; rows [:B]."""
        Bt = arrays[0].shape[0]
        with self._warm_lock:
            cold = not warm and Bt not in self._warmed
            self._warmed.add(Bt)
            if cold:
                self.cold_dispatches += 1
        if cold:
            self._m_cold.inc()
        feed = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]
        cap = self._capture  # thread-ok[THR01]: atomic reference read; None (not yet precompiled) takes the eager path
        # grad mode and the current device are thread-local: set both
        # here, in whichever thread dispatches
        with torch.no_grad(), _on(self.device):
            if cap is None:
                return self._host_rows(self._infer_feed(feed), B)
            # once precompiled, every dispatch goes through the capture:
            # a replay, else an eager forward it counts (a bucket never
            # captured, a rebound model, other knobs)
            with self._replay_lock:       # the graph's static buffers
                return self._host_rows(cap(*feed), B)

    @staticmethod
    def _host_rows(out, B):
        outs = out if isinstance(out, (list, tuple)) else [out]
        host = []
        for o in outs:
            if o.dtype in (torch.bfloat16, torch.float16):
                o = o.float()
            host.append(o.cpu().numpy()[:B])
        return host

    def _run(self, inputs, B):
        """inputs: one array (MultiLayerNetwork) or {name: array}."""
        if isinstance(inputs, dict):
            arrays = [self._pad(inputs[n], B)
                      for n in self.model.conf.networkInputs]
        else:
            arrays = [self._pad(inputs, B)]
        return self._forward(arrays, B)

    # -- BATCHED mode ---------------------------------------------------
    def _dispatch_coalesced(self, feats):
        """ONE padded dispatch for a host-coalesced batch: the
        MicroBatcher's dispatch callable. Returns the per-row outputs
        (a list for multi-output graphs)."""
        if _graph(self.model):
            ins = self.model.conf.networkInputs
            if len(ins) != 1:
                raise ValueError(
                    "queued-batched dispatch coalesces on one batch "
                    "axis and supports single-input graphs; serve "
                    "multi-input graphs in INPLACE mode")
            outs = self._run({ins[0]: feats}, feats.shape[0])
        else:
            outs = self._run(feats, feats.shape[0])
        return outs if len(outs) > 1 else outs[0]

    def _ensure_batcher(self):
        b = self._batcher  # thread-ok[THR01]: atomic reference read: the double-checked fast path; a stale None falls through to the locked slow path
        if b is not None:
            return b
        with self._batcher_lock:
            b = self._batcher
            if b is not None:
                return b
            from deeplearning4j_tpu_torch.serving.queue import (
                MicroBatcher, ServingClosedError)

            if self._closed:
                # a first request racing close() must not resurrect a
                # batcher on a swapped-out instance: fail like a closed
                # queue so the host's swap re-route handles it
                raise ServingClosedError("ParallelInference is closed")
            b = MicroBatcher(
                self._dispatch_coalesced,
                max_rows=max(self.batchBuckets),
                queue_limit=self.queueLimit,
                max_wait=self.maxWaitMs / 1000.0,
                bucket_for=self._target_batch,
                trailing_shape=self.example_shape(),
                # the warm runs float32 feeds: one dtype, one signature
                feature_dtype=np.float32,
                clock=self._clock,
                start_thread=self._clock is None,
                name=self.metricsName)
            self._batcher = b
        return b

    def close(self, drain=True):
        """Stop the BATCHED queue (sync modes keep working)."""
        with self._batcher_lock:
            self._closed = True
            b = self._batcher
        if b is not None:
            b.close(drain=drain)
        return self

    def _single_array(self, features):
        """features as ONE coalescable [rows, ...] array, or None when
        the feed is not queue-batchable (dicts / multi-input graphs)."""
        if isinstance(features, dict):
            return None
        if _graph(self.model):
            if len(self.model.conf.networkInputs) != 1:
                return None
            inputs = self.model._coerce_inputs(features)
            return _host(next(iter(inputs.values())))
        return _host(features)

    def output(self, features):
        """Inference on the network's device. A single array for a
        MultiLayerNetwork; an array, list of arrays or {name: array} for
        a ComputationGraph. Returns an INDArray over a host tensor (a
        list for multi-output graphs).

        In BATCHED mode the call is queued and coalesced with concurrent
        callers into one dispatch; a row's answer is bitwise the one the
        sync path gives at the same padded batch. May raise
        QueueFullError under backpressure."""
        if self.inferenceMode == "BATCHED":
            arr = self._single_array(features)
            if arr is not None:
                res = self._ensure_batcher().submit(arr)
                outs = [INDArray(torch.from_numpy(np.asarray(o))) for o in
                        (res if isinstance(res, list) else [res])]
                return outs[0] if len(outs) == 1 else outs
            # a feed the queue cannot coalesce: sync dispatch

        if _graph(self.model):
            if isinstance(features, dict):
                inputs = {n: _host(a) for n, a in features.items()}
            else:
                inputs = {n: _host(a) for n, a in
                          self.model._coerce_inputs(features).items()}
            B = next(iter(inputs.values())).shape[0]
        else:
            inputs = _host(features)
            B = inputs.shape[0]

        if self.batchLimit and B > self.batchLimit:
            chunks = []
            for s in range(0, B, self.batchLimit):
                e = min(B, s + self.batchLimit)
                sub = ({n: a[s:e] for n, a in inputs.items()}
                       if isinstance(inputs, dict) else inputs[s:e])
                chunks.append(self._run(sub, e - s))
            outs = [np.concatenate([c[i] for c in chunks], axis=0)
                    for i in range(len(chunks[0]))]
        else:
            outs = self._run(inputs, B)
        outs = [INDArray(torch.from_numpy(o)) for o in outs]
        return outs[0] if len(outs) == 1 else outs


def _on(device):
    """The device as the thread's current CUDA device (a no-op context
    on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
