"""Multi-model host: name -> served version, with rolling swap.

The counterpart of ``deeplearning4j_tpu/serving/host.py``. Two tables:

* one-shot models (``register``/``swap``/``submit``, the ``:predict``
  path): a ``ServedModel`` is the network, its dtype and int8 policy,
  its batch buckets and a BATCHED-mode ``ParallelInference`` (bounded
  queue + micro-batcher) on the network's device. Registration warms
  every bucket (one forward each) before the name is routable.
* sequence models (``register_sequence``/``swap_sequence``): a
  ``ServedSequenceModel`` is the network plus its scheduler, the KV-slot
  ``PagedSequenceScheduler`` for a paged LM (``kind == "paged_lm"``:
  token prompts in, sampled tokens out) or the carry-slot
  ``SequenceScheduler`` for a recurrent ``MultiLayerNetwork``
  (per-step features in, per-step outputs out). Registration runs every
  slot bucket once (the paged LM also builds its kernels and runs a
  prefill chunk).

Rolling swap: the replacement is built and warmed while the current
version keeps serving; the routing entry flips atomically under the
host lock, and the old version drains what it had already queued
through its own warm buckets. A request that loses the resolve/enqueue
race against the flip is re-routed to the new version, so a swap never
surfaces as a 5xx and never puts a cold dispatch on the request path.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import (
    ParallelInference, WarmSignatures,
)
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.chaos import fault_point
from deeplearning4j_tpu_torch.serving.queue import ServingClosedError
from deeplearning4j_tpu_torch.serving.sequence import (
    PagedSequenceScheduler, SequenceScheduler,
)

__all__ = ["ServedModel", "ServedSequenceModel", "ModelHost"]


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


class ServedModel:
    """One (name, version) one-shot entry: network + policy + its
    BATCHED-mode ParallelInference. Build through ModelHost.register/
    swap."""

    def __init__(self, name, version, network, batchBuckets=None,
                 int8=False, queueLimit=64, maxWaitMs=2.0, clock=None,
                 warmSignatures=None):
        self.name = str(name)
        self.version = int(version)
        self.network = network
        self.int8 = bool(int8)
        self.pi = ParallelInference(
            network, batchBuckets=batchBuckets, inferenceMode="BATCHED",
            queueLimit=queueLimit, maxWaitMs=maxWaitMs, int8=int8,
            clock=clock, metricsName=f"{self.name}:v{self.version}",
            warmSignatures=warmSignatures)

    @property
    def batcher(self):
        return self.pi._ensure_batcher()

    def warm(self):
        """One forward per batch bucket. Returns the per-bucket {key,
        status, seconds} report."""
        return self.pi.precompile()

    def submit(self, features, deadline_s=None, wait=True):
        """Queue one request (features [rows, ...]) and block for its
        sliced result. deadline_s bounds the WHOLE request (queue wait +
        dispatch): expiry raises DeadlineExceededError whether the
        request was still queued or the dispatcher is busy. May raise
        QueueFullError. wait=False returns the InferenceRequest at
        enqueue (the fleet's hedged-dispatch handle)."""
        b = self.batcher
        features = fault_point("host.submit", features)
        deadline = None if deadline_s is None else \
            b.clock() + float(deadline_s)
        return b.submit(features, deadline=deadline, wait=wait,
                        timeout=deadline_s)

    def policy(self):
        """The policy row the model table reports."""
        return {
            "model": self.name,
            "version": self.version,
            "dtype": _dtype_name(self.network._compute_dtype),
            "int8": self.int8,
            "batchBuckets": list(self.pi.batchBuckets or ()),
            "queueLimit": self.pi.queueLimit,
            "maxWaitMs": self.pi.maxWaitMs,
            "exampleShape": list(self.pi.example_shape() or ()),
            "device": str(self.pi.device),
        }

    def close(self, drain=True):
        self.pi.close(drain=drain)
        return self


class ServedSequenceModel:
    """One (name, version) sequence entry: network + its slot scheduler,
    paged or carry-slot by the network's kind. Build through
    ModelHost.register_sequence/swap_sequence."""

    def __init__(self, name, version, network, slotBuckets=None,
                 queueLimit=64, feedback=None, clock=None, numPages=64,
                 sampler=None, samplerSeed=0, prefixSharing=True):
        self.name = str(name)
        self.version = int(version)
        self.network = network
        self.paged = getattr(network, "kind", None) == "paged_lm"
        common = dict(slot_buckets=slotBuckets, queue_limit=queueLimit,
                      clock=clock, start_thread=clock is None,
                      name=f"{self.name}:v{self.version}")
        if self.paged:
            self.scheduler = PagedSequenceScheduler(
                network, num_pages=numPages, sampler=sampler,
                sampler_seed=samplerSeed, prefix_sharing=prefixSharing,
                **common)
        else:
            self.scheduler = SequenceScheduler(network, feedback=feedback,
                                               **common)

    def warm(self):
        """Run every slot bucket once (the paged LM builds its kernels
        first), capturing each bucket's step."""
        return self.scheduler.warm()

    def _deadline(self, deadline_s):
        return None if deadline_s is None else \
            self.scheduler.clock() + float(deadline_s)

    def submit(self, features, deadline_s=None, extra_steps=0, wait=True,
               timeout=None):
        """Queue one sequence of per-step features [T, F] on the
        carry-slot scheduler (:generate with a "steps" body). deadline_s
        bounds the whole request, checked per step."""
        if self.paged:
            raise ValueError(
                f"model {self.name!r} is a paged token model: a "
                "\"steps\" body is for recurrent models; send a token "
                "prompt (\"tokens\")")
        features = fault_point("host.submit_sequence", features)
        return self.scheduler.submit(
            features, deadline=self._deadline(deadline_s),
            extra_steps=extra_steps, wait=wait,
            timeout=deadline_s if timeout is None else timeout)

    def submit_tokens(self, tokens, deadline_s=None, max_new_tokens=1,
                      wait=True, timeout=None):
        """Queue one token prompt on the paged scheduler (:generate with
        a "tokens" body). Same deadline contract as submit()."""
        if not self.paged:
            raise ValueError(
                f"model {self.name!r} serves per-step features, not "
                "token prompts: send \"steps\"")
        tokens = fault_point("host.submit_sequence", tokens)
        return self.scheduler.submit(
            tokens, deadline=self._deadline(deadline_s),
            max_new_tokens=max_new_tokens, wait=wait,
            timeout=deadline_s if timeout is None else timeout)

    def policy(self):
        """The policy row the model table reports."""
        pol = {
            "model": self.name,
            "version": self.version,
            "kind": "sequence",
            "dtype": _dtype_name(self.network._compute_dtype),
            "device": str(self.network.device),
            "slotBuckets": list(self.scheduler.slot_buckets),
            "queueLimit": self.scheduler.queue_limit,
        }
        if self.paged:
            cache = self.scheduler.cache
            pol.update({
                "paged": True,
                "vocab": self.scheduler.vocab,
                "maxContext": self.network.max_context,
                "pageSize": cache.page_size,
                "numPages": cache.num_pages,
                "prefixSharing": self.scheduler.prefix_sharing,
            })
        else:
            pol["featureSize"] = self.scheduler.feature_size
        return pol

    def close(self, drain=True):
        self.scheduler.close(drain=drain)
        return self


class ModelHost:
    """name -> ServedModel and name -> ServedSequenceModel routing tables
    (module docstring): one host is one serving process's worth of
    models; serving/fleet.py stacks N hosts behind a router."""

    def __init__(self, clock=None):
        self._clock = clock
        self._models = {}
        self._sequences = {}        # name -> ServedSequenceModel
        self._registering = set()   # names reserved mid-register
        self._lock = threading.Lock()
        # what this host's warms have run: a swap to a network of the
        # same shape reports its buckets "warm"
        self._signatures = WarmSignatures()

    def _reserve(self, name, roll):
        with self._lock:
            if name in self._models or name in self._sequences \
                    or name in self._registering:
                raise ValueError(
                    f"model {name!r} is already registered — use "
                    f"{roll}() to roll a new version")
            # reserved so a concurrent register of the same name raises
            # instead of silently overwriting the loser
            self._registering.add(name)

    # -- one-shot models --------------------------------------------------
    def register(self, name, network, *, batchBuckets=None, int8=False,
                 queueLimit=64, maxWaitMs=2.0, precompile=True):
        """Serve `network` as `name` (version 1). precompile=True warms
        every bucket before the model is routable."""
        self._reserve(name, "swap")
        try:
            sm = ServedModel(name, 1, network, batchBuckets=batchBuckets,
                             int8=int8, queueLimit=queueLimit,
                             maxWaitMs=maxWaitMs, clock=self._clock,
                             warmSignatures=self._signatures)
            try:
                report = sm.warm() if precompile else None
            except Exception:
                sm.close(drain=False)
                raise
            with self._lock:
                self._models[name] = sm
        finally:
            with self._lock:
                self._registering.discard(name)
        return {"model": name, "version": sm.version, "warm": report}

    def swap(self, name, network, **overrides):
        """Rolling swap to a new version of `name`: (1) build the
        replacement with the current policy (any knob overridable by
        keyword), (2) WARM its buckets while the current version keeps
        serving, (3) install it atomically, (4) drain the old version:
        requests already queued complete on the version they were
        enqueued against."""
        with self._lock:
            old = self._models.get(name)
            if old is None:
                raise KeyError(
                    f"unknown model {name!r}: register() it first "
                    f"(registered: {sorted(self._models)})")
        pol = old.policy()
        kw = {"batchBuckets": tuple(pol["batchBuckets"]) or None,
              "int8": pol["int8"], "queueLimit": pol["queueLimit"],
              "maxWaitMs": pol["maxWaitMs"]}
        kw.update(overrides)
        new = ServedModel(name, old.version + 1, network, clock=self._clock,
                          warmSignatures=self._signatures, **kw)
        t0 = time.perf_counter()
        try:
            report = new.warm()       # old version is still serving
        except Exception:
            new.close(drain=False)    # old version stays routed
            raise
        warm_s = time.perf_counter() - t0
        with self._lock:
            self._models[name] = new  # atomic routing flip
        old.close(drain=True)         # queued requests finish on OLD
        return {"model": name, "version": new.version,
                "warm": report, "warm_s": round(warm_s, 3)}

    def model(self, name):
        with self._lock:
            sm = self._models.get(name)
        if sm is None:
            raise KeyError(
                f"unknown model {name!r} (registered: "
                f"{sorted(self.names())})")
        return sm

    def submit(self, name, features, deadline_s=None, wait=True):
        """Route one request to `name`'s live version. Once enqueued, a
        request completes on that version even if a swap lands
        mid-flight; one that loses the resolve/enqueue race against a
        swap is re-routed to the new version. wait=False returns the
        InferenceRequest at enqueue."""
        feats = np.asarray(features)
        return self._routed(self.model, name, lambda sm: sm.submit(
            feats, deadline_s=deadline_s, wait=wait))

    # -- sequence models --------------------------------------------------
    def register_sequence(self, name, network, *, slotBuckets=None,
                          queueLimit=64, feedback=None, precompile=True,
                          numPages=64, sampler=None, samplerSeed=0,
                          prefixSharing=True):
        """Serve `network` as the sequence model `name` (version 1): a
        paged LM behind the KV-slot scheduler (numPages, sampler,
        samplerSeed and prefixSharing apply there), a recurrent network
        behind the carry-slot one (feedback applies there).
        precompile=True warms every slot bucket before the model is
        routable; the warm captures each bucket's step as a CUDA graph
        that serving then replays."""
        self._reserve(name, "swap_sequence")
        try:
            sm = ServedSequenceModel(name, 1, network,
                                     slotBuckets=slotBuckets,
                                     queueLimit=queueLimit,
                                     feedback=feedback,
                                     clock=self._clock, numPages=numPages,
                                     sampler=sampler,
                                     samplerSeed=samplerSeed,
                                     prefixSharing=prefixSharing)
            try:
                report = sm.warm() if precompile else None
            except Exception:
                # the scheduler thread and its telemetry series already
                # exist: a failed warm must not leak either
                sm.close(drain=False)
                raise
            with self._lock:
                self._sequences[name] = sm
        finally:
            with self._lock:
                self._registering.discard(name)
        return {"model": name, "version": sm.version, "warm": report}
    def swap_sequence(self, name, network, **overrides):
        """Rolling swap: build + WARM the new version while the current
        one keeps stepping (its warm captures its own graphs, counted in
        ``dl4j_capture_total``), flip atomically, drain the old scheduler
        (its graphs go at its close)."""
        with self._lock:
            old = self._sequences.get(name)
            if old is None:
                raise KeyError(
                    f"unknown sequence model {name!r}: "
                    "register_sequence() it first (registered: "
                    f"{sorted(self._sequences)})")
        pol = old.policy()
        kw = {"slotBuckets": tuple(pol["slotBuckets"]) or None,
              "queueLimit": pol["queueLimit"]}
        if old.paged:
            kw.update({"numPages": pol["numPages"],
                       "sampler": old.scheduler.sampler,
                       "samplerSeed": old.scheduler.sampler_seed,
                       "prefixSharing": pol["prefixSharing"]})
        else:
            kw["feedback"] = old.scheduler.feedback
        kw.update(overrides)
        new = ServedSequenceModel(name, old.version + 1, network,
                                  clock=self._clock, **kw)
        t0 = time.perf_counter()
        try:
            report = new.warm()       # old version keeps stepping
        except Exception:
            new.close(drain=False)    # old version stays routed
            raise
        warm_s = time.perf_counter() - t0
        with self._lock:
            self._sequences[name] = new   # atomic routing flip
        old.close(drain=True)
        return {"model": name, "version": new.version,
                "warm": report, "warm_s": round(warm_s, 3)}

    def sequence_model(self, name):
        with self._lock:
            sm = self._sequences.get(name)
            registered = sorted(self._sequences)
        if sm is None:
            raise KeyError(
                f"unknown sequence model {name!r} (registered: "
                f"{registered})")
        return sm

    def submit_sequence(self, name, features, deadline_s=None,
                        extra_steps=0, wait=True, timeout=None):
        """Route one sequence ([T, F] per-step features) to `name`'s
        carry-slot scheduler (:generate with a "steps" body). A request
        that loses the resolve/enqueue race against a swap_sequence is
        re-routed to the new version."""
        feats = np.asarray(features)
        return self._routed(
            self.sequence_model, name, lambda sm: sm.submit(
                feats, deadline_s=deadline_s, extra_steps=extra_steps,
                wait=wait, timeout=timeout))

    def generate(self, name, tokens, deadline_s=None, max_new_tokens=1,
                 wait=True, timeout=None):
        """Route one token prompt to `name`'s paged scheduler (:generate
        with a "tokens" body). A request that loses the resolve/enqueue
        race against a swap_sequence is re-routed to the new version."""
        toks = np.asarray(tokens)
        return self._routed(
            self.sequence_model, name, lambda sm: sm.submit_tokens(
                toks, deadline_s=deadline_s,
                max_new_tokens=max_new_tokens, wait=wait,
                timeout=timeout))

    @staticmethod
    def _routed(resolve, name, submit):
        """``submit(resolve(name))`` on the live version, once more on
        the new version when it lost the race against a swap."""
        try:
            return submit(resolve(name))
        except ServingClosedError:
            return submit(resolve(name))

    def queued_work(self, name):
        """Outstanding work this host holds for `name`: one-shot
        requests queued OR inside a running dispatch (a wedged batch
        reads as load), or queue depth + live slots for a sequence
        model; None when `name` is not served here. The fleet's
        least-loaded ranking key (a point-in-time read)."""
        with self._lock:
            sm = self._models.get(name)
            seq = self._sequences.get(name)
        if sm is not None:
            # an idle model (no batcher yet) reports 0
            b = sm.pi._batcher
            return 0 if b is None else b.outstanding
        if seq is not None:
            return seq.scheduler.depth + seq.scheduler.active_slots
        return None

    def kind(self, name):
        """'oneshot' | 'sequence' | None when `name` is not served here
        (the fleet's swap_all dispatch key)."""
        with self._lock:
            if name in self._models:
                return "oneshot"
            if name in self._sequences:
                return "sequence"
        return None

    # -- introspection / lifecycle --------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._models) + sorted(self._sequences)

    def __contains__(self, name):
        with self._lock:
            return name in self._models or name in self._sequences

    def describe(self):
        """The model policy table (``GET /v1/models``); sequence models
        ride along with ``"kind": "sequence"`` rows."""
        with self._lock:
            models = list(self._models.values())
            seqs = list(self._sequences.values())
        table = {sm.name: sm.policy() for sm in models}
        table.update({sm.name: sm.policy() for sm in seqs})
        return table

    def metrics_snapshot(self):
        """The registry's snapshot plus a per-model serving view: queue
        stats, depth and occupancy for each one-shot model, and depth,
        live slots and slot occupancy for each sequence model (the
        per-replica row serving/fleet.py aggregates)."""
        with self._lock:
            models = list(self._models.values())
            seqs = list(self._sequences.values())
        per_model = {}
        for sm in models:
            # a snapshot is a read: never build the lazy batcher
            b = sm.pi._batcher
            if b is None:
                per_model[sm.name] = {
                    "version": sm.version, "stats": None, "queue_depth": 0,
                    "occupancy": {"dispatches": 0, "mean_occupancy": None,
                                  "histogram": {}}}
                continue
            per_model[sm.name] = {"version": sm.version,
                                  "stats": dict(b.stats),
                                  "queue_depth": b.depth,
                                  "occupancy": b.occupancy_summary()}
        per_seq = {}
        for sm in seqs:
            sched = sm.scheduler
            per_seq[sm.name] = {"version": sm.version,
                                "stats": dict(sched.stats),
                                "queue_depth": sched.depth,
                                "active_slots": sched.active_slots,
                                "slot_occupancy": sched.occupancy_summary()}
        return {"registry": telemetry.get_registry().snapshot(),
                "models": per_model, "sequences": per_seq}

    def warm_all(self):
        """(Re)warm every registered model, one-shot and sequence: the
        HTTP tier's /healthz warmup hook."""
        with self._lock:
            models = list(self._models.values())
            seqs = list(self._sequences.values())
        out = {sm.name: sm.warm() for sm in models}
        out.update({sm.name: sm.warm() for sm in seqs})
        return out

    def close(self, drain=True):
        with self._lock:
            models = list(self._models.values())
            seqs = list(self._sequences.values())
            self._models.clear()
            self._sequences.clear()
        for sm in models + seqs:
            sm.close(drain=drain)
