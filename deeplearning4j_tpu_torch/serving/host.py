"""Multi-model host: name -> served sequence model, with rolling swap.

The counterpart of the sequence half of ``deeplearning4j_tpu/serving/
host.py``. A registered sequence model is a ``ServedSequenceModel``: the
network plus its scheduler, the KV-slot ``PagedSequenceScheduler`` for a
paged LM (``kind == "paged_lm"``: token prompts in, sampled tokens out)
or the carry-slot ``SequenceScheduler`` for a recurrent
``MultiLayerNetwork`` (per-step features in, per-step outputs out).
Registration warms it (one step per slot bucket; the paged LM also
builds its kernels and runs a prefill chunk) before the name is
routable, so the first request is served hot.

Rolling swap (``swap_sequence``): the replacement is built and warmed
while the current version keeps serving; the routing entry flips
atomically under the host lock, and the old version drains what it had
already admitted or queued.

One-shot models (``register``/``swap``, the micro-batched ``:predict``
path) are not ported yet.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.runtime.chaos import fault_point
from deeplearning4j_tpu_torch.serving.queue import ServingClosedError
from deeplearning4j_tpu_torch.serving.sequence import (
    PagedSequenceScheduler, SequenceScheduler,
)

__all__ = ["ServedSequenceModel", "ModelHost"]


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
        first)."""
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
            "dtype": str(self.network._compute_dtype).replace("torch.",
                                                              ""),
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
    """name -> ServedSequenceModel routing table (module docstring)."""

    def __init__(self, clock=None):
        self._clock = clock
        self._sequences = {}        # name -> ServedSequenceModel
        self._registering = set()   # names reserved mid-register
        self._lock = threading.Lock()

    # -- one-shot models: a later slice ----------------------------------
    def register(self, name, network, **kwargs):
        raise NotImplementedError(
            "one-shot model serving (register/:predict) comes with the "
            "one-shot serving slice; register_sequence() serves paged LMs "
            "and recurrent networks")

    def swap(self, name, network, **overrides):
        raise NotImplementedError(
            "one-shot model serving (swap/:predict) comes with the "
            "one-shot serving slice; use swap_sequence()")

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
        routable."""
        with self._lock:
            if name in self._sequences or name in self._registering:
                raise ValueError(
                    f"model {name!r} is already registered — use "
                    "swap_sequence() to roll a new version")
            self._registering.add(name)
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
        one keeps stepping, flip atomically, drain the old scheduler."""
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
        return self._routed(name, lambda sm: sm.submit(
            feats, deadline_s=deadline_s, extra_steps=extra_steps,
            wait=wait, timeout=timeout))

    def generate(self, name, tokens, deadline_s=None, max_new_tokens=1,
                 wait=True, timeout=None):
        """Route one token prompt to `name`'s paged scheduler (:generate
        with a "tokens" body). A request that loses the resolve/enqueue
        race against a swap_sequence is re-routed to the new version."""
        toks = np.asarray(tokens)
        return self._routed(name, lambda sm: sm.submit_tokens(
            toks, deadline_s=deadline_s, max_new_tokens=max_new_tokens,
            wait=wait, timeout=timeout))

    def _routed(self, name, submit):
        """``submit(model)`` on `name`'s live version, once more on the
        new version when it lost the race against a swap_sequence."""
        try:
            return submit(self.sequence_model(name))
        except ServingClosedError:
            return submit(self.sequence_model(name))

    def queued_work(self, name):
        """Queue depth + live slots for `name`, or None when it is not
        served here (a point-in-time read)."""
        with self._lock:
            seq = self._sequences.get(name)
        if seq is None:
            return None
        return seq.scheduler.depth + seq.scheduler.active_slots

    # -- introspection / lifecycle --------------------------------------
    def describe(self):
        """The model policy table (``GET /v1/models``)."""
        with self._lock:
            seqs = list(self._sequences.values())
        return {sm.name: sm.policy() for sm in seqs}

    def warm_all(self):
        """(Re)warm every registered model — the HTTP tier's /healthz
        warmup hook; cheap once the kernels are built."""
        with self._lock:
            seqs = list(self._sequences.values())
        return {sm.name: sm.warm() for sm in seqs}

    def close(self, drain=True):
        with self._lock:
            seqs = list(self._sequences.values())
            self._sequences.clear()
        for sm in seqs:
            sm.close(drain=drain)
