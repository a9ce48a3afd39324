"""The autotune arbiter over the port's lowering knobs (reference:
``deeplearning4j_tpu/runtime/autotune.py``).

The knobs are the reference's, with its names and candidates: the max
pool backward (``ops.pooling``), the global max pool backward, the BN
epilogue and tail (``ops.norm``), the flash-attention backward
(``ops.flash_attention``) and the loss tail (``nn.losses``). Each default
was chosen once; the right value depends on the card, the shapes and the
library versions, so ``autotune(net, x_shape)`` measures:

* **sweep** — coordinate descent over the registry. A candidate whose
  train step dispatches the same sequence of aten ops as the incumbent's
  (a dispatch-mode trace of one step: op, shapes, dtypes) cannot differ
  in time or result and is skipped as "identical" (``flash_bwd`` on a
  CNN, ``bn_tail`` on an f32 net): the reference skips a byte-identical
  HLO the same way.
* **prove** — ``steps`` training steps from the same state reproduce the
  incumbent's losses: bitwise for the knobs that only swap an
  implementation (``parity_rtol`` 0), within ``parity_rtol`` for the
  others. A candidate that fails is never scored.
* **score** — on the card, the median wall of the CAPTURED step over
  CUDA events (``runtime.aot``), with the step's ``compiled_cost`` bytes
  (``util.profiler``) as the tiebreak; on the CPU the bytes alone, as
  the reference scores on its host backend (a `timer` may be injected).
  A candidate must win by ``min_gain`` (0.5 %).
* **persist** — the winners go to ``<key>.tune.json`` under
  ``DL4J_TPU_AUTOTUNE_CACHE`` (or the store's directory), keyed like the
  capture records without the knob values (they are the output). A
  later ``autotune``/``warm_start`` of the same network on the same card
  applies them with no sweep.

The sweep leaves the process's knobs and the network's state as it found
them: ``install(result.knobs)`` or ``warm_start`` adopts the winners.
Knobs are module globals, process-wide: in a process with several
networks the last install governs every later step (the reference's
rule).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import tempfile

import numpy as np
import torch

__all__ = [
    "KNOBS", "Knob", "current_knobs", "applied", "install",
    "tuning_key", "TuningStore", "enable", "disable", "store",
    "autotune", "autotune_subject", "warm_start", "AutotuneResult",
]

#: bump when the knob inventory or record layout changes
TUNE_FORMAT = 1

#: a directory for the tuning records
TUNE_DIR_ENV = "DL4J_TPU_AUTOTUNE_CACHE"


class Knob:
    """One tunable toggle: where it lives, its candidates, its setter and
    how strictly a candidate must reproduce the incumbent's losses."""

    def __init__(self, name, module, attr, candidates, setter=None,
                 parity_rtol=0.0, doc=""):
        self.name = name
        self._module = module
        self._attr = attr
        self.candidates = tuple(candidates)
        self._setter = setter
        self.parity_rtol = float(parity_rtol)
        self.doc = doc

    def _mod(self):
        return importlib.import_module(self._module)

    def get(self):
        return getattr(self._mod(), self._attr)

    def set(self, value):
        """Set the knob; returns the previous value."""
        if value not in self.candidates:
            raise ValueError(
                f"knob {self.name}: {value!r} not in {self.candidates}")
        mod = self._mod()
        if self._setter is not None:
            return getattr(mod, self._setter)(value)
        old = getattr(mod, self._attr)
        setattr(mod, self._attr, value)
        return old


_P = "deeplearning4j_tpu_torch."

#: the registry in sweep order; exactly the knobs of the capture key
#: (``aot.ambient_fingerprint``)
KNOBS = (
    Knob("maxpool_bwd", _P + "ops.pooling", "_BACKWARD_IMPL",
         ("stock", "indices", "argmax"), setter="set_maxpool_bwd",
         doc="max_pool2d gradient: F.max_pool2d's / saved int8 winner, "
             "one elementwise pass (non-overlapping windows) / winner "
             "recomputed from x"),
    Knob("global_maxpool_bwd", _P + "ops.pooling", "_GLOBAL_MAXPOOL_BWD",
         ("stock", "indices"), setter="set_global_maxpool_bwd",
         doc="global max-pool gradient: amax's / saved argmax"),
    Knob("bn_epilogue", _P + "ops.norm", "_EPILOGUE", ("fused", "unfused"),
         setter="set_bn_epilogue", parity_rtol=1e-4,
         doc="BN -> activation (-> add): one autograd Function / the plain "
             "composition"),
    Knob("flash_bwd", _P + "ops.flash_attention", "_BWD_IMPL",
         ("kernel", "recompute"), setter="set_flash_bwd", parity_rtol=1e-3,
         doc="flash-attention backward: K2/K3 from the saved lse / autograd "
             "through the blockwise scan"),
    Knob("bn_tail", _P + "ops.norm", "_TAIL_MODE", ("compute", "wide"),
         parity_rtol=0.05,
         doc="BN math dtype under a bf16/fp16 compute dtype"),
    Knob("loss_tail", _P + "nn.losses", "_TAIL_MODE", ("compute", "wide"),
         parity_rtol=0.05, doc="loss-tail math dtype"),
)

_KNOBS_BY_NAME = {k.name: k for k in KNOBS}


def current_knobs():
    """{name: live value} of every knob."""
    return {k.name: k.get() for k in KNOBS}


class applied:
    """Set the given {name: value} knobs; restore them on exit."""

    def __init__(self, knobs):
        self._target = dict(knobs)
        self._old = []

    def __enter__(self):
        for name, value in self._target.items():
            knob = _KNOBS_BY_NAME[name]
            self._old.append((knob, knob.get()))
            knob.set(value)
        return self

    def __exit__(self, *exc):
        for knob, value in reversed(self._old):
            knob.set(value)
        self._old = []
        return False


def install(knobs):
    """Set {name: value} knobs for good; returns {name: previous}."""
    return {name: _KNOBS_BY_NAME[name].set(value)
            for name, value in knobs.items()}


# ----------------------------------------------------------------------
# keys and the store
# ----------------------------------------------------------------------

def _ambient_base():
    """The capture key's ambient fingerprint without the knobs, plus the
    knob inventory (adding a candidate re-tunes)."""
    from deeplearning4j_tpu_torch.runtime import aot

    amb = dict(aot.ambient_fingerprint())
    for k in _KNOBS_BY_NAME:
        amb.pop(k, None)
    amb["tune_format"] = TUNE_FORMAT
    amb["knob_inventory"] = tuple((k.name, k.candidates) for k in KNOBS)
    return amb


def tuning_key(net, extra=""):
    """sha256 over (ambient without knobs, program fingerprint): a
    property of the program on this card, for any batch signature."""
    from deeplearning4j_tpu_torch.runtime import aot

    fp = aot.samediff_fingerprint(net) if hasattr(net, "_ops") \
        else aot.network_fingerprint(net)
    base = repr(sorted(_ambient_base().items()))
    return hashlib.sha256("|".join([base, fp, extra]).encode()).hexdigest()


class TuningStore:
    """{key: record} in memory and, with a directory, one JSON file a key
    written atomically; a stale or corrupt file is a counted miss."""

    def __init__(self, directory=None):
        self.directory = os.path.expanduser(str(directory)) \
            if directory else None
        if self.directory:
            os.makedirs(self.directory, mode=0o700, exist_ok=True)
        self._mem = {}
        self.stats = {"hits": 0, "misses": 0, "puts": 0, "stale": 0,
                      "corrupt": 0, "store_errors": 0}

    def _path(self, key):
        return os.path.join(self.directory, key + ".tune.json")

    def get(self, key):
        rec = self._mem.get(key)
        if rec is not None:
            self.stats["hits"] += 1
            return rec
        if self.directory is None or not os.path.exists(self._path(key)):
            self.stats["misses"] += 1
            return None
        path = self._path(key)
        try:
            with open(path, "r", encoding="utf-8") as fh:  # fault-ok[FLT02]: the tuning store is read once at warm start, off the serving dispatch path; a corrupt record is counted and removed
                rec = json.load(fh)
        except (OSError, ValueError, UnicodeDecodeError):
            self.stats["corrupt"] += 1
            self._remove(path)
            return None
        if not isinstance(rec, dict) \
                or rec.get("tune_format") != TUNE_FORMAT:
            self.stats["stale"] += 1
            self._remove(path)
            return None
        self.stats["hits"] += 1
        self._mem[key] = rec
        return rec

    def put(self, key, rec):
        rec = dict(rec)
        rec["tune_format"] = TUNE_FORMAT
        self._mem[key] = rec
        self.stats["puts"] += 1
        if self.directory is None:
            return
        try:
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:  # fault-ok[FLT02]: the tuning store is written at the end of a sweep, off the serving dispatch path; a failed write is counted (store_errors)
                    json.dump(rec, fh, indent=1)
                os.replace(tmp, self._path(key))
            except BaseException:
                self._remove(tmp)
                raise
        except OSError:
            self.stats["store_errors"] += 1

    @staticmethod
    def _remove(path):
        try:
            os.remove(path)
        except OSError:
            pass

    def clear_memory(self):
        self._mem.clear()


_STORE = None


def enable(directory=None):
    """The process-wide store (directory None: ``DL4J_TPU_AUTOTUNE_CACHE``,
    else memory only)."""
    global _STORE
    directory = directory or os.environ.get(TUNE_DIR_ENV) or None
    norm = os.path.expanduser(str(directory)) if directory else None
    if _STORE is not None and _STORE.directory == norm:
        return _STORE
    _STORE = TuningStore(directory)
    return _STORE


def disable():
    global _STORE
    _STORE = None


def store():
    """The active store, enabled on first use."""
    if _STORE is None:
        enable()
    return _STORE


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

class AutotuneResult:
    """What ``autotune`` found or recalled: ``knobs`` the winners,
    ``swept`` whether this call swept, ``per_knob`` each candidate's
    verdict, bytes and wall."""

    def __init__(self, key, knobs, swept, baseline_bytes=None,
                 tuned_bytes=None, per_knob=None, wall=None):
        self.key = key
        self.knobs = dict(knobs)
        self.swept = swept
        self.baseline_bytes = baseline_bytes
        self.tuned_bytes = tuned_bytes
        self.per_knob = list(per_knob or [])
        self.wall = wall

    @property
    def changed(self):
        """Knobs the sweep moved off their values before it."""
        return {k: v for k, v in self.knobs.items()
                if self.per_knob and v != next(
                    (p["from"] for p in self.per_knob
                     if p["knob"] == k), v)}

    def to_record(self):
        return {"knobs": self.knobs, "baseline_bytes": self.baseline_bytes,
                "tuned_bytes": self.tuned_bytes, "per_knob": self.per_knob,
                "wall": self.wall}

    @classmethod
    def from_record(cls, key, rec):
        return cls(key, rec["knobs"], swept=False,
                   baseline_bytes=rec.get("baseline_bytes"),
                   tuned_bytes=rec.get("tuned_bytes"),
                   per_knob=rec.get("per_knob"), wall=rec.get("wall"))

    def format(self):
        lines = [f"key {self.key[:16]}  "
                 f"({'swept' if self.swept else 'recalled'})"]
        for p in self.per_knob:
            lines.append(
                f"  {p['knob']:<20} {p['from']:>9} -> {p['to']:<9} "
                f"{p['verdict']:<12}"
                + (f" {p['bytes']:>14,} B" if p.get("bytes") else "")
                + (f" {p['wall_s'] * 1e3:9.3f} ms"
                   if p.get("wall_s") else ""))
        return "\n".join(lines)


def _step_args(net, x_shape, seed=0):
    """Random features and one-hot labels of one batch in the form the
    net's ``_train_step`` takes (random: all-ones would give BN a
    zero-variance batch)."""
    from deeplearning4j_tpu_torch.nn.multilayer import example_batch

    if hasattr(net, "layers"):
        _, y0 = example_batch(net, x_shape[0], tuple(x_shape))
    else:
        _, ys = net._example_shapes(x_shape[0], tuple(x_shape))
        y0 = np.zeros(ys, np.float32)
    rng = np.random.RandomState(seed)
    x = rng.rand(*x_shape).astype("float32")
    y = np.zeros_like(y0)
    if y.ndim == 2:
        y[np.arange(y.shape[0]), rng.randint(0, y.shape[1], y.shape[0])] = 1
    else:
        y[...] = rng.rand(*y.shape)
    x = torch.from_numpy(x).to(net.device)
    y = torch.from_numpy(y).to(net.device)
    if hasattr(net, "layers"):
        return (x, y, None, None)
    return ({net.conf.networkInputs[0]: x}, [y], None, None)


def _op_trace(net, args):
    """The aten ops one train step dispatches (op, shapes, dtypes), as a
    digest; the network's state is put back."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    h = hashlib.sha256()

    class _Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            leaves, _ = tree_flatten((a, kw))
            h.update(repr((str(func), [
                (tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
                else t for t in leaves
                if isinstance(t, (torch.Tensor, int, float, bool, str))
            ])).encode())
            return func(*a, **(kw or {}))

    snap = net._snapshot()
    try:
        with _Trace():
            net._train_step(*args, iteration=0)
    finally:
        net._restore(snap)
    return h.hexdigest()


def _run_steps(net, args, steps):
    """`steps` eager training steps from the current state; the losses
    (host floats). The network's state is put back."""
    snap = net._snapshot()
    try:
        return [float(net._train_step(*args, iteration=i))
                for i in range(steps)]
    finally:
        net._restore(snap)


def _step_bytes(net, args):
    """``compiled_cost`` bytes of one train step (state put back)."""
    from deeplearning4j_tpu_torch.util.profiler import compiled_cost

    snap = net._snapshot()
    try:
        return int(compiled_cost(
            lambda: net._train_step(*args, iteration=0))["bytes_accessed"])
    finally:
        net._restore(snap)


def captured_step_seconds(net, args, reps=10):
    """The median wall of the captured train step over CUDA events
    (`reps` replays after two), the network's state put back and the
    graph dropped."""
    snap = net._snapshot()
    cap = net._train_capture()
    try:
        cap.capture(args, iteration=0)
        for i in range(2):
            cap(*args, iteration=i)
        times = []
        for i in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            cap(*args, iteration=i)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        return float(np.median(times))
    finally:
        cap.drop(args)
        net._restore(snap)


def _parity_ok(base_losses, cand_losses, rtol):
    if any(not np.isfinite(v) for v in cand_losses):
        return False
    a, b = np.asarray(base_losses), np.asarray(cand_losses)
    if rtol <= 0.0:
        return bool(np.array_equal(a, b))
    return bool(np.allclose(a, b, rtol=rtol, atol=rtol * 1e-2))


def autotune(net, x_shape, *, knobs=None, store_=None, steps=3,
             force=False, min_gain=0.005, seed=0, timer=None):
    """Tune the knobs for `net`'s train step at batch shape `x_shape`
    (module docstring). A stored record (unless `force`) is returned with
    no sweep. `knobs`: a subset of the registry's names. `timer(net,
    args) -> seconds` replaces the score's wall (default: the captured
    step's CUDA-event median on the card, none on the CPU)."""
    st = store_ if store_ is not None else store()
    key = tuning_key(net)
    if not force:
        rec = st.get(key)
        if rec is not None:
            return AutotuneResult.from_record(key, rec)
    names = list(knobs) if knobs else [k.name for k in KNOBS]
    for n in names:
        if n not in _KNOBS_BY_NAME:
            raise ValueError(f"unknown knob {n!r}; registry: "
                             f"{sorted(_KNOBS_BY_NAME)}")
    if timer is None and net.device.type == "cuda":
        timer = captured_step_seconds
    args = _step_args(net, x_shape, seed)
    # the captured step's binding from the start: once a graph holds
    # the net, a step writes its layer state in place, and every trace
    # must see the same ops
    net._graphs_hold = True
    best = current_knobs()
    with applied(best):
        _op_trace(net, args)     # first-call work (workspaces) off the trace
        best_trace = _op_trace(net, args)
        base_losses = _run_steps(net, args, steps)
        baseline_bytes = best_bytes = _step_bytes(net, args)
        base_wall = best_wall = timer(net, args) if timer else None
    per_knob = []
    for name in names:
        knob = _KNOBS_BY_NAME[name]
        for cand in knob.candidates:
            if cand == best[name]:
                continue
            entry = {"knob": name, "from": best[name], "to": cand}
            with applied({**best, name: cand}):  # purity-ok[RTC01]: the sweep itself: each candidate is captured and scored once, by design
                trace = _op_trace(net, args)
                if trace == best_trace:
                    entry["verdict"] = "identical"
                    per_knob.append(entry)
                    continue
                losses = _run_steps(net, args, steps)
                nbytes = _step_bytes(net, args)
                wall = timer(net, args) if timer else None
            entry["bytes"] = nbytes
            entry["wall_s"] = wall
            if not _parity_ok(base_losses, losses, knob.parity_rtol):
                entry["verdict"] = "parity-fail"
                per_knob.append(entry)
                continue
            if timer:
                wins = wall < best_wall * (1.0 - min_gain) or (
                    wall <= best_wall
                    and nbytes < best_bytes * (1.0 - min_gain))
            else:
                wins = nbytes < best_bytes * (1.0 - min_gain)
            if wins:
                entry["verdict"] = "adopted"
                best = {**best, name: cand}
                best_bytes, best_wall, best_trace = nbytes, wall, trace
                # later knobs must match the adopted trajectory
                base_losses = losses
            else:
                entry["verdict"] = "no-gain"
            per_knob.append(entry)
    result = AutotuneResult(
        key, best, swept=True, baseline_bytes=baseline_bytes,
        tuned_bytes=best_bytes, per_knob=per_knob,
        wall={"baseline_s": base_wall, "tuned_s": best_wall,
              "scored_by": "wall+bytes" if timer else "bytes"})
    st.put(key, result.to_record())
    return result


def autotune_subject(subject, batch_size=None, device=None, **kw):
    """``autotune`` over one of ``analysis.hbm.SUBJECTS`` (lenet at 64,
    resnet_block at 32 by default)."""
    from deeplearning4j_tpu_torch.analysis.hbm import build_subject

    if batch_size is None:
        batch_size = {"lenet": 64, "resnet_block": 32}.get(subject, 32)
    net, x_shape, _slots = build_subject(subject, batch_size=batch_size,
                                         device=device)
    return autotune(net, x_shape, **kw)


def warm_start(net, store_=None):
    """Install the persisted winners of (card, net); the installed
    {name: value}, or None when there is no record. No sweep."""
    st = store_ if store_ is not None else store()
    rec = st.get(tuning_key(net))
    if rec is None:
        return None
    install(rec["knobs"])
    return dict(rec["knobs"])
