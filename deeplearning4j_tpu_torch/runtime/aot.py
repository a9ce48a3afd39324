"""Captured steps and their warm-start records (reference:
``deeplearning4j_tpu/runtime/aot.py``).

The reference compiles each step once per signature and keeps the XLA
executables in a two-level cache. The port runs eagerly, so its cost
before the first batch is not a compile but the host's issue of every
kernel, every step. What takes the executable's place is a CUDA graph:
the step captured once per signature into static input and output
buffers, then replayed, one launch for the whole step.

* ``CapturedStep`` (``cached_jit`` builds one) owns a step function and
  one ``GraphEntry`` per signature. ``capture`` warms the step up on a
  side stream (cuDNN and cuBLAS choose their plans, the allocator
  settles; a ``snapshot``/``restore`` pair puts back what the warm-up
  changed), then captures it; ``__call__`` copies the inputs into the
  static buffers, runs the entry's ``prologue`` (the iteration's
  hyperparameters into their device buffer, the draw sites' seeds) and
  replays. A call at a signature that was never captured runs the step
  eagerly and is COUNTED (``uncaptured``), never hidden; so is a call
  after the owner rebound its parameters (``invalidate`` drops the
  graphs; the owner's ``_bind_version`` tells). A capture that fails on
  the card raises with CUDA's error. On the CPU there is no graph: an
  entry runs the same step eagerly, under ``HostReadGuard``, which
  refuses any read of a tensor on the host inside the step.
* ``ExecutableCache`` keeps the reference's two levels. The memory level
  holds the live captured entries, weakly (a graph is bound to its
  owner's tensors, so it is kept per owner, lives as long as its owner's
  ``CapturedStep`` and is never shared between two networks; equal keys
  still report "warm"). The disk level holds a warm-start RECORD
  per key, ``<key>.capture.json``: the signature to capture, the knob
  values in force, the bucket set and the capture seconds. A CUDA graph
  cannot be serialised: a second process reads the records at
  ``precompile`` and captures exactly those signatures before its first
  batch. A record whose format or ambient fingerprint differs is stale,
  one that does not parse is corrupt: both are removed and counted as a
  miss, never a crash.
* ``CompileWatch`` proves a region captured nothing and dispatched
  nothing uncaptured.
* Launch counts: a kernel wrapper counts its launches where it makes
  them (``ops._kernels.count_launch``). Inside a capture nothing runs:
  the launches on the capturing stream (the backward's too, made on
  autograd's thread) go to the capture's tally, which the entry keeps,
  and every replay adds them to the counts. Launches on other streams
  meanwhile are counted as they run.
* Shape buckets (``bucket_batch``, ``pad_batch``, ``sentinel_budget``,
  ``DEFAULT_BATCH_BUCKETS``): a serving tier captures one graph per
  bucket, never one per request size.

Fingerprints name torch, CUDA and the card where the reference names
jax, and carry every knob of the autotune arbiter (``runtime.autotune``),
so a tuned and a stock run never share a key.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.chaos import fault_point

__all__ = [
    "ExecutableCache", "CapturedStep", "CachedJit", "GraphEntry",
    "cached_jit",
    "enable", "disable", "session_cache", "ambient_fingerprint",
    "network_fingerprint", "samediff_fingerprint", "abstract_signature",
    "cache_key", "bucket_batch", "pad_batch", "sentinel_budget",
    "DEFAULT_BATCH_BUCKETS", "CompileWatch", "CaptureRefused",
    "HostReadGuard", "HostReadError", "capture_supported",
]

#: bump when the record layout changes: old records become stale
CACHE_FORMAT = 1

#: a directory for the disk level; unset: the session cache is memory-only
CACHE_DIR_ENV = "DL4J_TPU_AOT_CACHE"

#: DL4J_TPU_AOT=off vetoes the session cache: a step keeps its graphs in
#: a cache of its own, in memory, and reads and writes no record
AOT_ENV = "DL4J_TPU_AOT"


class CaptureRefused(RuntimeError):
    """A step that cannot be captured whole, with the reason."""


class HostReadError(RuntimeError):
    """A captured region read a tensor on the host."""


def _package_version():
    from deeplearning4j_tpu_torch import __version__

    return __version__


_TM = None


def _tm():
    """The capture instruments on the port's registry, resolved once."""
    global _TM
    if _TM is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        _TM = {
            "reg": reg,
            "captures": reg.counter(
                "dl4j_capture_total", "CUDA-graph captures paid",
                labels=("entry",)),
            "uncaptured": reg.counter(
                "dl4j_capture_uncaptured_total",
                "steps run eagerly at a signature with no live graph",
                labels=("entry", "reason")),
            "replays": reg.counter(
                "dl4j_capture_replays_total", "graph replays",
                labels=("entry",)),
            "seconds": reg.histogram(
                "dl4j_capture_seconds",
                "warm-up plus capture wall of one signature").labels(),
            "records": reg.counter(
                "dl4j_capture_records_total",
                "warm-start records by outcome", labels=("outcome",)),
        }
    return _TM


# ----------------------------------------------------------------------
# fingerprints
# ----------------------------------------------------------------------

def _device_name():
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def ambient_fingerprint():
    """Process-level facts that change the captured program without
    appearing in any argument: versions, the card, and every knob the
    autotune arbiter can flip (so a tuned and a stock step never share
    a key)."""
    from deeplearning4j_tpu_torch.nn import losses as _losses
    from deeplearning4j_tpu_torch.ops import flash_attention as _flash
    from deeplearning4j_tpu_torch.ops import norm as _norm
    from deeplearning4j_tpu_torch.ops import pooling as _pooling

    return {
        "format": CACHE_FORMAT,
        "package": _package_version(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": _device_name(),
        "devices": torch.cuda.device_count() if torch.cuda.is_available()
        else 0,
        "tf32": (bool(torch.backends.cuda.matmul.allow_tf32),
                 bool(torch.backends.cudnn.allow_tf32)),
        "loss_tail": _losses._TAIL_MODE,
        "bn_tail": _norm._TAIL_MODE,
        "bn_epilogue": _norm._EPILOGUE,
        "maxpool_bwd": _pooling._BACKWARD_IMPL,
        "global_maxpool_bwd": _pooling._GLOBAL_MAXPOOL_BWD,
        "flash_bwd": _flash._BWD_IMPL,
        "argmax_bwd_win": _pooling._ARGMAX_BWD_MAX_WINDOW,
    }


_KNOB_MODULES = None


def _knob_state():
    """The knobs' live values as a tuple: part of a graph's identity (a
    graph captured under one knob setting is not replayed under
    another)."""
    global _KNOB_MODULES
    if _KNOB_MODULES is None:
        from deeplearning4j_tpu_torch.nn import losses
        from deeplearning4j_tpu_torch.ops import flash_attention, norm, \
            pooling

        _KNOB_MODULES = (losses, norm, pooling, flash_attention)
    losses, norm, pooling, flash = _KNOB_MODULES
    return (losses._TAIL_MODE, norm._TAIL_MODE, norm._EPILOGUE,
            pooling._BACKWARD_IMPL, pooling._GLOBAL_MAXPOOL_BWD,
            flash._BWD_IMPL)


def _sha(text):
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _conf_identity(conf):
    """The configuration's JSON, and, for a configuration that holds
    arrays (YOLO2's anchor priors), each array's shape, dtype and bytes
    hashed: the reference raises there and runs uncached; the port's
    precompile needs a key."""
    from deeplearning4j_tpu_torch.util import serde

    arrays = []
    text = json.dumps(serde.encode(conf, arrays))
    for a in arrays:
        a = np.ascontiguousarray(a.detach().cpu().numpy()
                                 if isinstance(a, torch.Tensor) else a)
        text += f"|{a.shape}:{a.dtype}:" \
            + hashlib.sha256(a.tobytes()).hexdigest()
    return text


def network_fingerprint(net):
    """Content hash of a MultiLayerNetwork/ComputationGraph's step: its
    configuration (``_conf_identity``: the remat policy and the
    per-layer ``activationCheckpointing`` flag included), the
    weight-update hook (a ZeRO update changes the step and its group is
    not configuration) and the solver choice (reference:
    ``network_fingerprint``)."""
    impl = getattr(net, "_update_impl", None)
    return _sha("|".join([
        type(net).__name__, _conf_identity(net.conf),
        "none" if impl is None else impl.describe(),
        "solver" if getattr(net, "_solver", None) is not None else "sgd",
        str(getattr(net, "device", "")),
    ]))


def samediff_fingerprint(sd):
    """Structural hash of a SameDiff graph and its TrainingConfig: ops,
    variables (name, type, stored array's shape and dtype), losses and
    the training configuration, and a ZeRO weight-update hook
    (reference: ``samediff_fingerprint``)."""
    parts = [f"{o.opName}({','.join(o.inputs)})->"
             f"({','.join(o.outputs)}){sorted(o.kwargs.items())!r}"
             for o in sd._ops]
    for n in sorted(sd._vars):
        v = sd._vars[n]
        a = sd._arrays.get(n)
        parts.append(
            f"{n}:{v.variableType}:"
            f"{None if a is None else (tuple(a.shape), str(a.dtype))}:"
            f"{getattr(v, '_ph_shape', None)}:{getattr(v, '_ph_dtype', None)}")
    parts.append(f"loss={sd._loss_vars}")
    tc = sd._tc
    if tc is not None:
        upd = tc.updater
        desc = repr(sorted(vars(upd).items())) if hasattr(upd, "__dict__") \
            else repr(upd)
        parts.append(f"tc:{type(upd).__name__}:{desc}:{tc.l1}:{tc.l2}:"
                     f"{tc.weightDecay}:{tc.dataSetFeatureMapping}:"
                     f"{tc.dataSetLabelMapping}:{tc.lossVariables}")
    impl = getattr(sd, "_update_impl", None)
    if impl is not None:
        parts.append(impl.describe())
    return _sha("|".join(parts))


def _leaf_sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return (tuple(leaf.shape), str(leaf.dtype), None)
    if leaf is None:
        return None
    return ("py", type(leaf).__name__)


def _flatten(args):
    if isinstance(args, (list, tuple)):
        out = [type(args).__name__, len(args)]
        for a in args:
            out.extend(_flatten(a))
        return out
    if isinstance(args, dict):
        out = ["dict", tuple(sorted(args))]
        for k in sorted(args):
            out.extend(_flatten(args[k]))
        return out
    return [_leaf_sig(args)]


def abstract_signature(args):
    """Hashable signature of a call's arguments: the nesting and each
    leaf's (shape, dtype, device). The same step at the same signature
    captures the same graph."""
    return tuple(_flatten(args))


def _sig_repr(sig):
    return sig if isinstance(sig, str) else repr(sig)


def cache_key(base_fp, entry, sig, ambient=None):
    """The key: sha256 over (ambient fingerprint, program fingerprint,
    entry point, signature)."""
    amb = ambient if ambient is not None else ambient_fingerprint()
    return _sha("|".join([repr(sorted(amb.items())), base_fp, entry,
                          _sig_repr(sig)]))


# ----------------------------------------------------------------------
# launch counts
# ----------------------------------------------------------------------

def _counted_kernels():
    """The kernel wrappers that count their launches."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    return (pa.paged_flash_decode, pa.paged_flash_prefill, fa.flash_fwd,
            fa.flash_bwd_dq, fa.flash_bwd_dkv)


# ----------------------------------------------------------------------
# the host-read detector
# ----------------------------------------------------------------------

class HostReadGuard:
    """A dispatch mode that raises on ``aten._local_scalar_dense`` (a
    tensor's value read by ``item``/``float``/``bool``) and on any copy
    from the card to the host: what a CUDA graph would bake in or refuse.
    The CPU tests run each captured region under it."""

    def __init__(self, what="captured region"):
        self.what = what

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        what = self.what

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.__name__
                if name.startswith("_local_scalar_dense"):
                    raise HostReadError(
                        f"{what}: a tensor's value was read on the host "
                        f"({func})")
                if name.startswith(("_to_copy", "copy_")):
                    src = args[1] if name.startswith("copy_") else args[0]
                    dst = args[0].device if name.startswith("copy_") \
                        else kwargs.get("device")
                    if isinstance(src, torch.Tensor) \
                            and src.device.type == "cuda" \
                            and dst is not None \
                            and torch.device(dst).type == "cpu":
                        raise HostReadError(
                            f"{what}: a device-to-host copy ({func})")
                return func(*args, **kwargs)

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def capture_supported():
    """Whether this torch can register per-step generators with a graph
    (``CUDAGraph.register_generator_state``)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------

class ExecutableCache:
    """Two levels (module docstring): memory holds the captured entries
    per owner, disk the warm-start records. Thread-safe: serving threads
    read it concurrently."""

    def __init__(self, directory=None):
        self.directory = os.path.expanduser(str(directory)) \
            if directory else None
        if self.directory:
            os.makedirs(self.directory, mode=0o700, exist_ok=True)
        self._lock = threading.RLock()
        self._mem = {}
        self.stats = {"mem_hits": 0, "disk_hits": 0, "misses": 0,
                      "captures": 0, "uncaptured": 0, "puts": 0,
                      "stale": 0, "corrupt": 0, "store_errors": 0}
        #: key -> seconds of its warm-up and capture
        self.seconds = {}

    # -- counts --------------------------------------------------------
    def note_capture(self, key, seconds, entry):
        with self._lock:
            self.stats["captures"] += 1
            self.stats["misses"] += 1
            self.seconds[key] = float(seconds)
        tm = _tm()
        tm["captures"].labels(entry=entry).inc()
        tm["seconds"].observe(seconds)

    def note_uncaptured(self, entry, reason):
        with self._lock:
            self.stats["uncaptured"] += 1
        _tm()["uncaptured"].labels(entry=entry, reason=reason).inc()

    # -- the memory level ----------------------------------------------
    def _path(self, key):
        return os.path.join(self.directory, key + ".capture.json")

    def __contains__(self, key):
        with self._lock:
            if any(k[0] == key and r() is not None
                   for k, r in self._mem.items()):
                return True
        return self.directory is not None \
            and os.path.exists(self._path(key))

    def get(self, key, owner=None, ambient=None):
        """The live entry of `owner` at `key` (memory), else the disk
        record (a dict), else None. A stale or corrupt record is removed
        and counted."""
        with self._lock:
            ref = self._mem.get((key, owner))
            hit = ref() if ref is not None else None
            if hit is not None:
                self.stats["mem_hits"] += 1
                return hit
        return self.record(key, ambient)

    def record(self, key, ambient=None):
        """The disk record at `key`, or None (stale/corrupt: removed)."""
        if self.directory is None:
            return None
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            # chaos seam INSIDE the corrupt-handling try: an injected
            # raise or a corrupted path is absorbed as disk rot is, a
            # miss and never an error (runtime/chaos.py)
            path = fault_point("aot.disk_read", path)
            with open(path, "r", encoding="utf-8") as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict):
                raise ValueError("not a record")
        except Exception:  # fault-ok[FLT01]: classified: _bad counts it as corrupt (stats and the records counter) and removes the file
            self._bad(path, "corrupt")
            return None
        amb = ambient if ambient is not None else ambient_fingerprint()
        if rec.get("format") != CACHE_FORMAT \
                or rec.get("ambient") != _jsonable(amb):
            self._bad(path, "stale")
            return None
        with self._lock:
            self.stats["disk_hits"] += 1
        _tm()["records"].labels(outcome="hit").inc()
        return rec

    def _bad(self, path, what):
        with self._lock:
            self.stats[what] += 1
        _tm()["records"].labels(outcome=what).inc()
        self._remove(path)

    def records_for(self, fingerprint, entry):
        """Every valid record of (fingerprint, entry) on disk."""
        if self.directory is None:
            return []
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".capture.json"):
                continue
            key = name[:-len(".capture.json")]
            path = os.path.join(self.directory, name)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    head = json.load(fh)
            except (OSError, ValueError, UnicodeDecodeError):
                self._bad(path, "corrupt")
                continue
            if isinstance(head, dict) \
                    and head.get("fingerprint") == fingerprint \
                    and head.get("entry") == entry:
                rec = self.record(key)
                if rec is not None:
                    out.append((key, rec))
        return out

    @staticmethod
    def _remove(path):
        try:
            os.remove(path)
        except OSError:
            pass

    def put(self, key, entry, owner=None, record=None, ambient=None):
        """Keep `entry` in memory for `owner` and, with a directory,
        write `record` (its signature, knobs, buckets, seconds)
        atomically. A failed write is counted, never raised: the next
        process captures cold."""
        with self._lock:
            self._mem[(key, owner)] = weakref.ref(entry)
            self.stats["puts"] += 1
        if self.directory is None or record is None:
            return
        rec = dict(record)
        rec["format"] = CACHE_FORMAT
        rec["ambient"] = _jsonable(ambient if ambient is not None
                                   else ambient_fingerprint())
        try:
            # chaos seam inside the counted try: an injected write fault
            # costs the record, never the process (runtime/chaos.py)
            fault_point("aot.disk_write")
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(rec, fh, indent=1)
                os.replace(tmp, self._path(key))
            except BaseException:
                self._remove(tmp)
                raise
        except Exception:
            with self._lock:
                self.stats["store_errors"] += 1

    def drop_key(self, key, owner):
        with self._lock:
            self._mem.pop((key, owner), None)

    def drop_owner(self, owner):
        """Forget `owner`'s entries (its graphs are invalid)."""
        with self._lock:
            for k in [k for k in self._mem if k[1] == owner]:
                del self._mem[k]

    def clear_memory(self):
        """Drop the memory level (a test's second process)."""
        with self._lock:
            self._mem.clear()

    def clear(self):
        self.clear_memory()
        if self.directory:
            for name in os.listdir(self.directory):
                if name.endswith(".capture.json"):
                    self._remove(os.path.join(self.directory, name))


def _jsonable(obj):
    return json.loads(json.dumps(obj, default=str))


_SESSION = None
_SESSION_INIT = False
_SESSION_LOCK = threading.Lock()


def enable(directory=None):
    """Turn on the process-wide session cache (directory None: the
    ``DL4J_TPU_AOT_CACHE`` directory, else memory only; False: memory
    only). Re-enabling with the same directory keeps the cache. The
    cache writes its records nowhere else."""
    global _SESSION, _SESSION_INIT
    if directory is False:
        directory = None
    else:
        directory = directory or os.environ.get(CACHE_DIR_ENV) or None
    norm = os.path.expanduser(str(directory)) if directory else None
    with _SESSION_LOCK:
        if _SESSION is not None and _SESSION.directory == norm:
            _SESSION_INIT = True
            return _SESSION
        _SESSION = ExecutableCache(directory)
        _SESSION_INIT = True
        return _SESSION


def disable():
    """Turn the session cache off."""
    global _SESSION, _SESSION_INIT
    _SESSION = None
    _SESSION_INIT = True


def _vetoed():
    return os.environ.get(AOT_ENV, "").lower() in ("off", "0", "false")


def session_cache():
    """The session cache or None; enabled on first use from
    ``DL4J_TPU_AOT_CACHE``; ``DL4J_TPU_AOT=off`` vetoes it."""
    global _SESSION_INIT
    if _vetoed():
        return None
    if not _SESSION_INIT:
        _SESSION_INIT = True
        if os.environ.get(CACHE_DIR_ENV):
            enable()
    return _SESSION


# ----------------------------------------------------------------------
# the captured step
# ----------------------------------------------------------------------

def _tensors(args):
    out = []
    if isinstance(args, (list, tuple)):
        for a in args:
            out.extend(_tensors(a))
    elif isinstance(args, dict):
        for k in sorted(args):
            out.extend(_tensors(args[k]))
    elif isinstance(args, torch.Tensor):
        out.append(args)
    return out


def _static_like(args):
    """Static buffers with `args`' nesting: each tensor cloned (its own
    memory the graph reads), everything else as it is."""
    if isinstance(args, (list, tuple)):
        return type(args)(_static_like(a) for a in args)
    if isinstance(args, dict):
        return {k: _static_like(v) for k, v in args.items()}
    if isinstance(args, torch.Tensor):
        return args.detach().clone()
    return args


def _copy_in(static, args):
    for s, a in zip(_tensors(static), _tensors(args)):
        if s.data_ptr() != a.data_ptr():
            s.copy_(a, non_blocking=True)


class GraphEntry:
    """One captured signature: the graph (None on the CPU), its static
    inputs and outputs, the per-replay prologue and the kernel launches
    the graph holds."""

    __slots__ = ("graph", "static_in", "static_out", "prologue", "launches",
                 "key", "seconds", "bind_version", "__weakref__")

    def __init__(self, graph, static_in, static_out, prologue, launches,
                 key, seconds, bind_version):
        self.graph, self.static_in, self.static_out = \
            graph, static_in, static_out
        self.prologue, self.launches, self.key = prologue, launches, key
        self.seconds, self.bind_version = seconds, bind_version


class CapturedStep:
    """A step function captured once per signature (module docstring).

    fn(*args, **host) -> a tensor or a tuple of tensors; `host` are the
    per-call host values (an iteration) the prologue turns into device
    state before each replay. `owner` gives the fingerprint (a network,
    else `fingerprint`) and a ``_bind_version`` that moves when it
    rebinds the tensors a graph holds. `snapshot()` returns what
    `restore(snap)` puts back after the warm-up.
    """

    def __init__(self, fn, owner=None, entry="step", extra="",
                 fingerprint=None, cache=None, prologue=None,
                 snapshot=None, restore=None):
        self._fn = fn
        self._owner = owner
        self.entry = entry
        self._extra = extra
        self._fingerprint = fingerprint
        self._pinned = cache
        self._prologue = prologue
        self._snapshot, self._restore = snapshot, restore
        self._table = {}
        self._lock = threading.RLock()
        self.refusal = None      # why capture is refused, once known
        #: capture each new signature on first sight (RetraceSentinel)
        self.auto = False
        #: called with no argument at each capture
        self.observers = []
        self.captures = 0
        self.replays = 0
        self.uncaptured = 0

    # -- keys ----------------------------------------------------------
    def pin_cache(self, cache):
        self._pinned = cache
        return self

    def cache(self):
        """The pinned cache, else the session cache (turned on here);
        under ``DL4J_TPU_AOT=off`` a memory-only cache of this step's
        own."""
        c = self._pinned if self._pinned is not None else session_cache()
        if c is None:
            c = self._pinned = ExecutableCache() if _vetoed() else enable()
        return c

    def fingerprint(self):
        if self._fingerprint is None:
            self._fingerprint = network_fingerprint(self._owner)  # thread-ok[THR04]: idempotent: racers compute the same string; no thread, queue or graph is built
        return self._fingerprint

    def key_for(self, args):
        return cache_key(self.fingerprint(), self.entry + self._extra,
                         abstract_signature(args))

    def _bind_version(self):
        return getattr(self._owner, "_bind_version", 0)

    def invalidate(self):
        """Drop every graph (the owner rebound what they hold)."""
        with self._lock:
            self._table.clear()
            self.cache().drop_owner(id(self))
        return self

    def _slot(self, args):
        return (abstract_signature(args), _knob_state())

    def captured(self, args):
        """Whether `args`' signature has a live entry."""
        ent = self._table.get(self._slot(args))  # thread-ok[THR01]: one atomic dict read; the entry's bind_version is checked, and a miss is answered by a locked capture
        return ent is not None and ent.bind_version == self._bind_version()

    def drop(self, args):
        """Forget the entry at `args`' signature (its graph and pool go
        with the last reference)."""
        with self._lock:
            ent = self._table.pop(self._slot(args), None)
        if ent is not None:
            self.cache().drop_key(ent.key, id(self))

    # -- capture -------------------------------------------------------
    def capture(self, args, record=None, **host):
        """Warm up and capture the step at `args`' signature (on the
        CPU: the same warm-up, under ``HostReadGuard``, and the key).
        Returns (key, status, seconds): status "warm" when the key was
        known (a record on disk or another owner's graph), else
        "cold"."""
        if self.refusal is not None:
            raise CaptureRefused(self.refusal)
        cache = self.cache()
        sig = self._slot(args)
        key = self.key_for(args)
        known = key in cache
        if hasattr(self._owner, "_graphs_hold"):
            # from the warm-up on, the owner writes its states into the
            # tensors it holds, which the graph then reads and writes
            self._owner._graphs_hold = True
        t0 = time.perf_counter()
        devs = {t.device.type for t in _tensors(args)}
        if "cuda" in devs:
            ent = self._capture_cuda(args, key, host)
        else:
            ent = self._capture_cpu(args, key, host)
        secs = time.perf_counter() - t0
        ent.seconds = secs
        with self._lock:
            self._table[sig] = ent
        self.captures += 1
        for obs in self.observers:
            obs()
        cache.note_capture(key, secs, self.entry)
        rec = {"fingerprint": self.fingerprint(),
               "entry": self.entry + self._extra,
               "signature": _describe(args), "capture_seconds": secs,
               "knobs": _knobs()}
        rec.update(record or {})
        cache.put(key, ent, owner=id(self), record=rec)
        return key, ("warm" if known else "cold"), secs

    def _warm(self, args, host, draws):
        """The warm-up: the step run once (on the card on a side stream)
        with its draw sites recorded; what it changed put back. A refusal
        (``CaptureRefused``) is kept and raised."""
        if self._prologue is not None:
            self._prologue(**host)
        snap = self._snapshot() if self._snapshot is not None else None
        try:
            with draws.recording():
                self._fn(*args, **host)
        except CaptureRefused as e:
            self.refusal = f"{self.entry}: {e}"
            self.cache().note_uncaptured(self.entry, "refused")
            raise CaptureRefused(self.refusal) from None
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            if snap is not None:
                self._restore(snap)

    def _capture_cpu(self, args, key, host):
        from deeplearning4j_tpu_torch.nn.conf import dropout as _dropout

        with HostReadGuard(f"{self.entry} (captured region)"):
            self._warm(args, host, _dropout.DrawSites())
        return GraphEntry(None, None, None, self._prologue, {}, key, 0.0,
                          self._bind_version())

    def _capture_cuda(self, args, key, host):
        from deeplearning4j_tpu_torch.nn.conf import dropout as _dropout

        static_in = _static_like(args)
        draws = _dropout.DrawSites()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._warm(static_in, host, draws)
        torch.cuda.current_stream().wait_stream(side)
        if draws.sites and not capture_supported():
            self.refusal = (
                "this torch cannot register a step's generators with a "
                "graph (CUDAGraph.register_generator_state), so the draws "
                "of the stochastic layers at " + draws.describe() +
                " would repeat on every replay")
            raise CaptureRefused(f"{self.entry}: {self.refusal}")
        if self._prologue is not None:
            self._prologue(**host)
        graph = torch.cuda.CUDAGraph()
        ts = _tensors(static_in)
        draws.bind(graph, ts[0].device if ts else torch.device("cuda"))
        from deeplearning4j_tpu_torch.ops import _kernels

        # thread_local: serving threads keep launching (and syncing) on
        # their own streams while a swap captures its new version
        with _kernels.capture_tally(side) as held, draws.capturing(), \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            out = self._fn(*static_in, **host)
        prologue = self._prologue
        if draws.sites:
            base = prologue

            def prologue(**h):
                if base is not None:
                    base(**h)
                draws.reseed(h.get("iteration"))
        return GraphEntry(graph, static_in, out, prologue, held, key, 0.0,
                          self._bind_version())

    # -- dispatch ------------------------------------------------------
    def __call__(self, *args, **host):
        ent = self._table.get(self._slot(args))  # thread-ok[THR01]: one atomic dict read on the replay path; a stale miss runs eagerly and is counted, a stale hit is checked against bind_version
        if ent is not None and ent.bind_version != self._bind_version():
            self.invalidate()
            return self._eager(args, host, "rebound")
        if ent is None and self.auto and self.refusal is None:
            self.capture(args, **host)
            ent = self._table.get(self._slot(args))  # thread-ok[THR01]: read back after this thread's own locked capture
        if ent is None:
            return self._eager(args, host, "signature")
        if ent.prologue is not None:
            ent.prologue(**host)
        self.replays += 1
        _tm()["replays"].labels(entry=self.entry).inc()
        if ent.graph is None:       # the CPU: the same step, eagerly
            return self._fn(*args, **host)
        _copy_in(ent.static_in, args)
        ent.graph.replay()
        from deeplearning4j_tpu_torch.ops import _kernels

        for f in _counted_kernels():
            n = ent.launches.get(f.__name__, 0)
            if n:
                _kernels.add_launches(f, n)
        return ent.static_out

    def _eager(self, args, host, reason):
        """An uncaptured dispatch: counted, then the step eagerly."""
        self.uncaptured += 1
        self.cache().note_uncaptured(self.entry, reason)
        if self._prologue is not None:
            self._prologue(**host)
        return self._fn(*args, **host)

    def records(self):
        """The disk records of this step's fingerprint and entry."""
        return self.cache().records_for(self.fingerprint(),
                                        self.entry + self._extra)


def _describe(args):
    """A JSON form of `args`' signature: [{"shape", "dtype"}] per tensor,
    None for an absent argument (what a second process rebuilds)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append({"shape": list(a.shape),
                        "dtype": str(a.dtype).replace("torch.", "")})
        elif isinstance(a, dict):
            out.append({k: _describe([v])[0] for k, v in a.items()})
        elif isinstance(a, (list, tuple)):
            out.append(_describe(a))
        else:
            out.append(None)
    return out


def zeros_from(desc, device):
    """Zero tensors rebuilt from a record's signature (``_describe``)."""
    if desc is None:
        return None
    if isinstance(desc, list):
        return [zeros_from(d, device) for d in desc]
    if "shape" in desc and "dtype" in desc:
        return torch.zeros(desc["shape"], dtype=getattr(torch, desc["dtype"]),
                           device=device)
    return {k: zeros_from(v, device) for k, v in desc.items()}


def _knobs():
    from deeplearning4j_tpu_torch.runtime import autotune

    return autotune.current_knobs()


#: the reference's name for the captured step
CachedJit = CapturedStep


def cached_jit(fn, owner=None, entry="step", extra="", fingerprint=None,
               **kwargs):
    """A ``CapturedStep`` over `fn` (the reference's ``cached_jit``)."""
    return CapturedStep(fn, owner=owner, entry=entry, extra=extra,
                        fingerprint=fingerprint, **kwargs)


# ----------------------------------------------------------------------
# the warm-path proof
# ----------------------------------------------------------------------

class CompileWatch:
    """Context manager proving a region captured nothing and ran nothing
    uncaptured: ``.captures`` and ``.uncaptured`` are the cache's deltas,
    ``.misses`` their sum (reference: ``CompileWatch``)."""

    def __init__(self, cache=None):
        self._explicit = cache
        self.misses = self.captures = self.uncaptured = None

    def __enter__(self):
        self._cache = self._explicit if self._explicit is not None \
            else session_cache()
        if self._cache is None:
            raise RuntimeError(
                "CompileWatch needs an active cache (aot.enable() or an "
                "explicit cache): with none there is no count to prove "
                "warmth against")
        self._before = dict(self._cache.stats)
        return self

    def __exit__(self, *exc):
        st = self._cache.stats
        self.captures = st["captures"] - self._before["captures"]
        self.uncaptured = st["uncaptured"] - self._before["uncaptured"]
        self.misses = self.captures + self.uncaptured
        return False

    def assert_no_compiles(self, context="watched region"):
        if self.misses is None:
            raise RuntimeError("assert_no_compiles before __exit__")
        if self.misses:
            raise RuntimeError(
                f"{context} paid {self.captures} capture(s) and "
                f"{self.uncaptured} uncaptured dispatch(es) that a warm "
                "cache should have served: precompile the signature, or "
                "the key changed")
        return self


# ----------------------------------------------------------------------
# shape buckets
# ----------------------------------------------------------------------

#: serving-tier batch buckets: one graph per bucket, never one per size
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_batch(n, buckets=DEFAULT_BATCH_BUCKETS):
    """Smallest bucket >= n; past the largest, the next multiple of it."""
    n = int(n)
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in buckets:
        if n <= b:
            return b
    top = max(buckets)
    return ((n + top - 1) // top) * top


def pad_batch(arr, bucket):
    """Zero-pad arr's leading (batch) axis up to `bucket` on the host;
    the caller slices the surplus rows off the output."""
    arr = np.asarray(arr)
    pad = bucket - arr.shape[0]
    if pad < 0:
        raise ValueError(f"batch {arr.shape[0]} exceeds bucket {bucket}")
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


def sentinel_budget(buckets=DEFAULT_BATCH_BUCKETS, entries=1):
    """The capture budget of a bucketed call site: one per bucket per
    entry point (hand to ``RetraceSentinel(max_compiles=...)``)."""
    return len(tuple(buckets)) * int(entries)
