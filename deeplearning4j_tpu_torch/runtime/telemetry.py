"""Metrics registry + span ring.

The counterpart of ``deeplearning4j_tpu/runtime/telemetry.py``: the
process-wide, thread-safe counters / gauges / fixed-bucket histograms
(with exact percentile readout over a bounded sample reservoir),
Prometheus-style labels, the Prometheus text exposition served on
``GET /metrics``, a JSON ``snapshot()``, spans (``span``, ``add_span``,
``event``) into a bounded ring on an injectable clock, exported as
Chrome trace-event JSON (``export_chrome_trace``, which Perfetto opens)
or JSONL (``export_jsonl``), and a process-wide kill switch:
``set_enabled(False)`` (or env ``DL4J_TPU_TELEMETRY=off``) turns every
instrument write and span record into a no-op, while reads (snapshot,
exposition, export) keep working on what was recorded. Instruments
live at dispatch boundaries on host code that already runs between
device launches; nothing here touches a device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import threading
import time

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "TraceBuffer", "get_registry", "set_enabled", "enabled",
           "percentile", "DEFAULT_BUCKETS"]

# process-wide kill switch (the overhead A/B: instrumented vs disabled)
_ENABLED = os.environ.get("DL4J_TPU_TELEMETRY", "on").lower() \
    not in ("off", "0", "false", "no")


def set_enabled(on: bool) -> bool:
    """Flip the process-wide telemetry switch. Disabled = every
    instrument write and span record is a no-op (reads keep working on
    whatever was recorded)."""
    global _ENABLED
    _ENABLED = bool(on)
    return _ENABLED


def enabled() -> bool:
    return _ENABLED


def percentile(values, q):
    """Linear-interpolated percentile (q in [0, 100]) of a sequence —
    numpy's default 'linear' method. None for an empty sequence."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    q = float(q)
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    rank = (len(vals) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return vals[int(rank)]
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


#: default latency buckets (seconds)
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0)

#: raw samples a histogram retains for exact percentile readout; past
#: this the reservoir is a sliding window of the most recent samples
DEFAULT_SAMPLE_CAP = 8192

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name):
    if not _NAME_OK.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: Prometheus names match "
            "[a-zA-Z_:][a-zA-Z0-9_:]*")
    return name


def _escape_label(v):
    """Prometheus label-value escaping: backslash, double-quote, LF."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v):
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class _Child:
    """One (instrument, label-values) time series. All mutation goes
    through the parent instrument's lock."""

    __slots__ = ("_parent", "labels", "value", "bucket_counts", "sum",
                 "count", "samples")

    def __init__(self, parent, labels):
        self._parent = parent
        self.labels = labels          # dict, insertion == labelnames order
        self.value = 0.0
        if parent.kind == "histogram":
            self.bucket_counts = [0] * (len(parent.buckets) + 1)
            self.sum = 0.0
            self.count = 0
            self.samples = []         # bounded ring, newest last

    def inc(self, n=1.0):
        if not _ENABLED:
            return self
        if self._parent.kind == "counter" and n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._parent._lock:
            self.value += n
        return self

    def dec(self, n=1.0):
        if self._parent.kind != "gauge":
            raise TypeError(f"dec() on a {self._parent.kind}")
        return self.inc(-n)

    def set(self, v):
        if self._parent.kind != "gauge":
            raise TypeError(f"set() on a {self._parent.kind}")
        if not _ENABLED:
            return self
        with self._parent._lock:
            self.value = float(v)
        return self

    def observe(self, v):
        if self._parent.kind != "histogram":
            raise TypeError(f"observe() on a {self._parent.kind}")
        if not _ENABLED:
            return self
        v = float(v)
        p = self._parent
        with p._lock:
            i = len(p.buckets)
            for j, edge in enumerate(p.buckets):
                if v <= edge:
                    i = j
                    break
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1
            self.samples.append(v)
            if len(self.samples) > p.sample_cap:
                del self.samples[:len(self.samples) - p.sample_cap]
        return self

    def percentile(self, q):
        """Exact percentile over the retained samples."""
        with self._parent._lock:
            vals = list(self.samples)
        return percentile(vals, q)

    def mean(self):
        """Mean over ALL observations (sum/count); None before the first
        (the fleet brownout's measured per-item estimate)."""
        with self._parent._lock:
            return self.sum / self.count if self.count else None

    def reset(self):
        """Zero this series in place (cached handles stay attached)."""
        with self._parent._lock:
            self.value = 0.0
            if self._parent.kind == "histogram":
                self.bucket_counts = [0] * (len(self._parent.buckets) + 1)
                self.sum = 0.0
                self.count = 0
                self.samples = []
        return self


class _Instrument:
    """A named family of label-distinguished children; every series is
    addressed through ``labels(...)``."""

    kind = None

    def __init__(self, name, help="", labelnames=()):
        self.name = _check_name(name)
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._lock = threading.RLock()
        self._children = {}

    def _make_child_locked(self, labels):
        child = _Child(self, labels)
        self._children[tuple(labels.values())] = child
        return child

    def _label_key(self, kv):
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        return tuple(str(kv[ln]) for ln in self.labelnames)

    def labels(self, **kv):
        """The child series for exactly this label set (created on
        first use)."""
        key = self._label_key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child_locked(
                    {ln: str(kv[ln]) for ln in self.labelnames})
        return child

    def labels_get(self, **kv):
        """The child for this label set, or None — never creates one."""
        with self._lock:
            return self._children.get(self._label_key(kv))

    def remove(self, **kv):
        """Drop this label set's series (no-op when absent); lifecycle
        owners call it at close so per-instance series don't pile up."""
        with self._lock:
            self._children.pop(self._label_key(kv), None)
        return self

    def children(self):
        with self._lock:
            return list(self._children.values())

    def reset(self):
        for c in self.children():
            c.reset()
        return self

    def _only(self):
        """The one series of an unlabeled instrument."""
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}: address a "
                "series via .labels(...)")
        return self.labels()


class Counter(_Instrument):
    kind = "counter"

    @property
    def value(self):
        return self._only().value


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, v):
        return self._only().set(v)

    def inc(self, n=1.0):
        return self._only().inc(n)

    def dec(self, n=1.0):
        return self._only().dec(n)

    @property
    def value(self):
        return self._only().value


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None,
                 sample_cap=DEFAULT_SAMPLE_CAP):
        buckets = DEFAULT_BUCKETS if buckets is None else tuple(
            sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = buckets
        self.sample_cap = int(sample_cap)
        super().__init__(name, help, labelnames)

    @property
    def count(self):
        return self._only().count

    @property
    def sum(self):
        return self._only().sum


class TraceBuffer:
    """Bounded ring of structured spans: {name, cat, ts, dur (seconds),
    ph ('X' span, 'i' instant), pid, tid, args}."""

    def __init__(self, capacity=8192):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans = []
        self.dropped = 0   # spans evicted by the ring bound

    def add(self, name, cat, ts, dur, args=None, ph="X"):
        if not _ENABLED:
            return
        span = {"name": str(name), "cat": str(cat), "ts": float(ts),
                "dur": float(dur), "ph": ph, "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": dict(args) if args else {}}
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.capacity:
                drop = len(self._spans) - self.capacity
                del self._spans[:drop]
                self.dropped += drop

    def spans(self):
        with self._lock:
            return [dict(s) for s in self._spans]

    def clear(self):
        with self._lock:
            self._spans = []
            self.dropped = 0


class MetricsRegistry:
    """Process-wide instrument + span registry. clock: monotonic seconds
    (default time.perf_counter) stamping ``event``s; components with a
    clock of their own record spans through ``add_span``."""

    def __init__(self, clock=None, trace_capacity=8192):
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.RLock()
        self._instruments = {}
        self.trace = TraceBuffer(trace_capacity)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"{name} already registered as {inst.kind}, "
                        f"requested {cls.kind}")
                if tuple(labelnames) != inst.labelnames:
                    raise ValueError(
                        f"{name} already registered with labels "
                        f"{inst.labelnames}, requested {tuple(labelnames)}")
                return inst
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name, help="", labels=()):
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=None,
                  sample_cap=DEFAULT_SAMPLE_CAP):
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets, sample_cap=sample_cap)

    def get(self, name):
        with self._lock:
            return self._instruments.get(name)

    def instruments(self):
        with self._lock:
            return dict(self._instruments)

    def reset(self):
        """Zero every series and clear the trace ring in place."""
        for inst in self.instruments().values():
            inst.reset()
        self.trace.clear()
        return self

    @contextlib.contextmanager
    def span(self, name, cat="", **args):
        """Record the wrapped block as one complete span on this
        registry's clock (nothing while telemetry is disabled)."""
        if not _ENABLED:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            self.trace.add(name, cat, t0, self.clock() - t0, args)

    def add_span(self, name, cat, ts, dur, **args):
        """Record a span with explicit start/duration (seconds) on the
        caller's clock (a scheduler's clock may be a ManualClock)."""
        self.trace.add(name, cat, ts, dur, args)

    def event(self, name, cat="", **args):
        """Record an instant event (ph 'i') at the registry's now."""
        self.trace.add(name, cat, self.clock(), 0.0, args, ph="i")

    def snapshot(self):
        """JSON-safe nested view of every instrument (the
        ``metrics_snapshot()`` surface)."""
        out = {}
        for name, inst in sorted(self.instruments().items()):
            series = []
            for c in inst.children():
                with inst._lock:
                    if inst.kind == "histogram":
                        rec = {"labels": dict(c.labels), "count": c.count,
                               "sum": round(c.sum, 9),
                               "p50": percentile(c.samples, 50),
                               "p99": percentile(c.samples, 99),
                               "buckets": dict(zip(
                                   [str(b) for b in inst.buckets]
                                   + ["+Inf"], c.bucket_counts))}
                    else:
                        rec = {"labels": dict(c.labels), "value": c.value}
                series.append(rec)
            out[name] = {"kind": inst.kind, "help": inst.help,
                         "series": series}
        return out

    def prometheus(self):
        """Prometheus text exposition (format 0.0.4): HELP/TYPE lines,
        label escaping, cumulative histogram buckets plus _sum/_count."""
        lines = []
        for name, inst in sorted(self.instruments().items()):
            if inst.help:
                lines.append(f"# HELP {name} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for c in inst.children():
                base = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in c.labels.items())
                suffix = f"{{{base}}}" if base else ""
                if inst.kind == "histogram":
                    with inst._lock:
                        counts = list(c.bucket_counts)
                        total, csum = c.count, c.sum
                    cum = 0
                    for edge, n in zip(inst.buckets, counts):
                        cum += n
                        lab = (base + "," if base else "") + \
                            f'le="{edge:g}"'
                        lines.append(f"{name}_bucket{{{lab}}} {cum}")
                    lab = (base + "," if base else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{lab}}} {total}")
                    lines.append(f"{name}_sum{suffix} {csum:g}")
                    lines.append(f"{name}_count{suffix} {total}")
                else:
                    lines.append(f"{name}{suffix} {c.value:g}")
        return "\n".join(lines) + "\n"


    def chrome_trace(self):
        """The span ring as a Chrome trace-event JSON object (ts and dur
        in microseconds, as the format wants)."""
        events = []
        for s in self.trace.spans():
            ev = {"name": s["name"], "cat": s["cat"] or "default",
                  "ph": s["ph"], "ts": s["ts"] * 1e6,
                  "pid": s["pid"], "tid": s["tid"], "args": s["args"]}
            if s["ph"] == "X":
                ev["dur"] = s["dur"] * 1e6
            else:
                ev["s"] = "t"   # instant scope: thread
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path):
        """Write ``chrome_trace()`` to `path` (tmp + rename); -> path."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:  # fault-ok[FLT02]: observability export, off every dispatch path: a failure raises to the operator who asked for the file
            json.dump(self.chrome_trace(), fh)
        os.replace(tmp, path)
        return path

    def export_jsonl(self, path):
        """One JSON object per span, oldest first (tmp + rename);
        -> path."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:  # fault-ok[FLT02]: observability export, as export_chrome_trace
            for s in self.trace.spans():
                fh.write(json.dumps(s) + "\n")
        os.replace(tmp, path)
        return path


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every built-in instrument lives in."""
    return _REGISTRY
