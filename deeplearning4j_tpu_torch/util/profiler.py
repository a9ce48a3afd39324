"""Profiling and per-step timing.

The counterpart of ``deeplearning4j_tpu/util/profiler.py``. Reference:
org.nd4j.linalg.profiler.OpProfiler + PerformanceListener's timing half.
The profiler accounts (a) host wall time per named section, the first
call split from the steady state, (b) device traces through
``torch.profiler`` and (c) the operations and bytes of one call, and a
model FLOP utilization against the card's peak.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time


class OpProfiler:
    """Singleton section timer (reference: OpProfiler.getInstance()), a
    facade over the telemetry registry (``runtime.telemetry``): every
    steady-state section lands in the
    ``dl4j_profiler_section_seconds{section=...}`` histogram and the
    first call's wall in the ``dl4j_profiler_compile_seconds{section=...}``
    gauge. Thread-safe; the clock is injectable
    (``OpProfiler(clock=ManualClock())`` in tests).

    A section measures host wall time, as the reference's does. On the
    card that is the time to ISSUE the block's work unless the block
    itself synchronises (a loss read, a ``.cpu()``): the profiler adds
    no synchronisation of its own. The first call of a section carries
    whatever warm-up happens in it (kernel builds, cuDNN's plan choice,
    the caching allocator's first allocations)."""

    _instance = None
    _instance_lock = threading.Lock()

    @classmethod
    def getInstance(cls) -> "OpProfiler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = OpProfiler()
            return cls._instance

    def __init__(self, clock=None, registry=None):
        from deeplearning4j_tpu_torch.runtime import telemetry

        if registry is None:
            registry = telemetry.get_registry()
        self._registry = registry
        self._clock = clock if clock is not None else registry.clock
        self._lock = threading.RLock()
        self._steady = registry.histogram(
            "dl4j_profiler_section_seconds",
            "OpProfiler steady-state section wall (first call excluded)",
            labels=("section",))
        self._compile = registry.gauge(
            "dl4j_profiler_compile_seconds",
            "OpProfiler first-call wall (warm-up: builds, plan choice)",
            labels=("section",))
        self._first = {}  # section -> first-call wall

    def reset(self):
        """Zero this profiler's sections in place (its registry series
        included; handles stay attached)."""
        with self._lock:
            for name in self._first:
                self._steady.labels(section=name).reset()
                self._compile.labels(section=name).reset()
            self._first = {}
        return self

    @contextlib.contextmanager
    def section(self, name: str):
        from deeplearning4j_tpu_torch.runtime import telemetry

        t0 = self._clock()
        try:
            yield
        finally:
            # the kill switch skips ALL bookkeeping (the first-call split
            # included): disabled readings stay 0 invocations, 0 seconds
            if telemetry.enabled():
                dt = self._clock() - t0
                with self._lock:
                    if name not in self._first:
                        self._first[name] = dt
                        self._compile.labels(section=name).set(dt)
                    else:
                        self._steady.labels(section=name).observe(dt)
                self._registry.trace.add(f"profiler.{name}", "profiler",
                                         t0, dt)

    def _steady_child(self, name):
        # a read must not create a series for a section never timed
        return self._steady.labels_get(section=name)

    def timeSpent(self, name: str) -> float:
        """Steady-state seconds (the first call excluded)."""
        c = self._steady_child(name)
        return c.sum if c is not None else 0.0

    def invocations(self, name: str) -> int:
        with self._lock:
            seen = name in self._first
        c = self._steady_child(name)
        return (c.count if c is not None else 0) + (1 if seen else 0)

    def compileTime(self, name: str) -> float:
        with self._lock:
            return self._first.get(name, 0.0)

    def averageTime(self, name: str) -> float:
        c = self._steady_child(name)
        return c.sum / max(c.count, 1) if c is not None else 0.0

    def printOutDashboard(self) -> str:
        lines = [f"{'section':<28}{'calls':>7}{'compile_s':>11}"
                 f"{'steady_avg_ms':>15}{'total_s':>9}"]
        with self._lock:
            names = sorted(self._first)
        for name in names:
            lines.append(f"{name:<28}{self.invocations(name):>7}"
                         f"{self.compileTime(name):>11.3f}"
                         f"{self.averageTime(name) * 1e3:>15.3f}"
                         f"{self.timeSpent(name):>9.3f}")
        out = "\n".join(lines)
        print(out)
        return out


# ----------------------------------------------------------------------
# operation counts and model FLOP utilization
# ----------------------------------------------------------------------

#: dense bf16 tensor-core peak FLOP/s by a substring of
#: ``torch.cuda.get_device_name``: NVIDIA's data sheet for the H100 SXM
#: (989 TFLOP/s without sparsity, at its 700 W power limit). The card the
#: port runs on reports "NVIDIA H100 80GB HBM3" with a power limit of
#: "700.00 W" (``nvidia-smi --query-gpu=name,power.limit
#: --format=csv,noheader``); a card set below 700 W reaches less.
_PEAK_BF16_FLOPS = (("H100", 989e12),)


def device_peak_flops(device=None) -> float:
    """The dense bf16 peak FLOP/s of the CUDA `device` (default: the
    current card); 0.0 for the CPU, for no visible card and for a card
    whose name the table does not know."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    if not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(device)
    for sub, peak in _PEAK_BF16_FLOPS:
        if sub in name:
            return peak
    return 0.0


def compiled_cost(fn, *args, **kwargs) -> dict:
    """The operations and bytes of ONE call of ``fn(*args, **kwargs)``,
    which this runs: {'flops': float, 'bytes_accessed': float}.

    ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count:
    matrix products, convolutions and attention at 2 per multiply-add;
    elementwise ops, reductions and normalisations count 0 (the
    reference's XLA cost analysis counts those too, so on a network the
    two agree on the products only). ``bytes_accessed`` is every aten
    op's input and output tensor bytes as it runs, seen by a
    ``TorchDispatchMode`` (views, which move nothing, left out): the
    unfused traffic, an upper bound of what XLA reports for the fused
    program. On a single matrix product the two packages agree exactly.
    The backward of anything ``fn`` differentiates is counted too."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if not func.is_view:
                leaves, _ = tree_flatten((a, kw, out))
                self.total += sum(t.numel() * t.element_size()
                                  for t in leaves
                                  if isinstance(t, torch.Tensor))
            return out

    flops, moved = FlopCounterMode(display=False), _Bytes()
    with flops, moved:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(moved.total)}


def mfu(flops_per_step: float, step_time_s: float, device=None) -> float:
    """Model FLOP utilization: achieved FLOP/s over the card's dense bf16
    peak (``device_peak_flops``); 0.0 when the peak is unknown."""
    peak = device_peak_flops(device)
    if not peak or step_time_s <= 0:
        return 0.0
    return flops_per_step / step_time_s / peak


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (host ops, and CUDA kernels
    and copies where a card is visible), written into `log_dir` as a
    Chrome trace (``trace_<pid>_<ns>.json``: Perfetto or
    chrome://tracing open it). (Reference analogue: ProfilerConfig +
    nvprof.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region inside a trace (``torch.profiler.record_function``;
    the reference's jax.profiler.TraceAnnotation)."""
    from torch.profiler import record_function

    return record_function(name)
