"""The runtime half of the retrace pass (reference:
``deeplearning4j_tpu/analysis/retrace.py``): a capture counter.

The reference counts jit traces: a call pattern that varies its trace
key compiles every step. The port's counterpart of a trace is a CUDA
graph capture (``runtime.aot``): a step captured again and again (one
graph per batch size, a graph per knob flip) pays a warm-up and a
capture each time. ``RetraceSentinel`` counts the captures of each step
it watches and raises ``RetraceError`` past its budget; every count is
mirrored into ``dl4j_retrace_compiles_total``.

    sentinel = RetraceSentinel(max_compiles=1)
    step = sentinel.wrap(fn, "train_step")   # captures each new signature
    ...
    assert sentinel.compiles("train_step") == 1

or, for a network, ``sentinel.install(net)``: the net's train step then
captures each new signature on first sight and replays it after. The
static lint (``lint_retrace``) waits for the analysis slice (ROADMAP.md
Queue 1 item 13).
"""

from __future__ import annotations

__all__ = ["RetraceError", "RetraceSentinel"]


class RetraceError(RuntimeError):
    """A step captured more often than its budget allows."""


class RetraceSentinel:
    """Counts captures of watched steps (module docstring)."""

    def __init__(self, max_compiles=1):
        self.max_compiles = int(max_compiles)
        self.counts = {}

    def _record(self, label):
        n = self.counts.get(label, 0) + 1
        self.counts[label] = n
        from deeplearning4j_tpu_torch.runtime import telemetry

        telemetry.get_registry().counter(
            "dl4j_retrace_compiles_total",
            "captures counted by RetraceSentinel-watched steps",
            labels=("fn",)).labels(fn=label).inc()
        if n > self.max_compiles:
            raise RetraceError(
                f"'{label}' is being captured for the {n}th time (budget "
                f"{self.max_compiles}): the call site varies its signature "
                "(shapes, dtypes) or the knobs per call")

    def compiles(self, name):
        return self.counts.get(name, 0)

    def watch(self, step, name):
        """Count `step`'s captures (an ``aot.CapturedStep``) under
        `name`, and let it capture each new signature on first sight."""
        step.auto = True
        step.observers.append(lambda: self._record(name))
        return step

    def wrap(self, fn, name=None, **kwargs):
        """`fn` as an ``aot.CapturedStep`` whose captures are counted;
        `kwargs` go to it (``fingerprint`` defaults to the label)."""
        from deeplearning4j_tpu_torch.runtime import aot

        label = name or getattr(fn, "__name__", repr(fn))
        kwargs.setdefault("fingerprint", label)
        return self.watch(aot.CapturedStep(fn, entry=label, **kwargs),
                          label)

    def install(self, net, name="train_step"):
        """Count captures of a MultiLayerNetwork/ComputationGraph's (or a
        ParallelWrapper's net's) train step. Returns self."""
        net = getattr(net, "net", net)
        self.watch(net._train_capture(), name)
        return self

    def install_fit_dataset(self, net, name="fit_dataset_loop"):
        """Count captures of the steps fitDataSet(stepsPerSync=k) runs:
        its blocks replay the train step's graphs, so this watches the
        same step under `name`. Returns self."""
        return self.install(net, name)
