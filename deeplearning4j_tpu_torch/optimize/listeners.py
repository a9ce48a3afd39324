"""Training listeners.

The counterpart of ``deeplearning4j_tpu/optimize/listeners.py``
(reference: org.deeplearning4j.optimize.api.TrainingListener and the impls
in org.deeplearning4j.optimize.listeners: ScoreIterationListener,
PerformanceListener, EvaluativeListener, CheckpointListener,
CollectScoresListener, TimeIterationListener, plus the UI StatsListener).
The networks fire the hooks as the reference's fit does: ``iterationDone``
after every step, ``onEpochStart``/``onEpochEnd`` around an iterator's
pass, and under ``fitDataSet(stepsPerSync=k)`` the block's k losses are
replayed through ``iterationDone`` at the block's one host sync, then
``onSyncBoundary`` fires once. ``model.score()`` is then a host float the
loop already holds, so no listener adds a device sync.
"""

from __future__ import annotations

import json
import math
import os
import time


class TrainingListener:
    """No-op base. Subclasses override what they need
    (reference: optimize.api.BaseTrainingListener)."""

    def iterationDone(self, model, iteration: int, epoch: int) -> None:
        pass

    def onEpochStart(self, model) -> None:
        pass

    def onEpochEnd(self, model) -> None:
        pass

    # ----- staged-epoch hook (fitDataSet / ResilientFit blocks) -------
    def onSyncBoundary(self, model, iteration: int, scores) -> None:
        """fitDataSet(stepsPerSync=k) finished one k-step device block:
        `scores` is the block's per-step loss vector (numpy, length k),
        already replayed through iterationDone. The ONLY point inside a
        staged epoch where host-side state is fresh — per-iteration
        hooks between sync boundaries observe scores replayed from the
        block's k-vector, not a live device fetch."""

    # ----- resilience hooks (runtime.resilience.ResilientFit) ---------
    def onStepSkipped(self, model, iteration: int, epoch: int,
                      loss: float) -> None:
        """A step produced non-finite loss/params and was NOT applied."""

    def onCheckpointSaved(self, model, path: str, iteration: int) -> None:
        pass

    def onCheckpointRestored(self, model, path: str,
                             iteration: int) -> None:
        """Training resumed from `path` (preemption recovery)."""


class ScoreIterationListener(TrainingListener):
    """Print score every `printIterations` iterations
    (reference: listeners.ScoreIterationListener)."""

    def __init__(self, printIterations: int = 10):
        self.printIterations = max(1, int(printIterations))

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.printIterations == 0:
            print(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener(TrainingListener):
    """Throughput reporting: iterations/sec, examples/sec
    (reference: listeners.PerformanceListener).

    Batch size is read from the model's last-fit minibatch (`model.batchSize()`
    if present) so examples/sec covers the real data rate into the chip.
    """

    def __init__(self, frequency: int = 10, reportScore: bool = False):
        self.frequency = max(1, int(frequency))
        self.reportScore = reportScore
        self._last_time = None
        self._last_iter = None

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        if self._last_time is not None and iteration > self._last_iter:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            ips = iters / dt if dt > 0 else float("inf")
            bs = getattr(model, "batchSize", lambda: None)()
            msg = f"iteration {iteration}: {ips:.2f} iterations/sec"
            if bs:
                msg += f", {ips * bs:.1f} examples/sec"
            if self.reportScore:
                msg += f", score {model.score()}"
            print(msg)
        self._last_time = now
        self._last_iter = iteration


class EvaluativeListener(TrainingListener):
    """Run an evaluation on a held-out iterator every `frequency` iterations
    or at each epoch end (reference: listeners.EvaluativeListener)."""

    ITERATION = "iteration"
    EPOCH = "epoch"

    def __init__(self, iterator, frequency: int = 100, invocationType: str = ITERATION,
                 evaluation=None):
        self.iterator = iterator
        self.frequency = max(1, int(frequency))
        self.invocationType = invocationType
        self.evaluation = evaluation
        self.callback = None  # called with the filled evaluation object

    def _invoke(self, model):
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation

        e = self.evaluation if self.evaluation is not None else Evaluation()
        e.reset()
        self.iterator.reset()
        while self.iterator.hasNext():
            ds = self.iterator.next()
            out = model.output(ds.getFeatures())
            e.eval(ds.getLabels(), out, mask=ds.getLabelsMaskArray())
        if self.callback is not None:
            self.callback(e)
        else:
            print(e.stats())

    def iterationDone(self, model, iteration, epoch):
        if self.invocationType == self.ITERATION and iteration % self.frequency == 0:
            self._invoke(model)

    def onEpochEnd(self, model):
        if self.invocationType == self.EPOCH:
            self._invoke(model)


class CheckpointListener(TrainingListener):
    """Periodic model checkpoints with rotation
    (reference: listeners.CheckpointListener.Builder — saveEveryNIterations /
    saveEveryNEpochs / keepLast)."""

    def __init__(self, modelSaveDir, saveEveryNIterations=None,
                 saveEveryNEpochs=None, keepLast: int = 0, saveUpdater: bool = True):
        if saveEveryNIterations is None and saveEveryNEpochs is None:
            raise ValueError("set saveEveryNIterations and/or saveEveryNEpochs")
        self.dir = str(modelSaveDir)
        os.makedirs(self.dir, exist_ok=True)
        self.everyIter = saveEveryNIterations
        self.everyEpoch = saveEveryNEpochs
        self.keepLast = int(keepLast)
        self.saveUpdater = saveUpdater
        self._saved = []  # paths, oldest first

    def _save(self, model, tag: str):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        path = os.path.join(self.dir, f"checkpoint_{tag}.npz")
        ModelSerializer.writeModel(model, path, saveUpdater=self.saveUpdater)
        self._saved.append(path)
        if self.keepLast > 0:
            while len(self._saved) > self.keepLast:
                old = self._saved.pop(0)
                try:
                    os.remove(old)
                except OSError:
                    pass

    def lastCheckpoint(self):
        return self._saved[-1] if self._saved else None

    def iterationDone(self, model, iteration, epoch):
        if self.everyIter and iteration % self.everyIter == 0:
            self._save(model, f"iter_{iteration}")

    def onEpochEnd(self, model):
        ep = model.getEpochCount() if hasattr(model, "getEpochCount") else 0
        if self.everyEpoch and (ep + 1) % self.everyEpoch == 0:
            self._save(model, f"epoch_{ep}")


class CollectScoresListener(TrainingListener):
    """Collect (iteration, score) pairs in memory
    (reference: listeners.CollectScoresListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.iterations = []
        self.scores = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.iterations.append(iteration)
            self.scores.append(model.score())


class TimeIterationListener(TrainingListener):
    """Estimate remaining training time from iteration rate
    (reference: listeners.TimeIterationListener)."""

    def __init__(self, iterationCount: int, frequency: int = 50):
        self.total = int(iterationCount)
        self.frequency = max(1, int(frequency))
        self._start = None

    def iterationDone(self, model, iteration, epoch):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = max(0.0, (self.total - iteration) / rate) if rate > 0 else 0.0
            print(f"iteration {iteration}/{self.total}, ETA {remaining:.1f}s")


class StatsListener(TrainingListener):
    """Training telemetry to a JSONL file + periodic terminal summary.

    Stand-in for the reference's UI server StatsListener
    (deeplearning4j-ui StatsListener → play-framework dashboard): one JSON
    object per record with score, rates, and parameter/gradient summary
    stats; any dashboard can tail the file.
    """

    def __init__(self, logFile=None, frequency: int = 10, collectHistograms: bool = False):
        self.frequency = max(1, int(frequency))
        self.logFile = str(logFile) if logFile is not None else None
        self.collectHistograms = collectHistograms
        self._last_time = None
        self._last_iter = None

    def _write(self, rec: dict):
        # append-per-record: no held file descriptor to leak, and records
        # are durable the moment they're written
        if self.logFile is None:
            return
        with open(self.logFile, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def _param_stats(self, model):
        import numpy as np

        stats = {}
        params = getattr(model, "_params", None)
        if params is None:
            return stats
        from deeplearning4j_tpu_torch.util.serializer import tree_leaves

        leaves = tree_leaves(params)
        if leaves:
            means = [float(x.detach().abs().mean()) for x in leaves]
            stats["paramMeanAbs"] = float(np.mean(means))
        return stats

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        score = model.score()
        rec = {"type": "stats", "iteration": iteration, "epoch": epoch,
               "score": score, "time": time.time()}
        if self._last_time is not None and iteration > self._last_iter:
            rec["iterationsPerSec"] = (iteration - self._last_iter) / (now - self._last_time)
        if self.collectHistograms:
            rec.update(self._param_stats(model))
        self._write(rec)
        self._last_time, self._last_iter = now, iteration

    def onEpochEnd(self, model):
        self._write({"type": "epochEnd", "epoch": model.getEpochCount(),
                     "score": model.score(), "time": time.time()})

    def summary(self) -> str:
        if self.logFile is None or not os.path.exists(self.logFile):
            return "no stats recorded"
        scores = []
        with open(self.logFile) as fh:
            for line in fh:
                rec = json.loads(line)
                if rec.get("type") == "stats":
                    scores.append((rec["iteration"], rec["score"]))
        if not scores:
            return "no stats recorded"
        first, last = scores[0], scores[-1]
        return (f"{len(scores)} records; score {first[1]:.6f} @ iter {first[0]} "
                f"→ {last[1]:.6f} @ iter {last[0]}")


class MetricsListener(TrainingListener):
    """Bridge the TrainingListener event stream into the process-wide
    metrics registry (runtime.telemetry): the scrape-able twin of
    ScoreIterationListener/ResilienceListener.

    Instruments (all under the registry the InferenceServer's
    /metrics endpoint exposes):

    * ``dl4j_train_iterations_total``        — iterationDone count
    * ``dl4j_train_score``                   — last host-visible score
      (read from the model's already-fetched loss: NO device sync)
    * ``dl4j_train_epochs_total``            — onEpochEnd count
    * ``dl4j_train_sync_boundaries_total``   — fitDataSet k-blocks
    * ``dl4j_train_steps_skipped_total``     — non-finite skipped steps
    * ``dl4j_checkpoints_saved_total`` / ``dl4j_checkpoints_restored_total``

    Counting stays OFF the hot path: every hook fires from host-side
    loop code that already holds the fetched loss. Attach once per
    process per training run; counters are cumulative process-wide.
    """

    def __init__(self, registry=None):
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = registry if registry is not None \
            else telemetry.get_registry()
        self.registry = reg
        self._iters = reg.counter(
            "dl4j_train_iterations_total",
            "training iterations seen by the listener chain").labels()
        self._score = reg.gauge(
            "dl4j_train_score",
            "last host-visible training score (loss)").labels()
        self._epochs = reg.counter(
            "dl4j_train_epochs_total", "training epochs completed").labels()
        self._syncs = reg.counter(
            "dl4j_train_sync_boundaries_total",
            "fitDataSet k-block sync boundaries").labels()
        self._skips = reg.counter(
            "dl4j_train_steps_skipped_total",
            "steps skipped by the non-finite guard").labels()
        self._saves = reg.counter(
            "dl4j_checkpoints_saved_total", "checkpoints written").labels()
        self._restores = reg.counter(
            "dl4j_checkpoints_restored_total",
            "checkpoints restored (preemption recovery)").labels()

    def iterationDone(self, model, iteration, epoch):
        self._iters.inc()
        # _score is the loop's already-fetched host float — reading it
        # costs nothing; model.score() on these models returns it as-is
        s = getattr(model, "_score", None)
        if s is not None:
            self._score.set(float(s))

    def onEpochEnd(self, model):
        self._epochs.inc()

    def onSyncBoundary(self, model, iteration, scores):
        self._syncs.inc()

    def onStepSkipped(self, model, iteration, epoch, loss):
        self._skips.inc()

    def onCheckpointSaved(self, model, path, iteration):
        self._saves.inc()

    def onCheckpointRestored(self, model, path, iteration):
        self._restores.inc()


class ResilienceListener(TrainingListener):
    """Collects the resilience event stream (skipped steps, checkpoint
    saves, restores) in memory — the assertion surface for the fault
    matrix, and a cheap ops signal ('how often does this run skip?').
    Events are (kind, iteration, detail) tuples, oldest first."""

    def __init__(self):
        self.events = []
        self.skippedSteps = 0
        self.saves = 0
        self.restores = 0

    def onStepSkipped(self, model, iteration, epoch, loss):
        self.skippedSteps += 1
        self.events.append(("skip", iteration, loss))

    def onCheckpointSaved(self, model, path, iteration):
        self.saves += 1
        self.events.append(("save", iteration, path))

    def onCheckpointRestored(self, model, path, iteration):
        self.restores += 1
        self.events.append(("restore", iteration, path))


class NanScoreWatcher(TrainingListener):
    """Failure detection: raise as soon as the loss goes NaN/Inf
    (reference analogue: FailureTestingListener / the workspace NaN panics).
    Catches divergence at the iteration it happens instead of after a full
    wasted epoch."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            s = model.score()
            if not math.isfinite(s):
                raise FloatingPointError(
                    f"non-finite training score {s} at iteration {iteration} "
                    f"(epoch {epoch})")
