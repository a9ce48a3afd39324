"""Early stopping.

Reference: org.deeplearning4j.earlystopping — EarlyStoppingConfiguration,
EarlyStoppingTrainer / EarlyStoppingGraphTrainer, termination conditions
(MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition,
BestScoreEpochTerminationCondition, MaxScoreIterationTerminationCondition,
MaxTimeIterationTerminationCondition), ScoreCalculator
(DataSetLossCalculator), and EarlyStoppingModelSaver
(InMemoryModelSaver / LocalFileModelSaver).

The counterpart of ``deeplearning4j_tpu/optimize/earlystopping.py``.
The port's networks update their parameters in place, so
``InMemoryModelSaver`` keeps a ``clone()`` (a device copy of params,
layer states, updater state and counters), not references.
``EarlyStoppingParallelTrainer`` waits for the rest of the data-parallel
slice (ROADMAP.md Queue 1 item 7) and raises naming it.
"""

from __future__ import annotations

import enum
import os
import time


class TerminationReason(enum.Enum):
    EpochTerminationCondition = "EpochTerminationCondition"
    IterationTerminationCondition = "IterationTerminationCondition"
    Error = "Error"


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------

class MaxEpochsTerminationCondition:
    def __init__(self, maxEpochs: int):
        self.maxEpochs = int(maxEpochs)

    def initialize(self):
        pass

    def terminate(self, epochNum: int, score: float, minimize: bool) -> bool:
        return epochNum + 1 >= self.maxEpochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.maxEpochs})"


class ScoreImprovementEpochTerminationCondition:
    """Stop when no score improvement for N consecutive epochs."""

    def __init__(self, maxEpochsWithNoImprovement: int, minImprovement: float = 0.0):
        self.maxEpochs = int(maxEpochsWithNoImprovement)
        self.minImprovement = float(minImprovement)
        self._best = None
        self._noImprove = 0

    def initialize(self):
        self._best = None
        self._noImprove = 0

    def terminate(self, epochNum, score, minimize):
        if self._best is None:
            self._best = score
            return False
        improvement = (self._best - score) if minimize else (score - self._best)
        if improvement > self.minImprovement:
            self._best = score
            self._noImprove = 0
        else:
            self._noImprove += 1
        return self._noImprove >= self.maxEpochs

    def __str__(self):
        return (f"ScoreImprovementEpochTerminationCondition({self.maxEpochs}, "
                f"minImprovement={self.minImprovement})")


class BestScoreEpochTerminationCondition:
    """Stop once the score is at least as good as a target value."""

    def __init__(self, bestExpectedScore: float):
        self.bestExpectedScore = float(bestExpectedScore)

    def initialize(self):
        pass

    def terminate(self, epochNum, score, minimize):
        return score <= self.bestExpectedScore if minimize else score >= self.bestExpectedScore

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.bestExpectedScore})"


class MaxScoreIterationTerminationCondition:
    """Abort mid-epoch if the score explodes past a ceiling."""

    def __init__(self, maxScore: float):
        self.maxScore = float(maxScore)

    def initialize(self):
        pass

    def terminate(self, lastMiniBatchScore: float) -> bool:
        import math

        return lastMiniBatchScore > self.maxScore or not math.isfinite(lastMiniBatchScore)

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.maxScore})"


class MaxTimeIterationTerminationCondition:
    def __init__(self, maxTime: float, unit: str = "seconds"):
        mult = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0}[unit]
        self.maxSeconds = float(maxTime) * mult
        self._start = None

    def initialize(self):
        self._start = time.perf_counter()

    def terminate(self, lastMiniBatchScore: float) -> bool:
        return (time.perf_counter() - self._start) >= self.maxSeconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.maxSeconds}s)"


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------

class DataSetLossCalculator:
    """Held-out loss, averaged over the iterator, weighted by batch size
    (reference: earlystopping.scorecalc.DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculateScore(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        while self.iterator.hasNext():
            ds = self.iterator.next()
            bs = ds.numExamples()
            total += model.score(ds) * bs
            n += bs
        if n == 0:
            return float("nan")
        return total / n if self.average else total

    def minimizeScore(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# model savers
# ---------------------------------------------------------------------------

class InMemoryModelSaver:
    """Keep the best/latest model in memory as ``clone()``s: device copies
    of the parameters, layer states, updater state and counters, which
    the next in-place training step cannot touch."""

    def __init__(self):
        self._best = None
        self._latest = None

    def saveBestModel(self, model, score):
        self._best = model.clone()

    def saveLatestModel(self, model, score):
        self._latest = model.clone()

    def getBestModel(self):
        return self._best

    def getLatestModel(self):
        return self._latest


class LocalFileModelSaver:
    """Persist best/latest model zips under a directory
    (reference: earlystopping.saver.LocalFileModelSaver)."""

    def __init__(self, directory):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._device = None   # restores onto the saved model's device

    def _path(self, name):
        return os.path.join(self.directory, name)

    def _write(self, model, name):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        self._device = model.device
        ModelSerializer.writeModel(model, self._path(name), saveUpdater=True)

    def saveBestModel(self, model, score):
        self._write(model, "bestModel.npz")

    def saveLatestModel(self, model, score):
        self._write(model, "latestModel.npz")

    def _restore(self, name):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        path = self._path(name)
        if not os.path.exists(path):
            return None
        return ModelSerializer.restore(path, device=self._device)

    def getBestModel(self):
        return self._restore("bestModel.npz")

    def getLatestModel(self):
        return self._restore("latestModel.npz")


# ---------------------------------------------------------------------------
# configuration + result
# ---------------------------------------------------------------------------

class EarlyStoppingConfiguration:
    """Builder-style config (reference:
    earlystopping.EarlyStoppingConfiguration.Builder)."""

    class Builder:
        def __init__(self):
            self._epochConds = []
            self._iterConds = []
            self._scoreCalc = None
            self._saver = InMemoryModelSaver()
            self._evalEveryN = 1
            self._saveLastModel = False

        def epochTerminationConditions(self, *conds):
            self._epochConds = list(conds)
            return self

        def iterationTerminationConditions(self, *conds):
            self._iterConds = list(conds)
            return self

        def scoreCalculator(self, calc):
            self._scoreCalc = calc
            return self

        def modelSaver(self, saver):
            self._saver = saver
            return self

        def evaluateEveryNEpochs(self, n: int):
            self._evalEveryN = max(1, int(n))
            return self

        def saveLastModel(self, save: bool = True):
            self._saveLastModel = save
            return self

        def build(self):
            return EarlyStoppingConfiguration(self)

    def __init__(self, b: "EarlyStoppingConfiguration.Builder"):
        self.epochTerminationConditions = b._epochConds
        self.iterationTerminationConditions = b._iterConds
        self.scoreCalculator = b._scoreCalc
        self.modelSaver = b._saver
        self.evaluateEveryNEpochs = b._evalEveryN
        self.saveLastModel = b._saveLastModel


class EarlyStoppingResult:
    def __init__(self, terminationReason, terminationDetails, scoreVsEpoch,
                 bestModelEpoch, bestModelScore, totalEpochs, bestModel):
        self.terminationReason = terminationReason
        self.terminationDetails = terminationDetails
        self.scoreVsEpoch = scoreVsEpoch
        self.bestModelEpoch = bestModelEpoch
        self.bestModelScore = bestModelScore
        self.totalEpochs = totalEpochs
        self._bestModel = bestModel

    def getBestModel(self):
        return self._bestModel

    def __str__(self):
        return (f"EarlyStoppingResult(reason={self.terminationReason.value}, "
                f"details={self.terminationDetails}, epochs={self.totalEpochs}, "
                f"bestEpoch={self.bestModelEpoch}, bestScore={self.bestModelScore})")


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class _IterationGuard:
    """Listener bridging per-iteration termination conditions into fit()."""

    class Halt(Exception):
        def __init__(self, cond):
            self.cond = cond

    def __init__(self, conds):
        self.conds = conds

    def iterationDone(self, model, iteration, epoch):
        score = model.score()
        for c in self.conds:
            if c.terminate(score):
                raise _IterationGuard.Halt(c)

    def onEpochStart(self, model):
        pass

    def onEpochEnd(self, model):
        pass


class EarlyStoppingTrainer:
    """Epoch loop with score-based model selection
    (reference: earlystopping.trainer.EarlyStoppingTrainer).

    Works for MultiLayerNetwork and ComputationGraph alike — both expose
    fit(iterator)/score(ds); EarlyStoppingGraphTrainer is an alias kept for
    reference API parity.
    """

    def __init__(self, earlyStoppingConfiguration, model, trainData):
        self.conf = earlyStoppingConfiguration
        self.model = model
        self.trainData = trainData

    def fit(self) -> EarlyStoppingResult:
        conf = self.conf
        for c in conf.epochTerminationConditions:
            c.initialize()
        for c in conf.iterationTerminationConditions:
            c.initialize()

        minimize = (conf.scoreCalculator.minimizeScore()
                    if conf.scoreCalculator is not None else True)
        scoreVsEpoch = {}
        best_score, best_epoch = None, -1
        last_val_score = None
        epoch = 0
        reason, details = None, None

        guard = _IterationGuard(conf.iterationTerminationConditions)
        self.model.addListeners(guard)
        try:
            while True:
                try:
                    self.model.fit(self.trainData)
                except _IterationGuard.Halt as h:
                    reason = TerminationReason.IterationTerminationCondition
                    details = str(h.cond)
                    halt_cond = h.cond
                    break

                scored = True
                if conf.scoreCalculator is not None:
                    if epoch % conf.evaluateEveryNEpochs == 0:
                        score = conf.scoreCalculator.calculateScore(self.model)
                        scoreVsEpoch[epoch] = score
                        last_val_score = score
                        better = (best_score is None or
                                  (score < best_score if minimize else score > best_score))
                        if better:
                            best_score, best_epoch = score, epoch
                            conf.modelSaver.saveBestModel(self.model, score)
                    else:
                        # skipped-evaluation epoch: no new validation score.
                        # Carry the last one forward for reporting, but treat
                        # the epoch as unscored — the training minibatch loss
                        # is a different metric, and re-feeding a stale score
                        # would count fake no-improvement epochs.
                        score = last_val_score
                        scored = False
                else:
                    score = self.model.score()
                    scoreVsEpoch[epoch] = score

                if conf.saveLastModel:
                    conf.modelSaver.saveLatestModel(self.model, score)

                stop = None
                for c in conf.epochTerminationConditions:
                    # score-comparing conditions only run on epochs that
                    # produced a fresh score; epoch-count conditions always run
                    if not scored and not isinstance(c, MaxEpochsTerminationCondition):
                        continue
                    if c.terminate(epoch, score, minimize):
                        stop = c
                        break
                if stop is not None:
                    reason = TerminationReason.EpochTerminationCondition
                    details = str(stop)
                    break
                epoch += 1
        finally:
            # detach the guard so the model is reusable afterwards
            self.model._listeners = [l for l in self.model._listeners if l is not guard]

        if best_score is None:
            if reason == TerminationReason.IterationTerminationCondition and (
                    conf.scoreCalculator is not None
                    or isinstance(halt_cond, MaxScoreIterationTerminationCondition)):
                # halted on divergence/NaN before any validation pass: the
                # final state is the exploded one that triggered the halt —
                # never save it as "best". A pure time-budget halt
                # (MaxTimeIterationTerminationCondition) without a score
                # calculator is benign: fall through and keep the final model.
                return EarlyStoppingResult(reason, details, scoreVsEpoch, -1,
                                           None, epoch + 1, None)
            # no score calculator, epoch-condition or time-budget stop:
            # best = final
            conf.modelSaver.saveBestModel(self.model, scoreVsEpoch.get(epoch))
            best_epoch = epoch
            best_score = scoreVsEpoch.get(epoch)
        best = conf.modelSaver.getBestModel() or self.model
        return EarlyStoppingResult(reason, details, scoreVsEpoch, best_epoch,
                                   best_score, epoch + 1, best)


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """Reference API parity alias (earlystopping.trainer.EarlyStoppingGraphTrainer)."""


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over a data-parallel trainer (reference:
    EarlyStoppingParallelTrainer): waits for the rest of the
    data-parallel slice."""

    def __init__(self, earlyStoppingConfiguration, model, trainData,
                 wrapper=None, mesh=None, **wrapper_kw):
        raise NotImplementedError(
            "EarlyStoppingParallelTrainer waits for the rest of the "
            "data-parallel slice (ROADMAP.md Queue 1 item 7)")
