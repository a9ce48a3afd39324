"""Learning-rate (and generic hyperparameter) schedules.

The counterpart of ``deeplearning4j_tpu/nn/schedules.py``: the fixed,
step, exponential, inverse, poly, sigmoid, map and 1cycle schedules, by
iteration or by epoch, and ``resolve``, which the updaters read their
learning rate through. The reference evaluates a schedule inside the
jitted step on a traced counter; the port's counters live on the host,
so ``valueAt`` is the same formula in Python floats.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ScheduleType", "ISchedule", "FixedSchedule", "StepSchedule",
           "ExponentialSchedule", "InverseSchedule", "PolySchedule",
           "SigmoidSchedule", "MapSchedule", "CycleSchedule", "resolve"]


class ScheduleType:
    ITERATION = "iteration"
    EPOCH = "epoch"


class ISchedule:
    def valueAt(self, iteration, epoch=0):
        raise NotImplementedError

    def __call__(self, iteration, epoch=0):
        return self.valueAt(iteration, epoch)

    def _at(self, iteration, epoch):
        return iteration if self.scheduleType == ScheduleType.ITERATION \
            else epoch


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = value

    def valueAt(self, iteration, epoch=0):
        return self.value


class StepSchedule(ISchedule):
    """value * decayRate^floor(i / step)"""

    def __init__(self, scheduleType, initialValue, decayRate, step):
        self.scheduleType, self.initialValue = scheduleType, initialValue
        self.decayRate, self.step = decayRate, step

    def valueAt(self, iteration, epoch=0):
        i = self._at(iteration, epoch)
        return self.initialValue * self.decayRate ** math.floor(i / self.step)


class ExponentialSchedule(ISchedule):
    """value * gamma^i"""

    def __init__(self, scheduleType, initialValue, gamma):
        self.scheduleType, self.initialValue, self.gamma = \
            scheduleType, initialValue, gamma

    def valueAt(self, iteration, epoch=0):
        return self.initialValue * self.gamma ** self._at(iteration, epoch)


class InverseSchedule(ISchedule):
    """value / (1 + gamma i)^power"""

    def __init__(self, scheduleType, initialValue, gamma, power):
        self.scheduleType, self.initialValue = scheduleType, initialValue
        self.gamma, self.power = gamma, power

    def valueAt(self, iteration, epoch=0):
        i = self._at(iteration, epoch)
        return self.initialValue / (1 + self.gamma * i) ** self.power


class PolySchedule(ISchedule):
    """value * (1 - min(i / maxIter, 1))^power"""

    def __init__(self, scheduleType, initialValue, power, maxIter):
        self.scheduleType, self.initialValue = scheduleType, initialValue
        self.power, self.maxIter = power, maxIter

    def valueAt(self, iteration, epoch=0):
        frac = min(max(self._at(iteration, epoch) / self.maxIter, 0.0), 1.0)
        return self.initialValue * (1 - frac) ** self.power


class SigmoidSchedule(ISchedule):
    """value / (1 + exp(gamma (i - stepSize)))"""

    def __init__(self, scheduleType, initialValue, gamma, stepSize):
        self.scheduleType, self.initialValue = scheduleType, initialValue
        self.gamma, self.stepSize = gamma, stepSize

    def valueAt(self, iteration, epoch=0):
        i = self._at(iteration, epoch)
        return self.initialValue / (1 + math.exp(self.gamma
                                                 * (i - self.stepSize)))


class MapSchedule(ISchedule):
    """Piecewise-constant values from given iterations or epochs on."""

    def __init__(self, scheduleType, values: dict):
        self.scheduleType = scheduleType
        self.points = sorted(values.items())
        if self.points[0][0] != 0:
            raise ValueError(
                "MapSchedule requires a value for iteration/epoch 0")

    def valueAt(self, iteration, epoch=0):
        i = self._at(iteration, epoch)
        v = self.points[0][1]
        for at, val in self.points[1:]:
            if i >= at:
                v = val
        # the reference selects among float32 values
        return float(np.float32(v))


class CycleSchedule(ISchedule):
    """The 1cycle schedule (reference: CycleSchedule): up from lr0 to
    lrMax, back down, then an annealing tail, every cycleLength."""

    def __init__(self, scheduleType, initialLearningRate, maxLearningRate,
                 cycleLength, annealingLength=None, annealingDecay=0.1):
        self.scheduleType = scheduleType
        self.lr0, self.lrMax = initialLearningRate, maxLearningRate
        self.cycleLength = cycleLength
        self.annealingLength = annealingLength or max(1, int(0.1
                                                             * cycleLength))
        self.annealingDecay = annealingDecay

    def valueAt(self, iteration, epoch=0):
        i = self._at(iteration, epoch)
        up = (self.cycleLength - self.annealingLength) / 2
        pos = i % self.cycleLength
        if pos < up:
            return self.lr0 + (self.lrMax - self.lr0) * (pos / up)
        if pos < 2 * up:
            return self.lrMax - (self.lrMax - self.lr0) * ((pos - up) / up)
        anneal_pos = (pos - 2 * up) / max(self.annealingLength, 1)
        return self.lr0 * (1 - (1 - self.annealingDecay) * anneal_pos)


def resolve(value_or_schedule):
    """A float or an ISchedule -> ISchedule."""
    if isinstance(value_or_schedule, ISchedule):
        return value_or_schedule
    return FixedSchedule(float(value_or_schedule))
