"""Learning-rate (and generic hyperparameter) schedules.

The counterpart of ``deeplearning4j_tpu/nn/schedules.py``: so far the
fixed schedule and ``resolve``, which the updaters read their learning
rate through. The other schedules wait for the nn-conf slice
(ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

__all__ = ["ScheduleType", "ISchedule", "FixedSchedule", "resolve"]


class ScheduleType:
    ITERATION = "iteration"
    EPOCH = "epoch"


class ISchedule:
    def valueAt(self, iteration, epoch=0):
        raise NotImplementedError

    def __call__(self, iteration, epoch=0):
        return self.valueAt(iteration, epoch)


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = value

    def valueAt(self, iteration, epoch=0):
        return self.value


def resolve(value_or_schedule):
    """A float or an ISchedule -> ISchedule."""
    if isinstance(value_or_schedule, ISchedule):
        return value_or_schedule
    return FixedSchedule(float(value_or_schedule))
