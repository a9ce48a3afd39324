"""Hyperparameter spaces.

The counterpart of ``deeplearning4j_tpu/arbiter/spaces.py``, copied.
Reference: org.deeplearning4j.arbiter.optimize.parameter —
ContinuousParameterSpace, DiscreteParameterSpace, IntegerParameterSpace.
Each space can draw a random sample or enumerate a grid discretization.
"""

from __future__ import annotations

import math

import numpy as np


class ParameterSpace:
    def sample(self, rng: np.random.RandomState):
        raise NotImplementedError

    def grid(self, n: int) -> list:
        """n representative values for grid search."""
        raise NotImplementedError

    def from_unit(self, u: float):
        """Decode a unit-interval coordinate u to a value; u is clamped
        to [0, 1] (mutation/crossover arithmetic can overshoot).

        The genetic generator represents every candidate as a genome of
        unit coordinates (one per space) so crossover/mutation are
        space-agnostic; each space owns its decode (reference analog:
        arbiter's genetic ChromosomeFactory over double[] genes)."""
        raise NotImplementedError

    @staticmethod
    def _clamp_unit(u):
        return min(max(float(u), 0.0), 1.0)


class ContinuousParameterSpace(ParameterSpace):
    """Uniform (or log-uniform) float range."""

    def __init__(self, minValue: float, maxValue: float, log: bool = False):
        if log and minValue <= 0:
            raise ValueError("log-scale space needs minValue > 0")
        self.min = float(minValue)
        self.max = float(maxValue)
        self.log = log

    def sample(self, rng):
        if self.log:
            return float(math.exp(rng.uniform(math.log(self.min), math.log(self.max))))
        return float(rng.uniform(self.min, self.max))

    def grid(self, n):
        if n == 1:
            if self.log:  # geometric mean is the log-scale center
                return [float(math.sqrt(self.min * self.max))]
            return [0.5 * (self.min + self.max)]
        if self.log:
            return [float(v) for v in np.geomspace(self.min, self.max, n)]
        return [float(v) for v in np.linspace(self.min, self.max, n)]

    def from_unit(self, u):
        u = self._clamp_unit(u)
        if self.log:
            return float(math.exp(math.log(self.min)
                                  + u * (math.log(self.max)
                                         - math.log(self.min))))
        return float(self.min + u * (self.max - self.min))


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, *values):
        if len(values) == 1 and isinstance(values[0], (list, tuple)):
            values = tuple(values[0])
        self.values = list(values)

    def sample(self, rng):
        return self.values[rng.randint(0, len(self.values))]

    def grid(self, n):
        return list(self.values)

    def from_unit(self, u):
        # u == 1.0 maps to the last value, not one past it
        u = self._clamp_unit(u)
        return self.values[min(int(u * len(self.values)),
                               len(self.values) - 1)]


class IntegerParameterSpace(ParameterSpace):
    """Uniform integer range, inclusive on both ends."""

    def __init__(self, minValue: int, maxValue: int):
        self.min = int(minValue)
        self.max = int(maxValue)

    def sample(self, rng):
        return int(rng.randint(self.min, self.max + 1))

    def grid(self, n):
        if n >= self.max - self.min + 1:
            return list(range(self.min, self.max + 1))
        return [int(round(v)) for v in np.linspace(self.min, self.max, n)]

    def from_unit(self, u):
        u = self._clamp_unit(u)
        span = self.max - self.min + 1
        return int(self.min + min(int(u * span), span - 1))
