"""Dropout strategies, and the key a training step draws them from.

The counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``: ``IDropout``,
``Dropout``, ``GaussianDropout``, ``GaussianNoise``, ``AlphaDropout``,
``SpatialDropout`` and ``resolve``. A layer's ``dropOut=`` takes a float
(the RETAIN probability, as the reference reads it; 0.0 and 1.0 mean no
dropout) or one of these objects; ``GaussianDropout(rate)`` takes the
DROP rate.

Each strategy splits into ``draw(x, gen)``, the random tensor (a keep
mask or a noise tensor, in the port's NCHW-logical layout), and
``combine(x, r)``, the reference's formula over it; ``apply(x, key)`` is
the two. A test that injects the reference's mask calls ``combine``.

``StepKey`` takes the place of the reference's folded ``jax.random`` key:
a tuple of integers, ``(seed ^ 0x5EED, iteration)`` for a step, to which
the data-parallel trainers append the rank and the networks the layer's
index (``fold``), as the reference folds its key. ``generator(device)``
seeds a fresh ``torch.Generator`` on the device from a fixed integer mix
of the tuple (SplitMix64), on the host, so a draw never reads the card
and never touches the global generator; a forward recomputed under a
checkpoint policy draws the same mask again. JAX's threefry and torch's
Philox never agree, so the port's masks differ from the reference's:
parity holds under an injected mask.
"""

from __future__ import annotations

import torch

__all__ = ["StepKey", "IDropout", "Dropout", "GaussianDropout",
           "GaussianNoise", "AlphaDropout", "SpatialDropout", "resolve",
           "step_key"]

_MASK64 = (1 << 64) - 1


def _splitmix64(z):
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class StepKey:
    """The source of one draw's randomness: a tuple of integers."""

    __slots__ = ("ints",)

    def __init__(self, *ints):
        self.ints = tuple(int(i) for i in ints)

    def fold(self, i):
        """A key for a sub-stream (a layer, a rank, a direction)."""
        return StepKey(*self.ints, i)

    def seed(self) -> int:
        """A 63-bit seed mixed from the tuple, on the host."""
        h = 0
        for i in self.ints:
            h = _splitmix64(h ^ (i & _MASK64))
        return h >> 1

    def generator(self, device) -> torch.Generator:
        """A fresh generator on `device`, seeded from the tuple."""
        g = torch.Generator(device=device)
        g.manual_seed(self.seed())
        return g

    def __repr__(self):
        return f"StepKey{self.ints}"


def step_key(seed, iteration, rank=None):
    """A training step's key (reference: ``fold_in(key(seed ^ 0x5EED),
    iteration)``, and the rank under data parallelism)."""
    k = StepKey(int(seed) ^ 0x5EED, iteration)
    return k if rank is None else k.fold(rank)


def _keep_mask(shape, p, gen, device):
    return torch.rand(shape, generator=gen, device=device) < p


class IDropout:
    def draw(self, x, gen):
        raise NotImplementedError

    def combine(self, x, r):
        raise NotImplementedError

    def apply(self, x, key):
        return self.combine(x, self.draw(x, key.generator(x.device)))


class Dropout(IDropout):
    """Inverted dropout with retain probability p (reference: Dropout)."""

    def __init__(self, p=0.5):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"retain probability must be in (0,1], got {p}")
        self.p = float(p)

    def apply(self, x, key):
        if self.p == 1.0:
            return x
        return super().apply(x, key)

    def draw(self, x, gen):
        return _keep_mask(x.shape, self.p, gen, x.device)

    def combine(self, x, keep):
        return torch.where(keep, x / self.p, 0.0)


class GaussianDropout(IDropout):
    """Multiplicative N(1, sqrt(rate/(1-rate))) noise, `rate` the DROP
    rate (reference: GaussianDropout)."""

    def __init__(self, rate=0.5):
        if not 0.0 < rate < 1.0:
            raise ValueError(f"rate must be in (0,1), got {rate}")
        self.rate = float(rate)

    def draw(self, x, gen):
        return torch.randn(x.shape, generator=gen, device=x.device,
                           dtype=x.dtype)

    def combine(self, x, noise):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * noise)


class GaussianNoise(IDropout):
    """Additive N(0, stddev) noise (reference: GaussianNoise)."""

    def __init__(self, stddev=0.1):
        self.stddev = float(stddev)

    def draw(self, x, gen):
        return torch.randn(x.shape, generator=gen, device=x.device,
                           dtype=x.dtype)

    def combine(self, x, noise):
        return x + self.stddev * noise


class AlphaDropout(IDropout):
    """SELU-preserving dropout (reference: AlphaDropout): dropped units
    go to alpha' = -scale * alpha, then the affine correction a·y + b."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def __init__(self, p=0.5):
        if not 0.0 < p < 1.0:
            raise ValueError(f"retain probability must be in (0,1), got {p}")
        self.p = float(p)
        self.alphaPrime = -self._SCALE * self._ALPHA
        q = self.p
        self.a = (q + self.alphaPrime ** 2 * q * (1 - q)) ** -0.5
        self.b = -self.a * self.alphaPrime * (1 - q)

    def draw(self, x, gen):
        return _keep_mask(x.shape, self.p, gen, x.device)

    def combine(self, x, keep):
        y = torch.where(keep, x, torch.tensor(self.alphaPrime, dtype=x.dtype,
                                              device=x.device))
        return self.a * y + self.b


class SpatialDropout(IDropout):
    """Drop whole channels (reference: SpatialDropout): one keep draw
    per (sample, channel), [B,C,1,1] for 4-d, [B,C,1] for NCW 3-d and
    [B,C,1,1,1] for 5-d activations; 2-d falls back to plain dropout."""

    def __init__(self, p=0.5):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"retain probability must be in (0,1], got {p}")
        self.p = float(p)

    def apply(self, x, key):
        if self.p == 1.0:
            return x
        return super().apply(x, key)

    def draw(self, x, gen):
        if x.dim() in (3, 4, 5):
            shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
        else:
            shape = tuple(x.shape)
        return _keep_mask(shape, self.p, gen, x.device)

    def combine(self, x, keep):
        return torch.where(keep, x / self.p, 0.0)


def resolve(d):
    """float|IDropout|None -> IDropout|None (a float is the retain
    probability; 0.0 and 1.0 mean none)."""
    if d is None or isinstance(d, IDropout):
        return d
    p = float(d)
    if p in (0.0, 1.0):
        return None
    return Dropout(p)
