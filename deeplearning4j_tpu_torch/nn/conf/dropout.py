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

Under a CUDA-graph capture (``runtime.aot``) a generator made on the host
would bake its seed into the graph, and every replay would draw the same
masks. ``DrawSites`` takes its place: the warm-up RECORDS each draw site
of the step (its key, whose second integer is the iteration), the
capture hands each site a generator registered with the graph, and
before every replay ``reseed(iteration)`` seeds each with the seed the
eager step would have made at that iteration. Philox reads its seed and
offset at launch, so a replay draws the eager step's masks bitwise. A
draw that takes ``StepKey.seed()`` itself (a SameDiff-defined layer's
stream) cannot be reseeded so, nor can a read of a tensor on the host:
``refuse`` raises ``aot.CaptureRefused`` with the reason, and the step is
not captured.
"""

from __future__ import annotations

import contextlib
import contextvars

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

    def _mix(self) -> int:
        h = 0
        for i in self.ints:
            h = _splitmix64(h ^ (i & _MASK64))
        return h >> 1

    def seed(self) -> int:
        """A 63-bit seed mixed from the tuple, on the host."""
        sites = _SITES.get()
        if sites is not None:
            sites.host_seed(self)
        return self._mix()

    def generator(self, device) -> torch.Generator:
        """A fresh generator on `device`, seeded from the tuple (under a
        capture, the draw site's registered generator)."""
        sites = _SITES.get()
        if sites is not None:
            return sites.generator(self, device)
        # meta tensors (the static analyzer's step) draw from the host
        dev = torch.device(device)
        g = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        g.manual_seed(self._mix())
        return g

    def __repr__(self):
        return f"StepKey{self.ints}"


_SITES = contextvars.ContextVar("draw_sites", default=None)


class DrawSites:
    """The draw sites of one captured step (module docstring)."""

    def __init__(self):
        self.sites = []         # each site's key integers, in draw order
        self._gens = []
        self._mode = None
        self._next = 0

    @contextlib.contextmanager
    def _active(self, mode):
        self._mode, self._next = mode, 0
        token = _SITES.set(self)
        try:
            yield self
        finally:
            _SITES.reset(token)
            self._mode = None

    def recording(self):
        """The warm-up: note each site, draw from a fresh generator."""
        self.sites = []
        return self._active("record")

    def capturing(self):
        """The capture: hand out the registered generators in order."""
        return self._active("capture")

    def describe(self):
        return ", ".join(f"key {k}" for k in self.sites)

    @staticmethod
    def refuse(reason):
        """Raise ``aot.CaptureRefused``: the step cannot be captured."""
        from deeplearning4j_tpu_torch.runtime.aot import CaptureRefused

        raise CaptureRefused(reason)

    def host_seed(self, key):
        self.refuse(f"the draw at key {key.ints} takes StepKey.seed() on "
                    "the host (a SameDiff-defined layer's stream), which a "
                    "graph would bake in")

    def generator(self, key, device):
        if self._mode == "record":
            self.sites.append(key.ints)
            g = torch.Generator(device=device)
            g.manual_seed(key._mix())
            return g
        i = self._next
        if i >= len(self._gens) or len(self.sites[i]) != len(key.ints):
            raise RuntimeError(
                f"the captured step drew at key {key.ints}, which its "
                "warm-up did not: the draws depend on host state")
        self._next += 1
        return self._gens[i]

    def bind(self, graph, device):
        """One generator per site, registered with `graph` (before the
        capture begins, as CUDA requires)."""
        self._gens = []
        for _ in self.sites:
            g = torch.Generator(device=device)
            graph.register_generator_state(g)
            self._gens.append(g)

    def reseed(self, iteration):
        """Seed every site as the eager step at `iteration` would."""
        for ints, g in zip(self.sites, self._gens):
            g.manual_seed(StepKey(ints[0], int(iteration),
                                  *ints[2:])._mix())


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
