"""Global RNG for the factory layer.

The counterpart of ``deeplearning4j_tpu/ndarray/random.py``
(reference: ``Nd4j.getRandom()``). ``DefaultRandom`` is a stateful
facade over one ``torch.Generator`` per device, all seeded from the one
seed: ``setSeed`` reseeds them, and a draw advances the generator of the
device it lands on. ``seed=`` on a draw gives a fresh stream from that
seed, as the reference's ``_key(seed)`` does, and leaves the global
streams where they were.

Torch's Philox never agrees bitwise with the reference's threefry, and
the CPU and CUDA generators give different streams from the same seed:
draws are reproducible per device and are held to their distribution's
moments, not to the reference's values.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["DefaultRandom", "getRandom", "setSeed", "generator", "uniform",
           "normal", "bernoulli"]


class DefaultRandom:
    """Seeded per-device generators behind a stateful facade."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._gens: dict[str, torch.Generator] = {}

    def setSeed(self, seed: int) -> None:
        with self._lock:
            self._seed = int(seed)
            self._gens.clear()

    def getSeed(self) -> int:
        with self._lock:
            return self._seed

    def generator(self, device="cpu") -> torch.Generator:
        """The global stream of `device` (made from the seed on first
        use)."""
        dev = torch.device(device)
        key = str(dev if dev.index is not None or dev.type == "cpu"
                  else torch.device(dev.type, torch.cuda.current_device()))
        with self._lock:
            g = self._gens.get(key)
            if g is None:
                g = torch.Generator(device=key)
                g.manual_seed(self._seed)
                self._gens[key] = g
            return g

    def nextDouble(self) -> float:
        return float(torch.rand((), generator=self.generator(),
                                dtype=torch.float64))

    def nextGaussian(self) -> float:
        return float(torch.randn((), generator=self.generator(),
                                 dtype=torch.float64))

    def nextInt(self, bound: int) -> int:
        return int(torch.randint(0, int(bound), (),
                                 generator=self.generator()))


_global = DefaultRandom(0)


def getRandom() -> DefaultRandom:
    return _global


def setSeed(seed: int) -> None:
    _global.setSeed(seed)


def generator(device, seed=None) -> torch.Generator:
    """A fresh generator from `seed`, or the global stream of `device`."""
    if seed is None:
        return _global.generator(device)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def uniform(shape, dtype, minval=0.0, maxval=1.0, seed=None,
            device="cpu") -> torch.Tensor:
    g = generator(device, seed)
    if not (dtype.is_floating_point):
        if int(maxval) - int(minval) <= 1:
            raise ValueError(
                "uniform with an integer dtype needs explicit integer bounds "
                f"(got minval={minval}, maxval={maxval}); the float defaults "
                "would yield a constant array"
            )
        return torch.randint(int(minval), int(maxval), tuple(shape),
                             generator=g, dtype=dtype, device=device)
    u = torch.rand(tuple(shape), generator=g, dtype=dtype, device=device)
    if minval == 0.0 and maxval == 1.0:
        return u
    return u * (maxval - minval) + minval


def normal(shape, dtype, mean=0.0, std=1.0, seed=None,
           device="cpu") -> torch.Tensor:
    z = torch.randn(tuple(shape), generator=generator(device, seed),
                    dtype=dtype, device=device)
    return mean + std * z


def bernoulli(shape, p, dtype, seed=None, device="cpu") -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator(device, seed),
                   device=device)
    return (u < p).to(dtype)
