"""The random numbers a fit takes, behind one seam.

The word-vector, clustering, graph and t-SNE entry points take every
random number they use from a ``Draws``: the initial tables, each
epoch's permutation, each step's negative samples, a first centre, a
projection, a starting embedding. A draw is named (``what``, e.g.
``"word2vec.W"``) and indexed (an epoch, a step's first example), so a
provider can compute it from the name alone. Three providers:

* ``Draws(seed, device)``: a ``torch.Generator`` on the fit's device
  (Philox on the card, mt19937 on the CPU), drawn in call order;
* ``Draws(seed, device, record=True)``: the same, keeping a CPU copy of
  every draw in ``log``;
* ``ReplayDraws(log, device)``: another run's draws in their order, so
  the card and the CPU can take the same steps.

A test subclasses ``Draws`` to hand a fit the reference's own numbers
(its threefry keys are not torch's), as ``data/augment.py`` splits a
transform's draws from their application.
"""

from __future__ import annotations

import torch

__all__ = ["Draws", "ReplayDraws"]


class Draws:
    """Named draws from a ``torch.Generator`` on `device`."""

    def __init__(self, seed=0, device="cpu", record=False):
        self.device = torch.device(device)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self.log = [] if record else None

    def _keep(self, kind, what, t):
        if self.log is not None:
            self.log.append((kind, what, t.detach().cpu().clone()))
        return t

    def uniform(self, what, shape, *index):
        """f32 in [0, 1)."""
        return self._keep("uniform", what, torch.rand(
            tuple(shape), generator=self._gen, device=self.device))

    def normal(self, what, shape, *index):
        """f32 standard normal."""
        return self._keep("normal", what, torch.randn(
            tuple(shape), generator=self._gen, device=self.device))

    def permutation(self, what, n, *index):
        """int64 permutation of range(n)."""
        return self._keep("permutation", what, torch.randperm(
            int(n), generator=self._gen, device=self.device))

    def choice(self, what, probs, shape, *index):
        """int64 indices of `shape` drawn with replacement from the
        categorical `probs` (a 1-d tensor on the device)."""
        n = 1
        for s in shape:
            n *= int(s)
        idx = torch.multinomial(probs, n, replacement=True,
                                generator=self._gen)
        return self._keep("choice", what, idx.reshape(tuple(shape)))

    def randint(self, what, high, *index):
        """One int in [0, high) (read on the host)."""
        t = torch.randint(int(high), (), generator=self._gen,
                          device=self.device)
        return int(self._keep("randint", what, t))


class ReplayDraws(Draws):
    """The draws of another run (its ``Draws(record=True).log``), in
    order, on `device`. A draw asked for out of order raises."""

    def __init__(self, log, device="cpu"):
        self.device = torch.device(device)
        self._log = list(log)
        self._i = 0
        self.log = None

    def _next(self, kind, what):
        if self._i >= len(self._log):
            raise RuntimeError(f"replay: no draw left for {what}")
        k, w, t = self._log[self._i]
        if (k, w) != (kind, what):
            raise RuntimeError(f"replay: draw {self._i} is {k} {w}, "
                               f"asked for {kind} {what}")
        self._i += 1
        return t.to(self.device)

    def uniform(self, what, shape, *index):
        return self._next("uniform", what)

    def normal(self, what, shape, *index):
        return self._next("normal", what)

    def permutation(self, what, n, *index):
        return self._next("permutation", what)

    def choice(self, what, probs, shape, *index):
        return self._next("choice", what)

    def randint(self, what, high, *index):
        return int(self._next("randint", what))
