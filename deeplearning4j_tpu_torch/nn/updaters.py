"""Gradient updaters.

The counterpart of ``deeplearning4j_tpu/nn/updaters.py`` for the SGD
family the port trains with so far: ``NoOp``, ``Sgd``, ``Nesterovs``
(ResNet50's default) and ``Adam``. An
updater works on one layer's dict of gradients: ``init(params)`` makes
its state, ``apply(grads, state, iteration)`` returns the updates to
SUBTRACT and the state, which it updates in place (the caller holds
``torch.no_grad()``).

Adam is the reference's update as written:
``lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``, with the
bias corrections folded into the step size, so ε sits beside the
uncorrected ``sqrt(v)``. ``torch.optim.Adam`` adds ε to the corrected
``sqrt(v_hat)`` instead, which is another update: it is not used here.
Nesterovs is the reference's as written: ``v = mu*v - lr*g`` and the
update to subtract ``lr*g - mu*v`` (the new v); ``torch.optim.SGD``'s
nesterov form keeps its buffer with the other sign and dampening. The
other updaters wait for the nn-primitives slice (ROADMAP.md Queue 1
item 3).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn import schedules as _sched

__all__ = ["IUpdater", "NoOp", "Sgd", "Nesterovs", "Adam", "resolve"]


class IUpdater:
    """Base updater over one layer's {name: tensor} gradients."""

    def init(self, params):
        raise NotImplementedError

    def apply(self, grads, state, iteration, epoch=0, params=None):
        """-> (updates_to_subtract, state)"""
        raise NotImplementedError

    def _lr(self, iteration, epoch):
        return _sched.resolve(self.learningRate).valueAt(iteration, epoch)


class NoOp(IUpdater):
    def __init__(self):
        self.learningRate = 0.0

    def init(self, params):
        return ()

    def apply(self, grads, state, iteration, epoch=0, params=None):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


class Sgd(IUpdater):
    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate

    def init(self, params):
        return ()

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        return {k: lr * g for k, g in grads.items()}, state


class Nesterovs(IUpdater):
    def __init__(self, learningRate=0.1, momentum=0.9):
        self.learningRate, self.momentum = learningRate, momentum

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        mu = _sched.resolve(self.momentum).valueAt(iteration, epoch)
        updates = {}
        for k, g in grads.items():
            v = state[k]
            v.mul_(mu).sub_(lr * g)
            updates[k] = lr * g - mu * v
        return updates, state


class Adam(IUpdater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1, self.beta2, self.epsilon = \
            learningRate, beta1, beta2, epsilon

    def init(self, params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        a = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        updates = {}
        for k, g in grads.items():
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            updates[k] = a * m / (torch.sqrt(v) + self.epsilon)
        return updates, state


def resolve(u) -> IUpdater:
    if isinstance(u, IUpdater):
        return u
    if isinstance(u, str):
        table = {"sgd": Sgd, "adam": Adam, "noop": NoOp,
                 "nesterovs": Nesterovs}
        if u.lower() in table:
            return table[u.lower()]()
        raise NotImplementedError(
            f"updater {u!r} waits for the nn-primitives slice (ROADMAP.md "
            "Queue 1 item 3); the port has sgd, nesterovs, adam and noop")
    raise ValueError(f"Cannot resolve updater from {u!r}")
