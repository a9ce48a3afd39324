"""Gradient updaters.

The counterpart of ``deeplearning4j_tpu/nn/updaters.py``: ``NoOp``,
``Sgd``, ``Nesterovs``, ``Adam``, ``AdamW``, ``AdaMax``, ``Nadam``,
``AMSGrad``, ``AdaGrad``, ``AdaDelta`` and ``RmsProp``. An updater works
on one layer's dict of gradients: ``init(params)`` makes its state, with
the reference's structure (so ``upd_to_reference`` carries it leaf by
leaf), and ``apply(grads, state, iteration)`` returns the updates to
SUBTRACT and the state, which it updates in place (the caller holds
``torch.no_grad()``).

Each is the reference's arithmetic as written, which is not always
``torch.optim``'s. Adam: ``lr * sqrt(1 - b2^t) / (1 - b1^t) * m /
(sqrt(v) + eps)``, the bias corrections folded into the step size, so ε
sits beside the uncorrected ``sqrt(v)`` (``torch.optim.Adam`` adds it to
the corrected ``sqrt(v_hat)``); AMSGrad the same over ``max(vhat, v)``;
AdamW adds ``lr * wd * p`` to Adam's update (decoupled decay); AdaMax
``lr / (1 - b1^t) * m / (u + eps)`` with ``u = max(b2 u, |g|)``; Nadam
the reference's look-ahead ``(b1 m + (1 - b1) g) / (1 - b1^(t+1))``
over ``sqrt(v / (1 - b2^t)) + eps``; AdaGrad ``lr g / (sqrt(h) + eps)``
with h the running sum of g²; AdaDelta ε inside both square roots;
RmsProp ``lr g / sqrt(h + eps)``, ε inside the root. Nesterovs:
``v = mu*v - lr*g`` and the update to subtract ``lr*g - mu*v`` (the new
v); ``torch.optim.SGD``'s nesterov form keeps its buffer with the other
sign and dampening.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn import schedules as _sched

__all__ = ["IUpdater", "NoOp", "Sgd", "Nesterovs", "Adam", "AdamW",
           "AdaMax", "Nadam", "AMSGrad", "AdaGrad", "AdaDelta", "RmsProp",
           "resolve"]


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


def _zeros(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


class AdamW(Adam):
    """Adam with decoupled weight decay (reference: AdamW): ``lr * wd *
    p`` is added to Adam's update, not folded into the gradient."""

    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weightDecay=0.01):
        super().__init__(learningRate, beta1, beta2, epsilon)
        self.weightDecay = float(weightDecay)

    def apply(self, grads, state, iteration, epoch=0, params=None):
        updates, state = super().apply(grads, state, iteration, epoch)
        if self.weightDecay:
            if params is None:
                raise ValueError(
                    "AdamW with weightDecay needs the current params: "
                    "call apply(..., params=params)")
            lr = self._lr(iteration, epoch)
            wd = self.weightDecay
            updates = {k: u + lr * wd * params[k] for k, u in updates.items()}
        return updates, state


class AdaMax(IUpdater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1, self.beta2, self.epsilon = \
            learningRate, beta1, beta2, epsilon

    def init(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        a = lr / (1 - b1 ** t)
        updates = {}
        for k, g in grads.items():
            m, u = state["m"][k], state["u"][k]
            m.mul_(b1).add_((1 - b1) * g)
            torch.maximum(b2 * u, g.abs(), out=u)
            updates[k] = a * m / (u + self.epsilon)
        return updates, state


class Nadam(IUpdater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1, self.beta2, self.epsilon = \
            learningRate, beta1, beta2, epsilon

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        updates = {}
        for k, g in grads.items():
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = (b1 * m + (1 - b1) * g) / (1 - b1 ** (t + 1))
            vhat = v / (1 - b2 ** t)
            updates[k] = lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return updates, state


class AMSGrad(IUpdater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1, self.beta2, self.epsilon = \
            learningRate, beta1, beta2, epsilon

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params),
                "vhat": _zeros(params)}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        a = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        updates = {}
        for k, g in grads.items():
            m, v, vh = state["m"][k], state["v"][k], state["vhat"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            torch.maximum(vh, v, out=vh)
            updates[k] = a * m / (torch.sqrt(vh) + self.epsilon)
        return updates, state


class AdaGrad(IUpdater):
    def __init__(self, learningRate=0.1, epsilon=1e-6):
        self.learningRate, self.epsilon = learningRate, epsilon

    def init(self, params):
        return _zeros(params)

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        updates = {}
        for k, g in grads.items():
            h = state[k]
            h.add_(g * g)
            updates[k] = lr * g / (torch.sqrt(h) + self.epsilon)
        return updates, state


class AdaDelta(IUpdater):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon
        self.learningRate = 1.0  # AdaDelta has no lr

    def init(self, params):
        return {"g2": _zeros(params), "dx2": _zeros(params)}

    def apply(self, grads, state, iteration, epoch=0, params=None):
        rho, eps = self.rho, self.epsilon
        updates = {}
        for k, g in grads.items():
            g2, dx2 = state["g2"][k], state["dx2"][k]
            g2.mul_(rho).add_((1 - rho) * g * g)
            dx = g * torch.sqrt(dx2 + eps) / torch.sqrt(g2 + eps)
            dx2.mul_(rho).add_((1 - rho) * dx * dx)
            updates[k] = dx
        return updates, state


class RmsProp(IUpdater):
    def __init__(self, learningRate=0.1, rmsDecay=0.95, epsilon=1e-8):
        self.learningRate, self.rmsDecay, self.epsilon = \
            learningRate, rmsDecay, epsilon

    def init(self, params):
        return _zeros(params)

    def apply(self, grads, state, iteration, epoch=0, params=None):
        lr = self._lr(iteration, epoch)
        d = self.rmsDecay
        updates = {}
        for k, g in grads.items():
            h = state[k]
            h.mul_(d).add_((1 - d) * g * g)
            updates[k] = lr * g / torch.sqrt(h + self.epsilon)
        return updates, state


def resolve(u) -> IUpdater:
    if isinstance(u, IUpdater):
        return u
    if isinstance(u, str):
        table = {
            "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "nadam": Nadam,
            "amsgrad": AMSGrad, "adagrad": AdaGrad, "adadelta": AdaDelta,
            "adamw": AdamW, "rmsprop": RmsProp, "nesterovs": Nesterovs,
            "noop": NoOp,
        }
        if u.lower() in table:
            return table[u.lower()]()
    raise ValueError(f"Cannot resolve updater from {u!r}")
