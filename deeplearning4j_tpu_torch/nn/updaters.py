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

Hyperparameters as device scalars, for a captured step (``runtime.aot``):
``scalars(iteration, epoch)`` is the tuple of host floats an updater's
``apply`` reads at that iteration (the scheduled learning rate, Adam's
bias-corrected step size, ...), computed exactly as the eager path
computes them; ``apply(..., hp=...)`` reads them from 0-d tensors
instead (views of ``HyperScalars``' one device buffer, written with one
host-to-device copy a step), so a graph reads each step's values rather
than baking in the first. A tensor scalar of the parameter dtype
multiplies bitwise as the Python float does. A DIVISION by a Python
float on the card is a multiplication by its reciprocal (PyTorch's CUDA
``div`` takes that path for a host scalar), so ``HyperScalars`` stores
the reciprocal of a divisor (``_DIVISORS``) for a card buffer and
``_div`` multiplies; on the CPU it stores the divisor and divides. With
``hp=None`` nothing changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import schedules as _sched

__all__ = ["IUpdater", "NoOp", "Sgd", "Nesterovs", "Adam", "AdamW",
           "AdaMax", "Nadam", "AMSGrad", "AdaGrad", "AdaDelta", "RmsProp",
           "BiasSplit", "is_bias", "resolve", "HyperScalars"]


def _div(x, c):
    """x / c for a host divisor, or for a ``HyperScalars`` view (which
    holds the reciprocal on the card: module docstring)."""
    if isinstance(c, torch.Tensor) and c.device.type == "cuda":
        return x * c
    return x / c


class IUpdater:
    """Base updater over one layer's {name: tensor} gradients."""

    #: indices into ``scalars()`` that the update divides by
    _DIVISORS = ()

    def init(self, params):
        raise NotImplementedError

    def scalars(self, iteration, epoch=0):
        """The iteration's hyperparameters as host floats, in the order
        ``apply`` reads them (module docstring)."""
        return ()

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        """-> (updates_to_subtract, state); `hp` replaces ``scalars()``"""
        raise NotImplementedError

    def _hp(self, hp, iteration, epoch):
        return self.scalars(iteration, epoch) if hp is None else hp

    def _divisors(self):
        return self._DIVISORS

    def _lr(self, iteration, epoch):
        return _sched.resolve(self.learningRate).valueAt(iteration, epoch)


class HyperScalars:
    """One device buffer holding every updater's ``scalars()`` for a
    captured step; ``views(i)`` are updater i's 0-d views, ``write(it)``
    fills the buffer for iteration `it` with one host-to-device copy.
    `updaters` is a list (None for a layer with no update). The host side
    is pageable memory: CUDA stages a pageable source before the copy
    call returns, so the next step may rewrite it while this step's copy
    is still queued (a block of steps issues them back to back)."""

    def __init__(self, updaters, dtype, device):
        self._updaters = list(updaters)
        self._sizes = [0 if u is None else len(u.scalars(0))
                       for u in self._updaters]
        n = max(1, sum(self._sizes))
        cuda = torch.device(device).type == "cuda"
        self.host = torch.zeros(n, dtype=dtype)
        self.buffer = torch.zeros(n, dtype=dtype, device=device)
        self._cuda = cuda
        self._np = np.float64 if dtype == torch.float64 else np.float32
        self._views, o = [], 0
        for size in self._sizes:
            self._views.append(tuple(self.buffer[o + j]
                                     for j in range(size)))
            o += size

    def views(self, i):
        return self._views[i]

    def values(self, iteration, epoch=0):
        """The host values `write` copies (divisors as reciprocals on
        the card)."""
        out = []
        for u in self._updaters:
            if u is None:
                continue
            vals = list(u.scalars(iteration, epoch))
            if self._cuda:
                for j in u._divisors():
                    vals[j] = self._np(1.0) / self._np(vals[j])
            out.extend(vals)
        return out

    def write(self, iteration, epoch=0):
        vals = self.values(iteration, epoch)
        if vals:
            self.host[:len(vals)] = torch.tensor(vals, dtype=torch.float64)
            self.buffer.copy_(self.host, non_blocking=self._cuda)


class NoOp(IUpdater):
    def __init__(self):
        self.learningRate = 0.0

    def init(self, params):
        return ()

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


class Sgd(IUpdater):
    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate

    def init(self, params):
        return ()

    def scalars(self, iteration, epoch=0):
        return (self._lr(iteration, epoch),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (lr,) = self._hp(hp, iteration, epoch)
        return {k: lr * g for k, g in grads.items()}, state


class Nesterovs(IUpdater):
    def __init__(self, learningRate=0.1, momentum=0.9):
        self.learningRate, self.momentum = learningRate, momentum

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def scalars(self, iteration, epoch=0):
        return (self._lr(iteration, epoch),
                _sched.resolve(self.momentum).valueAt(iteration, epoch))

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        lr, mu = self._hp(hp, iteration, epoch)
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

    def scalars(self, iteration, epoch=0):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        return (lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (a,) = self._hp(hp, iteration, epoch)[:1]
        b1, b2 = self.beta1, self.beta2
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

    def scalars(self, iteration, epoch=0):
        return super().scalars(iteration, epoch) + (
            self._lr(iteration, epoch) * self.weightDecay,)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        hp = self._hp(hp, iteration, epoch)
        updates, state = super().apply(grads, state, iteration, epoch,
                                       hp=hp)
        if self.weightDecay:
            if params is None:
                raise ValueError(
                    "AdamW with weightDecay needs the current params: "
                    "call apply(..., params=params)")
            lrwd = hp[1]
            updates = {k: u + lrwd * params[k] for k, u in updates.items()}
        return updates, state


class AdaMax(IUpdater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1, self.beta2, self.epsilon = \
            learningRate, beta1, beta2, epsilon

    def init(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def scalars(self, iteration, epoch=0):
        t = int(iteration) + 1
        return (self._lr(iteration, epoch) / (1 - self.beta1 ** t),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (a,) = self._hp(hp, iteration, epoch)
        b1, b2 = self.beta1, self.beta2
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

    #: (1 - b1^(t+1)) and (1 - b2^t) divide
    _DIVISORS = (1, 2)

    def scalars(self, iteration, epoch=0):
        t = int(iteration) + 1
        return (self._lr(iteration, epoch), 1 - self.beta1 ** (t + 1),
                1 - self.beta2 ** t)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        lr, c1, c2 = self._hp(hp, iteration, epoch)
        b1, b2 = self.beta1, self.beta2
        updates = {}
        for k, g in grads.items():
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = _div(b1 * m + (1 - b1) * g, c1)
            vhat = _div(v, c2)
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

    def scalars(self, iteration, epoch=0):
        lr = self._lr(iteration, epoch)
        t = int(iteration) + 1
        b1, b2 = self.beta1, self.beta2
        return (lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (a,) = self._hp(hp, iteration, epoch)
        b1, b2 = self.beta1, self.beta2
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

    def scalars(self, iteration, epoch=0):
        return (self._lr(iteration, epoch),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (lr,) = self._hp(hp, iteration, epoch)
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

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
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

    def scalars(self, iteration, epoch=0):
        return (self._lr(iteration, epoch),)

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        (lr,) = self._hp(hp, iteration, epoch)
        d = self.rmsDecay
        updates = {}
        for k, g in grads.items():
            h = state[k]
            h.mul_(d).add_((1 - d) * g * g)
            updates[k] = lr * g / torch.sqrt(h + self.epsilon)
        return updates, state


#: the leaf names of bias vectors (an AutoEncoder's visible bias too)
_BIAS_LEAVES = ("b", "beta", "vb")


def is_bias(name) -> bool:
    """Whether a (dotted) parameter name is a bias."""
    return name.rsplit(".", 1)[-1] in _BIAS_LEAVES


class BiasSplit(IUpdater):
    """A layer's updater when it sets a ``biasUpdater`` (reference:
    Builder.biasUpdater): the biases step by ``bias`` with their own
    state. ``main`` runs over EVERY parameter, biases included, so its
    state keeps the reference's structure and a model file crosses to
    the reference (which steps the biases with ``main``); its bias
    updates are replaced by ``bias``'s. The state is ``{"main": ...,
    "bias": ...}``."""

    def __init__(self, main, bias):
        self.main, self.bias = main, bias

    def init(self, params):
        return {"main": self.main.init(params),
                "bias": self.bias.init(_biases(params))}

    def scalars(self, iteration, epoch=0):
        return (tuple(self.main.scalars(iteration, epoch))
                + tuple(self.bias.scalars(iteration, epoch)))

    def _divisors(self):
        n = len(self.main.scalars(0))
        return tuple(self.main._divisors()) + tuple(
            n + j for j in self.bias._divisors())

    def apply(self, grads, state, iteration, epoch=0, params=None,
              hp=None):
        n = len(self.main.scalars(iteration, epoch))
        hm, hb = (None, None) if hp is None else (hp[:n], hp[n:])
        upd, sm = self.main.apply(grads, state["main"], iteration, epoch,
                                  params=params, hp=hm)
        bupd, sb = self.bias.apply(
            _biases(grads), state["bias"], iteration, epoch,
            params=None if params is None else _biases(params), hp=hb)
        return {**upd, **bupd}, {"main": sm, "bias": sb}


def _biases(d):
    return {k: v for k, v in d.items() if is_bias(k)}


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
