"""Parameter constraints, applied after each update step.

The counterpart of ``deeplearning4j_tpu/nn/conf/constraint.py``:
``MaxNormConstraint``, ``MinMaxNormConstraint``, ``NonNegativeConstraint``,
``UnitNormConstraint`` and ``apply_constraints``. The networks project a
layer's parameters through its constraints right after the updater's
step, in ``fit``, ``fitSteps`` and every ``fitDataSet`` block alike.

Norms are per output unit: over every axis of a parameter except its
OUTPUT axis. The reference keeps the output axis last in every layout
(dense ``[in, out]``, conv HWIO, conv1d ``[k, in, out]``) and reduces the
others; the port's convolution weights are torch's ``[out, in, ...]``
(a transposed convolution's ``[in, out, ...]``), so each layer names its
output axis (``Layer.output_axis``) and the norm runs over the rest. A
1-d parameter (a bias) is reduced over no axis at all: each element is
its own norm, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["BaseConstraint", "MaxNormConstraint", "MinMaxNormConstraint",
           "NonNegativeConstraint", "UnitNormConstraint",
           "apply_constraints"]

#: neither weights nor biases: class centers and PReLU's alpha keep their
#: own dynamics, so no constraint touches them
_OWN_DYNAMICS = ("centers", "alpha")
_BIASES = ("b", "beta", "vb")


class BaseConstraint:
    """Weights by default, as the reference's constrainWeights; the
    builder's constrainBias / constrainAllParameters set the flags."""

    def __init__(self, applyToWeights=True, applyToBiases=False):
        self.applyToWeights = applyToWeights
        self.applyToBiases = applyToBiases

    def appliesTo(self, name: str) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _OWN_DYNAMICS:
            return False
        return self.applyToBiases if leaf in _BIASES else self.applyToWeights

    def apply(self, p, out_axis=-1):
        raise NotImplementedError

    @staticmethod
    def _norms(p, out_axis):
        if p.dim() <= 1:
            return torch.sqrt(p.square() + 1e-12)
        axis = out_axis % p.dim()
        dims = [d for d in range(p.dim()) if d != axis]
        return torch.sqrt(p.square().sum(dim=dims, keepdim=True) + 1e-12)


class MaxNormConstraint(BaseConstraint):
    def __init__(self, maxNorm=2.0, **kw):
        super().__init__(**kw)
        self.maxNorm = float(maxNorm)

    def apply(self, p, out_axis=-1):
        n = self._norms(p, out_axis)
        return p * torch.clamp(self.maxNorm / n, max=1.0).to(p.dtype)


class MinMaxNormConstraint(BaseConstraint):
    """Per-output norms into [min, max] at an interpolation rate
    (reference: MinMaxNormConstraint; rate 1 snaps hard)."""

    def __init__(self, minNorm=0.0, maxNorm=2.0, rate=1.0, **kw):
        super().__init__(**kw)
        self.minNorm, self.maxNorm = float(minNorm), float(maxNorm)
        self.rate = float(rate)

    def apply(self, p, out_axis=-1):
        n = self._norms(p, out_axis)
        target = torch.clamp(n, self.minNorm, self.maxNorm)
        return (p * (1.0 + self.rate * (target / n - 1.0))).to(p.dtype)


class NonNegativeConstraint(BaseConstraint):
    def apply(self, p, out_axis=-1):
        return torch.clamp(p, min=0.0)


class UnitNormConstraint(BaseConstraint):
    def apply(self, p, out_axis=-1):
        return (p / self._norms(p, out_axis)).to(p.dtype)


def apply_constraints(layer, params):
    """Project one layer's {name: tensor} params through its constraint
    list in place (the caller holds ``torch.no_grad()``)."""
    cs = getattr(layer, "constraints", None)
    if not cs or not params:
        return params
    for c in cs:
        for name, p in params.items():
            if c.appliesTo(name):
                p.copy_(c.apply(p, layer.output_axis(name, p)))
    return params
