"""Weight noise: DropConnect and additive or multiplicative noise.

The counterpart of ``deeplearning4j_tpu/nn/conf/weightnoise.py``
(reference: IWeightNoise): a layer's WEIGHTS, not its activations, are
perturbed in each training forward; inference uses the clean weights.
The noisy weights are a function of the params and the step's key, so
autograd carries the gradient through the perturbation to the clean
master weights.

A layer's params are one flat dict (a wrapper's nested names dotted:
``"fwd.W"``); ``_weight_leaves`` walks them in the reference's leaf
order (its sorted walk of the nested dict). Biases are skipped unless ``applyToBias``; class
centers and PReLU's alpha never take noise. As with dropout, each
strategy splits into ``draw(v, key)`` (the random tensor, from a fresh
generator seeded from `key`) and ``combine(v, r)`` (the reference's
formula); leaf i of a layer draws from the layer's key folded with i, as
the reference folds its key, so a fitDataSet block, a resumed run and
``fit`` draw the same noise. JAX's threefry and torch's Philox never
agree: parity holds under injected draws (a test's ``draw`` reads the
reference's from the key's integers).
"""

from __future__ import annotations

import torch

__all__ = ["IWeightNoise", "DropConnect", "WeightNoise"]

#: the names that are not weights (reference: Layer._NON_WEIGHT_PARAMS)
_NON_WEIGHT = frozenset({"b", "beta", "centers", "alpha", "vb"})
#: true bias vectors among them: only these take noise under applyToBias
_TRUE_BIASES = frozenset({"b", "beta", "vb"})


def _weight_leaves(params):
    """(index, flat name, leaf name, tensor) over a layer's flat params in
    the reference's sorted walk of the nested dict."""
    names = sorted(params, key=lambda k: tuple(k.split(".")))
    for i, k in enumerate(names):
        yield i, k, k.rsplit(".", 1)[-1], params[k]


class IWeightNoise:
    applyToBias = False

    def draw(self, v, key):
        raise NotImplementedError

    def combine(self, v, r):
        raise NotImplementedError

    def apply(self, params: dict, key) -> dict:
        """One layer's params (compute dtype) perturbed; `key` is the
        layer's ``dropout.StepKey`` for weight noise."""
        repl = {}
        for i, name, leaf, v in _weight_leaves(params):
            if not v.is_floating_point():
                continue
            if leaf in _NON_WEIGHT and not (self.applyToBias
                                            and leaf in _TRUE_BIASES):
                continue
            repl[name] = self.combine(v, self.draw(v, key.fold(i)))
        return {**params, **repl}


class DropConnect(IWeightNoise):
    """Each weight kept with probability p and scaled by 1/p, else zero
    (reference: weightnoise.DropConnect(weightRetainProb))."""

    def __init__(self, weightRetainProb, applyToBias=False):
        if not (0.0 < weightRetainProb <= 1.0):
            raise ValueError(
                f"weightRetainProb must be in (0,1], got {weightRetainProb}")
        self.p = float(weightRetainProb)
        self.applyToBias = bool(applyToBias)

    def draw(self, v, key):
        return torch.rand(v.shape, generator=key.generator(v.device),
                          device=v.device) < self.p

    def combine(self, v, keep):
        return torch.where(keep, v / self.p, torch.zeros_like(v)).to(v.dtype)

    def apply(self, params, key):
        return params if self.p == 1.0 else super().apply(params, key)


class WeightNoise(IWeightNoise):
    """Noise from a distribution added to the weights, or multiplied in
    (reference: weightnoise.WeightNoise(Distribution, applyToBias,
    additive)); `distribution` is an ``nn.weights`` NormalDistribution or
    UniformDistribution."""

    def __init__(self, distribution, applyToBias=False, additive=True):
        self.distribution = distribution
        self.applyToBias = bool(applyToBias)
        self.additive = bool(additive)

    def draw(self, v, key):
        d, gen = self.distribution, key.generator(v.device)
        if hasattr(d, "std"):
            r = torch.randn(v.shape, generator=gen, device=v.device)
            return (d.mean + d.std * r).to(v.dtype)
        r = torch.rand(v.shape, generator=gen, device=v.device)
        return (d.lower + (d.upper - d.lower) * r).to(v.dtype)

    def combine(self, v, n):
        return (v + n if self.additive else v * n).to(v.dtype)
