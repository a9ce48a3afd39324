"""Transforms — the elementwise transform op set as a static utility.

The counterpart of ``deeplearning4j_tpu/ndarray/transforms.py``
(reference: org.nd4j.linalg.ops.transforms.Transforms). Each function
takes an INDArray (or anything array-like: numpy data lands on the card
unless it comes as an INDArray or tensor on the CPU) and returns a new
INDArray on its input's device; each is one or a few eager torch calls
with the reference's arithmetic (GELU is the tanh form, HardSigmoid is
clip(0.2x + 0.5), IsMax is the one-hot of the first maximum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray, as_tensor

__all__ = ["Transforms"]


def _t(x):
    t = as_tensor(x)
    return t if (t.is_floating_point() or t.is_complex()) \
        else t.to(torch.get_default_dtype())


def _wrap1(fn):
    def op(x, *args, **kwargs):
        return INDArray(fn(_t(x), *args, **kwargs))
    return op


def _other(y, like):
    if isinstance(y, (int, float)):
        return y
    return as_tensor(y, like.device)


def _rows(x, dimensions):
    """[N, D] row view for the all-pairs distance family; only the row
    layout (vectors along dim 1, the upstream default) is supported."""
    a = _t(x)
    if a.ndim != 2:
        raise ValueError(f"all-distances expect 2-D [N, D] input, got "
                         f"shape {tuple(a.shape)}")
    if dimensions and tuple(dimensions) != (1,):
        raise ValueError("only dimensions=1 (vectors along rows) is "
                         "supported")
    return a


class Transforms:
    # ----- exponential / log ------------------------------------------
    exp = staticmethod(_wrap1(torch.exp))
    log = staticmethod(_wrap1(torch.log))
    log1p = staticmethod(_wrap1(torch.log1p))
    expm1 = staticmethod(_wrap1(torch.expm1))
    sqrt = staticmethod(_wrap1(torch.sqrt))
    cbrt = staticmethod(_wrap1(
        lambda a: torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)))
    reciprocal = staticmethod(_wrap1(lambda a: 1.0 / a))

    # ----- trig / hyperbolic ------------------------------------------
    sin = staticmethod(_wrap1(torch.sin))
    cos = staticmethod(_wrap1(torch.cos))
    tan = staticmethod(_wrap1(torch.tan))
    asin = staticmethod(_wrap1(torch.asin))
    acos = staticmethod(_wrap1(torch.acos))
    atan = staticmethod(_wrap1(torch.atan))
    sinh = staticmethod(_wrap1(torch.sinh))
    cosh = staticmethod(_wrap1(torch.cosh))
    tanh = staticmethod(_wrap1(torch.tanh))
    atanh = staticmethod(_wrap1(torch.atanh))

    # ----- sign / rounding / clipping ---------------------------------
    abs = staticmethod(lambda x: INDArray(torch.abs(as_tensor(x))))
    sign = staticmethod(lambda x: INDArray(torch.sign(as_tensor(x))))
    floor = staticmethod(_wrap1(torch.floor))
    ceil = staticmethod(_wrap1(torch.ceil))
    round = staticmethod(_wrap1(torch.round))

    @staticmethod
    def clip(x, minVal, maxVal) -> INDArray:
        return INDArray(torch.clamp(as_tensor(x), minVal, maxVal))

    @staticmethod
    def pow(x, power) -> INDArray:
        t = as_tensor(x)
        return INDArray(torch.pow(t, _other(power, t)))

    @staticmethod
    def max(x, y) -> INDArray:
        t = as_tensor(x)
        o = _other(y, t)
        return INDArray(torch.clamp(t, min=o) if isinstance(o, (int, float))
                        else torch.maximum(t, o))

    @staticmethod
    def min(x, y) -> INDArray:
        t = as_tensor(x)
        o = _other(y, t)
        return INDArray(torch.clamp(t, max=o) if isinstance(o, (int, float))
                        else torch.minimum(t, o))

    # ----- neural activations -----------------------------------------
    sigmoid = staticmethod(_wrap1(torch.sigmoid))
    relu = staticmethod(_wrap1(torch.relu))
    relu6 = staticmethod(_wrap1(F.relu6))
    elu = staticmethod(_wrap1(F.elu))
    gelu = staticmethod(_wrap1(lambda a: F.gelu(a, approximate="tanh")))
    softplus = staticmethod(_wrap1(
        lambda a: torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                                 device=a.device))))
    softsign = staticmethod(_wrap1(F.softsign))
    mish = staticmethod(_wrap1(lambda a: a * torch.tanh(
        torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                       device=a.device)))))
    swish = staticmethod(_wrap1(lambda a: a * torch.sigmoid(a)))
    hardTanh = staticmethod(_wrap1(lambda a: torch.clamp(a, -1.0, 1.0)))
    # the reference's HardSigmoid is clip(0.2x + 0.5), not relu6(x+3)/6
    hardSigmoid = staticmethod(_wrap1(
        lambda a: torch.clamp(0.2 * a + 0.5, 0.0, 1.0)))

    @staticmethod
    def leakyRelu(x, alpha=0.01) -> INDArray:
        return INDArray(F.leaky_relu(_t(x), alpha))

    @staticmethod
    def softmax(x, dimension: int = -1) -> INDArray:
        return INDArray(torch.softmax(_t(x), dim=dimension))

    @staticmethod
    def logSoftmax(x, dimension: int = -1) -> INDArray:
        return INDArray(torch.log_softmax(_t(x), dim=dimension))

    @staticmethod
    def step(x) -> INDArray:  # heaviside, reference: Step
        return INDArray((as_tensor(x) > 0).to(torch.float32))

    # ----- vector geometry --------------------------------------------
    @staticmethod
    def unitVec(x) -> INDArray:
        a = _t(x)
        return INDArray(a / torch.linalg.vector_norm(a))

    @staticmethod
    def normalizeZeroMeanAndUnitVariance(x) -> INDArray:
        a = _t(x)
        return INDArray((a - a.mean()) / torch.clamp(
            a.std(correction=0), min=1e-12))

    @staticmethod
    def euclideanDistance(x, y) -> float:
        a = _t(x)
        return float(torch.linalg.vector_norm(a - _other(y, a)))

    @staticmethod
    def manhattanDistance(x, y) -> float:
        a = _t(x)
        return float(torch.abs(a - _other(y, a)).sum())

    @staticmethod
    def cosineSim(x, y) -> float:
        a = _t(x).reshape(-1)
        b = _t(as_tensor(y, a.device)).reshape(-1).to(a.dtype)
        denom = torch.clamp(torch.linalg.vector_norm(a)
                            * torch.linalg.vector_norm(b), min=1e-12)
        return float(torch.dot(a, b) / denom)

    @staticmethod
    def cosineDistance(x, y) -> float:
        return 1.0 - Transforms.cosineSim(x, y)

    @staticmethod
    def hammingDistance(x, y) -> float:
        a = as_tensor(x)
        b = as_tensor(y, a.device)
        return float(torch.mean((a != b).to(torch.float32)))

    @staticmethod
    def jaccardDistance(x, y) -> float:
        a = _t(x)
        b = _other(y, a)
        inter = torch.minimum(a, b).sum()
        union = torch.maximum(a, b).sum()
        return float(1.0 - inter / torch.clamp(union, min=1e-12))

    # ----- all-pairs distance matrices: [N, D] x [M, D] -> [N, M] ------
    @staticmethod
    def allEuclideanDistances(x, y, *dimensions) -> INDArray:
        a, b = _rows(x, dimensions), _rows(y, dimensions)
        # ||a-b||^2 = ||a||^2 + ||b||^2 - 2ab, clamped for fp error
        sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
              - 2.0 * (a @ b.T))
        return INDArray(torch.sqrt(torch.clamp(sq, min=0.0)))

    @staticmethod
    def allManhattanDistances(x, y, *dimensions) -> INDArray:
        a, b = _rows(x, dimensions), _rows(y, dimensions)
        # L1 has no gemm form; row by row keeps the working memory at
        # O(M*D) instead of the [N, M, D] broadcast
        return INDArray(torch.stack(
            [torch.abs(row[None, :] - b).sum(-1) for row in a])
            if a.shape[0] else a.new_zeros((0, b.shape[0])))

    @staticmethod
    def allCosineSimilarities(x, y, *dimensions) -> INDArray:
        a, b = _rows(x, dimensions), _rows(y, dimensions)
        an = torch.linalg.vector_norm(a, dim=1)[:, None]
        bn = torch.linalg.vector_norm(b, dim=1)[None, :]
        return INDArray((a @ b.T) / torch.clamp(an * bn, min=1e-12))

    @staticmethod
    def isMax(x, dimension: int = None) -> INDArray:
        """One-hot of the argmax (the first maximum on ties), the
        reference's IsMax op."""
        a = as_tensor(x)
        if dimension is None:
            flat = torch.zeros(a.numel(), dtype=a.dtype, device=a.device)
            flat[torch.argmax(a.reshape(-1))] = 1
            return INDArray(flat.reshape(a.shape))
        idx = torch.argmax(a, dim=dimension, keepdim=True)
        iota = torch.arange(a.shape[dimension], device=a.device).reshape(
            [-1 if d == dimension % a.ndim else 1 for d in range(a.ndim)])
        return INDArray((iota == idx).to(a.dtype))
