"""Named op registry for SameDiff graphs.

The counterpart of ``deeplearning4j_tpu/autodiff/ops_impl.py``: each op
NAME maps to a function over torch tensors with the reference's
arithmetic, so a graph file names its ops and either package can run it.
Every name the reference registers is here: elementwise math and logic,
the special functions (``betainc`` by Lentz's continued fraction on the
device), reductions, shape and index ops, the segment reductions, ``nn``
(``multiHeadDotProductAttention`` through
``ops.attention.multi_head_attention``, whose core is the flash
dispatcher), the losses, the products and decompositions, the cnn ops
over NHWC/HWIO arrays (``ops.conv``, ``ops.pooling``), the rnn ops
(``ops.rnn``), the image ops and non-max suppression, fft over complex
tensors, the bitwise ops and the random ops. The executor passes the
random ops a seeded ``torch.Generator`` as ``gen`` (where the reference
folds a PRNG key) and the no-input ops the graph's ``device``;
``if_cond``/``while_loop`` are sentinels the executor runs itself.

Indices that select (``gather``, ``embeddingLookup``, scatter ops,
``sparseSoftmaxCrossEntropy``) are bounds-checked on the host before
the launch: on the card an out-of-range index is a device-side assert
that poisons the context. Segment ids out of range are dropped, as
``jax.ops.segment_*`` drops them, with no host check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray.dtype import resolve
from deeplearning4j_tpu_torch.ndarray.factory import pad as _pad
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    _promote, arg_reduce, reduce_prod,
)
from deeplearning4j_tpu_torch.nn.losses import _log_softmax
from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.ops import conv as _conv
from deeplearning4j_tpu_torch.ops import pooling as _pool
from deeplearning4j_tpu_torch.ops import rnn as _rnn

__all__ = ["OPS", "CONTROL_OPS", "DEVICE_OPS", "STOCHASTIC_OPS",
           "abs_select"]

OPS = {}


def op(name):
    def deco(fn):
        OPS[name] = fn
        return fn
    return deco


def _reg(name, fn):
    OPS[name] = fn


def _float(x):
    return x if (x.is_floating_point() or x.is_complex()) \
        else x.to(torch.get_default_dtype())


def _axes(dimensions):
    return tuple(dimensions) if dimensions else None


def _all(x, axes):
    return tuple(range(x.ndim)) if axes is None else axes


def _checked_long(idx, n, what):
    """Integer indices as long, checked on the host against [-n, n) and
    wrapped to [0, n)."""
    idx = idx.long()
    if idx.numel() and idx.device.type != "meta":
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(f"{what}: index {hi if hi >= n else lo} out of "
                             f"bounds for size {n}")
    return torch.remainder(idx, n) if n else idx


def abs_select(x):
    """|x| whose gradient at 0 is +1, as the reference's (``lax.abs``
    differentiates as select(x >= 0, 1, -1)); ``torch.abs`` gives 0."""
    return torch.where(x >= 0, x, -x)


# ---- math: elementwise ----
for _n, _f in {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide, "floordiv": torch.floor_divide,
    "mod": torch.remainder, "pow": torch.pow,
    "squaredDifference": lambda a, b: torch.square(a - b),
    "maximum": torch.maximum, "minimum": torch.minimum,
    "neg": torch.neg, "abs": lambda x: abs_select(x), "sign": torch.sign,
    "exp": lambda x: torch.exp(_float(x)),
    "expm1": lambda x: torch.expm1(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "sqrt": lambda x: torch.sqrt(_float(x)),
    "rsqrt": lambda x: torch.rsqrt(_float(x)),
    "square": torch.square,
    "reciprocal": lambda x: torch.reciprocal(_float(x)),
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "erf": torch.special.erf, "erfc": torch.special.erfc,
    "atan2": torch.atan2,
    "lgamma": torch.lgamma, "digamma": torch.digamma,
    "igamma": torch.special.gammainc,     # regularized lower P(a, x)
    "igammac": torch.special.gammaincc,   # regularized upper Q(a, x)
    "polygamma": lambda n, x: torch.special.polygamma(
        int(n.reshape(-1)[0]) if isinstance(n, torch.Tensor) else int(n), x),
    "zeta": torch.special.zeta,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}.items():
    _reg(_n, _f)

# ---- comparisons / logic ----
for _n, _f in {
    "eq": torch.eq, "neq": torch.ne, "gt": torch.gt, "gte": torch.ge,
    "lt": torch.lt, "lte": torch.le, "and": torch.logical_and,
    "or": torch.logical_or, "xor": torch.logical_xor,
    "not": torch.logical_not,
}.items():
    _reg(_n, _f)


@op("where")
def _where(cond, x, y):
    return torch.where(cond.bool(), x, y)


# ---- reductions ----
def _keep_all(r, x, keepDims):
    return r.reshape([1] * x.ndim) if keepDims else r


@op("sum")
def _sum(x, dimensions=None, keepDims=False):
    return torch.sum(x, dim=_axes(dimensions), keepdim=keepDims)


@op("mean")
def _mean(x, dimensions=None, keepDims=False):
    return torch.mean(_float(x), dim=_axes(dimensions), keepdim=keepDims)


@op("prod")
def _prod(x, dimensions=None, keepDims=False):
    return reduce_prod(x, _axes(dimensions), keepDims)


@op("max")
def _max(x, dimensions=None, keepDims=False):
    return torch.amax(x, dim=_all(x, _axes(dimensions)), keepdim=keepDims)


@op("min")
def _min(x, dimensions=None, keepDims=False):
    return torch.amin(x, dim=_all(x, _axes(dimensions)), keepdim=keepDims)


@op("std")
def _std(x, dimensions=None, keepDims=False):
    # the op is the population std (the INDArray method is the sample one)
    return torch.std(_float(x), dim=_axes(dimensions), correction=0,
                     keepdim=keepDims)


@op("variance")
def _variance(x, dimensions=None, keepDims=False):
    return torch.var(_float(x), dim=_axes(dimensions), correction=0,
                     keepdim=keepDims)


@op("any")
def _any(x, dimensions=None, keepDims=False):
    ax = _axes(dimensions)
    if ax is None:
        return _keep_all(torch.any(x), x, keepDims)
    return torch.any(x, dim=ax, keepdim=keepDims)


@op("all")
def _all_op(x, dimensions=None, keepDims=False):
    ax = _axes(dimensions)
    if ax is None:
        return _keep_all(torch.all(x), x, keepDims)
    return torch.all(x, dim=ax, keepdim=keepDims)


@op("norm1")
def _norm1(x, dimensions=None, keepDims=False):
    return torch.sum(torch.abs(x), dim=_axes(dimensions), keepdim=keepDims)


@op("norm2")
def _norm2(x, dimensions=None, keepDims=False):
    return torch.sqrt(torch.sum(torch.square(_float(x)),
                                dim=_axes(dimensions), keepdim=keepDims))


@op("normmax")
def _normmax(x, dimensions=None, keepDims=False):
    return torch.amax(torch.abs(x), dim=_all(x, _axes(dimensions)),
                      keepdim=keepDims)


@op("argmax")
def _argmax(x, dimensions=None, keepDims=False):
    axis = dimensions[0] if dimensions else None
    r = torch.argmax(x, dim=axis)
    return r.unsqueeze(axis) if (keepDims and axis is not None) else r


@op("argmin")
def _argmin(x, dimensions=None, keepDims=False):
    axis = dimensions[0] if dimensions else None
    r = torch.argmin(x, dim=axis)
    return r.unsqueeze(axis) if (keepDims and axis is not None) else r


@op("cumsum")
def _cumsum(x, axis=0, exclusive=False, reverse=False):
    if reverse:
        x = torch.flip(x, (axis,))
    r = torch.cumsum(x, dim=axis)
    if exclusive:
        r = r - x
    if reverse:
        r = torch.flip(r, (axis,))
    return r


@op("cumprod")
def _cumprod(x, axis=0):
    return torch.cumprod(x, dim=axis)


# ---- shape ops ----
@op("reshape")
def _reshape(x, shape=None):
    return torch.reshape(x, tuple(shape))


@op("permute")
def _permute(x, dimensions=None):
    return x.permute(*dimensions)


@op("transpose")
def _transpose(x):
    return x.permute(*reversed(range(x.ndim)))


@op("expandDims")
def _expand(x, axis=0):
    return torch.unsqueeze(x, axis)


@op("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size {x.shape[a]}")
    return torch.squeeze(x, axes)


@op("concat")
def _concat(*xs, dimension=0):
    return torch.cat(xs, dim=dimension)


@op("stack")
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@op("unstack")
def _unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=axis))


@op("tile")
def _tile(x, reps=None):
    return torch.tile(x, tuple(reps))


@op("repeat")
def _repeat(x, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@op("reverse")
def _reverse(x, dimensions=None):
    return torch.flip(x, tuple(dimensions))


@op("slice")
def _slice(x, begin=None, size=None):
    # lax.dynamic_slice: a start is clamped so the slice fits
    sl = []
    for b, s, n in zip(begin, size, x.shape):
        b = min(max(int(b), 0), n - int(s))
        sl.append(slice(b, b + int(s)))
    return x[tuple(sl)]


@op("stridedSlice")
def _strided_slice(x, begin=None, end=None, strides=None):
    strides = strides or [1] * len(begin)
    for ax, (b, e, s) in enumerate(zip(begin, end, strides)):
        if s < 0:
            n = x.shape[ax]
            idx = torch.as_tensor(list(range(*slice(b, e, s).indices(n))),
                                  dtype=torch.long, device=x.device)
            x = torch.index_select(x, ax, idx)
        else:
            x = x[(slice(None),) * ax + (slice(b, e, s),)]
    return x


@op("gather")
def _gather(x, indices, axis=0):
    axis %= x.ndim
    idx = _checked_long(indices, x.shape[axis], "gather")
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@op("scatterUpdate")
def _scatter_update(ref, indices, updates):
    idx = _checked_long(indices, ref.shape[0], "scatterUpdate")
    return torch.index_put(ref, (idx,), updates.to(ref.dtype))


@op("scatterAdd")
def _scatter_add(ref, indices, updates):
    idx = _checked_long(indices, ref.shape[0], "scatterAdd")
    return torch.index_put(ref, (idx,), updates.to(ref.dtype),
                           accumulate=True)


@op("onehot")
def _onehot(x, depth=None, axis=-1, on=1.0, off=0.0):
    hot = (x.long().unsqueeze(-1) == torch.arange(
        int(depth), device=x.device)).to(torch.float32)
    if axis != -1:
        hot = torch.movedim(hot, -1, axis)
    return hot * (on - off) + off


@op("cast")
def _cast(x, dtype=None):
    return x.to(resolve(dtype))


@op("shape")
def _shape(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@op("pad")
def _pad_op(x, padding=None, constant=0.0, mode="CONSTANT"):
    mode = {"constant": "constant", "reflect": "reflect",
            "symmetric": "symmetric", "edge": "edge"}[mode.lower()]
    return _pad(x, [list(p) for p in padding], mode, constant)


@op("identity")
def _identity(x):
    return x


# ---- linalg ----
@op("mmul")
def _mmul(a, b, transposeA=False, transposeB=False):
    if transposeA:
        a = a.transpose(-1, -2)
    if transposeB:
        b = b.transpose(-1, -2)
    return torch.matmul(*_promote(a, b))


@op("tensorMmul")
def _tensormmul(a, b, dimensionsA=None, dimensionsB=None):
    return torch.tensordot(*_promote(a, b),
                           dims=(list(dimensionsA), list(dimensionsB)))


@op("batchMmul")
def _batchmmul(a, b):
    return torch.matmul(*_promote(a, b))


@op("matrixDiag")
def _matrix_diag(x):
    return torch.diag(x)


@op("diagPart")
def _diag_part(x):
    return torch.diagonal(x, 0, 0, 1)


@op("trace")
def _trace(x):
    return torch.diagonal(x, 0, 0, 1).sum(-1)


@op("eye")
def _eye(rows=None, cols=None, device=None):
    return torch.eye(int(rows), int(cols if cols is not None else rows),
                     device=device)


@op("cross")
def _cross(a, b):
    return torch.linalg.cross(*_promote(a, b))


# ---- nn ----
def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


for _n, _f in {
    "relu": torch.relu, "relu6": F.relu6, "sigmoid": torch.sigmoid,
    "softplus": _softplus, "softsign": F.softsign, "elu": F.elu,
    "selu": F.selu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": lambda x: x * torch.sigmoid(x),
    "hardSigmoid": F.hardsigmoid,
    "hardTanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
}.items():
    _reg(_n, _f)


@op("leakyRelu")
def _lrelu(x, alpha=0.01):
    return F.leaky_relu(x, alpha)


@op("softmax")
def _softmax(x, dimension=-1):
    return torch.softmax(x, dim=dimension)


@op("logSoftmax")
def _log_softmax_op(x, dimension=-1):
    return torch.log_softmax(x, dim=dimension)


@op("linear")
def _linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


@op("layerNorm")
def _layernorm(x, gain, bias=None, dimensions=(-1,)):
    ax = tuple(dimensions)
    mu = torch.mean(x, dim=ax, keepdim=True)
    var = torch.var(x, dim=ax, correction=0, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + 1e-5) * gain
    return y if bias is None else y + bias


@op("dropout")
def _dropout(x, gen=None, rate=0.0, train=False):
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@op("dotProductAttention")
def _dpa(q, k, v, mask=None, causal=False):
    return _attn.dot_product_attention(q, k, v, mask=mask, causal=causal)


@op("multiHeadDotProductAttention")
def _mhdpa(x, wq, wk, wv, wo, nHeads=1, causal=False):
    return _attn.multi_head_attention(x, wq, wk, wv, wo, int(nHeads),
                                      causal=causal)


@op("batchNorm")
def _batchnorm(x, mean, var, gamma=None, beta=None, epsilon=1e-5, axis=-1):
    shp = [1] * x.ndim
    shp[axis] = x.shape[axis]
    y = (x - mean.reshape(shp)) * torch.rsqrt(var.reshape(shp) + epsilon)
    if gamma is not None:
        y = y * gamma.reshape(shp)
    if beta is not None:
        y = y + beta.reshape(shp)
    return y


@op("embeddingLookup")
def _embedding(table, ids):
    return _gather(table, ids, axis=0)


# ---- loss ----
# Dtype policy (the reference's SameDiff loss tail): per-element loss math
# stays in the graph's compute dtype; the reductions accumulate in
# >= fp32 and the loss comes out fp32 (or wider).

def _acc_t(x):
    return torch.promote_types(x.dtype, torch.float32)


def _reduce_loss(per_ex, reduction):
    if reduction in ("MEAN_BY_WEIGHT", "MEAN"):
        return torch.mean(per_ex, dtype=_acc_t(per_ex))
    if reduction == "SUM":
        return torch.sum(per_ex, dtype=_acc_t(per_ex))
    return per_ex


@op("lossMSE")
def _loss_mse(labels, predictions, reduction="MEAN"):
    per = torch.mean(torch.square(predictions - labels), dim=-1,
                     dtype=_acc_t(predictions))
    return _reduce_loss(per, reduction)


@op("lossMAE")
def _loss_mae(labels, predictions, reduction="MEAN"):
    return _reduce_loss(torch.mean(torch.abs(predictions - labels), dim=-1,
                                   dtype=_acc_t(predictions)), reduction)


@op("lossLog")
def _loss_log(labels, predictions, reduction="MEAN", epsilon=1e-7):
    p = torch.clamp(predictions, epsilon, 1.0 - epsilon)
    per = -torch.mean(labels * torch.log(p) + (1 - labels) * torch.log(1 - p),
                      dim=-1, dtype=_acc_t(predictions))
    return _reduce_loss(per, reduction)


@op("softmaxCrossEntropy")
def _loss_sce(labels, logits, reduction="MEAN"):
    per = -torch.sum(labels.to(logits.dtype) * _log_softmax(logits),
                     dim=-1, dtype=_acc_t(logits))
    return _reduce_loss(per, reduction)


@op("sparseSoftmaxCrossEntropy")
def _loss_ssce(labels, logits, reduction="MEAN"):
    lp = _log_softmax(logits)
    idx = _checked_long(labels, logits.shape[-1], "sparseSoftmaxCrossEntropy")
    per = -torch.gather(lp, -1, idx.unsqueeze(-1)).squeeze(-1)
    return _reduce_loss(per.to(_acc_t(logits)), reduction)


@op("lossHinge")
def _loss_hinge(labels, predictions, reduction="MEAN"):
    per = torch.mean(torch.clamp(1.0 - (2.0 * labels - 1.0) * predictions,
                                 min=0.0),
                     dim=-1, dtype=_acc_t(predictions))
    return _reduce_loss(per, reduction)


@op("lossHuber")
def _loss_huber(labels, predictions, delta=1.0, reduction="MEAN"):
    d = torch.abs(predictions - labels)
    per = torch.mean(torch.where(d <= delta, 0.5 * d * d,
                                 delta * d - 0.5 * delta * delta), dim=-1,
                     dtype=_acc_t(predictions))
    return _reduce_loss(per, reduction)


@op("lossKLD")
def _loss_kld(labels, predictions, reduction="MEAN", epsilon=1e-7):
    l = torch.clamp(labels, epsilon, 1.0)
    p = torch.clamp(predictions, epsilon, 1.0)
    return _reduce_loss(torch.sum(l * torch.log(l / p), dim=-1,
                                  dtype=_acc_t(predictions)), reduction)


@op("lossPoisson")
def _loss_poisson(labels, predictions, reduction="MEAN"):
    per = torch.mean(predictions - labels * torch.log(predictions + 1e-7),
                     dim=-1, dtype=_acc_t(predictions))
    return _reduce_loss(per, reduction)


@op("lossCosine")
def _loss_cosine(labels, predictions, dimension=-1, reduction="MEAN"):
    ln = labels / (torch.linalg.vector_norm(labels, dim=dimension,
                                            keepdim=True) + 1e-12)
    pn = predictions / (torch.linalg.vector_norm(
        predictions, dim=dimension, keepdim=True) + 1e-12)
    return _reduce_loss(1.0 - torch.sum(ln * pn, dim=dimension,
                                        dtype=_acc_t(predictions)),
                        reduction)


@op("sigmoidCrossEntropy")
def _loss_sigmoid_ce(labels, logits, reduction="MEAN", labelSmoothing=0.0):
    if labelSmoothing:
        labels = labels * (1.0 - labelSmoothing) + 0.5 * labelSmoothing
    # numerically stable BCE-with-logits
    per = torch.clamp(logits, min=0.0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return _reduce_loss(torch.mean(per, dim=-1), reduction)


@op("weightedCrossEntropyWithLogits")
def _loss_weighted_ce(labels, logits, weights, reduction="MEAN"):
    log_weight = 1.0 + (weights - 1.0) * labels
    per = (1.0 - labels) * logits + log_weight * (
        torch.log1p(torch.exp(-torch.abs(logits)))
        + torch.clamp(-logits, min=0.0))
    return _reduce_loss(torch.mean(per, dim=-1), reduction)


@op("l2Loss")
def _loss_l2(x):
    return torch.sum(torch.square(x)) / 2.0


@op("meanPairwiseSquaredError")
def _loss_mpwse(labels, predictions, reduction="MEAN"):
    """Mean over all within-example pairs of (d_i - d_j)^2, d =
    predictions - labels, by the centred closed form."""
    d = (predictions - labels).reshape(labels.shape[0], -1)
    n = d.shape[-1]
    dc = d - torch.mean(d, dim=-1, keepdim=True)
    pair_sum = 2.0 * n * torch.sum(torch.square(dc), dim=-1)
    return _reduce_loss(pair_sum / max(n * (n - 1), 1), reduction)


# ---- the math long tail ----
def _safe_sqrt(s):
    """sqrt with a zero-safe gradient: the sqrt INPUT is where-guarded, so
    d/ds at 0 is 0, not inf * 0 = NaN."""
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


@op("cosineSimilarity")
def _cosine_sim(x, y, dimensions=None):
    d = _axes(dimensions)
    num = torch.sum(x * y, dim=d)
    den = _safe_sqrt(torch.sum(torch.square(x), dim=d)) * \
        _safe_sqrt(torch.sum(torch.square(y), dim=d))
    ok = den > 1e-12
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


@op("cosineDistance")
def _cosine_dist(x, y, dimensions=None):
    return 1.0 - _cosine_sim(x, y, dimensions)


@op("euclideanDistance")
def _euclidean(x, y, dimensions=None):
    return _safe_sqrt(torch.sum(torch.square(x - y), dim=_axes(dimensions)))


@op("manhattanDistance")
def _manhattan(x, y, dimensions=None):
    return torch.sum(torch.abs(x - y), dim=_axes(dimensions))


@op("hammingDistance")
def _hamming(x, y, dimensions=None):
    return torch.sum((x != y).to(torch.float32), dim=_axes(dimensions))


@op("jaccardDistance")
def _jaccard(x, y, dimensions=None):
    d = _axes(dimensions)
    mins = torch.sum(torch.minimum(x, y), dim=d)
    maxs = torch.sum(torch.maximum(x, y), dim=d)
    return 1.0 - mins / torch.clamp(maxs, min=1e-12)


@op("confusionMatrix")
def _confusion_matrix(labels, pred, numClasses=None, weights=None):
    if numClasses is None:
        raise ValueError("confusionMatrix requires numClasses (static "
                         "output shapes)")
    n = int(numClasses)
    lab = _checked_long(labels.reshape(-1), n, "confusionMatrix")
    prd = _checked_long(pred.reshape(-1), n, "confusionMatrix")
    w = torch.ones(lab.shape, dtype=torch.float32, device=lab.device) \
        if weights is None else weights.reshape(-1).to(torch.float32)
    cm = torch.zeros((n, n), dtype=torch.float32, device=lab.device)
    return torch.index_put(cm, (lab, prd), w, accumulate=True)


@op("confusionMatrixWeighted")
def _confusion_matrix_weighted(labels, pred, weights, numClasses=None):
    return _confusion_matrix(labels, pred, numClasses=numClasses,
                             weights=weights)


@op("zeroFraction")
def _zero_fraction(x):
    return torch.mean((x == 0).to(torch.float32))


@op("countNonZero")
def _count_nonzero(x, dimensions=None, keepDims=False):
    return torch.sum((x != 0).to(torch.int64), dim=_axes(dimensions),
                     keepdim=keepDims)


@op("countZero")
def _count_zero(x, dimensions=None, keepDims=False):
    return torch.sum((x == 0).to(torch.int64), dim=_axes(dimensions),
                     keepdim=keepDims)


@op("entropy")
def _entropy(x, dimensions=None):
    xs = torch.where(x > 0, x, 1.0)  # 0*log(0) = 0 convention
    return -torch.sum(x * torch.log(xs), dim=_axes(dimensions))


@op("shannonEntropy")
def _shannon_entropy(x, dimensions=None):
    xs = torch.where(x > 0, x, 1.0)
    return -torch.sum(x * torch.log2(xs), dim=_axes(dimensions))


@op("matchConditionCount")
def _match_condition_count(x, condition="eq", value=0.0, dimensions=None,
                           keepDims=False):
    cmp = {"eq": torch.eq, "neq": torch.ne, "gt": torch.gt, "gte": torch.ge,
           "lt": torch.lt, "lte": torch.le}[condition]
    return torch.sum(cmp(x, value).to(torch.int64), dim=_axes(dimensions),
                     keepdim=keepDims)


@op("iamax")
def _iamax(x, dimensions=None):
    return arg_reduce(torch.argmax, torch.abs(x),
                      tuple(dimensions[:1]) if dimensions else None)


@op("linspace")
def _linspace(start=0.0, stop=1.0, num=10, dtype="float32", device=None):
    return torch.linspace(start, stop, int(num), dtype=resolve(dtype),
                          device=device)


@op("range")
def _range(start=0, limit=None, delta=1, dtype="float32", device=None):
    return torch.arange(start, limit, delta, device=device).to(resolve(dtype))


@op("meshgrid")
def _meshgrid(*xs, indexing="xy"):
    r = torch.meshgrid(*xs, indexing=indexing)
    return r[0] if len(r) == 1 else tuple(r)


@op("clipByValue")
def _clip_by_value(x, clipValueMin=None, clipValueMax=None):
    # bounds in x's dtype: an integer tensor stays integer
    lo = torch.as_tensor(clipValueMin, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(clipValueMax, dtype=x.dtype, device=x.device)
    return torch.clamp(x, lo, hi)


@op("clipByNorm")
def _clip_by_norm(x, clipValue=None, dimensions=None):
    n = torch.sqrt(torch.sum(torch.square(x), dim=_axes(dimensions),
                             keepdim=True) + 1e-12)
    return x * torch.clamp(clipValue / n, max=1.0)


@op("sort")
def _sort(x, axis=-1, descending=False):
    y = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(y, (axis,)) if descending else y


@op("topK")
def _topk(x, k=1, sorted=True):
    # lax.top_k's order: largest first, ties by the lower index
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :int(k)], s.indices[..., :int(k)].to(torch.int32)


@op("split")
def _split(x, numSplit=2, axis=0):
    n = x.shape[axis]
    if n % int(numSplit):
        raise ValueError(f"split: axis of size {n} does not divide into "
                         f"{numSplit} equal parts")
    return tuple(torch.split(x, n // int(numSplit), dim=axis))


# ---- random ops: the executor passes a seeded generator as `gen` ----
@op("randomNormal")
def _random_normal(shape=None, mean=0.0, stddev=1.0, gen=None,
                   dtype="float32"):
    z = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=resolve(dtype))
    return mean + stddev * z


@op("randomUniform")
def _random_uniform(shape=None, min=0.0, max=1.0, gen=None, dtype="float32"):
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=resolve(dtype))
    return min + (max - min) * u


@op("randomBernoulli")
def _random_bernoulli(shape=None, p=0.5, gen=None, dtype="float32"):
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return (u < p).to(resolve(dtype))


@op("randomExponential")
def _random_exponential(shape=None, lambda_=1.0, gen=None, dtype="float32"):
    e = torch.empty(tuple(shape), device=gen.device).exponential_(
        1.0, generator=gen)
    return e.to(resolve(dtype)) / lambda_


# ---- block rearrangements over NHWC (the SpaceToDepth layer's) ----
_reg("spaceToDepth", _conv.space_to_depth)
_reg("depthToSpace", _conv.depth_to_space)

_reg("spaceToBatch", _conv.space_to_batch)
_reg("batchToSpace", _conv.batch_to_space)


# ---- cnn: the reference's NHWC activations and HWIO (DHWIO, WIO)
# kernels; the torch-order views are free, the kernels are cuDNN's ----
def _pads(padding):
    return tuple(tuple(int(v) for v in p) for p in padding)


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y):
    return y.permute(0, 2, 3, 1)


def _bias(y, b):
    return y if b is None else y + b


@op("conv2d")
def _conv2d(x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
            dilation=(1, 1), groups=1):
    y = _conv.conv2d(_to_nchw(x), w.permute(3, 2, 0, 1), None,
                     stride=tuple(stride), padding=_pads(padding),
                     dilation=tuple(dilation), groups=int(groups))
    return _bias(_to_nhwc(y), b)


@op("conv1d")
def _conv1d(x, w, b=None, stride=1, padding=((0, 0),), dilation=1):
    y = _conv.conv1d(x.permute(0, 2, 1), w.permute(2, 1, 0), None,
                     stride=int(stride), padding=_pads(padding),
                     dilation=int(dilation))
    return _bias(y.permute(0, 2, 1), b)


@op("conv3d")
def _conv3d(x, w, b=None, stride=(1, 1, 1), padding=((0, 0),) * 3,
            dilation=(1, 1, 1)):
    return _conv.conv3d(x, w, b, stride=tuple(stride),
                        padding=_pads(padding), dilation=tuple(dilation))


@op("deconv2d")
def _deconv2d(x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
              dilation=(1, 1)):
    # lax.conv_transpose's HWIO kernel, unflipped -> conv_transpose2d's
    # flipped [Cin, Cout, kh, kw]
    y = _conv.deconv2d(_to_nchw(x), w.flip(0, 1).permute(2, 3, 0, 1), None,
                       stride=tuple(stride), padding=_pads(padding),
                       dilation=tuple(dilation))
    return _bias(_to_nhwc(y), b)


@op("maxPooling2d")
def _maxpool(x, kernel=(2, 2), stride=(2, 2), padding=((0, 0), (0, 0))):
    return _to_nhwc(_pool.max_pool2d(_to_nchw(x), tuple(kernel),
                                     tuple(stride), _pads(padding)))


@op("avgPooling2d")
def _avgpool(x, kernel=(2, 2), stride=(2, 2), padding=((0, 0), (0, 0)),
             count_include_pad=True):
    return _to_nhwc(_pool.avg_pool2d(_to_nchw(x), tuple(kernel),
                                     tuple(stride), _pads(padding),
                                     count_include_pad=count_include_pad))


@op("upsampling2d")
def _upsample(x, size=(2, 2)):
    return _to_nhwc(_pool.upsample2d(_to_nchw(x), tuple(size)))


@op("im2col")
def _im2col(x, kernel=(3, 3), stride=(1, 1), padding=((0, 0), (0, 0))):
    """NHWC -> (N, OH, OW, KH, KW, C) patches, the reference's order
    (its XLA patches come out (C, KH, KW) and are transposed)."""
    n, h, w, c = x.shape
    kh, kw = (int(k) for k in kernel)
    sh, sw = (int(s) for s in stride)
    (t, bo), (l, r) = _pads(padding)
    cols = F.unfold(F.pad(_to_nchw(x), (l, r, t, bo)), (kh, kw),
                    stride=(sh, sw))
    oh = (h + t + bo - kh) // sh + 1
    ow = (w + l + r - kw) // sw + 1
    return cols.reshape(n, c, kh, kw, oh, ow).permute(0, 4, 5, 2, 3, 1)


# ---- rnn: time-major [T, B, F] ----
@op("lstmLayer")
def _lstm(x, w, u, b, h0=None, c0=None):
    ys, (h, c) = _rnn.lstm_scan(x, w, u, b, h0=h0, c0=c0)
    return ys, h, c


@op("gru")
def _gru(x, w, u, b, h0=None):
    return _rnn.gru_scan(x, w, u, b, h0=h0)[0]


@op("simpleRnn")
def _simple_rnn(x, w, u, b, h0=None):
    return _rnn.simple_rnn_scan(x, w, u, b, h0=h0)[0]


# ---- image (NHWC) ----
def _linear_resize_weights(n_in, n_out, like):
    """``jax.image.resize(method="bilinear")`` along one axis as an
    [n_out, n_in] matrix: its scale_and_translate weights, a triangle
    kernel widened by the scale when downsampling (antialiasing),
    normalized per output sample, half-pixel centres."""
    inv = n_in / n_out
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    wts = np.maximum(0.0, 1.0 - dist / max(inv, 1.0))
    tot = wts.sum(0, keepdims=True)
    wts = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(tot != 0, tot, 1.0), 0.0)
    wts = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :],
                   wts, 0.0)
    return torch.as_tensor(wts.T, dtype=like.dtype, device=like.device)


@op("resizeBilinear")
def _resize_bilinear(x, height=None, width=None, alignCorners=False):
    n, h, w, c = x.shape
    if int(height) != h:
        x = torch.einsum("oh,nhwc->nowc",
                         _linear_resize_weights(h, int(height), x), x)
    if int(width) != w:
        x = torch.einsum("pw,nowc->nopc",
                         _linear_resize_weights(w, int(width), x), x)
    return x


def _nearest_index(n_in, n_out, device):
    """``jax.image.resize(method="nearest")``'s source rows: the floor of
    each half-pixel output centre, computed in float32 as there."""
    off = (np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
    return torch.as_tensor(np.floor(off).astype(np.int64), device=device)


@op("resizeNearest")
def _resize_nearest(x, height=None, width=None):
    n, h, w, c = x.shape
    if int(height) != h:
        x = torch.index_select(x, 1, _nearest_index(h, int(height),
                                                    x.device))
    if int(width) != w:
        x = torch.index_select(x, 2, _nearest_index(w, int(width), x.device))
    return x


@op("cropAndResize")
def _crop_resize(x, boxes, boxIndices, cropHeight=None, cropWidth=None):
    """boxes [nBoxes, 4] normalized (y1, x1, y2, x2), bilinear samples,
    differentiable in x and the boxes (reference: ``cropAndResize``)."""
    n, h, w, c = x.shape
    bi = _checked_long(boxIndices, n, "cropAndResize")
    y1, x1, y2, x2 = boxes.unbind(-1)
    lin_h = torch.linspace(0.0, 1.0, int(cropHeight), dtype=boxes.dtype,
                           device=boxes.device)
    lin_w = torch.linspace(0.0, 1.0, int(cropWidth), dtype=boxes.dtype,
                           device=boxes.device)
    ys = (y1 * (h - 1))[:, None] + lin_h * ((y2 - y1) * (h - 1))[:, None]
    xs = (x1 * (w - 1))[:, None] + lin_w * ((x2 - x1) * (w - 1))[:, None]
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    b = bi[:, None, None]

    def at(yi, xi):
        return x[b, yi[:, :, None], xi[:, None, :]]

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


@op("adjustContrast")
def _adjust_contrast(x, factor=1.0):
    mean = torch.mean(x, dim=(-1, -2), keepdim=True)
    return (x - mean) * factor + mean


@op("hsvToRgb")
def _hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    sel = torch.remainder(i.to(torch.int64), 6).unsqueeze(-1)

    def choose(*opts):
        return torch.gather(torch.stack(opts, -1), -1, sel).squeeze(-1)

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


@op("rgbToHsv")
def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    h = torch.where(
        d == 0, 0.0,
        torch.where(mx == r, torch.remainder((g - b) / (d + 1e-12), 6),
                    torch.where(mx == g, (b - r) / (d + 1e-12) + 2,
                                (r - g) / (d + 1e-12) + 4))) / 6.0
    s = torch.where(mx == 0, 0.0, d / (mx + 1e-12))
    return torch.stack([h, s, mx], dim=-1)


@op("nonMaxSuppression")
def _non_max_suppression(boxes, scores, maxOutputSize=10, iouThreshold=0.5,
                         scoreThreshold=float("-inf")):
    """Greedy NMS in the reference's fixed-size form: boxes [N, 4] as
    (y1, x1, y2, x2), scores [N] -> [maxOutputSize] int32 indices,
    -1-padded. Non-finite scores are dropped up front, the first index
    wins a tie (argmax), no candidates give all -1; maxOutputSize rounds
    of device ops, no host sync."""
    m = int(maxOutputSize)
    n = boxes.shape[0]
    if n == 0:
        return torch.full((m,), -1, dtype=torch.int32, device=boxes.device)
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)
    area = torch.clamp(y2 - y1, min=0.0) * torch.clamp(x2 - x1, min=0.0)
    sc = scores.to(torch.float32)
    alive = torch.isfinite(scores)
    if math.isfinite(scoreThreshold):
        alive = alive & (scores > scoreThreshold)
    idx = torch.arange(n, device=boxes.device)
    sel = []
    for _ in range(m):
        masked = torch.where(alive, sc, -math.inf)
        j = torch.argmax(masked)
        valid = torch.isfinite(masked[j])
        inter = torch.clamp(torch.minimum(y2, y2[j])
                            - torch.maximum(y1, y1[j]), min=0.0) * \
            torch.clamp(torch.minimum(x2, x2[j])
                        - torch.maximum(x1, x1[j]), min=0.0)
        iou = inter / torch.clamp(area + area[j] - inter, min=1e-10)
        alive = alive & (iou <= iouThreshold) & (idx != j)
        sel.append(torch.where(valid, j, -1))
    return torch.stack(sel).to(torch.int32)


# ---- linalg decompositions (cuSOLVER on the card, LAPACK on the CPU;
# signs, phases and pivots may differ between the two) ----
_reg("cholesky", torch.linalg.cholesky)
_reg("inv", torch.linalg.inv)
_reg("det", torch.linalg.det)


@op("solve")
def _solve(a, b):
    return torch.linalg.solve(*_promote(a, b))


@op("lstsq")
def _lstsq(a, b):
    """The minimum-norm least-squares solution, as ``jnp.linalg.lstsq``:
    through the SVD, singular values below eps·max(M, N)·s_max dropped
    (torch's CUDA ``lstsq`` has only ``gels``, which assumes full
    rank)."""
    a, b = _promote(a, b)
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * max(a.shape[-2:])
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    x = vh.mT.conj() @ (s_inv[..., :, None].to(a.dtype)
                        * (u.mT.conj() @ b))
    return x[:, 0] if vec else x


@op("lu")
def _lu(x):
    p, l, u = torch.linalg.lu(x)
    return p, l, u


@op("eigh")
def _eigh(x):
    # jnp.linalg.eigh symmetrizes its input first
    w, v = torch.linalg.eigh((x + x.mT.conj()) / 2)
    return w, v


@op("svd")
def _svd(x, fullUV=False):
    r = torch.linalg.svd(x, full_matrices=bool(fullUV))
    return r.U, r.S, r.Vh


@op("qr")
def _qr(x):
    q, r = torch.linalg.qr(x)
    return q, r


# ---- fft (cuFFT on the card); complex64/complex128 results ----
def _points(numPoints):
    return None if numPoints is None else int(numPoints)


@op("fft")
def _fft(x, numPoints=None, dimension=-1):
    return torch.fft.fft(_float(x), n=_points(numPoints), dim=int(dimension))


@op("ifft")
def _ifft(x, numPoints=None, dimension=-1):
    return torch.fft.ifft(_float(x), n=_points(numPoints), dim=int(dimension))


@op("rfft")
def _rfft(x, numPoints=None, dimension=-1):
    return torch.fft.rfft(_float(x), n=_points(numPoints), dim=int(dimension))


@op("irfft")
def _irfft(x, numPoints=None, dimension=-1):
    return torch.fft.irfft(x, n=_points(numPoints), dim=int(dimension))


@op("fft2")
def _fft2(x):
    return torch.fft.fft2(_float(x))


@op("ifft2")
def _ifft2(x):
    return torch.fft.ifft2(_float(x))


@op("real")
def _real(x):
    return torch.real(x) if x.is_complex() else x


@op("imag")
def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@op("conj")
def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


@op("angle")
def _angle(x):
    return torch.angle(x)


@op("toComplex")
def _to_complex(re, im):
    re, im = _promote(_float(re), _float(im))
    return torch.complex(re, im)


# ---- bitwise: signed and 8-bit types natively; uint16/uint32 widened
# exactly to int32/int64 and wrapped back; uint64 and/or/xor/not on its
# int64 bits, its shifts refused (no exact route) ----
_WIDE = {torch.uint16: (torch.int32, 0xFFFF),
         torch.uint32: (torch.int64, 0xFFFFFFFF)}
_BIT_FNS = {"shiftLeft": torch.bitwise_left_shift,
            "shiftRight": torch.bitwise_right_shift,
            "bitwiseAnd": torch.bitwise_and, "bitwiseOr": torch.bitwise_or,
            "bitwiseXor": torch.bitwise_xor}


def _bitwise(name):
    fn = _BIT_FNS[name]

    def run(a, b):
        if a.dtype != b.dtype and torch.uint64 in (a.dtype, b.dtype):
            raise TypeError(f"{name}: uint64 with {a.dtype}/{b.dtype} has "
                            "no exact promotion")
        dt = a.dtype if a.dtype == b.dtype else None
        if dt in _WIDE:
            wide, mask = _WIDE[dt]
            r = fn(a.to(wide), b.to(wide))
            return torch.bitwise_and(r, mask).to(dt)
        if dt == torch.uint64:
            if name.startswith("shift"):
                raise TypeError(f"{name} on uint64 is refused: torch has "
                                "no exact uint64 shift (widen to int64 or "
                                "use uint32)")
            return fn(a.view(torch.int64), b.view(torch.int64)).view(dt)
        return fn(a, b)

    run.__name__ = name
    return run


for _n_ in _BIT_FNS:
    _reg(_n_, _bitwise(_n_))


@op("bitwiseNot")
def _bitwise_not(x):
    if x.dtype in _WIDE:
        wide, mask = _WIDE[x.dtype]
        return torch.bitwise_and(torch.bitwise_not(x.to(wide)),
                                 mask).to(x.dtype)
    if x.dtype == torch.uint64:
        return torch.bitwise_not(x.view(torch.int64)).view(torch.uint64)
    return torch.bitwise_not(x)


# ---- segment reductions: out-of-range ids dropped and an empty segment
# at the reducer's identity, as jax.ops.segment_* ----
def _segment_rows(ids, numSegments):
    if numSegments is None:
        raise ValueError(
            "segment ops require numSegments (the SameDiff executor "
            "compiles graphs with static output shapes)")
    n = int(numSegments)
    ids = ids.long()
    # out-of-range ids go to a spare row n, sliced off after
    return n, torch.where((ids >= 0) & (ids < n), ids, n)


def _identity_of(reduce, dtype):
    if reduce == "prod":
        return 1
    if dtype.is_floating_point:
        return -math.inf if reduce == "amax" else math.inf
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _segment(reduce):
    def run(data, segmentIds, numSegments=None):
        n, rows = _segment_rows(segmentIds, numSegments)
        shape = (n + 1,) + tuple(data.shape[1:])
        if reduce == "sum":
            out = torch.zeros(shape, dtype=data.dtype, device=data.device)
            return out.index_add(0, rows, data)[:n]
        out = torch.full(shape, _identity_of(reduce, data.dtype),
                         dtype=data.dtype, device=data.device)
        idx = rows.reshape((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
        return out.scatter_reduce(0, idx, data, reduce,
                                  include_self=False)[:n]
    return run


for _n_, _r in (("segmentSum", "sum"), ("segmentMax", "amax"),
                ("segmentMin", "amin"), ("segmentProd", "prod")):
    _reg(_n_, _segment(_r))


@op("segmentMean")
def _segment_mean(data, segmentIds, numSegments=None):
    s = OPS["segmentSum"](data, segmentIds, numSegments)
    c = OPS["segmentSum"](torch.ones_like(data), segmentIds, numSegments)
    return s / torch.clamp(c, min=1.0)


# ---- the regularized incomplete beta function ----
def _betainc_cf(a, b, x):
    """The continued fraction of I_x(a, b) by the modified Lentz
    algorithm (jax's ``lax.betainc``: DLMF 8.17.E23, tiny and tolerance
    eps/2, at most 200 terms in f32 and 600 in f64). Runs in chunks of
    16 terms with one host check a chunk: a term past convergence
    multiplies by exactly 1, so the chunking changes no bit."""
    dt = x.dtype
    eps = torch.finfo(dt).eps / 2
    limit = 200 if dt == torch.float32 else 600
    one = torch.ones_like(x)
    # the 0th partial denominator is 0, so h and c start at the tiny value
    h = torch.full_like(x, eps)
    if x.device.type == "meta":      # shape inference: no values
        return h
    c, d = h.clone(), torch.zeros_like(x)
    it = 1
    while it < limit:
        stop = min(it + 16, limit)
        unconverged = None
        for k in range(it, stop):
            m = (k - 1) // 2
            if k == 1:
                num = one
            elif k % 2 == 0:
                num = (-(a + b) * x / (a + 1.0) if m == 0 else
                       -(a + m) * (a + b + m) * x
                       / ((a + 2 * m) * (a + 2 * m + 1.0)))
            else:
                num = m * (b - m) * x / ((a + 2 * m - 1.0) * (a + 2 * m))
            c = 1.0 + num / c
            c = torch.where(c.abs() < eps, eps, c)
            d = 1.0 + num * d
            d = torch.reciprocal(torch.where(d.abs() < eps, eps, d))
            delta = c * d
            h = h * delta
            unconverged = (delta - 1.0).abs() >= eps
        it = stop
        if not bool(unconverged.any()):
            break
    return h


def _betainc_value(a, b, x):
    """jax's ``regularized_incomplete_beta_impl`` on broadcast tensors."""
    swap = x >= (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    cf = _betainc_cf(aa, bb, xx)
    tiny = torch.finfo(x.dtype).tiny * 2
    lb_small = torch.lgamma(bb) - torch.lgamma(aa + bb)
    lb = torch.lgamma(aa) + lb_small
    factor = torch.where(aa < tiny, torch.exp(torch.log1p(-xx) * bb
                                              - lb_small),
                         torch.exp(torch.log(xx) * aa + torch.log1p(-xx) * bb
                                   - lb) / aa)
    r = cf * factor
    r = torch.where(swap, 1.0 - r, r)
    a_zero = (a == 0) | (b == math.inf)
    b_zero = (b == 0) | (a == math.inf)
    r = torch.where((b_zero & (x != 1)) | (a_zero & (x == 0)), 0.0, r)
    r = torch.where((a_zero & (x != 0)) | (b_zero & (x == 1)), 1.0, r)
    nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero) | \
        torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    return torch.where(nan, math.nan, r)


class _BetaInc(torch.autograd.Function):
    """I_x(a, b) with jax's derivative rules: in x,
    x^(a-1) (1-x)^(b-1) / B(a, b); in a and b, an error."""

    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        return _betainc_value(a, b, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError(
                "Betainc gradient with respect to a and b not supported.")
        a, b, x = ctx.saved_tensors
        lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return None, None, g * torch.exp((b - 1) * torch.log1p(-x)
                                         + (a - 1) * torch.log(x) - lbeta)


@op("betainc")
def _betainc(a, b, x):
    a, b, x = torch.broadcast_tensors(*(_float(t) for t in (a, b, x)))
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    work = torch.promote_types(dt, torch.float32)   # f16/bf16 upcast
    r = _BetaInc.apply(a.to(work), b.to(work), x.to(work))
    return r.to(dt)


# ---- control flow: the executor runs these itself (their bodies are
# sub-graphs), so the table holds the names only ----
OPS["if_cond"] = None
OPS["while_loop"] = None
CONTROL_OPS = frozenset({"if_cond", "while_loop"})

STOCHASTIC_OPS = frozenset({"randomNormal", "randomUniform",
                            "randomBernoulli", "randomExponential"})
#: ops with no tensor input: the executor passes them the graph's device
DEVICE_OPS = frozenset({"eye", "linspace", "range"})
del _n, _f, _n_, _r
