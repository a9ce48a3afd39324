"""Named op registry for SameDiff graphs.

The counterpart of ``deeplearning4j_tpu/autodiff/ops_impl.py``: each op
NAME maps to a function over torch tensors with the reference's
arithmetic, so a graph file names its ops and either package can run it.
Ported families: elementwise math and logic, reductions, shape and index
ops, ``nn`` (``multiHeadDotProductAttention`` through
``ops.attention.multi_head_attention``, whose core is the flash
dispatcher), the losses, ``mmul``/``tensorMmul``/``batchMmul``, the
random ops and ``spaceToDepth``/``depthToSpace``. The executor passes
the random ops a seeded ``torch.Generator`` as ``gen`` (where the
reference folds a PRNG key) and the no-input ops the graph's
``device``.

The families in ``DEFERRED`` wait for the rest of SameDiff (ROADMAP.md
Queue 1 item 9): control flow, the rest of the cnn ops, the rnn, image,
fft and bitwise ops, the linalg decompositions, the segment ops and NMS;
a graph that names one raises ``NotImplementedError`` when it is built
or loaded.

Indices that select (``gather``, ``embeddingLookup``, scatter ops,
``sparseSoftmaxCrossEntropy``) are bounds-checked on the host before
the launch: on the card an out-of-range index is a device-side assert
that poisons the context.
"""

from __future__ import annotations

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

__all__ = ["OPS", "DEFERRED", "DEVICE_OPS", "STOCHASTIC_OPS", "deferred",
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
    if idx.numel():
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


# ---- linalg (products; the decompositions wait) ----
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

STOCHASTIC_OPS = frozenset({"randomNormal", "randomUniform",
                            "randomBernoulli", "randomExponential"})
#: ops with no tensor input: the executor passes them the graph's device
DEVICE_OPS = frozenset({"eye", "linspace", "range"})

# ---- the families that wait, by op name ----
_ITEM9 = "ROADMAP.md Queue 1 item 9"
DEFERRED = {}
for _names, _what in [
    ("if_cond while_loop", "SameDiff control flow (ifCond/whileLoop)"),
    ("conv2d conv1d conv3d deconv2d maxPooling2d avgPooling2d upsampling2d "
     "im2col spaceToBatch batchToSpace",
     "the SameDiff cnn namespace"),
    ("lstmLayer gru simpleRnn", "the SameDiff rnn namespace"),
    ("resizeBilinear resizeNearest cropAndResize adjustContrast hsvToRgb "
     "rgbToHsv", "the SameDiff image namespace"),
    ("nonMaxSuppression", "non-max suppression"),
    ("fft ifft rfft irfft fft2 ifft2 real imag conj angle toComplex",
     "the SameDiff fft namespace"),
    ("shiftLeft shiftRight bitwiseAnd bitwiseOr bitwiseXor bitwiseNot",
     "the SameDiff bitwise namespace"),
    ("cholesky inv det solve lstsq lu eigh svd qr",
     "the SameDiff linalg decompositions"),
    ("segmentSum segmentMax segmentMin segmentMean segmentProd",
     "the SameDiff segment ops"),
    ("betainc", "the incomplete beta function"),
]:
    for _n in _names.split():
        DEFERRED[_n] = _what
del _n, _f, _names, _what


def deferred(opName) -> NotImplementedError:
    """The error a graph naming a deferred op raises."""
    return NotImplementedError(
        f"op '{opName}': {DEFERRED[opName]} waits for the rest of SameDiff "
        f"({_ITEM9})")

