"""Batch normalization, with the hand-fused BN -> activation (-> residual
add) epilogue.

The counterpart of ``deeplearning4j_tpu/ops/norm.py``'s default path.
The reference fused these by hand as ``jax.custom_vjp``s, not Pallas
kernels; the port reproduces their gradient semantics as
``torch.autograd.Function``s over plain PyTorch ops:

* ``BNTrainFn`` is ``_bn_train``: training-mode BN returning (y, mean,
  var) with the cuDNN-batchnorm backward formulas; it saves exactly
  ``(x, mean, inv, gamma)``, so the backward is two passes over x and no
  normalised copy of x is kept.
* ``BNActTrainFn`` and ``BNActAddTrainFn`` are ``_bn_act_train`` and
  ``_bn_act_add_train``: the activation (after a residual add, for the
  second) in the same function, whose backward takes the activation's
  gradient from the OUTPUT (``_epilogue_grad_from_out``), so the BN
  output is never kept: they save ``(x, mean, inv, gamma, out)``.

The mean/var outputs are for the running statistics only; their
cotangents are zero. Channels are axis 1 (NCHW-logical activations, or
[B, C] / [B, C, T]); the statistics reduce over every other axis.

Dtype policy, the reference's default ("compute") tail: under bf16/fp16
compute the activation-scale math stays in the compute dtype, with the
statistics accumulated in fp32 inside the reduces and
``var = E[(x - round(mean))^2]``; under f32/f64 the whole tail runs in
that width (the reference's "wide" tail).

The reference's two knobs (the autotune arbiter's ``bn_tail`` and
``bn_epilogue``): ``_TAIL_MODE`` ("compute", default, or "wide"; initial
value from ``DL4J_TPU_BN_TAIL``) runs a bf16/fp16 tensor's BN math in
fp32 under "wide" and casts at the edges, as the reference's pre-round-6
tail; ``_EPILOGUE`` ("fused", default, or "unfused"; ``set_bn_epilogue``,
initial value from ``DL4J_TPU_BN_EPILOGUE``) makes ``batch_norm_act``
the plain composition, BN, the add, then the activation under autograd.
Each Function reads the tail mode when its forward runs and keeps it for
its backward.

Synchronised BN for data-parallel training: inside ``sync_batch_norm(group)``
the three Functions take their batch statistics over every rank of
``group`` (an object with ``size`` and an in-place ``all_reduce_sum``;
``parallel.mesh.DataGroup``), where the reference's dense data-parallel
step gets them from GSPMD reducing over the sharded batch. The forward
all-reduces the fp32 per-channel sum, divides by the global count, then
all-reduces the centred sum of squares; the backward all-reduces
(dbeta, dgamma) as one buffer before forming dx with the global count,
and returns the LOCAL sums as gamma's and beta's gradients (the data-
parallel wrapper's gradient mean makes them global). Each Function
captures the group when its forward runs, so its backward, which the
autograd engine may run on another thread, uses the same one. A group
of one rank is no group: the local code runs unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from deeplearning4j_tpu_torch.nn import activations as _act

__all__ = ["EPILOGUE_ACTIVATIONS", "bn_act_supported", "BNTrainFn",
           "BNActTrainFn", "BNActAddTrainFn", "batch_norm",
           "batch_norm_act", "sync_batch_norm", "current_sync_group",
           "lrn", "set_bn_epilogue"]

#: "compute" (default): activation-scale BN math in the compute dtype;
#: "wide": all of it in fp32, cast at the edges (module docstring)
_TAIL_MODE = os.environ.get("DL4J_TPU_BN_TAIL", "compute")

#: "fused" (default): BN -> activation (-> add) as one Function;
#: "unfused": the plain composition
_EPILOGUE = os.environ.get("DL4J_TPU_BN_EPILOGUE", "fused").lower()
if _EPILOGUE not in ("fused", "unfused"):
    raise ValueError(
        f"DL4J_TPU_BN_EPILOGUE must be 'fused' or 'unfused', got "
        f"{os.environ['DL4J_TPU_BN_EPILOGUE']!r}")


def set_bn_epilogue(mode):
    """Set the BN epilogue ("fused" or "unfused"); returns the previous
    value (the autotune arbiter's entry)."""
    global _EPILOGUE
    mode = str(mode).lower()
    if mode not in ("fused", "unfused"):
        raise ValueError(
            f"bn_epilogue must be 'fused' or 'unfused', got {mode!r}")
    old, _EPILOGUE = _EPILOGUE, mode
    return old

#: activations whose gradient is an exact function of the output
EPILOGUE_ACTIVATIONS = ("identity", "relu", "leakyrelu", "tanh", "sigmoid")
#: leakyrelu's negative slope, read from the registry function itself
_LEAKY_ALPHA = float(-_act.get("leakyrelu")(torch.tensor(-1.0)))


def bn_act_supported(activation):
    """True when the fused epilogue takes this activation name."""
    return str(activation).lower() in EPILOGUE_ACTIVATIONS


#: the group training-mode BN takes its statistics over (None: local)
_SYNC_GROUP = contextvars.ContextVar("bn_sync_group", default=None)


@contextlib.contextmanager
def sync_batch_norm(group):
    """Training-mode BN forwards inside the ``with`` take their batch
    statistics over every rank of `group` (module docstring); None or a
    group of one rank leaves BN local."""
    token = _SYNC_GROUP.set(
        group if group is not None and group.size > 1 else None)
    try:
        yield
    finally:
        _SYNC_GROUP.reset(token)


def current_sync_group():
    """The group the BN forwards of the current ``sync_batch_norm``
    context reduce over (None: local)."""
    return _SYNC_GROUP.get()


def _ft(x):
    return torch.promote_types(x.dtype, torch.float32)


def _wide(x):
    return x.dtype == _ft(x)


def _axes(x):
    return (0,) + tuple(range(2, x.dim()))


def _vec(v, x):
    """A per-channel vector [C] shaped to broadcast against x."""
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def _bn_train_fwd_math(x, gamma, beta, eps, group=None):
    """(y, mean, var, inv) of training-mode BN (reference:
    ``_bn_train_fwd_math``), the statistics over `group`'s ranks when one
    is given."""
    axes, ft, wide = _axes(x), _ft(x), _wide(x)
    if not wide and _TAIL_MODE == "wide":
        y, mean, var, inv = _bn_train_fwd_math(x.to(ft), gamma, beta, eps,
                                               group)
        return y.to(x.dtype), mean, var, inv
    if group is not None:
        n = x.numel() // x.shape[1] * group.size
        mean = group.all_reduce_sum(x.sum(axes, dtype=ft)) / n
        xc = x - _vec(mean.to(x.dtype), x)
        var = group.all_reduce_sum(xc.square().sum(axes, dtype=ft)) / n
    elif wide:
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
        xc = x - _vec(mean, x)
    else:
        mean = x.mean(axes, dtype=ft)
        xc = x - _vec(mean.to(x.dtype), x)
        var = xc.square().mean(axes, dtype=ft)
    inv = torch.rsqrt(var + eps)
    if wide:
        y = xc * _vec(inv, x) * _vec(gamma.to(ft), x) + _vec(beta.to(ft), x)
        return y, mean, var, inv
    scale = (inv * gamma.to(ft)).to(x.dtype)
    y = xc * _vec(scale, x) + _vec(beta.to(x.dtype), x)
    return y, mean, var, inv


def _global_sums(dbeta, dgamma, group):
    """(dbeta, dgamma) summed over `group`'s ranks in one all-reduce."""
    if group is None:
        return dbeta, dgamma
    both = group.all_reduce_sum(torch.cat([dbeta, dgamma]))
    return both[:dbeta.numel()], both[dbeta.numel():]


def _bn_train_bwd(x, mean, inv, gamma, dy, group=None, tail="compute"):
    """(dx, dgamma, dbeta) (reference: ``_bn_train_bwd``); over `group`,
    dx takes the global sums and count, dgamma/dbeta stay local. `tail`
    is the mode the forward ran under."""
    axes, ft = _axes(x), _ft(x)
    if not _wide(x) and tail == "wide":
        dx, dgamma, dbeta = _bn_train_bwd(x.to(ft), mean, inv, gamma,
                                          dy.to(ft), group)
        return dx.to(x.dtype), dgamma, dbeta
    n = x.numel() // x.shape[1] * (1 if group is None else group.size)
    if _wide(x):
        xhat = (x - _vec(mean, x)) * _vec(inv, x)
        dbeta = dy.sum(axes)
        dgamma = (dy * xhat).sum(axes)
        sb, sg = _global_sums(dbeta, dgamma, group)
        dx = _vec(gamma.to(ft) * inv / n, x) * (
            n * dy - _vec(sb, x) - xhat * _vec(sg, x))
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)
    xhat = (x - _vec(mean.to(x.dtype), x)) * _vec(inv.to(x.dtype), x)
    dbeta = dy.sum(axes, dtype=ft)
    dgamma = (dy * xhat).sum(axes, dtype=ft)
    sb, sg = _global_sums(dbeta, dgamma, group)
    k = (gamma.to(ft) * inv / n).to(x.dtype)
    dx = _vec(k, x) * (n * dy - _vec(sb.to(x.dtype), x)
                       - xhat * _vec(sg.to(x.dtype), x))
    return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _epilogue_apply(y, act):
    return y if act == "identity" else _act.get(act)(y)


def _epilogue_grad_from_out(out, act):
    """d(act)/d(pre) from the OUTPUT; None for identity. The relu mask
    is ``out > 0`` (strict: relu's gradient at its kink is 0), the
    leakyrelu mask ``out >= 0`` (its gradient at 0 is 1)."""
    if act == "relu":
        return (out > 0).to(out.dtype)
    if act == "leakyrelu":
        # 0-d fills on out's device: a host scalar would be a copy a
        # captured backward refuses
        return torch.where(
            out >= 0, torch.ones((), dtype=out.dtype, device=out.device),
            torch.full((), _LEAKY_ALPHA, dtype=out.dtype,
                       device=out.device))
    if act == "tanh":
        return 1 - out * out
    if act == "sigmoid":
        return out * (1 - out)
    return None


class BNTrainFn(torch.autograd.Function):
    """``_bn_train``: (x, gamma, beta, eps) -> (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.group, ctx.tail = _SYNC_GROUP.get(), _TAIL_MODE
        y, mean, var, inv = _bn_train_fwd_math(x, gamma, beta, eps,
                                               ctx.group)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _bn_train_bwd(x, mean, inv, gamma, dy,
                                          ctx.group, ctx.tail)
        return dx, dgamma, dbeta, None


class BNActTrainFn(torch.autograd.Function):
    """``_bn_act_train``: (x, gamma, beta, eps, act) -> (act(y), mean,
    var); the backward reads the output, not y."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act):
        ctx.group, ctx.tail = _SYNC_GROUP.get(), _TAIL_MODE
        y, mean, var, inv = _bn_train_fwd_math(x, gamma, beta, eps,
                                               ctx.group)
        out = _epilogue_apply(y, act)
        ctx.act = act
        ctx.save_for_backward(x, mean, inv, gamma, out)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, mean, inv, gamma, out = ctx.saved_tensors
        g = _epilogue_grad_from_out(out, ctx.act)
        dy = dout if g is None else dout * g
        dx, dgamma, dbeta = _bn_train_bwd(x, mean, inv, gamma, dy,
                                          ctx.group, ctx.tail)
        return dx, dgamma, dbeta, None, None


class BNActAddTrainFn(torch.autograd.Function):
    """``_bn_act_add_train``: (x, gamma, beta, residual, eps, act) ->
    (act(y + residual), mean, var), the ResNet block tail."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, act):
        ctx.group, ctx.tail = _SYNC_GROUP.get(), _TAIL_MODE
        y, mean, var, inv = _bn_train_fwd_math(x, gamma, beta, eps,
                                               ctx.group)
        out = _epilogue_apply(y + residual, act)
        ctx.act = act
        ctx.save_for_backward(x, mean, inv, gamma, out)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, mean, inv, gamma, out = ctx.saved_tensors
        g = _epilogue_grad_from_out(out, ctx.act)
        dy = dout if g is None else dout * g
        dx, dgamma, dbeta = _bn_train_bwd(x, mean, inv, gamma, dy,
                                          ctx.group, ctx.tail)
        return dx, dgamma, dbeta, dy, None, None


def _locked_gamma_beta(x, gamma, beta, ft):
    """A locked (None) gamma/beta becomes the constant 1/0 vector."""
    c = x.shape[1]
    g = torch.ones(c, dtype=ft, device=x.device) if gamma is None else gamma
    b = torch.zeros(c, dtype=ft, device=x.device) if beta is None else beta
    return g, b


def _ema(running, batch_stat, decay, ft):
    """decay*running + (1-decay)*batch in ft, cast back (the reference's
    decay semantics); outside autograd."""
    with torch.no_grad():
        return (decay * running.to(ft)
                + (1.0 - decay) * batch_stat).to(running.dtype)


def batch_norm(x, gamma, beta, running_mean, running_var, *, train,
               decay=0.9, eps=1e-5):
    """Batch norm over channel axis 1. Returns (y, new_running_mean,
    new_running_var). Training mode runs ``BNTrainFn``; eval mode is a
    plain affine transform from the running statistics."""
    ft = _ft(x)
    if train:
        g, b = _locked_gamma_beta(x, gamma, beta, ft)
        y, mean, var = BNTrainFn.apply(x, g, b, float(eps))
        return (y, _ema(running_mean, mean, decay, ft),
                _ema(running_var, var, decay, ft))
    if not _wide(x) and _TAIL_MODE == "wide":
        y, rm, rv = batch_norm(x.to(ft), gamma, beta, running_mean,
                               running_var, train=False, decay=decay,
                               eps=eps)
        return y.to(x.dtype), rm, rv
    mean = running_mean.to(ft)
    inv = torch.rsqrt(running_var.to(ft) + eps)
    if _wide(x):
        y = (x - _vec(mean, x)) * _vec(inv, x)
        if gamma is not None:
            y = y * _vec(gamma.to(ft), x)
        if beta is not None:
            y = y + _vec(beta.to(ft), x)
        return y, running_mean, running_var
    a = inv if gamma is None else inv * gamma.to(ft)
    b = -mean * a
    if beta is not None:
        b = b + beta.to(ft)
    y = x * _vec(a.to(x.dtype), x) + _vec(b.to(x.dtype), x)
    return y, running_mean, running_var


def batch_norm_act(x, gamma, beta, running_mean, running_var, *, train,
                   activation, decay=0.9, eps=1e-5, residual=None):
    """``batch_norm`` with the activation (and an optional residual add
    before it) fused into one epilogue; same returns. Eval mode, and
    training under the "unfused" epilogue, is ``batch_norm``, the add and
    the activation in plain ops."""
    act = str(activation).lower()
    if not bn_act_supported(act):
        raise ValueError(
            f"activation {activation!r} is not epilogue-fusable; "
            f"supported: {EPILOGUE_ACTIVATIONS}")
    ft = _ft(x)
    if not train or _EPILOGUE == "unfused":
        y, rm, rv = batch_norm(x, gamma, beta, running_mean, running_var,
                               train=train, decay=decay, eps=eps)
        if residual is not None:
            y = y + residual
        return _epilogue_apply(y, act), rm, rv
    g, b = _locked_gamma_beta(x, gamma, beta, ft)
    if residual is None:
        y, mean, var = BNActTrainFn.apply(x, g, b, float(eps), act)
    else:
        y, mean, var = BNActAddTrainFn.apply(x, g, b, residual, float(eps),
                                             act)
    return (y, _ema(running_mean, mean, decay, ft),
            _ema(running_var, var, decay, ft))


def lrn(x, k=2.0, n=5, alpha=1e-4, beta=0.75):
    """Local response normalization across channels (dim 1) (reference:
    ``ops.norm.lrn``): ``x / (k + alpha * S)^beta`` with S the sum of x²
    over an n-channel window, zero-padded by n // 2 on each side. alpha
    is NOT divided by n, so this is not ``F.local_response_norm`` (which
    averages the window). The window sum adds n shifted slices of the
    padded squares."""
    sq = x * x
    half = n // 2
    C = x.shape[1]
    padded = torch.nn.functional.pad(
        sq, (0, 0) * (x.dim() - 2) + (half, half))
    summed = padded.narrow(1, 0, C)
    for i in range(1, n):
        summed = summed + padded.narrow(1, i, C)
    return x / torch.pow(k + alpha * summed, beta)
