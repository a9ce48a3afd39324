"""Pooling: 2D max/avg/pnorm pooling and global pooling.

The counterpart of ``deeplearning4j_tpu/ops/pooling.py``'s default path:
``_pool_pads``, the stock ``max_pool2d`` (the reference's
``max_pool2d_reference`` oracle, ``lax.reduce_window`` with ``-inf``
padding, whose gradient is select-and-scatter), ``avg_pool2d``
(``count_include_pad``), ``pnorm_pool2d``, ``global_pool``, the
nearest-neighbour ``upsample2d`` and the 3-d ``max_pool3d``,
``avg_pool3d`` and ``upsample3d`` over NCDHW-logical tensors. Tensors
are NCHW-logical (``channels_last`` memory on the CNN path); the
reference's NHWC axes (1, 2) are the port's (2, 3).

Gradient semantics, as the reference's stock path:

* ``max_pool2d``: every window's cotangent goes to the FIRST maximum of
  the window in row-major order, on ties too (select-and-scatter's
  ``ge`` select; ``F.max_pool2d``'s saved indices keep the first).
  Padding is ``-inf``, so a pad never wins. ``F.max_pool2d`` takes a
  symmetric pad of at most half the kernel; any other pad is applied
  with ``F.pad(-inf)`` first.
* ``global_pool(.., "max")``: ``amax``, which splits the cotangent
  evenly among tied maxima, as ``jnp.max``'s autodiff does.

The reference's backward variants, selected by its knobs (the autotune
arbiter's ``maxpool_bwd`` and ``global_maxpool_bwd``; initial values
from ``DL4J_TPU_MAXPOOL_BWD`` and ``DL4J_TPU_GLOBAL_MAXPOOL_BWD``,
default "stock"):

* ``set_maxpool_bwd("indices")`` (``_MaxPoolIndices``): the forward
  takes the max and each window's winner in one pass of k*k strided
  slices and saves the winner as int8; for non-overlapping windows
  (stride >= kernel, at most ``_ARGMAX_BWD_MAX_WINDOW`` elements) the
  backward is one elementwise pass over the upsampled cotangent.
  Overlapping windows keep the stock gradient.
* ``set_maxpool_bwd("argmax")`` (``_MaxPoolArgmax``): saves x and
  recomputes the winner in the backward, routing the cotangent back with
  k*k strided adds (accumulated in fp32 for bf16/fp16).
* ``set_global_maxpool_bwd("indices")`` (``_GlobalMaxIndices``): saves
  the argmax, so the whole cotangent goes to the first maximum.

The window winner is the FIRST maximum in row-major order (strict ``>``
over the slices), the stock gradient's tie rule, so the max-pool
variants give the stock gradient: bitwise for non-overlapping windows.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.conv import _pair, same_pads

__all__ = ["max_pool2d", "avg_pool2d", "pnorm_pool2d", "global_pool",
           "upsample2d", "max_pool3d", "avg_pool3d", "upsample3d",
           "set_maxpool_bwd", "set_global_maxpool_bwd"]

#: windows larger than this keep the stock gradient under "argmax" and
#: "indices" (the winner index is saved as int8)
_ARGMAX_BWD_MAX_WINDOW = 36

_BACKWARD_IMPLS = ("stock", "argmax", "indices")
_BACKWARD_IMPL = os.environ.get("DL4J_TPU_MAXPOOL_BWD", "stock").lower()
if _BACKWARD_IMPL not in _BACKWARD_IMPLS:
    raise ValueError(
        f"DL4J_TPU_MAXPOOL_BWD must be one of {_BACKWARD_IMPLS}, got "
        f"{os.environ['DL4J_TPU_MAXPOOL_BWD']!r}")

_GLOBAL_IMPLS = ("stock", "indices")
_GLOBAL_MAXPOOL_BWD = os.environ.get(
    "DL4J_TPU_GLOBAL_MAXPOOL_BWD", "stock").lower()
if _GLOBAL_MAXPOOL_BWD not in _GLOBAL_IMPLS:
    raise ValueError(
        f"DL4J_TPU_GLOBAL_MAXPOOL_BWD must be one of {_GLOBAL_IMPLS}, "
        f"got {os.environ['DL4J_TPU_GLOBAL_MAXPOOL_BWD']!r}")


def set_maxpool_bwd(impl):
    """Set the max_pool2d backward ("stock", "argmax" or "indices");
    returns the previous value (the autotune arbiter's entry)."""
    global _BACKWARD_IMPL
    impl = str(impl).lower()
    if impl not in _BACKWARD_IMPLS:
        raise ValueError(
            f"maxpool_bwd must be one of {_BACKWARD_IMPLS}, got {impl!r}")
    old, _BACKWARD_IMPL = _BACKWARD_IMPL, impl
    return old


def set_global_maxpool_bwd(impl):
    """Set the global max-pool backward ("stock" or "indices"); returns
    the previous value."""
    global _GLOBAL_MAXPOOL_BWD
    impl = str(impl).lower()
    if impl not in _GLOBAL_IMPLS:
        raise ValueError(
            f"global_maxpool_bwd must be one of {_GLOBAL_IMPLS}, "
            f"got {impl!r}")
    old, _GLOBAL_MAXPOOL_BWD = _GLOBAL_MAXPOOL_BWD, impl
    return old


def _pool_pads(H, W, k, s, padding):
    """``padding`` ("SAME" or ((lo, hi), (lo, hi))) -> (explicit pads,
    Ho, Wo) for an H x W input (reference: ``_pool_pads``)."""
    if padding == "SAME":
        pads = (same_pads(H, k[0], s[0]), same_pads(W, k[1], s[1]))
    else:
        pads = (tuple(padding[0]), tuple(padding[1]))
    Ho = (H + pads[0][0] + pads[0][1] - k[0]) // s[0] + 1
    Wo = (W + pads[1][0] + pads[1][1] - k[1]) // s[1] + 1
    return pads, Ho, Wo


def _padded(x, pads, k, value):
    """(x, the pad ``F.*_pool2d`` takes itself): a symmetric pad of at
    most half the kernel stays with the pool op, any other is applied
    here with `value`."""
    (t, b), (l, r) = pads
    if t == b and l == r and t <= k[0] // 2 and l <= k[1] // 2:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _choose_pool_bwd(k, s, *, impl):
    """The backward a (kernel, stride) pair takes under `impl`
    (reference: ``_choose_pool_bwd``): "indices" needs non-overlapping
    windows, both variants at most ``_ARGMAX_BWD_MAX_WINDOW`` elements;
    anything else is "stock"."""
    if k[0] * k[1] > _ARGMAX_BWD_MAX_WINDOW:
        return "stock"
    if impl == "indices":
        return "indices" if s[0] >= k[0] and s[1] >= k[1] else "stock"
    return impl


def _like(y, x):
    """y in x's memory format (channels_last stays channels_last)."""
    if x.dim() == 4 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


def _window_slices(xp, k, s, Ho, Wo):
    """The k*k strided views of the padded input, one per in-window
    offset, in row-major order."""
    for dh in range(k[0]):
        for dw in range(k[1]):
            yield xp[:, :, dh:dh + (Ho - 1) * s[0] + 1:s[0],
                     dw:dw + (Wo - 1) * s[1] + 1:s[1]]


def _max_and_winner(x, k, s, pads, Ho, Wo):
    """(max, winner offset int8) of every window; strict ``>`` keeps the
    first maximum (reference: ``_max_pool2d_indices_fwd_math``)."""
    (t, b), (l, r) = pads
    xp = F.pad(x, (l, r, t, b), value=-math.inf) if t or b or l or r else x
    best = besti = None
    for j, v in enumerate(_window_slices(xp, k, s, Ho, Wo)):
        if best is None:
            best, besti = v, torch.zeros(v.shape, dtype=torch.int8,
                                         device=x.device)
        else:
            take = v > best
            best = torch.where(take, v, best)
            besti = torch.where(take, torch.full((), j, dtype=torch.int8,
                                                 device=x.device), besti)
    return best, besti


class _MaxPoolIndices(torch.autograd.Function):
    """Max pooling over non-overlapping windows that saves the int8
    winner (reference: ``_max_pool2d_indices``)."""

    @staticmethod
    def forward(ctx, x, k, s, pads, Ho, Wo):
        y, besti = _max_and_winner(x, k, s, pads, Ho, Wo)
        ctx.meta = (k, s, pads, tuple(x.shape[2:]))
        ctx.save_for_backward(besti)
        return _like(y, x)

    @staticmethod
    def backward(ctx, dy):
        (besti,) = ctx.saved_tensors
        k, s, pads, (H, W) = ctx.meta
        Ho, Wo = dy.shape[2], dy.shape[3]
        dy_up = dy.repeat_interleave(s[0], 2).repeat_interleave(s[1], 3)
        bi_up = besti.repeat_interleave(s[0], 2).repeat_interleave(s[1], 3)
        Hc, Wc = Ho * s[0], Wo * s[1]
        hp = torch.arange(Hc, device=dy.device) % s[0]
        wp = torch.arange(Wc, device=dy.device) % s[1]
        jpat = (hp[:, None] * k[1] + wp[None, :]).to(torch.int8)
        covered = (hp[:, None] < k[0]) & (wp[None, :] < k[1])
        dxp = torch.where((bi_up == jpat) & covered, dy_up,
                          torch.zeros((), dtype=dy.dtype, device=dy.device))
        need_h, need_w = pads[0][0] + H, pads[1][0] + W
        if need_h > Hc or need_w > Wc:
            dxp = F.pad(dxp, (0, max(0, need_w - Wc), 0, max(0, need_h - Hc)))
        dx = dxp[:, :, pads[0][0]:need_h, pads[1][0]:need_w]
        return _like(dx, dy), None, None, None, None, None


class _MaxPoolArgmax(torch.autograd.Function):
    """Max pooling that saves x and recomputes each window's winner in
    the backward (reference: ``_max_pool2d_argmax``)."""

    @staticmethod
    def forward(ctx, x, k, s, pads, Ho, Wo):
        y, _ = _max_and_winner(x, k, s, pads, Ho, Wo)
        ctx.meta = (k, s, pads, Ho, Wo)
        ctx.save_for_backward(x)
        return _like(y, x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        k, s, pads, Ho, Wo = ctx.meta
        _, besti = _max_and_winner(x, k, s, pads, Ho, Wo)
        (t, b), (l, r) = pads
        B, C, H, W = x.shape
        acc = torch.promote_types(dy.dtype, torch.float32)
        dxp = torch.zeros((B, C, H + t + b, W + l + r), dtype=acc,
                          device=dy.device)
        dya = dy.to(acc)
        zero = torch.zeros((), dtype=acc, device=dy.device)
        for j, view in enumerate(_window_slices(dxp, k, s, Ho, Wo)):
            view.add_(torch.where(besti == j, dya, zero))
        dx = dxp[:, :, t:t + H, l:l + W].to(dy.dtype)
        return _like(dx, x), None, None, None, None, None


def max_pool2d(x, kernel, stride, padding):
    """Max pooling over [B,C,H,W]; first-match gradient on ties, by the
    backward the ``maxpool_bwd`` knob selects (module docstring)."""
    k, s = _pair(kernel), _pair(stride)
    pads, Ho, Wo = _pool_pads(x.shape[2], x.shape[3], k, s, padding)
    impl = _choose_pool_bwd(k, s, impl=_BACKWARD_IMPL)
    if impl == "indices":
        return _MaxPoolIndices.apply(x, k, s, pads, Ho, Wo)
    if impl == "argmax":
        return _MaxPoolArgmax.apply(x, k, s, pads, Ho, Wo)
    x, pad = _padded(x, pads, k, -math.inf)
    return F.max_pool2d(x, k, s, pad)


class _GlobalMaxIndices(torch.autograd.Function):
    """Global max over a contiguous run of dims that saves the argmax,
    so the cotangent goes to the first maximum (reference:
    ``_global_max_indices``)."""

    @staticmethod
    def forward(ctx, x, dims):
        xr = x.flatten(dims[0], dims[-1])
        y, idx = xr.max(dim=dims[0])
        ctx.meta = (dims, tuple(x.shape), xr.shape)
        ctx.save_for_backward(idx)
        return y

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        dims, shape, rshape = ctx.meta
        dxr = torch.zeros(rshape, dtype=dy.dtype, device=dy.device)
        dxr.scatter_(dims[0], idx.unsqueeze(dims[0]), dy.unsqueeze(dims[0]))
        return dxr.reshape(shape), None


def avg_pool2d(x, kernel, stride, padding, count_include_pad=True):
    """Average pooling. Explicit pads with ``count_include_pad`` divide
    by k*k; "SAME" or ``count_include_pad=False`` divide by the number
    of real (unpadded) inputs in each window, as the reference does."""
    k, s = _pair(kernel), _pair(stride)
    pads, _, _ = _pool_pads(x.shape[2], x.shape[3], k, s, padding)
    xp, pad = _padded(x, pads, k, 0.0)
    if count_include_pad and padding != "SAME":
        return F.avg_pool2d(xp, k, s, pad, count_include_pad=True)
    summed = F.avg_pool2d(xp, k, s, pad, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    op, pad = _padded(ones, pads, k, 0.0)
    counts = F.avg_pool2d(op, k, s, pad, divisor_override=1)
    return summed / counts


def _root(summed, p):
    """summed^(1/p) with the gradient 0 where summed is 0 (a window of
    zeros), where the plain power's is 0·inf = NaN."""
    pos = summed > 0
    return torch.where(pos, torch.where(pos, summed, 1.0).pow(1.0 / p), 0.0)


def pnorm_pool2d(x, kernel, stride, padding, p=2):
    """(sum over the window of |x|^p)^(1/p), zero padding; a window of
    zeros has the gradient 0 (``_root``)."""
    k, s = _pair(kernel), _pair(stride)
    pads, _, _ = _pool_pads(x.shape[2], x.shape[3], k, s, padding)
    xp, pad = _padded(x.abs().pow(p), pads, k, 0.0)
    return _root(F.avg_pool2d(xp, k, s, pad, divisor_override=1), p)


def global_pool(x, pooling_type, dims, mask=None, pnorm=2):
    """Global pooling over `dims`, with an optional mask broadcastable to
    x (reference: ``global_pool``, stock path)."""
    t = str(pooling_type).lower()
    denom = None
    if mask is not None:
        m = mask.expand_as(x)
        x = torch.where(m > 0, x, -torch.inf) if t == "max" else x * m
        denom = torch.clamp(m.sum(dim=dims), min=1.0)
    if t == "max":
        dims = tuple(sorted(dims))
        if _GLOBAL_MAXPOOL_BWD == "indices" \
                and dims == tuple(range(dims[0], dims[-1] + 1)):
            return _GlobalMaxIndices.apply(x, dims)
        return x.amax(dim=dims)
    if t == "sum":
        return x.sum(dim=dims)
    if t == "avg":
        return x.sum(dim=dims) / denom if denom is not None \
            else x.mean(dim=dims)
    if t == "pnorm":
        return _root(x.abs().pow(pnorm).sum(dim=dims), pnorm)
    raise ValueError(f"Unknown pooling type '{pooling_type}'")


def upsample2d(x, size):
    """Nearest-neighbour upsampling of [B,C,H,W] by integer factors
    (reference: ``upsample2d``, a repeat of rows then columns): each
    pixel becomes an sh x sw block. Built as a broadcast of the NHWC
    view, so the result is one copy in channels_last memory; the
    gradient sums each block."""
    sh, sw = _pair(size)
    B, C, H, W = x.shape
    v = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    v = v.expand(B, H, sh, W, sw, C).reshape(B, H * sh, W * sw, C)
    return v.permute(0, 3, 1, 2)


def _triple(v):
    return (int(v),) * 3 if isinstance(v, int) else tuple(int(a) for a in v)


def _pool3d_pads(x, k, s, padding):
    """"SAME" or ((lo, hi),) * 3 -> explicit pads for x [B,C,D,H,W]."""
    if padding == "SAME":
        return tuple(same_pads(n, kk, ss)
                     for n, kk, ss in zip(x.shape[2:], k, s))
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad3d(x, pads, value):
    flat = tuple(v for lo_hi in reversed(pads) for v in lo_hi)
    return F.pad(x, flat, value=value) if any(flat) else x


def max_pool3d(x, kernel, stride, padding):
    """3-d max pooling over [B,C,D,H,W] (reference: ``max_pool3d``,
    ``lax.reduce_window`` with ``-inf`` padding: the cotangent goes to
    each window's first maximum). Pads are applied as ``-inf`` first."""
    k, s = _triple(kernel), _triple(stride)
    x = _pad3d(x, _pool3d_pads(x, k, s, padding), -math.inf)
    return F.max_pool3d(x, k, s)


def avg_pool3d(x, kernel, stride, padding, count_include_pad=True):
    """3-d average pooling (reference: ``avg_pool3d``): explicit pads
    with ``count_include_pad`` divide by the window's volume; "SAME" or
    ``count_include_pad=False`` by the number of real inputs in each
    window."""
    k, s = _triple(kernel), _triple(stride)
    pads = _pool3d_pads(x, k, s, padding)
    summed = F.avg_pool3d(_pad3d(x, pads, 0.0), k, s, divisor_override=1)
    if count_include_pad and padding != "SAME":
        return summed / (k[0] * k[1] * k[2])
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool3d(_pad3d(ones, pads, 0.0), k, s, divisor_override=1)
    return summed / counts


def upsample3d(x, size):
    """Nearest-neighbour upsampling of [B,C,D,H,W] by integer factors
    (reference: ``Upsampling3D``, a repeat along D, H then W)."""
    sd, sh, sw = _triple(size)
    B, C, D, H, W = x.shape
    v = x[:, :, :, None, :, None, :, None]
    v = v.expand(B, C, D, sd, H, sh, W, sw)
    return v.reshape(B, C, D * sd, H * sh, W * sw)
