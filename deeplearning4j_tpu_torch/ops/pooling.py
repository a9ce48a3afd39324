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

The reference's ``argmax`` and ``indices`` backward variants and their
knobs (``DL4J_TPU_MAXPOOL_BWD``, ``DL4J_TPU_GLOBAL_MAXPOOL_BWD``) are
not on its default path and are not ported (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.conv import _pair, same_pads

__all__ = ["max_pool2d", "avg_pool2d", "pnorm_pool2d", "global_pool",
           "upsample2d", "max_pool3d", "avg_pool3d", "upsample3d"]


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


def max_pool2d(x, kernel, stride, padding):
    """Max pooling over [B,C,H,W]; first-match gradient on ties."""
    k, s = _pair(kernel), _pair(stride)
    pads, _, _ = _pool_pads(x.shape[2], x.shape[3], k, s, padding)
    x, pad = _padded(x, pads, k, -math.inf)
    return F.max_pool2d(x, k, s, pad)


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
