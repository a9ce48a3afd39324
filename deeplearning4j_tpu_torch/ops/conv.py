"""1-d and 2-d convolution.

The counterpart of ``deeplearning4j_tpu/ops/conv.py`` for the CNN
training path: ``_pair``, ``explicit_padding`` (the Same/Truncate
arithmetic), ``conv2d``, ``conv1d`` (NCW over ``[out, in, k]``),
``conv3d`` (NDHWC over a DHWIO kernel, the reference's layouts, for
SameDiff's ``conv3d`` op) and its transpose ``deconv3d`` with
``deconv3d_explicit_padding`` (the ``Deconvolution3D`` layer), the
transposed convolution ``deconv2d`` with its padding and
``deconv_output_size``, and ``conv_output_size``; and the block
rearrangements ``space_to_depth`` / ``depth_to_space`` /
``space_to_batch`` / ``batch_to_space`` over NHWC arrays (the
reference's ``autodiff/ops_impl.py`` ops, which the ``SpaceToDepth``
layer and SameDiff share). The reference keeps
activations NHWC and weights HWIO and lowers to ``lax.conv``; the port
computes with ``F.conv2d`` (cuDNN on the card) on NCHW-logical tensors
held in ``torch.channels_last`` memory, with OIHW weights, so a
channels_last input and weight meet the card's NHWC convolution kernels
with no relayout. The reference computes conv outside any Pallas kernel,
so no hand-written kernel stands here.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

__all__ = ["explicit_padding", "resolve_pads", "same_pads", "conv2d",
           "conv1d", "conv_output_size", "deconv_explicit_padding",
           "deconv2d", "deconv_output_size", "space_to_depth",
           "depth_to_space", "space_to_batch", "batch_to_space", "conv3d",
           "deconv3d", "deconv3d_explicit_padding"]


def _pair(v):
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def same_pads(size, kernel, stride, dilation=1):
    """(lo, hi) of TF-style "SAME" padding along one axis: the output is
    ceil(size / stride), the total pad split with the extra row at the
    end (``lax``'s "SAME")."""
    k_eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def explicit_padding(mode, padding, kernel, stride, dilation):
    """A ConvolutionMode + configured padding -> "SAME" or explicit
    ((lo, hi), (lo, hi)) pairs (reference: ``explicit_padding``; Same
    computes TF-style same padding, Truncate/Strict use the pads)."""
    if str(mode).lower() == "same":
        return "SAME"
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def resolve_pads(padding, H, W, kernel, stride, dilation=(1, 1)):
    """"SAME" or explicit pairs -> explicit ((lo, hi), (lo, hi)) for an
    input of H x W."""
    if padding == "SAME":
        k, s, d = _pair(kernel), _pair(stride), _pair(dilation)
        return (same_pads(H, k[0], s[0], d[0]), same_pads(W, k[1], s[1], d[1]))
    return (tuple(padding[0]), tuple(padding[1]))


def conv2d(x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
           dilation=(1, 1), groups=1):
    """x: [B,Cin,H,W] (any memory format), w: [Cout,Cin/groups,kh,kw]
    -> [B,Cout,H',W']. ``padding`` is "SAME" or ((lo, hi), (lo, hi));
    asymmetric pairs go through ``F.pad``. The bias is added after the
    convolution, as a second op, where the reference adds it (under bf16
    the product is rounded before the add, as there)."""
    kh, kw = w.shape[2], w.shape[3]
    (t, bo), (l, r) = resolve_pads(padding, x.shape[2], x.shape[3],
                                   (kh, kw), stride, dilation)
    if t == bo and l == r:
        pad = (t, l)
    else:
        x = F.pad(x, (l, r, t, bo))
        pad = (0, 0)
    y = F.conv2d(x, w, None, _pair(stride), pad, _pair(dilation), groups)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def conv1d(x, w, b=None, stride=1, padding=((0, 0),), dilation=1):
    """x: [B,Cin,T], w: [Cout,Cin,k] -> [B,Cout,T'] (reference:
    ``conv1d``, NWC over a WIO kernel). ``padding`` is "SAME" or
    ((lo, hi),); the bias is added after the convolution."""
    lo, hi = (same_pads(x.shape[2], w.shape[2], int(stride), int(dilation))
              if padding == "SAME" else tuple(padding[0]))
    if lo != hi:
        x = F.pad(x, (lo, hi))
        lo = 0
    y = F.conv1d(x, w, None, int(stride), lo, int(dilation))
    return y if b is None else y + b.reshape(1, -1, 1)


def conv3d(x, w, b=None, stride=(1, 1, 1), padding=((0, 0),) * 3,
           dilation=(1, 1, 1)):
    """x: [B,D,H,W,Cin], w: [kd,kh,kw,Cin,Cout] -> [B,D',H',W',Cout]
    (reference: ``conv3d``, NDHWC over DHWIO). The views in torch's
    NCDHW/OIDHW order are free (channels_last_3d strides); asymmetric
    pads go through ``F.pad``; the bias is added after the product."""
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2)
    pads = [tuple(int(v) for v in p) for p in padding]
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, tuple(v for lo, hi in reversed(pads)
                             for v in (lo, hi)))
        pad = 0
    y = F.conv3d(xc, wc, None, tuple(int(s) for s in stride), pad,
                 tuple(int(d) for d in dilation))
    y = y.permute(0, 2, 3, 4, 1)
    return y if b is None else y + b


def conv_output_size(size, kernel, stride, pad, dilation, mode):
    """Spatial shape inference (reference: ``conv_output_size``, after
    ConvolutionUtils.getOutputSize)."""
    k_eff = (kernel - 1) * dilation + 1
    if str(mode).lower() == "same":
        return int(np.ceil(size / stride))
    return (size + 2 * pad - k_eff) // stride + 1


def deconv_output_size(size, kernel, stride, pad, dilation, mode):
    """The transposed convolution's output size (reference:
    ``deconv_output_size``): ``size * stride`` in Same mode, else
    ``stride * (size - 1) + k_eff - 2 * pad``."""
    k_eff = (kernel - 1) * dilation + 1
    if str(mode).lower() == "same":
        return size * stride
    return stride * (size - 1) + k_eff - 2 * pad


def deconv_explicit_padding(mode, padding, kernel, dilation):
    """A ConvolutionMode + configured pad -> "SAME" or the (lo, hi)
    pairs of ``lax.conv_transpose`` (reference: ``_deconv_pads``):
    ``k_eff - 1 - pad`` on each side, which give the output size
    ``s * (in - 1) + k_eff - 2 * pad``."""
    if str(mode).lower() == "same":
        return "SAME"
    return tuple((k_eff - 1 - p, k_eff - 1 - p) for p, k_eff in zip(
        _pair(padding), ((k - 1) * d + 1 for k, d in zip(_pair(kernel),
                                                         _pair(dilation)))))


def deconv3d_explicit_padding(mode, padding, kernel, dilation):
    """``deconv_explicit_padding`` over three spatial axes (reference:
    ``deconv3d_explicit_padding``)."""
    if str(mode).lower() == "same":
        return "SAME"
    return tuple((k_eff - 1 - int(p), k_eff - 1 - int(p))
                 for p, k_eff in zip(padding, ((int(k) - 1) * int(d) + 1
                                               for k, d in zip(kernel,
                                                               dilation))))


def _transpose_same_pads(k_eff, s):
    """``lax.conv_transpose``'s (lo, hi) for "SAME" along one axis."""
    pad_len = k_eff + s - 2
    lo = k_eff - 1 if s > k_eff - 1 else int(np.ceil(pad_len / 2))
    return lo, pad_len - lo


def deconv2d(x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
             dilation=(1, 1)):
    """The reference's transposed convolution: ``lax.conv_transpose`` of
    x [B,Cin,H,W] with its kernel UNFLIPPED (the port holds it flipped as
    ``conv_transpose2d``'s [Cin, Cout, kh, kw]; ``Deconvolution2D``'s
    layout map) and the (lo, hi) pads of ``deconv_explicit_padding``.
    ``F.conv_transpose2d`` at pad 0 gives the output of pads (k_eff - 1,
    k_eff - 1); each side is then cropped (a negative ``F.pad``) or
    padded with zeros to the asked pads."""
    s, d = _pair(stride), _pair(dilation)
    k_eff = [(k - 1) * dd + 1 for k, dd in zip(w.shape[2:], d)]
    if padding == "SAME":
        padding = tuple(_transpose_same_pads(k, ss)
                        for k, ss in zip(k_eff, s))
    y = F.conv_transpose2d(x, w, None, s, 0, 0, 1, d)
    (t, bo), (l, r) = padding
    adj = (l - (k_eff[1] - 1), r - (k_eff[1] - 1),
           t - (k_eff[0] - 1), bo - (k_eff[0] - 1))
    if any(adj):
        y = F.pad(y, adj)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def deconv3d(x, w, b=None, stride=(1, 1, 1), padding=((0, 0),) * 3,
             dilation=(1, 1, 1)):
    """The reference's transposed 3-d convolution (``lax.conv_transpose``
    of NDHWC x over its DHWIO kernel [kd, kh, kw, Cin, Cout], unflipped,
    read in the forward layout), on x [B,Cin,D,H,W] in any memory
    format, with the kernel held as ``conv_transpose3d``'s flipped
    [Cin, Cout, kd, kh, kw] (``Deconvolution3D``'s layout map). As
    ``deconv2d``: pad 0, then each side cropped or zero-padded to the
    asked (lo, hi) pads."""
    s = tuple(int(v) for v in stride)
    d = tuple(int(v) for v in dilation)
    k_eff = [(k - 1) * dd + 1 for k, dd in zip(w.shape[2:], d)]
    if padding == "SAME":
        padding = tuple(_transpose_same_pads(k, ss)
                        for k, ss in zip(k_eff, s))
    y = F.conv_transpose3d(x, w, None, s, 0, 0, 1, d)
    adj = []
    for (lo, hi), k in reversed(list(zip(padding, k_eff))):
        adj += [int(lo) - (k - 1), int(hi) - (k - 1)]
    if any(adj):
        y = F.pad(y, tuple(adj))
    return y if b is None else y + b.reshape(1, -1, 1, 1, 1)


def space_to_depth(x, blockSize=2):
    """[B,H,W,C] -> [B,H/b,W/b,C·b·b], output channel ``(s·b + t)·C + c``
    for the pixel (s, t) of each b x b block (reference:
    ``spaceToDepth``). ``F.pixel_unshuffle`` orders the channels
    ``c·b² + s·b + t``, another layout, so it is not used."""
    B, H, W, C = x.shape
    b = int(blockSize)
    x = x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // b, W // b, C * b * b)


def space_to_batch(x, blockSize=2, padding=((0, 0), (0, 0))):
    """[B,H,W,C] -> [B·b·b,(H+pads)/b,(W+pads)/b,C] after zero padding,
    batch index ``(s·b + t)·B + n`` for the pixel (s, t) of each block
    (reference: ``spaceToBatch``)."""
    (pt, pb), (pl, pr) = padding
    x = F.pad(x, (0, 0, pl, pr, pt, pb))
    B, H, W, C = x.shape
    b = int(blockSize)
    x = x.reshape(B, H // b, b, W // b, b, C).permute(2, 4, 0, 1, 3, 5)
    return x.reshape(B * b * b, H // b, W // b, C)


def depth_to_space(x, blockSize=2):
    """The inverse of ``space_to_depth`` (reference: ``depthToSpace``)."""
    B, H, W, C = x.shape
    b = int(blockSize)
    x = x.reshape(B, H, W, b, b, C // (b * b)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * b, W * b, C // (b * b))


def batch_to_space(x, blockSize=2, crops=((0, 0), (0, 0))):
    """The inverse of ``space_to_batch``, then the crops (reference:
    ``batchToSpace``, which refuses a batch not divisible by blockSize²
    and crops larger than the expanded image)."""
    b = int(blockSize)
    Bb, H, W, C = x.shape
    if Bb % (b * b):
        raise ValueError(
            f"batchToSpace needs batch ({Bb}) divisible by "
            f"blockSize^2 ({b * b})")
    B = Bb // (b * b)
    x = x.reshape(b, b, B, H, W, C).permute(2, 3, 0, 4, 1, 5)
    x = x.reshape(B, H * b, W * b, C)
    (ct, cb), (cl, cr) = (tuple(int(v) for v in q) for q in crops)
    if ct + cb > x.shape[1] or cl + cr > x.shape[2]:
        raise ValueError(f"crops {crops} exceed the expanded spatial dims "
                         f"{x.shape[1]}x{x.shape[2]}")
    return x[:, ct:x.shape[1] - cb, cl:x.shape[2] - cr, :]
