"""2D convolution.

The counterpart of ``deeplearning4j_tpu/ops/conv.py`` for the CNN
training path: ``_pair``, ``explicit_padding`` (the Same/Truncate
arithmetic), ``conv2d`` and ``conv_output_size``. The reference keeps
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
           "conv_output_size"]


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


def conv_output_size(size, kernel, stride, pad, dilation, mode):
    """Spatial shape inference (reference: ``conv_output_size``, after
    ConvolutionUtils.getOutputSize)."""
    k_eff = (kernel - 1) * dilation + 1
    if str(mode).lower() == "same":
        return int(np.ceil(size / stride))
    return (size + 2 * pad - k_eff) // stride + 1
