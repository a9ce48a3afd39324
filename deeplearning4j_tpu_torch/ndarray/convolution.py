"""Convolution helper ops — im2col / col2im.

The counterpart of ``deeplearning4j_tpu/ndarray/convolution.py``
(reference: org.nd4j.linalg.convolution.Convolution). ``im2col`` pads
(Same mode's padding may be asymmetric) and unfolds in one call;
``col2im`` folds, summing the overlapping patch contributions, and crops
the padding: it is im2col's exact adjoint, as the reference's is by
construction (a linear transpose). ``_geometry`` keeps the reference's
Same/Truncate arithmetic.

Layouts follow upstream: images are NCHW [B, C, H, W]; the column
tensor is [B, C, kH, kW, outH, outW].
"""

from __future__ import annotations

import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray, as_tensor

__all__ = ["Convolution", "im2col", "col2im"]


def _geometry(h, w, kh, kw, sy, sx, ph, pw, isSameMode):
    if isSameMode:
        # upstream's same mode: output spatial = ceil(in / stride); the
        # padding that achieves it is derived, ph/pw are ignored
        oh = -(-h // sy)
        ow = -(-w // sx)
        pad_h = max((oh - 1) * sy + kh - h, 0)
        pad_w = max((ow - 1) * sx + kw - w, 0)
        padding = ((pad_h // 2, pad_h - pad_h // 2),
                   (pad_w // 2, pad_w - pad_w // 2))
    else:
        oh = (h + 2 * ph - kh) // sy + 1
        ow = (w + 2 * pw - kw) // sx + 1
        padding = ((ph, ph), (pw, pw))
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"kernel ({kh}x{kw}) with stride ({sy},{sx}) and padding "
            f"{padding} does not fit a {h}x{w} input")
    return oh, ow, padding


def im2col(img, kh, kw, sy=1, sx=1, ph=0, pw=0, isSameMode=False):
    """[B, C, H, W] -> [B, C, kH, kW, outH, outW] (reference:
    Convolution.im2col)."""
    x = as_tensor(img)
    if x.ndim != 4:
        raise ValueError(f"im2col expects NCHW [B,C,H,W], got "
                         f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    oh, ow, ((pt, pb), (pl, pr)) = _geometry(h, w, kh, kw, sy, sx, ph, pw,
                                             isSameMode)
    xp = F.pad(x, (pl, pr, pt, pb))
    # [B, C*kh*kw, outH*outW], channel-major (C, then kh, then kw)
    cols = F.unfold(xp, (kh, kw), stride=(sy, sx))
    return INDArray(cols.reshape(b, c, kh, kw, oh, ow))


def col2im(col, sy=1, sx=1, ph=0, pw=0, h=None, w=None, isSameMode=False):
    """[B, C, kH, kW, outH, outW] -> [B, C, H, W], summing overlapping
    patch contributions (reference: Convolution.col2im)."""
    y = as_tensor(col)
    if y.ndim != 6:
        raise ValueError(
            f"col2im expects [B,C,kH,kW,outH,outW], got {tuple(y.shape)}")
    if h is None or w is None:
        raise ValueError("col2im needs the target h and w")
    b, c, kh, kw, oh, ow = y.shape
    exp_oh, exp_ow, ((pt, pb), (pl, pr)) = _geometry(
        h, w, kh, kw, sy, sx, ph, pw, isSameMode)
    if (oh, ow) != (exp_oh, exp_ow):
        raise ValueError(
            f"column tensor spatial dims {(oh, ow)} do not match the "
            f"declared geometry (expected {(exp_oh, exp_ow)} for "
            f"h={h}, w={w}, stride=({sy},{sx}), pad=({ph},{pw}))")
    img = F.fold(y.reshape(b, c * kh * kw, oh * ow),
                 (h + pt + pb, w + pl + pr), (kh, kw), stride=(sy, sx))
    return INDArray(img[:, :, pt:pt + h, pl:pl + w].contiguous())


class Convolution:
    """Namespace parity with org.nd4j.linalg.convolution.Convolution."""

    im2col = staticmethod(im2col)
    col2im = staticmethod(col2im)
