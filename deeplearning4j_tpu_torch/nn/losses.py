"""Loss functions.

The counterpart of ``deeplearning4j_tpu/nn/losses.py``:
``compute(loss, labels, preact, activation, mask, weights)`` is the mean
loss over the batch from PRE-activation outputs, so softmax + MCXENT is
the stable log-softmax form. Masked elements contribute nothing and the
mean is over the unmasked ones (``_apply_mask_mean``). ``weights`` scales
each output column; SPARSE_MCXENT, whose labels are class indices,
gathers each example's class weight. The dtype policy is the reference's
default ("compute") tail: under a sub-fp32 compute dtype the
activation-scale tensors stay in that dtype and fp32 appears only in the
reduction accumulators and the per-row logsumexp (``tail_dtype`` says
what a trainer casts to first). ``_TAIL_MODE`` "wide" (the autotune
arbiter's ``loss_tail`` knob; initial value from ``DL4J_TPU_LOSS_TAIL``)
is the reference's all-fp32 tail: ``tail_dtype`` then widens.

All the reference's losses: MCXENT / NEGATIVELOGLIKELIHOOD, SPARSE_MCXENT,
XENT (and its alias RECONSTRUCTION_CROSSENTROPY), MSE / L2, MAE / L1,
HINGE, SQUARED_HINGE, KL_DIVERGENCE, POISSON, COSINE_PROXIMITY, MAPE,
MSLE and WASSERSTEIN.
"""

from __future__ import annotations

import os

import torch

from deeplearning4j_tpu_torch.nn import activations as _act

__all__ = ["LossFunctions", "compute", "tail_dtype"]

#: "compute" (default): activation-scale loss math in the compute dtype;
#: "wide": the all-fp32 tail
_TAIL_MODE = os.environ.get("DL4J_TPU_LOSS_TAIL", "compute")


def tail_dtype(dtype):
    """The dtype a trainer casts preact/labels to before the loss: fp32
    (or fp64) when the compute dtype is already that wide, else the
    compute dtype itself; the fp32 accumulation then happens inside the
    reduces here."""
    wide = torch.promote_types(dtype, torch.float32)
    return wide if _TAIL_MODE == "wide" or dtype == wide else dtype


def _log_softmax(preact):
    """log_softmax whose fp32 appears only at vector scale: the max and
    the logsumexp accumulate in fp32, the [.., O] tensors stay in the
    input dtype."""
    ft = torch.promote_types(preact.dtype, torch.float32)
    if preact.dtype == ft:
        return torch.log_softmax(preact, dim=-1)
    s = preact - preact.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(s).sum(-1, keepdim=True, dtype=ft))
    return s - lse.to(preact.dtype)


class LossFunctions:
    class LossFunction:
        MSE = "mse"
        L2 = "l2"
        MAE = "mae"
        L1 = "l1"
        MCXENT = "mcxent"
        NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
        XENT = "xent"
        HINGE = "hinge"
        SQUARED_HINGE = "squared_hinge"
        KL_DIVERGENCE = "kl_divergence"
        POISSON = "poisson"
        COSINE_PROXIMITY = "cosine_proximity"
        SPARSE_MCXENT = "sparse_mcxent"
        MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"
        MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
        WASSERSTEIN = "wasserstein"
        RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"


def _apply_mask_mean(per_elem, mask):
    """Mean over unmasked elements of per_elem [batch, ...], summed in
    fp32 (fp64 for fp64); the result is at least fp32."""
    ft = torch.promote_types(per_elem.dtype, torch.float32)
    if mask is None:
        dims = tuple(range(1, per_elem.dim()))
        rows = per_elem.sum(dim=dims, dtype=ft) if dims \
            else per_elem.to(ft)
        return rows.mean()
    mask = mask.to(per_elem.dtype)
    n_unmasked = torch.clamp(mask.sum(dtype=ft), min=1.0)
    while mask.dim() < per_elem.dim():
        mask = mask[..., None]
    return (per_elem * mask).sum(dtype=ft) / n_unmasked


def _weighted(per, weights):
    if weights is None:
        return per
    return per * torch.as_tensor(weights, dtype=per.dtype,
                                 device=per.device)


def _logp(preact, act, activation):
    if activation == "softmax":
        return _log_softmax(preact)
    return torch.log(torch.clamp(act(preact), 1e-10, 1.0))


def compute(loss_name, labels, preact, activation="identity", mask=None,
            weights=None):
    """Mean loss over the batch (reference: ILossFunction.computeScore)."""
    name = str(loss_name).lower()
    if name == "reconstruction_crossentropy":
        name = "xent"    # the reference's alias: XENT's math
    act = _act.get(activation)
    if name in ("mcxent", "negativeloglikelihood"):
        per = _weighted(-labels * _logp(preact, act, activation), weights)
        return _apply_mask_mean(per, mask)
    if name == "sparse_mcxent":
        # labels are class indices: [B], [B,1] or [B,T,1]
        idx = labels.to(torch.int64)
        if idx.dim() == preact.dim() and idx.shape[-1] == 1:
            idx = idx[..., 0]
        logp = _logp(preact, act, activation)
        per = -torch.gather(logp, -1, idx[..., None])
        if weights is not None:
            w = torch.as_tensor(weights, dtype=per.dtype,
                                device=per.device)
            per = per * w[idx][..., None]
        return _apply_mask_mean(per, mask)
    if name == "xent":
        if activation == "sigmoid":
            per = (torch.clamp(preact, min=0) - preact * labels
                   + torch.log1p(torch.exp(-torch.abs(preact))))
        else:
            p = torch.clamp(act(preact), 1e-10, 1.0 - 1e-10)
            per = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
        return _apply_mask_mean(_weighted(per, weights), mask)
    out = act(preact)
    if name in ("mse", "l2"):
        per = torch.square(out - labels)
    elif name in ("mae", "l1"):
        per = torch.abs(out - labels)
    elif name == "hinge":
        per = torch.clamp(1.0 - labels * out, min=0.0)
    elif name == "squared_hinge":
        per = torch.square(torch.clamp(1.0 - labels * out, min=0.0))
    elif name == "kl_divergence":
        p = torch.clamp(labels, 1e-10, 1.0)
        q = torch.clamp(out, 1e-10, 1.0)
        per = p * (torch.log(p) - torch.log(q))
    elif name == "poisson":
        per = out - labels * torch.log(torch.clamp(out, min=1e-10))
    elif name == "cosine_proximity":
        ln = labels / (torch.linalg.vector_norm(labels, dim=-1,
                                                keepdim=True) + 1e-10)
        on = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                    + 1e-10)
        per = -ln * on
    elif name == "mape":
        per = 100.0 * torch.abs(out - labels) / torch.clamp(
            torch.abs(labels), min=1e-10)
    elif name == "msle":
        per = torch.square(torch.log1p(labels) - torch.log1p(out))
    elif name == "wasserstein":
        per = labels * out
    else:
        raise ValueError(f"Unknown loss function '{loss_name}'")
    per = _weighted(per, weights)
    if name in ("mse", "mape", "msle"):
        # mean over the output dim as well (reference LossMSE, LossMAPE,
        # LossMSLE)
        per = per / per.shape[-1]
    return _apply_mask_mean(per, mask)
