"""Loss functions.

The counterpart of ``deeplearning4j_tpu/nn/losses.py``:
``compute(loss, labels, preact, activation, mask)`` is the mean loss over
the batch from PRE-activation outputs, so softmax + MCXENT is the stable
log-softmax form. Masked elements contribute nothing and the mean is
over the unmasked ones. The dtype policy is the reference's default
("compute") tail: under a sub-fp32 compute dtype the activation-scale
tensors stay in that dtype and fp32 appears only in the reduction
accumulators and the per-row logsumexp (``tail_dtype`` says what a
trainer casts to first).

Ported so far: MCXENT / NEGATIVELOGLIKELIHOOD, XENT, MSE / L2 and
MAE / L1. The others raise and wait for the nn-conf slice (ROADMAP.md
Queue 1 item 4).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations as _act

__all__ = ["LossFunctions", "compute", "tail_dtype"]


def tail_dtype(dtype):
    """The dtype a trainer casts preact/labels to before the loss: fp32
    (or fp64) when the compute dtype is already that wide, else the
    compute dtype itself; the fp32 accumulation then happens inside the
    reduces here."""
    wide = torch.promote_types(dtype, torch.float32)
    return wide if dtype == wide else dtype


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


def compute(loss_name, labels, preact, activation="identity", mask=None):
    """Mean loss over the batch (reference: ILossFunction.computeScore)."""
    name = str(loss_name).lower()
    act = _act.get(activation)
    if name in ("mcxent", "negativeloglikelihood"):
        if activation == "softmax":
            logp = _log_softmax(preact)
        else:
            logp = torch.log(torch.clamp(act(preact), 1e-10, 1.0))
        return _apply_mask_mean(-labels * logp, mask)
    if name == "xent":
        if activation == "sigmoid":
            per = (torch.clamp(preact, min=0) - preact * labels
                   + torch.log1p(torch.exp(-torch.abs(preact))))
        else:
            p = torch.clamp(act(preact), 1e-10, 1.0 - 1e-10)
            per = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
        return _apply_mask_mean(per, mask)
    out = act(preact)
    if name in ("mse", "l2"):
        per = torch.square(out - labels)
    elif name in ("mae", "l1"):
        per = torch.abs(out - labels)
    else:
        raise NotImplementedError(
            f"loss {loss_name!r} waits for the nn-conf slice (ROADMAP.md "
            "Queue 1 item 4)")
    if name == "mse":
        # mean over the output dim as well (reference LossMSE)
        per = per / per.shape[-1]
    return _apply_mask_mean(per, mask)
