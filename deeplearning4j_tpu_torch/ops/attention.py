"""Attention primitives in plain PyTorch.

The counterpart of ``deeplearning4j_tpu/ops/attention.py``: the
blockwise (online-softmax) form over KV blocks, the fused form that
materialises the scores, and full multi-head attention, whose core goes
through ``ops.flash_attention.flash_attention``. Layout
``[B, H, T, D]``. Masks follow the reference: masked keys get the finite
score -1e30 (the dtype's lowest finite value where -1e30 does not fit,
as in fp16) and no weight, and a row with no valid key emits 0.
"""

from __future__ import annotations

import math

import torch

__all__ = ["blockwise_attention", "dot_product_attention",
           "multi_head_attention"]


def _mask_value(dtype):
    """-1e30, or the dtype's lowest finite value where -1e30 overflows."""
    return max(-1e30, torch.finfo(dtype).min)


def _block_attn(q, k, v, carry, mask=None):
    """One block: q [B,H,Tq,D] against k/v [B,H,Tk,D]; carry = (acc
    [B,H,Tq,D], row max m [B,H,Tq], row sum l [B,H,Tq]) -> new carry."""
    acc, m, l = carry
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask_value = _mask_value(scores.dtype)
    if mask is not None:
        scores = torch.where(mask, scores, mask_value)
    m_new = torch.maximum(m, scores.amax(-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        # a wholly masked block has m_new == mask_value and exp(0) == 1:
        # zero its probabilities explicitly so l stays 0 there
        p = torch.where(mask, p, 0.0)
    l_new = l * correction + p.sum(-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v)
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, block_size=512, causal=False,
                        key_mask=None):
    """Flash-style attention over KV blocks, O(T) memory. q, k, v
    [B,H,T,D]; key_mask: optional [B, Tk] bool validity of keys."""
    blockwise_attention.launches += 1
    B, H, T, D = q.shape
    Tk = k.shape[2]
    bs = min(block_size, Tk)
    n_blocks = (Tk + bs - 1) // bs
    pad = n_blocks * bs - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if key_mask is not None:
            key_mask = torch.nn.functional.pad(key_mask, (0, pad))
    q_pos = torch.arange(T, device=q.device)[:, None]
    carry = (torch.zeros_like(q),
             torch.full((B, H, T), -math.inf, dtype=q.dtype, device=q.device),
             torch.zeros((B, H, T), dtype=q.dtype, device=q.device))
    for j in range(n_blocks):
        cols = slice(j * bs, (j + 1) * bs)
        k_pos = j * bs + torch.arange(bs, device=q.device)[None, :]
        valid = k_pos < Tk
        mask = None
        if causal:
            mask = (q_pos >= k_pos) & valid
        elif pad:
            mask = valid.expand(T, bs)
        if mask is not None:
            mask = mask[None, None]
        if key_mask is not None:
            km4 = key_mask[:, None, None, cols]
            mask = km4 if mask is None else mask & km4
        carry = _block_attn(q, k[:, :, cols], v[:, :, cols], carry,
                            mask=mask)
    acc, _, l = carry
    # fully masked rows have l == 0: emit 0, not NaN
    return acc / torch.where(l == 0, 1.0, l)[..., None]


def dot_product_attention(q, k, v, mask=None, causal=False, key_mask=None):
    """Fused attention (the scores materialise). key_mask: optional
    [B, Tk] bool key validity, with blockwise_attention's semantics
    exactly: masked keys get no weight and a row whose keys are ALL
    masked under the combined causal, key and explicit masks emits 0."""
    dot_product_attention.launches += 1
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    neg = _mask_value(scores.dtype)
    valid = None
    if causal:
        T, Tk = q.shape[2], k.shape[2]
        cm = (torch.arange(T, device=q.device)[:, None]
              >= torch.arange(Tk, device=q.device)[None, :])
        scores = torch.where(cm[None, None], scores, neg)
        valid = cm[None, None]
    if key_mask is not None:
        kmb = key_mask[:, None, None, :]
        scores = torch.where(kmb, scores, neg)
        valid = kmb if valid is None else valid & kmb
    if mask is not None:
        scores = torch.where(mask, scores, neg)
        if valid is not None and key_mask is not None:
            valid = valid & mask
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if key_mask is not None:
        o = torch.where(valid.any(-1)[..., None], o, 0.0)
    return o


blockwise_attention.launches = 0
dot_product_attention.launches = 0


def multi_head_attention(x, Wq, Wk, Wv, Wo, nHeads, causal=False,
                         block_size=None, kv=None):
    """Full MHA: x [B, T, E]; Wq/Wk/Wv [E, H*D]; Wo [H*D, E]. The core
    goes through ``flash_attention``; an explicit block_size sets its KV
    block and bounds attention memory (never the fused form)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention

    B, T, _ = x.shape
    src = x if kv is None else kv
    Tk = src.shape[1]
    q = (x @ Wq).reshape(B, T, nHeads, -1).transpose(1, 2)
    k = (src @ Wk).reshape(B, Tk, nHeads, -1).transpose(1, 2)
    v = (src @ Wv).reshape(B, Tk, nHeads, -1).transpose(1, 2)
    if block_size:
        o = flash_attention(q, k, v, causal=causal, block_k=block_size,
                            force_streaming=True)
    else:
        o = flash_attention(q, k, v, causal=causal)
    return o.transpose(1, 2).reshape(B, T, -1) @ Wo
