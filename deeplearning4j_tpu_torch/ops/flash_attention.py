"""Flash attention: the forward and the FlashAttention-2 backward.

The counterpart of the flash half of ``deeplearning4j_tpu/ops/
pallas_attention.py``. Layout ``[B, H, T, D]``; q may be longer or
shorter than k/v.

* ``flash_fwd_plain``, ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain``
  are the plain versions: the reference kernels' arithmetic in their
  block order (the q/KV padding to a multiple of the block, the
  ``k_pos < Tk`` mask, the causal ``n_used`` skip, the backward's
  ``i0`` diagonal start, the ``+1e30`` lse sentinel, the zeroed KV
  padding rows), with sums in fp32 (fp64 for fp64 inputs).
  ``flash_bwd_plain`` is the reference's ``_flash_bwd_impl``: delta,
  then both halves.
* ``flash_fwd`` (K1), ``flash_bwd_dq`` (K2) and ``flash_bwd_dkv`` (K3)
  keep those signatures. For CPU tensors they run the plain version;
  for CUDA tensors they launch the hand-written kernels of
  ``csrc/flash_attention.cu`` (built and bound by ``ops/_kernels.py``)
  or raise. The kernels take q/k/v/do with any batch, head and row
  strides and a unit stride along D, so the callers' head transposes
  cost no copy (an operand whose strides or address do not allow
  16-byte loads is copied to a contiguous one first). The kernels
  choose their own tiles (64 or 128 rows a block, 32 keys or rows a
  streamed tile); ``block_q``/``block_k`` set the plain versions' block
  order and are accepted by the wrappers for signature parity.
* ``FlashAttentionFn`` is the reference's ``_flash`` custom VJP: K1
  forward (writing the lse only when a gradient will be needed), and a
  backward that computes ``delta = rowsum(do*o)`` in fp32 as one torch
  op and launches K2 and K3. ``set_flash_bwd("recompute")`` makes the
  backward autograd through the plain blockwise form instead.
* ``flash_attention`` dispatches by ``_choose_impl``, a pure decision
  in the shape of the reference's (``pallas_attention._choose_impl``):
  an unmasked call inside the kernels' domain (f32 or bf16, a head width
  that is a multiple of 8 in 8..128) takes ``FlashAttentionFn`` at every
  T (the kernels on the card, their plain versions on the CPU); a CPU
  call takes it at every dtype and width, since the plain versions take
  them all. A card call outside the domain, or with a key mask, which K1
  does not carry, takes ``dot_product_attention`` below
  ``_MASKED_FUSED_MAX_T`` (unless ``force_streaming``) and
  ``blockwise_attention`` from there, on the same device: outside the
  domain the kernels are never tried. The reference's TPU dispatch
  window is not inherited: an H100 table is a later measurement.

Each kernel wrapper and each plain version carries a ``launches``
count, added to where the kernel launches or the plain version runs;
``dot_product_attention`` and ``blockwise_attention`` carry one too, so
a run shows which route it took.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import attention as _attn

__all__ = ["flash_attention", "FlashAttentionFn", "set_flash_bwd",
           "flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_plain", "flash_bwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "reset_launches", "NEG_INF", "LSE_EMPTY"]

#: the reference's finite mask value: exp(NEG_INF - NEG_INF) is 1, never NaN
NEG_INF = -1e30
#: lse of a row with no valid key: large and POSITIVE, so the backward's
#: exp(s - lse) is exactly 0 for every key
LSE_EMPTY = 1e30
#: a key-masked call below this length takes the fused form, from it on
#: the O(T)-memory blockwise scan (the reference's masked-route split)
_MASKED_FUSED_MAX_T = 512
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_BWD_IMPLS = ("kernel", "recompute")
_BWD_IMPL = "kernel"


def set_flash_bwd(impl):
    """Set the backward strategy ("kernel": K2 and K3 from the saved lse;
    "recompute": autograd through ``blockwise_attention`` from q, k, v);
    returns the previous value."""
    global _BWD_IMPL
    impl = str(impl).lower()
    if impl not in _BWD_IMPLS:
        raise ValueError(
            f"flash_bwd must be one of {_BWD_IMPLS}, got {impl!r}")
    old, _BWD_IMPL = _BWD_IMPL, impl
    return old


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _acc_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _pad_flat(x, T, pad, dtype):
    """[B, H, T, D] -> [B*H, T + pad, D] in `dtype`, zero row padding."""
    B, H, _, D = x.shape
    xf = x.reshape(B * H, T, D).to(dtype)
    return F.pad(xf, (0, 0, 0, pad)) if pad else xf


def _blocks(Tq, Tk, block_q, block_k):
    # an empty axis keeps a block of 1 and has no blocks to walk
    bq, bk = max(1, min(block_q, Tq)), max(1, min(block_k, Tk))
    return bq, bk, (-Tq) % bq, (-Tk) % bk


def flash_fwd_plain(q, k, v, causal=False, block_q=512, block_k=512,
                    need_lse=False):
    """The plain version of K1: ``(o [B,H,Tq,D] in q's dtype, lse
    [B*H, Tq] or None)``, q blocks in order, each streaming its KV
    blocks through the online softmax."""
    flash_fwd_plain.launches += 1
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    ft = _acc_dtype(q)
    dev = q.device
    bq, bk, pq, pk = _blocks(Tq, Tk, block_q, block_k)
    qf = _pad_flat(q, Tq, pq, ft) * (1.0 / math.sqrt(D))
    kf = _pad_flat(k, Tk, pk, ft)
    vf = _pad_flat(v, Tk, pk, ft)
    Tqp, Tkp = Tq + pq, Tk + pk
    out = torch.empty((B * H, Tqp, D), dtype=ft, device=dev)
    lse = torch.empty((B * H, Tqp), dtype=ft, device=dev)
    for iq in range(Tqp // bq):
        rows = slice(iq * bq, (iq + 1) * bq)
        qb = qf[:, rows]
        q_pos = iq * bq + torch.arange(bq, device=dev)[:, None]
        acc = torch.zeros((B * H, bq, D), dtype=ft, device=dev)
        m = torch.full((B * H, bq), NEG_INF, dtype=ft, device=dev)
        l = torch.zeros((B * H, bq), dtype=ft, device=dev)
        # causal: skip KV blocks entirely above this q block's diagonal
        n_used = (min((iq + 1) * bq + bk - 1, Tkp) // bk if causal
                  else Tkp // bk)
        for j in range(n_used):
            kj = kf[:, j * bk:(j + 1) * bk]
            vj = vf[:, j * bk:(j + 1) * bk]
            s = qb @ kj.transpose(1, 2)
            k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
            valid = k_pos < Tk
            if causal:
                valid = valid & (q_pos >= k_pos)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vj
            m = m_new
        out[:, rows] = acc / torch.where(l == 0, 1.0, l)[..., None]
        lse[:, rows] = torch.where(l > 0, m + torch.log(l), LSE_EMPTY)
    o = out[:, :Tq].reshape(B, H, Tq, D).to(q.dtype)
    return o, (lse[:, :Tq].contiguous() if need_lse else None)


def _bwd_operands(q, k, v, do, lse, delta, block_q, block_k):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    ft = _acc_dtype(q)
    bq, bk, pq, pk = _blocks(Tq, Tk, block_q, block_k)
    scale = 1.0 / math.sqrt(D)
    qf = _pad_flat(q, Tq, pq, ft) * scale
    dof = _pad_flat(do, Tq, pq, ft)
    kf = _pad_flat(k, Tk, pk, ft)
    vf = _pad_flat(v, Tk, pk, ft)
    # padded q rows: do is 0 there, and the sentinel makes p exactly 0
    lsef = F.pad(lse.to(ft), (0, pq), value=LSE_EMPTY)
    deltaf = F.pad(delta.to(ft), (0, pq))
    return qf, dof, kf, vf, lsef, deltaf, bq, bk, scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=False, block_q=512,
                       block_k=512):
    """The plain version of K2: dq [B,H,Tq,D] in q's dtype from the
    saved lse and delta = rowsum(do*o), both [B*H, Tq]."""
    flash_bwd_dq_plain.launches += 1
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    qf, dof, kf, vf, lsef, deltaf, bq, bk, scale = _bwd_operands(
        q, k, v, do, lse, delta, block_q, block_k)
    Tqp, Tkp = qf.shape[1], kf.shape[1]
    dq = torch.empty_like(qf)
    for iq in range(Tqp // bq):
        rows = slice(iq * bq, (iq + 1) * bq)
        qb, dob = qf[:, rows], dof[:, rows]
        lb, db = lsef[:, rows, None], deltaf[:, rows, None]
        q_pos = iq * bq + torch.arange(bq, device=dev)[:, None]
        acc = torch.zeros_like(qb)
        n_used = (min((iq + 1) * bq + bk - 1, Tkp) // bk if causal
                  else Tkp // bk)
        for j in range(n_used):
            kj = kf[:, j * bk:(j + 1) * bk]
            vj = vf[:, j * bk:(j + 1) * bk]
            s = qb @ kj.transpose(1, 2)
            k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
            valid = k_pos < Tk
            if causal:
                valid = valid & (q_pos >= k_pos)
            p = torch.where(valid, torch.exp(s - lb), 0.0)
            dp = dob @ vj.transpose(1, 2)
            acc = acc + (p * (dp - db)) @ kj
        dq[:, rows] = acc
    return (dq[:, :Tq] * scale).reshape(B, H, Tq, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False, block_q=512,
                        block_k=512):
    """The plain version of K3: (dk, dv) [B,H,Tk,D] in k's and v's
    dtypes; KV blocks in order, each streaming the q blocks from its
    diagonal (causal) or from 0."""
    flash_bwd_dkv_plain.launches += 1
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    qf, dof, kf, vf, lsef, deltaf, bq, bk, _ = _bwd_operands(
        q, k, v, do, lse, delta, block_q, block_k)
    Tqp, Tkp = qf.shape[1], kf.shape[1]
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for jk in range(Tkp // bk):
        cols = slice(jk * bk, (jk + 1) * bk)
        kb, vb = kf[:, cols], vf[:, cols]
        k_pos = jk * bk + torch.arange(bk, device=dev)[None, :]
        dka, dva = torch.zeros_like(kb), torch.zeros_like(vb)
        i0 = (jk * bk) // bq if causal else 0
        for i in range(i0, Tqp // bq):
            rows = slice(i * bq, (i + 1) * bq)
            qi, doi = qf[:, rows], dof[:, rows]
            s = qi @ kb.transpose(1, 2)
            q_pos = i * bq + torch.arange(bq, device=dev)[:, None]
            valid = k_pos < Tk
            if causal:
                valid = valid & (q_pos >= k_pos)
            p = torch.where(valid, torch.exp(s - lsef[:, rows, None]), 0.0)
            dva = dva + p.transpose(1, 2) @ doi
            dp = doi @ vb.transpose(1, 2)
            ds = p * (dp - deltaf[:, rows, None])
            dka = dka + ds.transpose(1, 2) @ qi
        # zero the KV padding rows so the slice-off cannot leak garbage
        k_valid = (k_pos[0] < Tk)[None, :, None]
        dk[:, cols] = torch.where(k_valid, dka, 0.0)
        dv[:, cols] = torch.where(k_valid, dva, 0.0)
    return (dk[:, :Tk].reshape(B, H, Tk, D).to(k.dtype),
            dv[:, :Tk].reshape(B, H, Tk, D).to(v.dtype))


def _delta(do, o):
    """rowsum(do * o) in fp32 (fp64 for fp64), [B*H, Tq]: one torch op."""
    B, H, Tq, _ = o.shape
    ft = _acc_dtype(o)
    return (do.to(ft) * o.to(ft)).sum(-1).reshape(B * H, Tq)


def flash_bwd_plain(q, k, v, o, lse, do, causal=False, block_q=512,
                    block_k=512):
    """The reference's ``_flash_bwd_impl`` in plain torch: delta, then
    the dq and dk/dv halves. Returns (dq, dk, dv)."""
    delta = _delta(do, o)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, block_q,
                            block_k)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, block_q,
                                 block_k)
    return dq, dk, dv


# ----------------------------------------------------------------------
# the kernel wrappers
# ----------------------------------------------------------------------

def _check(what, q, k, v, *rest):
    ts = (q, k, v) + rest
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: tensors on different devices "
                         f"{[str(t.device) for t in ts]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: need q [B,H,Tq,D] and k, v [B,H,Tk,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype.is_floating_point or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one float dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.device.type == "cuda":
        if q.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{what}: the kernels take {_KERNEL_DTYPES}, "
                            f"got {q.dtype}")
        D = q.shape[3]
        if D % 8 or not 8 <= D <= 128:
            raise ValueError(f"{what}: the kernels take a head width that "
                             f"is a multiple of 8 in 8..128, got {D}")


def _operand(x):
    """x unchanged when 16-byte loads can walk it in place (unit stride
    along D, every other stride and the address 16-byte aligned), else a
    contiguous copy. Strides of size-1 dims are never used."""
    vec = 16 // x.element_size()
    ok = x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or s % vec == 0 for n, s in zip(x.shape[:3], x.stride()[:3]))
    if not ok:
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
    return x


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fn(lib, name, dtype):
    return getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def flash_fwd(q, k, v, causal=False, block_q=512, block_k=512,
              need_lse=False):
    """K1: ``(o [B,H,Tq,D] in q's dtype, lse [B*H, Tq] fp32 or None)``.
    CPU tensors run ``flash_fwd_plain``."""
    _check("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, block_q, block_k, need_lse)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    o = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if o.numel() == 0:
        return o, lse
    q, k, v = _operand(q), _operand(k), _operand(v)
    strides = _strides(q, k, v)
    with torch.cuda.device(q.device):
        err = _fn(_kernels.library(), "dl4j_flash_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), strides,
            B, H, Tq, Tk, D, int(bool(causal)), 1.0 / math.sqrt(D),
            _stream(q.device))
    _kernels.check(err, "flash_fwd")
    _kernels.count_launch(flash_fwd)
    return o, lse


def _check_bwd(what, q, k, v, do, lse, delta):
    _check(what, q, k, v, do, lse, delta)
    B, H, Tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do must match q, got {tuple(do.shape)} "
                         f"{do.dtype}")
    if lse.shape != (B * H, Tq) or delta.shape != (B * H, Tq):
        raise ValueError(f"{what}: lse and delta must be [B*H, Tq] = "
                         f"{(B * H, Tq)}, got {tuple(lse.shape)} and "
                         f"{tuple(delta.shape)}")
    if q.device.type == "cuda" and (
            lse.dtype != torch.float32 or delta.dtype != torch.float32
            or not lse.is_contiguous() or not delta.is_contiguous()):
        raise ValueError(f"{what}: lse and delta must be contiguous fp32")


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, block_q=512,
                 block_k=512):
    """K2: dq [B,H,Tq,D] in q's dtype. CPU tensors run
    ``flash_bwd_dq_plain``."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                  block_q, block_k)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if Tk == 0:
        return dq.zero_()
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        err = _fn(_kernels.library(), "dl4j_flash_bwd_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), strides,
            B, H, Tq, Tk, D, int(bool(causal)), 1.0 / math.sqrt(D),
            _stream(q.device))
    _kernels.check(err, "flash_bwd_dq")
    _kernels.count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, block_q=512,
                  block_k=512):
    """K3: (dk, dv) [B,H,Tk,D] in k's dtype. CPU tensors run
    ``flash_bwd_dkv_plain``."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   block_q, block_k)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        err = _fn(_kernels.library(), "dl4j_flash_bwd_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            strides, B, H, Tq, Tk, D, int(bool(causal)),
            1.0 / math.sqrt(D), _stream(q.device))
    _kernels.check(err, "flash_bwd_dkv")
    _kernels.count_launch(flash_bwd_dkv)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=False, block_q=512, block_k=512):
    """The backward through the kernels: delta = rowsum(do*o) as one
    torch op, then K2 (dq) and K3 (dk, dv). Returns (dq, dk, dv)."""
    delta = _delta(do, o)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, block_q, block_k)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, block_q,
                           block_k)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP. ``need_lse`` (decided by
    the caller: grad mode is off inside ``forward``) makes K1 write the
    lse the kernel backward needs; without it the backward recomputes
    through ``blockwise_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, need_lse):
        o, lse = flash_fwd(q, k, v, causal, block_q, block_k, need_lse)
        ctx.causal, ctx.block_q, ctx.block_k = causal, block_q, block_k
        # o rides as a residual only for the kernel backward
        ctx.save_for_backward(q, k, v, o if need_lse else None, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if lse is not None:
            # decided by the residuals, not the knob: a flip between
            # the forward and the backward cannot mismatch them
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                   ctx.block_q, ctx.block_k)
        else:
            with torch.enable_grad():
                qq, kk, vv = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                out = _attn.blockwise_attention(qq, kk, vv,
                                          block_size=ctx.block_k,
                                          causal=ctx.causal)
                dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), do)
        return dq, dk, dv, None, None, None, None


def _choose_impl(T, D, dtype, *, on_cuda, has_mask=False,
                 force_streaming=False):
    """Pure dispatch decision -> 'flash' | 'fused' | 'blockwise' for a
    call of length T (the longer of q and k), head width D and dtype."""
    in_domain = dtype in _KERNEL_DTYPES and D % 8 == 0 and 8 <= D <= 128
    if not has_mask and (not on_cuda or in_domain):
        return "flash"
    if T < _MASKED_FUSED_MAX_T and not force_streaming:
        return "fused"
    return "blockwise"


def flash_attention(q, k, v, causal=False, key_mask=None, block_q=512,
                    block_k=512, force_streaming=False):
    """Attention ``[B,H,T,D]`` by ``_choose_impl``: ``FlashAttentionFn``
    (K1 and, under autograd, K2/K3 on a CUDA tensor; their plain versions
    on a CPU tensor), or the fused or blockwise form on q's device.
    ``key_mask``: [B, Tk] bool key validity; ``force_streaming`` (a
    caller that bounded attention memory) never takes the fused form.
    Returns the output in q's dtype."""
    impl = _choose_impl(max(q.shape[2], k.shape[2]), q.shape[3], q.dtype,
                        on_cuda=q.device.type == "cuda",
                        has_mask=key_mask is not None,
                        force_streaming=force_streaming)
    if impl == "fused":
        return _attn.dot_product_attention(q, k, v, causal=causal,
                                           key_mask=key_mask)
    if impl == "blockwise":
        return _attn.blockwise_attention(q, k, v, block_size=block_k,
                                         causal=causal, key_mask=key_mask)
    need_lse = (_BWD_IMPL == "kernel" and torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v)))
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(block_q),
                                  int(block_k), need_lse)


def reset_launches():
    """Zero the launch counts of the kernels, their plain versions and
    the fused and blockwise forms (set before a run that reads them)."""
    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_plain,
               flash_bwd_dq_plain, flash_bwd_dkv_plain,
               _attn.dot_product_attention, _attn.blockwise_attention):
        fn.launches = 0


reset_launches()
