"""Paged KV attention: block-table decode and chunked prefill.

The counterpart of the paged half of ``deeplearning4j_tpu/ops/
pallas_attention.py``. The serving tier stores KV in fixed-size pages
of a pool ``[P, page, H, Dh]``; a block table maps a slot's logical KV
block j to physical page ``bt[j]``.

* ``paged_attend`` is the plain version (the reference's portable
  ``paged_attend``): page-sequential online softmax with fp32
  accumulation over pages already gathered through the block table,
  the mask ``(k_pos < length) & (q_pos >= k_pos)``, the finite -1e30
  mask value, an exact zero row for ``length == 0``.
* ``paged_flash_decode`` / ``paged_flash_prefill`` keep the signatures
  and layouts of the reference's kernel entry points. For CPU tensors
  they run the plain version; for CUDA tensors they launch the
  hand-written kernels of ``csrc/paged_attention.cu`` (built and bound
  by ``ops/_kernels.py``), which index K and V through the block table
  in place instead of gathering a copy, or raise. Nothing falls back.
  Each launches a split kernel over spans of ``SPLIT_PAGES`` logical
  pages and a combine that merges a row's spans in split order.
* ``split_partials_plain`` / ``combine_plain`` are a plain model of that
  plan (the per-span (m, l, acc) and their merge), which the CPU tests
  hold against the reference; nothing on the card path calls them.

Each function carries a ``launches`` count: the wrappers add one where
they launch their kernel, ``paged_attend`` one per plain call, so a run
shows which path served it.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops import _kernels

__all__ = ["paged_attend", "paged_flash_decode", "paged_flash_prefill",
           "paged_decode_plain", "paged_prefill_plain",
           "split_partials_plain", "combine_plain",
           "paged_decode_split_plain", "paged_prefill_split_plain",
           "NEG_INF", "LSE_EMPTY", "SPLIT_PAGES", "reset_launches"]

#: the reference's finite mask value: exp(NEG_INF - NEG_INF) is 1, never NaN
NEG_INF = -1e30
#: lse of a row with no valid key (a padded decode slot)
LSE_EMPTY = 1e30
#: logical pages per split of the kernels' KV walk (kSplitPages in
#: csrc/paged_attention.cu): the plan depends on a row's length and this
SPLIT_PAGES = 4

_DTYPES = (torch.float32, torch.bfloat16)


def paged_attend(q, k_pages, v_pages, lengths, q_starts, need_lse=False):
    """Plain batched paged attention. q [S, R, H, Dh] (R = 1 for
    decode, the chunk for prefill); k_pages/v_pages [S, MP, page, H, Dh]
    (pool pages gathered through each slot's block table); lengths [S]
    live KV tokens; q_starts [S] position of q row 0. Returns
    [S, R, H, Dh] in q's dtype (and lse [S, H, R] fp32 when need_lse).
    Every page is visited, in order: pages past a slot's length are
    exact no-ops on the carry, as in the reference."""
    paged_attend.launches += 1
    S, R, H, Dh = q.shape
    MP, page = k_pages.shape[1], k_pages.shape[2]
    dev = q.device
    qs = q.float().permute(0, 2, 1, 3) * (1.0 / math.sqrt(Dh))
    kt = k_pages.permute(0, 3, 1, 2, 4)           # [S, H, MP, page, Dh]
    vt = v_pages.permute(0, 3, 1, 2, 4)
    lengths = lengths.to(dev, torch.int64)
    q_pos = q_starts.to(dev, torch.int64)[:, None] \
        + torch.arange(R, device=dev)              # [S, R]
    ar = torch.arange(page, device=dev)
    acc = torch.zeros((S, H, R, Dh), dtype=torch.float32, device=dev)
    m = torch.full((S, H, R), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, H, R), dtype=torch.float32, device=dev)
    for j in range(MP):
        kj = kt[:, :, j].float()                   # [S, H, page, Dh]
        vj = vt[:, :, j].float()
        s = qs @ kj.transpose(-1, -2)              # [S, H, R, page]
        k_pos = j * page + ar
        valid = ((k_pos[None, None, :] < lengths[:, None, None])
                 & (q_pos[:, :, None] >= k_pos[None, None, :]))[:, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        pr = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + pr.sum(-1)
        acc = acc * corr[..., None] + pr @ vj
        m = m_new
    out = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
    out = out.permute(0, 2, 1, 3)
    if not need_lse:
        return out
    return out, torch.where(l > 0, m + torch.log(l), LSE_EMPTY)


def paged_decode_plain(q, k_pool, v_pool, block_tables, seq_lens,
                       need_lse=False):
    """The plain version of ``paged_flash_decode``: gather each slot's
    pages, then ``paged_attend`` with the query at position len - 1."""
    bt = block_tables.long()
    res = paged_attend(q[:, None], k_pool[bt], v_pool[bt], seq_lens,
                       seq_lens.long() - 1, need_lse=need_lse)
    if need_lse:
        return res[0][:, 0], res[1][:, :, 0]
    return res[:, 0]


def paged_prefill_plain(q_chunk, k_pool, v_pool, block_table, t0,
                        n_valid):
    """The plain version of ``paged_flash_prefill``."""
    bt = block_table.long()
    dev = q_chunk.device
    return paged_attend(
        q_chunk[None], k_pool[bt][None], v_pool[bt][None],
        torch.tensor([int(t0) + int(n_valid)], device=dev),
        torch.tensor([int(t0)], device=dev))[0]


def _splits(MP):
    return -(-MP // SPLIT_PAGES)


def split_partials_plain(q, k_pages, v_pages, lengths, q_starts):
    """The kernels' split plan in plain PyTorch: each span of
    SPLIT_PAGES logical pages gives its own softmax partial. Arguments as
    ``paged_attend``. Returns (m, l [S, H, NS, R], acc [S, H, NS, R, Dh]
    fp32, n_live [S]): span i's max score, sum of exp(s - m) and
    exp-weighted V over its valid keys, and each slot's count of live
    spans (those starting below its length). A span with no valid key for
    a row keeps (NEG_INF, 0, 0); spans at or past n_live are never
    merged. Sums run over the last axis, so a row's values do not depend
    on the other rows of the batch."""
    S, R, H, Dh = q.shape
    MP, page = k_pages.shape[1], k_pages.shape[2]
    NS, span = _splits(MP), SPLIT_PAGES * page
    dev = q.device
    pad = NS * SPLIT_PAGES - MP
    if pad:   # keys past MP * page are masked: zero pages change nothing
        z = k_pages.new_zeros((S, pad) + tuple(k_pages.shape[2:]))
        k_pages, v_pages = (torch.cat([t, z], 1) for t in (k_pages, v_pages))
    kt = k_pages.reshape(S, NS, span, H, Dh).permute(0, 3, 1, 2, 4).float()
    vt = v_pages.reshape(S, NS, span, H, Dh).permute(0, 3, 1, 4, 2).float()
    qs = q.float().permute(0, 2, 1, 3) * (1.0 / math.sqrt(Dh))
    lengths = lengths.to(dev, torch.int64).clamp(max=MP * page)
    q_pos = q_starts.to(dev, torch.int64)[:, None] \
        + torch.arange(R, device=dev)                       # [S, R]
    k_pos = torch.arange(NS * span, device=dev).view(NS, span)
    valid = ((k_pos[None, :, None, :] < lengths[:, None, None, None])
             & (q_pos[:, None, :, None] >= k_pos[None, :, None, :])
             )[:, None]                                     # [S,1,NS,R,span]
    # [S, H, NS, R, span, Dh] products, summed over Dh
    s = (qs[:, :, None, :, None, :] * kt[:, :, :, None]).sum(-1)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = (p[..., None, :] * vt[:, :, :, None]).sum(-1)    # [S,H,NS,R,Dh]
    n_live = -(-lengths // span)
    return m, l, acc, n_live


def combine_plain(m, l, acc, n_live):
    """Merge each row's first n_live span partials in split order, as the
    combine kernel does: M = max m_i, L = sum l_i e^(m_i - M),
    o = sum acc_i e^(m_i - M) / L. Returns (o [S, H, R, Dh] fp32, lse
    [S, H, R]); L == 0 gives a zero row and LSE_EMPTY. Whatever the dead
    spans hold (even NaN) is never read into the result."""
    S, H, NS, R = m.shape
    live = [(i < n_live).view(S, 1, 1) for i in range(NS)]
    mx = torch.full((S, H, R), NEG_INF, dtype=torch.float32, device=m.device)
    for i in range(NS):
        mx = torch.where(live[i], torch.maximum(mx, m[:, :, i]), mx)
    tot = torch.zeros_like(mx)
    o = torch.zeros_like(acc[:, :, 0])
    for i in range(NS):
        w = torch.exp(m[:, :, i] - mx)
        tot = torch.where(live[i], tot + l[:, :, i] * w, tot)
        o = torch.where(live[i][..., None], o + acc[:, :, i] * w[..., None],
                        o)
    o = o / torch.where(tot == 0, 1.0, tot)[..., None]
    return o, torch.where(tot > 0, mx + torch.log(tot), LSE_EMPTY)


def paged_decode_split_plain(q, k_pool, v_pool, block_tables, seq_lens,
                             need_lse=False):
    """``paged_decode_plain`` through the split plan: the plain model of
    what K4's split kernel and combine compute."""
    bt = block_tables.long()
    o, lse = combine_plain(*split_partials_plain(
        q[:, None], k_pool[bt], v_pool[bt], seq_lens, seq_lens.long() - 1))
    out = o[:, :, 0].to(q.dtype)
    return (out, lse[:, :, 0]) if need_lse else out


def paged_prefill_split_plain(q_chunk, k_pool, v_pool, block_table, t0,
                              n_valid):
    """``paged_prefill_plain`` through the split plan (K5's model)."""
    bt = block_table.long()
    dev = q_chunk.device
    o, _ = combine_plain(*split_partials_plain(
        q_chunk[None], k_pool[bt][None], v_pool[bt][None],
        torch.tensor([int(t0) + int(n_valid)], device=dev),
        torch.tensor([int(t0)], device=dev)))
    return o[0].permute(1, 0, 2).to(q_chunk.dtype)


def _workspace(units, MP, Dh, dev):
    """The kernels' fp32 workspace: acc [units, NS, Dh], (m, l)
    [units, NS, 2]."""
    return torch.empty(units * _splits(MP) * (Dh + 2), dtype=torch.float32,
                       device=dev)


def _check_pools(what, q, k_pool, v_pool, tables, lens=None):
    ts = [q, k_pool, v_pool, tables] + ([lens] if lens is not None else [])
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: tensors on different devices "
                         f"{[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: q and pools must share one dtype of "
                        f"{_DTYPES}, got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if tables.dtype != torch.int32 or (lens is not None
                                       and lens.dtype != torch.int32):
        raise TypeError(f"{what}: block tables and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 \
            or k_pool.shape != v_pool.shape \
            or tuple(k_pool.shape[2:]) != tuple(q.shape[1:]):
        raise ValueError(f"{what}: q [., H, Dh] and pools [P, page, H, Dh] "
                         f"disagree: {tuple(q.shape)} vs "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: every input must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.device.type == "cuda" and (k_pool.data_ptr() % 16
                                    or v_pool.data_ptr() % 16):
        raise ValueError(f"{what}: the kernels read the pools 16 bytes at "
                         "a time; pools must be 16-byte aligned")


def paged_flash_decode(q, k_pool, v_pool, block_tables, seq_lens,
                       need_lse=False):
    """Block-table decode: one query row per slot against the K/V pages
    of its block table. q [S, H, Dh]; k_pool/v_pool [P, page, H, Dh];
    block_tables [S, MP] int32 (padded slots point at the null page);
    seq_lens [S] int32 (0 = padded slot -> zero row, lse LSE_EMPTY).
    Returns [S, H, Dh] (and lse [S, H] fp32 when need_lse).

    The block-table entries and lengths live on the device, so they are
    the caller's contract (the scheduler builds them): entries < P and
    lengths <= MP * page."""
    _check_pools("paged_flash_decode", q, k_pool, v_pool, block_tables,
                 seq_lens)
    S = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or seq_lens.shape != (S,):
        raise ValueError(
            f"paged_flash_decode: block_tables [S, MP] and seq_lens [S] "
            f"must match q's S={S}, got {tuple(block_tables.shape)} and "
            f"{tuple(seq_lens.shape)}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables,
                                  seq_lens, need_lse)
    _, H, Dh = q.shape
    page = k_pool.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((S, H), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if S:
        MP = block_tables.shape[1]
        ws = _workspace(S * H, MP, Dh, q.device)
        lib = _kernels.library()
        fn = (lib.dl4j_paged_decode_bf16 if q.dtype == torch.bfloat16
              else lib.dl4j_paged_decode_f32)
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), seq_lens.data_ptr(),
                     ws.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     S, H, Dh, page, MP, 1.0 / math.sqrt(Dh),
                     torch.cuda.current_stream().cuda_stream)
        _kernels.check(err, "paged_flash_decode")
        _kernels.count_launch(paged_flash_decode)
    return (out, lse) if need_lse else out


def paged_flash_prefill(q_chunk, k_pool, v_pool, block_table, t0,
                        n_valid):
    """Chunked-prefill attention for ONE slot: the chunk's C == page
    query rows at offset t0 against the slot's whole block table (the
    chunk's own KV page already written; causal in-chunk by the mask).
    q_chunk [C, H, Dh]; block_table [MP] int32; t0 a multiple of page;
    n_valid live rows (< C only for the prompt's tail chunk). t0 and
    n_valid are host ints. Returns [C, H, Dh]; rows past n_valid are
    padding the caller slices off."""
    _check_pools("paged_flash_prefill", q_chunk, k_pool, v_pool,
                 block_table)
    C, H, Dh = q_chunk.shape
    page = k_pool.shape[1]
    t0, n_valid = int(t0), int(n_valid)
    if block_table.dim() != 1 or C != page:
        raise ValueError(
            f"paged_flash_prefill: need q_chunk [page={page}, H, Dh] and "
            f"block_table [MP], got {tuple(q_chunk.shape)} and "
            f"{tuple(block_table.shape)}")
    MP = block_table.shape[0]
    if t0 < 0 or t0 % page or not 1 <= n_valid <= C \
            or t0 + n_valid > MP * page:
        raise ValueError(
            f"paged_flash_prefill: t0={t0} must be a multiple of {page}, "
            f"1 <= n_valid={n_valid} <= {C}, and t0 + n_valid <= "
            f"MP * page = {MP * page}")
    if q_chunk.device.type == "cpu":
        return paged_prefill_plain(q_chunk, k_pool, v_pool, block_table,
                                   t0, n_valid)
    out = torch.empty_like(q_chunk)
    ws = _workspace(C * H, MP, Dh, q_chunk.device)
    lib = _kernels.library()
    fn = (lib.dl4j_paged_prefill_bf16 if q_chunk.dtype == torch.bfloat16
          else lib.dl4j_paged_prefill_f32)
    with torch.cuda.device(q_chunk.device):
        err = fn(q_chunk.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), ws.data_ptr(), out.data_ptr(), C,
                 H, Dh, page, MP, t0, n_valid, 1.0 / math.sqrt(Dh),
                 torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "paged_flash_prefill")
    _kernels.count_launch(paged_flash_prefill)
    return out


def reset_launches():
    """Zero the three launch counts (set before a run that reads them)."""
    for fn in (paged_attend, paged_flash_decode, paged_flash_prefill):
        fn.launches = 0


reset_launches()
