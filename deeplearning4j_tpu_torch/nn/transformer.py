"""Causal transformer LM with paged-KV serving step functions.

The counterpart of ``deeplearning4j_tpu/nn/transformer.py``: a
decoder-only LM (learned positions, tied embedding/head, RMSNorm, a
4x tanh-GELU MLP, no biases) whose serving steps run over an external
paged KV cache (``serving/kvcache.py``):

* ``prefill_paged`` — write ONE page-sized prompt chunk's K/V into the
  slot's fresh page and attend the chunk's queries over the block
  table so far (causal in-chunk) through ``paged_flash_prefill``;
* ``decode_paged`` — one token per slot: write each slot's K/V row at
  its (page, offset), then one ``paged_flash_decode`` over every slot.

On the card both attention calls are the hand-written kernels; on the
CPU they are the plain version. The q/k/v/o, MLP and logits products
stay ``torch.matmul``, as the reference leaves them to XLA.

KV append is an in-place ``index_put_``/``index_copy_`` on the pool
tensors, where the reference does a functional ``.at[].set``; the steps
still return the pools so callers keep the reference's shape.

The DENSE twins (``decode_dense``/``prefill_dense``, contiguous
``[L, S, max_context, H, Dh]`` slabs) view each slab as pages through an
identity block table and call the SAME attention entry points, so a
dense trajectory (``dense_serial_trajectory``) is bitwise comparable to
the paged one on either device.

Parameters are drawn from ``numpy.random.default_rng(seed)`` in the
reference's order and kept in its ``[in, out]`` layout (``x @ W``), so
one seed gives the same weights in both packages and
``params_from_reference`` is a plain copy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_flash_decode, paged_flash_prefill,
)

__all__ = ["CausalTransformerLM", "dense_serial_trajectory",
           "params_from_reference"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


def _rows(table, idx):
    """``table[idx]`` with XLA's gather semantics, as the reference's
    ``params["emb"][tokens]`` gets them: an index in [-n, 0) counts from
    the end, and any index still outside [0, n) is clamped to the nearest
    row. Elementwise on the device, so it sits inside a captured step; a
    corrupted token never reaches the gather as an out-of-range index
    (which asserts on the card and ends the CUDA context)."""
    n = table.shape[0]
    i = idx.long()
    return table[torch.where(i < 0, i + n, i).clamp(0, n - 1)]


def _pos_slice(pos, t0, C):
    """``pos[t0:t0 + C]`` as the reference's ``dynamic_slice`` takes it:
    the start clamped so the C rows lie inside the table."""
    t0 = min(max(int(t0), 0), pos.shape[0] - C)
    return pos[t0:t0 + C]


def _rmsnorm(x, g):
    """RMSNorm in fp32, cast to the compute dtype BEFORE the gain
    multiply, exactly as the reference orders it."""
    xf = x.float()
    inv = torch.reciprocal(
        torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6))
    return (xf * inv).to(x.dtype) * g


def params_from_reference(tree):
    """The reference's parameter pytree (after ``jax.tree.map(np.asarray,
    ...)``: ``{"emb", "pos", "lnf", "layers": [{...}, ...]}``) as the
    port's flat ``{name: Tensor}`` state dict (``layers.i.wq`` ...). A
    plain copy: both keep the ``[in, out]`` layout. bf16 leaves (numpy's
    ml_dtypes extension type) come across bit for bit."""
    def tensor(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    out = {k: tensor(tree[k]) for k in ("emb", "pos", "lnf")}
    for i, lp in enumerate(tree["layers"]):
        for k in _LAYER_KEYS:
            out[f"layers.{i}.{k}"] = tensor(lp[k])
    return out


class _Block(nn.Module):
    def __init__(self, params):
        super().__init__()
        for k in _LAYER_KEYS:
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))


class CausalTransformerLM(nn.Module):
    """Decoder-only causal LM with paged-KV serving steps (module
    docstring). vocab/d_model/n_heads/n_layers/d_ff: the usual dims
    (d_ff defaults to 4*d_model). max_context bounds positions;
    page_size is the KV page AND the prefill chunk size. dtype
    ("float32" | "bfloat16") is the parameter/KV/residual dtype; logits
    always come back fp32 for host-side sampling. device follows the
    port's policy: ``cuda`` unless ``"cpu"`` is asked for."""

    #: duck-type marker the serving host dispatches on
    kind = "paged_lm"

    def __init__(self, *, vocab, d_model=32, n_heads=2, n_layers=2,
                 d_ff=None, max_context=64, page_size=8,
                 dtype="float32", seed=0, device=None):
        super().__init__()
        if int(d_model) % int(n_heads):
            raise ValueError(
                f"d_model {d_model} must divide by n_heads {n_heads}")
        if int(max_context) % int(page_size):
            raise ValueError(
                f"max_context {max_context} must be a multiple of "
                f"page_size {page_size}")
        if str(dtype) not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_ff = int(d_ff) if d_ff else 4 * self.d_model
        self.max_context = int(max_context)
        self.page_size = int(page_size)
        self.max_pages_per_slot = self.max_context // self.page_size
        self.head_dim = self.d_model // self.n_heads
        self.seed = int(seed)
        self.dtype_name = str(dtype)
        self._compute_dtype = _DTYPES[self.dtype_name]
        self.device = resolve_device(device)
        top, layers = self._init_params()
        for k, v in top.items():
            self.register_parameter(k, nn.Parameter(v, requires_grad=False))
        self.layers = nn.ModuleList(_Block(lp) for lp in layers)
        self.to(self.device)
        self._refresh_head()

    def fingerprint(self):
        """Config hash, identical to the reference's for one config."""
        return ("causal-lm:"
                f"v{self.vocab}:d{self.d_model}:h{self.n_heads}:"
                f"L{self.n_layers}:ff{self.d_ff}:T{self.max_context}:"
                f"p{self.page_size}:{self.dtype_name}:s{self.seed}")

    def _init_params(self):
        """The reference's draw order: per layer wq, wk, wv, wo, w1, w2,
        then emb and pos; N(0, 0.02) in fp32, then cast."""
        rng = np.random.default_rng(self.seed)
        dt = self._compute_dtype

        def w(*shape):
            return torch.from_numpy(
                (rng.standard_normal(shape) * 0.02).astype(np.float32)
            ).to(dt)

        def ones():
            return torch.ones((self.d_model,), dtype=dt)

        layers = []
        for _ in range(self.n_layers):
            layers.append({
                "ln1": ones(),
                "wq": w(self.d_model, self.d_model),
                "wk": w(self.d_model, self.d_model),
                "wv": w(self.d_model, self.d_model),
                "wo": w(self.d_model, self.d_model),
                "ln2": ones(),
                "w1": w(self.d_model, self.d_ff),
                "w2": w(self.d_ff, self.d_model),
            })
        top = {"emb": w(self.vocab, self.d_model),
               "pos": w(self.max_context, self.d_model),
               "lnf": ones()}
        return top, layers

    def _refresh_head(self):
        # the logits product is bf16 x bf16 with an fp32 result in the
        # reference: both operands upcast, kept once, not per step
        self._emb_f32 = self.emb.detach().float()

    def load_reference_params(self, tree):
        """Load the reference's parameter pytree (numpy leaves) — the
        one bridge between the packages; cast to this model's dtype."""
        sd = {k: v.to(self._compute_dtype)
              for k, v in params_from_reference(tree).items()}
        self.load_state_dict(sd, strict=True)
        self._refresh_head()
        return self

    # -- shared block pieces ----------------------------------------------
    def _qkv(self, lp, x):
        S = x.shape[0]
        shape = (S, self.n_heads, self.head_dim)
        return ((x @ lp.wq).reshape(shape), (x @ lp.wk).reshape(shape),
                (x @ lp.wv).reshape(shape))

    def _mlp(self, lp, h):
        x = _rmsnorm(h, lp.ln2)
        # jax.nn.gelu defaults to the tanh form
        return h + F.gelu(x @ lp.w1, approximate="tanh") @ lp.w2

    def _logits(self, h):
        hn = _rmsnorm(h, self.lnf)
        return hn.float() @ self._emb_f32.T

    def _pool_view(self, slab):
        """A dense slab [S, max_context, H, Dh] as pages [S*MP, page, H,
        Dh] (a view, no copy)."""
        return slab.view(-1, self.page_size, self.n_heads, self.head_dim)

    # -- paged steps ------------------------------------------------------
    @torch.inference_mode()
    def decode_paged(self, tokens, k_pools, v_pools, block_tables,
                     seq_lens):
        """One decode token per slot. tokens [S] int (last sampled);
        k_pools/v_pools [L, P, page, H, Dh]; block_tables [S, MP] int32;
        seq_lens [S] int32 live KV rows per slot (= the new token's
        position). Returns (logits [S, V] fp32, k_pools, v_pools).
        Padded slots (seq_len 0, table all null page) write identical
        garbage rows into the null page, which no live slot attends."""
        S = tokens.shape[0]
        sl = seq_lens.long()
        h = _rows(self.emb, tokens) + _rows(self.pos, sl)
        pages = block_tables.long()[torch.arange(S, device=sl.device),
                                    sl // self.page_size]
        offs = sl % self.page_size
        lens = seq_lens + 1
        for li, lp in enumerate(self.layers):
            x = _rmsnorm(h, lp.ln1)
            q, k, v = self._qkv(lp, x)
            k_pools[li].index_put_((pages, offs), k)
            v_pools[li].index_put_((pages, offs), v)
            att = paged_flash_decode(q, k_pools[li], v_pools[li],
                                     block_tables, lens)
            h = h + att.reshape(S, self.d_model) @ lp.wo
            h = self._mlp(lp, h)
        return self._logits(h), k_pools, v_pools

    @torch.inference_mode()
    def prefill_paged(self, tokens, t0, n_valid, k_pools, v_pools,
                      block_table):
        """One page-sized prompt chunk for ONE slot. tokens [C=page] int
        (zero-padded past n_valid); t0 (multiple of page) and n_valid
        are host ints; block_table [MP] int32 with the chunk's fresh
        page installed at t0 // page. Writes the chunk's K/V into that
        page (padded rows too — decode overwrites them before they are
        unmasked) and attends the chunk causally over the table.
        Returns (last-valid-row logits [V] fp32, k_pools, v_pools)."""
        C = tokens.shape[0]
        t0, n_valid = int(t0), int(n_valid)
        h = _rows(self.emb, tokens) + _pos_slice(self.pos, t0, C)
        blk = t0 // self.page_size
        page_id = block_table[blk:blk + 1].long()
        for li, lp in enumerate(self.layers):
            x = _rmsnorm(h, lp.ln1)
            q, k, v = self._qkv(lp, x)
            k_pools[li].index_copy_(0, page_id, k[None])
            v_pools[li].index_copy_(0, page_id, v[None])
            att = paged_flash_prefill(q, k_pools[li], v_pools[li],
                                      block_table, t0, n_valid)
            h = h + att.reshape(C, self.d_model) @ lp.wo
            h = self._mlp(lp, h)
        return self._logits(h[n_valid - 1:n_valid])[0], k_pools, v_pools

    # -- dense-cache twins (serial oracle) ---------------------------------
    @torch.inference_mode()
    def decode_dense(self, tokens, kcs, vcs, seq_lens):
        """Dense-slab decode: kcs/vcs [L, S, max_context, H, Dh]. Views
        the slab as pages through an identity block table and runs the
        SAME attention entry point as ``decode_paged``."""
        S = tokens.shape[0]
        sl = seq_lens.long()
        h = _rows(self.emb, tokens) + _rows(self.pos, sl)
        rows = torch.arange(S, device=sl.device)
        mp = self.max_pages_per_slot
        ident = (rows[:, None] * mp + torch.arange(mp, device=sl.device)
                 ).to(torch.int32)
        lens = seq_lens + 1
        for li, lp in enumerate(self.layers):
            x = _rmsnorm(h, lp.ln1)
            q, k, v = self._qkv(lp, x)
            kcs[li].index_put_((rows, sl), k)
            vcs[li].index_put_((rows, sl), v)
            att = paged_flash_decode(q, self._pool_view(kcs[li]),
                                     self._pool_view(vcs[li]), ident, lens)
            h = h + att.reshape(S, self.d_model) @ lp.wo
            h = self._mlp(lp, h)
        return self._logits(h), kcs, vcs

    @torch.inference_mode()
    def prefill_dense(self, tokens, t0, n_valid, kcs, vcs, slot):
        """Dense-slab chunked prefill for ONE slot (the same chunking as
        the paged path — the oracle takes the same block steps)."""
        C = tokens.shape[0]
        t0, n_valid, slot = int(t0), int(n_valid), int(slot)
        h = _rows(self.emb, tokens) + _pos_slice(self.pos, t0, C)
        mp = self.max_pages_per_slot
        bt = torch.arange(slot * mp, (slot + 1) * mp, dtype=torch.int32,
                          device=h.device)
        for li, lp in enumerate(self.layers):
            x = _rmsnorm(h, lp.ln1)
            q, k, v = self._qkv(lp, x)
            kcs[li, slot, t0:t0 + C] = k
            vcs[li, slot, t0:t0 + C] = v
            att = paged_flash_prefill(q, self._pool_view(kcs[li]),
                                      self._pool_view(vcs[li]), bt, t0,
                                      n_valid)
            h = h + att.reshape(C, self.d_model) @ lp.wo
            h = self._mlp(lp, h)
        return self._logits(h[n_valid - 1:n_valid])[0], kcs, vcs

    # -- dense caches ------------------------------------------------------
    def dense_cache(self, S):
        """Zeroed dense KV slabs for S slots (S x max_context rows each)."""
        shape = (self.n_layers, int(S), self.max_context, self.n_heads,
                 self.head_dim)
        return (torch.zeros(shape, dtype=self._compute_dtype,
                            device=self.device),
                torch.zeros(shape, dtype=self._compute_dtype,
                            device=self.device))

    def dense_cache_bytes(self, S):
        """Bytes the dense twin reserves for S slots (K and V)."""
        itemsize = torch.empty((), dtype=self._compute_dtype).element_size()
        return (2 * self.n_layers * int(S) * self.max_context
                * self.n_heads * self.head_dim * itemsize)


def dense_serial_trajectory(model, prompt, n_new, sampler, rng,
                            bucket=1):
    """The serial oracle: ONE sequence generated through the DENSE twin
    at a fixed slot bucket (live row 0, padding rows dead) — page-size
    prefill chunks, then one decode step per generated token, sampling
    with the caller's rng stream. Returns (tokens [n_new] int list,
    logits [n_new, V] fp32 numpy) — what the paged scheduler must
    reproduce bitwise for the same (seed, stream) within the same
    bucket."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    dev = model.device
    S = int(bucket)
    kcs, vcs = model.dense_cache(S)
    page = model.page_size
    t0 = 0
    last = None
    while t0 < prompt.shape[0]:
        n_valid = min(page, prompt.shape[0] - t0)
        chunk = np.zeros((page,), np.int32)
        chunk[:n_valid] = prompt[t0:t0 + n_valid]
        last, kcs, vcs = model.prefill_dense(
            torch.from_numpy(chunk).to(dev), t0, n_valid, kcs, vcs, 0)
        t0 += n_valid
    tokens, logits = [], []
    logits.append(last.cpu().numpy())
    tokens.append(int(sampler(logits[-1], rng)))
    seq_len = int(prompt.shape[0])
    for _ in range(int(n_new) - 1):
        tok = np.zeros((S,), np.int32)
        tok[0] = tokens[-1]
        sls = np.zeros((S,), np.int32)
        sls[0] = seq_len
        out, kcs, vcs = model.decode_dense(
            torch.from_numpy(tok).to(dev), kcs, vcs,
            torch.from_numpy(sls).to(dev))
        seq_len += 1
        logits.append(out[0].cpu().numpy())
        tokens.append(int(sampler(logits[-1], rng)))
    return tokens, np.stack(logits, axis=0)
