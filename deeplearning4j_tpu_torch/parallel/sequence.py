"""Sequence (context) parallelism over the mesh's "seq" axis.

The counterpart of ``deeplearning4j_tpu/parallel/sequence.py``. Each
rank holds its contiguous slice ``[B, H, T/s, D]`` of q, k and v (rank i
of the seq group the rows [i·T/s, (i+1)·T/s)) and gets back its slice
of the output; the reference's ``shard_map`` bodies run here as each
rank's own program:

* ``ring_attention``: s steps of the blockwise online softmax
  (``ops.attention._block_attn``, plain PyTorch as the reference's
  ``_block_attn`` is plain XLA) against the K/V block the rank holds,
  whose source shard sets the causal key positions (reference
  :53-56); between steps K and V go one rank on around the ring
  (``collectives.ppermute_grad``, +1); the output is ``acc / l``. The
  reference rotates once more after the last step, returning the blocks
  home; nothing reads them, so the port does not send them.
* ``ulysses_attention``: an all-to-all from sequence shards to head
  shards (H % s == 0), full-length attention on H/s heads
  (``ops.attention.dot_product_attention``, as the reference), and the
  reverse all-to-all.

The backward is autograd through the exchanges' Functions (a ppermute's
is the inverse shift, an all-to-all's the transposed one). On a seq axis
of size 1 both run the same code with no exchange.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group

__all__ = ["ring_attention", "ulysses_attention"]


def ring_attention(q, k, v, mesh, axis=SEQ_AXIS, causal=False):
    """Exact attention over sequence-sharded q, k, v (this rank's
    ``[B, H, T/s, D]`` each); returns this rank's output shard."""
    g = axis_group(mesh, axis)
    n, my = g.size, g.rank
    B, H, Tl, D = q.shape
    acc = torch.zeros_like(q)
    m = torch.full((B, H, Tl), -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=q.dtype, device=q.device)
    q_pos = (my * Tl + torch.arange(Tl, device=q.device))[:, None]
    kr, vr = k, v
    for i in range(n):
        src = (my - i) % n       # the shard whose block this rank holds
        mask = None
        if causal:
            k_pos = (src * Tl + torch.arange(Tl, device=q.device))[None, :]
            mask = (q_pos >= k_pos)[None, None]
        acc, m, l = _attn._block_attn(q, kr, vr, (acc, m, l), mask=mask)
        if i < n - 1:
            kr = _coll.ppermute_grad(kr, g, 1)
            vr = _coll.ppermute_grad(vr, g, 1)
    return acc / l[..., None]


def ulysses_attention(q, k, v, mesh, axis=SEQ_AXIS, causal=False):
    """DeepSpeed-Ulysses sequence parallelism (H % s == 0): this rank's
    output shard of exact attention over sequence-sharded q, k, v."""
    g = axis_group(mesh, axis)
    if q.shape[1] % g.size:
        raise ValueError(f"ulysses_attention needs the head count "
                         f"{q.shape[1]} divisible by the '{axis}' axis "
                         f"size {g.size}")

    def seq_to_head(x):
        return _coll.all_to_all_grad(x, g, 1, 2)

    o = _attn.dot_product_attention(seq_to_head(q), seq_to_head(k),
                                    seq_to_head(v), causal=causal)
    return _coll.all_to_all_grad(o, g, 2, 1)
