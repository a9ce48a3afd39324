"""Batch rows per rank, the compressed gradient exchanges and their bill.

The counterpart of the data-parallel part of
``deeplearning4j_tpu/parallel/sharding.py``:

* ``shard_batch``: this rank's contiguous rows of a global batch, in
  the order the reference lays rows over the mesh (rank r takes rows
  [r·B/dp, (r+1)·B/dp)); an indivisible batch raises the reference's
  error instead of padding.
* ``quantized_psum_mean``: the int8/block_int8 gradient all-reduce
  (reference: ``_quant_scales``, ``_quantize``, ``quantized_psum_mean``,
  :138-183). The scale is the per-tensor absmax (or the per-block absmax
  over zero-padded blocks), floored at 1e-12 and all-reduced with MAX;
  ``q = clip(round(flat / sc * 127), -127, 127)`` in the reference's
  operation order (both ``jnp.round`` and ``torch.round`` round half to
  even, so the lanes are the reference's on equal inputs); the lanes are
  summed exactly (``collectives.int8_lane_sum``) and the mean is
  ``sum · (sc/127) / dp`` in f32 by true division (``_div``: on the card
  a divide by a Python number is a multiply by its reciprocal), cast to
  the leaf's dtype. The reference
  runs it per leaf inside ``shard_map`` and lets XLA combine the
  collectives; the port takes every leaf at once: one MAX all-reduce of
  all the scales and one all-reduce of all the packed lanes a step.
* ``threshold_psum_mean``: the Strom-2015 exchange of the reference's
  ``_threshold_step`` (trainer.py:656-760) for every leaf: ``acc = g +
  residual``, ``threshold_encode_fixed(acc, tau, threshold_cap(n,
  capacity))``, every rank's message gathered, scatter-added and divided
  by dp. ``val`` is exactly ±tau or 0 and tau is the same on every rank,
  so one int32 a pair goes on the wire, ``sign · (idx + 1)`` (0: nothing
  sent), all leaves in one all-gather. The scatter-add counts the signs
  at each index in int32 (exact and order-free, so the card's atomics
  give the same answer every run) and scales the count by tau once:
  ``round(c · tau) / dp`` where the reference adds ±tau in float one by
  one. The two agree bitwise while |c| <= 2 at every index (always at
  dp 2); beyond, the reference's running sum may differ by an ulp.
* ``compressed_wire_bytes``: the reference's bill of bytes on the wire
  a step, copied whole (pure arithmetic, the hierarchical term
  included); it publishes the same gauge on the port's registry.

* ``spec_for_param``: the reference's tensor-parallel naming and size
  rule (``parallel/sharding.py:75`` there), pure, so the partition-plan
  analyzer (``analysis.partitioning``) can check plans over model axes
  the port does not execute yet. Specs are tuples of axis names (None:
  that dimension is not sharded; ``()``: replicated). The rule shards a
  weight's output dimension, which is the last in the reference's
  layouts and in the port's dense and recurrent ones, and dimension 0
  in the port's OIHW convolution kernels. ``shard_params``, which
  would place parameters by these specs, waits for ROADMAP Queue 1 item
  7.

``COMPRESSION_MODES`` lists the reference's modes; "hierarchical" waits
for ROADMAP Queue 1 item 7 (the trainer raises naming it).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.compression import threshold_cap
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["shard_batch", "spec_for_param", "quantized_psum_mean", "threshold_psum_mean",
           "COMPRESSION_MODES", "DEFAULT_COMPRESSION_BLOCK",
           "DEFAULT_COMPRESSION_GROUP", "DEFAULT_ENCODING_CAPACITY",
           "compressed_wire_bytes", "default_compression_group",
           "hierarchical_shard_elems"]

#: per-block scale granularity of gradient_compression="block_int8"
DEFAULT_COMPRESSION_BLOCK = 256
#: default node-group size of the hierarchical exchange (its bill only)
DEFAULT_COMPRESSION_GROUP = 8
#: selectable gradient_compression modes (None = dense all-reduce)
COMPRESSION_MODES = (None, "int8", "block_int8", "threshold",
                     "hierarchical")
#: default fraction of a leaf's elements the fixed-capacity threshold
#: encoder may transmit a step (ParallelWrapper encodingCapacity)
DEFAULT_ENCODING_CAPACITY = 0.125


def shard_batch(arr, mesh, batch_axis=DATA_AXIS, dim=0):
    """This rank's rows of `arr` (a tensor) along `dim`: the r-th of
    ``mesh.size`` equal contiguous blocks. REJECTS an indivisible batch
    with the reference's error (sharding.py:32-60) instead of padding."""
    axes = batch_axis if isinstance(batch_axis, tuple) else (batch_axis,)
    for ax in axes:
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh has no axis '{ax}' (axes: "
                f"{list(mesh.shape)}); build the mesh with a "
                "data-parallel axis or pass batch_axis=")
    width = mesh.size
    if arr.shape[dim] % width != 0:
        raise ValueError(
            f"Global batch {arr.shape[dim]} not divisible by "
            f"data-parallel mesh axis '{batch_axis}' (size {width}): "
            "refusing to silently pad; use a batch size that is a "
            f"multiple of {width} (PAR03)")
    b = arr.shape[dim] // width
    return arr.narrow(dim, mesh.rank * b, b)


def _div(t, v):
    """`t` / `v` by true division. PyTorch's CUDA kernels divide by a
    Python number by multiplying with its reciprocal, which rounds
    differently from the reference's (and the CPU's) division; a
    divisor held as a 0-d tensor on `t`'s device is divided exactly."""
    return t / torch.full((), v, dtype=t.dtype, device=t.device)


def _flat(leaves, spans, dtype=None):
    """The leaves as one flat (of `dtype`), each followed by zeros up to
    its span; one concatenation."""
    pad = max(span - g.numel() for g, span in zip(leaves, spans))
    zeros = leaves[0].new_zeros(pad)
    pieces = []
    for g, span in zip(leaves, spans):
        pieces.append(g.reshape(-1))
        if span > g.numel():
            pieces.append(zeros[:span - g.numel()])
    flat = torch.cat(pieces)
    return flat if dtype is None else flat.to(dtype)


def _unflat(flat, leaves, spans):
    """Views of `flat` shaped and typed as `leaves` (a span's padding
    dropped)."""
    return [f[:g.numel()].view(g.shape).to(g.dtype)
            for g, f in zip(leaves, flat.split(spans))]


def _quantize(leaves, group, mode, block):
    """(lanes, scale, spans): every leaf's int8 lanes in one flat, each
    lane's f32 dequant scale beside it, and each leaf's span in the flat
    (a block_int8 leaf zero-padded to whole blocks, the padding's lanes
    0). The scale is shared across ranks: the leaf's absmax ("int8") or
    its block's absmax ("block_int8"), floored at 1e-12, every leaf's
    scales in one MAX all-reduce; the lanes are
    ``clip(round(flat / sc * 127))``."""
    sizes = [g.numel() for g in leaves]
    spans = sizes if mode == "int8" else [n + (-n) % block for n in sizes]
    flat = _flat(leaves, spans, torch.float32)
    if mode == "int8":
        leaf_max = torch._foreach_norm(list(flat.split(sizes)),
                                       float("inf"))
        s = _coll.all_reduce(torch.stack(leaf_max).clamp_min(1e-12),
                             group, "max")
        scale = torch.cat([v.expand(n) for v, n in zip(s.unbind(), sizes)])
    else:
        s = flat.abs().view(-1, block).amax(1).clamp_min(1e-12)
        scale = _coll.all_reduce(s, group, "max").repeat_interleave(block)
    q = torch.clamp(torch.round(flat / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale, spans


def quantized_psum_mean(leaves, group, mode="int8", block=None):
    """The compressed all-reduce mean of every leaf (module docstring):
    a list of tensors shaped and typed as `leaves`."""
    block = DEFAULT_COMPRESSION_BLOCK if block is None else int(block)
    q, scale, spans = _quantize(leaves, group, mode, block)
    summed = _coll.int8_lane_sum(q, group).to(torch.float32)
    mean = _div(summed * _div(scale, 127.0), group.size)
    return _unflat(mean, leaves, spans)


def threshold_psum_mean(leaves, residual, tau, capacity, group):
    """The threshold exchange of every leaf at once (module docstring).
    `residual` is one flat of the leaves' dtype and total length, `tau` a
    0-d tensor on their device. Each leaf's candidates are its top
    ``threshold_cap(n, capacity)`` magnitudes, ties in index order (two
    stable sorts of the whole flat: by magnitude, then by leaf), exactly
    ``ndarray.compression.threshold_encode_fixed``'s per leaf. Returns
    (means shaped as `leaves`, the residual flat after encoding, the
    count of entries sent, a 0-d int tensor)."""
    sizes = [g.numel() for g in leaves]
    caps = [threshold_cap(n, capacity) for n in sizes]
    dev = residual.device
    acc = _flat(leaves, sizes) + residual
    starts = torch.tensor(np.cumsum([0] + sizes[:-1]), device=dev)
    leaf = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=dev),
        torch.tensor(sizes, device=dev), output_size=acc.numel())
    order = torch.sort(acc.abs(), descending=True, stable=True).indices
    order = order[torch.sort(leaf[order], stable=True).indices]
    # each leaf's first cap entries: position start_l + j for j < cap_l
    cap_leaf = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev), torch.tensor(caps, device=dev),
        output_size=sum(caps))
    cap_starts = torch.tensor(np.cumsum([0] + caps[:-1]), device=dev)
    base = starts[cap_leaf]
    j = torch.arange(sum(caps), device=dev) - cap_starts[cap_leaf]
    idx = order[base + j]
    cand = acc[idx]
    t = tau.to(acc.dtype)
    val = torch.where(torch.abs(cand) >= t, torch.sign(cand) * t,
                      torch.zeros((), dtype=acc.dtype, device=dev))
    rest = acc - torch.zeros_like(acc).index_put_((idx,), val)
    codes = ((idx - base + 1) * torch.sign(val).to(torch.int64)) \
        .to(torch.int32)
    gathered = _coll.all_gather(codes, group)
    counts = torch.zeros(acc.numel(), dtype=torch.int32, device=dev)
    counts.index_add_(0, (base + (gathered.abs() - 1).clamp_min(0)).reshape(-1),
                      torch.sign(gathered).reshape(-1))
    mean = _div(counts.to(acc.dtype) * t, group.size)
    return _unflat(mean, leaves, sizes), rest, torch.count_nonzero(val)


# ----------------------------------------------------------------------
# the bytes-on-wire bill per compression mode (reference: :585-712)
# ----------------------------------------------------------------------

def spec_for_param(name, shape, model_axis=MODEL_AXIS,
                   min_shard_size=2 ** 16):
    """The partition spec (a tuple) of one parameter by the reference's
    rule: below `min_shard_size` elements replicated; a 2-d weight
    (dense, recurrent, embedding) [in, out] sharded on its output
    dimension; a 4-d convolution kernel on its output channels (OIHW:
    dimension 0); a 1-d bias or gain on its one dimension."""
    if int(np.prod(shape)) < min_shard_size:
        return ()
    if len(shape) == 2:
        return (None, model_axis)
    if len(shape) == 4:
        return (model_axis, None, None, None)
    if len(shape) == 1:
        return (model_axis,)
    return ()


def default_compression_group(dp):
    """The node-group size "hierarchical" picks when none is given
    (reference: ``default_compression_group``)."""
    dp = int(dp)
    for g in range(min(dp // 2, DEFAULT_COMPRESSION_GROUP), 1, -1):
        if dp % g == 0:
            return g
    raise ValueError(
        f"data-parallel degree {dp} has no hierarchical factorization: "
        f"the 2-hop exchange needs a group size g with 2 <= g <= dp/2 "
        f"(>= 2 chips per group AND >= 2 groups), which requires a "
        f"composite dp >= 4; use gradient_compression='threshold' or "
        f"'block_int8' on this mesh instead")


def hierarchical_shard_elems(n, group_size):
    """Per-chip shard length of an n-element leaf under the
    hierarchical exchange (reference: ``hierarchical_shard_elems``)."""
    n, g = int(n), int(group_size)
    return (n + (-n) % g) // g


def _ceil_div(a, b):
    return -(-int(a) // int(b))


def compressed_wire_bytes(grad_bytes, dp, compression=None, block=None,
                          capacity=None, itemsize=4, group_size=None,
                          intra_mode="block_int8"):
    """LOGICAL per-replica bytes on the wire of ONE gradient reduction
    under a compression mode, ring convention (the reference's bill,
    whole):

      dense       2*(dp-1)/dp * G
      int8        2*(dp-1)/dp * (N + 4)
      block_int8  2*(dp-1)/dp * (N + 4*ceil(N/block))
      threshold   (dp-1) * cap * 5        cap = ceil(N*capacity)
      hierarchical  intra (I-1)/I * (Np + 4*ceil(Np/block)) (or the
                    dense Np*itemsize when intra_mode=None) plus the
                    (I-1)/I * Np*itemsize fan-back all-gather, and the
                    leader hop (groups-1) * cap(Ns) * 5

    N = grad_bytes / itemsize. Returns {wire_bytes, dense_wire_bytes,
    ratio, mode}; the hierarchical mode adds {intra_wire_bytes,
    leader_wire_bytes, group_size, groups, intra_mode,
    flat_threshold_wire_bytes, vs_flat_threshold}."""
    if compression not in COMPRESSION_MODES:
        raise ValueError(
            f"unknown gradient_compression {compression!r}; pick one of "
            f"{COMPRESSION_MODES}")
    if group_size is not None and compression != "hierarchical":
        raise ValueError(
            f"group_size only applies to "
            f"gradient_compression='hierarchical', got group_size="
            f"{group_size} with {compression!r}")
    block = DEFAULT_COMPRESSION_BLOCK if block is None else int(block)
    capacity = DEFAULT_ENCODING_CAPACITY if capacity is None \
        else float(capacity)
    G = int(grad_bytes)
    N = G // int(itemsize)
    dense = 2 * (dp - 1) * G // dp
    extra = {}
    if compression is None:
        wire = dense
    elif compression == "int8":
        wire = 2 * (dp - 1) * (N + 4) // dp
    elif compression == "block_int8":
        wire = 2 * (dp - 1) * (N + 4 * _ceil_div(N, block)) // dp
    elif compression == "threshold":
        wire = (dp - 1) * threshold_cap(N, capacity) * 5
    else:  # hierarchical
        gsz = default_compression_group(dp) if group_size is None \
            else int(group_size)
        if gsz < 2 or gsz >= dp or dp % gsz != 0:
            raise ValueError(
                f"hierarchical group_size {gsz} must be a divisor of "
                f"dp={dp} with 2 <= group_size <= dp/2 (node groups "
                "tile the data axis exactly and the leader exchange "
                "needs >= 2 groups)")
        if intra_mode not in (None, "block_int8"):
            raise ValueError(
                f"hierarchical intra_mode must be None (dense) or "
                f"'block_int8', got {intra_mode!r}")
        groups = dp // gsz
        Ns = hierarchical_shard_elems(N, gsz)
        Np = Ns * gsz
        if intra_mode == "block_int8":
            hop1 = (gsz - 1) * (Np + 4 * _ceil_div(Np, block)) // gsz
        else:
            hop1 = (gsz - 1) * Np * int(itemsize) // gsz
        hop3 = (gsz - 1) * Np * int(itemsize) // gsz
        leader = (groups - 1) * threshold_cap(Ns, capacity) * 5
        wire = hop1 + hop3 + leader
        flat_thr = (dp - 1) * threshold_cap(N, capacity) * 5
        extra = {
            "intra_wire_bytes": int(hop1 + hop3),
            "leader_wire_bytes": int(leader),
            "group_size": gsz,
            "groups": groups,
            "intra_mode": intra_mode or "dense",
            "flat_threshold_wire_bytes": int(flat_thr),
            "vs_flat_threshold": round(wire / flat_thr, 4)
            if flat_thr else 1.0,
        }
    from deeplearning4j_tpu_torch.runtime import telemetry

    gauge = telemetry.get_registry().gauge(
        "dl4j_compressed_wire_bytes",
        "analytic per-replica gradient bytes-on-wire per step",
        labels=("mode",))
    gauge.labels(mode=compression or "dense").set(int(wire))
    gauge.labels(mode="dense").set(int(dense))
    rec = {
        "wire_bytes": int(wire),
        "dense_wire_bytes": int(dense),
        "ratio": round(wire / dense, 4) if dense else 1.0,
        "mode": compression or "dense",
    }
    rec.update(extra)
    return rec
