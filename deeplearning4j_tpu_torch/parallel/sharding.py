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
  in the port's OIHW convolution kernels.
* ``shard_params`` / ``replicate_params`` (reference: :90-128): a
  network's leaves placed by ``spec_for_param`` over the mesh's model
  axis. Each sharded leaf becomes this rank's block along the spec's
  dimension, its updater state (Adam's moments, Nesterovs' velocity)
  the same block; an indivisible dimension replicates, or raises the
  reference's PAR03 message under ``on_indivisible="error"``. On a
  network it installs the tensor-parallel layer rule
  (``parallel.tensor``), so ``fit``/``output`` run over the model axis;
  ``replicate_params`` gathers the leaves back and removes it.
* ``ZeroShardedUpdate`` (and ``ManualZeroUpdate``, its compressed form):
  the ZeRO weight update (reference: :352-580). A leaf of n elements
  with ``n >= min_shard_size and n % dp == 0`` is reduce-scattered as
  rows [dp, n/dp] (``scatter_mean``; int8/block_int8 lanes through
  ``quantized_psum_scatter_mean``, each rank's row packed apart), the
  updater runs on this rank's row of the flat param and of its state,
  which is allocated in that layout, and the rows are all-gathered back;
  every other leaf takes the replicated exchange. The leaves of a dtype
  go in one reduce-scatter and one all-gather. ``dp_weight_update_bytes``
  is the reference's bill, whole.
* ``hierarchical_mesh`` / ``hierarchical_grad_exchange``: the 2-hop
  exchange (reference: :215-350) over ``torch.distributed`` subgroups,
  a node group of contiguous ranks and the ranks at one intra position.
  Hop 1 reduce-scatters every leaf (zero-padded to the group size)
  inside the node group, dense or as block_int8 lanes, and divides by
  the group size; hop 2 is ``threshold_psum_mean`` of this rank's blocks
  over the leaders' group; hop 3 all-gathers the blocks back.

``COMPRESSION_MODES`` lists the reference's modes.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.compression import threshold_cap
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, GROUP_AXIS, INTRA_AXIS, MODEL_AXIS, Mesh,
)

__all__ = ["shard_batch", "spec_for_param", "shard_params",
           "replicate_params", "shard_plan", "quantized_psum_mean",
           "threshold_psum_mean", "quantized_psum_scatter_mean",
           "scatter_mean", "mean_all", "own_row", "ZeroShardedUpdate",
           "ManualZeroUpdate", "dp_weight_update_bytes",
           "HierarchicalGroups", "hierarchical_mesh",
           "hierarchical_grad_exchange",
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
    if isinstance(mesh, Mesh):
        # rows over the named axes only: rank order over them, row-major
        rank, width = 0, 1
        for ax in axes:
            g = mesh.group(ax)
            rank, width = rank * g.size + g.rank, width * g.size
    else:
        rank, width = mesh.rank, mesh.size
    if arr.shape[dim] % width != 0:
        raise ValueError(
            f"Global batch {arr.shape[dim]} not divisible by "
            f"data-parallel mesh axis '{batch_axis}' (size {width}): "
            "refusing to silently pad; use a batch size that is a "
            f"multiple of {width} (PAR03)")
    b = arr.shape[dim] // width
    return arr.narrow(dim, rank * b, b)


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


def _is_network(obj):
    return hasattr(obj, "_unit_keys") and hasattr(obj, "_params")


def _keystr(key, name):
    return f"[{key!r}][{name!r}]"


def shard_plan(params, mesh, model_axis=MODEL_AXIS, min_shard_size=2 ** 16,
               on_indivisible="replicate"):
    """{layer key: {leaf name: dimension}} of the leaves ``shard_params``
    shards, placing nothing (module docstring): `params` a network or a
    params tree, `mesh` a mesh or an {axis: size} dict."""
    if on_indivisible not in ("replicate", "error"):
        raise ValueError("on_indivisible must be 'replicate' or 'error'")
    if _is_network(params):
        keys, tree = params._unit_keys(), params._params
    else:
        tree = params
        keys = range(len(params)) if isinstance(params, (list, tuple)) \
            else list(params)
    axes = mesh if isinstance(mesh, dict) else mesh.shape
    width = int(axes.get(model_axis, 1))
    plan = {}
    for key in keys:
        for name, t in tree[key].items():
            shape = tuple(t.shape)
            spec = spec_for_param(name, shape, model_axis, min_shard_size)
            if model_axis not in spec:
                continue
            dim = spec.index(model_axis)
            if shape[dim] % width != 0:
                if on_indivisible == "error":
                    raise ValueError(
                        f"param {_keystr(key, name)} dim {shape[dim]} is "
                        f"not divisible by mesh axis '{model_axis}' (size "
                        f"{width}) (PAR03)")
                continue
            if width > 1:
                plan.setdefault(key, {})[name] = dim
    return plan


def shard_params(params, mesh, model_axis=MODEL_AXIS,
                 min_shard_size=2 ** 16, on_indivisible="replicate",
                 batch_axis=DATA_AXIS):
    """Place a network's (or a params tree's) leaves over the mesh's
    model axis (module docstring). `params` is a network (placed in
    place and returned, with the tensor-parallel rule installed) or a
    list/dict of per-layer {name: tensor} dicts (this rank's blocks
    returned in the same structure). A mesh without `model_axis`, or of
    model size 1, shards nothing."""
    from deeplearning4j_tpu_torch.parallel.tensor import TensorParallel

    if not _is_network(params):
        keys = range(len(params)) if isinstance(params, (list, tuple)) \
            else list(params)
        plan = shard_plan(params, mesh, model_axis, min_shard_size,
                          on_indivisible)
        tp = TensorParallel(mesh, model_axis, batch_axis, plan)
        out = [{n: tp.block(t, plan[k][n]).clone()
                if n in plan.get(k, {}) else t
                for n, t in params[k].items()} for k in keys]
        return out if isinstance(params, (list, tuple)) \
            else dict(zip(keys, out))
    net = params
    net._require_init()
    if getattr(net, "_tp", None) is not None:
        replicate_params(net, mesh)
    plan = shard_plan(net, mesh, model_axis, min_shard_size, on_indivisible)
    mode = getattr(net.conf, "gradientNormalization", None)
    if plan and mode not in (None, "clip_elementwise"):
        raise ValueError(
            f"gradientNormalization={mode} takes norms over whole leaves, "
            "and under tensor parallelism a rank holds blocks of the "
            "sharded ones: use ClipElementWiseAbsoluteValue or none")
    noisy = [k for k in plan
             if getattr(net._unit_layer(k), "weightNoise", None) is not None]
    if noisy:
        raise ValueError(
            f"layers {noisy} draw weight noise over whole leaves, and "
            "under tensor parallelism a rank holds blocks of them: raise "
            "min_shard_size past them or drop the noise")
    tp = TensorParallel(mesh, model_axis, batch_axis, plan)
    with torch.no_grad():
        for k, dims in plan.items():
            p = net._params[k]
            for n, dim in dims.items():
                p[n] = tp.block(p[n].detach(), dim).clone() \
                    .requires_grad_(True)
            net._upd_states[k] = tp.block_upd_state(k, net._upd_states[k])
    net._tp = tp
    net._captured = None
    net._rebind()
    net._reset_solver()
    return net


def replicate_params(params, mesh=None):
    """The whole leaves on every rank (reference: ``replicate_params``):
    a network placed by ``shard_params`` gets its leaves and updater
    state gathered back and the tensor-parallel rule removed (every rank
    of the model group must call it); a params tree is returned as it
    is, each rank holding it whole already."""
    if not _is_network(params):
        return params
    net = params
    tp = getattr(net, "_tp", None)
    if tp is None:
        return net
    keys = net._unit_keys()
    with torch.no_grad():
        whole = tp.whole_params(net)
        upd = tp.whole_upd_states(net, net._upd_states)
        for k in keys:
            for n, t in whole[k].items():
                if n in tp.sharded.get(k, {}):
                    net._params[k][n] = t.clone().requires_grad_(True)
            net._upd_states[k] = upd[k]
    net._tp = None
    net._captured = None
    net._rebind()
    net._reset_solver()
    return net


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


# ----------------------------------------------------------------------
# the ZeRO weight update (reference: :352-580)
# ----------------------------------------------------------------------

def _map_pair(fn, a, b):
    """`fn(leaf_a, leaf_b)` over two trees of one structure, keeping
    `a`'s containers (tuples stay tuples)."""
    if isinstance(a, dict):
        return {k: _map_pair(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_map_pair(fn, x, y) for x, y in zip(a, b))
    return fn(a, b) if isinstance(a, torch.Tensor) else a


def _by_dtype(tensors):
    """Indices of `tensors` grouped by dtype, in first-seen order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _rows(flats, dp):
    """[dp, sum n_i/dp]: row r holds each flat's r-th 1/dp block."""
    return torch.cat([f.reshape(dp, -1) for f in flats], 1)


def own_row(rows, group):
    """Row ``group.rank`` of `rows` (row 0 where the group has no
    process group): this rank's block of a rank-ordered stack."""
    return rows[group.rank if group.pg is not None else 0]


def scatter_mean(leaves, group, weight=None):
    """The dense reduce-scatter of every leaf (each length divisible by
    the group's size): this rank's 1/dp block of each leaf's mean over
    the ranks, one reduce-scatter a dtype. With `weight` each rank's
    leaves are scaled by it and summed (the label-mask mean), as the
    replicated exchange does."""
    dp = group.size
    out = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        flat = _rows([leaves[i].reshape(-1) for i in idx], dp).reshape(-1)
        if weight is not None:
            flat = flat * weight.to(flat.dtype)
        mine = _coll.reduce_scatter(flat, group)
        if group.pg is not None and weight is None:
            mine = _div(mine, dp)
        for i, seg in zip(idx, mine.split([leaves[i].numel() // dp
                                           for i in idx])):
            out[i] = seg
    return out


def quantized_psum_scatter_mean(leaves, group, mode="int8", block=None):
    """The compressed reduce-scatter of every leaf (each length
    divisible by the group's size; reference: ``quantized_psum_scatter_
    mean``): quantized on the scale grid ``quantized_psum_mean`` shares
    across ranks, the int8 lanes reduce-scattered exactly
    (``collectives.int8_lane_scatter``), and only this rank's 1/dp block
    of each leaf dequantized, in f32, then cast to the leaf's dtype."""
    block = DEFAULT_COMPRESSION_BLOCK if block is None else int(block)
    dp = group.size
    q, scale, spans = _quantize(leaves, group, mode, block)
    sizes = [g.numel() for g in leaves]
    # each leaf's own lanes and scales, its block padding dropped
    qs = [s[:n] for s, n in zip(q.split(spans), sizes)]
    scs = [s[:n] for s, n in zip(scale.split(spans), sizes)]
    summed = _coll.int8_lane_scatter(_rows(qs, dp), group)
    sc = own_row(_rows(scs, dp), group)
    mean = _div(summed.to(torch.float32) * _div(sc, 127.0), dp)
    return [m.to(g.dtype) for m, g in zip(
        mean.split([n // dp for n in sizes]), leaves)]


class ZeroShardedUpdate:
    """ZeRO-style cross-replica weight-update sharding (Xu et al.,
    arXiv:2004.13336; reference: ``ZeroShardedUpdate`` and its
    shard_map twin ``ManualZeroUpdate``), over this rank's data group.

    Installed as a network's (or SameDiff's) ``_update_impl``, it takes
    the step's per-rank gradients after the backward pass and replaces
    the gradient all-reduce and the update:

      * each eligible leaf (``n >= min_shard_size and n % dp == 0``: the
        reference's rule, never padded) is reduce-scattered, so this
        rank receives the mean of its 1/dp block of the flat leaf, dense
        (``scatter_mean``) or as int8 lanes (``compression`` "int8" /
        "block_int8": ``quantized_psum_scatter_mean``); every other leaf
        takes the replicated exchange and updates whole;
      * the updater runs on this rank's block of the params and of its
        state, which is allocated in that layout (``init_state``): a
        rank only ever holds 1/dp of an eligible leaf's updater state;
      * the fresh blocks are all-gathered into the full params, one
        all-gather a dtype, and the layers' constraints applied.

    ``pre_reduced=True`` (the dense mode under gradient normalization,
    which needs the whole reduced gradient): the gradients arrive as the
    mean already and each rank takes its block locally. `weight` (set
    per step by the wrapper) is the dense exchange's label-mask share.
    The flat view is a reshape and the update elementwise, so a step at
    world 1 is bitwise the replicated one; at dp > 1 only the order the
    backend sums the ranks' gradients in can differ."""

    def __init__(self, mesh, axis=DATA_AXIS, min_shard_size=2 ** 16,
                 compression=None, block=None):
        if axis not in mesh.shape:
            raise ValueError(
                f"mesh has no axis '{axis}' (axes: {list(mesh.shape)}); "
                "build the mesh with a data-parallel axis or pass axis=")
        if compression not in (None, "int8", "block_int8"):
            raise ValueError(
                "the sharded weight update composes with "
                "gradient_compression 'int8'/'block_int8', got "
                f"{compression!r} (the 'threshold' step's per-replica "
                "error-feedback residual has no per-parameter "
                "reduce-scatter form)")
        self.mesh = mesh
        self.axis = axis
        self.dp = int(mesh.shape[axis])
        self.min_shard_size = int(min_shard_size)
        self.compression = compression
        self.block = DEFAULT_COMPRESSION_BLOCK if block is None \
            else int(block)
        self.pre_reduced = False
        self.weight = None

    # ----- eligibility and the layout ---------------------------------
    def eligible(self, leaf):
        """Shard-or-replicate for one tensor (or a shape, or an element
        count) by its total element count."""
        if isinstance(leaf, torch.Tensor):
            n = leaf.numel()
        elif isinstance(leaf, (tuple, list)):
            n = int(np.prod(leaf))
        else:
            n = int(leaf)
        return n > 0 and n >= self.min_shard_size and n % self.dp == 0

    def _rank(self):
        return self.mesh.rank if self.mesh.pg is not None else 0

    def _width(self):
        return self.dp if self.mesh.pg is not None else 1

    def shard(self, t):
        """This rank's block of `t` flattened in its logical order: a
        view of a contiguous `t`, a copy of any other (a channels-last
        convolution kernel), which the update writes back."""
        m = t.numel() // self._width()
        return t.detach().reshape(-1).narrow(0, self._rank() * m, m)

    def view(self, params):
        """{name: this rank's block of an eligible param, else the
        param}."""
        return {k: self.shard(p) if self.eligible(p) else p
                for k, p in params.items()}

    def init_state(self, updater, params):
        """Fresh updater state allocated in the sharded layout."""
        with torch.no_grad():
            return updater.init(self.view(params))

    def place_state(self, state):
        """A state in the canonical full-shape layout -> the sharded one
        (this rank's blocks copied out; the rest freed)."""
        return _map_pair(
            lambda a, _: self.shard(a).clone() if self.eligible(a) else a,
            state, state)

    def unview_state(self, state, updater, params):
        """The sharded layout -> the canonical full-shape layout: each
        block all-gathered over the ranks and reshaped (every rank
        calls it; checkpoints and files hold this form, so a sharded
        save restores into any mode and any dp)."""
        with torch.device("meta"):
            template = updater.init({k: torch.empty_like(p, device="meta")
                                     for k, p in params.items()})
        g = self.mesh

        def unview(s, t):
            if not self.eligible(t):
                return s
            full = _coll.all_gather(s.contiguous(), g) \
                if g.pg is not None else s
            return full.reshape(t.shape).clone()

        return _map_pair(unview, state, template)

    def canonical_states(self, net):
        """`net`'s updater state in the canonical layout (``unview_state``
        of every layer that holds params)."""
        out = dict(net._upd_states) if isinstance(net._upd_states, dict) \
            else list(net._upd_states)
        for k in net._unit_keys():
            if net._params[k]:
                out[k] = self.unview_state(net._upd_states[k],
                                           net._updaters[k], net._params[k])
        return out

    @staticmethod
    def per_rank_state_bytes(states):
        """Bytes of updater state this rank holds (every tensor leaf)."""
        from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

        return sum(t.numel() * t.element_size() for t in tree_leaves(states)
                   if isinstance(t, torch.Tensor))

    # ----- the step ----------------------------------------------------
    def _reduce(self, grads, params):
        """Every unit's gradients as the update reads them: an eligible
        leaf as this rank's block of the mean, the rest whole."""
        g = self.mesh
        items = [(u, k) for u, gd in enumerate(grads) for k in gd]
        elig = [(u, k) for u, k in items if self.eligible(params[u][k])]
        rest = [(u, k) for u, k in items if not self.eligible(params[u][k])]
        out = [dict(gd) for gd in grads]
        if self.pre_reduced:
            for u, k in elig:
                out[u][k] = self.shard(grads[u][k])
            return out
        eg = [grads[u][k] for u, k in elig]
        rg = [grads[u][k] for u, k in rest]
        if self.compression is None:
            eg = scatter_mean(eg, g, self.weight) if eg else []
            rg = mean_all(rg, g, self.weight)
        else:
            eg = quantized_psum_scatter_mean(eg, g, self.compression,
                                             self.block) if eg else []
            rg = quantized_psum_mean(rg, g, self.compression,
                                     self.block) if rg else []
        for (u, k), t in zip(elig, eg):
            out[u][k] = t
        for (u, k), t in zip(rest, rg):
            out[u][k] = t
        return out

    def step(self, units, iteration):
        """One sharded update in place. `units`: [(updater, grads,
        updater state, params, hp)] per layer that trains; returns the
        units' new updater states."""
        grads = self._reduce([u[1] for u in units], [u[3] for u in units])
        states, blocks = [], []
        with torch.no_grad():
            for (upd, _, st, params, hp), gv in zip(units, grads):
                pv = self.view(params)
                delta, st = upd.apply(gv, st, iteration, params=pv, hp=hp)
                for k, p in pv.items():
                    p.sub_(delta[k].to(p.dtype))
                    if self.eligible(params[k]):
                        blocks.append((params[k], p))
                states.append(st)
            self._gather(blocks)
        return states

    def _gather(self, blocks):
        """(param, its fresh block) pairs: the blocks all-gathered into
        the full params (one all-gather a dtype); without a process
        group a block that is a copy is written back."""
        g = self.mesh
        if g.pg is None:
            for p, b in blocks:
                if not p.is_contiguous():
                    p.detach().copy_(b.view(p.shape))
            return
        for idx in _by_dtype([b for _, b in blocks]):
            rows = _coll.all_gather(torch.cat([blocks[i][1] for i in idx]),
                                    g)
            off = 0
            for i in idx:
                p, b = blocks[i]
                full = rows[:, off:off + b.numel()].reshape(-1)
                p.detach().copy_(full.view(p.shape))
                off += b.numel()

    def __call__(self, net, keys, grads, iteration, hyper=None):
        """The networks' hook (``NetworkRuntime._apply_updates``): every
        layer that trains, updated; its constraints applied after the
        gather."""
        from deeplearning4j_tpu_torch.nn.conf.constraint import \
            apply_constraints

        units, where = [], []
        for i, (k, gd) in enumerate(zip(keys, grads)):
            layer, params = net._unit_layer(k), net._params[k]
            if not params or getattr(layer, "frozen", False):
                continue
            units.append((net._updaters[k], gd, net._upd_states[k], params,
                          None if hyper is None else hyper.views(i)))
            where.append(k)
        for k, st in zip(where, self.step(units, iteration)):
            net._upd_states[k] = st
        with torch.no_grad():
            for k in where:
                apply_constraints(net._unit_layer(k), net._params[k])

    def describe(self):
        """What a capture key must hold of this hook."""
        return (f"zero[{self.axis}={self.dp},min={self.min_shard_size},"
                f"comp={self.compression},blk={self.block}]")


class ManualZeroUpdate(ZeroShardedUpdate):
    """The reference's compressed twin of ``ZeroShardedUpdate`` (its
    shard_map form): `zero`'s group, axis and size rule with the
    eligible leaves' int8/block_int8 lanes reduce-scattered
    (``quantized_psum_scatter_mean``) and the rest on the compressed
    all-reduce. In the port the two are one class; this one checks the
    mode as the reference does."""

    def __init__(self, zero, compression, block=None):
        if compression not in ("int8", "block_int8"):
            raise ValueError(
                "ManualZeroUpdate composes the sharded weight update "
                "with gradient_compression 'int8'/'block_int8', got "
                f"{compression!r} (the 'threshold' step's per-replica "
                "error-feedback residual has no per-parameter "
                "reduce-scatter form)")
        super().__init__(zero.mesh, zero.axis, zero.min_shard_size,
                         compression, block)
        self.zero = zero


def mean_all(tensors, group, weight=None):
    """The dense mean over the ranks of each tensor (one all-reduce a
    dtype), or with `weight` the sum of the weighted tensors; the tensors
    themselves without a process group."""
    if group.pg is None:
        return tensors
    out = [None] * len(tensors)
    for idx in _by_dtype(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if weight is not None:
            flat = flat * weight.to(flat.dtype)
        _coll.all_reduce(flat, group)
        if weight is None:
            flat = _div(flat, group.size)
        for i, seg in zip(idx, flat.split([tensors[i].numel()
                                           for i in idx])):
            out[i] = seg.view(tensors[i].shape)
    return out


def dp_weight_update_bytes(grad_bytes, dp, master_bytes=None,
                           opt_state_bytes=None, sharded=False,
                           compression=None, compression_block=None,
                           encoding_capacity=None,
                           compression_group=None):
    """Analytic per-replica bytes of the data-parallel weight update
    (the reference's bill, whole): replicated, the ring all-reduce
    2(dp-1)/dp·G and the full update 2M + 2S + G; sharded (ZeRO), a
    (dp-1)/dp·G reduce-scatter plus a (dp-1)/dp·M all-gather on the
    wire, the update (2M + 2S + G)/dp and S/dp of updater state resident
    a rank. A compressed sharded step bills its reduce-scatter as half
    the compressed all-reduce (``compressed_reduce_scatter_bytes``); the
    threshold and hierarchical modes do not compose with it and raise.
    M and S default to G."""
    if compression not in COMPRESSION_MODES:
        raise ValueError(
            f"unknown gradient_compression {compression!r}; pick one of "
            f"{COMPRESSION_MODES}")
    if sharded and compression in ("threshold", "hierarchical"):
        raise ValueError(
            f"weight_update sharding does not compose with "
            f"gradient_compression={compression!r}: the Strom step "
            "carries per-replica error-feedback residuals and "
            "transmits sparse messages, which have no per-parameter "
            "reduce-scatter form; bill 'int8'/'block_int8' (compressed "
            "reduce-scatter) or the dense sharded path")
    G = int(grad_bytes)
    M = G if master_bytes is None else int(master_bytes)
    S = G if opt_state_bytes is None else int(opt_state_bytes)
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    allreduce = 2 * (dp - 1) * G // dp
    update_repl = 2 * M + 2 * S + G
    update_shard = (2 * M + 2 * S + G) // dp
    rec = {
        "allreduce_bytes": allreduce,
        "update_replicated_bytes": update_repl,
        "update_sharded_bytes": update_shard,
        "sharding_saves_bytes": update_repl - update_shard,
        "dp": int(dp),
        "mode": "sharded" if sharded else "replicated",
        "gradient_compression": compression,
    }
    if compression is not None:
        rec["compressed_wire"] = compressed_wire_bytes(
            G, dp, compression, block=compression_block,
            capacity=encoding_capacity,
            group_size=compression_group
            if compression == "hierarchical" else None)
    if not sharded:
        rec["update_bytes"] = update_repl
        rec["opt_state_resident_bytes"] = S
        return rec
    rs = (dp - 1) * G // dp
    ag = (dp - 1) * M // dp
    rec.update({
        "reduce_scatter_bytes": rs,
        "all_gather_bytes": ag,
        "collective_wire_bytes": rs + ag,
        "update_bytes": update_shard,
        "opt_state_resident_bytes": S // dp,
        "hlo_collective_bytes": {
            "reduce_scatter": (G + G // dp) + (M + M // dp),
            "all_reduce_gather": 2 * G + (M + M // dp),
        },
    })
    if compression is not None:
        rs_c = rec["compressed_wire"]["wire_bytes"] // 2
        rec["compressed_reduce_scatter_bytes"] = rs_c
        rec["collective_wire_bytes_compressed"] = rs_c + ag
    return rec


# ----------------------------------------------------------------------
# the hierarchical 2-hop exchange (reference: :215-350)
# ----------------------------------------------------------------------

class HierarchicalGroups:
    """This rank's two subgroups of a data axis factored into node
    groups of `group_size` contiguous ranks (reference:
    ``hierarchical_mesh``, intra innermost): ``intra`` (the ranks of this
    rank's node group, over the "intra" axis) and ``group`` (the ranks
    at this rank's intra position in every node group, over the "group"
    axis: the leaders of this rank's shard). ``shape`` is {"group": G,
    "intra": g}."""

    def __init__(self, mesh, group_size, intra, group):
        self.mesh, self.group_size = mesh, int(group_size)
        self.n_groups = mesh.size // self.group_size
        self.intra, self.group = intra, group

    @property
    def shape(self):
        return {GROUP_AXIS: self.n_groups, INTRA_AXIS: self.group_size}


def _position(mesh, g):
    """(node group, intra position) of this rank in groups of `g`."""
    return divmod(mesh.rank, g)


def hierarchical_mesh(mesh, group_size, batch_axis=DATA_AXIS):
    """Factor a pure data-parallel group into node groups of
    `group_size` contiguous ranks: a ``HierarchicalGroups`` of this
    rank's intra and group subgroups (``torch.distributed`` groups made
    on every rank in one order). Rejects meshes with other axes and
    indivisible or degenerate group sizes with the reference's
    messages."""
    from deeplearning4j_tpu_torch.parallel.mesh import DataGroup

    names = tuple(mesh.shape)
    if names != (batch_axis,):
        raise ValueError(
            f"gradient_compression='hierarchical' needs a 1-D pure "
            f"data-parallel mesh over '{batch_axis}', got axes "
            f"{list(names)}: the 2-hop exchange re-factors the data "
            "axis itself and cannot coexist with other mesh axes")
    dp = int(mesh.shape[batch_axis])
    g = int(group_size)
    if g < 2:
        raise ValueError(
            f"compressionGroupSize must be >= 2, got {g}: a 1-chip "
            "group has no intra-group reduction — that is the flat "
            "gradient_compression='threshold' mode; use it directly")
    if g > dp:
        raise ValueError(
            f"compressionGroupSize {g} exceeds the data-parallel "
            f"degree {dp}: a group cannot span more chips than the "
            "mesh has")
    if g == dp:
        raise ValueError(
            f"compressionGroupSize {g} equals the data-parallel degree "
            f"{dp}, leaving a single node group — hop 2's sparse "
            "leader exchange would have no peer to exchange with; use "
            "gradient_compression='block_int8' for pure in-group "
            f"quantization, or a divisor of {dp} that is <= {dp // 2}")
    if dp % g != 0:
        raise ValueError(
            f"data-parallel degree {dp} is not divisible by "
            f"compressionGroupSize {g}: node groups must tile the "
            f"data axis exactly (pick a divisor of {dp})")
    G = dp // g
    gi, ii = _position(mesh, g)
    intra_pg = group_pg = None
    if mesh.pg is not None:
        import torch.distributed as dist

        # every rank makes every subgroup, in one order, and keeps its own
        intras = [dist.new_group([k * g + j for j in range(g)])
                  for k in range(G)]
        leaders = [dist.new_group([k * g + j for k in range(G)])
                   for j in range(g)]
        intra_pg, group_pg = intras[gi], leaders[ii]

    class _Sub(DataGroup):
        def __init__(self, axis, r, size, pg):
            super().__init__(r, size, mesh.backend, pg, mesh.device)
            self._axis = axis

        @property
        def shape(self):
            return {self._axis: self.size}

    return HierarchicalGroups(mesh, g, _Sub(INTRA_AXIS, ii, g, intra_pg),
                              _Sub(GROUP_AXIS, gi, G, group_pg))


def hierarchical_grad_exchange(leaves, residual, tau, groups, capacity,
                               intra_mode="block_int8", block=None):
    """The 2-hop exchange of every leaf at once over `groups`
    (``hierarchical_mesh``; reference: ``hierarchical_grad_exchange``,
    per leaf):

      hop 1  a dense or block_int8 reduce-scatter inside the node group
             of each leaf zero-padded to a multiple of the group size,
             divided by the group size: this rank holds the group MEAN
             of its 1/g block of each leaf (the group is one virtual
             Strom replica);
      hop 2  the threshold exchange of those blocks between the ranks
             at this intra position (``threshold_psum_mean``: error
             feedback, the fixed-capacity encoder, the gathered codes'
             scatter-add, /n_groups);
      hop 3  the all-gather fan-back inside the node group.

    `residual` is this rank's error-feedback flat, one block per leaf
    (``hierarchical_shard_elems`` each). Returns (means shaped and typed
    as `leaves`, the residual after encoding, the count of entries
    sent, a 0-d int tensor); clipping and the adaptive tau are the
    caller's, as in the flat threshold mode."""
    block = DEFAULT_COMPRESSION_BLOCK if block is None else int(block)
    intra = groups.intra
    g = groups.group_size
    sizes = [t.numel() for t in leaves]
    ns = [hierarchical_shard_elems(n, g) for n in sizes]
    pads = [torch.nn.functional.pad(t.reshape(-1).to(torch.float32),
                                    (0, s * g - n))
            for t, n, s in zip(leaves, sizes, ns)]
    if intra_mode == "block_int8":
        q, scale, spans = _quantize(pads, intra, "block_int8", block)
        qs = [a[:s * g] for a, s in zip(q.split(spans), ns)]
        scs = [a[:s * g] for a, s in zip(scale.split(spans), ns)]
        summed = _coll.int8_lane_scatter(_rows(qs, g), intra)
        sc = own_row(_rows(scs, g), intra)
        shard = summed.to(torch.float32) * _div(sc, 127.0 * g)
    else:
        shard = _div(_coll.reduce_scatter(_rows(pads, g).reshape(-1),
                                          intra), g)
    means, rest, sent = threshold_psum_mean(
        list(shard.split(ns)), residual, tau, capacity, groups.group)
    mine = torch.cat([m.reshape(-1) for m in means])
    rows = _coll.all_gather(mine, intra)     # [g, sum ns]
    out, off = [], 0
    for t, n, s in zip(leaves, sizes, ns):
        full = rows[:, off:off + s].reshape(-1)[:n]
        out.append(full.view(t.shape).to(t.dtype))
        off += s
    return out, rest, sent
