"""The collectives the data-parallel trainers run, over ``torch.distributed``.

Port-only: the reference's are ``lax.psum``/``pmax``/``all_gather``
inside ``shard_map`` programs, which XLA lowers to ICI collectives. Here
each is one call on the group's process group (NCCL on the card, gloo
on the CPU or where the caller asked for it), and a group with no
process group (world size 1, ``torch.distributed`` not initialised) is
the identity: nothing is launched and nothing is counted.

Every launched collective adds to three counters of the port's metrics
registry, labelled by op: ``dl4j_collectives_total``,
``dl4j_collective_payload_bytes_total`` (what this rank hands to the
collective) and ``dl4j_collective_wire_bytes_total`` (what it sends
under the ring convention ``sharding.compressed_wire_bytes`` bills:
2(dp-1)/dp of the payload for an all-reduce, (dp-1) payloads for an
all-gather, (dp-1)/dp for a broadcast and for a reduce-scatter, whose
payload is the whole input). ``totals()`` reads them, so a
trainer can report collectives and bytes a step.

``int8_lane_sum`` is the int8 exchange's wire format. The reference sums
int8 lanes in int16 (``sharding._acc_dtype``); gloo rejects int16 and
NCCL has no 16-bit integer type. Each lane is biased to [0, 254] and
``k = 31 // bits`` lanes are packed into one int32 word, ``bits`` wide
enough for 254·dp, so the int32 all-reduce adds every lane exactly with
no carry between lanes: 4/k bytes an element (k = 3 up to dp 4, 2 up to
dp 129) where an int32 sum would send 4, one all-reduce, and it runs on
every backend that all-reduces int32 (gloo on the card included).
``int8_lane_scatter`` packs each rank's row the same way and
reduce-scatters the words: the ZeRO update's compressed half.

The mesh axes' exchanges (reference: ``lax.ppermute``,
``lax.all_to_all`` and GSPMD's inserted gathers):

* ``ppermute(t, group, shift)``: rank i's `t` to rank i+shift, as one
  ``dist.batch_isend_irecv`` (a send and a receive a rank); cyclic
  unless ``cyclic=False``, where a rank with no source gets zeros. Wire:
  one payload a rank.
* ``all_to_all(t, group, split_dim, concat_dim)``: `t` cut into `size`
  blocks along split_dim, block j to rank j, the received blocks
  concatenated along concat_dim in rank order (the reference's
  ``tiled=True``), one ``dist.all_to_all_single``. Wire: (size-1)/size
  of the payload.
* The autograd Functions the axes differentiate through: ``copy_to``
  (Megatron's f: identity forward, all-reduce of the gradient
  backward), ``gather_from`` (all-gather along a dim forward, this
  rank's block of the gradient backward), ``scatter_to`` (its dual:
  this rank's block forward, the gradient's blocks all-gathered
  backward), ``reduce_from`` (all-reduce
  forward, identity backward: a sum whose every term has its own
  gradient), ``ppermute_grad`` (backward: the inverse shift) and
  ``all_to_all_grad`` (backward: the transposed all-to-all). On a group
  with no process group each is the identity.

The collective signature: under ``recording()`` every call made here
appends one ``Site`` (op, dtype, element count, group axes and size,
payload and wire bytes, the int8 lanes it carries) to the recording, in
call order: the port's counterpart of the reference's jaxpr walk
(``analysis.collectives`` checks it). ``recording(execute=False)``
records without communicating (each op returns what a one-rank group
would), so ranks whose signatures differ can compare them instead of
deadlocking.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Site", "all_reduce", "all_gather", "broadcast",
           "reduce_scatter", "int8_lane_sum", "int8_lane_scatter",
           "ppermute", "all_to_all", "copy_to", "gather_from",
           "scatter_to", "reduce_from", "ppermute_grad",
           "all_to_all_grad", "lane_bits", "recording", "totals",
           "wire_bytes"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_COUNTERS = None
#: the active recording: (list of Site, execute?) or None
_RECORDING = None


class Site:
    """One collective call, in call order (the signature's entry)."""

    __slots__ = ("op", "dtype", "count", "axes", "size", "payload_bytes",
                 "wire_bytes", "lanes", "reduce", "perm")

    def __init__(self, op, dtype, count, axes, size, payload_bytes,
                 wire_bytes, lanes=None, reduce=None, perm=None):
        self.op, self.dtype, self.count = op, str(dtype), int(count)
        self.axes, self.size = tuple(axes), int(size)
        self.payload_bytes = int(payload_bytes)
        self.wire_bytes = int(wire_bytes)
        self.lanes = lanes
        self.reduce = reduce
        #: a ppermute's (source, destination) pairs (COL06 checks them)
        self.perm = perm

    def key(self):
        """What two ranks' signatures must agree on."""
        return (self.op, self.dtype, self.count, self.axes, self.size,
                self.reduce)

    def format(self):
        extra = "" if self.lanes is None else f" lanes={self.lanes}"
        red = "" if self.reduce is None else f" op={self.reduce}"
        return (f"{self.op}[axes={','.join(self.axes)} size={self.size} "
                f"dtype={self.dtype} count={self.count}{red}{extra} "
                f"wire={self.wire_bytes}B]")

    def __repr__(self):
        return f"<Site {self.format()}>"


class recording:
    """Context manager: record every collective made here in this
    process, in call order (``.sites``); with ``execute=False`` nothing
    communicates."""

    def __init__(self, execute=True):
        self.execute = bool(execute)
        self.sites = []

    def __enter__(self):
        global _RECORDING
        if _RECORDING is not None:
            raise RuntimeError("a collective recording is already active")
        _RECORDING = (self.sites, self.execute)
        return self

    def __exit__(self, *exc):
        global _RECORDING
        _RECORDING = None
        return False


#: the op a recorded site's wire bytes are billed as
_WIRE_OP = {"int8_lane_sum": "all_reduce",
            "int8_lane_scatter": "reduce_scatter"}


def _record(op, t, group, reduce=None, lanes=None, perm=None):
    """Append `op` on `t` over `group` to the active recording; return
    whether the op should communicate."""
    rec = _RECORDING
    if rec is None:
        return True
    n = t.numel() * t.element_size()
    size = group.size
    rec[0].append(Site(op, str(t.dtype).replace("torch.", ""), t.numel(),
                       tuple(getattr(group, "shape", {"data": size})),
                       size, n, wire_bytes(_WIRE_OP.get(op, op), n, size),
                       lanes=lanes, reduce=reduce, perm=perm))
    return rec[1]


def _counters():
    global _COUNTERS
    if _COUNTERS is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        _COUNTERS = (
            reg.counter("dl4j_collectives_total",
                        "collectives launched by the data-parallel path",
                        labels=("op",)),
            reg.counter("dl4j_collective_payload_bytes_total",
                        "bytes this rank handed to collectives",
                        labels=("op",)),
            reg.counter("dl4j_collective_wire_bytes_total",
                        "bytes this rank sent, ring convention",
                        labels=("op",)))
    return _COUNTERS


def wire_bytes(op, payload, size):
    """Bytes one rank sends for `op` on `payload` bytes over `size`
    ranks, under the ring convention (module docstring)."""
    if op == "all_reduce":
        return 2 * (size - 1) * payload // size
    if op == "all_gather":
        return (size - 1) * payload
    if op == "ppermute":
        return payload if size > 1 else 0
    # a broadcast, an all-to-all, and a reduce-scatter of `payload`
    # bytes (each rank keeps 1/size of the sum)
    return (size - 1) * payload // size


def _count(op, t, size):
    n = t.numel() * t.element_size()
    calls, payload, wire = _counters()
    calls.labels(op=op).inc()
    payload.labels(op=op).inc(n)
    wire.labels(op=op).inc(wire_bytes(op, n, size))


def totals():
    """(collectives, payload bytes, wire bytes) launched so far in this
    process, over every op."""
    return tuple(int(sum(c.value for c in inst.children()))
                 for inst in _counters())


def all_reduce(t, group, op="sum", _lanes=None):
    """`t` reduced in place over the group's ranks (op "sum" or "max");
    returns `t`."""
    if group.pg is not None:
        if not _record("int8_lane_sum" if _lanes is not None
                       else "all_reduce", t, group, reduce=op,
                       lanes=_lanes):
            return t
        _count("all_reduce", t, group.size)
        dist.all_reduce(t, op=_OPS[op], group=group.pg)
    return t


def all_gather(t, group):
    """Every rank's `t`, stacked in rank order: [size, *t.shape]."""
    if group.pg is None:
        return t.unsqueeze(0)
    if not _record("all_gather", t, group):
        return t.unsqueeze(0).expand(group.size, *t.shape).clone()
    _count("all_gather", t, group.size)
    out = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(out, t.contiguous(), group=group.pg)
    return torch.stack(out)


def reduce_scatter(t, group, _lanes=None):
    """This rank's block of the sum over the group's ranks of `t`, a 1-D
    tensor whose length the group's size divides: rank r keeps elements
    [r·n/size, (r+1)·n/size) of the sum."""
    if group.pg is None:
        return t
    m = t.numel() // group.size
    if not _record("int8_lane_scatter" if _lanes is not None
                   else "reduce_scatter", t, group, reduce="sum",
                   lanes=_lanes):
        return t[group.rank * m:(group.rank + 1) * m].clone()
    _count("reduce_scatter", t, group.size)
    out = torch.empty(m, dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group.pg)
    return out


def broadcast(t, group, src=0):
    """`t` overwritten in place by rank `src`'s; returns `t`."""
    if group.pg is not None:
        if not _record("broadcast", t, group):
            return t
        _count("broadcast", t, group.size)
        dist.broadcast(t, src, group=group.pg)
    return t


def lane_bits(size):
    """Bits a packed lane needs to hold the sum of `size` biased int8
    lanes (254 each at most)."""
    return (254 * int(size)).bit_length()


def _pack(u, bits, k):
    """Rows of biased lanes [rows, n] -> int32 words [rows, ceil(n/k)],
    k lanes of `bits` bits a word."""
    u = torch.nn.functional.pad(u, (0, (-u.shape[1]) % k))
    u = u.view(u.shape[0], -1, k)
    shifts = torch.arange(k, dtype=torch.int32, device=u.device) * bits
    return (u << shifts).sum(2, dtype=torch.int32), shifts


def int8_lane_scatter(q, group):
    """The exact sum over the group's ranks of `q` [size, m] (integer
    lanes in [-127, 127], row r bound for rank r), as this rank's row of
    the sum in int32: each row packed into int32 words as
    ``int8_lane_sum`` packs (no word straddles two rows) and
    reduce-scattered once."""
    size, m = q.shape
    bits = lane_bits(group.size)
    k = 31 // bits
    words, shifts = _pack(q.to(torch.int32) + 127, bits, k)
    mine = reduce_scatter(words.reshape(-1), group, _lanes=q.numel())
    lanes = (mine.unsqueeze(1) >> shifts) & ((1 << bits) - 1)
    return lanes.reshape(-1)[:m] - 127 * group.size


def int8_lane_sum(q, group):
    """The exact sum over the group's ranks of `q`, an integer tensor of
    lanes in [-127, 127] of the same length on every rank, as int32:
    packed into int32 words (module docstring) and all-reduced once."""
    bits = lane_bits(group.size)
    k = 31 // bits
    n = q.numel()
    words, shifts = _pack(q.reshape(1, -1).to(torch.int32) + 127, bits, k)
    words = words.reshape(-1)
    all_reduce(words, group, _lanes=n)
    lanes = (words.unsqueeze(1) >> shifts) & ((1 << bits) - 1)
    return lanes.reshape(-1)[:n] - 127 * group.size


# ----------------------------------------------------------------------
# the mesh axes' exchanges (module docstring)
# ----------------------------------------------------------------------

def _peer(group, i):
    """The global rank of index `i` of `group`."""
    ranks = getattr(group, "ranks", None)
    return int(i) if ranks is None else ranks[i]


def ppermute(t, group, shift=1, cyclic=True):
    """Rank i's `t` on rank i+shift of `group` (module docstring): this
    rank's result is what rank i-shift sent (zeros where there is none,
    ``cyclic=False``)."""
    size, r = group.size, group.rank
    if cyclic:
        dst, src = (r + shift) % size, (r - shift) % size
    else:
        dst = r + shift if 0 <= r + shift < size else None
        src = r - shift if 0 <= r - shift < size else None
    if group.pg is None:
        return t.clone() if src == r else torch.zeros_like(t)
    perm = [(i, (i + shift) % size) for i in range(size)] if cyclic \
        else [(i, i + shift) for i in range(size) if 0 <= i + shift < size]
    if not _record("ppermute", t, group, reduce=f"shift{shift:+d}"
                   + ("" if cyclic else "/open"), perm=perm):
        return t.clone() if (src == r or cyclic) else torch.zeros_like(t)
    _count("ppermute", t, size)
    t = t.contiguous()
    out = torch.empty_like(t) if src is not None else torch.zeros_like(t)
    if dst == r and src == r:
        out.copy_(t)
        return out
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, t, _peer(group, dst), group.pg))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group.pg))
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    return out


def all_to_all(t, group, split_dim, concat_dim):
    """`t` split in `size` blocks along split_dim, block j to rank j,
    the received blocks concatenated along concat_dim (module
    docstring)."""
    size = group.size
    if group.pg is None:
        return t
    if t.shape[split_dim] % size:
        raise ValueError(
            f"all_to_all: dim {split_dim} of size {t.shape[split_dim]} "
            f"does not divide over {size} ranks")
    if not _record("all_to_all", t, group):
        return t.clone()
    _count("all_to_all", t, size)
    inp = torch.stack(t.chunk(size, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group.pg)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _gather_dim(t, group, dim):
    """Every rank's `t` concatenated along `dim` in rank order (moved
    last for the exchange, so a channels_last activation gathers without
    a relayout)."""
    dim = dim % t.dim()
    xm = t.movedim(dim, -1).contiguous()
    rows = all_gather(xm, group)                    # [size, ..., c]
    full = rows.movedim(0, -2).reshape(*xm.shape[:-1], -1)
    return full.movedim(-1, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim % x.dim(), x.shape[dim]
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g.narrow(ctx.dim, r * n, n), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g.contiguous(), ctx.group, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, cyclic):
        ctx.args = (group, shift, cyclic)
        return ppermute(x.detach(), group, shift, cyclic)

    @staticmethod
    def backward(ctx, g):
        group, shift, cyclic = ctx.args
        return ppermute(g, group, -shift, cyclic), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return all_to_all(x.detach(), group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return all_to_all(g, group, concat_dim, split_dim), None, None, None


def copy_to(x, group):
    """Identity forward; the gradient all-reduced over `group`
    backward (the input of a column-parallel product)."""
    return x if group.pg is None else _Copy.apply(x, group)


def gather_from(x, group, dim=-1):
    """Every rank's block concatenated along `dim` forward; this rank's
    block of the gradient backward."""
    return x if group.pg is None else _Gather.apply(x, group, dim)


def scatter_to(x, group, dim=-1):
    """This rank's block of `x` along `dim` forward; every rank's block
    of the gradient gathered backward (``gather_from``'s dual: a
    replicated leaf read by a column block gets its whole gradient, the
    same on every rank)."""
    return x if group.pg is None else _Scatter.apply(x, group, dim)


def reduce_from(x, group):
    """The sum over `group` forward; the gradient as it is backward."""
    return x if group.pg is None else _Reduce.apply(x, group)


def ppermute_grad(x, group, shift=1, cyclic=True):
    """``ppermute`` with the inverse shift as its backward."""
    if group.pg is None:
        return ppermute(x, group, shift, cyclic)
    return _PPermute.apply(x, group, shift, cyclic)


def all_to_all_grad(x, group, split_dim, concat_dim):
    """``all_to_all`` with the transposed all-to-all as its backward."""
    return x if group.pg is None else _AllToAll.apply(
        x, group, split_dim, concat_dim)
