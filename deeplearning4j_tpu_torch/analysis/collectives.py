"""Collective-safety verifier (reference:
``deeplearning4j_tpu/analysis/collectives.py``, whose codes and checks
this keeps, retargeted from a jaxpr walk to the port's one collective
choke point).

The reference traces a program (``jax.make_jaxpr``) and walks its
jaxpr for collective primitives. Every collective of the port goes
through ``parallel/collectives.py`` (``all_reduce``, ``all_gather``,
``broadcast``, ``reduce_scatter``, ``int8_lane_sum``,
``int8_lane_scatter``, and the mesh axes' ``ppermute`` and
``all_to_all``), which records the ordered
**collective signature** of whatever runs under
``collectives.recording()``: one ``Site`` a call (op, dtype, element
count, group axes and size, payload and wire bytes, the int8 lanes it
packs). ``collective_signature(fn, *args)`` runs `fn` once under a
record-only recording (nothing communicates) and returns it.

- COL01  the deadlock shape. At run time: ranks whose recorded
         signatures differ (``verify_program`` gathers every rank's and
         compares them entry by entry); in the source: a collective call
         under a branch (``if``/``while``/a conditional expression) on
         ``rank``, ``get_rank()`` or a value derived from one
         (``lint_collective_source``; a deliberate one carries
         ``# collective-ok[COL01]: reason`` on its line).
- COL02  a site whose group axis is not an axis of the mesh.
- COL03  one int8 accumulator contract across three places: the
         analyzer (``expected_lane_bits(dp)``: the bits 254·dp needs),
         the lane packing (``collectives.lane_bits(dp)`` and the int32
         words each ``int8_lane_sum`` site sends: ceil(lanes / (31 //
         bits))) and the bill (its per-lane wire bytes, 4 / (31 //
         bits)). This replaces the reference's int16 ``psum``.
- COL04  a signature that drifted from its declared
         ``CollectiveContract`` (``compression_contract`` for the dense,
         int8, block_int8, threshold and hierarchical modes and the
         sharded weight update).
- COL05  ``check_bill``: measured wire bytes against an analytic bill
         (``port_wire_bill``: the port's own wire format; the
         reference's ``sharding.compressed_wire_bytes`` bills the
         reference's, which the port's int8 lanes exceed by 4/k).
- COL06  a ring that is not a permutation, or has self-cycles
         (``check_ring``; a ``ppermute`` site carries its pairs: ring
         attention's and the pipeline's shifts).

``linalg_contract(routine)`` declares the distributed-linalg routines'
shapes (``linalg/``), counted as the port records them: calls, not the
reference's jaxpr sites, so a ring's hops and CG's iterations each count
(``ring=`` and ``iterations=`` pin them; unpinned they are bounds).

Limits: the signature is this process's calls while the recording is
active; a collective made on another thread in that window is recorded
too. Record-only runs do not communicate, so ``fn``'s numbers are those
of a one-rank group: where ``fn`` is a bound method (a trainer's
``fit``), its owner (and the owner's ``.net``) is put back afterwards, so
a pre-flight leaves the replicas bitwise equal; a closure's side effects
stand.
"""

from __future__ import annotations

import ast
import contextlib
import re

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report

__all__ = ["CollectiveContract", "CollectiveSignature", "check_acc_dtype",
           "check_bill", "check_ring", "check_signature",
           "collective_counts", "collective_signature",
           "compression_contract", "expected_acc_dtype",
           "expected_lane_bits", "linalg_contract",
           "lint_collective_paths", "lint_collective_source",
           "port_wire_bill", "verify_program"]

_SUPPRESS_RE = re.compile(
    r"#\s*collective-ok\[(?P<codes>[A-Z0-9*,\s]+)\]\s*[:—-]\s*(?P<why>\S.*)")

#: the callees that are collectives at the source level
_COLLECTIVE_CALLS = {"all_reduce", "all_gather", "broadcast",
                     "int8_lane_sum", "quantized_psum_mean",
                     "threshold_psum_mean", "all_reduce_sum", "barrier",
                     "reduce_scatter", "all_gather_object",
                     "broadcast_object_list", "all_to_all"}


class CollectiveSignature:
    """Ordered collective sites of one run (``collectives.Site``)."""

    def __init__(self, sites):
        self.sites = list(sites)

    def counts(self):
        """{op: site count}."""
        out = {}
        for s in self.sites:
            out[s.op] = out.get(s.op, 0) + 1
        return out

    def axes(self):
        a = set()
        for s in self.sites:
            a |= set(s.axes)
        return a

    def wire_bytes(self):
        return sum(s.wire_bytes for s in self.sites)

    def keys(self):
        return [s.key() for s in self.sites]

    def __len__(self):
        return len(self.sites)

    def __iter__(self):
        return iter(self.sites)

    def format(self):
        return "\n".join(s.format() for s in self.sites) or "(empty)"


@contextlib.contextmanager
def _held(owner):
    """Put back, on exit, what a run changes in `owner` (a network, or a
    trainer whose ``.net`` is held with it; None holds nothing): every
    attribute is rebound to what it was, a tensor attribute gets its
    values back, and a network's step state (params, updater and layer
    state, written in place) is restored from a snapshot. Tensors nested
    in other containers are put back by reference only."""
    import torch

    saved = []
    net = getattr(owner, "net", None)
    for x in (owner, net if net is not owner else None):
        if x is None:
            continue
        attrs = dict(vars(x))
        with torch.no_grad():
            values = {k: v.detach().clone() for k, v in attrs.items()
                      if isinstance(v, torch.Tensor)}
        snap = x._snapshot() if hasattr(x, "_step_state") else None
        saved.append((x, attrs, values, snap))
    try:
        yield
    finally:
        for x, attrs, values, snap in saved:
            vars(x).clear()
            vars(x).update(attrs)
            with torch.no_grad():
                for k, v in values.items():
                    attrs[k].copy_(v)
            if snap is not None:
                x._restore(snap)


def collective_signature(fn, *args, execute=False):
    """Run `fn(*args)` once under a recording and return its ordered
    signature. With ``execute=False`` (default) nothing communicates:
    each collective returns this rank's own values, so the run computes
    a one-rank step on this rank's data. It must leave no trace, or the
    replicas would drift apart: where `fn` is a bound method (a
    trainer's ``fit``), its owner's state is put back after the run
    (``_held``)."""
    from deeplearning4j_tpu_torch.parallel import collectives as _coll

    owner = None if execute else getattr(fn, "__self__", None)
    with _held(owner), _coll.recording(execute=execute) as rec:
        fn(*args)
    return CollectiveSignature(rec.sites)


def collective_counts(fn, *args):
    """{op: call count} of one run of `fn(*args)` (record-only)."""
    return collective_signature(fn, *args).counts()


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------

def check_signature(sig, mesh_axes=None, subject=""):
    """COL02 (an axis the mesh lacks) and COL06 (a malformed ring) over
    one signature. Returns a Report."""
    report = Report(subject=subject or "collectives")
    axes = set(mesh_axes) if mesh_axes is not None else None
    for site in sig:
        if axes is None:
            continue
        for a in site.axes:
            if a not in axes:
                report.add(
                    "COL02", ERROR, site.format(),
                    f"collective {site.op} runs over axis '{a}' but the "
                    f"mesh axes are {sorted(axes)}",
                    hint="run it over the mesh's group (the "
                         "signature-level twin of PAR04)")
        perm = getattr(site, "perm", None)
        if perm is not None:
            report.extend(check_ring(perm, where=site.format()))
    return report


def check_ring(perm, where="ring", subject=""):
    """COL06: a ring given as (source, destination) pairs must be a
    permutation with no self-cycle."""
    report = Report(subject=subject or "ring")
    perm = [tuple(p) for p in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        report.add(
            "COL06", ERROR, where,
            f"ring {tuple(perm)} is not a permutation (duplicate source "
            "or destination): ranks would send and receive mismatched "
            "messages and deadlock",
            hint="each source and each destination may appear at most "
                 "once; build rings as [(j, (j+1) % n) for j in "
                 "range(n)]")
    self_edges = [(s, d) for s, d in perm if s == d]
    if self_edges:
        report.add(
            "COL06", ERROR, where,
            f"ring contains self-cycle(s) {self_edges}: a rank sending "
            "to itself is a no-op link, almost always an off-by-one",
            hint="rotate by (j + 1) % n, not j % n")
    return report


def expected_lane_bits(dp):
    """The bits one packed lane needs: the sum of dp biased int8 lanes
    reaches 254·dp."""
    return (254 * int(dp)).bit_length()


def expected_acc_dtype(dp):
    """The integer word the packed lanes are summed in: int32 while a
    lane fits 31 bits (dp <= 2**31 / 254); None past that."""
    import torch

    return torch.int32 if expected_lane_bits(dp) <= 31 else None


def check_acc_dtype(sig, dp, billed_acc_bytes=None, subject=""):
    """COL03: the int8 accumulator contract at data-parallel degree
    `dp` (module docstring) over one signature's ``int8_lane_sum``
    sites, and the bill's per-lane bytes when given. Returns a
    Report."""
    from deeplearning4j_tpu_torch.parallel import collectives as _coll

    report = Report(subject=subject or f"acc@dp{dp}")
    bits = expected_lane_bits(dp)
    if bits > 31:
        report.add("COL03", ERROR, "analyzer",
                   f"the sum of {dp} int8 lanes needs {bits} bits: no "
                   "lane fits an int32 word", hint="dp must stay below "
                   "2**31 / 254")
        return report
    runtime = _coll.lane_bits(int(dp))
    if runtime != bits:
        report.add(
            "COL03", ERROR, "parallel.collectives.lane_bits",
            f"the lane packing gives a lane {runtime} bits at dp={dp}; "
            f"254*{dp} = {254 * int(dp)} needs exactly {bits}",
            hint="lanes narrower overflow into their neighbours; wider "
                 "ones waste the wire")
    k = 31 // bits
    for s in sig:
        if s.op == "int8_lane_scatter":
            # rows bound for each of the group's ranks, packed apart; the
            # lanes sum over this site's group (hop 1: the node group)
            ks = 31 // expected_lane_bits(s.size)
            want = s.size * -(-(int(s.lanes) // s.size) // ks)
            if s.dtype != "int32" or s.count != want:
                report.add(
                    "COL03", ERROR, s.format(),
                    f"int8_lane_scatter sent {s.count} {s.dtype} word(s) "
                    f"for {s.lanes} lanes over {s.size} ranks; the "
                    f"contract packs each rank's row {ks} lanes an int32 "
                    f"word: {want} words",
                    hint="route the exchange through "
                         "parallel.collectives.int8_lane_scatter")
            continue
        if s.op != "int8_lane_sum":
            continue
        want = -(-int(s.lanes) // k)
        if s.dtype != "int32" or s.count != want:
            report.add(
                "COL03", ERROR, s.format(),
                f"int8_lane_sum sent {s.count} {s.dtype} word(s) for "
                f"{s.lanes} lanes at dp={dp}; the contract packs {k} "
                f"lanes of {bits} bits an int32 word: {want} words",
                hint="route the exchange through "
                     "parallel.collectives.int8_lane_sum")
    if billed_acc_bytes is not None \
            and abs(float(billed_acc_bytes) - 4.0 / k) > 1e-9:
        report.add(
            "COL03", ERROR, "byte bill",
            f"the bill charges {billed_acc_bytes} B a lane at dp={dp}; "
            f"the packing sends 4/{k} = {4.0 / k:.4f} B: analyzer, bill "
            "and packing disagree",
            hint="bill with port_wire_bill, which derives the lane "
                 "width from lane_bits")
    return report


def check_bill(measured_bytes, analytic_bytes, rel=0.10, where="",
               subject=""):
    """COL05: measured collective bytes against an analytic bill;
    divergence beyond `rel` is an error."""
    report = Report(subject=subject or "collective-bill")
    measured = float(measured_bytes)
    analytic = float(analytic_bytes)
    if analytic <= 0:
        if measured > 0:
            report.add("COL05", ERROR, where or "bill",
                       f"analytic bill is 0 B but {int(measured)} B of "
                       "collective traffic was measured")
        return report
    drift = abs(measured - analytic) / analytic
    if drift > float(rel):
        report.add(
            "COL05", ERROR, where or "bill",
            f"measured collective bytes {int(measured)} diverge "
            f"{drift:.1%} from the analytic bill {int(analytic)} "
            f"(gate: {float(rel):.0%})",
            hint="either the exchange changed or the bill is stale — "
                 "they must move together")
    return report


def port_wire_bill(mode, leaf_sizes, dp, block=None, capacity=None,
                   sharded=False, min_shard_size=2 ** 16, group_size=None,
                   intra_mode="block_int8"):
    """Analytic wire bytes one rank sends for ONE gradient exchange in
    the port's wire format (ring convention, ``collectives.wire_bytes``):

      dense       all-reduce of the f32 gradients
      int8        all-reduce of one f32 scale a leaf (max) and of the
                  packed lanes: ceil(N / k) int32 words, k = 31 //
                  lane_bits(dp)
      block_int8  as int8, a scale a block, each leaf padded to whole
                  blocks
      threshold   all-gather of one int32 code a transmitted element,
                  threshold_cap(n, capacity) a leaf
      hierarchical  over node groups of g (``group_size``) ranks, n_i
                  padded to g·s_i: hop 1 a reduce-scatter inside the
                  group of the f32 leaves (dense) or of their packed
                  lanes (rows of ceil(sum s_i / k_g) words) after a max
                  all-reduce of their block scales; hop 2 the threshold
                  codes of the blocks (threshold_cap(s_i)) all-gathered
                  over the dp/g groups; hop 3 the f32 blocks all-gathered
                  inside the group

    ``sharded=True`` (dense, int8, block_int8: the ZeRO update) bills the
    eligible leaves (n >= min_shard_size, n % dp == 0) as a
    reduce-scatter of the f32 gradients (or the max all-reduce of their
    scales and the reduce-scatter of rows of ceil(E / dp / k) lane
    words) plus the all-gather of the f32 param blocks, and the other
    leaves as the replicated mode does: dense, the first two terms are
    ``sharding.dp_weight_update_bytes``'s ``collective_wire_bytes``.
    """
    from deeplearning4j_tpu_torch.ndarray.compression import threshold_cap
    from deeplearning4j_tpu_torch.parallel import collectives as _coll
    from deeplearning4j_tpu_torch.parallel.sharding import (
        DEFAULT_COMPRESSION_BLOCK, DEFAULT_ENCODING_CAPACITY,
        default_compression_group, hierarchical_shard_elems,
    )

    sizes = [int(n) for n in leaf_sizes]
    dp = int(dp)
    b = DEFAULT_COMPRESSION_BLOCK if block is None else int(block)
    cap = DEFAULT_ENCODING_CAPACITY if capacity is None else float(capacity)

    def scales(leaves, mode):
        if mode == "int8":
            return len(leaves)
        return sum(-(-n // b) for n in leaves)

    if sharded:
        if mode not in (None, "int8", "block_int8"):
            raise ValueError(f"the sharded weight update does not compose "
                             f"with gradient_compression {mode!r}")
        elig = [n for n in sizes if n >= min_shard_size and n % dp == 0]
        rest = [n for n in sizes if not (n >= min_shard_size
                                         and n % dp == 0)]
        E = sum(elig)
        wire = _coll.wire_bytes("all_gather", 4 * E // dp, dp) if E else 0
        if E and mode is None:
            wire += _coll.wire_bytes("reduce_scatter", 4 * E, dp)
        elif E:
            k = 31 // _coll.lane_bits(dp)
            words = dp * -(-(E // dp) // k)
            wire += _coll.wire_bytes("all_reduce", 4 * scales(elig, mode),
                                     dp) \
                + _coll.wire_bytes("reduce_scatter", 4 * words, dp)
        return wire + (port_wire_bill(mode, rest, dp, block, capacity)
                       if rest else 0)
    if mode is None:
        return _coll.wire_bytes("all_reduce", 4 * sum(sizes), dp)
    if mode in ("int8", "block_int8"):
        k = 31 // _coll.lane_bits(dp)
        if mode == "int8":
            lanes = sum(sizes)
        else:
            lanes = b * scales(sizes, mode)
        words = -(-lanes // k)
        return _coll.wire_bytes("all_reduce", 4 * scales(sizes, mode), dp) \
            + _coll.wire_bytes("all_reduce", 4 * words, dp)
    if mode == "threshold":
        codes = sum(threshold_cap(n, cap) for n in sizes)
        return _coll.wire_bytes("all_gather", 4 * codes, dp)
    if mode == "hierarchical":
        g = default_compression_group(dp) if group_size is None \
            else int(group_size)
        ns = [hierarchical_shard_elems(n, g) for n in sizes]
        S = sum(ns)
        if intra_mode == "block_int8":
            k = 31 // _coll.lane_bits(g)
            hop1 = _coll.wire_bytes(
                "all_reduce", 4 * sum(-(-g * s // b) for s in ns), g) \
                + _coll.wire_bytes("reduce_scatter", 4 * g * -(-S // k), g)
        else:
            hop1 = _coll.wire_bytes("reduce_scatter", 4 * g * S, g)
        codes = sum(threshold_cap(s, cap) for s in ns)
        return hop1 + _coll.wire_bytes("all_gather", 4 * codes, dp // g) \
            + _coll.wire_bytes("all_gather", 4 * S, g)
    raise ValueError(f"no port wire format for gradient_compression "
                     f"{mode!r}")


# ----------------------------------------------------------------------
# contracts (COL04)
# ----------------------------------------------------------------------

class CollectiveContract:
    """A parallel mode's expected collective signature, declared once.

    `counts` maps op -> expected call count: an int for an exact bound
    or a (min, max) tuple (max None = unbounded). `axes`, when given,
    is the set of mesh axes every site must run over. Ops not named in
    `counts` are drift (COL04)."""

    def __init__(self, name, counts, axes=None, description="",
                 expects_quantized=False):
        self.name = str(name)
        self.counts = dict(counts)
        self.axes = None if axes is None else frozenset(axes)
        self.description = str(description)
        #: the mode's gradient sum must travel as packed int8 lanes: a
        #: signature with no int8_lane_sum site is COL03
        self.expects_quantized = bool(expects_quantized)

    def _bounds(self, want):
        if isinstance(want, tuple):
            lo, hi = want
            return int(lo), (None if hi is None else int(hi))
        return int(want), int(want)

    def check(self, sig_or_counts, subject=""):
        """COL04 drift report of an observed signature (or a bare
        {op: count} dict) against this declaration."""
        report = Report(subject=subject or f"contract:{self.name}")
        if isinstance(sig_or_counts, CollectiveSignature):
            got = sig_or_counts.counts()
            axes = sig_or_counts.axes()
        else:
            got = dict(sig_or_counts)
            axes = None
        for op, want in self.counts.items():
            lo, hi = self._bounds(want)
            n = got.get(op, 0)
            if n < lo or (hi is not None and n > hi):
                bound = f"{lo}" if hi == lo else \
                    f"[{lo}, {'∞' if hi is None else hi}]"
                report.add(
                    "COL04", ERROR, f"{self.name}:{op}",
                    f"declared {bound} {op} call(s), the recorded "
                    f"signature has {n}: the communication shape "
                    "drifted from the mode's contract",
                    hint=self.description or
                    "update the contract only if the new shape is "
                    "intended")
        for op, n in got.items():
            if op not in self.counts and n:
                report.add(
                    "COL04", ERROR, f"{self.name}:{op}",
                    f"the step makes {n} undeclared {op} call(s): "
                    "communication the contract never admitted",
                    hint="declare it in the contract or remove the "
                         "collective")
        if self.axes is not None and axes is not None:
            extra = axes - self.axes
            if extra:
                report.add(
                    "COL04", ERROR, self.name,
                    f"the step runs over axes {sorted(extra)} the "
                    f"contract restricts to {sorted(self.axes)}")
        return report


def compression_contract(mode, n_leaves=None, axis="data",
                         sync_bn_layers=0, stateful=False,
                         adaptive=False, sharded=False,
                         replicated_leaves=True, group_axis="group",
                         intra_axis="intra", intra_quantized=True):
    """The declared collective contract of one data-parallel step of
    ``ParallelWrapper``/``SharedTrainingMaster`` in gradient_compression
    `mode` (the port packs every leaf into one exchange, so the counts
    do not grow with `n_leaves`, kept for the reference's signature):

      None        all_reduce = 2 + 3·B   the flat gradient mean and the
                                         loss mean; each of B synced
                                         BatchNormalization layers adds
                                         2 forward (mean, variance) and
                                         1 backward
      int8 /      all_reduce = 2 (+1)    the scales (max) and the loss
      block_int8                         mean (+ the layer-state mean
                                         when the net has state)
                  int8_lane_sum = 1      the packed lanes
      threshold   all_gather = 1         every rank's codes
                  all_reduce = 1 (+1)(+1) the loss mean (+ state mean)
                                         (+ the adaptive tau's sent
                                         fraction)
      hierarchical  (over the data, group and intra axes)
                  int8_lane_scatter = 1  hop 1's packed lanes (intra;
                                         reduce_scatter = 1 when dense)
                  all_gather = 2         hop 2's codes (group), hop 3's
                                         fan-back (intra)
                  all_reduce = 2 (+1)(+1) hop 1's block scales (max,
                                         quantized only), the loss mean
                                         (+ state mean) (+ the adaptive
                                         tau's sent fraction)
      sharded     (``sharded=True``, the ZeRO update, one dtype)
        None      reduce_scatter = 1     the eligible gradients
                  all_gather = 1         the fresh param blocks
                  all_reduce = 1 (+1) + 3·B  the loss (+ the
                                         replicated leaves' mean)
        int8 /    int8_lane_scatter = 1  the eligible leaves' lanes
        block_int8 all_gather = 1        the fresh param blocks
                  all_reduce = 2 (+1)    their scales, the loss (+ state)
                  (+ int8_lane_sum = 1, all_reduce +1: the replicated
                  leaves' lanes and scales)
    """
    del n_leaves
    st = 1 if stateful else 0
    if sharded:
        if mode not in (None, "int8", "block_int8"):
            raise ValueError(f"the sharded weight update does not compose "
                             f"with gradient_compression {mode!r}")
        rep = 1 if replicated_leaves else 0
        if mode is None:
            counts = {"reduce_scatter": 1, "all_gather": 1,
                      "all_reduce": 1 + rep + 3 * int(sync_bn_layers)}
        else:
            counts = {"int8_lane_scatter": 1, "all_gather": 1,
                      "all_reduce": 2 + st + rep}
            if rep:
                counts["int8_lane_sum"] = 1
        return CollectiveContract(
            f"{mode or 'dense'}+zero", counts, axes=(axis,),
            description="the ZeRO update: the eligible gradients "
                        "reduce-scattered, the fresh param blocks "
                        "all-gathered; the other leaves replicated; the "
                        "loss mean",
            expects_quantized=mode is not None)
    if mode is None:
        return CollectiveContract(
            "dense", {"all_reduce": 2 + 3 * int(sync_bn_layers)},
            axes=(axis,),
            description="dense data-parallel: one flat gradient "
                        "all-reduce, the loss mean, synced BN")
    if mode in ("int8", "block_int8"):
        return CollectiveContract(
            mode, {"all_reduce": 2 + st, "int8_lane_sum": 1},
            axes=(axis,),
            description="quantized all-reduce: scale max + packed int8 "
                        "lanes + the loss mean",
            expects_quantized=True)
    if mode == "threshold":
        return CollectiveContract(
            "threshold",
            {"all_gather": 1, "all_reduce": 1 + st + (1 if adaptive
                                                       else 0)},
            axes=(axis,),
            description="Strom threshold encoding: one all-gather of "
                        "the codes + the loss mean")
    if mode == "hierarchical":
        counts = {"all_gather": 2, "all_reduce": 1 + st + (1 if adaptive
                                                            else 0)}
        if intra_quantized:
            counts["int8_lane_scatter"] = 1
            counts["all_reduce"] += 1
        else:
            counts["reduce_scatter"] = 1
        return CollectiveContract(
            "hierarchical", counts, axes=(axis, group_axis, intra_axis),
            description="2-hop exchange: the intra reduce-scatter (block "
                        "scales max + packed lanes, or dense), the "
                        "leaders' threshold codes all-gathered over the "
                        "group axis, the intra fan-back all-gather; + the "
                        "loss mean",
            expects_quantized=bool(intra_quantized))
    raise ValueError(
        f"unknown gradient_compression mode {mode!r}; pick one of "
        "(None, 'int8', 'block_int8', 'threshold', 'hierarchical')")


#: the linalg routines' collective calls on a mesh whose axes each have
#: more than one rank (a one-rank group makes none). "hops": a ring of n
#: ranks makes n - 1 ppermutes (the reference's n-th, which returns each
#: panel home, is not made); "iters": lstsq makes one all-reduce a CG
#: iteration after its two setup ones (A^T b, the initial residual).
#: lstsq may gather a column-sharded A (the reference declares no
#: all-gather there; its col-sharded solve would drift from it)
_LINALG_CONTRACTS = {
    "matmul2d": {"all_gather": 1, "ppermute": "hops"},
    "matmul1d": {"ppermute": "hops"},
    "matmul_ta": {"all_reduce": 1, "all_gather": (0, 2)},
    "matmul_tb": {"all_gather": 1},
    "gram": {"all_reduce": 1, "all_gather": (0, 1)},
    "covariance": {"all_reduce": 2, "all_gather": (0, 1)},
    "pairwise_sq_dists": {},
    "lstsq": {"all_reduce": "iters", "all_gather": (0, 1)},
}


def linalg_contract(routine, ring=None, iterations=None):
    """CollectiveContract of one distributed-linalg routine (reference:
    ``linalg_contract``): `ring` (the ring's ranks) pins a SUMMA's
    ppermute count to ring - 1, `iterations` lstsq's all-reduces to 2 +
    iterations; unpinned they are at least 1 and 3."""
    try:
        counts = dict(_LINALG_CONTRACTS[routine])
    except KeyError:
        raise ValueError(
            f"unknown linalg routine {routine!r}; declared: "
            f"{sorted(_LINALG_CONTRACTS)}") from None
    for op, want in counts.items():
        if want == "hops":
            counts[op] = (1, None) if ring is None else int(ring) - 1
        elif want == "iters":
            counts[op] = (3, None) if iterations is None \
                else 2 + int(iterations)
    return CollectiveContract(
        f"linalg.{routine}", counts,
        description="linalg tier communication shape (linalg/); update "
                    "only with the routine")


# ----------------------------------------------------------------------
# COL01 — run time (signatures across ranks) and source (rank branches)
# ----------------------------------------------------------------------

def _gather_signatures(sig, group):
    """Every rank's signature keys (rank order), over the group's
    process group (an object all-gather); [own] at world size 1."""
    import torch.distributed as dist

    keys = sig.keys()
    if group is None or getattr(group, "pg", None) is None:
        return [keys]
    out = [None] * group.size
    dist.all_gather_object(out, keys, group=group.pg)
    return out


def _compare_ranks(report, all_keys):
    base = all_keys[0]
    for r, keys in enumerate(all_keys[1:], start=1):
        if keys == base:
            continue
        n = min(len(keys), len(base))
        i = next((j for j in range(n) if keys[j] != base[j]), n)
        a = base[i] if i < len(base) else "(nothing)"
        b = keys[i] if i < len(keys) else "(nothing)"
        report.add(
            "COL01", ERROR, f"rank {r} vs rank 0, call {i}",
            f"the ranks' collective signatures differ at call {i}: rank "
            f"0 makes {a}, rank {r} makes {b} ({len(base)} vs "
            f"{len(keys)} calls): run together, they deadlock or "
            "exchange mismatched buffers",
            hint="every rank must make the same collectives in the same "
                 "order; hoist rank-dependent work out of the exchange")


def verify_program(fn, *args, mesh=None, group=None, contract=None,
                   dp=None, billed_acc_bytes=None, execute=False,
                   subject=""):
    """Run `fn(*args)` once on this rank under a recording (record-only
    unless `execute`; a record-only run of a bound method puts back its
    owner's state, ``collective_signature``), gather every rank's
    signature over `group` (a ``DataGroup``; every rank must call this
    together) and check:
    COL01 (ranks that differ), COL02 (axes against `mesh`, default the
    group's), COL06, COL03 (with `dp`, for a contract that declares the
    int8 lanes) and COL04 (with a `contract`). Returns the merged
    Report; ``report.signature`` is this rank's signature and
    ``report.rank_signatures`` every rank's keys."""
    from deeplearning4j_tpu_torch.analysis.partitioning import normalize_mesh

    sig = collective_signature(fn, *args, execute=execute)
    if mesh is None and group is not None:
        mesh = group.shape
    axes = set(normalize_mesh(mesh)) if mesh is not None else None
    report = Report(subject=subject or "collectives")
    all_keys = _gather_signatures(sig, group)
    _compare_ranks(report, all_keys)
    report.extend(check_signature(sig, mesh_axes=axes, subject=subject))
    quantized = any(s.op in ("int8_lane_sum", "int8_lane_scatter")
                    for s in sig)
    if contract is not None and contract.expects_quantized:
        if not quantized:
            report.add(
                "COL03", ERROR, contract.name,
                "quantized mode made NO int8_lane_sum: the gradients "
                "crossed the wire unquantized",
                hint="route the exchange through parallel.sharding."
                     "quantized_psum_mean")
        elif dp is not None:
            report.extend(check_acc_dtype(
                sig, dp, billed_acc_bytes=billed_acc_bytes))
    if contract is not None:
        report.extend(contract.check(sig))
    report.signature = sig
    report.rank_signatures = all_keys
    return report


def _rank_names(tree):
    """Names bound (anywhere in the module) from a rank: ``r =
    dist.get_rank()``, ``rank = self.mesh.rank`` and the like."""
    names = {"rank", "local_rank", "global_rank"}
    changed = True
    while changed:
        changed = False
        for n in ast.walk(tree):
            if isinstance(n, ast.Assign) and _mentions_rank(n.value, names):
                for t in n.targets:
                    for m in ast.walk(t):
                        if isinstance(m, ast.Name) and m.id not in names:
                            names.add(m.id)
                            changed = True
    return names


def _mentions_rank(expr, names):
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in names:
            return True
        if isinstance(n, ast.Attribute) and (n.attr in names
                                             or n.attr == "get_rank"):
            return True
    return False


def _callee(node):
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def lint_collective_source(source, path="<string>"):
    """COL01's source twin: a collective call under an ``if``/``while``
    or a conditional expression whose test reads a rank. Returns a
    Report."""
    report = Report(subject=f"collectives:{path}")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.add("LNT00", ERROR, f"{path}:{e.lineno or 0}",
                   f"file does not parse: {e.msg}")
        return report
    names = _rank_names(tree)
    seen = set()
    lines = source.splitlines()

    def flag(call, test):
        key = (call.lineno, call.col_offset)
        if key in seen:
            return
        seen.add(key)
        text = lines[call.lineno - 1] if call.lineno <= len(lines) else ""
        m = _SUPPRESS_RE.search(text)
        codes = {c.strip() for c in m.group("codes").split(",")} if m \
            else set()
        report.add(
            "COL01", ERROR, f"{path}:{call.lineno}:{call.col_offset}",
            f"collective {_callee(call)}() under a branch on the rank "
            f"(line {test.lineno}): ranks taking different sides make "
            "different collectives and deadlock",
            hint="make the collective on every rank and branch on its "
                 "result instead",
            suppressed="*" in codes or "COL01" in codes)

    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                and _mentions_rank(node.test, names):
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) \
                else [node.orelse]
            for st in body + orelse:
                for n in ast.walk(st):
                    if isinstance(n, ast.Call) \
                            and _callee(n) in _COLLECTIVE_CALLS:
                        flag(n, node.test)
    return report


def lint_collective_paths(paths=None):
    """COL01's source twin over files/directories (default: the port's
    ``parallel`` and ``linalg`` packages and ``ops/norm.py``) -> merged
    Report."""
    import os

    from deeplearning4j_tpu_torch.analysis.purity import iter_py_files

    if paths is None:
        import deeplearning4j_tpu_torch as pkg

        base = os.path.dirname(os.path.abspath(pkg.__file__))
        paths = [os.path.join(base, "parallel"),
                 os.path.join(base, "linalg"),
                 os.path.join(base, "ops", "norm.py")]
    report = Report(subject="collectives")
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            report.add("LNT00", ERROR, path, f"unreadable: {e}")
            continue
        report.extend(lint_collective_source(src, path))
    return report
