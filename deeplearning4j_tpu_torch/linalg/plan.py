"""Static validation and per-rank byte bills for distributed linalg plans.

The counterpart of ``deeplearning4j_tpu/linalg/plan.py`` (a copy: the port
imports nothing of the reference). Each canonical block plan (SUMMA GEMM,
tall Gram, randomized SVD, CG least squares) gets

  * PAR01/PAR03: axes exist, no axis reused, every sharded dimension
    divides its axis (the never-pad contract ``DistributedMatrix``
    enforces at placement),
  * PAR04: ``analysis.partitioning.check_collectives`` (the axis names
    the sources hand to collectives) and the collective source lint
    (``analysis.collectives.lint_collective_source``: no collective under
    a branch on the rank) over the port's ``linalg/`` sources,
  * PAR06: a per-rank byte bill of what the port's block programs hold at
    their peak, against a memory budget (default: the visible card's
    memory; with no card and no budget the bill is reported and never
    fails).

What the bills count (each rank; R, C the row and column axis sizes):

  * a one-rank group's gather is a view, so nothing is billed for it;
  * ``collectives.all_gather`` fills one buffer a rank and stacks them,
    and a column gather then reorders the stack: a gather holds two
    copies of the gathered panel for a moment (``gather_peak``);
  * ``collectives.ppermute`` receives each hop into a fresh buffer while
    the sender's is still held: the ring holds the operand's own block
    plus up to two moving blocks (one at C = 2); the port makes C - 1
    hops (the reference's C-th returns each panel home);
  * the GEMM accumulates in place (``addmm_``): one output block;
  * rsvd holds two sketch blocks (CholeskyQR's input and output), and pca
    its centred block as well (``center=True``);
  * lstsq holds the rhs rows, the matvec's [n/R, m] intermediate and the
    CG state (x, r, p, S p, A^T b and one temporary: 6 d m).

cuBLAS's workspace and the allocator's rounding are not billed.

CLI: ``python -m deeplearning4j_tpu_torch.analysis --linalg`` validates the
canonical plans on the dp4xtp2 mesh (exit 0/1/2 like every subject).
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, WARNING, Report
from deeplearning4j_tpu_torch.analysis.partitioning import (
    _mesh_tag, check_collectives, normalize_mesh,
)

__all__ = ["matmul_plan", "gram_plan", "rsvd_plan", "lstsq_plan",
           "CANONICAL_LINALG_PLANS", "validate_linalg_plan"]

#: the mesh the canonical plans target (the trainers' dp4xtp2)
CANONICAL_LINALG_MESH = {"data": 4, "model": 2}

#: canonical block plans, the reference's at the reference's widths: a
#: square 2-D SUMMA GEMM and the tall-skinny family (Gram / randomized
#: SVD / CG least squares) on a 2^23 x 1024 f32 data matrix (34.4 GB)
CANONICAL_LINALG_PLANS = (
    {"name": "gemm_32k", "op": "matmul",
     "m": 32768, "k": 32768, "n": 32768},
    {"name": "gram_tall", "op": "gram", "n": 2 ** 23, "d": 1024},
    {"name": "rsvd_tall", "op": "rsvd", "n": 2 ** 23, "d": 1024,
     "rank": 64, "oversample": 8},
    {"name": "lstsq_tall", "op": "lstsq", "n": 2 ** 23, "d": 1024},
)


def _axes_sizes(axes, row_axis, col_axis):
    r = int(axes[row_axis]) if row_axis is not None else 1
    c = int(axes[col_axis]) if col_axis is not None else 1
    return r, c


def _ring_wire(size, payload):
    """An all-reduce's wire bytes a rank (the ring convention of
    ``collectives.wire_bytes``)."""
    return 2 * (size - 1) * payload // size


def _col_gather(n_rows, d, r, c, dtype_bytes):
    """(resident panel, peak) of gathering a [n/R, d/C] block's columns."""
    if c == 1:
        return 0, 0
    panel = (n_rows // r) * d * dtype_bytes
    return panel, 2 * panel


def matmul_plan(m, k, n, axes, row_axis="data", col_axis="model",
                dtype_bytes=4):
    """Per-rank bill of C[m,n] = A[m,k] @ B[k,n] under the SUMMA block
    programs (distributed._summa_2d / _summa_1d). 2-D (col_axis set): B's
    k-blocks gathered over the row axis once (a k x n/C panel) and A's
    blocks make C-1 hops; 1-D: B's blocks make R-1 hops."""
    r, c = _axes_sizes(axes, row_axis, col_axis)
    a_block = m * k // (r * c) * dtype_bytes
    b_block = k * n // (r * c) * dtype_bytes
    out_block = m * n // (r * c) * dtype_bytes
    if col_axis is not None:
        hops, moving = c - 1, a_block
        gathered = k * (n // c) * dtype_bytes if r > 1 else 0
        gather_wire = (r - 1) * (k // r) * (n // c) * dtype_bytes
    else:
        hops, moving = r - 1, b_block
        gathered = gather_wire = 0
    ring = min(hops, 2) * moving
    loop = gathered + out_block + ring
    return {
        "op": "matmul", "global_bytes": (m * k + k * n + m * n)
                                        * dtype_bytes,
        "a_block_bytes": a_block, "b_block_bytes": b_block,
        "gathered_panel_bytes": gathered, "out_block_bytes": out_block,
        "ring_buffer_bytes": ring, "hops": hops,
        "per_chip_bytes": a_block + b_block + max(2 * gathered, loop),
        "ring_wire_bytes": hops * moving, "gather_wire_bytes": gather_wire,
        "collectives": (("all_gather", "ppermute") if col_axis
                        else ("ppermute",)),
    }


def gram_plan(n, d, axes, row_axis="data", col_axis=None, dtype_bytes=4):
    """A^T A for a row-sharded tall A[n, d]: one all-reduce of the d x d
    partial; the replicated output is billed once a rank."""
    r, c = _axes_sizes(axes, row_axis, col_axis)
    a_block = n * d // (r * c) * dtype_bytes
    gathered, peak = _col_gather(n, d, r, c, dtype_bytes)
    out = d * d * dtype_bytes
    return {
        "op": "gram", "global_bytes": n * d * dtype_bytes,
        "a_block_bytes": a_block, "gathered_panel_bytes": gathered,
        "out_block_bytes": out,
        "per_chip_bytes": a_block + max(peak, gathered + out),
        "ring_wire_bytes": _ring_wire(r, out),
        "gather_wire_bytes": (c - 1) * a_block,
        "collectives": ("all_reduce",) + (("all_gather",) if c > 1 else ()),
    }


def rsvd_plan(n, d, rank, axes, oversample=8, row_axis="data",
              col_axis=None, dtype_bytes=4, n_iter=4, center=False):
    """Randomized SVD of row-sharded A[n, d] at rank `rank`: A's block,
    two row-sharded sketch blocks [n/R, l] and the replicated small
    factors (Omega / Z / B: 3 d l, the Gram l l); `center` (pca) adds the
    centred block. ``wire_bytes`` counts every all-reduce of the run."""
    r, c = _axes_sizes(axes, row_axis, col_axis)
    l_ = min(rank + oversample, min(n, d))
    a_block = n * d // (r * c) * dtype_bytes
    gathered, peak = _col_gather(n, d, r, c, dtype_bytes)
    held = (n // r) * d * dtype_bytes if center else 0
    sketch = 2 * (n // r) * l_ * dtype_bytes
    factors = (3 * d * l_ + l_ * l_) * dtype_bytes
    grams = 2 * (1 + n_iter)
    payload = (grams * l_ * l_ + (n_iter + 1) * d * l_
               + (d if center else 0)) * dtype_bytes
    return {
        "op": "rsvd", "global_bytes": n * d * dtype_bytes,
        "a_block_bytes": a_block, "gathered_panel_bytes": gathered,
        "centred_block_bytes": held, "sketch_block_bytes": sketch,
        "out_block_bytes": factors,
        "per_chip_bytes": a_block + max(peak, gathered + held + sketch
                                        + factors),
        "ring_wire_bytes": _ring_wire(r, d * l_ * dtype_bytes),
        "wire_bytes": _ring_wire(r, payload),
        "gather_wire_bytes": (c - 1) * a_block,
        "collectives": ("all_reduce",) + (("all_gather",) if c > 1 else ()),
    }


def lstsq_plan(n, d, axes, row_axis="data", col_axis=None, dtype_bytes=4,
               n_rhs=1):
    """Normal-equation CG for row-sharded A[n, d] and `n_rhs` right-hand
    sides: A's block, the rhs rows and the matvec's intermediate (each
    [n/R, n_rhs]) and the replicated CG state (6 d n_rhs); matrix-free,
    A^T A never materialises. Wire: two setup all-reduces, one an
    iteration."""
    r, c = _axes_sizes(axes, row_axis, col_axis)
    a_block = n * d // (r * c) * dtype_bytes
    gathered, peak = _col_gather(n, d, r, c, dtype_bytes)
    rhs = (n // r) * n_rhs * dtype_bytes
    state = 6 * d * n_rhs * dtype_bytes
    vec = d * n_rhs * dtype_bytes
    return {
        "op": "lstsq", "global_bytes": (n * d + n * n_rhs) * dtype_bytes,
        "a_block_bytes": a_block, "gathered_panel_bytes": gathered,
        "rhs_block_bytes": rhs, "matvec_temp_bytes": rhs,
        "out_block_bytes": state,
        # the rhs rows stay; the loop adds the matvec's intermediate
        "per_chip_bytes": a_block + rhs + max(peak, gathered + rhs + state),
        "ring_wire_bytes_per_iter": _ring_wire(r, vec),
        "setup_wire_bytes": 2 * _ring_wire(r, vec),
        "gather_wire_bytes": (c - 1) * a_block,
        "collectives": ("all_reduce",) + (("all_gather",) if c > 1 else ()),
    }


def _bill(plan, axes, dtype_bytes):
    op = plan["op"]
    if op == "matmul":
        return matmul_plan(plan["m"], plan["k"], plan["n"], axes,
                           row_axis=plan.get("row_axis", "data"),
                           col_axis=plan.get("col_axis", "model"),
                           dtype_bytes=dtype_bytes)
    row = plan.get("row_axis", "data")
    col = plan.get("col_axis")
    if op == "gram":
        return gram_plan(plan["n"], plan["d"], axes, row_axis=row,
                         col_axis=col, dtype_bytes=dtype_bytes)
    if op == "rsvd":
        return rsvd_plan(plan["n"], plan["d"], plan["rank"], axes,
                         oversample=plan.get("oversample", 8),
                         row_axis=row, col_axis=col,
                         dtype_bytes=dtype_bytes,
                         n_iter=plan.get("n_iter", 4),
                         center=plan.get("center", False))
    if op == "lstsq":
        return lstsq_plan(plan["n"], plan["d"], axes, row_axis=row,
                          col_axis=col, dtype_bytes=dtype_bytes,
                          n_rhs=plan.get("n_rhs", 1))
    raise ValueError(f"unknown linalg plan op {op!r}")


def _plan_dims(plan):
    """(dim, role, axis) triples the never-pad contract checks."""
    op = plan["op"]
    row = plan.get("row_axis", "data")
    col = plan.get("col_axis", "model" if op == "matmul" else None)
    if op == "matmul":
        return [(plan["m"], "m (rows of A)", row),
                (plan["k"], "k (contraction)", row),
                (plan["k"], "k (contraction)", col),
                (plan["n"], "n (cols of B)", col)]
    return [(plan["n"], "n (rows)", row), (plan["d"], "d (cols)", col)]


def _default_budget():
    """The visible card's memory in GB, or None with no card."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 1e9
    return None


def _check_sources(report, axes):
    from deeplearning4j_tpu_torch.analysis.collectives import \
        lint_collective_source

    base = os.path.dirname(os.path.abspath(__file__))
    for fname in ("distributed.py", "solvers.py", "randomized.py"):
        path = os.path.join(base, fname)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        report.extend(check_collectives(src, axes, path=path))
        report.extend(lint_collective_source(src, path))


def validate_linalg_plan(mesh, plans=None, hbm_gb=None, dtype_bytes=4,
                         check_sources=True):
    """Static pre-flight of distributed-linalg block plans on one mesh:
    PAR01 (axes exist), PAR03 (never-pad divisibility), PAR04 (the
    collective lints over the linalg sources), PAR06 (the per-rank bill
    against `hbm_gb`, default the visible card's memory). Returns a
    Report; ``report.plan`` carries the per-plan byte bills."""
    axes = normalize_mesh(mesh)
    plans = CANONICAL_LINALG_PLANS if plans is None else plans
    if hbm_gb is None:
        hbm_gb = _default_budget()
    report = Report(subject=f"linalg @ {_mesh_tag(axes)}")
    bills = {}

    for plan in plans:
        name = plan.get("name", plan["op"])
        where = f"linalg plan '{name}'"
        usable = True
        # axis reuse: placement refuses row_axis == col_axis, and the
        # bill would count the shared axis twice (r*c)
        row = plan.get("row_axis", "data")
        col = plan.get("col_axis",
                       "model" if plan["op"] == "matmul" else None)
        if col is not None and row == col:
            report.add("PAR01", ERROR, where,
                       f"row_axis and col_axis are both '{row}': a "
                       "mesh axis can shard at most one dim",
                       hint="pick distinct axes or drop col_axis")
            continue
        for dim, role, axis in _plan_dims(plan):
            if axis is None:
                continue
            if axis not in axes:
                report.add("PAR01", ERROR, where,
                           f"plan shards {role} over mesh axis '{axis}' "
                           f"but the mesh axes are {sorted(axes)}",
                           hint="fix the axis name or add the axis to "
                                "build_mesh(...)")
                usable = False
                continue
            if dim % axes[axis] != 0:
                report.add("PAR03", ERROR, where,
                           f"{role} = {dim} is not divisible by mesh "
                           f"axis '{axis}' (size {axes[axis]}): "
                           "DistributedMatrix refuses to silently pad",
                           hint=f"use a multiple of {axes[axis]} or "
                                "replicate that dim")
                usable = False
        if not usable:
            continue
        bill = _bill(plan, axes, dtype_bytes)
        bills[name] = bill
        if hbm_gb is not None:
            budget = float(hbm_gb) * 1e9
            used = bill["per_chip_bytes"]
            detail = (f"block {bill['a_block_bytes'] / 1e9:.3f} GB + "
                      f"gathered {bill['gathered_panel_bytes'] / 1e9:.3f}"
                      f" GB + out {bill['out_block_bytes'] / 1e9:.3f} GB"
                      f"; global operand "
                      f"{bill['global_bytes'] / 1e9:.3f} GB")
            if used > budget:
                report.add(
                    "PAR06", ERROR, f"{where} @ {_mesh_tag(axes)}",
                    f"predicted per-chip bytes {used / 1e9:.3f} GB "
                    f"exceed the {float(hbm_gb):g} GB budget ({detail})",
                    hint="shard over more axes, shrink the block, or "
                         "stream panels")
            elif used > 0.9 * budget:
                report.add(
                    "PAR06", WARNING, f"{where} @ {_mesh_tag(axes)}",
                    f"predicted per-chip bytes {used / 1e9:.3f} GB are "
                    f"within 10% of the {float(hbm_gb):g} GB budget "
                    f"({detail})",
                    hint="the allocator's rounding and cuBLAS's workspace "
                         "can push a >90% fit over the edge")

    if check_sources:
        _check_sources(report, axes)
    report.plan = {"mesh": dict(axes), "bills": bills,
                   "dtype_bytes": int(dtype_bytes)}
    return report


def per_chip_parity(dm):
    """Cross-check helper: the static bill's block bytes for one placed
    DistributedMatrix; must equal ``dm.per_chip_bytes()`` exactly."""
    axes = dict(dm.mesh.shape)
    r, c = _axes_sizes(axes, dm.row_axis, dm.col_axis)
    return int(np.prod(dm.shape)) // (r * c) * dm.tensor().element_size()
