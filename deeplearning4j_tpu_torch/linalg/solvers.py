"""Matrix-free conjugate-gradient and least-squares solvers.

The counterpart of ``deeplearning4j_tpu/linalg/solvers.py``:

  * ``cg``     solve S x = b for any SPD matvec; b and x are a tensor, a
               list or tuple of tensors, or a dict of them
               (``nn.solvers``' truncated-Newton step solves through it)
  * ``lstsq``  min ||A x - b||^2 (+ l2 ridge) by the normal equations
               with A a row-sharded ``DistributedMatrix``: the A^T (A x)
               matvec reduces over the sharded row axis with one
               all-reduce an iteration
  * ``CGResult`` carries the iterations, the final residual norm and a
               converged flag, so a solve that ran out of iterations says
               so.

The reference's ``lax.while_loop`` becomes a Python loop whose test is
read on the host each iteration (as the port's other loops do). In a
distributed solve every scalar the test reads (||r||^2, p'Sp) is computed
from all-reduced vectors, identical bit for bit on every rank, so every
rank stops at the same iteration; ``analysis.collectives.verify_program``
run with ``execute=True`` compares the ranks' signatures (one all-reduce
an iteration), so a rank that stopped early would show (COL01).

Stated deviation: the loop also stops, keeping the iterate so far, at a
direction p with p'Sp <= 0, which an SPD operator never gives; the
reference divides through it (the truncated-Newton rule the port's
Newton-CG step needs on an indefinite Hessian).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

from deeplearning4j_tpu_torch.linalg.distributed import (
    _as_tensor, _check_divisible, _entry, _gather_cols, _group, _local,
    _row_product, _run, _size, _sum,
)

__all__ = ["CGResult", "cg", "lstsq"]


class CGResult(NamedTuple):
    """Solution and convergence diagnostics of one CG solve."""

    x: Any
    iterations: int        # matvecs spent in the loop
    residual_norm: float   # ||b - S x|| at exit (the recurrence's)
    converged: bool        # tolerance reached before maxiter


def _vdot(a, b):
    """Sum over the leaves of a . b (a 0-d tensor)."""
    return sum(ai.reshape(-1).dot(bi.reshape(-1)) for ai, bi in zip(a, b))


def _axpy(alpha, x, y):
    """y + alpha * x, leafwise, keeping y's dtypes."""
    return [(yi + alpha * xi).to(yi.dtype) for xi, yi in zip(x, y)]


def _flat(tree):
    """-> (leaves, rebuild) for a tensor, a list/tuple or a dict."""
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda xs: kind(xs)
    return [tree], lambda xs: xs[0]


def cg(matvec, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Conjugate gradients for S x = b, S symmetric positive
    (semi-)definite, given only the matvec; `M` is an optional
    preconditioner matvec (approximates S^-1). Stops when ||r|| <=
    max(tol * ||b||, atol) or at maxiter, as ``CGResult.converged`` says,
    or at a direction of non-positive curvature (module docstring)."""
    leaves, rebuild = _flat(b)
    if maxiter is None:
        maxiter = sum(t.numel() for t in leaves) or 1
    maxiter = int(maxiter)
    if maxiter < 1:
        raise ValueError(f"maxiter must be >= 1, got {maxiter}")

    def mv(xs):
        return _flat(matvec(rebuild(xs)))[0]

    precond = (lambda v: v) if M is None else \
        (lambda v: _flat(M(rebuild(v)))[0])
    x = [t.new_zeros(t.shape) for t in leaves] if x0 is None \
        else _flat(x0)[0]
    b_norm = math.sqrt(float(_vdot(leaves, leaves)))
    thresh2 = max(tol * b_norm, atol) ** 2
    r = [bi - mi for bi, mi in zip(leaves, mv(x))]
    z = precond(r)
    p = z
    gamma = _vdot(r, z)
    rr = float(_vdot(r, r))
    k = 0
    while rr > thresh2 and k < maxiter:
        mp = mv(p)
        curv = _vdot(p, mp)
        if float(curv) <= 0:
            break
        alpha = gamma / curv
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, mp, r)
        z = precond(r)
        gamma_new = _vdot(r, z)
        beta = gamma_new / gamma
        p = [(zi + beta * pi).to(pi.dtype) for zi, pi in zip(z, p)]
        gamma = gamma_new
        rr = float(_vdot(r, r))
        k += 1
    return CGResult(rebuild(x), k, math.sqrt(rr), rr <= thresh2)


# ----------------------------------------------------------------------
# distributed least squares
# ----------------------------------------------------------------------

def _lstsq_step(mesh, r, c, l2, tol, maxiter):
    """The ONE builder behind the "lstsq" entry (shared by lstsq and
    precompile): the whole normal-equation CG solve on each rank. al [n/R,
    k(/C)] is this rank's block, bl [n/R, m] its rows of the rhs; x is
    replicated (every reduction is an all-reduce, so the iterates agree
    bit for bit). One all-reduce an iteration plus two for the setup."""
    rows, cols = _group(mesh, r), _group(mesh, c)
    l2, tol, maxiter = float(l2), float(tol), int(maxiter)

    def body(al, bl):
        af = _gather_cols(al, cols)

        def normal_matvec(xs):
            x = xs[0]
            s = _sum(_row_product(af, af @ x), rows)
            return [(s + l2 * x).to(x.dtype) if l2 else s]

        atb = _sum(_row_product(af, bl), rows)
        return cg(normal_matvec, [atb], tol=tol, maxiter=maxiter)

    return _entry("lstsq", mesh, (r, c, l2, tol, maxiter), body)


def lstsq(a, b, l2=0.0, *, tol=1e-6, maxiter=None):
    """min_x ||A x - b||^2 + l2 ||x||^2 for a row-sharded (optionally
    also column-sharded) DistributedMatrix A [n, k] and a global rhs b [n]
    or [n, m] (numpy, INDArray or tensor; its rows are placed over A's row
    shards). -> CGResult with x [k(, m)] replicated on every rank.

    Matrix-free: A is only applied, never formed as A^T A; a rank holds
    A's block, its rows of b and k-sized vectors."""
    if a.row_axis is None:
        raise ValueError("lstsq needs a row-sharded DistributedMatrix "
                         "(the normal-equation reduction is over the "
                         "sharded row axis)")
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    bt = _as_tensor(b)
    vector_rhs = bt.dim() == 1
    if vector_rhs:
        bt = bt[:, None]
    if bt.shape[0] != a.shape[0]:
        raise ValueError(f"rhs has {bt.shape[0]} rows, A has "
                         f"{a.shape[0]}")
    _check_divisible(bt.shape[0], r, _size(mesh, r), "rhs row")
    k = a.shape[1]
    maxiter = max(2 * k, 16) if maxiter is None else int(maxiter)
    bl = _local(bt, mesh, r, None, a.device).to(a.dtype)
    res = _run(_lstsq_step(mesh, r, c, l2, tol, maxiter), a.tensor(), bl)
    x = res.x[0][:, 0] if vector_rhs else res.x[0]
    return res._replace(x=x)

