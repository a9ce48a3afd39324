"""Randomized SVD / PCA on row-sharded operands.

The counterpart of ``deeplearning4j_tpu/linalg/randomized.py`` (the
Halko-Martinsson-Tropp range finder). The data matrix stays row-sharded
end to end:

  * the sketch Y = A @ Omega and every subspace-iteration product is a
    local block product,
  * orthonormalisation is CholeskyQR2: two rounds of (Gram all-reduce ->
    local Cholesky -> local triangular solve), shifted so an oversampled
    sketch of a low-rank matrix keeps a finite factor,
  * only l x l / l x d factors are replicated; the final SVD of the
    projected B = Q^T A is a local op on a replicated small matrix.

The sketch Omega is a named draw of a ``util.draws.Draws`` (default: a
``torch.Generator`` on the block's device seeded by `seed`: Philox on the
card). Stated deviation: the reference draws it from its threefry key, so
the same seed gives another sketch; a test hands the reference's Omega in
through ``draws=``. Every rank draws the same Omega from the same seed.

A rank holds its block of A, two sketch blocks [n/R, l] (CholeskyQR's
input and output; the previous iterate is dropped before the next product)
and the small factors; ``pca`` also holds its centred block (the
reference's centring fuses into the factorisation: the port materialises
``A - mean`` once, billed by ``rsvd_plan(center=True)``).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.linalg.distributed import (
    DistributedMatrix, _entry, _gather_cols, _group, _row_product, _run,
    _sum,
)

__all__ = ["rsvd", "pca"]

#: the draw's name (``Draws.normal``)
OMEGA = "linalg.rsvd.omega"


def _cholqr(y, rows):
    """Distributed tall-skinny QR step: the Gram over the sharded rows
    (one all-reduce), then Cholesky and a triangular solve on the
    replicated l x l factor, with the reference's trace-scaled shift.
    Returns Q with y's row sharding."""
    g = _sum(_row_product(y, y), rows)
    fi = torch.finfo(y.dtype)
    shift = fi.eps * g.shape[0] * torch.trace(g) + fi.tiny
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    low, _ = torch.linalg.cholesky_ex(g + shift * eye)
    # q = y @ inv(L)^T: the small factor inverted by a triangular solve,
    # then one product, whose output is the only sketch-sized buffer made
    return y @ torch.linalg.solve_triangular(low, eye, upper=False).T


def _cholqr2(y, rows):
    """CholeskyQR2: a second round repairs the sqrt(cond) orthogonality
    loss of one CholeskyQR in f32. `y` is rebound to the first round's Q,
    so the input is freed before the second round makes its own: two
    sketch blocks at a time, not three."""
    y = _cholqr(y, rows)
    return _cholqr(y, rows)


def _rsvd_body(mesh, r, c, n_iter, k, center, n):
    """The whole randomized SVD on each rank: al [n/R, d(/C)] this rank's
    block, omega [d, l] replicated. Returns (u_local [n/R, k], s [k],
    vt [k, d], mu [d]); s, vt and mu replicated."""
    rows, cols = _group(mesh, r), _group(mesh, c)

    def body(al, omega):
        af = _gather_cols(al, cols)
        if center:
            mu = _sum(af.sum(0), rows) / n
            af = af - mu[None, :]
        else:
            mu = af.new_zeros(af.shape[1])
        y = _cholqr2(af @ omega, rows)
        for _ in range(n_iter):
            z = torch.linalg.qr(_sum(_row_product(af, y), rows)).Q  # [d, l]
            y = None            # drop the old basis before the next one
            y = _cholqr2(af @ z, rows)
        b = _sum(_row_product(y, af), rows)                # [l, d]
        ub, s, vt = torch.linalg.svd(b, full_matrices=False)
        return y @ ub[:, :k], s[:k], vt[:k], mu

    return body


def _draws(draws, seed, device):
    if draws is not None:
        return draws
    from deeplearning4j_tpu_torch.util.draws import Draws

    return Draws(seed, device)


def _rsvd_run(a, k, oversample, n_iter, seed, center, draws):
    if a.row_axis is None:
        raise ValueError("rsvd/pca need a row-sharded DistributedMatrix "
                         "(small factors replicate; rows stay sharded)")
    n, d = a.shape
    k = int(k)
    if not 1 <= k <= min(n, d):
        raise ValueError(f"k={k} outside [1, {min(n, d)}]")
    l_ = min(k + int(oversample), min(n, d))
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    omega = _draws(draws, seed, a.device).normal(OMEGA, (d, l_)) \
        .to(device=a.device, dtype=a.dtype)
    # n is closed over (the centring divisor), so it keys the entry
    step = _entry("pca" if center else "rsvd", mesh,
                  (r, c, k, l_, int(n_iter), bool(center), n),
                  _rsvd_body(mesh, r, c, int(n_iter), k, bool(center), n))
    u, s, vt, mu = _run(step, a.tensor(), omega)
    return DistributedMatrix._placed(u, (n, k), mesh, r), s, vt, mu


def rsvd(a, k, oversample=8, n_iter=4, seed=0, draws=None):
    """Randomized truncated SVD of a row-sharded DistributedMatrix [n, d]:
    A ~= U diag(s) Vt with U [n, k] row-sharded and s [k] / Vt [k, d]
    replicated. -> (U: DistributedMatrix, s, Vt).

    `oversample` widens the sketch (l = k + oversample, clamped to
    min(n, d)); `n_iter` subspace iterations sharpen a slowly decaying
    spectrum; `draws` gives Omega (module docstring)."""
    u, s, vt, _ = _rsvd_run(a, k, oversample, n_iter, seed, False, draws)
    return u, s, vt


def pca(a, k, oversample=8, n_iter=4, seed=0, draws=None):
    """Randomized PCA of a row-sharded data matrix [n, d]: column means by
    one all-reduce, then the factorisation of the centred block. ->
    (components [k, d], explained_variance [k], mean [d]), replicated."""
    n = a.shape[0]
    if n < 2:
        raise ValueError(f"pca needs >= 2 rows, got {n}")
    _, s, vt, mu = _rsvd_run(a, k, oversample, n_iter, seed, True, draws)
    return vt, (s ** 2) / (n - 1), mu
