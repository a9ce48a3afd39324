"""t-SNE dimensionality reduction.

The counterpart of ``deeplearning4j_tpu/plot/tsne.py`` (reference:
org.deeplearning4j.plot.BarnesHutTsne; Builder setMaxIter / perplexity /
theta / learningRate; fit(INDArray) then getData()). The joint
probabilities P come from the reference's host code, copied: a dense
per-point bandwidth search (``_p_conditional``) or its kNN-sparse form
(``_p_sparse``). Two gradients:

- "exact": dense P, the whole-matrix gradient, O(N^2) memory;
- "tiled": kNN-sparse P (k = 3 * perplexity; k = N - 1 gives exact's P),
  the attraction as a sum over P's edges (``index_add_``), the repulsion
  and the Q normaliser streamed over [tile, N] row blocks.

"auto" takes exact up to 4,096 points. Early exaggeration (12 for the
first min(100, maxIter / 4) iterations) and momentum (0.5, then 0.8) as
the reference (van der Maaten 2008). The reference's ``fori_loop``
becomes a Python loop of device ops with no host read inside. The start
Y0 = 1e-4 * N(0, 1) comes from a ``util.draws.Draws`` (``fit(draws=)``);
``load_reference_params`` starts from a given Y and momentum instead.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["BarnesHutTsne"]


def _p_conditional(X, perplexity, tol=1e-5, max_tries=50):
    """Symmetrized joint probabilities P from a host-side per-point
    binary search over Gaussian bandwidths (one-time setup cost)."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    sq = np.sum(X ** 2, 1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi, beta = -np.inf, np.inf, 1.0
        Di = np.delete(D[i], i)
        for _ in range(max_tries):
            expD = np.exp(-Di * beta)
            sumP = max(expD.sum(), 1e-12)
            H = np.log(sumP) + beta * np.sum(Di * expD) / sumP
            if abs(H - target) < tol:
                break
            if H > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        row = np.exp(-Di * beta)
        row = row / max(row.sum(), 1e-12)
        P[i, np.arange(n) != i] = row
    P = (P + P.T) / (2.0 * n)
    return np.maximum(P, 1e-12)


def _p_sparse(X, perplexity, k, block=2048, tol=1e-5, max_tries=50):
    """kNN-sparse symmetrized P as COO (rows, cols, vals). The neighbour
    search streams [block, N] distance tiles; the bandwidth binary
    search runs vectorised over all rows at once."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    k = min(int(k), n - 1)
    sq = np.sum(X ** 2, 1)
    idx = np.empty((n, k), np.int64)
    Dk = np.empty((n, k), np.float64)
    for s in range(0, n, block):
        e = min(n, s + block)
        d = np.maximum(sq[s:e, None] + sq[None, :] - 2.0 * (X[s:e] @ X.T),
                       0.0)
        d[np.arange(e - s), np.arange(s, e)] = np.inf  # exclude self
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        idx[s:e] = part
        Dk[s:e] = np.take_along_axis(d, part, axis=1)
    target = np.log(perplexity)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    beta = np.ones(n)
    for _ in range(max_tries):
        expD = np.exp(-Dk * beta[:, None])
        sumP = np.maximum(expD.sum(1), 1e-12)
        H = np.log(sumP) + beta * np.sum(Dk * expD, 1) / sumP
        if np.all(np.abs(H - target) < tol):
            break
        gt = H > target
        lo = np.where(gt, beta, lo)
        hi = np.where(gt, hi, beta)
        beta = np.where(
            gt, np.where(np.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            np.where(np.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
    rowsP = np.exp(-Dk * beta[:, None])
    rowsP /= np.maximum(rowsP.sum(1, keepdims=True), 1e-12)
    # symmetrize the sparse conditional: P = (P + P^T) / 2n, summing
    # duplicate (i,j) entries via unique codes
    i0 = np.repeat(np.arange(n), k)
    j0 = idx.ravel()
    v0 = rowsP.ravel() / (2.0 * n)
    codes = np.concatenate([i0 * n + j0, j0 * n + i0])
    vals = np.concatenate([v0, v0])
    uniq, inv = np.unique(codes, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, vals)
    return (uniq // n).astype(np.int32), (uniq % n).astype(np.int32), \
        np.maximum(acc, 1e-12).astype(np.float32)


class BarnesHutTsne:
    """Builder-constructed t-SNE (reference: BarnesHutTsne.Builder)."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def setMaxIter(self, n):
            self._kw["maxIter"] = int(n)
            return self

        def method(self, m):
            """"exact" | "tiled" | "auto" (this framework's replacement
            knob for upstream's theta; see module docstring)."""
            self._kw["method"] = str(m)
            return self

        def tileSize(self, b):
            self._kw["tileSize"] = int(b)
            return self

        def knnK(self, k):
            """Sparse-P neighbour count for tiled mode (default
            3*perplexity; k=N-1 makes tiled P identical to exact P)."""
            self._kw["knnK"] = int(k)
            return self

        def perplexity(self, p):
            self._kw["perplexity"] = float(p)
            return self

        def theta(self, t):  # accepted for parity; exact solver ignores it
            self._kw["theta"] = float(t)
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = float(lr)
            return self

        def numDimension(self, d):
            self._kw["numDimensions"] = int(d)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def device(self, d):
            """Where fit() runs (None: the card)."""
            self._kw["device"] = d
            return self

        def build(self):
            return BarnesHutTsne(**self._kw)

    def __init__(self, maxIter=1000, perplexity=30.0, theta=0.5,
                 learningRate=200.0, numDimensions=2, seed=42,
                 method="auto", tileSize=1024, knnK=None, device=None):
        self.device = device
        self._start = None   # load_reference_params: (Y, V, iteration)
        self.maxIter = maxIter
        self.perplexity = perplexity
        self.theta = theta
        self.learningRate = learningRate
        self.numDimensions = numDimensions
        self.seed = seed
        if method not in ("auto", "exact", "tiled"):
            raise ValueError(f"method must be auto/exact/tiled, got {method!r}")
        self.method = method
        self.tileSize = int(tileSize)
        self.knnK = knnK
        self._Y = None
        self.usedMethod = None

    def fit(self, X, device=None, draws=None):
        """Embed X [n, D] on `device` (default: the Builder's, else the
        card). `draws` gives Y0 (default: a generator on the device
        seeded by `seed`)."""
        X = np.asarray(getattr(X, "toNumpy", lambda: X)())
        n = X.shape[0]
        if n < 3 * self.perplexity + 1:
            raise ValueError(
                f"perplexity {self.perplexity} too large for {n} points "
                f"(needs n > 3*perplexity)")
        m = self.method
        if m == "auto":
            m = "exact" if n <= 4096 else "tiled"
        self.usedMethod = m
        dev = resolve_device(device if device is not None else self.device)
        if self._start is not None:
            Y0, V0, it0 = self._start
            Y0, V0 = Y0.to(dev), V0.to(dev)
            self._start = None
        else:
            draws = draws if draws is not None else Draws(self.seed, dev)
            Y0 = 1e-4 * draws.normal("tsne.Y0",
                                     (n, self.numDimensions)).to(dev)
            V0, it0 = torch.zeros_like(Y0), 0
        with torch.no_grad():
            if m == "tiled":
                Y = self._fit_tiled(X, n, Y0, V0, it0, dev)
            else:
                t0 = time.perf_counter()
                P = torch.from_numpy(
                    _p_conditional(X, self.perplexity).astype(np.float32)
                ).to(dev)
                self.affinitySeconds = time.perf_counter() - t0
                self._P = P
                Y, _ = self._loop(Y0, V0, it0, lambda Y, pm: self._kl_grad(
                    Y, P * pm), lambda Y: Y - Y.mean(0, keepdim=True))
        self._Y = Y.cpu().numpy()
        return self

    @staticmethod
    def _kl_grad(Y, Pm):
        n = Y.shape[0]
        sq = (Y * Y).sum(1)
        num = 1.0 / (1.0 + torch.clamp(
            sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T), min=0.0))
        num = num * (1.0 - torch.eye(n, dtype=Y.dtype, device=Y.device))
        Q = torch.clamp(num / num.sum(), min=1e-12)
        PQ = (Pm - Q) * num
        return 4.0 * (torch.diag(PQ.sum(1)) - PQ) @ Y

    def _loop(self, Y, V, it0, grad, centre):
        """maxIter iterations from iteration it0 of the schedule: early
        exaggeration and momentum 0.5 before min(100, maxIter // 4), then
        none and 0.8. No host read."""
        lr = self.learningRate
        exag_iters = min(100, self.maxIter // 4)
        for i in range(it0, it0 + self.maxIter):
            early = i < exag_iters
            g = grad(Y, 12.0 if early else 1.0)
            V = (0.5 if early else 0.8) * V - lr * g
            Y = centre(Y + V)
        return Y, V

    def _fit_tiled(self, X, n, Y0, V0, it0, dev):
        """Block-pairwise gradient: O(tile * N) peak memory instead of
        O(N^2); same objective and update rule as the exact path."""
        k = self.knnK if self.knnK is not None \
            else int(round(3 * self.perplexity))
        t0 = time.perf_counter()
        rows, cols, pvals0 = _p_sparse(X, self.perplexity, k)
        self.affinitySeconds = time.perf_counter() - t0
        self._P_sparse = (rows, cols, pvals0)
        B = min(self.tileSize, n)
        n_pad = -(-n // B) * B
        nblk = n_pad // B
        d = self.numDimensions
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(dev)
        cols_t = torch.from_numpy(cols.astype(np.int64)).to(dev)
        pvals = torch.from_numpy(pvals0).to(dev)
        pad = torch.zeros((n_pad - n, d), dtype=torch.float32, device=dev)
        Y0 = torch.cat([Y0, pad])
        V0 = torch.cat([V0, pad])
        valid = torch.arange(n_pad, device=dev) < n
        col_ids = torch.arange(n_pad, device=dev)

        def grad(Y, pm):
            diff = Y[rows_t] - Y[cols_t]
            num_e = 1.0 / (1.0 + (diff * diff).sum(1))
            attr = torch.zeros_like(Y).index_add_(
                0, rows_t, (pvals * pm * num_e)[:, None] * diff)
            sqY = (Y * Y).sum(1)
            S = torch.zeros((), dtype=Y.dtype, device=dev)
            rep = torch.empty_like(Y)
            for s in range(nblk):
                yb = Y[s * B:(s + 1) * B]
                rid = col_ids[s * B:(s + 1) * B]
                d2 = torch.clamp(sqY[rid][:, None] + sqY[None, :]
                                 - 2.0 * yb @ Y.T, min=0.0)
                mask = (valid[None, :] & valid[rid][:, None]
                        & (rid[:, None] != col_ids[None, :]))
                num = torch.where(mask, 1.0 / (1.0 + d2), 0.0)
                n2 = num * num
                rep[s * B:(s + 1) * B] = n2.sum(1)[:, None] * yb - n2 @ Y
                S = S + num.sum()
            return 4.0 * (attr - rep / torch.clamp(S, min=1e-12))

        def centre(Y):
            mean = (Y * valid[:, None]).sum(0, keepdim=True) / n
            return torch.where(valid[:, None], Y - mean, 0.0)

        Y, _ = self._loop(Y0, V0, it0, grad, centre)
        return Y[:n]

    def load_reference_params(self, Y, V=None, iteration=0):
        """Start the next fit from Y [n, d] (numpy; e.g. the reference's)
        and momentum V (default zeros), at `iteration` of the schedule,
        instead of drawing Y0."""
        Y = torch.from_numpy(np.asarray(Y, np.float32).copy())
        V = torch.zeros_like(Y) if V is None else torch.from_numpy(
            np.asarray(V, np.float32).copy())
        self._start = (Y, V, int(iteration))
        return self

    def getData(self):
        if self._Y is None:
            raise RuntimeError("call fit() first")
        return self._Y

    def saveAsFile(self, labels, path):
        """Rows of 'y0,y1,...,label' (reference: BarnesHutTsne.saveAsFile
        feeding the upstream plotting utilities)."""
        Y = self.getData()
        with open(path, "w") as fh:
            for row, lab in zip(Y, labels):
                fh.write(",".join(f"{v:.6f}" for v in row) + f",{lab}\n")
