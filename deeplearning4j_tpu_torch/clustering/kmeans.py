"""KMeans + exact nearest neighbors.

The counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``
(reference: org.deeplearning4j.clustering.kmeans.KMeansClustering,
setup(clusterCount, maxIterationCount, distanceFunction) ->
applyTo(points) -> ClusterSet). Points are mean-centred, seeded by
farthest points from a drawn first centre, then Lloyd iterations run on
the device until no assignment changes, at most maxIterationCount
times. The reference's ``lax.while_loop`` becomes a Python loop whose
convergence test reads one flag on the host an iteration
(``hostFlagReads``). Empty clusters re-seed to distinct farthest points
(slot i takes the i-th farthest); argmin keeps the first index on ties.
The first centre comes from a ``util.draws.Draws`` (``applyTo(draws=)``)
so a test can hand in the reference's ``jax.random.randint``.

With a `mesh`, seeding and Lloyd run row-sharded over its data axis
(the linalg tier, reference ``_lloyd_sharded``): each rank holds its block
of the centred points (``linalg.DistributedMatrix``, never padded), the
first centre comes from its owner by an all-reduce, each farthest point is
the global argmax of the local candidates all-gathered (the single-device
path's first-occurrence tie-break), centre sums, counts and the changed
flag are all-reduced, and empty clusters re-seed to the global farthest
points. Every rank returns the whole result (assignments all-gathered).

NearestNeighbors is exact brute force: one quadratic-form distance
matrix and a top-k on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.linalg.distributed import sq_dists
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["ClusterSet", "KMeansClustering", "NearestNeighbors", "sq_dists"]


def _points(points):
    return np.asarray(getattr(points, "toNumpy", lambda: points)(),
                      np.float32)


class ClusterSet:
    """Fitted result (reference: clustering.cluster.ClusterSet)."""

    def __init__(self, centers, assignments, inertia):
        self._centers = np.asarray(centers)
        self._assign = np.asarray(assignments)
        self.inertia = float(inertia)

    def getClusterCount(self):
        return self._centers.shape[0]

    def getCenters(self):
        return self._centers

    def getAssignments(self):
        return self._assign

    def classifyPoint(self, point):
        d = np.sum((self._centers - np.asarray(point)) ** 2, 1)
        return int(np.argmin(d))


class KMeansClustering:
    """Reference: KMeansClustering.setup(...).applyTo(points)."""

    def __init__(self, clusterCount, maxIterationCount=100,
                 distanceFunction="euclidean", seed=42, mesh=None):
        if str(distanceFunction).lower() not in ("euclidean", "sqeuclidean"):
            raise ValueError(
                f"distanceFunction {distanceFunction!r} unsupported "
                "(euclidean)")
        self.k = int(clusterCount)
        if self.k < 1:
            raise ValueError(f"clusterCount must be >= 1, got {clusterCount}")
        #: mesh-sharded Lloyd (module docstring)
        self.mesh = mesh
        self.maxIter = int(maxIterationCount)
        self.seed = int(seed)
        self.iterations = 0
        self.hostFlagReads = 0
        self._C0 = None   # load_reference_params: the next applyTo's start

    @staticmethod
    def setup(clusterCount, maxIterationCount=100,
              distanceFunction="euclidean", seed=42, mesh=None):
        return KMeansClustering(clusterCount, maxIterationCount,
                                distanceFunction, seed, mesh=mesh)

    def applyTo(self, points, device=None, draws=None) -> ClusterSet:
        """Cluster `points` [n, d] on `device` (None: the card, or the
        mesh's under NCCL). `draws` gives the first centre (default: a
        generator on the device seeded by `seed`). With a mesh every rank
        passes the same points."""
        Xh = _points(points)
        n, d = Xh.shape
        if n < self.k:
            raise ValueError(f"{n} points cannot form {self.k} clusters")
        mean = Xh.mean(0, keepdims=True)
        if self.mesh is not None:
            return self._apply_sharded(Xh - mean, mean, device, draws)
        dev = resolve_device(device)
        with torch.no_grad():
            X = torch.from_numpy(Xh - mean).to(dev)
            if self._C0 is not None:
                C0 = torch.from_numpy(self._C0 - mean).to(dev)
                self._C0 = None
            else:
                draws = draws if draws is not None else Draws(self.seed, dev)
                C0 = self._seed_centres(X, draws.randint("kmeans.first", n))
            C, a, inertia = self._lloyd(X, C0)
        return ClusterSet(C.cpu().numpy() + mean, a.cpu().numpy(),
                          float(inertia))

    def _seed_centres(self, X, first):
        """Farthest-point seeding with a running min-distance vector, on
        the device (no host read)."""
        idxs = torch.empty(self.k, dtype=torch.int64, device=X.device)
        idxs[0] = first
        dmin = sq_dists(X, X[first][None, :])[:, 0]
        for i in range(1, self.k):
            nxt = torch.argmax(dmin)
            idxs[i] = nxt
            dmin = torch.minimum(dmin, sq_dists(X, X[nxt][None, :])[:, 0])
        return X[idxs]

    def _step(self, X, C):
        D = sq_dists(X, C)
        a = torch.argmin(D, 1)
        counts = torch.bincount(a, minlength=self.k).to(X.dtype)
        sums = torch.zeros_like(C).index_add_(0, a, X)
        newC = sums / torch.clamp(counts, min=1.0)[:, None]
        far_idx = torch.topk(D.min(1).values, self.k).indices
        return torch.where((counts > 0)[:, None], newC, X[far_idx]), a

    def _lloyd(self, X, C0):
        """Lloyd until the assignments repeat, at most maxIter steps; one
        host read of the changed flag an iteration."""
        C, a = self._step(X, C0)
        it, reads = 1, 0
        a_prev = None
        while it < self.maxIter:
            if a_prev is not None:
                reads += 1
                if not bool((a_prev != a).any()):
                    break
            a_prev = a
            C, a = self._step(X, C)
            it += 1
        self.iterations, self.hostFlagReads = it, reads
        D = sq_dists(X, C)
        return C, torch.argmin(D, 1), D.min(1).values.sum()

    def _apply_sharded(self, Xc, mean, device, draws):
        from deeplearning4j_tpu_torch.linalg import (DistributedMatrix,
                                                     ROW_AXIS)
        from deeplearning4j_tpu_torch.linalg.distributed import (
            _gather_rows, _group, _sum,
        )
        from deeplearning4j_tpu_torch.parallel import collectives as _coll

        dX = DistributedMatrix(Xc, self.mesh, row_axis=ROW_AXIS,
                               device=device)     # never-pad (PAR03)
        rows = _group(self.mesh, ROW_AXIS)
        xl, k = dX.tensor(), self.k
        nl = xl.shape[0]
        if nl < k:
            raise ValueError(
                f"{dX.shape[0]} points over mesh axis '{ROW_AXIS}' (size "
                f"{rows.size}) leave {nl} rows per chip — fewer than "
                f"k={k}; the distributed farthest-point re-seed needs k "
                "candidates per shard")

        def gather(t):
            if rows.pg is None:
                return t.unsqueeze(0)
            return _coll.all_gather(t.contiguous(), rows)

        def seed_centres(first):
            """The first centre from its owner, then the global farthest
            points (local candidates gathered, re-argmaxed)."""
            mine = first // nl == rows.rank
            pt = _sum(xl[first % nl].clone() if mine
                      else xl.new_zeros(xl.shape[1]), rows)
            C = xl.new_zeros(k, xl.shape[1])
            C[0] = pt
            dmin = sq_dists(xl, pt[None, :])[:, 0]
            for i in range(1, k):
                li = torch.argmax(dmin)
                pt = gather(xl[li])[torch.argmax(gather(dmin[li]))]
                C[i] = pt
                dmin = torch.minimum(dmin, sq_dists(xl, pt[None, :])[:, 0])
            return C

        with torch.no_grad():
            if self._C0 is not None:
                C = torch.from_numpy(self._C0 - mean).to(xl.device)
                self._C0 = None
            else:
                draws = draws if draws is not None \
                    else Draws(self.seed, xl.device)
                C = seed_centres(draws.randint("kmeans.first", dX.shape[0]))

            def step(C):
                D = sq_dists(xl, C)
                a = torch.argmin(D, 1)
                counts = _sum(torch.bincount(a, minlength=k).to(xl.dtype),
                              rows)
                sums = _sum(torch.zeros_like(C).index_add_(0, a, xl), rows)
                newC = sums / torch.clamp(counts, min=1.0)[:, None]
                lv, li = torch.topk(D.min(1).values, k)
                far = gather(xl[li]).reshape(-1, xl.shape[1])[
                    torch.topk(gather(lv).reshape(-1), k).indices]
                return torch.where((counts > 0)[:, None], newC, far), a

            C, a = step(C)
            it, reads = 1, 0
            while it < self.maxIter:
                C2, a2 = step(C)
                it += 1
                changed = _sum((a != a2).any().to(torch.int32), rows)
                reads += 1
                C, a = C2, a2
                if not bool(changed > 0):
                    break
            D = sq_dists(xl, C)
            a = _gather_rows(torch.argmin(D, 1)[:, None], rows)[:, 0]
            inertia = _sum(D.min(1).values.sum(), rows)
        self.iterations, self.hostFlagReads = it, reads
        return ClusterSet(C.cpu().numpy() + mean, a.cpu().numpy(),
                          float(inertia))

    def load_reference_params(self, centers):
        """Start the next applyTo from these centres (numpy [k, d], in
        the points' own coordinates, e.g. a reference ClusterSet's)
        instead of seeding; the Lloyd loop then runs as usual."""
        c = np.asarray(centers, np.float32)
        if c.shape[0] != self.k:
            raise ValueError(f"{c.shape[0]} centres for k={self.k}")
        self._C0 = c
        return self


class NearestNeighbors:
    """Exact k-NN by brute force on the device (reference: the
    VPTree/NearestNeighborsServer stack)."""

    def __init__(self, points, device=None):
        Xh = _points(points)
        if Xh.ndim != 2 or Xh.shape[0] == 0:
            raise ValueError("points must be a non-empty [n, d] matrix")
        self._dev = resolve_device(device)
        self._mean = Xh.mean(0, keepdims=True)
        self._X = torch.from_numpy(Xh - self._mean).to(self._dev)

    def search(self, query, k):
        """-> (indices [q, k], distances [q, k]) for a [q, d] (or [d])
        query batch; euclidean, exact."""
        q = _points(query)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        k = int(k)
        if not (1 <= k <= self._X.shape[0]):
            raise ValueError(f"k={k} outside [1, {self._X.shape[0]}]")
        with torch.no_grad():
            qt = torch.from_numpy(q - self._mean).to(self._dev)
            negd, idx = torch.topk(-sq_dists(qt, self._X), k)
        dist = np.sqrt(-negd.cpu().numpy())
        idx = idx.cpu().numpy()
        return (idx[0], dist[0]) if single else (idx, dist)
