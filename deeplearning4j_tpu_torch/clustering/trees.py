"""Spatial index structures: VPTree and KDTree.

A copy of ``deeplearning4j_tpu/clustering/trees.py`` (reference:
org.deeplearning4j.clustering.vptree.VPTree, the index behind
NearestNeighborsServer, and org.deeplearning4j.clustering.kdtree.KDTree).
Host numpy: batched k-NN runs on the device as brute force
(``clustering.NearestNeighbors``); these trees serve the latency-bound
single query, where an O(log n) prune beats a trip to the device. Both
are exact; the seeded vantage points make a VPTree the reference's, node
for node.
"""

from __future__ import annotations

import heapq

import numpy as np


def _as_matrix(points):
    X = np.asarray(getattr(points, "toNumpy", lambda: points)(), np.float64)
    if X.ndim != 2 or X.shape[0] == 0:
        raise ValueError("points must be a non-empty [n, d] matrix")
    return X


def _as_vector(p, d):
    q = np.asarray(getattr(p, "toNumpy", lambda: p)(), np.float64).reshape(-1)
    if q.shape[0] != d:
        raise ValueError(f"query has {q.shape[0]} dims, index has {d}")
    return q


class VPTree:
    """Vantage-point tree over a fixed corpus (reference: VPTree — the
    JVM picks a vantage point, splits by median distance, and prunes
    with the triangle inequality; same algorithm here, held in flat
    numpy arrays instead of node objects).

    search(target, k) -> (indices, distances), exact, sorted ascending.
    """

    _LEAF = 8  # below this, a linear scan beats further indirection

    def __init__(self, items, distance="euclidean", seed=0):
        if str(distance).lower() != "euclidean":
            raise ValueError(f"distance {distance!r} unsupported (euclidean)")
        self._X = _as_matrix(items)
        n = self._X.shape[0]
        # diagnostic: points visited by the last search() (exactness is
        # tested; this shows the prune working). Not thread-safe.
        self._scanned = 0
        rng = np.random.default_rng(seed)
        # flat node list + explicit worklist: tie-heavy corpora (e.g.
        # many duplicate rows) make a degenerate split put every point
        # on one side, which would blow Python's recursion limit
        self._nodes = []
        self._root = self._alloc(np.arange(n))
        work = ([self._root] if self._root >= 0
                and "pending" in self._nodes[self._root] else [])
        while work:
            pos = work.pop()
            node = self._nodes[pos]
            idx = node.pop("pending")
            vp_pos = int(rng.integers(idx.size))
            vp = idx[vp_pos]
            rest = np.delete(idx, vp_pos)
            d = np.linalg.norm(self._X[rest] - self._X[vp], axis=1)
            mu = float(np.median(d))
            inner_idx = rest[d <= mu]
            outer_idx = rest[d > mu]
            if inner_idx.size == rest.size:  # all ties: split made no
                node["leaf"] = idx           # progress -> linear leaf
                continue
            node["vp"], node["mu"] = vp, mu
            node["inner"] = self._alloc(inner_idx)
            node["outer"] = self._alloc(outer_idx)
            for child in (node["inner"], node["outer"]):
                if child >= 0 and "pending" in self._nodes[child]:
                    work.append(child)

    def _alloc(self, idx):
        if idx.size == 0:
            return -1
        self._nodes.append({"leaf": idx} if idx.size <= self._LEAF
                           else {"pending": idx})
        return len(self._nodes) - 1

    def search(self, target, k):
        q = _as_vector(target, self._X.shape[1])
        k = int(k)
        if not (1 <= k <= self._X.shape[0]):
            raise ValueError(f"k={k} outside [1, {self._X.shape[0]}]")
        # max-heap of the current best k (python heapq is a min-heap,
        # so store negated distances)
        best = []  # (-dist, index)
        self._scanned = 0

        def consider(i, dist):
            if len(best) < k:
                heapq.heappush(best, (-dist, i))
            elif dist < -best[0][0]:
                heapq.heapreplace(best, (-dist, i))

        def tau():
            return -best[0][0] if len(best) == k else np.inf

        # explicit stack (degenerate trees can be O(n) deep — see
        # _build). A far-side entry carries (dvp, mu, outer?) and its
        # triangle-inequality gate is re-evaluated when POPPED, after
        # the near side has tightened tau — same prune strength as the
        # recursive visit-near-then-test formulation.
        stack = [(self._root, None)]
        while stack:
            pos, gate = stack.pop()
            if pos < 0:
                continue
            if gate is not None:
                dvp, mu, is_outer = gate
                # a point at distance <= mu from vp can be no closer to
                # q than dvp - mu; one > mu no closer than mu - dvp
                if is_outer and not (dvp + tau() > mu):
                    continue
                if not is_outer and not (dvp - tau() <= mu):
                    continue
            node = self._nodes[pos]
            if "leaf" in node:
                leaf = node["leaf"]
                self._scanned += leaf.size
                # one vectorized norm over the leaf block (leaves can be
                # large when ties collapse a subtree)
                for i, dist in zip(
                        leaf, np.linalg.norm(self._X[leaf] - q, axis=1)):
                    consider(int(i), float(dist))
                continue
            vp, mu = node["vp"], node["mu"]
            self._scanned += 1
            dvp = float(np.linalg.norm(self._X[vp] - q))
            consider(int(vp), dvp)
            # near side (containing q) pushed last -> visited first
            if dvp <= mu:
                stack.append((node["outer"], (dvp, mu, True)))
                stack.append((node["inner"], None))
            else:
                stack.append((node["inner"], (dvp, mu, False)))
                stack.append((node["outer"], None))
        out = sorted(((-nd, i) for nd, i in best))
        return (np.array([i for _, i in out]),
                np.array([d for d, _ in out]))


class _KDNode:
    __slots__ = ("point", "index", "axis", "left", "right")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left = None
        self.right = None


class KDTree:
    """Incremental k-d tree (reference: kdtree.KDTree — upstream inserts
    points one at a time and serves nn / radius queries; same here).

    insert(point) -> index; nn(point) -> (index, distance);
    knn(point, radius) -> (indices, distances) within radius, sorted.
    """

    def __init__(self, dims):
        self.dims = int(dims)
        if self.dims < 1:
            raise ValueError(f"dims must be >= 1, got {dims}")
        self._root = None
        self._points = []

    def size(self):
        return len(self._points)

    def insert(self, point):
        p = _as_vector(point, self.dims)
        idx = len(self._points)
        self._points.append(p)
        if self._root is None:
            self._root = _KDNode(p, idx, 0)
            return idx
        node = self._root
        while True:
            side = "left" if p[node.axis] < node.point[node.axis] else "right"
            child = getattr(node, side)
            if child is None:
                setattr(node, side,
                        _KDNode(p, idx, (node.axis + 1) % self.dims))
                return idx
            node = child

    def nn(self, point):
        if self._root is None:
            raise ValueError("nn() on an empty KDTree")
        q = _as_vector(point, self.dims)
        best = [np.inf, -1]
        # explicit stack (insert-order trees can chain O(n) deep, e.g.
        # sorted or duplicate inserts); a far-side entry carries the
        # hyperplane distance and is prune-tested when popped, after the
        # near side has tightened the best ball
        stack = [(self._root, None)]
        while stack:
            node, plane = stack.pop()
            if node is None:
                continue
            # the splitting hyperplane is |diff| away; the far side can
            # only hold a closer point if the current ball crosses it
            if plane is not None and plane >= best[0]:
                continue
            dist = float(np.linalg.norm(node.point - q))
            if dist < best[0]:
                best[0], best[1] = dist, node.index
            diff = q[node.axis] - node.point[node.axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            stack.append((far, abs(diff)))
            stack.append((near, None))  # pushed last -> visited first
        return best[1], best[0]

    def knn(self, point, radius):
        """All points within `radius`, nearest first (reference:
        KDTree.knn(INDArray, double))."""
        if self._root is None:
            raise ValueError("knn() on an empty KDTree")
        q = _as_vector(point, self.dims)
        radius = float(radius)
        hits = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is None:
                continue
            dist = float(np.linalg.norm(node.point - q))
            if dist <= radius:
                hits.append((dist, node.index))
            diff = q[node.axis] - node.point[node.axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            stack.append(near)
            # fixed radius: the side away from q is reachable only if
            # the hyperplane is within radius
            if abs(diff) <= radius:
                stack.append(far)
        hits.sort()
        return (np.array([i for _, i in hits], np.int64),
                np.array([d for d, _ in hits]))
