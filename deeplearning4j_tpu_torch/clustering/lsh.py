"""Random-projection LSH for approximate nearest neighbors.

The counterpart of ``deeplearning4j_tpu/clustering/lsh.py`` (reference:
nd4j's RandomProjectionLSH: hashLength, numTables, inDimension;
index(data), bucket(query), search(query, k)). Hashing is one matmul on
the index's device: the corpus's sign(X @ R) over one [d, T*L]
projection, packed into int64 codes on the host (hashLength <= 62). The
host keeps the buckets (code -> row ids); candidates are re-ranked
exactly by the quadratic distance form on the device. R is drawn from a
``util.draws.Draws`` at index() unless ``load_reference_params(R)``
gave it.

With a `mesh`, index() hashes the corpus through the distributed
projection (``linalg.matmul``: corpus rows sharded over the data axis,
never padded, R replicated); the sign codes come back gathered, so every
rank builds the whole index. Queries stay local single-row products.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.trees import _as_matrix, _as_vector
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.linalg.distributed import sq_dists
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["RandomProjectionLSH"]


class RandomProjectionLSH:
    """Sign-random-projection (SimHash) multi-table LSH: hashLength bits
    a table, numTables tables."""

    def __init__(self, hashLength, numTables, inDimension, seed=0,
                 mesh=None):
        self.hashLength = int(hashLength)
        self.numTables = int(numTables)
        self.inDimension = int(inDimension)
        if min(self.hashLength, self.numTables, self.inDimension) < 1:
            raise ValueError("hashLength, numTables, inDimension must be >= 1")
        if self.hashLength > 62:
            raise ValueError("hashLength > 62 overflows the packed int64 code")
        self.mesh = mesh
        self.seed = int(seed)
        self._R = None
        self._tables = None
        self._X = None
        self._mean = None

    def load_reference_params(self, R):
        """The projection [inDimension, numTables * hashLength] (numpy),
        e.g. the reference index's; index() then draws none."""
        R = np.asarray(R, np.float32)
        want = (self.inDimension, self.numTables * self.hashLength)
        if R.shape != want:
            raise ValueError(f"R has shape {R.shape}, want {want}")
        self._R = torch.from_numpy(R.copy())
        return self

    def _project(self, X, distributed=False):
        """[n, d] @ [d, T*L]: through linalg's sharded GEMM when
        `distributed` (the corpus-sized call), else one local product."""
        if not distributed:
            return X @ self._R
        from deeplearning4j_tpu_torch.linalg import (DistributedMatrix,
                                                     ROW_AXIS, matmul)

        dX = DistributedMatrix(X, self.mesh, row_axis=ROW_AXIS,
                               device=X.device)   # never-pad (PAR03)
        return matmul(dX, self._R)._global()

    def _codes(self, X, distributed=False):
        """[n, d] tensor -> int64 [n, T] packed sign codes (bits packed
        on the host in int64)."""
        bits = (self._project(X, distributed) >= 0).cpu().numpy()
        bits = bits.reshape(-1, self.numTables, self.hashLength)
        weights = 2 ** np.arange(self.hashLength, dtype=np.int64)
        return (bits.astype(np.int64) * weights).sum(-1)

    def index(self, data, device=None, distributed=None, draws=None):
        """Hash the corpus [n, inDimension] on `device` (None: the card, or
        the mesh's under NCCL), through the distributed projection when
        `distributed` (default: when a mesh is set). `draws` gives R when
        none was loaded (default: a generator on the device seeded by
        `seed`)."""
        if distributed is None:
            distributed = self.mesh is not None
        if distributed and self.mesh is None:
            raise ValueError("a distributed index needs a mesh: "
                             "RandomProjectionLSH(..., mesh=build_mesh())")
        if device is None and distributed:
            device = self.mesh.device
        dev = resolve_device(device)
        Xh = _as_matrix(data).astype(np.float32)
        if Xh.shape[1] != self.inDimension:
            raise ValueError(
                f"data must be [n, {self.inDimension}], got {Xh.shape}")
        with torch.no_grad():
            if self._R is None:
                draws = draws if draws is not None else Draws(self.seed, dev)
                self._R = draws.normal(
                    "lsh.R", (self.inDimension,
                              self.numTables * self.hashLength))
            self._R = self._R.to(dev)
            X = torch.from_numpy(Xh).to(dev)
            codes = self._codes(X, distributed)
        self._tables = []
        for t in range(self.numTables):
            col = codes[:, t]
            order = np.argsort(col, kind="stable")
            keys, starts = np.unique(col[order], return_index=True)
            groups = np.split(order, starts[1:])
            self._tables.append(dict(zip(keys.tolist(), groups)))
        self._mean = Xh.mean(0, keepdims=True)
        self._X = torch.from_numpy(Xh - self._mean).to(dev)
        return self

    def _parse_query(self, query):
        if self._tables is None:
            raise ValueError("bucket()/search() before index()")
        return _as_vector(query, self.inDimension).astype(
            np.float32).reshape(1, -1)

    def _candidates(self, q):
        with torch.no_grad():
            codes = self._codes(torch.from_numpy(q).to(self._R.device))[0]
        parts = [self._tables[t].get(int(codes[t]))
                 for t in range(self.numTables)]
        parts = [p for p in parts if p is not None]
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(parts)).astype(np.int64)

    def bucket(self, query):
        """Candidate row ids whose code matches the query's in ANY table
        (reference: RandomProjectionLSH.bucket)."""
        return self._candidates(self._parse_query(query))

    def search(self, query, k):
        """-> (indices, distances): exact euclidean re-rank of the
        candidate set, nearest first; a full scan only when no bucket
        matches. Returns min(k, candidates) rows."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        q = self._parse_query(query)
        cand = self._candidates(q)
        dev = self._X.device
        with torch.no_grad():
            if cand.size == 0:
                sub, back = self._X, None
            else:
                sub = self._X[torch.from_numpy(cand).to(dev)]
                back = cand
            k_eff = min(k, int(sub.shape[0]))
            qc = torch.from_numpy(q - self._mean).to(dev)
            negd, pos = torch.topk(-sq_dists(qc, sub)[0], k_eff)
        pos = pos.cpu().numpy()
        idx = pos if back is None else back[pos]
        return idx, np.sqrt(-negd.cpu().numpy())
