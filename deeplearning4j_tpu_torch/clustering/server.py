"""NearestNeighborsServer: HTTP kNN serving over VPTree / LSH indexes.

The counterpart of ``deeplearning4j_tpu/clustering/server.py``
(reference: deeplearning4j-nearestneighbors-server), on the port's
``util/httpserve.py`` with the same routes and codes:

  GET  /status   {"numPoints": n, "dims": d, "index": "VPTree"}
  POST /knn      {"index": i, "k": 5}      neighbors of corpus point i
  POST /knnnew   {"point": [...], "k": 5}  neighbors of a new vector

Both POST routes answer {"results": [{"index": i, "distance": d}, ...]},
nearest first; /knn drops the query point itself. A bad body answers
400, an unknown route 404; GET /healthz answers readiness and
``requestDeadline`` bounds each request. Any object with
``search(vector, k) -> (indices, distances)`` can serve: VPTree (exact,
host) and RandomProjectionLSH (approximate, on its device) both do.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.trees import VPTree
from deeplearning4j_tpu_torch.util.httpserve import HttpServerOwner, JsonHandler

__all__ = ["NearestNeighborsServer"]


class NearestNeighborsServer(HttpServerOwner):
    """Build (or wrap) a kNN index and serve it over HTTP.

    points: [n, d] corpus -> a VPTree is built over it.
    index:  alternatively, a prebuilt index exposing search(vec, k);
            pass `corpus` too if /knn (query-by-row) should work.
    """

    def __init__(self, points=None, index=None, corpus=None):
        if (points is None) == (index is None):
            raise ValueError("pass exactly one of points / index")
        if points is not None:
            self._corpus = np.asarray(
                getattr(points, "toNumpy", lambda: points)(), np.float64)
            self._index = VPTree(self._corpus)
        else:
            self._index = index
            self._corpus = None if corpus is None else np.asarray(
                getattr(corpus, "toNumpy", lambda: corpus)(), np.float64)

    # ----- query API (usable without the HTTP layer) -------------------
    def knnNew(self, point, k):
        idx, dist = self._index.search(point, int(k))
        return [{"index": int(i), "distance": float(d)}
                for i, d in zip(np.asarray(idx), np.asarray(dist))]

    def knn(self, row, k):
        if self._corpus is None:
            raise ValueError(
                "/knn needs the corpus — construct with points= or corpus=")
        row = int(row)
        if not (0 <= row < self._corpus.shape[0]):
            raise ValueError(
                f"index {row} outside corpus [0, {self._corpus.shape[0]})")
        # k+1 then drop the self-match (distance-0 row itself)
        k = int(k)
        k_eff = min(k + 1, self._corpus.shape[0])
        res = self.knnNew(self._corpus[row], k_eff)
        return [r for r in res if r["index"] != row][:k]

    @property
    def numPoints(self):
        if self._corpus is not None:
            return int(self._corpus.shape[0])
        X = getattr(self._index, "_X", None)
        return None if X is None else int(X.shape[0])

    # ----- HTTP layer --------------------------------------------------
    def start(self, port=9200, requestDeadline=None, warmup=None):
        """Serve on 127.0.0.1:<port> (0 = ephemeral); returns self.
        GET /healthz answers readiness (503 while setReady(False), e.g.
        during an index rebuild); requestDeadline (seconds) bounds each
        request; `warmup` (callable, e.g. a precompile closure) gates
        readiness until the executables are hot — see util.httpserve."""
        srv = self

        class Handler(JsonHandler):
            def handle_GET(self):
                if self.path != "/status":
                    return self._json({"error": "unknown route"}, 404)
                d = None
                if srv._corpus is not None:
                    d = int(srv._corpus.shape[1])
                elif getattr(srv._index, "_X", None) is not None:
                    d = int(srv._index._X.shape[1])
                return self._json({"numPoints": srv.numPoints, "dims": d,
                                   "index": type(srv._index).__name__})

            def handle_POST(self):
                if self.path not in ("/knn", "/knnnew"):
                    return self._json({"error": "unknown route"}, 404)
                try:
                    body = self._read_json_object()
                    k = int(body.get("k", 5))
                    if self.path == "/knn":
                        results = srv.knn(body["index"], k)
                    else:
                        results = srv.knnNew(
                            np.asarray(body["point"], np.float64), k)
                    return self._json({"results": results, "k": k})
                except (KeyError, TypeError, ValueError) as e:
                    return self._json(
                        {"error": f"{type(e).__name__}: {e}"}, 400)

        return self._serve(Handler, port, requestDeadline=requestDeadline,
                           warmup=warmup)
