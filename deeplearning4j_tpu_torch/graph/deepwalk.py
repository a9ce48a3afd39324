"""DeepWalk vertex embeddings.

The counterpart of ``deeplearning4j_tpu/graph/deepwalk.py`` (reference:
deeplearning4j-graph org.deeplearning4j.graph.models.deepwalk.DeepWalk,
after Perozzi et al. 2014): truncated random walks as sentences,
embedded by skip-gram with negative sampling. The walks are the
reference's host code and draw from the same
``np.random.RandomState(seed)``, so they are its walks, bitwise; the
embedding trains through the port's Word2Vec on the fit's device (the
card unless ``device="cpu"``).
"""

from __future__ import annotations

import time

import numpy as np

from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                   CollectionSentenceIterator)

__all__ = ["Graph", "GraphLoader", "DeepWalk"]


class Graph:
    """Undirected-by-default adjacency graph, optionally edge-weighted
    (reference: org.deeplearning4j.graph.graph.Graph; weighted walks:
    WeightedWalkIterator)."""

    def __init__(self, numVertices: int):
        if int(numVertices) <= 0:
            raise ValueError("numVertices must be positive")
        self._adj = [[] for _ in range(int(numVertices))]
        self._w = [[] for _ in range(int(numVertices))]

    def numVertices(self) -> int:
        return len(self._adj)

    def addEdge(self, a: int, b: int, directed: bool = False,
                weight: float = 1.0):
        n = self.numVertices()
        if not (0 <= a < n and 0 <= b < n):
            raise ValueError(f"edge ({a},{b}) outside [0,{n})")
        if not (weight > 0):
            raise ValueError(f"edge weight must be positive, got {weight}")
        self._adj[a].append(b)
        self._w[a].append(float(weight))
        if not directed:
            self._adj[b].append(a)
            self._w[b].append(float(weight))
        return self

    def getConnectedVertices(self, v: int):
        return list(self._adj[v])

    def getEdgeWeights(self, v: int):
        return list(self._w[v])


class GraphLoader:
    """Edge-list file loaders (reference:
    org.deeplearning4j.graph.data.GraphLoader). Lines are
    "a<delim>b" or "a<delim>b<delim>weight"; blank lines and
    '#'-comments are skipped; any whitespace works when `delimiter`
    is None."""

    @staticmethod
    def _parse(path, delimiter):
        edges = []
        with open(str(path)) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = (line.split(delimiter) if delimiter
                         else line.split())
                parts = [p for p in (s.strip() for s in parts) if p]
                if len(parts) not in (2, 3):
                    raise ValueError(
                        f"{path}:{ln}: expected 'a b' or 'a b weight', "
                        f"got {line!r}")
                a, b = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) == 3 else 1.0
                edges.append((a, b, w))
        if not edges:
            raise ValueError(f"{path}: no edges")
        return edges

    @staticmethod
    def loadUndirectedGraphEdgeListFile(path, numVertices=None,
                                        delimiter=None):
        return GraphLoader._build(path, numVertices, delimiter,
                                  directed=False)

    @staticmethod
    def loadWeightedEdgeListFile(path, numVertices=None, delimiter=None,
                                 directed=False):
        return GraphLoader._build(path, numVertices, delimiter, directed)

    @staticmethod
    def _build(path, numVertices, delimiter, directed):
        edges = GraphLoader._parse(path, delimiter)
        n = (numVertices if numVertices is not None
             else max(max(a, b) for a, b, _ in edges) + 1)
        g = Graph(n)
        for a, b, w in edges:
            g.addEdge(a, b, directed=directed, weight=w)
        return g


class _IdentityTokenizer:
    """Vertex-id 'sentences' must not be lowercased/regex-split."""

    def create(self, sentence):
        return sentence.split()


class DeepWalk:
    """Builder-constructed DeepWalk (reference: DeepWalk.Builder)."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def windowSize(self, n):
            self._kw["windowSize"] = int(n)
            return self

        def vectorSize(self, n):
            self._kw["vectorSize"] = int(n)
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = float(lr)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def returnParam(self, p):
            """node2vec p: smaller -> walks revisit the previous vertex
            more (reference: upstream's weighted/biased walk support;
            parameterisation per Grover & Leskovec 2016)."""
            self._kw["returnParam"] = float(p)
            return self

        def inOutParam(self, q):
            """node2vec q: q>1 keeps walks local (BFS-like, community
            structure); q<1 pushes outward (DFS-like)."""
            self._kw["inOutParam"] = float(q)
            return self

        def device(self, d):
            """Where fit() trains (None: the card)."""
            self._kw["device"] = d
            return self

        def build(self):
            return DeepWalk(**self._kw)

    def __init__(self, windowSize=5, vectorSize=100, learningRate=0.025,
                 seed=42, returnParam=1.0, inOutParam=1.0, device=None):
        self.device = device
        self.windowSize = windowSize
        self.vectorSize = vectorSize
        self.learningRate = learningRate
        self.seed = seed
        if returnParam <= 0 or inOutParam <= 0:
            raise ValueError("returnParam/inOutParam must be > 0")
        self.returnParam = float(returnParam)
        self.inOutParam = float(inOutParam)
        self._w2v = None

    def _walks(self, graph, walkLength, walksPerVertex, rng):
        walks = []
        n = graph.numVertices()
        p, q = self.returnParam, self.inOutParam
        biased = (p != 1.0 or q != 1.0)
        adj_sets = [set(a) for a in graph._adj] if biased else None
        # edge weights multiply every transition probability (reference:
        # WeightedWalkIterator; node2vec defines its alpha bias ON TOP
        # of edge weights)
        wlists = [np.asarray(w) for w in graph._w]
        weighted = any(len(w) and (w != w[0]).any() for w in wlists
                       if len(w))
        # per-vertex first-order distributions are step-invariant:
        # normalize once, not per step. Also serves a biased walk's
        # FIRST step (no prev yet), where unweighted graphs need the
        # uniform all-ones distribution
        probs = ([w / w.sum() if len(w) else w for w in wlists]
                 if (weighted or biased) else None)
        for _ in range(walksPerVertex):
            for start in rng.permutation(n):
                v = int(start)
                prev = None
                walk = [v]
                for _ in range(walkLength - 1):
                    nbrs = graph._adj[v]
                    if not nbrs:
                        break  # dead end: truncate like upstream
                    if not biased and not weighted:
                        nxt = int(nbrs[rng.randint(len(nbrs))])
                    else:
                        # node2vec second-order transition: 1/p to return,
                        # 1 to a mutual neighbour of prev, 1/q outward
                        if biased and prev is not None:
                            alpha = np.array(
                                [1.0 / p if x == prev
                                 else (1.0 if x in adj_sets[prev]
                                       else 1.0 / q)
                                 for x in nbrs])
                            w = alpha * wlists[v]
                            w = w / w.sum()
                        else:  # first-order: precomputed distribution
                            w = probs[v]
                        nxt = int(nbrs[rng.choice(len(nbrs), p=w)])
                    prev, v = v, nxt
                    walk.append(v)
                walks.append(" ".join(map(str, walk)))
        return walks

    def fit(self, graph, walkLength=40, walksPerVertex=10, iterations=5,
            device=None, draws=None):
        """Walk on the host, then train on `device` (default: the
        Builder's, else the card); `draws` as Word2Vec.fit's."""
        self._n = graph.numVertices()
        rng = np.random.RandomState(self.seed)
        t = time.perf_counter()
        walks = self._walks(graph, int(walkLength), int(walksPerVertex), rng)
        self.walkSeconds = time.perf_counter() - t
        self._w2v = Word2Vec(
            iterator=CollectionSentenceIterator(walks),
            tokenizer=_IdentityTokenizer(),
            minWordFrequency=1, layerSize=self.vectorSize,
            windowSize=self.windowSize, negative=5, seed=self.seed,
            iterations=int(iterations), learningRate=self.learningRate,
            device=device if device is not None else self.device,
        ).fit(draws=draws)
        return self

    # ---- query API (reference: DeepWalk/GraphVectors methods) ----
    def _require_fit(self):
        if self._w2v is None:
            raise RuntimeError("call fit() first")

    def _check_vertex(self, v):
        if not (0 <= int(v) < self._n):
            raise ValueError(f"vertex {v} outside [0,{self._n})")

    def getVertexVector(self, v: int):
        self._require_fit()
        self._check_vertex(v)
        return self._w2v.getWordVector(str(int(v)))

    def similarity(self, a: int, b: int) -> float:
        self._require_fit()
        self._check_vertex(a)
        self._check_vertex(b)
        return self._w2v.similarity(str(int(a)), str(int(b)))

    def verticesNearest(self, v: int, top: int = 10):
        self._require_fit()
        self._check_vertex(v)
        return [int(w) for w in self._w2v.wordsNearest(str(int(v)), top)]

    def embeddings(self) -> np.ndarray:
        """[numVertices, vectorSize] embedding matrix, row i = vertex i
        (every vertex is in the vocabulary: each walk round starts a walk
        at every vertex and minWordFrequency is 1)."""
        self._require_fit()
        W = self._w2v._matrix()
        return W[[self._w2v.vocab[str(v)] for v in range(self._n)]]

    def _rows(self, E, mesh):
        """E row-sharded over `mesh`'s data axis (never padded: the vertex
        count must divide it), on the mesh's card under NCCL, else the
        fit's device."""
        from deeplearning4j_tpu_torch.linalg import (DistributedMatrix,
                                                     ROW_AXIS)

        dev = mesh.device if mesh.device is not None \
            else self._w2v._device(None)
        return DistributedMatrix(E, mesh, row_axis=ROW_AXIS, device=dev)

    def embeddingGram(self, mesh=None) -> np.ndarray:
        """E^T E [vectorSize, vectorSize] of the vertex embeddings. With a
        `mesh` the reduction runs over row-sharded embeddings
        (``linalg.gram``: one all-reduce over the data axis); without, a
        local product."""
        E = self.embeddings()
        if mesh is None:
            return E.T @ E
        from deeplearning4j_tpu_torch import linalg

        return linalg.gram(self._rows(E, mesh)).toNumpy()

    def similarityMatrix(self, mesh=None) -> np.ndarray:
        """All-pairs cosine similarity [n, n] of the vertex embeddings.
        With a `mesh`: ``linalg.matmul(transpose_b=True)`` (rows sharded,
        one all-gather of the normalised embeddings), gathered to the
        host."""
        E = self.embeddings()
        En = E / np.maximum(np.linalg.norm(E, axis=1, keepdims=True),
                            1e-12)
        if mesh is None:
            return En @ En.T
        from deeplearning4j_tpu_torch import linalg

        dE = self._rows(En, mesh)
        return linalg.matmul(dE, dE, transpose_b=True).toNumpy()
