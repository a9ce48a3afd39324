"""DeepWalk and t-SNE against the reference.

DeepWalk's walks draw from the same ``np.random.RandomState`` and are
the reference's, bitwise (uniform, weighted and node2vec-biased); the
embedding under the reference's draws lies within 2e-5 of its max-abs.
t-SNE's P (dense and kNN-sparse) is bitwise; exact and tiled runs under
the reference's Y0 lie within 1e-4 of their max-abs after 10 iterations.
Beyond that an f32 t-SNE amplifies a rounding difference by roughly 10x
every few iterations under early exaggeration (the reference's exact and
tiled paths part the same way), so a longer trajectory is held to the
clusters it must keep apart, not to the digit.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as JG
import deeplearning4j_tpu.plot as JP
import deeplearning4j_tpu_torch.graph as PG
import deeplearning4j_tpu_torch.plot as PP
from _torch_nlp_draws import RefDraws, max_abs_rel
from deeplearning4j_tpu.plot.tsne import _p_conditional as j_pc
from deeplearning4j_tpu.plot.tsne import _p_sparse as j_ps
from deeplearning4j_tpu_torch.plot.tsne import _p_conditional as p_pc
from deeplearning4j_tpu_torch.plot.tsne import _p_sparse as p_ps

torch.set_num_threads(2)


def _graphs(n=40, weighted=False):
    out = []
    for M in (PG, JG):
        g = M.Graph(n)
        for i in range(n):
            for j, w in ((1, 1.0), (3, 2.0), (11, 0.5)):
                g.addEdge(i, (i + j) % n, weight=w if weighted else 1.0)
        out.append(g)
    return out


@pytest.mark.parametrize("weighted,p,q", [(False, 1.0, 1.0),
                                          (True, 1.0, 1.0),
                                          (False, 0.5, 2.0)],
                         ids=["uniform", "weighted", "node2vec"])
def test_walks_bitwise(weighted, p, q):
    gp, gj = _graphs(weighted=weighted)
    dp = PG.DeepWalk.Builder().returnParam(p).inOutParam(q).seed(4).build()
    dj = JG.DeepWalk.Builder().returnParam(p).inOutParam(q).seed(4).build()
    assert dp._walks(gp, 12, 3, np.random.RandomState(4)) == \
        dj._walks(gj, 12, 3, np.random.RandomState(4))


def test_deepwalk_matches_the_reference():
    gp, gj = _graphs()
    dp = PG.DeepWalk.Builder().vectorSize(8).windowSize(3).seed(4).build()
    dj = JG.DeepWalk.Builder().vectorSize(8).windowSize(3).seed(4).build()
    dj.fit(gj, walkLength=10, walksPerVertex=2, iterations=2)
    dp.fit(gp, walkLength=10, walksPerVertex=2, iterations=2, device="cpu",
           draws=RefDraws(4))
    assert dp.walkSeconds >= 0
    assert max_abs_rel(dp.embeddings(), dj.embeddings()) < 2e-5
    assert dp.verticesNearest(3, 5) == dj.verticesNearest(3, 5)
    assert dp.similarity(1, 2) == pytest.approx(dj.similarity(1, 2),
                                                rel=1e-4)
    np.testing.assert_allclose(dp.embeddingGram(), dj.embeddingGram(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dp.similarityMatrix(), dj.similarityMatrix(),
                               atol=1e-4)
    # the linalg products on a one-rank mesh: the local products
    from deeplearning4j_tpu_torch.parallel import build_mesh

    np.testing.assert_allclose(dp.embeddingGram(mesh=build_mesh()),
                               dp.embeddingGram(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dp.similarityMatrix(mesh=build_mesh()),
                               dp.similarityMatrix(), atol=1e-6)
    with pytest.raises(ValueError, match="outside"):
        dp.getVertexVector(99)


def test_graph_loader(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("# comment\n0 1\n1 2 2.5\n\n3,0\n".replace(",", " "))
    gp = PG.GraphLoader.loadWeightedEdgeListFile(path)
    gj = JG.GraphLoader.loadWeightedEdgeListFile(path)
    for v in range(4):
        assert gp.getConnectedVertices(v) == gj.getConnectedVertices(v)
        assert gp.getEdgeWeights(v) == gj.getEdgeWeights(v)
    bad = tmp_path / "bad.txt"
    bad.write_text("0 1 2 3\n")
    with pytest.raises(ValueError, match="expected"):
        PG.GraphLoader.loadUndirectedGraphEdgeListFile(bad)


def _clusters(n_per=20, d=5, k=3, seed=0):
    rs = np.random.RandomState(seed)
    X = np.concatenate([rs.randn(n_per, d) + 8 * i for i in range(k)])
    return X.astype(np.float32), np.repeat(np.arange(k), n_per)


def test_affinities_bitwise():
    X, _ = _clusters()
    np.testing.assert_array_equal(p_pc(X, 12.0), j_pc(X, 12.0))
    for k in (10, 59):
        for a, b in zip(p_ps(X, 12.0, k, block=16), j_ps(X, 12.0, k,
                                                        block=16)):
            np.testing.assert_array_equal(a, b)


def _tsne(M, method, iters, **kw):
    b = (M.BarnesHutTsne.Builder().setMaxIter(iters).perplexity(10)
         .learningRate(100.0).seed(5).method(method))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


@pytest.mark.parametrize("method,kw", [("exact", {}),
                                       ("tiled", {"knnK": 40,
                                                  "tileSize": 16})],
                         ids=["exact", "tiled"])
def test_tsne_matches_the_reference(method, kw):
    X, _ = _clusters()
    want = _tsne(JP, method, 10, **kw).fit(X).getData()
    m = _tsne(PP, method, 10, **kw)
    got = m.fit(X, device="cpu", draws=RefDraws(5)).getData()
    assert m.usedMethod == method
    assert max_abs_rel(got, want) < 1e-4


def test_tiled_with_full_k_is_exact():
    X, _ = _clusters()
    a = _tsne(PP, "exact", 10).fit(X, device="cpu").getData()
    b = _tsne(PP, "tiled", 10, knnK=59, tileSize=16).fit(
        X, device="cpu").getData()
    assert max_abs_rel(b, a) < 1e-4


def test_long_run_separates_clusters_and_continues(tmp_path):
    X, lab = _clusters()
    m = _tsne(PP, "tiled", 250, knnK=30, tileSize=32)
    Y = m.fit(X, device="cpu").getData()
    cent = np.stack([Y[lab == c].mean(0) for c in range(3)])
    spread = max(np.linalg.norm(Y[lab == c] - cent[c], axis=1).mean()
                 for c in range(3))
    gap = min(np.linalg.norm(cent[a] - cent[b])
              for a in range(3) for b in range(a + 1, 3))
    assert gap > 2 * spread
    # a reference trajectory continues from its Y and momentum
    j = _tsne(JP, "exact", 10).fit(X).getData()
    cont = _tsne(PP, "exact", 5).load_reference_params(j, iteration=10)
    Y2 = cont.fit(X, device="cpu").getData()
    assert Y2.shape == j.shape and not np.array_equal(Y2, j)
    path = tmp_path / "t.csv"
    m.saveAsFile([str(c) for c in lab], str(path))
    rows = path.read_text().splitlines()
    assert len(rows) == len(lab) and rows[0].endswith(",0")


def test_tsne_refusals():
    X, _ = _clusters(n_per=5)
    with pytest.raises(ValueError, match="perplexity"):
        _tsne(PP, "exact", 5).fit(X, device="cpu")
    with pytest.raises(ValueError, match="auto/exact/tiled"):
        PP.BarnesHutTsne(method="bh")
    with pytest.raises(RuntimeError, match="fit"):
        PP.BarnesHutTsne().getData()
    if not torch.cuda.is_available():
        X, _ = _clusters()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _tsne(PP, "exact", 5).fit(X)
