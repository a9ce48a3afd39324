"""The port's clustering and nearest-neighbour stack against the
reference: k-means under the reference's first centre (assignments
equal, centres within 1e-5 of their max-abs), the trees node for node,
LSH under the reference's projection (codes, buckets and searches
equal), brute-force k-NN, and the NearestNeighborsServer over HTTP,
mirroring tests/test_serving.py::TestNearestNeighborsServer."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.clustering as J
import deeplearning4j_tpu_torch.clustering as P
from _torch_nlp_draws import RefDraws, max_abs_rel

torch.set_num_threads(2)


def _blobs(k=5, per=40, d=6, seed=0, spread=4.0):
    rs = np.random.RandomState(seed)
    centres = rs.randn(k, d) * spread + 50.0   # far from the origin
    return np.concatenate([rs.randn(per, d) + c for c in centres]).astype(
        np.float32)


@pytest.mark.parametrize("k,seed", [(5, 3), (8, 11), (1, 0)])
def test_kmeans_matches_the_reference(k, seed):
    X = _blobs()
    want = J.KMeansClustering.setup(k, 60, seed=seed).applyTo(X)
    km = P.KMeansClustering.setup(k, 60, seed=seed)
    got = km.applyTo(X, device="cpu", draws=RefDraws(seed))
    np.testing.assert_array_equal(got.getAssignments(),
                                  want.getAssignments())
    assert max_abs_rel(got.getCenters(), want.getCenters()) < 1e-5
    assert got.inertia == pytest.approx(want.inertia, rel=1e-5)
    assert 1 <= km.iterations <= 60
    assert km.hostFlagReads == max(km.iterations - 1, 0) or \
        km.iterations == 60
    p = X[7] + 0.01
    assert got.classifyPoint(p) == want.classifyPoint(p)


def test_kmeans_empty_cluster_reseeds_to_distinct_points():
    """Duplicate rows force empty clusters; slot i takes the i-th
    farthest point, as the reference."""
    X = np.concatenate([np.zeros((30, 3)), np.ones((2, 3)) * 5,
                        np.eye(3) * 9]).astype(np.float32)
    want = J.KMeansClustering.setup(6, 20, seed=1).applyTo(X)
    got = P.KMeansClustering.setup(6, 20, seed=1).applyTo(
        X, device="cpu", draws=RefDraws(1))
    np.testing.assert_array_equal(got.getAssignments(),
                                  want.getAssignments())
    np.testing.assert_allclose(got.getCenters(), want.getCenters(),
                               atol=1e-5)


def test_kmeans_reference_centres_and_refusals():
    X = _blobs()
    want = J.KMeansClustering.setup(5, 60, seed=3).applyTo(X)
    km = P.KMeansClustering.setup(5, 60).load_reference_params(
        want.getCenters())
    got = km.applyTo(X, device="cpu")
    np.testing.assert_array_equal(got.getAssignments(),
                                  want.getAssignments())
    # a fixed point: the second step sees no assignment change
    assert km.iterations == 2 and km.hostFlagReads == 1
    # the mesh-sharded Lloyd on a one-rank mesh: the same fixed point
    from deeplearning4j_tpu_torch.parallel import build_mesh

    sharded = P.KMeansClustering.setup(5, 60, mesh=build_mesh()) \
        .load_reference_params(want.getCenters()).applyTo(X, device="cpu")
    np.testing.assert_array_equal(sharded.getAssignments(),
                                  want.getAssignments())
    assert sharded.inertia == pytest.approx(got.inertia, rel=1e-5)
    with pytest.raises(ValueError, match="cannot form"):
        P.KMeansClustering(500).applyTo(X, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        P.KMeansClustering(3, distanceFunction="cosine")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.KMeansClustering(3).applyTo(X)


def test_nearest_neighbors_brute_force():
    X = _blobs(d=5)
    q = np.random.RandomState(4).randn(7, 5).astype(np.float32) + 50
    pi, pd = P.NearestNeighbors(X, device="cpu").search(q, 6)
    ji, jd = J.NearestNeighbors(X).search(q, 6)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(pd, np.asarray(jd), rtol=1e-4)
    one_i, _ = P.NearestNeighbors(X, device="cpu").search(q[0], 3)
    np.testing.assert_array_equal(one_i, pi[0, :3])


def test_trees_node_for_node():
    X = np.random.RandomState(0).randn(300, 4)
    X[100:140] = X[5]                       # ties
    pt, jt = P.VPTree(X, seed=3), J.VPTree(X, seed=3)
    assert len(pt._nodes) == len(jt._nodes)
    for q in np.random.RandomState(1).randn(12, 4):
        pi, pd = pt.search(q, 7)
        ji, jd = jt.search(q, 7)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pd, jd)
        assert pt._scanned == jt._scanned
        brute = np.argsort(np.linalg.norm(X - q, axis=1), kind="stable")[:7]
        np.testing.assert_allclose(pd, np.linalg.norm(X[brute] - q, axis=1))
    pk, jk = P.KDTree(4), J.KDTree(4)
    for row in X[:120]:
        assert pk.insert(row) == jk.insert(row)
    q = X[3] + 0.05
    assert pk.nn(q) == jk.nn(q)
    for a, b in zip(pk.knn(q, 1.5), jk.knn(q, 1.5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L,T,seed", [(8, 4, 2), (16, 3, 5), (62, 1, 0)])
def test_lsh_matches_the_reference(L, T, seed):
    X = _blobs(d=12, per=30)
    j = J.RandomProjectionLSH(L, T, 12, seed=seed).index(X)
    p = P.RandomProjectionLSH(L, T, 12, seed=seed).index(
        X, device="cpu", draws=RefDraws(seed))
    np.testing.assert_array_equal(p._R.numpy(), np.asarray(j._R))
    for tp, tj in zip(p._tables, j._tables):
        assert sorted(tp) == sorted(tj)
        for code, rows in tj.items():
            np.testing.assert_array_equal(tp[code], rows)
    # the f32 quadratic form loses ~eps |x|^2 of a squared distance
    scale = float(np.max(np.sum((X - X.mean(0)) ** 2, 1)))
    for q in X[:10] + 0.05:
        np.testing.assert_array_equal(p.bucket(q), j.bucket(q))
        pi, pd = p.search(q, 5)
        ji, jd = j.search(q, 5)
        np.testing.assert_array_equal(pi, np.asarray(ji))
        np.testing.assert_allclose(pd ** 2, np.asarray(jd) ** 2,
                                   atol=1e-5 * scale)


def test_lsh_reference_projection_and_refusals():
    X = _blobs(d=8, per=10)
    j = J.RandomProjectionLSH(6, 3, 8, seed=9).index(X)
    p = P.RandomProjectionLSH(6, 3, 8).load_reference_params(
        np.asarray(j._R)).index(X, device="cpu")
    assert [sorted(t) for t in p._tables] == [sorted(t) for t in j._tables]
    with pytest.raises(ValueError, match="shape"):
        P.RandomProjectionLSH(6, 3, 8).load_reference_params(np.zeros((2, 2)))
    # the distributed projection on a one-rank mesh: the same tables
    from deeplearning4j_tpu_torch.parallel import build_mesh

    d = P.RandomProjectionLSH(6, 3, 8, mesh=build_mesh()) \
        .load_reference_params(np.asarray(j._R)).index(X, device="cpu")
    assert [sorted(t) for t in d._tables] == [sorted(t) for t in j._tables]
    with pytest.raises(ValueError, match="needs a mesh"):
        P.RandomProjectionLSH(6, 3, 8).index(X, device="cpu",
                                             distributed=True)
    with pytest.raises(ValueError, match="62"):
        P.RandomProjectionLSH(63, 1, 8)
    with pytest.raises(ValueError, match="before index"):
        P.RandomProjectionLSH(6, 3, 8).search(X[0], 2)


# ----------------------------------------------------------------------
# NearestNeighborsServer over HTTP
# ----------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _corpus(n=64, d=8):
    return np.random.RandomState(0).randn(n, d)


@pytest.fixture
def served():
    servers = []

    def start(**kw):
        srv = P.NearestNeighborsServer(**kw).start(port=0)
        servers.append(srv)
        return f"http://127.0.0.1:{srv.port}"

    yield start
    for s in servers:
        s.stop()


def test_server_knnnew_matches_bruteforce(served):
    X = _corpus()
    base = served(points=X)
    q = np.random.RandomState(1).randn(8)
    status, resp = _post(base + "/knnnew", {"point": q.tolist(), "k": 5})
    assert status == 200 and len(resp["results"]) == 5
    got = [r["index"] for r in resp["results"]]
    assert got == np.argsort(np.linalg.norm(X - q, axis=1))[:5].tolist()
    dists = [r["distance"] for r in resp["results"]]
    assert dists == sorted(dists)
    want = J.NearestNeighborsServer(points=X).knnNew(q, 5)
    assert resp["results"] == want


def test_server_knn_excludes_self(served):
    X = _corpus()
    base = served(points=X)
    status, resp = _post(base + "/knn", {"index": 3, "k": 4})
    idxs = [r["index"] for r in resp["results"]]
    assert status == 200 and 3 not in idxs
    assert idxs == np.argsort(np.linalg.norm(X - X[3], axis=1))[1:5].tolist()


def test_server_status_errors_and_readiness(served):
    base = served(points=_corpus(n=16, d=4))
    status, body = _get(base + "/status")
    assert json.loads(body) == {"numPoints": 16, "dims": 4, "index": "VPTree"}
    assert _get(base + "/healthz")[0] == 200
    for body, what in (({"point": [1.0, 2.0], "k": 3}, "dims"),
                       ({"k": 3}, None), ([1, 2, 3], "object")):
        path = "/knn" if body == {"k": 3} else "/knnnew"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + path, body)
        assert ei.value.code == 400
        if what:
            assert what in json.loads(ei.value.read().decode())["error"]
    for bad in ("/nope",):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + bad)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + bad, {})
        assert ei.value.code == 404


def test_server_lsh_index_and_deadline(served):
    X = _corpus(n=128, d=16).astype(np.float32)
    lsh = P.RandomProjectionLSH(hashLength=4, numTables=6, inDimension=16)
    lsh.index(X, device="cpu", draws=RefDraws(0))
    srv = P.NearestNeighborsServer(index=lsh, corpus=X).start(
        port=0, requestDeadline=30.0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        _, resp = _post(base + "/knnnew", {"point": X[7].tolist(), "k": 3})
        assert resp["results"][0]["index"] == 7
        assert resp["results"][0]["distance"] < 1e-5
        st = json.loads(_get(base + "/status")[1])
        assert st == {"numPoints": 128, "dims": 16,
                      "index": "RandomProjectionLSH"}
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="exactly one"):
        P.NearestNeighborsServer()
    with pytest.raises(ValueError, match="corpus"):
        P.NearestNeighborsServer(index=lsh).knn(0, 2)
