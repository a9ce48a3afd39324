"""Distributed linear algebra: the port's ``linalg`` (deeplearning4j_tpu_torch/
linalg/) against the reference's (deeplearning4j_tpu/linalg/), class for
class with the reference's tests/test_linalg.py.

The reference runs on the first four devices of its virtual CPU mesh,
``{data: 2, model: 2}`` and ``{data: 4}``; the port on four gloo ranks,
one launch (``parallel.launch``; rank body ``linalg_rank`` in
tests/_torch_parallel_ranks.py, started in a thread while this process
computes the reference's answers). The inputs are numpy draws from seeds,
in f64 and in f32; rsvd and pca take the reference's sketch Omega
(``FixedDraws``), since the port draws its own from a torch generator.
The refusals, the retrace contract, the plan gate and the CLI run in this
process on one-rank meshes, or on a rank-0 view of a larger mesh whose
groups have no process group (placement reads only the mesh's shape).

Bands: f64 within 1e-10 of the reference's, relative to the largest
magnitude of the answer (the two sum in different orders); f32 at the
reference test's own bars against numpy.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import linalg as J
from deeplearning4j_tpu.clustering import KMeansClustering as JKMeans
from deeplearning4j_tpu.clustering.lsh import \
    RandomProjectionLSH as JRandomProjectionLSH
from deeplearning4j_tpu.parallel import build_mesh as jmesh

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch import linalg as P
from deeplearning4j_tpu_torch.parallel import build_mesh, launch
from deeplearning4j_tpu_torch.parallel.mesh import DataGroup, mesh_from_grid

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0
F64 = 1e-10
BAR = dict(rtol=2e-5, atol=1e-4)      # the reference test's matmul bar
CPU = "cpu"


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


def _inputs():
    rng3, rng4 = np.random.RandomState(3), np.random.RandomState(4)
    return {
        "A1": _rand((16, 24), 1), "B1": _rand((24, 8), 2),
        "A2": _rand((16, 6), 7), "B2": _rand((16, 4), 8),
        "A3": _rand((16, 8), 19), "B3": _rand((8, 4), 20),
        "A4": _rand((16, 6), 9), "A5": _rand((32, 5), 10) + 7.0,
        "A6": _rand((16, 4), 11), "B6": _rand((5, 4), 12),
        "A7": _rand((64, 6), 13), "b7": _rand((64,), 14),
        "A8": _rand((16, 4), 15), "B8": _rand((16, 3), 16),
        "A9": rng3.randn(64, 5) @ rng3.randn(5, 16)
        + 1e-3 * rng3.randn(64, 16),
        "A10": rng4.randn(64, 4) @ rng4.randn(4, 12) + 5.0
        + 1e-3 * rng4.randn(64, 12),
    }


def _omega(d, l_, dtype):
    return np.asarray(jax.random.normal(jax.random.key(0), (d, l_), dtype))


def _kmeans_X():
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(32, 4) + c
                        for c in (0, 10, 20)]).astype(np.float32)
    return X[rng.permutation(96)]


def _data():
    return {"inputs": _inputs(),
            "omega9": {"f64": _omega(16, 13, jnp.float64),
                       "f32": _omega(16, 13, jnp.float32)},
            "omega10": {"f64": _omega(12, 11, jnp.float64),
                        "f32": _omega(12, 11, jnp.float32)},
            "kmeans_X": _kmeans_X(),
            "kmeans_first": int(jax.random.randint(jax.random.key(1), (), 0,
                                                   96)),
            "lsh_X": _rand((64, 6), 17).astype(np.float32),
            "lsh_R": np.asarray(JRandomProjectionLSH(10, 3, 6, seed=2)._R)}


def _reference(data):
    """The reference's answers in f64 on the first four devices."""
    devs = jax.devices()[:4]
    m22 = jmesh({"data": 2, "model": 2}, devs)
    m4 = jmesh({"data": 4}, devs)
    g = data["inputs"]
    D, M = "data", "model"

    def dm(a, mesh, r=D, c=None):
        return J.DistributedMatrix(jnp.asarray(a), mesh, row_axis=r,
                                   col_axis=c)

    out = {
        "summa2d": J.matmul(dm(g["A1"], m22, D, M),
                            dm(g["B1"], m22, D, M)).toNumpy(),
        "summa1d": J.matmul(dm(g["A1"], m4), dm(g["B1"], m4)).toNumpy(),
        "replb1d": J.matmul(dm(g["A1"], m4), g["B1"]).toNumpy(),
        "replb2d": J.matmul(dm(g["A1"], m22, D, M), g["B1"]).toNumpy(),
        "ta": J.matmul(dm(g["A2"], m4), dm(g["B2"], m4),
                       transpose_a=True).toNumpy(),
        "tb": J.matmul(dm(g["A2"], m4), dm(g["A2"], m4),
                       transpose_b=True).toNumpy(),
        "repl_dm": J.matmul(dm(g["A3"], m4),
                            dm(g["B3"], m4, None)).toNumpy(),
        "gram1d": J.gram(dm(g["A4"], m4)).toNumpy(),
        "gram2d": J.gram(dm(g["A4"], m22, D, M)).toNumpy(),
        "cov": J.covariance(dm(g["A5"], m4)).toNumpy(),
        "pairwise": J.pairwise_sq_dists(dm(g["A6"], m4),
                                        g["B6"]).toNumpy(),
    }
    for name, a, b, kw in (("lstsq", dm(g["A7"], m4), g["b7"], {}),
                           ("ridge", dm(g["A7"], m4), g["b7"], {"l2": 0.5}),
                           ("multi", dm(g["A8"], m22, D, M), g["B8"], {})):
        r = J.lstsq(a, b, tol=1e-7, **kw)
        out[name] = (np.asarray(r.x), int(r.iterations), bool(r.converged))
    U, s, Vt = J.rsvd(dm(g["A9"], m4), 5, n_iter=4)
    out["rsvd"] = (U.toNumpy(), np.asarray(s), np.asarray(Vt))
    comps, ev, mu = J.pca(dm(g["A10"], m4), 3)
    out["pca"] = (np.asarray(comps), np.asarray(ev), np.asarray(mu))
    c = JKMeans.setup(3, seed=1, mesh=m4).applyTo(data["kmeans_X"])
    out["kmeans"] = (c.getAssignments(), c.inertia)
    lsh = JRandomProjectionLSH(10, 3, 6, seed=2, mesh=m4).index(
        data["lsh_X"])
    out["lsh"] = ([sorted(t) for t in lsh._tables],
                  lsh.search(data["lsh_X"][7], 5))
    return out


@pytest.fixture(scope="module")
def both():
    """(rank results, the reference's answers, the inputs): the ranks run
    in a thread while the reference computes."""
    data = _data()
    box = {}

    def run():
        try:
            box["ranks"] = launch(R.linalg_rank, 4, device=CPU,
                                  timeout=LAUNCH_TIMEOUT, args=(data,))
        except BaseException as e:      # re-raised in the test thread
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    ref = _reference(data)
    t.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], ref, data


def close64(got, want):
    """f64 parity: within F64 of the answer's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= F64 * scale, \
        np.abs(got - want).max() / scale


def fake_mesh(axes):
    """Rank 0's view of a mesh of `axes` with no process group: placement
    and its refusals read only the shape."""
    sizes = list(axes.values())
    world = DataGroup(0, int(np.prod(sizes)))
    if list(axes) == ["data"]:
        return world
    return mesh_from_grid(np.arange(world.size).reshape(sizes), list(axes),
                          world)


def _f32(a):
    return np.asarray(a, np.float32)


# ----------------------------------------------------------------------
# TestDistributedMatrix
# ----------------------------------------------------------------------

class TestDistributedMatrix:
    def test_block_placement_and_metadata(self, both):
        ranks, _, data = both
        A = _f32(data["inputs"]["A1"])
        for r in ranks:
            p = r["placement"]
            assert p["block_shape"] == (8, 12)
            assert p["per_chip_bytes"] == 8 * 12 * 4
            np.testing.assert_array_equal(p["whole"], A)
            i, j = p["coords"]["data"], p["coords"]["model"]
            np.testing.assert_array_equal(
                p["block"], A[8 * i:8 * (i + 1), 12 * j:12 * (j + 1)])

    def test_never_pad_divisibility_contract(self):
        # the reference's words, refusal for refusal
        jm8 = jmesh({"data": 8})
        jm42 = jmesh({"data": 4, "model": 2})
        pm8, pm42 = fake_mesh({"data": 8}), fake_mesh({"data": 4,
                                                       "model": 2})
        cases = ((_rand((10, 4)), "data", None, jm8, pm8),
                 (_rand((16, 3)), "data", "model", jm42, pm42),
                 (_rand((16, 4)), "nope", None, jm8, pm8))
        for a, r, c, jm, pm in cases:
            with pytest.raises(ValueError) as want:
                J.DistributedMatrix(a, jm, row_axis=r, col_axis=c)
            with pytest.raises(ValueError) as got:
                P.DistributedMatrix(a, pm, row_axis=r, col_axis=c,
                                    device=CPU)
            assert str(got.value) == str(want.value)
        dA = P.DistributedMatrix(_rand((16, 8)), pm8, device=CPU)
        dB = P.DistributedMatrix(_rand((16, 4)), pm8, device=CPU)
        with pytest.raises(ValueError, match="shape mismatch"):
            P.matmul(dA, dB)
        with pytest.raises(ValueError, match="both 'data'"):
            P.DistributedMatrix(_rand((16, 4)), pm42, row_axis="data",
                                col_axis="data", device=CPU)

    def test_indarray_distribute_entry_point(self, both):
        ranks, _, data = both
        A = _f32(data["inputs"]["A4"])
        got = ranks[0]["placement"]["distribute_gram"]
        assert got.shape == (6, 6)
        np.testing.assert_allclose(got, A.T @ A, rtol=2e-5, atol=2e-4)

    def test_replicate_roundtrip(self, both):
        ranks, _, data = both
        for r in ranks:
            assert r["placement"]["replicated"]
            np.testing.assert_array_equal(r["placement"]["replicate"],
                                          _f32(data["inputs"]["A2"]))

    def test_a_tensor_on_the_device_is_not_copied(self):
        t = torch.arange(12.0).reshape(6, 2)
        dm = P.DistributedMatrix(t, build_mesh())
        assert dm.tensor().data_ptr() == t.data_ptr()
        assert dm.device == t.device and dm.spec == ("data", None)
        if not torch.cuda.is_available():   # no fallback: the CPU is asked for
            with pytest.raises(RuntimeError, match="device='cpu'"):
                P.DistributedMatrix(np.ones((2, 2)), build_mesh())


# ----------------------------------------------------------------------
# TestMatmulParity (f64 against the reference, f32 against numpy)
# ----------------------------------------------------------------------

_MATMULS = {
    "summa2d": lambda g: g["A1"] @ g["B1"],
    "summa1d": lambda g: g["A1"] @ g["B1"],
    "replb1d": lambda g: g["A1"] @ g["B1"],
    "replb2d": lambda g: g["A1"] @ g["B1"],
    "ta": lambda g: g["A2"].T @ g["B2"],
    "tb": lambda g: g["A2"] @ g["A2"].T,
    "repl_dm": lambda g: g["A3"] @ g["B3"],
}


class TestMatmulParity:
    @pytest.mark.parametrize("name", sorted(_MATMULS))
    def test_f64_equals_the_reference(self, both, name):
        ranks, ref, _ = both
        for r in ranks:
            close64(r["f64"][name], ref[name])

    @pytest.mark.parametrize("name", sorted(_MATMULS))
    def test_f32_against_numpy(self, both, name):
        ranks, _, data = both
        g = {k: _f32(v) for k, v in data["inputs"].items()}
        np.testing.assert_allclose(ranks[0]["f32"][name], _MATMULS[name](g),
                                   **BAR)

    def test_layouts_of_the_results(self, both):
        r = both[0][0]["f32"]
        assert r["summa2d_spec"] == ("data", "model")
        assert r["ta_replicated"] and r["tb_row_axis"] == "data"
        assert r["repl_dm_row_axis"] == "data"

    def test_refusals(self):
        pm = fake_mesh({"data": 4, "model": 2})
        dA = P.DistributedMatrix(_rand((16, 8)), pm, "data", "model",
                                 device=CPU)
        dB = P.DistributedMatrix(_rand((8, 4)), pm, "data", device=CPU)
        with pytest.raises(ValueError, match="same layout"):
            P.matmul(dA, dB)
        with pytest.raises(ValueError, match="transpose_a and transpose_b"):
            P.matmul(dA, dA, transpose_a=True, transpose_b=True)
        dC = P.DistributedMatrix(_rand((8, 8)), pm, row_axis=None,
                                 col_axis="model", device=CPU)
        with pytest.raises(ValueError, match="column-only"):
            P.matmul(dC, dC)
        with pytest.raises(TypeError, match="DistributedMatrix"):
            P.matmul(_rand((2, 2)), dB)


# ----------------------------------------------------------------------
# TestGramCovariancePairwise
# ----------------------------------------------------------------------

class TestGramCovariancePairwise:
    @pytest.mark.parametrize("name", ["gram1d", "gram2d", "cov",
                                      "pairwise"])
    def test_f64_equals_the_reference(self, both, name):
        ranks, ref, _ = both
        close64(ranks[0]["f64"][name], ref[name])

    def test_row_reductions_in_chunks(self, monkeypatch):
        # a reduction over more rows than ROW_CHUNK sums chunk products
        # in place: the same answer (port-only: f32 accuracy at 2^23 rows)
        from deeplearning4j_tpu_torch.linalg import distributed as LD

        monkeypatch.setattr(LD, "ROW_CHUNK", 5)
        A, b = _rand((23, 4), 30), _rand((23,), 31)
        dA = P.DistributedMatrix(A, build_mesh(), device=CPU)
        close64(P.gram(dA).toNumpy(), A.T @ A)
        close64(P.covariance(dA).toNumpy(), np.cov(A, rowvar=False))
        close64(P.matmul(dA, dA, transpose_a=True).toNumpy(), A.T @ A)
        close64(P.lstsq(dA, b, tol=1e-12).x.numpy(),
                np.linalg.lstsq(A, b, rcond=None)[0])

    def test_f32_against_numpy(self, both):
        ranks, _, data = both
        g = {k: _f32(v) for k, v in data["inputs"].items()}
        r = ranks[0]["f32"]
        for name in ("gram1d", "gram2d"):
            np.testing.assert_allclose(r[name], g["A4"].T @ g["A4"],
                                       rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(r["cov"], np.cov(g["A5"], rowvar=False),
                                   rtol=1e-4, atol=1e-5)
        want = ((g["A6"][:, None, :] - g["B6"][None]) ** 2).sum(-1)
        np.testing.assert_allclose(r["pairwise"], want, rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------------
# TestSolvers
# ----------------------------------------------------------------------

def _spd(n=12, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    return M @ M.T + 0.5 * np.eye(n), rng.randn(n)


class TestSolvers:
    def test_cg_plain_spd(self):
        M, b = _spd()
        want = J.cg(lambda x: jnp.asarray(M) @ x, jnp.asarray(b), tol=1e-8,
                    maxiter=200)
        Mt = torch.from_numpy(M)
        got = P.cg(lambda x: Mt @ x, torch.from_numpy(b), tol=1e-8,
                   maxiter=200)
        assert got.converged and got.iterations == int(want.iterations)
        close64(got.x, want.x)
        np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(M, b),
                                   rtol=1e-8, atol=1e-8)
        # both stop below the same threshold (the recurrence's last
        # residual is a cancellation: its digits are not comparable)
        thresh = 1e-8 * np.linalg.norm(b)
        assert got.residual_norm <= thresh
        assert float(want.residual_norm) <= thresh

    def test_cg_pytree_preconditioner_and_diagnostics(self):
        # a block-diagonal SPD operator over a dict and a list, with a
        # Jacobi preconditioner; non-convergence at maxiter 1 is reported
        w, v = _rand((6,), 1), _rand((3,), 2)

        def jmv(x):
            return {"w": 3.0 * x["w"], "v": 0.5 * x["v"]}

        def pmv(x):
            return [3.0 * x[0], 0.5 * x[1]]

        jb = {"w": jnp.asarray(w), "v": jnp.asarray(v)}
        pb = [torch.from_numpy(w), torch.from_numpy(v)]
        want = J.cg(jmv, jb, tol=1e-12, maxiter=50)
        got = P.cg(pmv, pb, tol=1e-12, maxiter=50)
        assert got.converged and got.iterations == int(want.iterations)
        close64(got.x[0], want.x["w"])
        close64(got.x[1], want.x["v"])
        d = P.cg(lambda x: {"w": 3.0 * x["w"]},
                 {"w": torch.from_numpy(w)}, tol=1e-12, maxiter=50,
                 M=lambda r: {"w": r["w"] / 3.0})
        assert d.iterations == 1 and d.converged
        np.testing.assert_allclose(d.x["w"].numpy(), w / 3.0, rtol=1e-12)
        bad = P.cg(pmv, pb, tol=1e-12, maxiter=1)
        assert not bad.converged
        assert bool(J.cg(jmv, jb, tol=1e-12, maxiter=1).converged) is False
        with pytest.raises(ValueError, match="maxiter"):
            P.cg(pmv, pb, maxiter=0)

    def test_cg_stops_at_negative_curvature(self):
        # stated deviation: p'Sp <= 0 stops the loop with the iterate so
        # far (an SPD operator never gives it)
        got = P.cg(lambda x: -x, torch.ones(3, dtype=torch.float64))
        assert got.iterations == 0 and not got.converged
        assert torch.equal(got.x, torch.zeros(3, dtype=torch.float64))

    @pytest.mark.parametrize("name", ["lstsq", "ridge", "multi"])
    def test_lstsq_f64_equals_the_reference(self, both, name):
        ranks, ref, _ = both
        x, iters, conv = ranks[0]["f64"][name]
        assert conv and ref[name][2]
        close64(x, ref[name][0])
        assert abs(iters - ref[name][1]) <= 1
        for r in ranks[1:]:   # every rank stops at the same iteration
            assert r["f64"][name][1] == iters
            np.testing.assert_array_equal(r["f64"][name][0], x)

    def test_lstsq_f32_against_numpy(self, both):
        ranks, _, data = both
        g = {k: _f32(v) for k, v in data["inputs"].items()}
        r = ranks[0]["f32"]
        bar = dict(rtol=1e-3, atol=1e-3)
        assert r["lstsq"][2] and r["ridge"][2] and r["multi"][2]
        np.testing.assert_allclose(
            r["lstsq"][0], np.linalg.lstsq(g["A7"], g["b7"], rcond=None)[0],
            **bar)
        A = g["A7"].astype(np.float64)
        ridge = np.linalg.solve(A.T @ A + 0.5 * np.eye(6), A.T @ g["b7"])
        np.testing.assert_allclose(r["ridge"][0], ridge, **bar)
        np.testing.assert_allclose(
            r["multi"][0], np.linalg.lstsq(g["A8"], g["B8"], rcond=None)[0],
            **bar)


# ----------------------------------------------------------------------
# TestRandomized
# ----------------------------------------------------------------------

def _projector(U):
    return U @ U.T


class TestRandomized:
    def test_rsvd_f64_equals_the_reference(self, both):
        ranks, ref, _ = both
        U, s, Vt = ranks[0]["f64"]["rsvd"]
        jU, js, jVt = ref["rsvd"]
        close64(s, js)
        close64(U @ np.diag(s) @ Vt, jU @ np.diag(js) @ jVt)
        close64(_projector(U), _projector(jU))

    def test_pca_f64_equals_the_reference(self, both):
        ranks, ref, _ = both
        comps, ev, mu = ranks[0]["f64"]["pca"]
        jc, jev, jmu = ref["pca"]
        close64(ev, jev)
        close64(mu, jmu)
        close64(comps.T @ comps, jc.T @ jc)

    def test_rsvd_and_pca_f32_against_numpy(self, both):
        ranks, _, data = both
        g = {k: _f32(v) for k, v in data["inputs"].items()}
        U, s, Vt = ranks[0]["f32"]["rsvd"]
        A = g["A9"]
        np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:5],
                                   rtol=1e-3)
        np.testing.assert_allclose(U @ np.diag(s) @ Vt, A, atol=0.05)
        np.testing.assert_allclose(U.T @ U, np.eye(5), atol=1e-3)
        comps, ev, mu = ranks[0]["f32"]["pca"]
        X = g["A10"]
        c = X - X.mean(0)
        s_ref = np.linalg.svd(c, compute_uv=False)[:3]
        np.testing.assert_allclose(ev, s_ref ** 2 / 63, rtol=1e-3)
        np.testing.assert_allclose(mu, X.mean(0), atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(c @ comps.T),
                                   np.linalg.norm(s_ref), rtol=1e-3)

    def test_rsvd_with_its_own_draws(self):
        # stated deviation: without the reference's Omega the port draws
        # its own (Philox on the card); the singular values and the
        # projector are held instead
        A = _inputs()["A9"]
        dA = P.DistributedMatrix(A, build_mesh(), device=CPU)
        U, s, Vt = P.rsvd(dA, 5, n_iter=4, seed=3)
        u, sv, vt = np.linalg.svd(A)
        np.testing.assert_allclose(s.numpy(), sv[:5], rtol=1e-9)
        np.testing.assert_allclose(_projector(U.toNumpy()),
                                   _projector(u[:, :5]), atol=1e-8)
        np.testing.assert_allclose(Vt.numpy().T @ Vt.numpy(),
                                   vt[:5].T @ vt[:5], atol=1e-8)


# ----------------------------------------------------------------------
# TestRetraceContract (one-rank meshes in this process)
# ----------------------------------------------------------------------

class TestRetraceContract:
    def test_one_capture_per_shape(self):
        from deeplearning4j_tpu_torch.analysis import RetraceSentinel

        mesh = build_mesh()
        sentinel = RetraceSentinel(max_compiles=2)
        P.install_retrace_sentinel(sentinel)
        try:
            dA = P.DistributedMatrix(_rand((16, 8)), mesh, device=CPU)
            dB = P.DistributedMatrix(_rand((8, 4)), mesh, device=CPU)
            for _ in range(3):
                P.matmul(dA, dB)
            assert sentinel.compiles("matmul1d") == 1
            dA2 = P.DistributedMatrix(_rand((32, 8)), mesh, device=CPU)
            P.matmul(dA2, dB)
            P.matmul(dA2, dB)
            assert sentinel.compiles("matmul1d") == 2
            for _ in range(2):
                P.gram(dA)
            assert sentinel.compiles("gram") == 1
        finally:
            P.install_retrace_sentinel(None)

    def test_precompile_shares_the_dispatch_body(self):
        mesh = build_mesh()
        P.precompile(mesh, 16, 8, 8, device=CPU)
        A, B = _rand((16, 8), 21), _rand((16, 4), 22)
        out = P.matmul(P.DistributedMatrix(A, mesh, device=CPU),
                       P.DistributedMatrix(B, mesh, device=CPU),
                       transpose_a=True)
        assert out.shape == (8, 4)
        np.testing.assert_allclose(out.toNumpy(), A.T @ B, rtol=1e-12)

    def test_pca_entry_keys_on_row_count(self):
        mesh = build_mesh()
        for rows, seed in ((32, 23), (64, 24)):
            X = _rand((rows, 8), seed) + 3.0
            _, _, mu = P.pca(P.DistributedMatrix(X, mesh, device=CPU), 2)
            np.testing.assert_allclose(mu.numpy(), X.mean(0), rtol=1e-12)

    def test_precompile_enforces_never_pad_contract(self):
        with pytest.raises(ValueError, match="refusing to silently pad"):
            P.precompile(fake_mesh({"data": 8}), 64, 6, 4, device=CPU)

    def test_precompile_statuses(self):
        # the reference's four entries; lstsq (CG reads its test on the
        # host) refuses capture, a stated deviation
        out = P.precompile(build_mesh(), 16, 8, 4, device=CPU)
        assert set(out) == {"matmul1d", "matmul_ta", "gram", "lstsq"}
        assert out["lstsq"] == ("refused", 0.0)
        for k in ("matmul1d", "matmul_ta", "gram"):
            assert out[k][0] in ("cold", "warm")

    def test_multi_rank_entries_refuse_capture(self, both):
        # stated deviation: on a multi-rank mesh every entry refuses
        # capture, and each dispatch counts the refusal
        from deeplearning4j_tpu_torch.linalg.distributed import \
            MULTI_RANK_REFUSAL

        for r in both[0]:
            p = r["placement"]
            assert set(p["precompile"].values()) == {("refused", 0.0)}
            assert p["refused_dispatches"] == 1
            assert p["refusal"] == MULTI_RANK_REFUSAL


# ----------------------------------------------------------------------
# TestPlanGate
# ----------------------------------------------------------------------

class TestPlanGate:
    def test_canonical_plans_clean_on_dp4xtp2(self):
        rep = P.validate_linalg_plan({"data": 4, "model": 2}, hbm_gb=16)
        assert rep.ok, [d.format() for d in rep.errors]
        assert "PAR04" not in rep.codes() and "COL01" not in rep.codes()
        bills = rep.plan["bills"]
        assert set(bills) == {"gemm_32k", "gram_tall", "rsvd_tall",
                              "lstsq_tall"}
        tall = bills["gram_tall"]
        assert tall["global_bytes"] > 16e9 > tall["per_chip_bytes"]
        assert P.CANONICAL_LINALG_PLANS == J.CANONICAL_LINALG_PLANS
        assert P.CANONICAL_LINALG_MESH == J.CANONICAL_LINALG_MESH

    @pytest.mark.parametrize("axes", [{"data": 4, "model": 2},
                                      {"data": 1, "model": 1},
                                      {"data": 4}])
    def test_bills_describe_the_ports_buffers(self, axes):
        # the reference's terms where the port holds the same buffers;
        # the port's own where it holds others (a stated deviation)
        rep = P.validate_linalg_plan(axes, check_sources=False)
        want = J.validate_linalg_plan(axes, check_sources=False)
        same = ("global_bytes", "a_block_bytes", "out_block_bytes",
                "gather_wire_bytes")
        for name, bill in rep.plan["bills"].items():
            ref = want.plan["bills"][name]
            for key in same:
                if key in ref and not (bill["op"] in ("rsvd", "lstsq")
                                       and key == "out_block_bytes"):
                    assert bill[key] == ref[key], (name, key)
            r, c = axes.get("data", 1), axes.get("model", 1)
            if name == "gemm_32k":
                a, g = bill["a_block_bytes"], bill["gathered_panel_bytes"]
                assert g == (ref["gathered_panel_bytes"] if r > 1 else 0)
                assert bill["ring_buffer_bytes"] == min(c - 1, 2) * a
                assert bill["per_chip_bytes"] == a + bill["b_block_bytes"] \
                    + max(2 * g, g + bill["out_block_bytes"]
                          + bill["ring_buffer_bytes"])
                assert bill["ring_wire_bytes"] == ref["ring_wire_bytes"]
            if name == "rsvd_tall":
                assert bill["sketch_block_bytes"] == \
                    2 * ref["sketch_block_bytes"]
        if axes == {"data": 1, "model": 1}:
            b = rep.plan["bills"]
            assert b["gemm_32k"]["per_chip_bytes"] == 3 * 32768 ** 2 * 4
            assert b["gram_tall"]["per_chip_bytes"] == \
                (2 ** 23 * 1024 + 1024 ** 2) * 4

    def test_per_chip_bytes_match_runtime_placement(self):
        from deeplearning4j_tpu_torch.linalg.plan import per_chip_parity

        dA = P.DistributedMatrix(_rand((16, 24)).astype(np.float32),
                                 fake_mesh({"data": 4, "model": 2}),
                                 "data", "model", device=CPU)
        bill = P.matmul_plan(16, 24, 8, {"data": 4, "model": 2})
        assert bill["a_block_bytes"] == dA.per_chip_bytes() == 4 * 12 * 4
        assert per_chip_parity(dA) == dA.per_chip_bytes()

    def test_plan_violations_reported(self):
        bad = ((({"data": 4}), {"name": "bad_axis", "op": "gram", "n": 64,
                                "d": 8, "col_axis": "model"}, None, "PAR01"),
               (({"data": 4}), {"name": "ragged", "op": "gram", "n": 63,
                                "d": 8}, None, "PAR03"),
               (({"data": 4}), {"name": "huge", "op": "gram",
                                "n": 2 ** 26, "d": 1024}, 16, "PAR06"),
               (({"data": 4}), {"op": "gram", "n": 64, "d": 8,
                                "row_axis": "data", "col_axis": "data"},
                None, "PAR01"))
        for axes, plan, hbm, code in bad:
            for mod in (P, J):
                rep = mod.validate_linalg_plan(axes, plans=(plan,),
                                               hbm_gb=hbm,
                                               check_sources=False)
                assert not rep.ok and code in rep.codes(), (mod, plan)
        rep = P.validate_linalg_plan(
            {"data": 4}, plans=({"op": "gram", "n": 64, "d": 8,
                                 "row_axis": "data", "col_axis": "data"},),
            check_sources=False)
        assert rep.plan["bills"] == {}

    def test_budget_defaults_to_the_visible_card(self):
        # never a TPU's 16 GB: with no card and no budget the bill is
        # reported and never fails
        huge = ({"name": "huge", "op": "gram", "n": 2 ** 26, "d": 1024},)
        rep = P.validate_linalg_plan({"data": 4}, plans=huge,
                                     check_sources=False)
        if torch.cuda.is_available():
            assert "PAR06" not in rep.codes()     # 68.7 GB < 80 GB card
        else:
            assert rep.ok and rep.plan["bills"]["huge"]["per_chip_bytes"] \
                > 16e9

    def test_cli_linalg_exit_contract(self):
        from deeplearning4j_tpu.analysis.cli import main as jmain
        from deeplearning4j_tpu_torch.analysis.cli import main

        for argv in (["--linalg", "--hbm-gb", "16"],
                     ["--linalg", "--mesh", "data=3"],
                     ["--linalg", "--mesh", "data==bad"],
                     ["--linalg", "--parallel"],
                     ["--linalg", "--precompile", "lenet"]):
            assert main(argv) == jmain(argv), argv
        assert main(["--linalg", "--hbm-gb", "16", "--json"]) == 0

    def test_collective_counts_contract(self, both):
        # record-only counts, as the reference's jaxpr sites count them
        for r in both[0]:
            c = r["contracts"]["record_only"]
            assert c["summa2d"] == {"all_gather": 1, "ppermute": 1}
            assert c["gram2d"] == {"all_gather": 1, "all_reduce": 1}
            assert c["gram_rows"] == {"all_reduce": 1}


# ----------------------------------------------------------------------
# the executed signatures: contracts (COL01/04/06) and wire bytes
# ----------------------------------------------------------------------

_CONTRACTED = ("matmul2d", "matmul1d", "matmul_ta", "matmul_tb", "gram",
               "covariance", "pairwise_sq_dists", "lstsq")


class TestSignatures:
    @pytest.mark.parametrize("name", _CONTRACTED + ("rsvd",))
    def test_every_rank_meets_the_contract(self, both, name):
        for r in both[0]:
            c = r["contracts"][name]
            assert c["ok"], c["codes"]
            assert c["ranks_agree"]
        counts = both[0][0]["contracts"][name]["counts"]
        if name == "matmul1d":
            assert counts == {"ppermute": 3}     # 4 ranks: 3 hops
        if name == "lstsq":
            it = both[0][0]["contracts"]["lstsq"]["iterations"]
            assert counts == {"all_reduce": 2 + it}

    def test_wire_bytes_equal_the_plans(self, both):
        c = both[0][0]["contracts"]
        m2 = P.matmul_plan(16, 24, 8, {"data": 2, "model": 2})
        assert c["matmul2d"]["wire"] == m2["ring_wire_bytes"] \
            + m2["gather_wire_bytes"]
        m1 = P.matmul_plan(16, 24, 8, {"data": 4}, col_axis=None)
        assert c["matmul1d"]["wire"] == m1["ring_wire_bytes"]
        g = P.gram_plan(16, 24, {"data": 2, "model": 2}, col_axis="model")
        assert c["gram"]["wire"] == g["ring_wire_bytes"] \
            + g["gather_wire_bytes"]
        ls = P.lstsq_plan(64, 6, {"data": 4})
        assert c["lstsq"]["wire"] == ls["setup_wire_bytes"] \
            + c["lstsq"]["iterations"] * ls["ring_wire_bytes_per_iter"]
        rs = P.rsvd_plan(64, 16, 5, {"data": 4}, n_iter=4)
        assert c["rsvd"]["wire"] == rs["wire_bytes"]


# ----------------------------------------------------------------------
# TestConsumers
# ----------------------------------------------------------------------

class TestConsumers:
    def test_kmeans_sharded_parity(self, both):
        ranks, ref, _ = both
        km = ranks[0]["consumers"]["kmeans"]
        a, b = km["local"][0], km["shard"][0]
        assert ((a[:, None] == a[None, :]) == (b[:, None] == b[None, :])).all()
        assert km["shard"][1] == pytest.approx(km["local"][1], rel=1e-4)
        # seeded from the reference's first centre: its assignments
        np.testing.assert_array_equal(km["ref_first"][0], ref["kmeans"][0])
        assert km["ref_first"][1] == pytest.approx(ref["kmeans"][1],
                                                   rel=1e-5)
        for r in ranks:
            np.testing.assert_array_equal(r["consumers"]["kmeans"]["shard"][0],
                                          b)
            assert "refusing to silently pad" in r["consumers"]["kmeans_pad"]

    def test_lsh_distributed_projection_parity(self, both):
        ranks, ref, _ = both
        tables, (i, d) = ranks[0]["consumers"]["lsh"]
        assert tables == ref["lsh"][0]
        np.testing.assert_array_equal(i, ref["lsh"][1][0])
        np.testing.assert_allclose(d, ref["lsh"][1][1], rtol=1e-5)

    def test_deepwalk_gram_products(self, both):
        for r in both[0]:
            E, G, sim, local = r["consumers"]["deepwalk"]
            assert E.shape == (8, 8)
            np.testing.assert_allclose(G, E.T @ E, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(sim, local, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(np.diag(sim), np.ones(8), atol=1e-4)

    def test_nn_conjugate_gradient_solves_through_linalg_cg(self):
        # CONJUGATE_GRADIENT's Newton-CG step is linalg.cg's solve: on a
        # convex quadratic it reaches the least-squares answer, as the
        # reference's does
        from deeplearning4j_tpu_torch.nn import solvers as S

        assert not hasattr(S, "cg")        # the copy is gone
        solver = S.build_solver("CONJUGATE_GRADIENT", maxIterations=20)
        assert isinstance(solver, S._NewtonCG)
        rng = np.random.RandomState(5)
        A = torch.from_numpy(rng.randn(32, 6))
        b = torch.from_numpy(rng.randn(32))

        def value_fn(ps):
            r = A @ ps[0] - b
            return 0.5 * r.dot(r)

        x = [torch.zeros(6, dtype=torch.float64)]
        calls = []
        import deeplearning4j_tpu_torch.linalg.solvers as LS

        real = LS.cg
        LS.cg = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            for _ in range(3):
                v, g = S._value_and_grad(value_fn, x)
                u, _ = solver.update(g, (), x, value=v, value_fn=value_fn)
                x = [xi + ui for xi, ui in zip(x, u)]
        finally:
            LS.cg = real
        assert len(calls) == 3
        np.testing.assert_allclose(
            x[0].numpy(), np.linalg.lstsq(A.numpy(), b.numpy(),
                                          rcond=None)[0],
            rtol=1e-6, atol=1e-6)


def test_all_names_are_the_references():
    assert P.__all__ == J.__all__
    for n in P.__all__:
        assert hasattr(P, n), n
