"""SameDiff control flow and serialization in the port against the
reference's, on the CPU.

The port executes eagerly: ``ifCond`` reads its predicate on the host and
runs one branch; ``whileLoop(maxIterations=None)`` is a Python loop with
one predicate fetch an iteration; ``whileLoop(maxIterations=N)`` is N
masked iterations (``where(pred, new, old)``, the body running on after
the predicate turns false) with no host sync. Each mirrors a case of
tests/test_samediff.py's TestControlFlow, TestControlFlowSerialization
and TestControlFlowSerializationHardening (:229-580), and the same graph
in the reference gives the same values (rtol 1e-6) and gradients (rel L2
1e-5). Files with recorded bodies cross both packages. Stochastic ops in
bodies are held to the port's own streams (fresh every iteration, never
an outer op's), never to the reference's threefry draws. The same
range's TestExtraMathOps and TestRandomOps close the file.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSD
from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.data.dataset import DataSetIterator
from deeplearning4j_tpu_torch.nn import updaters as tupd

torch.set_num_threads(2)
CPU = "cpu"
F32 = np.float32


def new(pkg):
    return JSD.create() if pkg == "j" else SameDiff.create(device=CPU)


def tc_of(pkg, lr=0.05, feats=("x",), labels=("y",)):
    tc, upd = (JTC, jupd.Adam) if pkg == "j" else (TrainingConfig, tupd.Adam)
    return (tc.Builder().updater(upd(learningRate=lr))
            .dataSetFeatureMapping(*feats).dataSetLabelMapping(*labels)
            .build())


# ----------------------------------------------------------------------
# TestControlFlow
# ----------------------------------------------------------------------

def _if_both(pkg):
    sd = new(pkg)
    x = sd.placeHolder("x", "float32", 3)
    p = sd.placeHolder("p", "float32")
    out = sd.ifCond(p, lambda s, a: a * 2.0, lambda s, a: a - 1.0,
                    inputs=[x], name="branch")
    return sd, out


def test_if_cond_both_branches():
    xv = np.array([1.0, 2.0, 3.0], "float32")
    for pkg in ("p", "j"):
        sd, out = _if_both(pkg)
        hi = sd.output({"x": xv, "p": F32(1.0)}, [out])["branch"]
        lo = sd.output({"x": xv, "p": F32(0.0)}, [out])["branch"]
        np.testing.assert_allclose(hi.toNumpy(), xv * 2)
        np.testing.assert_allclose(lo.toNumpy(), xv - 1)
    sd, _ = _if_both("p")
    before = sd._control_syncs
    sd.output({"x": xv, "p": F32(1.0)}, ["branch"])
    assert sd._control_syncs == before + 1     # one predicate fetch


def test_if_cond_subgraph_ops():
    xv = np.array([[-1.0, 2.0], [0.5, -3.0]], "float32")
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 2, 2)
        p = sd.placeHolder("p", "float32")
        out = sd.ifCond(p, lambda s, a: s.math.exp(a),
                        lambda s, a: s.nn.relu(a), inputs=[x], name="cf")
        hi = sd.output({"x": xv, "p": F32(5.0)}, [out])["cf"]
        lo = sd.output({"x": xv, "p": F32(0.0)}, [out])["cf"]
        np.testing.assert_allclose(hi.toNumpy(), np.exp(xv), rtol=1e-6)
        np.testing.assert_allclose(lo.toNumpy(), np.maximum(xv, 0))


def _dynamic_while(pkg, max_it=None, step=2.0, op="mul"):
    sd = new(pkg)
    x = sd.placeHolder("x", "float32")
    limit = sd.placeHolder("limit", "float32")
    cnt0 = sd.constant(F32(0.0), name="cnt0")
    acc, cnt, _ = sd.whileLoop(
        lambda s, a, c, lim: s.math.lt(c, lim),
        lambda s, a, c, lim: (getattr(s.math, op)(
            a, s.constant(F32(step))), c + s.constant(F32(1.0)), lim),
        loopVars=[x, cnt0, limit], maxIterations=max_it, name="wl")
    return sd, acc, cnt


def test_while_loop_dynamic_count():
    for pkg in ("p", "j"):
        sd, acc, cnt = _dynamic_while(pkg)
        for n_iter in (3, 7):
            r = sd.output({"x": F32(1.5), "limit": F32(n_iter)}, [acc, cnt])
            np.testing.assert_allclose(r[acc.name].toNumpy(),
                                       1.5 * 2 ** n_iter)
            np.testing.assert_allclose(r[cnt.name].toNumpy(), n_iter)
    sd, acc, cnt = _dynamic_while("p")
    before = sd._control_syncs
    sd.output({"x": F32(1.5), "limit": F32(7)}, [acc])
    assert sd._control_syncs - before == 8     # 7 true, 1 false


def test_bounded_while_matches_unbounded():
    for pkg in ("p", "j"):
        sd, acc, cnt = _dynamic_while(pkg, max_it=8, step=3.0, op="add")
        r = sd.output({"x": F32(1.0), "limit": F32(5)}, [acc, cnt])
        np.testing.assert_allclose(r[acc.name].toNumpy(), 16.0)
        np.testing.assert_allclose(r[cnt.name].toNumpy(), 5.0)
    sd, acc, _ = _dynamic_while("p", max_it=8, step=3.0, op="add")
    before = sd._control_syncs
    sd.output({"x": F32(1.0), "limit": F32(5)}, [acc])
    assert sd._control_syncs == before          # no host fetch


def test_bounded_while_body_runs_on_after_the_predicate_turns_false():
    """The reference's masked scan evaluates the body every iteration
    and keeps the old carry where the predicate is false: a body that
    would raise on its masked values still leaves them untouched."""
    vals = {}
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32")
        out = sd.whileLoop(
            lambda s, a: s.math.lt(a, s.constant(F32(10.0))),
            lambda s, a: s.math.mul(a, s.constant(F32(3.0))),
            [x], maxIterations=6, name="w")
        vals[pkg] = sd.output({"x": F32(2.0)}, [out])["w"].toNumpy()
    np.testing.assert_array_equal(vals["p"], vals["j"])
    assert float(vals["p"]) == 18.0


def _trained_while(pkg, epochs):
    rs = np.random.RandomState(0)
    w_true = 0.8
    x0 = rs.randn(32, 4).astype("float32")
    batches = [([x0, F32(k)], [x0 * (w_true ** k)]) for k in (2.0, 4.0)]
    sd = new(pkg)
    x = sd.placeHolder("x", "float32", 32, 4)
    klim = sd.placeHolder("k", "float32")
    y = sd.placeHolder("y", "float32", 32, 4)
    w = sd.var("w", np.array(0.3, "float32"))
    cnt0 = sd.constant(F32(0.0))
    h, _, _, _ = sd.whileLoop(
        lambda s, a, c, lim, ww: s.math.lt(c, lim),
        lambda s, a, c, lim, ww: (a * ww, c + s.constant(F32(1.0)), lim, ww),
        loopVars=[x, cnt0, klim, w], maxIterations=6, name="wl")
    sd.loss.meanSquaredError(y, h, name="mse")
    sd.setTrainingConfig(tc_of(pkg, 0.05, ("x", "k"), ("y",)))
    return sd, sd.fit(data=batches, epochs=epochs), batches


def test_bounded_while_trains():
    sd, hist, _ = _trained_while("p", 100)
    assert hist[-1] < 0.05 * hist[0], f"loss {hist[0]} -> {hist[-1]}"
    w_fit = float(sd.getVariable("w").getArr().toNumpy())
    assert abs(w_fit - 0.8) < 0.1
    assert sd._control_syncs == 0
    # the same trajectory as the reference's, step by step
    _, jh, _ = _trained_while("j", 5)
    _, ph, _ = _trained_while("p", 5)
    np.testing.assert_allclose(ph, jh, rtol=1e-5)


def _xy(n=64):
    rs = np.random.RandomState(1)
    return (rs.randn(n, 3).astype("float32"),
            rs.randn(n, 3).astype("float32"))


def _loss_graph(control):
    """x [8, 3] -> x @ w -> `control` -> MSE, Adam."""
    sd = new("p")
    x = sd.placeHolder("x", "float32", 8, 3)
    y = sd.placeHolder("y", "float32", 8, 3)
    w = sd.var("w", np.eye(3, dtype="float32"))
    h = control(sd, sd.linalg.mmul(x, w), w)
    sd.loss.meanSquaredError(y, h, name="l")
    sd.setTrainingConfig(tc_of("p", 0.01))
    return sd


def _bounded(sd, h, w):
    return sd.whileLoop(
        lambda s, a, c, ww: s.math.lt(c, s.constant(F32(2.0))),
        lambda s, a, c, ww: (s.math.tanh(s.linalg.mmul(a, ww)),
                             c + s.constant(F32(1.0)), ww),
        [h, sd.constant(F32(0.0)), w], maxIterations=3)[0]


def test_bounded_while_in_fit_steps_and_fit_dataset_adds_no_sync():
    X, Y = _xy()
    sd = _loss_graph(_bounded)
    loss = sd.fitSteps(features=X[:8], labels=Y[:8], numSteps=3)
    assert np.isfinite(loss) and sd._control_syncs == 0
    hist = sd.fitDataSet(DataSetIterator(X, Y, 8),
                         stepsPerSync=4)
    assert len(hist) == 8 and sd._fit_dataset_syncs == 2   # the 2 blocks
    # the same steps as fit's
    again = _loss_graph(_bounded)
    again.fitSteps(features=X[:8], labels=Y[:8], numSteps=3)
    want = []
    for i in range(8):
        want += again.fit(features=X[8 * i:8 * i + 8],
                          labels=Y[8 * i:8 * i + 8])
    np.testing.assert_allclose(hist, want, rtol=1e-6)


def test_control_flow_syncs_are_counted_in_fit_dataset():
    """An ifCond in the loss adds one host fetch a step; fitDataSet's
    count carries them beside its block syncs."""
    X, Y = _xy()
    sd = _loss_graph(lambda sd, h, w: sd.ifCond(
        sd.math.gt(sd.math.sum(h), sd.constant(F32(0.0))),
        lambda s, a: a, lambda s, a: s.math.neg(a), inputs=[h]))
    hist = sd.fitDataSet(DataSetIterator(X, Y, 8),
                         stepsPerSync=4)
    assert len(hist) == 8
    assert sd._fit_dataset_syncs == 2 + 8      # 2 blocks + 8 predicates


def test_unbounded_while_refuses_gradients():
    sd = new("p")
    w = sd.var("w", F32(1.5))
    out = sd.whileLoop(lambda s, a: s.math.lt(a, s.constant(F32(10.0))),
                       lambda s, a: a * 2.0, [w], name="w2")
    sd.setLossVariables(out.name)
    with pytest.raises(ValueError, match="maxIterations"):
        sd.calculateGradients({}, "w")
    # inference is fine
    assert float(out.eval().toNumpy()) == 12.0


def test_dropout_inside_cond_respects_train_mode():
    sd = new("p")
    x = sd.placeHolder("x", "float32", 1000)
    p = sd.placeHolder("p", "float32")
    sd.ifCond(p, lambda s, a: s.nn.dropout(a, 0.5), lambda s, a: a,
              inputs=[x], name="cf")
    xv = np.ones(1000, "float32")
    env = dict(sd._base_env(), x=torch.from_numpy(xv),
               p=torch.tensor(F32(1)))
    train_out = sd._run_graph(dict(env), ["cf"], train=True,
                              stream=7)["cf"].numpy()
    infer_out = sd._run_graph(dict(env), ["cf"])["cf"].numpy()
    assert (train_out == 0).mean() > 0.3, "dropout inactive in training"
    np.testing.assert_allclose(infer_out, xv)


def test_if_cond_output_count_validated():
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 2)
        p = sd.placeHolder("p", "float32")
        out = sd.ifCond(p, lambda s, a: (a, a * 2.0), lambda s, a: (a, a),
                        inputs=[x], name="bad")
        with pytest.raises(ValueError, match="declared"):
            sd.output({"x": np.ones(2, "float32"), "p": F32(1)}, [out])


def test_gradients_through_if_and_bounded_while_match_reference():
    xv = np.random.RandomState(3).randn(4, 3).astype("float32")
    wv = np.random.RandomState(4).randn(3, 3).astype("float32") * 0.5
    grads = {}
    for pkg in ("j", "p"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 4, 3)
        w = sd.var("w", wv)
        h = sd.math.tanh(sd.linalg.mmul(x, w))
        h = sd.ifCond(sd.math.gt(sd.math.sum(h), sd.constant(F32(-100.0))),
                      lambda s, a: s.math.sin(a) * 2.0,
                      lambda s, a: a, inputs=[h])
        c0 = sd.constant(F32(0.0))
        h, _, _ = sd.whileLoop(
            lambda s, a, c, ww: s.math.lt(c, s.constant(F32(2.0))),
            lambda s, a, c, ww: (s.math.tanh(s.linalg.mmul(a, ww)),
                                 c + s.constant(F32(1.0)), ww),
            [h, c0, w], maxIterations=4)
        loss = sd.math.sum(sd.math.square(h), name="loss")
        sd.setLossVariables(loss.name)
        g = sd.calculateGradients({"x": xv}, "w", "x")
        grads[pkg] = {n: g[n].toNumpy() for n in ("w", "x")}
    for n in ("w", "x"):
        d = np.linalg.norm(grads["p"][n] - grads["j"][n])
        assert d <= 1e-5 * np.linalg.norm(grads["j"][n]), n


def test_nested_control_flow():
    """An ifCond whose branch runs another ifCond around an unbounded
    whileLoop (the reference cannot trace an unbounded loop inside a
    branch: its predicate is a tracer there; the port reads it)."""
    sd = new("p")
    x = sd.placeHolder("x", "float32", 3)

    def outer(s, a):
        return s.ifCond(
            s.math.gt(s.math.sum(a), s.constant(F32(0.0))),
            lambda s2, b: s2.whileLoop(
                lambda s3, v: s3.math.lt(s3.math.sum(v),
                                         s3.constant(F32(50.0))),
                lambda s3, v: s3.math.mul(v, s3.constant(F32(2.0))), [b]),
            lambda s2, b: s2.math.neg(b), inputs=[a])

    sd.ifCond(sd.math.gt(sd.math.max(x), sd.constant(F32(0.0))), outer,
              lambda s, a: a, inputs=[x], name="o")
    for xv, want in (([1.0, -2.0, 3.0], [32.0, -64.0, 96.0]),
                     ([1.0, -4.0, 2.0], [-1.0, 4.0, -2.0]),
                     ([-1.0, -4.0, -2.0], [-1.0, -4.0, -2.0])):
        before = sd._control_syncs
        got = sd.output({"x": np.array(xv, "float32")}, ["o"])["o"]
        np.testing.assert_array_equal(got.toNumpy(), want)
        assert sd._control_syncs > before    # counted on the outer graph


# ----------------------------------------------------------------------
# TestControlFlowSerialization (+ files across the packages)
# ----------------------------------------------------------------------

def _ifcond_graph(pkg):
    sd = new(pkg)
    x = sd.placeHolder("x", "float32", 4)
    pred = sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0)))
    sd.ifCond(pred, lambda s, a: s.math.mul(a, s.constant(F32(2.0))),
              lambda s, a: s.math.neg(a), inputs=[x], name="branch")
    return sd


def _load(pkg, path):
    return JSD.load(path) if pkg == "j" else SameDiff.load(path, device=CPU)


@pytest.mark.parametrize("src,dst", [("p", "p"), ("j", "p"), ("p", "j")])
def test_ifcond_roundtrip(tmp_path, src, dst):
    sd = _ifcond_graph(src)
    p = str(tmp_path / "cf.sdz")
    sd.save(p)
    back = _load(dst, p)
    for sign in (1.0, -1.0):
        xv = (sign * np.arange(1, 5)).astype("float32")
        np.testing.assert_allclose(
            back.output({"x": xv}, ["branch"])["branch"].toNumpy(),
            sd.output({"x": xv}, ["branch"])["branch"].toNumpy(), rtol=1e-6)


@pytest.mark.parametrize("src,dst", [("p", "p"), ("j", "p"), ("p", "j")])
def test_while_roundtrip_dynamic_trip_count(tmp_path, src, dst):
    sd = new(src)
    x = sd.placeHolder("x", "float32")
    sd.whileLoop(lambda s, v: s.math.lt(v, s.constant(F32(100.0))),
                 lambda s, v: s.math.mul(v, s.constant(F32(3.0))),
                 loopVars=[x], name="tripled")
    p = str(tmp_path / "while.sdz")
    sd.save(p)
    sd2 = _load(dst, p)
    for v0 in (2.0, 50.0, 200.0):
        a = sd.output({"x": F32(v0)}, ["tripled"])["tripled"]
        b = sd2.output({"x": F32(v0)}, ["tripled"])["tripled"]
        np.testing.assert_allclose(a.toNumpy(), b.toNumpy())


def test_random_op_roundtrip(tmp_path):
    sd = new("p")
    sd.random.normal(0.0, 1.0, 32, name="n")
    p = str(tmp_path / "rng.sdz")
    sd.save(p)
    a = sd.output({}, ["n"])["n"].toNumpy()
    b = SameDiff.load(p, device=CPU).output({}, ["n"])["n"].toNumpy()
    np.testing.assert_array_equal(a, b)


def test_unrecordable_body_fails_at_save_not_define(tmp_path):
    sd = new("p")
    x = sd.placeHolder("x", "float32", 2)

    def bad_body(s, a):
        raise RuntimeError("I inspect runtime values")

    sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0))),
              bad_body, lambda s, a: a, inputs=[x], name="b")
    with pytest.raises(NotImplementedError, match="could not be recorded"):
        sd.save(str(tmp_path / "bad.sdz"))


# ----------------------------------------------------------------------
# TestControlFlowSerializationHardening
# ----------------------------------------------------------------------

def _noise_loop(n_iters, lane="normal"):
    sd = new("p")
    v = sd.placeHolder("v", "float32")
    i = sd.placeHolder("i", "float32")
    out = sd.whileLoop(
        lambda s, vv, ii: s.math.lt(ii, s.constant(F32(n_iters))),
        lambda s, vv, ii: (s.math.add(vv, s.random.normal(0.0, 1.0)),
                           s.math.add(ii, s.constant(F32(1)))),
        loopVars=[v, i], name="acc")
    return sd, out


def test_while_body_random_redraws_each_iteration():
    def run(n):
        sd, out = _noise_loop(n)
        res = sd.output({"v": F32(0), "i": F32(0)}, [out[0].name])
        return float(res[out[0].name].toNumpy())

    v1, v2 = run(1), run(2)
    assert abs((v2 - v1) - v1) > 1e-6, "second draw replayed the first"
    assert run(2) == v2                         # and reproducibly


def test_body_draws_never_collide_with_outer_ops():
    """An op at sub-index i in a body and an outer op at index i get
    different streams (the body's path folds 1_000_000 + op index)."""
    sd = new("p")
    a = sd.random.normal(0.0, 1.0, 64, name="outer")      # op 0
    out = sd.ifCond(sd.constant(F32(1.0)),
                    lambda s, z: s.random.normal(0.0, 1.0, 64),
                    lambda s, z: s.random.normal(0.0, 1.0, 64),
                    inputs=[a], name="inner")
    r = sd.output({}, [a, out])
    assert not np.array_equal(r["outer"].toNumpy(), r["inner"].toNumpy())


def test_dropout_in_a_bounded_loop_draws_per_iteration():
    sd = new("p")
    x = sd.placeHolder("x", "float32", 256)
    c0 = sd.constant(F32(0.0))
    outs = sd.whileLoop(
        lambda s, a, m, c: s.math.lt(c, s.constant(F32(2.0))),
        lambda s, a, m, c: (s.nn.dropout(s.math.identity(m), 0.5),
                            a, c + s.constant(F32(1.0))),
        [x, x, c0], maxIterations=2, name="dl")
    env = dict(sd._base_env(), x=torch.ones(256))
    first = sd._run_graph(dict(env), [outs[0].name], train=True,
                          stream=3)[outs[0].name]
    # iteration 1 re-drops the iteration-0 input (the loop carries m
    # unchanged), so the two masks are the per-iteration draws
    m0 = (first != 0)
    assert 0.3 < m0.float().mean() < 0.7
    sd2 = new("p")
    x2 = sd2.placeHolder("x", "float32", 256)
    one = sd2.whileLoop(
        lambda s, a, m, c: s.math.lt(c, s.constant(F32(1.0))),
        lambda s, a, m, c: (s.nn.dropout(s.math.identity(m), 0.5),
                            a, c + s.constant(F32(1.0))),
        [x2, x2, sd2.constant(F32(0.0))], maxIterations=1, name="dl")
    env2 = dict(sd2._base_env(), x=torch.ones(256))
    only = sd2._run_graph(dict(env2), [one[0].name], train=True,
                          stream=3)[one[0].name]
    assert not torch.equal(first, only), "iteration 1 replayed iteration 0"


def test_nested_unrecordable_fails_at_save(tmp_path):
    sd = new("p")
    x = sd.placeHolder("x", "float32", 2)

    def bad(s, a):
        raise RuntimeError("inspects runtime values")

    def outer(s, a):
        return s.ifCond(s.math.gt(s.math.sum(a), s.constant(F32(0.0))),
                        bad, lambda s2, b: b, inputs=[a])

    sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0))), outer,
              lambda s, a: a, inputs=[x], name="o")
    with pytest.raises(NotImplementedError, match="could not be recorded"):
        sd.save(str(tmp_path / "nested.sdz"))


@pytest.mark.parametrize("dst", ["p", "j"])
def test_body_constants_stored_in_npz_not_json(tmp_path, dst):
    big = np.random.RandomState(0).rand(64, 64).astype("float32")
    sd = new("p")
    x = sd.placeHolder("x", "float32", 64)
    pred = sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0)))
    sd.ifCond(pred, lambda s, a: s.math.sum(s.math.mul(s.constant(big), a),
                                            1),
              lambda s, a: a, inputs=[x], name="proj")
    p = str(tmp_path / "bigbody.sdz")
    sd.save(p)
    with zipfile.ZipFile(p) as z:
        gj = z.read("graph.json").decode()
        assert len(gj) < 20_000, "body constant leaked into graph.json"
        names = np.load(io.BytesIO(z.read("arrays.npz"))).files
        assert any(n.startswith("__body__/") for n in names)
        json.loads(gj)
    xv = np.random.RandomState(1).rand(64).astype("float32")
    a = sd.output({"x": xv}, ["proj"])["proj"].toNumpy()
    b = _load(dst, p).output({"x": xv}, ["proj"])["proj"].toNumpy()
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_loaded_graph_with_control_flow_trains_like_the_original(tmp_path):
    """A reference file with a bounded loop loads here and its next fit
    steps equal the reference's own continuation (rtol 1e-5)."""
    sd, _, batches = _trained_while("j", 3)
    p = str(tmp_path / "trained.sdz")
    sd.save(p)
    back = SameDiff.load(p, device=CPU)
    back.setTrainingConfig(tc_of("p", 0.05, ("x", "k"), ("y",)))
    fresh_ref = JSD.load(p)
    fresh_ref.setTrainingConfig(tc_of("j", 0.05, ("x", "k"), ("y",)))
    np.testing.assert_allclose(back.fit(data=batches, epochs=2),
                               fresh_ref.fit(data=batches, epochs=2),
                               rtol=1e-5)


def test_shapes_through_control_flow_without_data():
    """SDVariable.shape of a control-flow output is inferred over meta
    tensors, as the reference's eval_shape does (the true branch; a
    loop keeps its carry's shapes)."""
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 3, 4)
        o = sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0))),
                      lambda s, a: s.math.mul(a, s.constant(np.ones(
                          (3, 4), F32))), lambda s, a: a, inputs=[x])
        w = sd.whileLoop(
            lambda s, a: s.math.lt(s.math.sum(a), s.constant(F32(9.0))),
            lambda s, a: s.math.mul(a, s.constant(F32(2.0))), [o])
        assert tuple(o.shape) == tuple(w.shape) == (3, 4)


# ----------------------------------------------------------------------
# TestExtraMathOps and TestRandomOps (the rest of :229-580)
# ----------------------------------------------------------------------

def test_clip_sort_topk_split():
    xv = np.array([[3., -5., 1., 0.5, 2., -2.],
                   [0., 1., -1., 4., -4., 2.]], "float32")
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 2, 6)
        c = sd.math.clipByValue(x, -1.0, 1.0, name="clip")
        s = sd.math.sort(x, descending=True, name="srt")
        tv, ti = sd.math.topK(x, 2, name="tk")
        a, _, _ = sd.math.split(x, 3, axis=1, name="sp")
        r = sd.output({"x": xv}, [c, s, tv, ti, a])
        np.testing.assert_allclose(r["clip"].toNumpy(), np.clip(xv, -1, 1))
        np.testing.assert_allclose(r["srt"].toNumpy(), -np.sort(-xv, -1))
        np.testing.assert_allclose(r[tv.name].toNumpy(),
                                   -np.sort(-xv, -1)[:, :2])
        np.testing.assert_allclose(r[ti.name].toNumpy(),
                                   np.argsort(-xv, -1)[:, :2])
        np.testing.assert_allclose(r[a.name].toNumpy(), xv[:, :2])


def test_clip_by_norm_and_integer_clip():
    for pkg in ("p", "j"):
        sd = new(pkg)
        x = sd.placeHolder("x", "float32", 4)
        y = sd.math.clipByNorm(x, 2.0, name="cn")
        xv = np.array([3.0, 4.0, 0.0, 0.0], "float32")
        r = sd.output({"x": xv}, [y])["cn"].toNumpy()
        np.testing.assert_allclose(np.linalg.norm(r), 2.0, rtol=1e-5)
        np.testing.assert_allclose(r, xv * 0.4, rtol=1e-4)
        xi = sd.placeHolder("xi", "int32", 5)
        ci = sd.math.clipByValue(xi, 0, 3, name="ci")
        r = sd.output({"xi": np.array([-2, 1, 9, 3, 0], "int32")}, [ci])
        assert r["ci"].toNumpy().dtype == np.int32
        np.testing.assert_array_equal(r["ci"].toNumpy(), [0, 1, 3, 3, 0])


def test_random_ops_stats_and_determinism():
    sd = new("p")
    sd.random.normal(2.0, 3.0, 4000, name="n")
    sd.random.uniform(-1.0, 1.0, 1000, name="u")
    sd.random.bernoulli(0.3, 5000, name="b")
    sd.random.exponential(4.0, 8000, name="e")
    sd.random.normal(2.0, 3.0, 4000, name="n2")
    o1 = sd.output({}, ["n", "u", "b", "e", "n2"])
    o2 = sd.output({}, ["n"])
    n, u, b, e = (o1[k].toNumpy() for k in "nube")
    np.testing.assert_array_equal(n, o2["n"].toNumpy())   # seeded output
    assert abs(n.mean() - 2.0) < 0.2 and abs(n.std() - 3.0) < 0.2
    assert u.min() >= -1.0 and u.max() < 1.0
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.05
    assert e.min() >= 0.0 and abs(e.mean() - 0.25) < 0.05
    assert not np.allclose(n, o1["n2"].toNumpy())        # independent ops


def test_noise_in_expression_trains():
    rs = np.random.RandomState(0)
    X = (3.0 + 0.1 * rs.randn(64, 8)).astype("float32")
    sd = new("p")
    x = sd.placeHolder("x", "float32", 64, 8)
    w = sd.var("w", np.zeros((8,), dtype="float32"))
    mask = sd.random.bernoulli(0.5, 64, 8, name="mask")
    loss = sd.math.mean(sd.math.square(sd.math.sub(sd.math.mul(x, mask), w)),
                        name="loss")
    sd.setLossVariables(loss.name)
    sd.setTrainingConfig(TrainingConfig.Builder().updater(tupd.Adam(0.05))
                         .dataSetFeatureMapping("x").build())
    hist = sd.fit(features=X, labels=None, epochs=60)
    assert np.isfinite(hist[-1])
    # E[x * mask] = 1.5: the noise refreshes each step
    assert abs(sd.getVariable("w").eval().toNumpy().mean() - 1.5) < 0.25
