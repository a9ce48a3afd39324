"""The autotune arbiter and its knobs (``runtime/autotune.py``;
``ops/pooling.py``, ``ops/norm.py``, ``nn/losses.py``) against the
reference's ``tests/test_autotune.py`` (``TestKnobRegistry``,
``TestStore``, ``TestSweep``, ``TestFullLeNetSweep``, the BN epilogue's
bands) on the CPU.

The knobs' variants against the reference's: the max-pool ``indices`` and
``argmax`` gradients and the global ``indices`` gradient on tied windows
in f32 and bf16 (non-overlapping windows bitwise; overlapping ones sum a
position's windows in another order: f32 within 1e-6 of the gradient's
max-abs, bf16 within 2^-7, the port accumulating in fp32 where the
reference adds in bf16); the BN epilogue fused against unfused in the
reference's bands (relu, leakyrelu and identity bitwise, tanh and sigmoid
2e-5); the wide BN and loss tails against the reference's wide tails (the
same fp32 math: outputs within 1 bf16 ulp). The sweep runs with an
injected timer (a CPU wall is no measure of the card) and finds LeNet's
"indices", persists it, and a second process recalls it with no sweep and
no capture. The reference's own sweep is not run here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import losses as ref_losses
from deeplearning4j_tpu.ops import norm as ref_norm
from deeplearning4j_tpu.ops import pooling as ref_pool
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn import losses as L
from deeplearning4j_tpu_torch.ops import norm as N
from deeplearning4j_tpu_torch.ops import pooling as PO
from deeplearning4j_tpu_torch.runtime import aot
from deeplearning4j_tpu_torch.runtime import autotune as at

torch.set_num_threads(1)


def _tiny_pool_net(seed=3):
    conf = (P.NeuralNetConfiguration.Builder()
            .seed(seed).updater(P.Nesterovs(0.1, 0.9))
            .activation("relu").list()
            .layer(P.ConvolutionLayer(nOut=4, kernelSize=(3, 3)))
            .layer(P.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))
            .layer(P.OutputLayer(nOut=10, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.convolutional(10, 10, 1))
            .build())
    return P.MultiLayerNetwork(conf, device="cpu").init(), (8, 1, 10, 10)


def _pool_timer(net, args):
    """An injected wall: "indices" fastest, then "argmax", then stock."""
    return {"stock": 1.0, "argmax": 0.8,
            "indices": 0.5}[PO._BACKWARD_IMPL]


class TestKnobRegistry:
    def test_registry_matches_the_capture_key(self):
        amb = aot.ambient_fingerprint()
        for knob in at.KNOBS:
            assert amb[knob.name] == knob.get(), knob.name

    def test_names_and_candidates_are_the_references(self):
        from deeplearning4j_tpu.runtime import autotune as ref_at

        assert [(k.name, k.candidates, k.parity_rtol) for k in at.KNOBS] \
            == [(k.name, k.candidates, k.parity_rtol) for k in ref_at.KNOBS]

    def test_get_set_restore(self):
        knob = at._KNOBS_BY_NAME["maxpool_bwd"]
        old = knob.get()
        try:
            assert knob.set("indices") == old
            assert knob.get() == "indices"
        finally:
            knob.set(old)
        with pytest.raises(ValueError, match="not in"):
            knob.set("definitely-not-an-impl")

    def test_applied_context_restores_on_exception(self):
        before = at.current_knobs()
        with pytest.raises(RuntimeError):
            with at.applied({"maxpool_bwd": "indices",
                             "bn_epilogue": "unfused"}):
                assert at.current_knobs()["maxpool_bwd"] == "indices"
                raise RuntimeError("boom")
        assert at.current_knobs() == before

    def test_install_returns_previous(self):
        before = at.current_knobs()
        old = at.install({"maxpool_bwd": "argmax"})
        try:
            assert old == {"maxpool_bwd": before["maxpool_bwd"]}
            assert at.current_knobs()["maxpool_bwd"] == "argmax"
        finally:
            at.install(old)
        assert at.current_knobs() == before

    def test_unknown_knob_rejected(self):
        net, x_shape = _tiny_pool_net()
        with pytest.raises(ValueError, match="unknown knob"):
            at.autotune(net, x_shape, knobs=["no_such_knob"],
                        store_=at.TuningStore())

    def test_environment_variables_seed_the_knobs(self, monkeypatch):
        import importlib

        monkeypatch.setenv("DL4J_TPU_MAXPOOL_BWD", "indices")
        monkeypatch.setenv("DL4J_TPU_BN_EPILOGUE", "unfused")
        try:
            assert importlib.reload(PO)._BACKWARD_IMPL == "indices"
            assert importlib.reload(N)._EPILOGUE == "unfused"
            monkeypatch.setenv("DL4J_TPU_MAXPOOL_BWD", "bogus")
            with pytest.raises(ValueError, match="DL4J_TPU_MAXPOOL_BWD"):
                importlib.reload(PO)
        finally:
            monkeypatch.delenv("DL4J_TPU_MAXPOOL_BWD")
            monkeypatch.delenv("DL4J_TPU_BN_EPILOGUE")
            importlib.reload(PO)
            importlib.reload(N)


class TestKey:
    def test_key_independent_of_current_knob_values(self):
        net, _ = _tiny_pool_net()
        k0 = at.tuning_key(net)
        with at.applied({"maxpool_bwd": "indices",
                         "bn_epilogue": "unfused", "loss_tail": "wide"}):
            assert at.tuning_key(net) == k0

    def test_key_depends_on_program(self):
        assert at.tuning_key(_tiny_pool_net(3)[0]) \
            != at.tuning_key(_tiny_pool_net(4)[0])


class TestStore:
    def test_disk_round_trip_and_second_instance(self, tmp_path):
        st = at.TuningStore(str(tmp_path))
        st.put("k" * 64, {"knobs": {"maxpool_bwd": "indices"},
                          "tuned_bytes": 42})
        st2 = at.TuningStore(str(tmp_path))
        assert st2.get("k" * 64)["knobs"] == {"maxpool_bwd": "indices"}
        assert st2.stats["hits"] == 1

    def test_stale_format_removed(self, tmp_path):
        import json
        import os

        st = at.TuningStore(str(tmp_path))
        st.put("s" * 64, {"knobs": {}})
        path = st._path("s" * 64)
        rec = json.load(open(path))
        rec["tune_format"] = -1
        json.dump(rec, open(path, "w"))
        st2 = at.TuningStore(str(tmp_path))
        assert st2.get("s" * 64) is None and st2.stats["stale"] == 1
        assert not os.path.exists(path)

    def test_corrupt_file_is_a_miss(self, tmp_path):
        st = at.TuningStore(str(tmp_path))
        with open(st._path("c" * 64), "w") as fh:
            fh.write("{not json")
        assert st.get("c" * 64) is None and st.stats["corrupt"] == 1


def test_parity_bands_are_the_references():
    from deeplearning4j_tpu.runtime import autotune as ref_at

    cases = [([1.0, 0.5], [1.0, 0.5], 0.0),
             ([1.0, 0.5], [1.0, 0.5000001], 0.0),
             ([1.0, 0.5], [1.001, 0.5005], 0.05),
             ([1.0, 0.5], [1.2, 0.5], 0.05),
             ([1.0, 0.5], [float("nan"), 0.5], 0.05)]
    for a, b, r in cases:
        assert at._parity_ok(a, b, r) == ref_at._parity_ok(a, b, r)


class TestSweep:
    def test_injected_timer_sweep_finds_indices_and_persists(self,
                                                             tmp_path):
        net, x_shape = _tiny_pool_net()
        st = at.TuningStore(str(tmp_path))
        before = at.current_knobs()
        p0 = [t.clone() for d in net._params for t in d.values()]
        res = at.autotune(net, x_shape, knobs=["maxpool_bwd"], store_=st,
                          steps=2, timer=_pool_timer)
        assert res.swept and at.current_knobs() == before
        assert all(torch.equal(a, b) for a, b in zip(
            p0, [t for d in net._params for t in d.values()]))
        assert res.knobs["maxpool_bwd"] == "indices"
        verdicts = {p["to"]: p["verdict"] for p in res.per_knob}
        assert verdicts == {"indices": "adopted", "argmax": "no-gain"}
        # the second process: a fresh store on the same directory
        st2 = at.TuningStore(str(tmp_path))
        cache = aot.session_cache() or aot.enable()
        with aot.CompileWatch(cache) as watch:
            res2 = at.autotune(net, x_shape, knobs=["maxpool_bwd"],
                               store_=st2, timer=_pool_timer)
        watch.assert_no_compiles("the recall")
        assert not res2.swept and res2.knobs == res.knobs

    def test_without_a_timer_the_bytes_score(self, tmp_path):
        net, x_shape = _tiny_pool_net(seed=6)
        res = at.autotune(net, x_shape, knobs=["maxpool_bwd"],
                          store_=at.TuningStore(), steps=2)
        assert res.wall["scored_by"] == "bytes"
        for p in res.per_knob:
            assert p["verdict"] in ("adopted", "no-gain") and p["bytes"] > 0
        assert res.baseline_bytes > 0

    def test_force_resweeps(self, tmp_path):
        net, x_shape = _tiny_pool_net()
        st = at.TuningStore(str(tmp_path))
        at.autotune(net, x_shape, knobs=["maxpool_bwd"], store_=st,
                    steps=2, timer=_pool_timer)
        assert at.autotune(net, x_shape, knobs=["maxpool_bwd"], store_=st,
                           steps=2, force=True, timer=_pool_timer).swept

    def test_identical_op_traces_skip(self, tmp_path):
        net, x_shape = _tiny_pool_net(seed=5)
        res = at.autotune(net, x_shape, knobs=["flash_bwd", "bn_tail",
                                               "bn_epilogue"],
                          store_=at.TuningStore(), steps=2,
                          timer=_pool_timer)
        assert {p["knob"]: p["verdict"] for p in res.per_knob} == {
            "flash_bwd": "identical", "bn_tail": "identical",
            "bn_epilogue": "identical"}
        assert res.knobs["flash_bwd"] == "kernel"

    def test_traces_agree_once_a_timer_has_captured(self):
        """A captured step writes BN's running statistics in place (one
        copy each): the baseline's trace must already see that binding,
        or every candidate after the first timed capture reads as
        changed."""
        conf = (P.NeuralNetConfiguration.Builder().seed(2)
                .updater(P.Nesterovs(0.1, 0.9)).activation("relu").list()
                .layer(P.ConvolutionLayer(nOut=4, kernelSize=(3, 3)))
                .layer(P.BatchNormalization())
                .layer(P.OutputLayer(nOut=10, activation="softmax",
                                     lossFunction="mcxent"))
                .setInputType(P.InputType.convolutional(8, 8, 1)).build())
        net = P.MultiLayerNetwork(conf, device="cpu").init()

        def capturing_timer(n, args):
            n._train_capture().capture(args, iteration=0)
            return 1.0

        res = at.autotune(net, (8, 1, 8, 8), knobs=["flash_bwd"],
                          store_=at.TuningStore(), steps=2,
                          timer=capturing_timer)
        assert [p["verdict"] for p in res.per_knob] == ["identical"]

    def test_a_parity_failure_is_never_scored(self, monkeypatch):
        net, x_shape = _tiny_pool_net(seed=8)
        real = at._run_steps

        def skewed(n, args, steps):
            out = real(n, args, steps)
            return [v * 1.5 for v in out] \
                if PO._BACKWARD_IMPL == "indices" else out

        monkeypatch.setattr(at, "_run_steps", skewed)
        res = at.autotune(net, x_shape, knobs=["maxpool_bwd"],
                          store_=at.TuningStore(), steps=2,
                          timer=_pool_timer)
        v = {p["to"]: p["verdict"] for p in res.per_knob}
        assert v["indices"] == "parity-fail"
        assert res.knobs["maxpool_bwd"] == "argmax"

    def test_warm_start_installs_winners(self, tmp_path):
        net, x_shape = _tiny_pool_net()
        st = at.TuningStore(str(tmp_path))
        assert at.warm_start(net, store_=st) is None
        at.autotune(net, x_shape, knobs=["maxpool_bwd"], store_=st,
                    steps=2, timer=_pool_timer)
        before = at.current_knobs()
        try:
            assert at.warm_start(net, store_=st)["maxpool_bwd"] \
                == "indices"
            assert at.current_knobs()["maxpool_bwd"] == "indices"
        finally:
            at.install(before)

    def test_precompile_autotune_kwarg(self, tmp_path):
        net, x_shape = _tiny_pool_net()
        st = at.TuningStore(str(tmp_path))
        at.autotune(net, x_shape, knobs=["maxpool_bwd"], store_=st,
                    steps=2, timer=_pool_timer)
        before = at.current_knobs()
        prev = at._STORE
        at._STORE = st
        try:
            net.precompile(batchSize=x_shape[0], entries=("train",),
                           autotune=True)
            assert at.current_knobs()["maxpool_bwd"] == "indices"
        finally:
            at._STORE = prev
            at.install(before)


class TestFullLeNetSweep:
    def test_lenet_sweep_finds_indices(self, tmp_path):
        st = at.TuningStore(str(tmp_path))
        res = at.autotune_subject("lenet", device="cpu", store_=st,
                                  steps=2, timer=_pool_timer)
        assert res.knobs["maxpool_bwd"] == "indices"
        adopted = {p["knob"] for p in res.per_knob
                   if p["verdict"] == "adopted"}
        assert adopted == {"maxpool_bwd"}
        skipped = {p["knob"] for p in res.per_knob
                   if p["verdict"] == "identical"}
        assert {"flash_bwd", "bn_epilogue"} <= skipped
        assert at.TuningStore(str(tmp_path)).get(res.key) is not None


# ----------------------------------------------------------------------
# the knobs' variants against the reference's
# ----------------------------------------------------------------------

def _ties(shape, dtype, seed=0):
    x = np.random.RandomState(seed).randint(0, 3, shape).astype(np.float32)
    return x


def _port_pool_grad(impl, x, dy, k, s, pad, dtype):
    old = PO.set_maxpool_bwd(impl)
    try:
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
        xt.requires_grad_(True)
        y = PO.max_pool2d(xt, k, s, pad)
        y.backward(torch.from_numpy(dy.transpose(0, 3, 1, 2).copy())
                   .to(dtype))
        return (y.detach().float().numpy().transpose(0, 2, 3, 1),
                xt.grad.float().numpy().transpose(0, 2, 3, 1))
    finally:
        PO.set_maxpool_bwd(old)


def _ref_pool_grad(fn, x, dy, k, s, pad, jdt):
    xj = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(lambda a: fn(a, k, s, pad), xj)
    (g,) = vjp(jnp.asarray(dy, jdt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(g.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["indices", "argmax"])
@pytest.mark.parametrize("k,s,pad", [((2, 2), (2, 2), ((0, 0), (0, 0))),
                                     ((3, 3), (3, 3), ((1, 1), (1, 1))),
                                     ((3, 3), (2, 2), ((1, 1), (1, 1)))],
                         ids=["2x2s2", "3x3s3", "3x3s2"])
def test_maxpool_variants_match_the_references_on_tied_windows(
        dtype, impl, k, s, pad):
    x = _ties((2, 9, 9, 3), dtype)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    Ho = (9 + sum(pad[0]) - k[0]) // s[0] + 1
    Wo = (9 + sum(pad[1]) - k[1]) // s[1] + 1
    dy = np.random.RandomState(1).randn(2, Ho, Wo, 3).astype(np.float32)
    dy = np.asarray(jnp.asarray(dy, jdt).astype(jnp.float32))
    ref_fn = {"indices": ref_pool._max_pool2d_indices
              if s[0] >= k[0] else ref_pool.max_pool2d_reference,
              "argmax": ref_pool._max_pool2d_argmax}[impl]
    yr, gr = _ref_pool_grad(ref_fn, x, dy, k, s, pad, jdt)
    yp, gp = _port_pool_grad(impl, x, dy, k, s, pad, tdt)
    np.testing.assert_array_equal(yp, yr)
    if s[0] >= k[0]:
        np.testing.assert_array_equal(gp, gr)
    else:
        tol = 1e-6 if dtype == "float32" else 2.0 ** -7
        assert np.abs(gp - gr).max() <= tol * np.abs(gr).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_max_indices_matches_the_references(dtype):
    x = _ties((3, 4, 5, 6), dtype, seed=4)          # NHWC, many ties
    dy = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    jdt = getattr(jnp, dtype)
    dy = np.asarray(jnp.asarray(dy, jdt).astype(jnp.float32))
    yr, vjp = jax.vjp(lambda a: ref_pool._global_max_indices(a, (1, 2)),
                      jnp.asarray(x, jdt))
    (gr,) = vjp(jnp.asarray(dy, jdt))
    old = PO.set_global_maxpool_bwd("indices")
    try:
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(
            getattr(torch, dtype)).requires_grad_(True)
        y = PO.global_pool(xt, "max", (2, 3))
        y.backward(torch.from_numpy(dy.copy()).to(xt.dtype))
    finally:
        PO.set_global_maxpool_bwd(old)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(yr.astype(jnp.float32)))
    np.testing.assert_array_equal(
        xt.grad.float().numpy().transpose(0, 2, 3, 1),
        np.asarray(gr.astype(jnp.float32)))


def _bn_data(seed=0, shape=(8, 5, 6, 6)):
    rng = np.random.RandomState(seed)
    C = shape[1]
    return (torch.from_numpy(rng.randn(*shape).astype("float32")),
            torch.from_numpy(rng.rand(C).astype("float32") + 0.5),
            torch.from_numpy(rng.randn(C).astype("float32")),
            torch.from_numpy(rng.randn(C).astype("float32")),
            torch.from_numpy(rng.rand(C).astype("float32") + 0.5))


@pytest.mark.parametrize(
    "act", ["identity", "relu", "leakyrelu", "tanh", "sigmoid"])
def test_bn_epilogue_fused_vs_unfused_in_the_references_bands(act):
    x, gm, bt, rm, rv = _bn_data()

    def grads(mode):
        old = N.set_bn_epilogue(mode)
        try:
            xs, g, b = (t.clone().requires_grad_(True) for t in (x, gm, bt))
            o, m2, v2 = N.batch_norm_act(xs, g, b, rm, rv, train=True,
                                         activation=act)
            (o ** 2).sum().backward()
            return [o.detach(), m2, v2, xs.grad, g.grad, b.grad]
        finally:
            N.set_bn_epilogue(old)

    fused, unfused = grads("fused"), grads("unfused")
    exact = act in ("identity", "relu", "leakyrelu")
    for a, b in zip(fused, unfused):
        if exact:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=2e-5)


def test_bn_epilogue_relu_kink_subgradient_is_zero_unfused_too():
    x = torch.zeros(6, 2)
    x[:, 1] = torch.from_numpy(np.random.RandomState(0).randn(6)
                               .astype("float32"))
    gm, bt = torch.ones(2), torch.zeros(2, requires_grad=True)
    w = torch.from_numpy(np.random.RandomState(1).randn(6, 2)
                         .astype("float32"))
    old = N.set_bn_epilogue("unfused")
    try:
        o, _, _ = N.batch_norm_act(x, gm, bt, torch.zeros(2), torch.ones(2),
                                   train=True, activation="relu")
        (w * o).sum().backward()
    finally:
        N.set_bn_epilogue(old)
    assert float(bt.grad[0]) == 0.0


def test_wide_bn_tail_matches_the_references_wide_tail():
    x, gm, bt, rm, rv = _bn_data(seed=3)
    xb = x.to(torch.bfloat16)
    dy = torch.from_numpy(np.random.RandomState(4).randn(*x.shape)
                          .astype("float32")).to(torch.bfloat16)
    old, N._TAIL_MODE = N._TAIL_MODE, "wide"
    try:
        xs = xb.clone().requires_grad_(True)
        y, m2, v2 = N.batch_norm(xs, gm, bt, rm, rv, train=True)
        y.backward(dy)
    finally:
        N._TAIL_MODE = old
    ref_old, ref_norm._TAIL_MODE = ref_norm._TAIL_MODE, "wide"
    try:
        xj = jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1),
                         jnp.bfloat16)

        def f(a):
            return ref_norm.batch_norm(a, jnp.asarray(gm.numpy()),
                                       jnp.asarray(bt.numpy()),
                                       jnp.asarray(rm.numpy()),
                                       jnp.asarray(rv.numpy()),
                                       train=True)[0]

        yr, vjp = jax.vjp(f, xj)
        (gr,) = vjp(jnp.asarray(dy.float().numpy().transpose(0, 2, 3, 1),
                                jnp.bfloat16))
    finally:
        ref_norm._TAIL_MODE = ref_old
    yp = y.detach().float().numpy().transpose(0, 2, 3, 1)
    ulp = 2.0 ** -7 * np.abs(np.asarray(yr, np.float32)) + 1e-6
    assert (np.abs(yp - np.asarray(yr, np.float32)) <= ulp).all()
    gp = xs.grad.float().numpy().transpose(0, 2, 3, 1)
    g = np.asarray(gr, np.float32)
    assert np.abs(gp - g).max() <= 2.0 ** -7 * np.abs(g).max()


@pytest.mark.parametrize("mode", ["compute", "wide"])
def test_loss_tail_dtype_is_the_references(mode):
    old, L._TAIL_MODE = L._TAIL_MODE, mode
    ref_old, ref_losses._TAIL_MODE = ref_losses._TAIL_MODE, mode
    try:
        for t, j in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32),
                     (torch.float64, jnp.float64)):
            got = str(L.tail_dtype(t)).replace("torch.", "")
            assert got == str(jnp.dtype(ref_losses.tail_dtype(j)))
    finally:
        L._TAIL_MODE = old
        ref_losses._TAIL_MODE = ref_old


def test_wide_loss_tail_loss_matches_the_references():
    rng = np.random.RandomState(5)
    pre = rng.randn(16, 10).astype("float32")
    y = np.eye(10, dtype="float32")[rng.randint(0, 10, 16)]
    old, L._TAIL_MODE = L._TAIL_MODE, "wide"
    ref_old, ref_losses._TAIL_MODE = ref_losses._TAIL_MODE, "wide"
    try:
        pb = torch.from_numpy(pre).to(torch.bfloat16)
        ldt = L.tail_dtype(pb.dtype)
        got = float(L.compute("mcxent", torch.from_numpy(y).to(ldt),
                              pb.to(ldt), "softmax"))
        pj = jnp.asarray(pre, jnp.bfloat16)
        jdt = ref_losses.tail_dtype(pj.dtype)
        want = float(ref_losses.compute("mcxent", jnp.asarray(y, jdt),
                                        pj.astype(jdt), "softmax"))
    finally:
        L._TAIL_MODE = old
        ref_losses._TAIL_MODE = ref_old
    assert abs(got - want) <= 1e-6 * abs(want)
