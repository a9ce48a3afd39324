"""Port parity for the updaters, schedules and losses
(deeplearning4j_tpu_torch/nn/{updaters,schedules,losses}.py) against the
JAX reference, inputs made from numpy seeds.

- The 7 updaters the CNN-zoo slice ports (AdamW, AdaMax, Nadam, AMSGrad,
  AdaGrad, AdaDelta, RmsProp), and the 4 before them, over 5 steps of
  seeded gradients: each step's updates and the state after it, f64,
  rel 1e-12 (the same arithmetic; only the order of a product of scalars
  may differ).
- Updater state through a ``TrainingCheckpoint`` written by either
  package and read by the other: the state carries bit for bit, and one
  more training step agrees to rel 1e-5 (f32).
- The 7 schedules at iterations and epochs 0..50: rel 1e-12.
- The 16 losses (10 ported by this slice), with and without a mask, with
  ``weights=``, f64: rel 1e-12; f32 and bf16 (the compute tail): rel
  1e-5 and 1e-2. Gradients of each f64 loss: rel L2 1e-10.
- tests/test_multilayer.py's updater convergence and long-tail loss
  oracles, on the port.
"""

import json
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import schedules as jsched
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.util.serializer import \
    TrainingCheckpoint as JTrainingCheckpoint
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.nn import losses as plosses
from deeplearning4j_tpu_torch.nn import schedules as psched
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.util.serializer import TrainingCheckpoint

torch.set_num_threads(1)

UPDATERS = {
    "AdamW": dict(learningRate=1e-2, weightDecay=0.05),
    "AdaMax": dict(learningRate=1e-2),
    "Nadam": dict(learningRate=1e-2),
    "AMSGrad": dict(learningRate=1e-2),
    "AdaGrad": dict(learningRate=0.1),
    "AdaDelta": dict(rho=0.9),
    "RmsProp": dict(learningRate=0.05),
    "Adam": dict(learningRate=1e-2),
    "Nesterovs": dict(learningRate=0.1, momentum=0.9),
    "Sgd": dict(learningRate=0.1),
    "NoOp": dict(),
}
NEW_UPDATERS = ["AdamW", "AdaMax", "Nadam", "AMSGrad", "AdaGrad",
                "AdaDelta", "RmsProp"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _close_trees(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_trees(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_trees(g, w, tol)
    else:
        assert _rel(got, want) <= tol, (_rel(got, want))


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_matches_over_five_steps(name):
    rng = np.random.default_rng(3)
    shapes = {"W": (4, 3), "b": (3,)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    ju = getattr(jupd, name)(**UPDATERS[name])
    pu = getattr(pupd, name)(**UPDATERS[name])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = ju.init(jp), pu.init(pp)
    for it in range(5):
        g = {k: rng.standard_normal(s) for k, s in shapes.items()}
        jupd_, js = ju.apply({k: jnp.asarray(v) for k, v in g.items()}, js,
                             it, params=jp)
        with torch.no_grad():
            pupd_, ps = pu.apply({k: torch.from_numpy(v) for k, v in
                                  g.items()}, ps, it, params=pp)
        _close_trees(_np(pupd_), _np(jupd_), 1e-12)
        _close_trees(_np(ps), _np(js), 1e-12)
        jp = {k: jp[k] - jupd_[k] for k in jp}
        with torch.no_grad():
            for k in pp:
                pp[k].sub_(pupd_[k])


def test_resolve_names_every_updater():
    for n in ("sgd", "adam", "adamax", "nadam", "amsgrad", "adagrad",
              "adadelta", "adamw", "rmsprop", "nesterovs", "noop"):
        assert type(pupd.resolve(n)).__name__ == \
            type(jupd.resolve(n)).__name__
    with pytest.raises(ValueError):
        pupd.resolve("lamb")


def test_adamw_needs_params():
    u = pupd.AdamW(weightDecay=0.1)
    g = {"W": torch.ones(2)}
    with pytest.raises(ValueError, match="params"):
        u.apply(g, u.init(g), 0)


def _mlp(M, updater):
    return (M.NeuralNetConfiguration.Builder().seed(7).updater(updater)
            .activation("tanh").list()
            .layer(M.DenseLayer(nOut=6))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.feedForward(4)).build())


def _xy(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 4).astype("float32")
    return x, np.eye(3, dtype="float32")[rng.randint(0, 3, 16)]


def _flat_upd(states):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(np.asarray(t.detach().cpu() if isinstance(
                t, torch.Tensor) else t, np.float64).ravel())

    walk(states)
    return np.concatenate(out) if out else np.zeros(0)


@pytest.mark.parametrize("name", NEW_UPDATERS)
def test_checkpoint_from_the_reference_restores_in_the_port(name, tmp_path):
    x, y = _xy()
    jn = J.MultiLayerNetwork(_mlp(J, getattr(J, name)(**UPDATERS[name]))
                             ).init()
    for _ in range(2):
        jn.fit(x, y)
    path = str(tmp_path / "ck.npz")
    JTrainingCheckpoint.save(jn, path)
    pn, _, _ = TrainingCheckpoint.load(path, device="cpu")
    assert type(pn._updaters[0]).__name__ == name
    np.testing.assert_array_equal(
        _flat_upd(pn.reference_state()["upd_states"]),
        _flat_upd(jax.tree.map(np.asarray, jn._upd_states)))
    jn.fit(x, y)
    pn.fit(x, y)
    assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NEW_UPDATERS)
def test_checkpoint_from_the_port_restores_in_the_reference(name, tmp_path):
    x, y = _xy(1)
    pn = P.MultiLayerNetwork(_mlp(P, getattr(P, name)(**UPDATERS[name])),
                             device="cpu").init()
    for _ in range(2):
        pn.fit(x, y)
    path = str(tmp_path / "ck.npz")
    TrainingCheckpoint.save(pn, path)
    jn, _, _ = JTrainingCheckpoint.load(path)
    np.testing.assert_array_equal(
        _flat_upd(jax.tree.map(np.asarray, jn._upd_states)),
        _flat_upd(pn.reference_state()["upd_states"]))
    jn.fit(x, y)
    pn.fit(x, y)
    assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())


@pytest.mark.parametrize("name", ["RmsProp", "AdaGrad", "AdaMax", "Nadam",
                                  "AMSGrad", "AdamW", "AdaDelta"])
def test_updaters_reduce_loss(name):
    """tests/test_multilayer.py's convergence case, on the port."""
    x, y = _xy(2)
    kw = dict(UPDATERS[name])
    if name == "AdaDelta":
        kw = dict(rho=0.95, epsilon=1e-3)
    net = P.MultiLayerNetwork(_mlp(P, getattr(P, name)(**kw)),
                              device="cpu").init()
    losses = []
    for _ in range(15):
        net.fit(x, y)
        losses.append(net.score())
    assert losses[-1] < losses[0]


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------

def _schedules(M, kind):
    return {
        "Fixed": M.FixedSchedule(0.3),
        "Step": M.StepSchedule(kind, 0.5, 0.7, 4),
        "Exponential": M.ExponentialSchedule(kind, 0.5, 0.93),
        "Inverse": M.InverseSchedule(kind, 0.5, 0.1, 0.75),
        "Poly": M.PolySchedule(kind, 0.5, 2.0, 40),
        "Sigmoid": M.SigmoidSchedule(kind, 0.5, 0.3, 20),
        "Map": M.MapSchedule(kind, {0: 0.5, 7: 0.2, 30: 0.05}),
        "Cycle": M.CycleSchedule(kind, 0.01, 0.1, 24, 4, 0.2),
    }


@pytest.mark.parametrize("kind", ["iteration", "epoch"])
@pytest.mark.parametrize("name", ["Fixed", "Step", "Exponential", "Inverse",
                                  "Poly", "Sigmoid", "Map", "Cycle"])
def test_schedule_values_match(name, kind):
    js = _schedules(jsched, kind)[name]
    ps = _schedules(psched, kind)[name]
    for i in range(51):
        it, ep = (i, 3) if kind == "iteration" else (3, i)
        want = float(js.valueAt(it, ep))
        got = ps.valueAt(it, ep)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300), (i, got,
                                                                   want)


def test_map_schedule_needs_a_value_at_zero():
    with pytest.raises(ValueError, match="0"):
        psched.MapSchedule("iteration", {3: 0.1})


def test_a_schedule_drives_the_learning_rate_and_crosses_json():
    """An updater's learningRate schedule reaches the step (the trajectory
    equals the reference's) and its conf JSON crosses both packages."""
    x, y = _xy(3)
    jc = _mlp(J, J.Sgd(jsched.StepSchedule("iteration", 0.5, 0.5, 2)))
    pc = _mlp(P, P.Sgd(psched.StepSchedule("iteration", 0.5, 0.5, 2)))
    assert json.loads(P.MultiLayerConfiguration.fromJson(jc.toJson())
                      .toJson()) == json.loads(jc.toJson())
    assert json.loads(J.MultiLayerConfiguration.fromJson(pc.toJson())
                      .toJson()) == json.loads(pc.toJson())
    jn = J.MultiLayerNetwork(jc).init()
    pn = P.MultiLayerNetwork(pc, device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    for _ in range(5):
        jn.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jn.score()) <= 1e-5 * abs(jn.score())


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

LOSSES = {   # name -> (activation, label kind)
    "mcxent": ("softmax", "onehot"),
    "negativeloglikelihood": ("sigmoid", "onehot"),
    "sparse_mcxent": ("softmax", "index"),
    "xent": ("sigmoid", "binary"),
    "reconstruction_crossentropy": ("sigmoid", "binary"),
    "mse": ("identity", "real"),
    "l2": ("tanh", "real"),
    "mae": ("identity", "real"),
    "l1": ("identity", "real"),
    "hinge": ("identity", "sign"),
    "squared_hinge": ("tanh", "sign"),
    "kl_divergence": ("softmax", "prob"),
    "poisson": ("softplus", "count"),
    "cosine_proximity": ("identity", "real"),
    "mape": ("identity", "real"),
    "msle": ("softplus", "count"),
    "wasserstein": ("identity", "sign"),
}
NEW_LOSSES = ["hinge", "squared_hinge", "kl_divergence", "poisson",
              "cosine_proximity", "sparse_mcxent", "mape", "msle",
              "wasserstein", "reconstruction_crossentropy"]


def _loss_inputs(name, rng, shape=(6, 4)):
    act, kind = LOSSES[name]
    pre = rng.standard_normal(shape)
    C = shape[-1]
    if kind == "onehot":
        y = np.eye(C)[rng.integers(0, C, shape[:-1])]
    elif kind == "index":
        y = rng.integers(0, C, shape[:-1] + (1,)).astype(np.float64)
    elif kind == "binary":
        y = (rng.random(shape) > 0.5).astype(np.float64)
    elif kind == "sign":
        y = np.where(rng.random(shape) > 0.5, 1.0, -1.0)
    elif kind == "prob":
        y = rng.random(shape)
        y /= y.sum(-1, keepdims=True)
    elif kind == "count":
        y = rng.integers(0, 4, shape).astype(np.float64)
    else:
        y = rng.standard_normal(shape)
    return act, pre, y


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient_match_f64(name, weighted, masked):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = (3, 5, 4) if masked else (6, 4)
    act, pre, y = _loss_inputs(name, rng, shape)
    w = rng.random(4) + 0.5 if weighted else None
    mask = (rng.random(shape[:2]) > 0.3).astype(np.float64) if masked \
        else None
    want, jg = jax.value_and_grad(lambda p: jlosses.compute(
        name, jnp.asarray(y), p, act,
        None if mask is None else jnp.asarray(mask),
        None if w is None else jnp.asarray(w)))(jnp.asarray(pre))
    tp = torch.from_numpy(pre.copy()).requires_grad_(True)
    got = plosses.compute(name, torch.from_numpy(y), tp, act,
                          None if mask is None else torch.from_numpy(mask),
                          w)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-12 * max(abs(float(want)),
                                                        1e-300)
    assert _rel(tp.grad.numpy(), np.asarray(jg)) <= 1e-10


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("name", NEW_LOSSES)
def test_loss_compute_tail_dtypes(name, dtype, tol):
    rng = np.random.default_rng(7)
    act, pre, y = _loss_inputs(name, rng, (8, 6))
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = float(jlosses.compute(name, jnp.asarray(y, jd),
                                 jnp.asarray(pre, jd), act))
    got = float(plosses.compute(
        name, torch.from_numpy(y).to(td), torch.from_numpy(pre).to(td), act))
    assert abs(got - want) <= tol * max(abs(want), 1e-6), (got, want)


def test_sparse_mcxent_matches_dense():
    """tests/test_multilayer.py's TestLossLongTail, on the port."""
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(6, 4).astype("float32"))
    idx = rs.randint(0, 4, 6)
    dense = plosses.compute("mcxent", torch.from_numpy(
        np.eye(4, dtype="float32")[idx]), logits, "softmax")
    sparse = plosses.compute("sparse_mcxent", torch.from_numpy(
        idx.astype("float32")[:, None]), logits, "softmax")
    assert abs(float(sparse) - float(dense)) <= 1e-6 * abs(float(dense))
    # per-class weights gather by each example's class
    w = np.array([0.5, 1.0, 2.0, 3.0])
    ws = plosses.compute("sparse_mcxent", torch.from_numpy(
        idx.astype("float32")[:, None]), logits, "softmax", weights=w)
    wd = plosses.compute("mcxent", torch.from_numpy(
        np.eye(4, dtype="float32")[idx]), logits, "softmax", weights=w)
    assert abs(float(ws) - float(wd)) <= 1e-6 * abs(float(wd))


def test_mape_msle_oracles():
    y = torch.tensor([[2.0, 4.0]])
    yhat = torch.tensor([[1.0, 5.0]])
    mape = plosses.compute("mape", y, yhat, "identity")
    assert abs(float(mape) - 100 * (0.5 + 0.25) / 2) <= 1e-4
    msle = plosses.compute("msle", y, yhat, "identity")
    want = (np.log(3 / 2) ** 2 + np.log(5 / 6) ** 2) / 2
    assert abs(float(msle) - want) <= 1e-6


def test_output_layer_trains_with_each_new_loss():
    """Each new loss as an OutputLayer's lossFunction: the port's step
    loss equals the reference's (weights carried)."""
    x, _ = _xy(4)
    rng = np.random.default_rng(4)
    for name in NEW_LOSSES:
        act, _, y = _loss_inputs(name, rng, (16, 3))
        y = y.astype("float32")

        def conf(M):
            return (M.NeuralNetConfiguration.Builder().seed(2)
                    .updater(M.Sgd(0.05)).list()
                    .layer(M.DenseLayer(nOut=5, activation="tanh"))
                    .layer(M.OutputLayer(nOut=3, activation=act,
                                         lossFunction=name))
                    .setInputType(M.InputType.feedForward(4)).build())

        jn = J.MultiLayerNetwork(conf(J)).init()
        pn = P.MultiLayerNetwork(conf(P), device="cpu").init()
        pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
        for _ in range(2):
            jn.fit(x, y)
            pn.fit(x, y)
            assert abs(pn.score() - jn.score()) <= 1e-5 * max(
                abs(jn.score()), 1e-6), name
