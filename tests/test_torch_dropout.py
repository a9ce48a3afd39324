"""Port parity for dropout (deeplearning4j_tpu_torch/nn/conf/dropout.py,
``Layer._dropout_input``, ``DropoutLayer`` and the step key the networks
thread into every layer) against the JAX reference.

JAX's threefry and torch's Philox never agree, so the port's masks are
not the reference's: parity injects them. Each strategy's formula is
held to the reference's ``apply`` under the reference's own draw (the
keep mask or noise drawn in the test by ``jax.random`` with the key the
reference uses, handed to the port's ``combine``); a network's first
training step is held to the reference's under the reference's masks
(monkeypatched into the port's ``draw``, layer by layer). The port's own
draws are held to their moments (keep fraction, Gaussian mean and std,
one SpatialDropout draw per channel, each within 5 sigma), to the key
(the same tuple draws the same mask, the next iteration another), and
to its training contracts, bitwise: ``fitDataSet(4) == fit``,
``fitSteps(k)`` == k ``fit`` calls, a ``ResilientFit`` resume equal to
the unbroken run, no dropout in inference or in a frozen layer, and on
data-parallel ranks one key a rank with the replicas still equal.

Tolerances (f32): a formula under an injected mask max-abs 1e-6 (the
same float ops); a network's loss rel 1e-5 and its gradients rel L2
1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.nn.conf import dropout as jdo
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.nn.conf import dropout as pdo
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.runtime.resilience import (
    FaultInjector, Preemption, ResilientFit, RetryPolicy,
)

import _torch_parallel_ranks as R

torch.set_num_threads(1)
KEY = jax.random.key(3)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ----------------------------------------------------------------------
# each strategy's formula under the reference's draw
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.5, 0.8])
@pytest.mark.parametrize("cls", ["Dropout", "AlphaDropout"])
def test_keep_mask_strategies_match_under_the_reference_mask(cls, p):
    x = _x((6, 7))
    want = np.asarray(getattr(jdo, cls)(p).apply(jnp.asarray(x), KEY))
    keep = np.asarray(jax.random.bernoulli(KEY, p, x.shape))
    got = getattr(pdo, cls)(p).combine(torch.from_numpy(x),
                                       torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cls,arg", [("GaussianDropout", 0.3),
                                     ("GaussianNoise", 0.2)])
def test_noise_strategies_match_under_the_reference_noise(cls, arg):
    x = _x((5, 9), 1)
    want = np.asarray(getattr(jdo, cls)(arg).apply(jnp.asarray(x), KEY))
    noise = np.asarray(jax.random.normal(KEY, x.shape, jnp.float32))
    got = getattr(pdo, cls)(arg).combine(torch.from_numpy(x),
                                         torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dims", [3, 4, 5])
def test_spatial_dropout_matches_under_the_reference_mask(dims):
    """The reference's activations are channels-last for 4-d and 5-d,
    NCW for 3-d; the port's are channels-first throughout."""
    p = 0.6
    if dims == 3:
        x = _x((4, 5, 6), 2)          # NCW on both sides
        xr, shape = x, (4, 5, 1)
    else:
        x = _x((4, 5) + (3,) * (dims - 2), 2)    # the port's [B,C,...]
        xr = np.moveaxis(x, 1, -1)               # the reference's [B,...,C]
        shape = (4,) + (1,) * (dims - 2) + (5,)
    want = np.asarray(jdo.SpatialDropout(p).apply(jnp.asarray(xr), KEY))
    keep = np.asarray(jax.random.bernoulli(KEY, p, shape))
    if dims > 3:
        keep, want = np.moveaxis(keep, -1, 1), np.moveaxis(want, -1, 1)
    got = pdo.SpatialDropout(p).combine(torch.from_numpy(x),
                                        torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_resolve_reads_the_retain_probability():
    for v in (None, 0.0, 1.0):
        assert pdo.resolve(v) is None and jdo.resolve(v) is None
    d = pdo.resolve(0.7)
    assert isinstance(d, pdo.Dropout) and d.p == jdo.resolve(0.7).p == 0.7
    a, b = pdo.AlphaDropout(0.9), jdo.AlphaDropout(0.9)
    assert (a.a, a.b, a.alphaPrime) == (b.a, b.b, b.alphaPrime)
    for bad in (lambda: pdo.Dropout(0.0), lambda: pdo.GaussianDropout(1.0),
                lambda: pdo.AlphaDropout(1.0)):
        with pytest.raises(ValueError):
            bad()


# ----------------------------------------------------------------------
# the port's own draws
# ----------------------------------------------------------------------

N = 1 << 20


def test_keep_fraction_and_inverted_scale():
    p = 0.7
    x = torch.ones(N)
    y = pdo.Dropout(p).apply(x, pdo.step_key(1, 0))
    keep = (y != 0).double().mean().item()
    assert abs(keep - p) <= 5 * (p * (1 - p) / N) ** 0.5
    assert torch.allclose(y[y != 0], torch.full((), 1 / p))


@pytest.mark.parametrize("cls,arg,mean,std", [
    ("GaussianDropout", 0.2, 1.0, 0.5),      # sqrt(0.2 / 0.8)
    ("GaussianNoise", 0.3, 1.0, 0.3)])
def test_gaussian_moments(cls, arg, mean, std):
    y = getattr(pdo, cls)(arg).apply(torch.ones(N, dtype=torch.float64),
                                     pdo.step_key(2, 5))
    assert abs(y.mean().item() - mean) <= 5 * std / N ** 0.5
    assert abs(y.std().item() - std) <= 5 * std / (2 * N) ** 0.5


def test_spatial_dropout_is_constant_per_channel():
    x = torch.ones(64, 32, 5, 5)
    y = pdo.SpatialDropout(0.5).apply(x, pdo.step_key(4, 1))
    per = y.reshape(64, 32, -1)
    assert torch.equal(per.amax(-1), per.amin(-1))
    keep = (per[..., 0] != 0).double().mean().item()
    assert abs(keep - 0.5) <= 5 * (0.25 / (64 * 32)) ** 0.5


def test_the_same_tuple_draws_the_same_mask():
    x = torch.ones(4096)
    d = pdo.Dropout(0.5)
    a = d.apply(x, pdo.step_key(9, 3).fold(2))
    assert torch.equal(a, d.apply(x, pdo.step_key(9, 3).fold(2)))
    for other in (pdo.step_key(9, 4).fold(2), pdo.step_key(9, 3).fold(1),
                  pdo.step_key(9, 3, rank=1).fold(2)):
        assert not torch.equal(a, d.apply(x, other))
    # the global generator is neither read nor advanced
    state = torch.get_rng_state()
    d.apply(x, pdo.step_key(9, 3))
    assert torch.equal(state, torch.get_rng_state())


# ----------------------------------------------------------------------
# through the networks
# ----------------------------------------------------------------------

def _mlp(M, dropout=0.7, seed=5):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Adam(1e-2)).activation("relu").list()
            .layer(M.DenseLayer(nOut=12, dropOut=dropout))
            .layer(M.DropoutLayer(dropOut=0.6))
            .layer(M.DenseLayer(nOut=8))
            .layer(M.OutputLayer(nOut=3, activation="softmax",
                                 dropOut=0.9))
            .setInputType(M.InputType.feedForward(4)).build())


def _data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    return x, np.eye(3, dtype="float32")[rng.randint(0, 3, n)]


def _net(dropout=0.7):
    return P.MultiLayerNetwork(_mlp(P, dropout), device="cpu").init()


def test_first_step_matches_the_reference_under_its_masks(monkeypatch):
    """The reference's step-0 masks (its key folded as its trainer
    folds it, layer by layer) injected into the port: the loss and the
    gradients of the first training step agree."""
    x, y = _data()
    jn = J.MultiLayerNetwork(_mlp(J)).init()
    pn = _net()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    key = jax.random.fold_in(jax.random.key(jn.conf.seed ^ 0x5EED), 0)
    loss, grads = jax.value_and_grad(
        lambda p: jn._loss_fn(p, jn._states, jnp.asarray(x), jnp.asarray(y),
                              key, None, None, False)[0])(jn._params)
    shapes = {0: (16, 4), 1: (16, 12), 3: (16, 8)}
    masks = [np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, i), p, shapes[i]))
        for i, p in ((0, 0.7), (1, 0.6), (3, 0.9))]
    queue = list(masks)
    monkeypatch.setattr(pdo.Dropout, "draw",
                        lambda self, t, gen: torch.from_numpy(queue.pop(0)))
    pn._train_step(torch.from_numpy(x), torch.from_numpy(y), None, None)
    assert not queue
    # the step applied the update: recompute its gradient from the start
    pn2 = _net()
    pn2.load_reference_params(jax.tree.map(np.asarray, jn._params))
    queue.extend(masks)
    ploss, _ = pn2._loss_fn(pn2._params, pn2._states, x, y, None, None,
                            key=pdo.step_key(jn.conf.seed, 0))
    ploss.backward()
    got = params_to_reference(pn2.layers, [{k: t.grad for k, t in p.items()}
                                           for p in pn2._params])
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    for i, want in enumerate(grads):
        for k in want:
            assert _rel(got[i][k], want[k]) <= 1e-5, (i, k)


def test_no_dropout_in_inference():
    x, _ = _data()
    a, b = _net(), _net(None)
    b.setParams(a.params())
    assert torch.equal(a.output(x).tensor(), b.output(x).tensor())
    # a training step does draw
    g1, _ = a._loss_fn(a._params, a._states, x, _data()[1], None, None,
                       key=pdo.step_key(5, 0))
    g2, _ = b._loss_fn(b._params, b._states, x, _data()[1], None, None,
                       key=pdo.step_key(5, 0))
    assert float(g1) != float(g2)


def test_frozen_layers_run_without_dropout():
    x, y = _data()
    a, b = _net(), _net()
    b.layers[0].frozen = True
    key = pdo.step_key(5, 0)
    la, _ = a._run_layers(a._params, a._states, x, True, None, key)
    lb, _ = b._run_layers(b._params, b._states, x, True, None, key)
    c = _net(None)
    c.layers[1].dropOut = None
    c.layers[3].dropOut = None
    lc, _ = c._run_layers(c._params, c._states, x, True, None, key)
    assert not torch.equal(la, lb)
    b.layers[1].dropOut = b.layers[3].dropOut = None
    lb, _ = b._run_layers(b._params, b._states, x, True, None, key)
    assert torch.equal(lb, lc)


def test_fit_dataset_equals_fit_bitwise():
    x, y = _data(40, 1)
    a, b = _net(), _net()
    a.fit(DataSetIterator(x, y, 4))
    b.fitDataSet(DataSetIterator(x, y, 4), stepsPerSync=4)
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert a.score() == b.score() and a._iteration == b._iteration == 10


def test_fit_steps_equals_fit_calls_bitwise():
    x, y = _data()
    a, b = _net(), _net()
    for _ in range(5):
        a.fit(x, y)
    b.fitSteps(x, y, numSteps=5)
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert a.score() == b.score()


def test_graph_dropout_keys_follow_the_layer_index():
    """A ComputationGraph draws layer n's mask from the key folded with
    n's index among the layers, as the reference's ``_layer_idx``."""
    def conf():
        return (P.NeuralNetConfiguration.Builder().seed(8)
                .updater(P.Sgd(0.1)).graphBuilder().addInputs("in")
                .addLayer("d", P.DenseLayer(nOut=6, activation="relu",
                                            dropOut=0.5), "in")
                .addLayer("out", P.OutputLayer(nOut=3, activation="softmax"),
                          "d")
                .setOutputs("out")
                .setInputTypes(P.InputType.feedForward(4)).build())

    x, y = _data()
    a = P.ComputationGraph(conf(), device="cpu").init()
    b = P.ComputationGraph(conf(), device="cpu").init()
    seen = []
    orig = pdo.Dropout.apply

    def spy(self, t, key):
        seen.append(key.ints)
        return orig(self, t, key)

    pdo.Dropout.apply = spy
    try:
        a.fit(x, y)
        a.fit(x, y)
    finally:
        pdo.Dropout.apply = orig
    assert seen == [(8 ^ 0x5EED, 0, 0), (8 ^ 0x5EED, 1, 0)]
    b.fitSteps(x, y, numSteps=2)
    assert torch.equal(a.params().tensor(), b.params().tensor())


_FAST = RetryPolicy(maxRetries=3, initialDelay=0.001, maxDelay=0.004,
                    sleep=lambda s: None)


def test_resilient_resume_is_bitwise_with_dropout(tmp_path):
    x, y = _data(64, 2)

    def it():
        return DataSetIterator(x, y, 16)

    ref = _net()
    ref.fit(it(), epochs=3)
    net = _net()
    with pytest.raises(Preemption):
        ResilientFit(net, tmp_path / "ck", saveEveryNIterations=2,
                     retryPolicy=_FAST,
                     injector=FaultInjector().killAfterStep(7)).fit(
            it(), epochs=3)
    again = _net()
    ResilientFit(again, tmp_path / "ck", saveEveryNIterations=2,
                 retryPolicy=_FAST).fit(it(), epochs=3)
    assert again._iteration == 12
    assert torch.equal(ref.params().tensor(), again.params().tensor())


def test_data_parallel_ranks_fold_their_rank_into_the_key():
    """Dense ParallelWrapper on two gloo ranks: each rank draws its masks
    from the step's key folded with its rank (the reference decorrelates
    its replicas' dropout so), and the replicas stay bitwise equal."""
    ranks = launch(R.dropout_rank, 2, device="cpu", timeout=240)
    base = 5 ^ 0x5EED
    for r, out in enumerate(ranks):
        assert out["keys"] == [(base, 0, r, 0), (base, 1, r, 0)]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
