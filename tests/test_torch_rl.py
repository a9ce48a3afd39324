"""Port parity for DQN (deeplearning4j_tpu_torch/rl/qlearning.py) against
the JAX reference, and the reference's tests/test_rl.py cases on the
port.

The Q-networks are built in both packages from one configuration; the
reference's initial parameters are carried into the port with
``load_reference_params``. Both trainers draw from
``np.random.RandomState(seed)``, so on one replay they sample the same
minibatches.

Tolerances (f32): TD targets within 1e-6 of their max-abs, every
parameter after each ``fit`` within 1e-5 of its tensor's max-abs (the
two frameworks sum the dense products in another order; three Adam
steps keep it there). Policy files written by either package give the
same greedy actions (exact).
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import rl as JR
from deeplearning4j_tpu.nn import (Adam as JAdam, DenseLayer as JDense,
                                   InputType as JInputType,
                                   MultiLayerNetwork as JMLN,
                                   NeuralNetConfiguration as JNNC,
                                   OutputLayer as JOutput)
from deeplearning4j_tpu_torch import rl as R
from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
from tests.test_rl import ChainMDP

torch.set_num_threads(1)

TARGET_REL = 1e-6
PARAM_REL = 1e-5


def _qnet(n_in, n_out, seed=0, hidden=24):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(5e-3))
            .list()
            .layer(DenseLayer(nOut=hidden, activation="tanh"))
            .layer(OutputLayer(nOut=n_out, activation="identity",
                               lossFunction="mse"))
            .setInputType(InputType.feedForward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _ref_qnet(n_in, n_out, seed=0, hidden=24):
    conf = (JNNC.Builder().seed(seed).updater(JAdam(5e-3)).list()
            .layer(JDense(nOut=hidden, activation="tanh"))
            .layer(JOutput(nOut=n_out, activation="identity",
                           lossFunction="mse"))
            .setInputType(JInputType.feedForward(n_in)).build())
    return JMLN(conf).init()


def _pair(n_in=5, n_out=2):
    jn = _ref_qnet(n_in, n_out)
    pn = _qnet(n_in, n_out)
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def _replay(n, obs=5, seed=3):
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        s = rng.randn(obs).astype("float32")
        s2 = rng.randn(obs).astype("float32")
        items.append((s, int(rng.randint(2)), float(rng.randn()), s2,
                      float(rng.rand() < 0.2)))
    return items


def _within(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _recording(net, seen):
    fit = net.fit

    def rec(x, y):
        seen.append((np.array(x), np.array(y)))
        return fit(x, y)

    net.fit = rec


class TestLearnBatchParity:
    @pytest.mark.parametrize("double", [True, False])
    def test_td_targets_and_fit_match_the_reference(self, double):
        jn, pn = _pair()
        conf = dict(seed=7, gamma=0.9, batchSize=16, doubleDQN=double,
                    errorClamp=1.0)
        jt = JR.QLearningDiscreteDense(ChainMDP(5), jn,
                                       JR.QLearningConfiguration(**conf))
        pt = R.QLearningDiscreteDense(ChainMDP(5), pn,
                                      R.QLearningConfiguration(**conf))
        items = _replay(200)
        jt._replay, pt._replay = list(items), list(items)
        jseen, pseen = [], []
        _recording(jn, jseen)
        _recording(pn, pseen)
        for step in range(3):
            jt._learn_batch()
            pt._learn_batch()
            (js, jy), (ps, py) = jseen[-1], pseen[-1]
            np.testing.assert_array_equal(ps, js)   # same minibatch
            _within(py, jy, TARGET_REL, f"targets {step}")
            want = jax.tree.map(np.asarray, jn._params)
            got = params_to_reference(pn.layers, pn._params)
            for i, (w, g) in enumerate(zip(want, got)):
                for k in w:
                    _within(g[k], w[k], PARAM_REL, f"step {step} {i}_{k}")
            if step == 0:   # the next steps bootstrap from a synced target
                jt._target = jt._snapshot()
                pt._target = pt._snapshot()

    def test_q_values_of_the_target_snapshot(self):
        jn, pn = _pair()
        jt = JR.QLearningDiscreteDense(ChainMDP(5), jn,
                                       JR.QLearningConfiguration())
        pt = R.QLearningDiscreteDense(ChainMDP(5), pn,
                                      R.QLearningConfiguration())
        x = np.random.RandomState(0).randn(8, 5).astype("float32")
        _within(pt._q(pt._target, x), jt._q(jt._target, x), TARGET_REL,
                "q")


class TestTargetSnapshot:
    """The port's updaters write the online net's parameters in place, so
    the target must be a clone: it stays fixed between syncs while the
    online net trains, and equals the online net right at a sync."""

    def test_target_fixed_between_syncs(self):
        conf = R.QLearningConfiguration(
            seed=7, gamma=0.9, batchSize=8, expRepMaxSize=500,
            targetDqnUpdateFreq=40, updateStart=10, maxEpochStep=30)
        dqn = R.QLearningDiscreteDense(ChainMDP(5), _qnet(5, 2), conf)
        init = [{k: v.clone() for k, v in p.items()} for p in dqn._target]
        dqn.train(maxSteps=30)            # 20 learn steps, no sync yet

        def equal(a, b):
            return all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                       for k in x)

        assert equal(dqn._target, init)
        assert not equal(dqn.net._params, init)
        dqn.train(maxSteps=40)            # the sync at step 40
        assert equal(dqn._target, dqn.net._params)
        at_sync = [{k: v.clone() for k, v in p.items()} for p in dqn._target]
        dqn.train(maxSteps=55)
        assert equal(dqn._target, at_sync)
        assert not equal(dqn.net._params, at_sync)
        assert all(not t.requires_grad for p in dqn._target
                   for t in p.values())


class TestPolicyFilesAcrossPackages:
    def _obs(self):
        return np.random.RandomState(4).randn(20, 5).astype("float32")

    def test_reference_file_reads_in_the_port(self, tmp_path):
        jn, _ = _pair()
        p = str(tmp_path / "ref_dqn.zip")
        JR.DQNPolicy(jn).save(p)
        back = R.DQNPolicy.load(p, device="cpu")
        want = JR.DQNPolicy.load(p)
        assert [back.nextAction(o) for o in self._obs()] == \
            [want.nextAction(o) for o in self._obs()]

    def test_port_file_reads_in_the_reference(self, tmp_path):
        pn = _qnet(5, 2, seed=3)
        p = str(tmp_path / "port_dqn.zip")
        pol = R.DQNPolicy(pn)
        pol.save(p)
        back = JR.DQNPolicy.load(p)
        assert [back.nextAction(o) for o in self._obs()] == \
            [pol.nextAction(o) for o in self._obs()]


class TestDQN:
    """tests/test_rl.py's cases on the port (its own initial draws)."""

    def test_learns_chain_policy(self):
        mdp = ChainMDP(5)
        conf = R.QLearningConfiguration(
            seed=7, gamma=0.9, batchSize=32, expRepMaxSize=2000,
            targetDqnUpdateFreq=100, updateStart=64, minEpsilon=0.05,
            epsilonNbStep=1200, maxEpochStep=30, doubleDQN=True)
        dqn = R.QLearningDiscreteDense(mdp, _qnet(5, 2), conf)
        dqn.train(maxSteps=2500)
        policy = dqn.getPolicy()
        for s in range(4):
            mdp.s = s
            assert policy.nextAction(mdp._obs()) == 1, f"state {s}"
        assert policy.play(ChainMDP(5), maxSteps=20) == 10.0

    def test_epsilon_anneals(self):
        dqn = R.QLearningDiscreteDense(
            ChainMDP(4), _qnet(4, 2),
            R.QLearningConfiguration(minEpsilon=0.1, epsilonNbStep=100))
        assert dqn._epsilon() == 1.0
        dqn._step = 50
        assert abs(dqn._epsilon() - 0.55) < 1e-6
        dqn._step = 1000
        assert abs(dqn._epsilon() - 0.1) < 1e-6

    def test_requires_initialized_net(self):
        conf = (NeuralNetConfiguration.Builder().list()
                .layer(DenseLayer(nOut=4))
                .layer(OutputLayer(nOut=2, activation="identity",
                                   lossFunction="mse"))
                .setInputType(InputType.feedForward(3)).build())
        with pytest.raises(RuntimeError, match="init"):
            R.QLearningDiscreteDense(
                ChainMDP(3), MultiLayerNetwork(conf, device="cpu"),
                R.QLearningConfiguration())
