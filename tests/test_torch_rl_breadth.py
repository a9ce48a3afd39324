"""Port parity for conv DQN, A3C and async n-step Q
(deeplearning4j_tpu_torch/rl/{conv,a3c,async_nstep}.py) against the JAX
reference, and the reference's tests/test_rl_breadth.py cases on the
port.

The port draws its own initial A3C and n-step parameters (a
``torch.Generator``); the parity cases carry the reference's parameters
and Adam state across with ``load_reference_params``.

Tolerances (f32): one update from one fixed rollout, every parameter and
Adam moment within 1e-5 of its tensor's max-abs and the losses within
1e-5 relative. A short A3C run from the same parameters is compared too:
its actions are sampled by ``RandomState.choice`` over softmax values
each package computes, so a difference of an ulp at a cumulative
boundary would change an action and split the trajectories; the case
checks that the draws stayed in step (the rollouts' rewards and losses
equal) before it compares the parameters, within the same 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import rl as JR
from deeplearning4j_tpu_torch import rl as R
from deeplearning4j_tpu_torch.nn import (Adam, ConvolutionLayer, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from tests.test_rl import ChainMDP
from tests.test_rl_breadth import PixelTrackMDP
from tests.test_torch_rl import _qnet

torch.set_num_threads(1)

REL = 1e-5


def _conv_qnet(n, hist, n_out):
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(5e-3))
            .list()
            .layer(ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                    convolutionMode="same",
                                    activation="relu"))
            .layer(DenseLayer(nOut=32, activation="tanh"))
            .layer(OutputLayer(nOut=n_out, activation="identity",
                               lossFunction="mse"))
            .setInputType(InputType.convolutional(n, n, hist)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _host(tree):
    """Host copies (a CPU tensor's .numpy() would share its memory)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _close_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], f"{what}.{k}")
        return
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (what, err)


def _rollout(n, obs=5, actions=2, seed=9):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, obs).astype("float32"),
            rng.randint(0, actions, n).astype(np.int64),
            rng.randn(n).astype("float32"))


A3C_CONF = dict(seed=5, gamma=0.9, nStep=10, numThreads=8,
                learningRate=3e-3, entropyCoef=0.01, valueCoef=0.5,
                maxEpochStep=30)
NSTEP_CONF = dict(seed=11, gamma=0.9, nStep=10, numThreads=8,
                  learningRate=3e-3, targetDqnUpdateFreq=20,
                  minEpsilon=0.05, epsilonNbStep=6000, maxEpochStep=30)


def _a3c_pair(warm_steps=160):
    """The reference trained `warm_steps` (so its Adam state is not zero)
    and the port from its parameters, Adam state and iteration."""
    jt = JR.A3CDiscreteDense(lambda: ChainMDP(5),
                             JR.A3CConfiguration(**A3C_CONF), hiddenSize=32)
    jt.train(maxSteps=warm_steps)
    pt = R.A3CDiscreteDense(lambda: ChainMDP(5),
                            R.A3CConfiguration(**A3C_CONF), hiddenSize=32,
                            device="cpu")
    pt.load_reference_params(_np(jt.params), _np(jt._upd_state))
    pt._iteration = jt._iteration
    return jt, pt


class TestA3CParity:
    def test_one_update_from_a_fixed_rollout(self):
        jt, pt = _a3c_pair()
        assert jt._iteration == 2
        obs, acts, ret = _rollout(80)
        jt.params, jt._upd_state, jpg, jv = jt._jit_update(
            jt.params, jt._upd_state, jnp.asarray(jt._iteration, jnp.int32),
            jnp.asarray(obs), jnp.asarray(acts, jnp.int32), jnp.asarray(ret))
        ppg, pv = pt._update(obs, acts, ret)
        assert abs(float(ppg) - float(jpg)) <= REL * abs(float(jpg))
        assert abs(float(pv) - float(jv)) <= REL * abs(float(jv))
        _close_tree(_host(pt.params), _np(jt.params), "params")
        _close_tree(_host(pt._upd_state), _np(jt._upd_state), "adam")

    def test_short_run_while_the_draws_stay_in_step(self):
        jt, pt = _a3c_pair(warm_steps=0)
        jt.train(maxSteps=240)
        pt.train(maxSteps=240)
        # the same actions give the same rollouts: equal losses say the
        # sampled actions stayed in step; a flip would move them by far
        # more than the arithmetic's 1e-5
        np.testing.assert_allclose(pt._value_losses, jt._value_losses,
                                   rtol=REL)
        np.testing.assert_allclose(pt._policy_losses, jt._policy_losses,
                                   rtol=REL, atol=1e-7)
        _close_tree(_host(pt.params), _np(jt.params), "params")

    def test_initial_draws_are_the_ports_own(self):
        a = R.A3CDiscreteDense(lambda: ChainMDP(5), device="cpu")
        b = R.A3CDiscreteDense(lambda: ChainMDP(5), device="cpu")
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k])
        s1 = 1.0 / np.sqrt(5)
        assert float(a.params["W1"].abs().max()) <= s1
        assert float(a.params["b1"].abs().max()) == 0.0

    def test_load_reference_params_checks_names_and_shapes(self):
        pt = R.A3CDiscreteDense(lambda: ChainMDP(5), device="cpu")
        good = _host(pt.params)
        with pytest.raises(ValueError, match="Wv"):
            pt.load_reference_params({k: v for k, v in good.items()
                                      if k != "Wv"})
        bad = dict(good, W1=np.zeros((4, 32), "float32"))
        with pytest.raises(ValueError, match="W1"):
            pt.load_reference_params(bad)


class TestLivePolicy:
    """getPolicy()'s live view must see every update: the trainer rebinds
    its params dict each update, and the policy re-reads on a new dict."""

    def test_policy_taken_before_train_follows_it(self):
        a3c = R.A3CDiscreteDense(lambda: ChainMDP(5),
                                 R.A3CConfiguration(**A3C_CONF),
                                 device="cpu")
        pol = a3c.getPolicy()
        obs = ChainMDP(5).reset()
        pol.nextAction(obs)                    # caches the initial params
        before = a3c.params
        stale = _host(before)
        a3c.train(maxSteps=400)
        assert a3c.params is not before
        _close_tree(_host(before), stale, "the old dict kept its values")
        pol.nextAction(obs)
        for k, v in _host(a3c.params).items():
            np.testing.assert_array_equal(pol._cached[k], v)
        assert any(not np.array_equal(pol._cached[k], stale[k])
                   for k in stale)

    def test_snapshot_policy_does_not_follow(self):
        a3c = R.A3CDiscreteDense(lambda: ChainMDP(5), device="cpu")
        snap = R.ACPolicy(_host(a3c.params))
        a3c.train(maxSteps=400)
        assert any(not np.array_equal(snap.params[k], v)
                   for k, v in _host(a3c.params).items())


class TestNStepParity:
    def test_one_update_from_a_fixed_rollout(self):
        from deeplearning4j_tpu_torch.rl import (
            AsyncNStepQLConfiguration, AsyncNStepQLearningDiscreteDense)

        jt = JR.AsyncNStepQLearningDiscreteDense(
            lambda: ChainMDP(5), JR.AsyncNStepQLConfiguration(**NSTEP_CONF),
            hiddenSize=32)
        jt.train(maxSteps=160)
        pt = AsyncNStepQLearningDiscreteDense(
            lambda: ChainMDP(5), AsyncNStepQLConfiguration(**NSTEP_CONF),
            hiddenSize=32, device="cpu")
        pt.load_reference_params(_np(jt.params), _np(jt._upd_state))
        pt._iteration = jt._iteration
        obs, acts, tgt = _rollout(80, seed=12)
        jt.params, jt._upd_state, jl = jt._jit_update(
            jt.params, jt._upd_state, jnp.asarray(jt._iteration, jnp.int32),
            jnp.asarray(obs), jnp.asarray(acts, jnp.int32), jnp.asarray(tgt))
        pl = pt._update(obs, acts, tgt)
        assert abs(float(pl) - float(jl)) <= REL * abs(float(jl))
        _close_tree(_host(pt.params), _np(jt.params), "params")
        _close_tree(_host(pt._upd_state), _np(jt._upd_state), "adam")
        # the q-values the target net bootstraps from
        x = np.random.RandomState(1).randn(6, 5).astype("float32")
        _close_tree(pt._q(pt.params, x),
                    np.asarray(jt._jit_q(jt.params, jnp.asarray(x))), "q")

    def test_target_fixed_between_syncs(self):
        from deeplearning4j_tpu_torch.rl import (
            AsyncNStepQLConfiguration, AsyncNStepQLearningDiscreteDense)

        conf = AsyncNStepQLConfiguration(**dict(NSTEP_CONF,
                                                targetDqnUpdateFreq=5))
        ql = AsyncNStepQLearningDiscreteDense(lambda: ChainMDP(5), conf,
                                              device="cpu")
        init = _host(ql.targetParams)
        ql.train(maxSteps=4 * 80)           # 4 updates, no sync yet
        _close_tree(_host(ql.targetParams), init, "before the sync")
        assert ql.targetParams["W1"] is not ql.params["W1"]
        ql.train(maxSteps=5 * 80)           # the sync after update 5
        for k, v in ql.params.items():
            assert torch.equal(ql.targetParams[k], v)
            assert ql.targetParams[k].data_ptr() != v.data_ptr()
        synced = _host(ql.targetParams)
        ql.train(maxSteps=8 * 80)
        for k, v in synced.items():
            np.testing.assert_array_equal(_host(ql.targetParams)[k], v)


class TestACPolicyFilesAcrossPackages:
    def _params(self):
        rs = np.random.RandomState(2)
        return {"W1": rs.randn(5, 7).astype("float32"),
                "b1": np.zeros(7, "float32"),
                "Wp": rs.randn(7, 3).astype("float32"),
                "bp": np.zeros(3, "float32"),
                "Wv": rs.randn(7, 1).astype("float32"),
                "bv": np.zeros(1, "float32")}

    def _obs(self):
        return np.random.RandomState(3).randn(30, 5).astype("float32")

    def test_both_ways(self, tmp_path):
        ref = str(tmp_path / "ref_ac.bin")
        JR.ACPolicy(self._params()).save(ref)
        port = str(tmp_path / "port_ac.bin")
        R.ACPolicy(self._params()).save(port)
        for greedy in (True, False):
            a = R.ACPolicy.load(ref, greedy=greedy, seed=4)
            b = JR.ACPolicy.load(port, greedy=greedy, seed=4)
            assert [a.nextAction(o) for o in self._obs()] == \
                [b.nextAction(o) for o in self._obs()]

    def test_trained_port_policy_reads_in_the_reference(self, tmp_path):
        a3c = R.A3CDiscreteDense(lambda: ChainMDP(5), device="cpu")
        a3c.train(maxSteps=400)
        p = str(tmp_path / "trained.npz")
        pol = a3c.getPolicy()
        pol.save(p)
        back = JR.ACPolicy.load(p)
        assert [back.nextAction(o) for o in self._obs()] == \
            [pol.nextAction(o) for o in self._obs()]


# ----------------------------------------------------------------------
# tests/test_rl_breadth.py's cases on the port
# ----------------------------------------------------------------------

class TestConvDQN:
    def test_learns_pixel_track_policy(self):
        n, hist = 5, 2
        conf = R.QLearningConfiguration(
            seed=3, gamma=0.9, batchSize=32, expRepMaxSize=2000,
            targetDqnUpdateFreq=100, updateStart=64, minEpsilon=0.05,
            epsilonNbStep=1000, maxEpochStep=30, doubleDQN=True)
        dqn = R.QLearningDiscreteConv(
            PixelTrackMDP(n), _conv_qnet(n, hist, 2),
            R.HistoryProcessorConfiguration(historyLength=hist), conf)
        dqn.train(maxSteps=2200)
        assert dqn.getPolicy().play(PixelTrackMDP(n), maxSteps=20) == 10.0

    def test_frame_stack_semantics(self):
        dqn = R.QLearningDiscreteConv(
            PixelTrackMDP(4), _conv_qnet(4, 3, 2),
            R.HistoryProcessorConfiguration(historyLength=3),
            R.QLearningConfiguration())
        o0 = dqn._reset_env()
        assert o0.shape == (3, 4, 4)
        np.testing.assert_array_equal(o0[0], o0[2])
        o1, _, _ = dqn._step_env(1)
        assert o1[2][0, 1] == 1.0 and o1[0][0, 0] == 1.0

    def test_skip_frame_repeats_the_action_and_sums_rewards(self):
        dqn = R.QLearningDiscreteConv(
            PixelTrackMDP(6), _conv_qnet(6, 2, 2),
            R.HistoryProcessorConfiguration(historyLength=2, skipFrame=3),
            R.QLearningConfiguration())
        dqn._reset_env()
        o, r, done = dqn._step_env(1)      # three steps right
        assert o[1][0, 3] == 1.0 and not done and r == 0.0
        dqn._reset_env()
        o, r, done = dqn._step_env(0)      # left at the edge, 3 x 0.2
        assert r == pytest.approx(0.6)

    def test_bad_history_length_rejected(self):
        with pytest.raises(ValueError, match="historyLength"):
            R.HistoryProcessorConfiguration(historyLength=0)

    def test_history_policy_file_reads_in_the_reference(self, tmp_path):
        net = _conv_qnet(4, 2, 2)
        pol = R.HistoryDQNPolicy(net, 2)
        p = str(tmp_path / "conv.zip")
        pol.save(p)
        back = JR.HistoryDQNPolicy.load(p, 2)
        mine = R.HistoryDQNPolicy.load(p, 2, device="cpu")
        env = PixelTrackMDP(4)
        obs = [env.reset()] + [env.step(a)[0] for a in (1, 1, 0)]
        assert [back.nextAction(o) for o in obs] == \
            [mine.nextAction(o) for o in obs]


class TestA3C:
    def _train(self, steps=12_000):
        conf = R.A3CConfiguration(**A3C_CONF)
        return R.A3CDiscreteDense(lambda: ChainMDP(5), conf, hiddenSize=32,
                                  device="cpu").train(maxSteps=steps)

    def test_solves_chain_and_losses_decrease(self):
        a3c = self._train()
        assert a3c.getPolicy().play(ChainMDP(5), maxSteps=20) == 10.0
        v = a3c._value_losses
        early, late = np.mean(v[:10]), np.mean(v[-10:])
        assert late < early * 0.5, (early, late)
        assert np.isfinite(a3c._policy_losses).all()

    def test_greedy_policy_walks_right_from_every_state(self):
        pol = self._train().getPolicy()
        mdp = ChainMDP(5)
        for s in range(4):
            mdp.s = s
            assert pol.nextAction(mdp._obs()) == 1, f"state {s}"

    def test_stochastic_policy_samples(self):
        pol = self._train(steps=800).getPolicy(greedy=False)
        acts = {pol.nextAction(ChainMDP(5).reset()) for _ in range(40)}
        assert acts <= {0, 1} and len(acts) >= 1


class TestAsyncNStepQLearning:
    def _train(self, steps=12_000):
        conf = R.AsyncNStepQLConfiguration(**NSTEP_CONF)
        return R.AsyncNStepQLearningDiscreteDense(
            lambda: ChainMDP(5), conf, hiddenSize=32,
            device="cpu").train(maxSteps=steps)

    def test_solves_chain(self):
        ql = self._train()
        assert ql.getPolicy().play(ChainMDP(5), maxSteps=20) == 10.0
        losses = ql._losses
        assert np.mean(losses[-10:]) < np.mean(losses[:10])

    def test_greedy_policy_right_from_every_state(self):
        pol = self._train().getPolicy()
        mdp = ChainMDP(5)
        for s in range(4):
            mdp.s = s
            assert pol.nextAction(mdp._obs()) == 1, f"state {s}"

    def test_epsilon_anneals(self):
        conf = R.AsyncNStepQLConfiguration(minEpsilon=0.1, epsilonNbStep=100)
        ql = R.AsyncNStepQLearningDiscreteDense(lambda: ChainMDP(5), conf,
                                                device="cpu")
        assert ql._epsilon() == 1.0
        ql._step = 50
        assert abs(ql._epsilon() - 0.55) < 1e-9
        ql._step = 1000
        assert abs(ql._epsilon() - 0.1) < 1e-9

    def test_target_net_syncs(self):
        ql = self._train(steps=2000)
        diff = float((ql.targetParams["Wq"] - ql.params["Wq"]).abs().max())
        assert diff < 1.0
        assert ql._iteration >= ql.conf.targetDqnUpdateFreq


class TestPolicyPersistence:
    def test_dqn_policy_roundtrip(self, tmp_path):
        conf = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-2))
                .list()
                .layer(DenseLayer(nOut=8, activation="relu"))
                .layer(OutputLayer(nOut=3, activation="identity",
                                   lossFunction="mse"))
                .setInputType(InputType.feedForward(4)).build())
        pol = R.DQNPolicy(MultiLayerNetwork(conf, device="cpu").init())
        p = str(tmp_path / "dqn.zip")
        pol.save(p)
        back = R.DQNPolicy.load(p, device="cpu")
        obs = np.random.RandomState(0).randn(4).astype("float32")
        assert back.nextAction(obs) == pol.nextAction(obs)

    def test_ac_policy_roundtrip_and_sampling(self, tmp_path):
        params = TestACPolicyFilesAcrossPackages()._params()
        pol = R.ACPolicy(params)
        p = str(tmp_path / "ac.bin")
        pol.save(p)
        back = R.ACPolicy.load(p)
        obs = np.random.RandomState(2).randn(5).astype("float32")
        assert back.nextAction(obs) == pol.nextAction(obs)
        stoch = R.ACPolicy(params, greedy=False, seed=5)
        assert len({stoch.nextAction(obs) for _ in range(50)}) >= 2

    def test_trained_policy_survives_roundtrip(self, tmp_path):
        mdp = ChainMDP(4)
        trainer = R.QLearningDiscreteDense(
            mdp, _qnet(4, 2),
            R.QLearningConfiguration(seed=7, maxEpochStep=20,
                                     expRepMaxSize=2000, batchSize=32,
                                     targetDqnUpdateFreq=50,
                                     epsilonNbStep=800, gamma=0.9))
        trainer.train(maxSteps=2500)
        pol = trainer.getPolicy()
        score = pol.play(mdp, maxSteps=30)
        p = str(tmp_path / "solved.zip")
        pol.save(p)
        assert R.DQNPolicy.load(p, device="cpu").play(mdp, maxSteps=30) \
            == score
