"""The gym adapter (deeplearning4j_tpu_torch/rl/gym.py, a copy of the
reference's) under the reference's tests/test_rl_gym.py cases, with the
port's DQN training through it; and the two adapters side by side on
the same stub environments (observations, rewards and dones equal,
exact)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.rl import GymEnv as JGymEnv
from deeplearning4j_tpu_torch.rl import (GymEnv, QLearningConfiguration,
                                         QLearningDiscreteDense)
from tests.test_rl_gym import ClassicGymChain, GymChain, _Space
from tests.test_torch_rl import _qnet

torch.set_num_threads(1)


class TestGymEnvAdapter:
    def test_protocol_mapping_gymnasium(self):
        env = GymEnv(GymChain(), seed=42)
        assert env.obsSize() == 5 and env.numActions() == 2
        obs = env.reset()
        assert obs.shape == (5,) and obs[0] == 1.0
        assert env._env.seeded_with == 42
        obs, r, done = env.step(1)
        assert (r, done) == (0.0, False) and obs[1] == 1.0
        for _ in range(3):
            obs, r, done = env.step(1)
        assert (r, done) == (10.0, True)
        env.close()
        assert env._env.closed

    def test_protocol_mapping_classic(self):
        env = GymEnv(ClassicGymChain())
        assert env.reset().shape == (5,)
        obs, r, done = env.step(0)
        assert r == pytest.approx(0.2) and not done

    def test_kwargs_reset_wrapper_gets_seed(self):
        class Wrapper(GymChain):
            def reset(self, **kwargs):
                return super().reset(**kwargs)
        env = GymEnv(Wrapper(), seed=99)
        env.reset()
        assert env._env.seeded_with == 99

    def test_classic_env_seeds_via_seed_method(self):
        class SeedableClassic(ClassicGymChain):
            def seed(self, s):
                self.seeded_with = s
        env = GymEnv(SeedableClassic(), seed=11)
        env.reset()
        assert env._env.seeded_with == 11
        env.reset()
        assert env._env.seeded_with == 11

    def test_truncation_counts_as_done(self):
        class Truncating(GymChain):
            def step(self, action):
                return self._obs(), 0.5, False, True, {}
        _, r, done = GymEnv(Truncating()).step(0)
        assert done and r == 0.5

    def test_flatten_and_shape_passthrough(self):
        class Img(GymChain):
            def __init__(self):
                super().__init__()
                self.observation_space = _Space(shape=(4, 4, 2))

            def reset(self, seed=None):
                return np.ones((4, 4, 2)), {}
        assert GymEnv(Img()).reset().shape == (32,)
        e = GymEnv(Img(), flatten=False)
        assert e.reset().shape == (4, 4, 2)
        assert e.obsShape() == (4, 4, 2)

    def test_rejects_non_discrete_and_shapeless(self):
        class Box(GymChain):
            def __init__(self):
                super().__init__()
                self.action_space = _Space(low=-1.0, high=1.0)
        with pytest.raises(ValueError, match="discrete"):
            GymEnv(Box())

        class NoShape(GymChain):
            def __init__(self):
                super().__init__()
                self.observation_space = _Space()
        with pytest.raises(ValueError, match="observation_space"):
            GymEnv(NoShape())

    def test_dqn_trains_through_adapter(self):
        env = GymEnv(GymChain(), seed=7)
        conf = QLearningConfiguration(
            seed=7, gamma=0.9, batchSize=32, expRepMaxSize=2000,
            targetDqnUpdateFreq=100, updateStart=64, minEpsilon=0.05,
            epsilonNbStep=1200, maxEpochStep=30, doubleDQN=True)
        dqn = QLearningDiscreteDense(env, _qnet(env.obsSize(),
                                                env.numActions()), conf)
        dqn.train(maxSteps=2500)
        assert dqn.getPolicy().play(env, maxSteps=20) == pytest.approx(10.0)


class TestSeedProbeSemantics:
    def test_env_internal_typeerror_propagates(self):
        class Buggy(GymChain):
            def reset(self, seed=None):
                raise TypeError("cannot unpack non-iterable NoneType")
        with pytest.raises(TypeError, match="unpack"):
            GymEnv(Buggy(), seed=1).reset()


@pytest.mark.parametrize("make", [GymChain, ClassicGymChain],
                         ids=["gymnasium", "classic"])
def test_the_adapters_agree_step_for_step(make):
    mine, ref = GymEnv(make(), seed=3), JGymEnv(make(), seed=3)
    np.testing.assert_array_equal(mine.reset(), ref.reset())
    for a in np.random.RandomState(0).randint(0, 2, 40):
        got, want = mine.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if got[2]:
            np.testing.assert_array_equal(mine.reset(), ref.reset())
