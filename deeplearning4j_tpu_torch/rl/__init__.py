"""Reinforcement learning (reference: the rl4j sub-project of the
deeplearning4j monorepo — org.deeplearning4j.rl4j), the counterpart of
``deeplearning4j_tpu/rl``: DQN (dense + conv with frame stacking),
advantage actor-critic and async n-step Q-learning. Q-networks are
regular MultiLayerNetworks whose fit() consumes TD targets; A3C and
n-step Q keep their parameter dicts on the trainer's device with
vectorized environments. Every random draw of the host loop comes from
``np.random.RandomState(seed)``, as the reference's."""

from deeplearning4j_tpu_torch.rl.qlearning import (MDP, DQNPolicy,
                                                   QLearningConfiguration,
                                                   QLearningDiscreteDense)
from deeplearning4j_tpu_torch.rl.conv import (HistoryDQNPolicy,
                                              HistoryProcessorConfiguration,
                                              QLearningDiscreteConv)
from deeplearning4j_tpu_torch.rl.a3c import (ACPolicy, A3CConfiguration,
                                             A3CDiscreteDense)
from deeplearning4j_tpu_torch.rl.async_nstep import (
    AsyncNStepQLConfiguration, AsyncNStepQLearningDiscreteDense,
)
from deeplearning4j_tpu_torch.rl.gym import GymEnv

__all__ = ["MDP", "DQNPolicy", "HistoryDQNPolicy", "ACPolicy",
           "QLearningConfiguration", "QLearningDiscreteDense",
           "HistoryProcessorConfiguration", "QLearningDiscreteConv",
           "A3CConfiguration", "A3CDiscreteDense",
           "AsyncNStepQLConfiguration", "AsyncNStepQLearningDiscreteDense",
           "GymEnv"]
