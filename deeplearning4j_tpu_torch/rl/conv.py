"""Pixel-input DQN with frame stacking.

The counterpart of ``deeplearning4j_tpu/rl/conv.py``. Reference: rl4j org.deeplearning4j.rl4j.learning.sync.qlearning.discrete
.QLearningDiscreteConv + learning.HistoryProcessor — pixels in, the last
`historyLength` frames stacked on the channel axis feed a convolutional
Q-network. The Q-net is an ordinary MultiLayerNetwork with a CNN
InputType (NCHW API feed) on its own device; only the frame ring lives
host-side, exactly where rl4j keeps its HistoryProcessor.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.rl.qlearning import (BasePolicy,
                                             QLearningDiscreteDense)


class HistoryProcessorConfiguration:
    """Reference: HistoryProcessor.Configuration (the fields that shape
    learning; crop/rescale are the caller's concern here — the MDP
    already emits the observation tensor it wants learned from)."""

    def __init__(self, historyLength=4, skipFrame=1):
        if historyLength < 1:
            raise ValueError(f"historyLength must be >= 1, got {historyLength}")
        self.historyLength = int(historyLength)
        self.skipFrame = int(skipFrame)


class QLearningDiscreteConv(QLearningDiscreteDense):
    """DQN over stacked pixel frames (reference: QLearningDiscreteConv).

    The MDP's observations are [H, W] or [C, H, W] float arrays; the
    trainer stacks the last `historyLength` frames into a
    [historyLength*C, H, W] observation. The Q-net must declare
    InputType.convolutional(H, W, historyLength*C).
    """

    def __init__(self, mdp, qNetwork, hpConfig, config):
        super().__init__(mdp, qNetwork, config)
        self.hp = hpConfig or HistoryProcessorConfiguration()
        self._frames = None

    @staticmethod
    def _frame(raw):
        f = np.asarray(raw, "float32")
        if f.ndim == 2:
            f = f[None]  # [H,W] -> [1,H,W]
        if f.ndim != 3:
            raise ValueError(
                f"conv MDP observations must be [H,W] or [C,H,W], got "
                f"shape {f.shape}")
        return f

    def _reset_env(self):
        f = self._frame(self.mdp.reset())
        self._frames = [f] * self.hp.historyLength  # repeat-pad at episode start
        return np.concatenate(self._frames, axis=0)

    def _step_env(self, action):
        reward = 0.0
        done = False
        # skipFrame: repeat the action, accumulate reward (reference:
        # HistoryProcessor skip semantics)
        for _ in range(max(1, self.hp.skipFrame)):
            obs2, r, done = self.mdp.step(action)
            reward += r
            if done:
                break
        self._frames = self._frames[1:] + [self._frame(obs2)]
        return np.concatenate(self._frames, axis=0), reward, done

    def getPolicy(self):
        """Greedy policy that carries its own frame ring (reference:
        DQNPolicy over a HistoryProcessor)."""
        return HistoryDQNPolicy(self.net, self.hp.historyLength)


class HistoryDQNPolicy(BasePolicy):
    """Greedy conv-DQN policy with its own frame ring, persistable
    (reference: rl4j DQNPolicy over a HistoryProcessor). save() writes
    the network; load() needs the historyLength the net was trained
    with (it is an input-shape property, not a network parameter)."""

    def __init__(self, net, historyLength):
        self.net = net
        self.historyLength = int(historyLength)
        self._frames = None

    def onEpisodeStart(self):
        self._frames = None  # play() resets the frame ring

    def nextAction(self, obs):
        f = QLearningDiscreteConv._frame(obs)
        if self._frames is None:
            self._frames = [f] * self.historyLength
        else:
            self._frames = self._frames[1:] + [f]
        stacked = np.concatenate(self._frames, axis=0)
        q = self.net.output(stacked[None]).toNumpy()
        return int(np.argmax(q[0]))

    def save(self, path):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        # saveUpdater=False: an inference-only artifact has no use
        # for optimizer moments (3x the payload with Adam)
        ModelSerializer.writeModel(self.net, path, False)
        return self

    @staticmethod
    def load(path, historyLength, device=None):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        return HistoryDQNPolicy(ModelSerializer.restore(path, device=device),
                                historyLength)
