"""Deep Q-learning for discrete action spaces.

The counterpart of ``deeplearning4j_tpu/rl/qlearning.py``. Reference:
rl4j org.deeplearning4j.rl4j.learning.sync.qlearning.discrete
.QLearningDiscreteDense with QLearning.QLConfiguration (gamma, epsilon
schedule, experience replay, target network, double DQN) over an
org.deeplearning4j.rl4j.mdp.MDP. The Q-network is an ordinary
MultiLayerNetwork on its own device: acting is its inference forward,
learning is its fit() on TD targets; the environment loop, the replay
and every random draw (epsilon, random actions, replay indices: one
``np.random.RandomState(seed)``, as the reference's) are host-side, so
one seed gives both packages the same draws.

A learn step moves its batch to the device as numpy (``np.stack`` of the
sampled observations, unpinned) and reads Q-values back three times
(target net on s', online net on s' for double DQN, online net on s)
before ``fit``'s loss read: the reference's traffic, kept as it is.
"""

from __future__ import annotations

import numpy as np


class BasePolicy:
    """Shared rollout semantics for all policies (reference: rl4j
    policy.Policy.play). Subclasses implement nextAction(obs); policies
    with episode state (frame rings) override onEpisodeStart()."""

    def nextAction(self, obs):
        raise NotImplementedError

    def onEpisodeStart(self):
        pass

    def play(self, mdp, maxSteps=1000):
        self.onEpisodeStart()
        obs = mdp.reset()
        total = 0.0
        for _ in range(maxSteps):
            obs, r, done = mdp.step(self.nextAction(obs))
            total += r
            if done:
                break
        return total


class MDP:
    """Environment protocol (reference: rl4j.mdp.MDP): discrete actions,
    dense observations."""

    def obsSize(self) -> int:
        raise NotImplementedError

    def numActions(self) -> int:
        raise NotImplementedError

    def reset(self):
        """-> initial observation (1-D float array)."""
        raise NotImplementedError

    def step(self, action: int):
        """-> (observation, reward, done)."""
        raise NotImplementedError


class QLearningConfiguration:
    """Reference: QLearning.QLConfiguration (the fields that shape the
    algorithm; Builder-style kwargs)."""

    def __init__(self, seed=123, gamma=0.99, batchSize=32,
                 expRepMaxSize=10_000, targetDqnUpdateFreq=100,
                 updateStart=100, minEpsilon=0.05, epsilonNbStep=1000,
                 maxEpochStep=200, doubleDQN=True, errorClamp=1.0):
        self.seed = int(seed)
        self.gamma = float(gamma)
        self.batchSize = int(batchSize)
        self.expRepMaxSize = int(expRepMaxSize)
        self.targetDqnUpdateFreq = int(targetDqnUpdateFreq)
        self.updateStart = int(updateStart)
        self.minEpsilon = float(minEpsilon)
        self.epsilonNbStep = int(epsilonNbStep)
        self.maxEpochStep = int(maxEpochStep)
        self.doubleDQN = bool(doubleDQN)
        self.errorClamp = float(errorClamp)


class QLearningDiscreteDense:
    """DQN trainer (reference: QLearningDiscreteDense): epsilon-greedy
    acting, uniform experience replay, periodic target-network sync,
    optional double-DQN target selection."""

    def __init__(self, mdp: MDP, qNetwork, config: QLearningConfiguration):
        qNetwork._require_init()
        self.mdp = mdp
        self.net = qNetwork
        self.conf = config
        self._rng = np.random.RandomState(config.seed)
        # ring buffer: O(1) eviction (a list with pop(0) degrades to O(n)
        # per environment step once full) AND O(1) random indexing for
        # minibatch sampling (which a deque would not give)
        self._replay = []  # (s, a, r, s2, done)
        self._replay_pos = 0  # next overwrite slot once at capacity
        self._target = self._snapshot()
        self._step = 0

    # ---- internals -------------------------------------------------
    def _snapshot(self):
        # a clone, not references: the updaters write the online net's
        # parameters in place
        from deeplearning4j_tpu_torch.util.pytree import device_copy_tree

        return device_copy_tree(self.net._params)

    def _epsilon(self):
        c = self.conf
        frac = min(1.0, self._step / max(c.epsilonNbStep, 1))
        return 1.0 + (c.minEpsilon - 1.0) * frac

    def _q(self, params, states):
        # `params`: per-layer dicts (the online net's or the target
        # snapshot); BN layers use the online net's running statistics
        return self.net._forward_infer(params, states).float().cpu().numpy()

    def _act(self, obs):
        if self._rng.rand() < self._epsilon():
            return int(self._rng.randint(self.mdp.numActions()))
        q = self._q(self.net._params, obs[None].astype("float32"))
        return int(np.argmax(q[0]))

    # ---- environment hooks (QLearningDiscreteConv overrides these to
    # maintain its frame stack; reference: rl4j's HistoryProcessor sits
    # at exactly this boundary) ---------------------------------------
    def _reset_env(self):
        return np.asarray(self.mdp.reset(), "float32")

    def _step_env(self, action):
        obs2, reward, done = self.mdp.step(action)
        return np.asarray(obs2, "float32"), reward, done

    def _learn_batch(self):
        c = self.conf
        idx = self._rng.randint(len(self._replay), size=c.batchSize)
        s, a, r, s2, done = (np.stack([self._replay[i][j] for i in idx])
                             for j in range(5))
        s = s.astype("float32")
        s2 = s2.astype("float32")
        q_next_t = self._q(self._target, s2)
        if c.doubleDQN:
            # online net picks the action, target net evaluates it
            pick = np.argmax(self._q(self.net._params, s2), axis=1)
            q_next = q_next_t[np.arange(len(pick)), pick]
        else:
            q_next = q_next_t.max(axis=1)
        target_vals = r + c.gamma * q_next * (1.0 - done)
        # regress ONLY the taken action's output: start from the net's
        # own predictions so other actions contribute zero error
        targets = np.array(self._q(self.net._params, s))  # writable copy
        cur = targets[np.arange(len(a)), a.astype(int)]
        td = np.clip(target_vals - cur, -c.errorClamp, c.errorClamp)
        targets[np.arange(len(a)), a.astype(int)] = cur + td
        self.net.fit(s, targets.astype("float32"))

    # ---- public API (reference: Learning.train / getPolicy) --------
    def train(self, maxSteps=5000):
        c = self.conf
        while self._step < maxSteps:
            obs = self._reset_env()
            for _ in range(c.maxEpochStep):
                a = self._act(obs)
                obs2, reward, done = self._step_env(a)
                item = (obs, a, float(reward), obs2, float(done))
                if len(self._replay) < c.expRepMaxSize:
                    self._replay.append(item)
                else:
                    self._replay[self._replay_pos] = item
                    self._replay_pos = (self._replay_pos + 1) % c.expRepMaxSize
                obs = obs2
                self._step += 1
                if self._step >= c.updateStart and \
                        len(self._replay) >= c.batchSize:
                    self._learn_batch()
                if self._step % c.targetDqnUpdateFreq == 0:
                    self._target = self._snapshot()
                if done or self._step >= maxSteps:
                    break
        return self

    def getPolicy(self):
        """Greedy policy over the trained Q-network (reference:
        policy.DQNPolicy)."""
        return DQNPolicy(self.net)


class DQNPolicy(BasePolicy):
    """Greedy policy over a trained Q-network, persistable (reference:
    rl4j policy.DQNPolicy.save/load — upstream serializes the DQN's
    network; same here via ModelSerializer, in the reference's file
    format)."""

    def __init__(self, net):
        self.net = net

    def nextAction(self, obs):
        q = self.net.output(np.asarray(obs, "float32")[None]).toNumpy()
        return int(np.argmax(q[0]))

    def save(self, path):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        # saveUpdater=False: an inference-only artifact has no use
        # for optimizer moments (3x the payload with Adam)
        ModelSerializer.writeModel(self.net, path, False)
        return self

    @staticmethod
    def load(path, device=None):
        """The policy of a file written by either package's save();
        the network lands on `device` (default: the card)."""
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        return DQNPolicy(ModelSerializer.restore(path, device=device))
