"""Async n-step Q-learning for discrete action spaces.

The counterpart of ``deeplearning4j_tpu/rl/async_nstep.py``. Reference:
rl4j org.deeplearning4j.rl4j.learning.async.nstep.discrete
.AsyncNStepQLearningDiscreteDense with AsyncQLearningConfiguration
(numThreads, nStep, gamma, targetDqnUpdateFreq, epsilon schedule).
Upstream's third algorithm family: Hogwild workers accumulate n-step
Q-gradients against a shared target net. Same shape as ``rl/a3c.py``:
`numThreads` environments act in lockstep (epsilon-greedy over one
batched forward), the n-step targets bootstrap from a periodically
synced target network (a clone, ``util.pytree.device_copy_tree``), and
the update is one autograd step over the whole rollout with the port's
``nn.updaters.Adam``. Initial parameters come from
``torch.Generator(seed)``; ``load_reference_params`` carries the
reference's across. Host draws (exploration, random actions) come from
``np.random.RandomState(seed)``, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.rl.a3c import (carried, discounted, on,
                                             step_envs, tensors,
                                             uniform_init)
from deeplearning4j_tpu_torch.rl.qlearning import BasePolicy
from deeplearning4j_tpu_torch.util.pytree import device_copy_tree


class AsyncNStepQLConfiguration:
    """Reference: AsyncQLearningConfiguration fields that shape the
    algorithm (epsilon anneals linearly to minEpsilon over
    epsilonNbStep environment steps, as upstream's EpsGreedy does)."""

    def __init__(self, seed=123, gamma=0.99, nStep=8, numThreads=8,
                 learningRate=1e-3, targetDqnUpdateFreq=50,
                 minEpsilon=0.05, epsilonNbStep=3000, maxEpochStep=200):
        self.seed = int(seed)
        self.gamma = float(gamma)
        self.nStep = int(nStep)
        self.numThreads = int(numThreads)
        self.learningRate = float(learningRate)
        self.targetDqnUpdateFreq = int(targetDqnUpdateFreq)
        self.minEpsilon = float(minEpsilon)
        self.epsilonNbStep = int(epsilonNbStep)
        self.maxEpochStep = int(maxEpochStep)


def _q_values(p, x):
    h = torch.tanh(x @ p["W1"] + p["b1"])
    return h @ p["Wq"] + p["bq"]


class AsyncNStepQLearningDiscreteDense:
    """n-step Q trainer (reference: AsyncNStepQLearningDiscreteDense).

    `mdpFactory`: zero-arg callable returning a fresh MDP (upstream:
    MDP.newInstance() per worker). `device`: where the parameters live
    (default: the card)."""

    def __init__(self, mdpFactory, config=None, hiddenSize=32, device=None):
        self.conf = config or AsyncNStepQLConfiguration()
        c = self.conf
        self.device = resolve_device(device)
        self._envs = [mdpFactory() for _ in range(c.numThreads)]
        mdp = self._envs[0]
        self.obsSize = mdp.obsSize()
        self.numActions = mdp.numActions()
        H = int(hiddenSize)
        gen = torch.Generator().manual_seed(c.seed)
        s1 = 1.0 / np.sqrt(self.obsSize)
        s2 = 1.0 / np.sqrt(H)
        dev = self.device
        self.params = {
            "W1": uniform_init(gen, (self.obsSize, H), s1, dev),
            "b1": torch.zeros(H, device=dev),
            "Wq": uniform_init(gen, (H, self.numActions), s2, dev),
            "bq": torch.zeros(self.numActions, device=dev),
        }
        self.targetParams = device_copy_tree(self.params)
        self._updater = _upd.Adam(c.learningRate)
        self._upd_state = self._updater.init(self.params)
        self._iteration = 0
        self._rng = np.random.RandomState(c.seed)
        self._step = 0
        self._losses = []

    def load_reference_params(self, params, updater_state=None):
        """Take the reference trainer's parameters (numpy dict) and, when
        given, its Adam state; the target net becomes a clone of them
        (the reference's starts as a copy of its init)."""
        self.params = carried(params, self.params, self.device)
        self.targetParams = device_copy_tree(self.params)
        self._upd_state = (self._updater.init(self.params)
                           if updater_state is None
                           else tensors(updater_state, self.device))
        return self

    def _epsilon(self):
        c = self.conf
        frac = min(1.0, self._step / max(1, c.epsilonNbStep))
        return 1.0 + frac * (c.minEpsilon - 1.0)

    def _q(self, params, obs):
        with torch.no_grad():
            return _q_values(params, on(self.device, obs)).cpu().numpy()

    def _update(self, obs, acts, targets):
        """One Adam step on a flat rollout (numpy): -> the TD loss as a
        device scalar. The parameters become a new dict of new tensors."""
        obs, targets = on(self.device, obs), on(self.device, targets)
        acts = on(self.device, acts, np.int64)
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        q_sa = _q_values(p, obs).gather(1, acts[:, None])[:, 0]
        loss = torch.mean((targets - q_sa) ** 2)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            upd, self._upd_state = self._updater.apply(
                grads, self._upd_state, self._iteration)
            self.params = {k: p[k].detach() - upd[k] for k in p}
        self._iteration += 1
        return loss.detach()

    def train(self, maxSteps=10_000):
        c = self.conf
        obs = np.stack([np.asarray(e.reset(), "float32")
                        for e in self._envs])
        ep_steps = np.zeros(len(self._envs), int)
        while self._step < maxSteps:
            O, A, R, D = [], [], [], []
            for _ in range(c.nStep):
                acts = self._q(self.params, obs).argmax(1)
                explore = self._rng.rand(len(self._envs)) < self._epsilon()
                acts[explore] = self._rng.randint(
                    0, self.numActions, int(explore.sum()))
                nxt, rews, dones = step_envs(self._envs, acts, ep_steps,
                                             c.maxEpochStep, obs)
                O.append(obs.copy())
                A.append(acts.astype(np.int64))
                R.append(rews)
                D.append(dones)
                obs = nxt
                self._step += len(self._envs)
            # n-step targets bootstrapped from max_a Q_target(s_{t+n});
            # a done cuts the bootstrap chain (upstream semantics)
            targets = discounted(R, D, self._q(self.targetParams, obs)
                                 .max(1), c.gamma)
            loss = self._update(np.concatenate(O), np.concatenate(A),
                                np.concatenate(targets))
            self._losses.append(float(loss))
            if self._iteration % c.targetDqnUpdateFreq == 0:
                self.targetParams = device_copy_tree(self.params)
        return self

    def getPolicy(self):
        """Greedy Q policy (reference: policy.DQNPolicy)."""
        outer = self

        class _Policy(BasePolicy):
            def nextAction(self, obs):
                return int(outer._q(outer.params,
                                    np.asarray(obs, "float32")[None])[0]
                           .argmax())

        return _Policy()
