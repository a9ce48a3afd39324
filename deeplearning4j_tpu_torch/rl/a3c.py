"""Advantage actor-critic for discrete action spaces.

The counterpart of ``deeplearning4j_tpu/rl/a3c.py``. Reference: rl4j
org.deeplearning4j.rl4j.learning.async.a3c.discrete.A3CDiscreteDense with
A3CLearningConfiguration (numThreads, nStep, gamma, learningRate) over the
same MDP protocol as DQN. Upstream runs `numThreads` async JVM workers
that Hogwild-update a shared net, to decorrelate samples on CPU
clusters. Here, as in the reference package, the same objective (n-step
advantage policy gradient + value regression + entropy bonus, Mnih et
al. 2016) takes its decorrelation from `numThreads` environments stepped
in lockstep: acting is one batched forward over the environments a step
(one device read of the action probabilities), and the update is one
autograd step over the whole n-step rollout with the port's
``nn.updaters.Adam``. There are no weight races between workers.

The actor-critic net is a shared tanh trunk with policy and value heads
(reference: ActorCriticFactoryCompoundStdDense), a dict of tensors on the
trainer's device. Its initial values come from ``torch.Generator(seed)``,
not the reference's ``jax.random`` draws; ``load_reference_params``
carries the reference's parameters (and Adam state) across. Every host
draw (the sampled actions) comes from ``np.random.RandomState(seed)``, as
the reference's; a sampled action can still differ between the packages
where the two softmaxes straddle a cumulative boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.rl.qlearning import BasePolicy


class A3CConfiguration:
    """Reference: A3CLearningConfiguration fields that shape the
    algorithm."""

    def __init__(self, seed=123, gamma=0.99, nStep=8, numThreads=8,
                 learningRate=1e-3, entropyCoef=0.01, valueCoef=0.5,
                 maxEpochStep=200):
        self.seed = int(seed)
        self.gamma = float(gamma)
        self.nStep = int(nStep)
        self.numThreads = int(numThreads)
        self.learningRate = float(learningRate)
        self.entropyCoef = float(entropyCoef)
        self.valueCoef = float(valueCoef)
        self.maxEpochStep = int(maxEpochStep)


def uniform_init(gen, shape, scale, device):
    """U(-scale, scale) f32 from the CPU generator `gen`, on `device`."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(device)


def tensors(tree, device):
    """A numpy dict tree as f32 tensors of their own on `device` (copies:
    the updater writes its state in place)."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def carried(params, current, device):
    """The reference trainer's numpy parameters as tensors on `device`,
    after checking their names and shapes against `current`'s."""
    if set(params) != set(current):
        raise ValueError(f"reference params {sorted(params)} vs "
                         f"{sorted(current)}")
    new = tensors(params, device)
    for k, v in new.items():
        if v.shape != current[k].shape:
            raise ValueError(f"{k}: reference {tuple(v.shape)} vs "
                             f"{tuple(current[k].shape)}")
    return new


def on(device, a, dtype=np.float32):
    """A host batch (numpy) as a tensor on `device`."""
    return torch.from_numpy(np.asarray(a, dtype)).to(device)


def step_envs(envs, acts, ep_steps, maxEpochStep, obs):
    """Step every environment once with its action: -> (next
    observations, rewards, dones); a finished episode (done, or
    `maxEpochStep` steps) resets its environment and its step count."""
    nxt = np.empty_like(obs)
    rews = np.zeros(len(envs), "float32")
    dones = np.zeros(len(envs), "float32")
    for i, (env, a) in enumerate(zip(envs, acts)):
        o2, r, d = env.step(int(a))
        ep_steps[i] += 1
        if ep_steps[i] >= maxEpochStep:
            d = True
        rews[i], dones[i] = r, float(d)
        nxt[i] = np.asarray(o2 if not d else env.reset(), "float32")
        if d:
            ep_steps[i] = 0
    return nxt, rews, dones


def discounted(R, D, boot, gamma):
    """n-step returns, bootstrapped from `boot` per environment; a done
    cuts the chain. -> one array per step, in step order."""
    ret = boot
    out = []
    for t in reversed(range(len(R))):
        ret = R[t] + gamma * ret * (1.0 - D[t])
        out.append(ret)
    out.reverse()
    return out


def _forward(p, x):
    h = torch.tanh(x @ p["W1"] + p["b1"])
    logits = h @ p["Wp"] + p["bp"]
    value = (h @ p["Wv"] + p["bv"])[:, 0]
    return logits, value


class A3CDiscreteDense:
    """Actor-critic trainer (reference: A3CDiscreteDense).

    `mdpFactory`: zero-arg callable returning a fresh MDP (upstream:
    MDP.newInstance() gives each worker its own copy). `hiddenSize`
    sizes the shared trunk (reference default factory: one dense layer).
    `device`: where the parameters live (default: the card).
    """

    def __init__(self, mdpFactory, config=None, hiddenSize=32, device=None):
        self.conf = config or A3CConfiguration()
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
            "Wp": uniform_init(gen, (H, self.numActions), s2, dev),
            "bp": torch.zeros(self.numActions, device=dev),
            "Wv": uniform_init(gen, (H, 1), s2, dev),
            "bv": torch.zeros(1, device=dev),
        }
        self._updater = _upd.Adam(c.learningRate)
        self._upd_state = self._updater.init(self.params)
        self._iteration = 0
        self._rng = np.random.RandomState(c.seed)
        self._step = 0
        self._policy_losses = []
        self._value_losses = []

    def load_reference_params(self, params, updater_state=None):
        """Take the reference trainer's parameters (numpy dict, its
        ``params`` after ``np.asarray``) and, when given, its Adam state
        ({"m": {...}, "v": {...}}); without one the Adam state starts at
        zero. The iteration count is left as it is."""
        self.params = carried(params, self.params, self.device)
        self._upd_state = (self._updater.init(self.params)
                           if updater_state is None
                           else tensors(updater_state, self.device))
        return self

    # ---------------- rollout collection ------------------------------
    def _policy_probs(self, obs_batch):
        with torch.no_grad():
            logits, _ = _forward(self.params, on(self.device, obs_batch))
            return torch.softmax(logits, -1).cpu().numpy()

    def _values(self, obs_batch):
        with torch.no_grad():
            return _forward(self.params,
                            on(self.device, obs_batch))[1].cpu().numpy()

    def _update(self, obs, acts, returns):
        """One Adam step on a flat rollout (numpy: [N, obs], [N] actions,
        [N] returns): -> (policy loss, value loss) as device scalars.
        The parameters become a NEW dict of new tensors, as the
        reference's functional step rebinds its: a policy or snapshot
        holding the old dict keeps the old values (``ACPolicy``'s live
        view tells the two apart by the dict's identity)."""
        c = self.conf
        obs, returns = on(self.device, obs), on(self.device, returns)
        acts = on(self.device, acts, np.int64)
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        logits, value = _forward(p, obs)
        logp = torch.log_softmax(logits, -1)
        probs = torch.softmax(logits, -1)
        adv = (returns - value).detach()
        pg = -torch.mean(logp.gather(1, acts[:, None])[:, 0] * adv)
        v = torch.mean((returns - value) ** 2)
        ent = -torch.mean(torch.sum(probs * logp, -1))
        loss = pg + c.valueCoef * v - c.entropyCoef * ent
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            upd, self._upd_state = self._updater.apply(
                grads, self._upd_state, self._iteration)
            self.params = {k: p[k].detach() - upd[k] for k in p}
        self._iteration += 1
        return pg.detach(), v.detach()

    def train(self, maxSteps=10_000):
        c = self.conf
        obs = np.stack([np.asarray(e.reset(), "float32")
                        for e in self._envs])
        ep_steps = np.zeros(len(self._envs), int)
        while self._step < maxSteps:
            O, A, R, D = [], [], [], []
            for _ in range(c.nStep):
                probs = self._policy_probs(obs)
                acts = np.array([self._rng.choice(self.numActions, p=pr)
                                 for pr in probs])
                nxt, rews, dones = step_envs(self._envs, acts, ep_steps,
                                             c.maxEpochStep, obs)
                O.append(obs.copy())
                A.append(acts)
                R.append(rews)
                D.append(dones)
                obs = nxt
                self._step += len(self._envs)
            returns = discounted(R, D, self._values(obs), c.gamma)
            pg, v = self._update(np.concatenate(O), np.concatenate(A),
                                 np.concatenate(returns))
            self._policy_losses.append(float(pg))
            self._value_losses.append(float(v))
        return self

    # ---------------- policy ------------------------------------------
    def getPolicy(self, greedy=True):
        """Reference: policy.ACPolicy (greedy=False samples, matching
        upstream's stochastic ACPolicy with an rng)."""
        # live supplier: the policy tracks further train() calls, like
        # DQNPolicy does through its mutable net reference
        return ACPolicy(lambda: self.params, greedy=greedy,
                        seed=self.conf.seed)


def _host(v):
    """A parameter (tensor or array) as a host f32 array of its own."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.array(v, dtype=np.float32)


class ACPolicy(BasePolicy):
    """Actor-critic policy, persistable (reference: rl4j policy.ACPolicy
    save/load; the ``.npz`` file reads in either package). Holds the
    actor-critic parameter dict; inference is a host-side numpy forward
    (single observations, no device round trip), the trainer's tanh
    actor head exactly."""

    def __init__(self, params, greedy=True, seed=0):
        """`params`: a parameter dict (snapshot — what load() gives), or
        a zero-arg callable returning one (live view — what
        getPolicy() gives, so the policy tracks further training).
        The live view is copied to the host lazily and again only when
        the trainer has REBOUND its params dict (an identity check in
        _probs: every update makes a new dict, so no device transfer
        happens unless training actually did)."""
        self._supplier = params if callable(params) else (lambda: params)
        self.greedy = bool(greedy)
        self._rng = np.random.RandomState(seed)
        self._cached = None
        self._cached_src = None

    @property
    def params(self):
        return {k: _host(v) for k, v in self._supplier().items()}

    def onEpisodeStart(self):
        self._materialize()

    def _materialize(self):
        self._cached_src = self._supplier()
        self._cached = {k: _host(v) for k, v in self._cached_src.items()}

    def _probs(self, obs):
        if self._cached is None or self._supplier() is not self._cached_src:
            self._materialize()
        p = self._cached
        h = np.tanh(obs @ p["W1"] + p["b1"])
        logits = h @ p["Wp"] + p["bp"]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def nextAction(self, obs):
        probs = self._probs(np.asarray(obs, "float32")[None])[0]
        if self.greedy:
            return int(np.argmax(probs))
        return int(self._rng.choice(len(probs), p=probs))

    def save(self, path):
        # file object: np.savez(str) appends ".npz" to other extensions
        with open(str(path), "wb") as f:
            np.savez(f, **self.params)
        return self

    @staticmethod
    def load(path, greedy=True, seed=0):
        with np.load(str(path)) as z:
            params = {k: z[k] for k in z.files}
        return ACPolicy(params, greedy=greedy, seed=seed)
