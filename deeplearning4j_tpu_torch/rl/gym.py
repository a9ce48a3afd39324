"""Gym-API environment adapter.

The counterpart of ``deeplearning4j_tpu/rl/gym.py``, copied.
Reference: rl4j-gym's `GymEnv` — upstream adapts OpenAI-gym
environments into rl4j's MDP interface (over gym-java-client HTTP; here
directly over the in-process Python object). Any object speaking the
gym API trains through every algorithm in this package
(QLearningDiscreteDense/Conv, AsyncNStepQLearning, A3C) unchanged.

Both gym API generations are accepted:

    reset()  -> obs                      (classic)
    reset()  -> (obs, info)              (gymnasium)
    step(a)  -> (obs, r, done, info)     (classic 4-tuple)
    step(a)  -> (obs, r, terminated, truncated, info)   (gymnasium)

Only discrete action spaces are supported (`action_space.n`), matching
upstream GymEnv<O, Integer, DiscreteSpace>.

The upstream satellites `rl4j-ale` (Atari) and `rl4j-malmo` (Minecraft)
are the same adapter pattern over those simulators' own APIs; neither
simulator ships in this zero-egress image, so their analogs stay
environment-gated: wrap the simulator's Python binding in a gym-style
object (ALE's `ale_py` and malmo's MalmoPython both provide one) and
hand it to GymEnv.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.rl.qlearning import MDP


class GymEnv(MDP):
    """Wrap a gym-API environment as an MDP.

    flatten=True (default) raveles observations to the 1-D float vector
    dense networks expect; flatten=False passes frames through unchanged
    for QLearningDiscreteConv-style pixel pipelines.
    """

    def __init__(self, env, flatten=True, seed=None):
        n = getattr(getattr(env, "action_space", None), "n", None)
        if n is None:
            raise ValueError(
                "GymEnv needs a discrete action space (action_space.n) — "
                f"got {getattr(env, 'action_space', None)!r}; continuous "
                "control is out of scope (upstream GymEnv is "
                "<O, Integer, DiscreteSpace> too)")
        shape = getattr(getattr(env, "observation_space", None),
                        "shape", None)
        if shape is None:
            raise ValueError(
                "GymEnv needs observation_space.shape to size the network")
        self._env = env
        self._n_actions = int(n)
        self._shape = tuple(int(s) for s in shape)
        self._flatten = bool(flatten)
        self._seed = seed
        self._seed_pending = seed is not None

    # ---- MDP protocol ------------------------------------------------
    def obsSize(self) -> int:
        return int(np.prod(self._shape))

    def obsShape(self) -> tuple:
        return self._shape

    def numActions(self) -> int:
        return self._n_actions

    def reset(self):
        if self._seed_pending:
            self._seed_pending = False  # gym seeds once, on first reset
            # probe reset(seed=) directly — signature inspection can't
            # see through **kwargs wrappers (TimeLimit et al. forward
            # seed inward). Only an argument-mismatch TypeError (the
            # interpreter's "unexpected keyword argument 'seed'" shape)
            # falls back to the classic env.seed() path; a TypeError
            # raised by a bug INSIDE the env — even one whose message
            # mentions 'seed' — propagates instead of silently
            # re-running unseeded.
            try:
                out = self._env.reset(seed=self._seed)
            except TypeError as e:
                msg = str(e)
                if not ("unexpected keyword argument" in msg
                        and "seed" in msg):
                    raise
                seed_fn = getattr(self._env, "seed", None)
                if callable(seed_fn):
                    seed_fn(self._seed)
                out = self._env.reset()
        else:
            out = self._env.reset()
        if isinstance(out, tuple):  # gymnasium: (obs, info)
            out = out[0]
        return self._obs(out)

    def step(self, action):
        out = self._env.step(int(action))
        if len(out) == 5:  # gymnasium: terminated | truncated
            obs, reward, terminated, truncated, _ = out
            done = bool(terminated) or bool(truncated)
        elif len(out) == 4:  # classic
            obs, reward, done, _ = out
            done = bool(done)
        else:
            raise ValueError(
                f"gym step() returned {len(out)} values; expected the "
                "4-tuple (obs, r, done, info) or 5-tuple "
                "(obs, r, terminated, truncated, info) API")
        return self._obs(obs), float(reward), done

    def close(self):
        close = getattr(self._env, "close", None)
        if close is not None:
            close()

    # ------------------------------------------------------------------
    def _obs(self, obs):
        a = np.asarray(obs, "float32")
        return a.ravel() if self._flatten else a
