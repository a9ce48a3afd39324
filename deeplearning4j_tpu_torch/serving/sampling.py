"""Decode-feedback samplers with per-slot seeded RNG streams.

Copied from ``deeplearning4j_tpu/serving/sampling.py``. A sampler is a
host-side callable ``sample(logits_row, rng) -> token`` over one fp32
logits row already copied to the host; the rng is a per-request
``numpy.random.Generator`` seeded as ``default_rng((seed, stream_id))``
with stream ids assigned in submit order, so sampling is deterministic
per (seed, stream) and the serial oracle can replay it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["greedy_sampler", "temperature_sampler", "stream_rng",
           "sampled_onehot_feedback"]


def stream_rng(seed, stream_id):
    """The per-slot RNG stream: deterministic in (seed, stream_id)."""
    return np.random.default_rng((int(seed), int(stream_id)))


def greedy_sampler():
    """argmax over the logits row — deterministic, rng unused."""

    def sample(logits, rng):
        return int(np.argmax(logits))

    return sample


def temperature_sampler(temperature=1.0, top_k=None):
    """Softmax sampling at ``temperature``, optionally truncated to the
    ``top_k`` highest-logit tokens; temperature 0 is exactly greedy.
    The draw comes from the caller's per-slot rng stream."""
    temperature = float(temperature)
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    top_k = None if top_k is None else int(top_k)

    def sample(logits, rng):
        z = np.asarray(logits, np.float64)
        if temperature == 0:
            return int(np.argmax(z))
        z = z / temperature
        if top_k is not None and top_k < z.shape[0]:
            # keep the k largest; ties break by index like argpartition
            cut = np.argpartition(z, -top_k)[:-top_k]
            z = z.copy()
            z[cut] = -np.inf
        z = z - np.max(z)
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(p.shape[0], p=p))

    return sample


def sampled_onehot_feedback(vocab, sampler, rng):
    """The sampled twin of ``greedy_onehot_feedback`` for the carry-slot
    scheduler: the one-hot row of the token `sampler` draws from an
    output row with `rng` is the next input; deterministic per the
    sampler's rng stream."""
    eye = np.eye(int(vocab), dtype=np.float32)

    def feedback(out_row):
        return eye[sampler(np.asarray(out_row, np.float32), rng)]

    return feedback
