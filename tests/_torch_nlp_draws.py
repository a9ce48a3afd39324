"""The reference's random numbers, handed to the port through its
``util.draws.Draws`` seam.

``RefDraws(seed)`` answers each named draw of the port's word-vector,
clustering and t-SNE fits with the number the reference draws at the
same point, from the reference's own threefry keys
(``deeplearning4j_tpu/nlp/word2vec.py``, ``glove.py``, ``fasttext.py``,
``clustering/kmeans.py``, ``clustering/lsh.py``, ``plot/tsne.py``). With
it, both packages compute the same function, so a parity test compares
trained tables, not seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu_torch.util.draws import Draws


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


class RefDraws(Draws):
    """The reference's draws for a model built with `seed`."""

    def __init__(self, seed):
        super().__init__(seed, "cpu")
        self.names = []
        s = int(seed)
        rng = jax.random.key(s)
        init_k, shuf_k = jax.random.split(rng)
        kw, kd = jax.random.split(init_k)
        dbow = jax.random.split(jax.random.key(s ^ 0xD0C), 3)
        inf_init, inf_samp = jax.random.split(jax.random.key(s ^ 0x1FE12))
        g0, g_shuf = jax.random.split(rng)
        gks = jax.random.split(g0, 4)
        self._uniform = {
            "word2vec.W": init_k, "dm.W": kw, "dm.Dv": kd,
            "dbow.Dv": dbow[0], "infer.v": inf_init,
            "glove.W": gks[0], "glove.Wt": gks[1],
            "fasttext.Win": kw, "fasttext.G": kd, "fasttext.E": init_k}
        self._perm = {"word2vec.perm": shuf_k, "dm.perm": shuf_k,
                      "dbow.perm": dbow[1], "glove.perm": g_shuf,
                      "fasttext.perm": shuf_k}
        self._neg = {"word2vec.neg": (rng, 100003),
                     "dm.neg": (rng, 100003),
                     "dbow.neg": (dbow[2], 99991),
                     "fasttext.neg": (rng, 100003)}
        self._rng = rng
        self._inf_samp = inf_samp

    def uniform(self, what, shape, *index):
        self.names.append(what)
        return _t(jax.random.uniform(self._uniform[what], tuple(shape),
                                     jnp.float32))

    def normal(self, what, shape, *index):
        self.names.append(what)
        return _t(jax.random.normal(self._rng, tuple(shape), jnp.float32))

    def permutation(self, what, n, *index):
        self.names.append(what)
        epoch, = index
        return _t(jax.random.permutation(
            jax.random.fold_in(self._perm[what], epoch), int(n)),
            torch.int64)

    def choice(self, what, probs, shape, *index):
        self.names.append(what)
        p = jnp.asarray(probs.detach().cpu().numpy())
        if what == "infer.neg":
            key = jax.random.fold_in(self._inf_samp, index[0])
        else:
            base, mult = self._neg[what]
            epoch, start = index
            key = jax.random.fold_in(base, epoch * mult + start)
        return _t(jax.random.choice(key, p.shape[0], tuple(shape), p=p),
                  torch.int64)

    def randint(self, what, high, *index):
        self.names.append(what)
        return int(jax.random.randint(self._rng, (), 0, int(high)))


def max_abs_rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))
