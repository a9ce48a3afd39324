"""GloVe — global co-occurrence factorization.

The counterpart of ``deeplearning4j_tpu/nlp/glove.py`` (reference:
deeplearning4j-nlp org.deeplearning4j.models.glove.Glove, after
Pennington et al. 2014). The co-occurrence table is built on the host
once — symmetric, 1/distance weights, in the reference's ``defaultdict``
insertion order, with numpy instead of a Python dict — into the same
``(i, j, log X, f(X))`` arrays. Training is AdaGrad over W, W̃ and both
biases with the reference's accumulators (they start at 1): each step's
gradient of the batch's mean weighted squared error is scattered into
dense per-table gradients, so the update is the reference's dense one.
Word vectors are W + W̃; W̃ is kept as the context table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec, device_table,
                                                   flat_tokens, leaf,
                                                   run_epochs)
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["Glove", "cooccurrences"]


def cooccurrences(id_lists, windowSize):
    """-> (i, j) int32 and X f32 over every co-occurring pair, ordered by
    first occurrence: for each token, each later token within the window
    adds 1/distance to (a, b) and then to (b, a)."""
    tok, pos, length, _ = flat_tokens(id_lists)
    if tok.size == 0:
        return (np.zeros(0, "int32"),) * 2 + (np.zeros(0, "float32"),)
    V = int(tok.max()) + 1
    d = np.arange(1, windowSize + 1)
    valid = (pos[:, None] + d[None, :]) < length[:, None]    # [T, w]
    gi = np.arange(tok.size)[:, None] + d[None, :]
    a = np.broadcast_to(tok[:, None], valid.shape)[valid]
    b = tok[gi[valid]]
    w = np.broadcast_to(1.0 / d, valid.shape)[valid]
    # events in the reference's order: (a, b) then (b, a), pair by pair
    codes = np.stack([a * V + b, b * V + a], 1).reshape(-1)
    vals = np.repeat(w, 2)
    uniq, first, inv = np.unique(codes, return_index=True,
                                 return_inverse=True)
    sums = np.bincount(inv, weights=vals, minlength=uniq.size)
    order = np.argsort(first, kind="stable")
    keys = uniq[order]
    return ((keys // V).astype("int32"), (keys % V).astype("int32"),
            sums[order].astype("float32"))


class Glove(Word2Vec):
    class Builder(Word2Vec.Builder):
        def xMax(self, x):
            self._kw["xMax"] = float(x)
            return self

        def alpha(self, a):
            self._kw["alpha"] = float(a)
            return self

        def epochs(self, n):  # upstream Glove.Builder calls it epochs
            self._kw["iterations"] = int(n)
            return self

        def build(self):
            return Glove(**self._kw)

    def __init__(self, xMax=100.0, alpha=0.75, learningRate=0.05,
                 batchSize=4096, **kw):
        kw.setdefault("negative", 0)  # unused; GloVe has no neg sampling
        super().__init__(learningRate=learningRate, batchSize=batchSize, **kw)
        self.xMax = float(xMax)
        self.alpha = float(alpha)
        self._params = self._acc = None
        self._carry = False   # load_reference_params: the next fit continues

    def _cooccurrences(self):
        self._scan_vocab()
        t0 = time.perf_counter()
        ii, jj, xx = cooccurrences(self._ids, self.windowSize)
        self.cooccurrenceSeconds = time.perf_counter() - t0
        if not ii.size:
            raise ValueError("no co-occurrences (sentences too short?)")
        return ii, jj, xx

    def fit(self, device=None, draws=None, steps=None):
        """Build the co-occurrences and train on `device` (default: the
        Builder's, else the card); `draws` and `steps` as Word2Vec's."""
        dev = self._device(device)
        draws = draws if draws is not None else Draws(self.seed, dev)
        ii, jj, xx = self._cooccurrences()
        self.cooccurrenceEntries = int(ii.size)
        logx = np.log(xx)
        fx = np.minimum((xx / self.xMax) ** self.alpha, 1.0).astype("float32")
        V, D = len(self.vocab), self.layerSize
        scale = np.float32(0.5 / D)
        with torch.no_grad():
            if not self._carry or self._params["W"].shape != (V, D):
                p = {}
                for name in ("W", "Wt"):
                    u = draws.uniform(f"glove.{name}", (V, D)).to(dev)
                    p[name] = u * (2 * scale) - scale
                p["b"] = torch.zeros(V, device=dev)
                p["bt"] = torch.zeros(V, device=dev)
                self._params = p
                self._acc = {k: torch.ones_like(v) for k, v in p.items()}
            self._carry = False
            self._train(dev, draws, steps, ii, jj, logx, fx)
        return self

    def _train(self, dev, draws, steps, ii, jj, logx, fx):
        p, acc = self._params, self._acc
        i_d = device_table(ii, dev, torch.int64)
        j_d = device_table(jj, dev, torch.int64)
        t_d = device_table(logx, dev)
        f_d = device_table(fx, dev)
        lr = self.learningRate
        rows = {"W": "i", "b": "i", "Wt": "j", "bt": "j"}

        def step(idx, epoch, s):
            i, j, t, f = i_d[idx], j_d[idx], t_d[idx], f_d[idx]
            with torch.enable_grad():
                g = {"W": leaf(p["W"][i]), "Wt": leaf(p["Wt"][j]),
                     "b": leaf(p["b"][i]), "bt": leaf(p["bt"][j])}
                err = (g["W"] * g["Wt"]).sum(-1) + g["b"] + g["bt"] - t
                loss = (f * err * err).mean()
                grads = torch.autograd.grad(loss, list(g.values()))
            for (name, _), gr in zip(g.items(), grads):
                dense = torch.zeros_like(p[name]).index_add_(
                    0, i if rows[name] == "i" else j, gr)
                acc[name].add_(dense * dense)
                p[name].sub_(lr * dense * torch.rsqrt(acc[name]))
            return loss.detach()

        self._finish(run_epochs(ii.shape[0], self.batchSize,
                                self.iterations, draws, "glove.perm", step,
                                steps))
        self._bake()

    def _bake(self):
        self._W = self._params["W"] + self._params["Wt"]
        self._C = self._params["Wt"]

    def load_reference_params(self, W, Wt, b, bt, acc=None, device=None):
        """The reference's raw tables (numpy; its `params` W, Wt, b, bt)
        and, optionally, its AdaGrad accumulators (a dict of the same
        keys); the next fit() continues from them."""
        dev = self._device(device)
        self._params = {k: device_table(v, dev)
                        for k, v in (("W", W), ("Wt", Wt), ("b", b),
                                     ("bt", bt))}
        self._acc = ({k: device_table(acc[k], dev) for k in self._params}
                     if acc is not None else
                     {k: torch.ones_like(v) for k, v in self._params.items()})
        self.layerSize = int(self._params["W"].shape[1])
        self._carry = True
        self._bake()
        return self
