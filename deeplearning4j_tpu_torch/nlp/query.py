"""Shared word-vector query surface.

The counterpart of ``deeplearning4j_tpu/nlp/query.py`` (reference: the
WordVectors/WordVectorsImpl interface in deeplearning4j-nlp: hasWord /
getWordVector / similarity / wordsNearest), one implementation for the
trained models (Word2Vec and its subclasses, FastText) and for loaded
static tables (StaticWordVectors). Cosine scans are one [V, D] @ [D]
product over a host copy of the table.

The host copy is cached. The reference keys its cache on the table's
identity, which a fit rebinds. A torch table is updated in place
(``index_add_``), which keeps its identity, so the cache here is keyed
on the tensor and its ``_version`` counter: any in-place write, a re-fit
included, makes the next query copy the table again.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["WordVectorQuery"]


def _stamp(arr):
    return getattr(arr, "_version", None) if isinstance(arr, torch.Tensor) \
        else None


def host_array(arr):
    """A numpy copy of a tensor (any device) or an array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class WordVectorQuery:
    """Mixin over (self.vocab, self._ivocab, self._W). Subclasses may
    override _matrix() to gate access (e.g. require fit())."""

    def _host(self, attr):
        """Host copy of the table bound at self.<attr>, cached on the
        table's identity and its version counter."""
        arr = getattr(self, attr)
        cache = getattr(self, "_host_cache", None)
        if cache is None:
            cache = self._host_cache = {}
        hit = cache.get(attr)
        if hit is None or hit[0] is not arr or hit[1] != _stamp(arr):
            hit = cache[attr] = (arr, _stamp(arr), host_array(arr))
        return hit[2]

    def _matrix(self):
        return self._host("_W")

    def hasWord(self, word):
        return word in self.vocab

    def getWordVector(self, word):
        # a COPY: callers normalize in place; a live view would corrupt
        # the shared table
        return np.array(self._matrix()[self.vocab[word]])

    def similarity(self, w1, w2):
        W = self._matrix()
        a, b = W[self.vocab[w1]], W[self.vocab[w2]]
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    def wordsNearest(self, word, n=10, negative=None):
        """Nearest words by cosine. Two forms (reference: WordVectorsImpl
        .wordsNearest):

        - wordsNearest("king", 10) — neighbors of one word
        - wordsNearest(["king", "woman"], 5, negative=["man"]) — the
          analogy query: unit vectors of the positives summed, negatives
          subtracted, scaled by 1/(len(pos)+len(neg))
        """
        W = self._matrix()
        positive = [word] if isinstance(word, str) else list(word)
        neg = list(negative or [])
        if not positive and not neg:
            raise ValueError("wordsNearest needs at least one query word")
        missing = [w for w in positive + neg if w not in self.vocab]
        if missing:
            raise KeyError(f"words not in vocabulary: {missing}")

        def unit(w):
            v = W[self.vocab[w]]
            return v / (np.linalg.norm(v) + 1e-12)

        v = (sum(unit(w) for w in positive)
             - (sum(unit(w) for w in neg) if neg else 0.0)) / max(
            len(positive) + len(neg), 1)
        sims = W @ v / (np.linalg.norm(W, axis=1)
                        * (np.linalg.norm(v) + 1e-12) + 1e-12)
        order = np.argsort(-sims)
        query = set(positive) | set(neg)
        out = [self._ivocab[i] for i in order
               if self._ivocab[i] not in query]
        return out[:n]
