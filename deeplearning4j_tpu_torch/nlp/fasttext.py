"""FastText — subword-enriched word vectors and text classification.

The counterpart of ``deeplearning4j_tpu/nlp/fasttext.py`` (reference:
deeplearning4j-nlp org.deeplearning4j.models.fasttext.FastText, after
Bojanowski et al. 2017). The char n-grams (``<word>`` between minn and
maxn) and their FNV-1a hashes over the UTF-8 bytes are the reference's
exactly. A word's representation is the mean of its own row and its
subword rows: a [V, D] word table beside a [bucket, D] subword table,
gathered through a padded [V, S] subword-id matrix.

Two modes: unsupervised skip-gram with negative sampling on that
representation, and supervised classification (words plus hashed word
n-grams, mean pooled, softmax over the labels). Gradients are minibatch
means, as the whole nlp family's; the rows' gradients are scattered into
the tables (the subword table is 2,000,000 rows at the CLI's default
bucket), the same function as the reference's dense update. ``_W`` holds
the effective per-word vectors the query API reads.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.query import WordVectorQuery, host_array
from deeplearning4j_tpu_torch.nlp.word2vec import (
    DefaultTokenizerFactory, Word2Vec, device_table, leaf, ns_step,
    run_epochs, scatter_sgd, skipgram_pairs)
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["FastText"]


def _ngrams(word, minn, maxn):
    """Char n-grams of `<word>` between minn and maxn, fastText-style
    (Dictionary::computeSubwords): the bracketed word itself is one of
    them whenever its length lies in [minn, maxn]."""
    w = "<" + word + ">"
    out = []
    for n in range(minn, maxn + 1):
        if n > len(w):
            break
        out.extend(w[i:i + n] for i in range(len(w) - n + 1))
    return out


def _fnv1a(s):
    """FNV-1a 32-bit over the UTF-8 bytes (Dictionary::hash)."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class FastText(WordVectorQuery):
    """Builder-constructed FastText model (unsupervised skip-gram or
    supervised classification)."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def supervised(self, flag=True):
            self._kw["supervised"] = bool(flag)
            return self

        def skipgram(self, flag=True):
            if flag:
                self._kw["supervised"] = False
            return self

        def minCount(self, n):
            self._kw["minCount"] = int(n)
            return self

        def dim(self, n):
            self._kw["dim"] = int(n)
            return self

        def contextWindow(self, n):
            self._kw["contextWindow"] = int(n)
            return self

        def negativeSamples(self, n):
            self._kw["negative"] = int(n)
            return self

        def bucket(self, n):
            self._kw["bucket"] = int(n)
            return self

        def minNgramLength(self, n):
            self._kw["minn"] = int(n)
            return self

        def maxNgramLength(self, n):
            self._kw["maxn"] = int(n)
            return self

        def wordNgrams(self, n):
            self._kw["wordNgrams"] = int(n)
            return self

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = float(lr)
            return self

        def labelPrefix(self, p):
            self._kw["labelPrefix"] = str(p)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def batchSize(self, n):
            self._kw["batchSize"] = int(n)
            return self

        def iterate(self, sentenceIterator):
            self._kw["iterator"] = sentenceIterator
            return self

        def tokenizerFactory(self, tf):
            self._kw["tokenizer"] = tf
            return self

        def device(self, d):
            """Where fit() trains (None: the card)."""
            self._kw["device"] = d
            return self

        def build(self):
            return FastText(**self._kw)

    def __init__(self, iterator=None, tokenizer=None, supervised=False,
                 minCount=1, dim=100, contextWindow=5, negative=5,
                 bucket=2000, minn=3, maxn=6, wordNgrams=1, epochs=5,
                 learningRate=None, labelPrefix="__label__", seed=42,
                 batchSize=1024, device=None):
        self.iterator = iterator
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.supervised_mode = supervised
        self.minCount = minCount
        self.layerSize = self.dim = dim
        self.contextWindow = contextWindow
        self.negative = negative
        self.bucket = bucket
        self.minn = minn
        self.maxn = maxn
        self.wordNgrams = wordNgrams
        self.epochs = epochs
        # the reference's mode-dependent default (0.05 skip-gram, 0.5
        # supervised: minibatch means take few steps on small corpora)
        self.learningRate = (0.5 if supervised else 0.05) \
            if learningRate is None else learningRate
        self.labelPrefix = labelPrefix
        self.seed = seed
        self.batchSize = batchSize
        self.device = device
        self.vocab = {}
        self._ivocab = []
        self.labels = []           # supervised: index -> label string
        self._W = None             # [V, D] effective word vectors (query)
        self._Win = None           # [V, D] raw word input table
        self._G = None             # [bucket, D] subword table
        self._L = None             # supervised: [n_labels, D] + bias
        self.stepsTaken = 0
        self.trainLog = None

    # ------------- host-side corpus scan -----------------------------
    def _sub_ids(self, word):
        return [_fnv1a(g) % self.bucket for g in
                _ngrams(word, self.minn, self.maxn)]

    def _scan(self):
        """Tokenize the corpus; split off labels in supervised mode."""
        counts = Counter()
        sents, labels = [], []
        self.iterator.reset()
        while self.iterator.hasNext():
            raw = self.iterator.nextSentence()
            label = None
            if self.supervised_mode:
                parts = raw.split()
                tags = [p for p in parts if p.startswith(self.labelPrefix)]
                if not tags:
                    raise ValueError(
                        f"supervised example has no {self.labelPrefix!r}"
                        f" token: {raw[:60]!r}")
                label = tags[0][len(self.labelPrefix):]
                raw = " ".join(p for p in parts
                               if not p.startswith(self.labelPrefix))
            toks = self.tokenizer.create(raw)
            sents.append(toks)
            labels.append(label)
            counts.update(toks)
        vocab_words = sorted(
            (w for w, c in counts.items() if c >= self.minCount),
            key=lambda w: (-counts[w], w))
        if not vocab_words:
            raise ValueError(
                f"empty vocabulary (minCount={self.minCount})")
        self.vocab = {w: i for i, w in enumerate(vocab_words)}
        self._ivocab = vocab_words
        f = np.array([counts[w] for w in vocab_words], "float64") ** 0.75
        self._freq = (f / f.sum()).astype("float32")
        self._sents, self._labels_raw = sents, labels

    def _subword_matrix(self):
        """Padded [V, S] subword-row matrix + [V, S] mask (cached per
        vocabulary)."""
        cached = getattr(self, "_subword_cache", None)
        if cached is not None and cached[0] is self._ivocab:
            return cached[1], cached[2]
        rows = [self._sub_ids(w) for w in self._ivocab]
        S = max(1, max(len(r) for r in rows))
        ids = np.zeros((len(rows), S), "int32")
        mask = np.zeros((len(rows), S), "float32")
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1.0
        self._subword_cache = (self._ivocab, ids, mask)
        return ids, mask

    # ------------- training ------------------------------------------
    def fit(self, device=None, draws=None, steps=None):
        """Scan and train on `device` (default: the Builder's, else the
        card). `draws`: a util.draws.Draws (default seeded by `seed` on
        the device); `steps` stops after that many steps."""
        dev = resolve_device(device if device is not None else self.device)
        draws = draws if draws is not None else Draws(self.seed, dev)
        self._scan()
        with torch.no_grad():
            if self.supervised_mode:
                self._fit_supervised(dev, draws, steps)
            else:
                self._fit_skipgram(dev, draws, steps)
        return self

    def _pairs(self):
        get = self.vocab.get
        ids = [[i for i in map(get, toks) if i is not None]
               for toks in self._sents]
        centers, contexts = skipgram_pairs(ids, self.contextWindow)
        if not centers.size:
            raise ValueError("no training pairs (sentences too short?)")
        return centers, contexts

    def _fit_skipgram(self, dev, draws, steps):
        centers, contexts = self._pairs()
        V, D, K = len(self.vocab), self.dim, self.negative
        sub_ids, sub_mask = self._subword_matrix()
        sid_d = device_table(sub_ids, dev, torch.int64)
        smk_d = device_table(sub_mask, dev)
        Win = (draws.uniform("fasttext.Win", (V, D)).to(dev) - 0.5) / D
        G = (draws.uniform("fasttext.G", (self.bucket, D)).to(dev) - 0.5) / D
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        freq = device_table(self._freq, dev)
        ctr_d = device_table(centers, dev, torch.int64)
        ctx_d = device_table(contexts, dev, torch.int64)
        lr = self.learningRate

        def step(idx, epoch, s):
            ctr, ctx = ctr_d[idx], ctx_d[idx]
            sids, m = sid_d[ctr], smk_d[ctr]
            neg = draws.choice("fasttext.neg", freq, (ctr.shape[0], K),
                               epoch, s).to(dev)
            den = 1.0 + m.sum(1, keepdim=True)
            h = (Win[ctr] + (G[sids] * m[..., None]).sum(1)) / den
            loss, gh, gc, gcn = ns_step(h, C[ctx], C[neg])
            scatter_sgd(Win, ctr, gh / den, lr)
            scatter_sgd(G, sids, gh[:, None, :] * (m / den)[..., None], lr)
            scatter_sgd(C, ctx, gc, lr)
            scatter_sgd(C, neg, gcn, lr)
            return loss.detach()

        self._Win, self._G, self._C = Win, G, C
        self._finish(run_epochs(centers.shape[0], self.batchSize,
                                self.epochs, draws, "fasttext.perm", step,
                                steps))
        self._bake_vectors()

    def _features(self, toks):
        """Supervised feature ids of one example: vocab rows, plus word
        n-grams (n <= wordNgrams) hashed into V + bucket space."""
        V = len(self.vocab)
        ids = [self.vocab[t] for t in toks if t in self.vocab]
        feats = list(ids)
        for n in range(2, self.wordNgrams + 1):
            for i in range(len(toks) - n + 1):
                g = " ".join(toks[i:i + n])
                feats.append(V + _fnv1a(g) % self.bucket)
        return feats

    def _supervised_rows(self):
        label_names = sorted({l for l in self._labels_raw if l is not None})
        lab_idx = {l: i for i, l in enumerate(label_names)}
        rows, ys = [], []
        for toks, lab in zip(self._sents, self._labels_raw):
            feats = self._features(toks)
            if not feats:
                continue
            rows.append(feats)
            ys.append(lab_idx[lab])
        if not rows:
            raise ValueError("no supervised examples with known features")
        T = max(len(r) for r in rows)
        X = np.zeros((len(rows), T), "int32")
        M = np.zeros((len(rows), T), "float32")
        for i, r in enumerate(rows):
            X[i, :len(r)] = r
            M[i, :len(r)] = 1.0
        return label_names, X, M, np.asarray(ys, "int32")

    def _fit_supervised(self, dev, draws, steps):
        self.labels, X, M, y = self._supervised_rows()
        N, V, D = X.shape[0], len(self.vocab), self.dim
        nlab = len(self.labels)
        E = (draws.uniform("fasttext.E", (V + self.bucket, D)).to(dev)
             - 0.5) / D
        L = torch.zeros((nlab, D), dtype=torch.float32, device=dev)
        b = torch.zeros((nlab,), dtype=torch.float32, device=dev)
        X_d = device_table(X, dev, torch.int64)
        M_d = device_table(M, dev)
        y_d = device_table(y, dev, torch.int64)
        lr = self.learningRate

        def step(idx, epoch, s):
            x, m, yy = X_d[idx], M_d[idx], y_d[idx]
            with torch.enable_grad():
                e, Lw, bw = leaf(E[x]), leaf(L), leaf(b)
                h = (e * m[..., None]).sum(1) / m.sum(1, keepdim=True)
                lp = F.log_softmax(h @ Lw.T + bw, -1)
                loss = -lp.gather(1, yy[:, None])[:, 0].mean()
                ge, gL, gb = torch.autograd.grad(loss, (e, Lw, bw))
            scatter_sgd(E, x, ge, lr)
            L.sub_(lr * gL)
            b.sub_(lr * gb)
            return loss.detach()

        self._E, self._L, self._b = E, L, b
        self._finish(run_epochs(N, self.batchSize, self.epochs, draws,
                                "fasttext.perm", step, steps))
        self._W = E[:V]

    _finish = Word2Vec._finish    # the same bookkeeping of a TrainLog

    def _bake_vectors(self):
        """Effective per-word vectors (word row + subword mean), once on
        the tables' device."""
        sub_ids, sub_mask = self._subword_matrix()
        dev = self._Win.device
        ids = device_table(sub_ids, dev, torch.int64)
        m = device_table(sub_mask, dev)
        with torch.no_grad():
            tot = self._Win + (self._G[ids] * m[..., None]).sum(1)
            self._W = tot / (1.0 + m.sum(1, keepdim=True))

    # ------------- reference arrays -----------------------------------
    def load_reference_params(self, Win=None, G=None, C=None, E=None,
                              L=None, b=None, device=None):
        """The reference model's tables (numpy), in this model's
        vocabulary order: Win, G and C (skip-gram), or E, L and b
        (supervised). The query vectors are baked from them."""
        dev = resolve_device(device if device is not None else self.device)
        if self.supervised_mode:
            self._E, self._L, self._b = (device_table(a, dev)
                                         for a in (E, L, b))
            self._W = self._E[:len(self._ivocab)]
        else:
            self._Win, self._G, self._C = (device_table(a, dev)
                                           for a in (Win, G, C))
            self._bake_vectors()
        self.layerSize = self.dim = int(self._W.shape[1])
        return self

    # ------------- queries -------------------------------------------
    def getWordVector(self, word):
        """In-vocab: the baked vector. OOV: the mean of its subword
        rows."""
        if word in self.vocab:
            return super().getWordVector(word)
        if self._G is None:
            raise KeyError(
                f"{word!r} not in vocabulary (supervised models have no "
                f"subword table for OOV queries)")
        sids = self._sub_ids(word)
        if not sids:
            raise KeyError(f"{word!r} has no char n-grams of length "
                           f">={self.minn}")
        rows = self._G[torch.as_tensor(sids, dtype=torch.int64,
                                       device=self._G.device)]
        return host_array(rows).mean(0)

    def similarityOOV(self, w1, w2):
        a, b = self.getWordVector(w1), self.getWordVector(w2)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    # ------------- supervised inference ------------------------------
    def _predict_logits(self, text):
        if self._L is None:
            raise RuntimeError("predict() requires a supervised model")
        toks = self.tokenizer.create(text)
        feats = self._features(toks)
        if not feats:
            raise ValueError("no known features in text")
        rows = self._E[torch.as_tensor(feats, dtype=torch.int64,
                                       device=self._E.device)]
        h = host_array(rows).mean(0)
        return h @ self._host("_L").T + self._host("_b")

    def predict(self, text):
        return self.labels[int(np.argmax(self._predict_logits(text)))]

    def predictProbability(self, text):
        z = self._predict_logits(text)
        p = np.exp(z - z.max())
        p /= p.sum()
        i = int(np.argmax(p))
        return self.labels[i], float(p[i])

    # ------------- serde (the reference's npz layout) ----------------
    @staticmethod
    def _npz(path):
        p = str(path)
        return p if p.endswith(".npz") else p + ".npz"

    def save(self, path):
        if self._W is None:
            raise RuntimeError("call fit() first")
        common = dict(
            words=np.array(self._ivocab, dtype=object),
            tokenizer_class=type(self.tokenizer).__name__,
            hyper=np.asarray([self.minn, self.maxn, self.bucket,
                              self.wordNgrams], "int64"))
        if self.supervised_mode:
            np.savez(self._npz(path), mode="supervised",
                     labels=np.array(self.labels, dtype=object),
                     E=host_array(self._E), L=host_array(self._L),
                     b=host_array(self._b), **common)
        else:
            np.savez(self._npz(path), mode="skipgram",
                     Win=host_array(self._Win), G=host_array(self._G),
                     C=host_array(self._C), **common)

    @staticmethod
    def load(path, tokenizerFactory=None, device=None):
        """Restore a saved model onto `device` (None: the card). A model
        fit with a non-default tokenizer must be given it back."""
        z = np.load(FastText._npz(path), allow_pickle=True)
        saved_tok = str(z["tokenizer_class"]) if "tokenizer_class" \
            in z.files else "DefaultTokenizerFactory"
        if tokenizerFactory is None \
                and saved_tok != "DefaultTokenizerFactory":
            raise ValueError(
                f"model was trained with tokenizer {saved_tok}; pass "
                f"the same tokenizerFactory= to FastText.load")
        minn, maxn, bucket, wng = (int(x) for x in z["hyper"])
        m = FastText(minn=minn, maxn=maxn, bucket=bucket, wordNgrams=wng,
                     tokenizer=tokenizerFactory, device=device,
                     supervised=str(z["mode"]) == "supervised")
        m._ivocab = [str(w) for w in z["words"]]
        m.vocab = {w: i for i, w in enumerate(m._ivocab)}
        if m.supervised_mode:
            m.labels = [str(l) for l in z["labels"]]
            m.load_reference_params(E=z["E"], L=z["L"], b=z["b"])
        else:
            m.load_reference_params(Win=z["Win"], G=z["G"], C=z["C"])
        return m
