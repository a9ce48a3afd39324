"""Word2Vec (skip-gram and CBOW, negative sampling or hierarchical
softmax) and ParagraphVectors (PV-DBOW and PV-DM).

The counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (reference:
deeplearning4j-nlp org.deeplearning4j.models.word2vec.Word2Vec and
models.paragraphvectors.ParagraphVectors). The vocabulary scan and the
example extraction run on the host once; training is a loop of steps on
the fit's device over example arrays that live there.

Host arrays equal the reference's: the vocabulary order (count
descending, then the word), the unigram^0.75 table, the skip-gram pairs,
the CBOW and PV-DM windows (built with numpy in the reference's order
instead of Python loops) and the Huffman codes (the same heap).

The step is the reference's rule: ``W - lr * dW``, ``C - lr * dC`` with
``dW`` the gradient of the batch's MEAN loss at a constant learning rate
(not word2vec.c's per-pair linear decay), the tail batch included. The
gradient is taken by autograd with respect to the gathered rows, and the
rows' gradients are scattered into the tables with ``index_add_``: the
same function as the reference's dense ``W - lr * gW``, with duplicate
rows summed in another order.

Every random number comes from a ``util.draws.Draws`` (``fit(draws=)``):
the initial tables ``(U[0,1) - 0.5) / D`` (the output tables start at
zero), each epoch's permutation and each step's negatives (drawn with
replacement from the 0.75-power table). By default a ``torch.Generator``
on the fit's device seeded by ``seed``; a test hands in the reference's.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import heapq
import itertools
import re
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.query import WordVectorQuery, host_array
from deeplearning4j_tpu_torch.nlp.tokenization import \
    apply_preprocessor as _apply_preprocessor
from deeplearning4j_tpu_torch.util.draws import Draws

__all__ = ["Word2Vec", "ParagraphVectors", "DefaultTokenizerFactory",
           "CollectionSentenceIterator", "LineSentenceIterator"]


class DefaultTokenizerFactory:
    """Lowercasing word tokenizer (reference:
    text.tokenization.tokenizerfactory.DefaultTokenizerFactory).
    An optional TokenPreProcess (nlp.tokenization) maps each token;
    tokens it empties are dropped."""

    _RE = re.compile(r"[A-Za-z0-9']+")

    def __init__(self):
        self._pre = None

    def setTokenPreProcessor(self, pre):
        self._pre = pre

    def create(self, sentence):
        return _apply_preprocessor(self._RE.findall(sentence.lower()),
                                   self._pre)


class CollectionSentenceIterator:
    """Sentences from an in-memory collection (reference:
    text.sentenceiterator.CollectionSentenceIterator)."""

    def __init__(self, sentences):
        self._s = list(sentences)
        self._i = 0

    def hasNext(self):
        return self._i < len(self._s)

    def nextSentence(self):
        s = self._s[self._i]
        self._i += 1
        return s

    def reset(self):
        self._i = 0


class LineSentenceIterator(CollectionSentenceIterator):
    """One sentence per line of a file (reference:
    text.sentenceiterator.LineSentenceIterator)."""

    def __init__(self, path):
        with open(path) as fh:
            super().__init__([l.strip() for l in fh if l.strip()])


# ----------------------------------------------------------------------
# host-side example arrays (numpy, in the reference's order)
# ----------------------------------------------------------------------

def flat_tokens(id_lists):
    """Token-id lists -> (tok [T], pos [T] position in its sentence,
    length [T] of its sentence, sent [T] sentence index), int32."""
    lens = np.fromiter((len(s) for s in id_lists), np.int64, len(id_lists))
    total = int(lens.sum())
    tok = np.fromiter(itertools.chain.from_iterable(id_lists), np.int32,
                      total)
    sent = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    pos = np.arange(total, dtype=np.int32) - starts[sent]
    return tok, pos, lens.astype(np.int32)[sent], sent


def _offsets(w):
    return np.array([d for d in range(-w, w + 1) if d != 0], np.int32)


def skipgram_pairs(id_lists, windowSize):
    """(center, context) int32 pairs: for each token in sentence order,
    each in-sentence neighbour within the window, left to right — the
    reference's ``_scan`` loops."""
    tok, pos, length, _ = flat_tokens(id_lists)
    offs = _offsets(windowSize)
    j = pos[:, None] + offs[None, :]
    valid = (j >= 0) & (j < length[:, None])
    gi = np.arange(tok.size, dtype=np.int32)[:, None] + offs[None, :]
    centers = np.broadcast_to(tok[:, None], valid.shape)[valid]
    return centers, tok[gi[valid]]


def window_rows(id_lists, windowSize):
    """CBOW-shaped rows for every token: (centers [N] int32, contexts
    [N, 2w] int32 left-packed and 0-padded, masks [N, 2w] f32, sentence
    [N]) — the reference's ``_windows`` over every sentence."""
    tok, pos, length, sent = flat_tokens(id_lists)
    width = 2 * windowSize
    left = np.minimum(pos, windowSize)                 # valid on the left
    cnt = left + np.minimum(length - 1 - pos, windowSize)
    # the valid offsets are one run starting at column w - left: shift it
    # to column 0. Column c holds offset c - left (+1 past the centre).
    c = np.arange(width, dtype=np.int32)[None, :]
    d = c - left[:, None]
    d += d >= 0
    mask = c < cnt[:, None]
    src = np.arange(tok.size, dtype=np.int32)[:, None] + d
    np.multiply(src, mask, out=src)
    ctx = tok[src]
    np.multiply(ctx, mask, out=ctx)
    return tok, ctx, mask.astype("float32"), sent


def build_huffman(counts):
    """counts[i] = frequency of vocab word i -> (points [V, L] int32
    inner-node ids, signs [V, L] f32 in {+1,-1}, mask [V, L] f32); the
    reference's heap and tie rule, padded to the longest code."""
    V = len(counts)
    if V < 2:
        raise ValueError("hierarchical softmax needs a vocabulary "
                         "of at least 2 words")
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    nxt = V
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        parent[n1] = (nxt, 0)
        parent[n2] = (nxt, 1)
        heapq.heappush(heap, (f1 + f2, nxt))
        nxt += 1
    paths = []
    for w in range(V):
        pts, bits = [], []
        node = w
        while node in parent:
            par, bit = parent[node]
            pts.append(par - V)  # inner nodes -> 0..V-2
            bits.append(bit)
            node = par
        paths.append((pts[::-1], bits[::-1]))
    L = max(len(p) for p, _ in paths)
    points = np.zeros((V, L), "int32")
    signs = np.zeros((V, L), "float32")
    mask = np.zeros((V, L), "float32")
    for w, (pts, bits) in enumerate(paths):
        n = len(pts)
        points[w, :n] = pts
        signs[w, :n] = 1.0 - 2.0 * np.asarray(bits)  # bit 0 -> +1
        mask[w, :n] = 1.0
    return points, signs, mask


# ----------------------------------------------------------------------
# device-side losses and the step loop
# ----------------------------------------------------------------------

def ns_step(h, pos_rows, neg_rows):
    """The negative-sampling loss of h [B, D] against pos_rows [B, D] and
    neg_rows [B, K, D], -(mean log sigmoid(h . pos) + mean sum_k log
    sigmoid(-h . neg_k)), and its gradients written out: (loss, d/dh,
    d/dpos_rows, d/dneg_rows). d log sigmoid(x) / dx = sigmoid(-x); each
    mean over the batch divides by B."""
    B = h.shape[0]
    pos = (h * pos_rows).sum(-1)
    negs = torch.bmm(neg_rows, h[:, :, None])[..., 0]
    loss = -(F.logsigmoid(pos).mean() + F.logsigmoid(-negs).sum(-1).mean())
    gp = torch.sigmoid(-pos).div_(-B)                 # d loss / d pos
    gn = torch.sigmoid(negs).div_(B)                  # d loss / d negs
    gh = torch.baddbmm(gp[:, None, None] * pos_rows[:, None, :],
                       gn[:, None, :], neg_rows)[:, 0]
    return loss, gh, gp[:, None] * h, gn[:, :, None] * h[:, None, :]


def hs_loss(h, node_rows, signs, mask):
    """-mean_B sum_path log sigmoid(sign * h . S1[node]) for h [B, D],
    node_rows [B, L, D], signs and mask [B, L]."""
    logits = torch.einsum("bd,bld->bl", h, node_rows)
    return -(F.logsigmoid(signs * logits) * mask).sum(-1).mean()


def masked_mean(rows, m, extra=None, plus=0.0):
    """sum_j rows[:, j] * m[:, j] (+ extra) over (sum m + plus)."""
    tot = (rows * m[..., None]).sum(1)
    if extra is not None:
        tot = tot + extra
    return tot / (m.sum(1, keepdim=True) + plus)


def leaf(t):
    return t.detach().requires_grad_()


def scatter_sgd(table, index, grad, lr):
    """table[index] -= lr * grad, duplicates summed (index_add_)."""
    table.index_add_(0, index.reshape(-1),
                     grad.reshape(-1, table.shape[1]), alpha=-lr)


class TrainLog:
    """What a training loop did: the first and last batch's loss, the
    steps taken, the loop's seconds (ending in the last loss's host
    read) and its step function ``step(idx, epoch, start)``."""

    def __init__(self, first, last, steps, seconds, step):
        self.first, self.last = first, last
        self.steps, self.seconds, self.step = steps, seconds, step


def run_epochs(n, batch, epochs, draws, perm_what, step, steps=None):
    """The reference's loop: per epoch a permutation of the n examples,
    then batches of `batch` in order (the tail batch too). `step(idx,
    epoch, start)` returns the batch's loss (a device scalar, read on the
    host once, at the end). `steps` caps the number of steps (None: every
    epoch). -> TrainLog"""
    t0 = time.perf_counter()
    B = min(batch, n)
    done = 0
    first = loss = None
    for epoch in range(epochs):
        perm = draws.permutation(perm_what, n, epoch)
        for s in range(0, n, B):
            if steps is not None and done >= steps:
                break
            loss = step(perm[s:s + B], epoch, s)
            first = loss if first is None else first
            done += 1
    nan = float("nan")
    last = float(loss) if loss is not None else nan
    return TrainLog(float(first) if first is not None else nan, last, done,
                    time.perf_counter() - t0, step)


def device_table(a, dev, dtype=torch.float32):
    """A copy of the array `a` as a `dtype` tensor on `dev` (a copy:
    tables are trained in place)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


class Word2Vec(WordVectorQuery):
    """Builder-constructed Word2Vec (reference: Word2Vec.Builder)."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def minWordFrequency(self, n):
            self._kw["minWordFrequency"] = int(n)
            return self

        def layerSize(self, n):
            self._kw["layerSize"] = int(n)
            return self

        def windowSize(self, n):
            self._kw["windowSize"] = int(n)
            return self

        def negativeSample(self, n):
            self._kw["negative"] = int(n)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def iterations(self, n):  # epochs over the extracted examples
            self._kw["iterations"] = int(n)
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = float(lr)
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

        def elementsLearningAlgorithm(self, algorithm):
            """"skipgram" (default) or "cbow"."""
            name = algorithm if isinstance(algorithm, str) \
                else type(algorithm).__name__
            self._kw["elementsLearningAlgorithm"] = name
            return self

        def useHierarchicSoftmax(self, flag=True):
            self._kw["useHierarchicSoftmax"] = bool(flag)
            return self

        def stopWords(self, words):
            self._kw["stopWords"] = list(words)
            return self

        def vocabCache(self, model):
            """Take another model's vocabulary scan (its vocabulary and
            token lists) instead of reading the iterator again
            (reference: Word2Vec.Builder.vocabCache)."""
            self._kw["vocabCache"] = model
            return self

        def device(self, d):
            """Where fit() trains (None: the card)."""
            self._kw["device"] = d
            return self

        def build(self):
            return Word2Vec(**self._kw)

    def __init__(self, iterator=None, tokenizer=None, minWordFrequency=5,
                 layerSize=100, windowSize=5, negative=5, seed=42,
                 iterations=1, learningRate=0.025, batchSize=1024,
                 elementsLearningAlgorithm="skipgram",
                 useHierarchicSoftmax=False, stopWords=(), device=None,
                 vocabCache=None):
        alg = str(elementsLearningAlgorithm).lower()
        alg = alg.split("<")[0]  # tolerate upstream's "CBOW<VocabWord>"
        if alg not in ("skipgram", "cbow"):
            raise ValueError(
                f"unknown elementsLearningAlgorithm {elementsLearningAlgorithm!r}"
                " (use 'skipgram' or 'cbow')")
        self.algorithm = alg
        self.useHierarchicSoftmax = bool(useHierarchicSoftmax)
        self.stopWords = set(stopWords)
        self.iterator = iterator
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.minWordFrequency = minWordFrequency
        self.layerSize = layerSize
        self.windowSize = windowSize
        self.negative = negative
        self.seed = seed
        self.iterations = iterations
        self.learningRate = learningRate
        self.batchSize = batchSize
        self.device = device
        self.vocabCache = vocabCache
        self.vocab = {}            # word -> index
        self._ivocab = []          # index -> word
        self._freq = None          # unigram^0.75 sampling weights
        self._W = None             # [V, D] input embeddings (the vectors)
        self._C = None             # [V, D] context table (HS: [V-1, D])
        self._doc_trained = None   # ParagraphVectors: bool per doc
        self.stepsTaken = 0
        self.trainLog = None
        self.scanSeconds = 0.0

    # ---------------- vocab + example extraction (host side, once) -----
    def _scan_vocab(self):
        t0 = time.perf_counter()
        src = self.vocabCache
        if src is not None:
            if not src.vocab:
                src._scan_vocab()
            for a in ("vocab", "_ivocab", "_counts", "_freq", "_sents",
                      "_ids"):
                setattr(self, a, getattr(src, a))
            self.scanSeconds = time.perf_counter() - t0
            return
        counts = Counter()
        sents = []
        self.iterator.reset()
        while self.iterator.hasNext():
            toks = [t for t in
                    self.tokenizer.create(self.iterator.nextSentence())
                    if t not in self.stopWords]
            sents.append(toks)
            counts.update(toks)
        self._sents = sents
        vocab_words = sorted(
            (w for w, c in counts.items() if c >= self.minWordFrequency),
            key=lambda w: (-counts[w], w))
        if not vocab_words:
            raise ValueError(
                f"empty vocabulary: no token reached minWordFrequency="
                f"{self.minWordFrequency}")
        self.vocab = {w: i for i, w in enumerate(vocab_words)}
        self._ivocab = vocab_words
        self._counts = np.array([counts[w] for w in vocab_words], "int64")
        f = self._counts.astype("float64") ** 0.75
        self._freq = (f / f.sum()).astype("float32")
        self._ids = self._id_lists(sents)
        self.scanSeconds = time.perf_counter() - t0

    def _id_lists(self, sents):
        """In-vocab token ids of each sentence."""
        get = self.vocab.get
        return [[i for i in map(get, toks) if i is not None]
                for toks in sents]

    def _scan(self):
        """Vocab scan + skip-gram (center, context) pairs."""
        self._scan_vocab()
        centers, contexts = skipgram_pairs(self._ids, self.windowSize)
        if not centers.size:
            raise ValueError("no training pairs (sentences too short?)")
        return centers, contexts

    def _cbow_examples(self):
        """Vocab scan + CBOW examples (center [N], context [N, 2w],
        mask [N, 2w]); rows with an empty window are dropped."""
        self._scan_vocab()
        c, x, m, _ = window_rows(self._ids, self.windowSize)
        keep = m[:, 0] > 0
        if not keep.any():
            raise ValueError("no training pairs (sentences too short?)")
        return c[keep], x[keep], m[keep]

    _build_huffman = staticmethod(build_huffman)

    # ---------------- training -------------------------------------
    def _device(self, device):
        return resolve_device(device if device is not None else self.device)

    def fit(self, device=None, draws=None, steps=None):
        """Scan, extract and train on `device` (default: the Builder's,
        else the card). `draws`: a util.draws.Draws (default: a
        generator on the device seeded by `seed`). `steps` stops after
        that many steps (None: every epoch)."""
        dev = self._device(device)
        draws = draws if draws is not None else Draws(self.seed, dev)
        with torch.no_grad():
            if self.useHierarchicSoftmax:
                self._fit_hs(dev, draws, steps)
            elif self.algorithm == "cbow":
                self._fit_cbow(dev, draws, steps)
            else:
                self._fit_skipgram(dev, draws, steps)
        return self

    def _init_W(self, draws, what, rows, dev):
        D = self.layerSize
        return (draws.uniform(what, (rows, D)).to(dev) - 0.5) / D

    def _finish(self, log):
        self.trainLog = log
        self.stepsTaken = log.steps
        self._score = log.last

    def _fit_skipgram(self, dev, draws, steps):
        centers, contexts = self._scan()
        V, D, K = len(self.vocab), self.layerSize, self.negative
        W = self._init_W(draws, "word2vec.W", V, dev)
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        freq = device_table(self._freq, dev)
        ctr_d = device_table(centers, dev, torch.int64)
        ctx_d = device_table(contexts, dev, torch.int64)
        lr = self.learningRate

        def step(idx, epoch, s):
            ctr, ctx = ctr_d[idx], ctx_d[idx]
            neg = draws.choice("word2vec.neg", freq, (ctr.shape[0], K),
                               epoch, s).to(dev)
            loss, gw, gc, gcn = ns_step(W[ctr], C[ctx], C[neg])
            scatter_sgd(W, ctr, gw, lr)
            scatter_sgd(C, ctx, gc, lr)
            scatter_sgd(C, neg, gcn, lr)
            return loss.detach()

        self._W, self._C = W, C
        self._finish(run_epochs(centers.shape[0], self.batchSize,
                                 self.iterations, draws, "word2vec.perm",
                                 step, steps))

    def _fit_cbow(self, dev, draws, steps):
        centers, ctxs, masks = self._cbow_examples()
        V, D, K = len(self.vocab), self.layerSize, self.negative
        W = self._init_W(draws, "word2vec.W", V, dev)
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        freq = device_table(self._freq, dev)
        ctr_d = device_table(centers, dev, torch.int64)
        ctx_d = device_table(ctxs, dev, torch.int64)
        msk_d = device_table(masks, dev)
        lr = self.learningRate

        def step(idx, epoch, s):
            ctr, ctx, m = ctr_d[idx], ctx_d[idx], msk_d[idx]
            neg = draws.choice("word2vec.neg", freq, (ctr.shape[0], K),
                               epoch, s).to(dev)
            loss, gh, gc, gcn = ns_step(masked_mean(W[ctx], m), C[ctr],
                                        C[neg])
            share = m / m.sum(1, keepdim=True)     # d h / d each row
            scatter_sgd(W, ctx, gh[:, None, :] * share[..., None], lr)
            scatter_sgd(C, ctr, gc, lr)
            scatter_sgd(C, neg, gcn, lr)
            return loss.detach()

        self._W, self._C = W, C
        self._finish(run_epochs(centers.shape[0], self.batchSize,
                                 self.iterations, draws, "word2vec.perm",
                                 step, steps))

    def _hs_device_tables(self, dev):
        pts, sgn, msk = build_huffman(self._counts)
        self.huffmanCodeLength = int(pts.shape[1])
        self._hs_tables = (device_table(pts, dev, torch.int64),
                           device_table(sgn, dev), device_table(msk, dev))
        return self._hs_tables

    def _fit_hs(self, dev, draws, steps):
        """Skip-gram or CBOW against the hierarchical-softmax objective;
        the output table is the V-1 inner-node matrix."""
        cbow = self.algorithm == "cbow"
        if cbow:
            data = self._cbow_examples()
        else:
            data = self._scan()
        V, D = len(self.vocab), self.layerSize
        pts, sgn, msk = self._hs_device_tables(dev)
        W = self._init_W(draws, "word2vec.W", V, dev)
        S1 = torch.zeros((max(V - 1, 1), D), dtype=torch.float32, device=dev)
        lr = self.learningRate
        dd = [device_table(a, dev, torch.int64 if a.dtype.kind == "i"
                           else torch.float32) for a in data]

        def step(idx, epoch, s):
            if cbow:
                tgt, ctx, m = dd[0][idx], dd[1][idx], dd[2][idx]
            else:
                ctr, tgt = dd[0][idx], dd[1][idx]
            nodes = pts[tgt]
            with torch.enable_grad():
                x = leaf(W[ctx] if cbow else W[ctr])
                s1 = leaf(S1[nodes])
                h = masked_mean(x, m) if cbow else x
                loss = hs_loss(h, s1, sgn[tgt], msk[tgt])
                gx, gs = torch.autograd.grad(loss, (x, s1))
            scatter_sgd(W, ctx if cbow else ctr, gx, lr)
            scatter_sgd(S1, nodes, gs, lr)
            return loss.detach()

        self._W, self._C = W, S1
        self._finish(run_epochs(data[0].shape[0], self.batchSize,
                                 self.iterations, draws, "word2vec.perm",
                                 step, steps))

    # ---------------- reference arrays ------------------------------
    def load_reference_params(self, W, C, device=None):
        """Take the reference model's tables (numpy): the vectors W
        [V, D] and the output table C ([V, D], or the [V-1, D] inner-node
        table in HS mode), in this model's vocabulary order."""
        dev = self._device(device)
        W, C = np.asarray(W, np.float32), np.asarray(C, np.float32)
        if self._ivocab and W.shape[0] != len(self._ivocab):
            raise ValueError(f"W has {W.shape[0]} rows for a vocabulary "
                             f"of {len(self._ivocab)}")
        self._W = device_table(W, dev)
        self._C = device_table(C, dev)
        self.layerSize = int(W.shape[1])
        return self

    # ---------------- query API ------------------------------------
    def _require_fit(self):
        if self._W is None:
            raise RuntimeError("call fit() first")

    def _matrix(self):
        self._require_fit()
        return super()._matrix()

    # ---------------- serde (the reference's npz layout) ------------
    @staticmethod
    def _npz(path):
        p = str(path)
        return p if p.endswith(".npz") else p + ".npz"

    def save(self, path):
        self._require_fit()
        np.savez(self._npz(path), words=np.array(self._ivocab, dtype=object),
                 W=host_array(self._W), C=host_array(self._C))

    @staticmethod
    def load(path, device=None):
        z = np.load(Word2Vec._npz(path), allow_pickle=True)
        dev = resolve_device(device)
        m = Word2Vec(device=device)
        m._ivocab = [str(w) for w in z["words"]]
        m.vocab = {w: i for i, w in enumerate(m._ivocab)}
        m._W = device_table(z["W"], dev)
        m._C = device_table(z["C"], dev)
        m.layerSize = int(z["W"].shape[1])
        return m


class ParagraphVectors(Word2Vec):
    """Doc embeddings via PV-DBOW or PV-DM (reference: ParagraphVectors
    with sequenceLearningAlgorithm DBOW / DM).

    DBOW (default): the word tables train first (skip-gram/CBOW/HS per
    the config), then each document vector learns to predict its words
    against the frozen output table. DM (mean variant): one joint step —
    the masked mean of the window's word vectors and the doc vector
    predicts the center word; words, docs and the output table all
    train together. inferVector() fits a fresh vector for unseen text
    with the trained tables frozen."""

    class Builder(Word2Vec.Builder):
        def sequenceLearningAlgorithm(self, algorithm):
            """"DBOW" (default) or "DM"."""
            name = algorithm if isinstance(algorithm, str) \
                else type(algorithm).__name__
            self._kw["sequenceLearningAlgorithm"] = name
            return self

        def build(self):
            return ParagraphVectors(**self._kw)

    def __init__(self, *args, sequenceLearningAlgorithm="DBOW", **kw):
        super().__init__(*args, **kw)
        alg = str(sequenceLearningAlgorithm).upper().split("<")[0]
        if alg not in ("DBOW", "DM"):
            raise ValueError(
                f"unknown sequenceLearningAlgorithm "
                f"{sequenceLearningAlgorithm!r} (use 'DBOW' or 'DM')")
        if alg == "DM" and self.useHierarchicSoftmax:
            raise ValueError(
                "PV-DM here trains with negative sampling; combine DM "
                "with useHierarchicSoftmax(False) or use DBOW for the "
                "hierarchical-softmax path")
        self.sequenceAlgorithm = alg
        self._D = None

    def _doc_pairs(self):
        """(doc_id, word_id) int32 for every in-vocab token of every doc;
        docs with no in-vocab token are recorded as untrained."""
        self._n_docs = len(self._sents)
        self._doc_trained = np.asarray([bool(i) for i in self._ids], bool)
        tok, _, _, sent = flat_tokens(self._ids)
        return sent.astype("int32"), tok.astype("int32")

    def _dm_examples(self):
        """(doc [N], center [N], context [N, 2w], mask [N, 2w]) over all
        documents: CBOW-shaped windows (empty ones kept) and the doc."""
        self._scan_vocab()
        c, x, m, sent = window_rows(self._ids, self.windowSize)
        if not c.size:
            raise ValueError("no training examples (empty documents?)")
        self._n_docs = len(self._sents)
        self._doc_trained = np.asarray([bool(i) for i in self._ids], bool)
        return sent.astype("int32"), c, x, m

    def fit(self, device=None, draws=None, steps=None):
        """As Word2Vec.fit; `steps` caps each training loop (the word
        loop and the document loop of DBOW)."""
        dev = self._device(device)
        draws = draws if draws is not None else Draws(self.seed, dev)
        if self.sequenceAlgorithm == "DM":
            with torch.no_grad():
                self._fit_dm(dev, draws, steps)
            return self
        super().fit(device=dev, draws=draws, steps=steps)
        with torch.no_grad():
            self._fit_dbow(dev, draws, steps)
        return self

    def _fit_dm(self, dev, draws, steps):
        docs, centers, ctxs, masks = self._dm_examples()
        V, D, K = len(self.vocab), self.layerSize, self.negative
        W = self._init_W(draws, "dm.W", V, dev)
        Dv = self._init_W(draws, "dm.Dv", self._n_docs, dev)
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        freq = device_table(self._freq, dev)
        doc_d = device_table(docs, dev, torch.int64)
        ctr_d = device_table(centers, dev, torch.int64)
        ctx_d = device_table(ctxs, dev, torch.int64)
        msk_d = device_table(masks, dev)
        lr = self.learningRate

        def step(idx, epoch, s):
            did, ctr, ctx, m = doc_d[idx], ctr_d[idx], ctx_d[idx], msk_d[idx]
            neg = draws.choice("dm.neg", freq, (ctr.shape[0], K),
                               epoch, s).to(dev)
            den = m.sum(1, keepdim=True) + 1.0
            h = masked_mean(W[ctx], m, extra=Dv[did], plus=1.0)
            loss, gh, gc, gcn = ns_step(h, C[ctr], C[neg])
            scatter_sgd(W, ctx, gh[:, None, :] * (m / den)[..., None], lr)
            scatter_sgd(Dv, did, gh / den, lr)
            scatter_sgd(C, ctr, gc, lr)
            scatter_sgd(C, neg, gcn, lr)
            return loss.detach()

        self._W, self._C, self._D = W, C, Dv
        self._finish(run_epochs(centers.shape[0], self.batchSize,
                                 self.iterations, draws, "dm.perm", step,
                                 steps))

    def _fit_dbow(self, dev, draws, steps):
        d_idx, w_idx = self._doc_pairs()
        V, K = len(self.vocab), self.negative
        Dv = self._init_W(draws, "dbow.Dv", self._n_docs, dev)
        C = self._C  # frozen: context table (NS) / inner-node table (HS)
        freq = device_table(self._freq, dev)
        doc_d = device_table(d_idx, dev, torch.int64)
        wrd_d = device_table(w_idx, dev, torch.int64)
        lr = self.learningRate
        hs = self.useHierarchicSoftmax
        if hs:
            pts, sgn, msk = self._hs_tables

        def step(idx, epoch, s):
            did, wid = doc_d[idx], wrd_d[idx]
            if not hs:
                neg = draws.choice("dbow.neg", freq, (did.shape[0], K),
                                   epoch, s).to(dev)
            if hs:
                with torch.enable_grad():
                    v = leaf(Dv[did])
                    loss = hs_loss(v, C[pts[wid]], sgn[wid], msk[wid])
                    g, = torch.autograd.grad(loss, (v,))
            else:
                loss, g, _, _ = ns_step(Dv[did], C[wid], C[neg])
            scatter_sgd(Dv, did, g, lr)
            return loss.detach()

        self._D = Dv
        self.docTrainLog = run_epochs(
            d_idx.shape[0], self.batchSize, self.iterations, draws,
            "dbow.perm", step, steps)

    def load_reference_params(self, W, C, Dv=None, device=None):
        """As Word2Vec's, plus the doc table Dv [docs, D]."""
        super().load_reference_params(W, C, device=device)
        if Dv is not None:
            self._D = device_table(np.asarray(Dv, np.float32), self._W.device)
        return self

    def getParagraphVector(self, docIndex):
        if self._D is None:
            raise RuntimeError("call fit() first")
        i = int(docIndex)
        if self._doc_trained is not None and not self._doc_trained[i]:
            raise ValueError(
                f"document {i} has no in-vocabulary tokens — its vector "
                f"was never trained")
        return host_array(self._D[i])

    def inferVector(self, text, steps=50, device=None, draws=None):
        """Fit a vector for unseen text against the frozen tables
        (reference: ParagraphVectors.inferVector), on `device` (default:
        the device the model's tables are on). `draws`: as fit's (default
        seeded by seed ^ 0x1FE12)."""
        if self._D is None:
            raise RuntimeError("call fit() first")
        ids = [self.vocab[t] for t in self.tokenizer.create(text)
               if t in self.vocab]
        if not ids:
            raise ValueError("no in-vocabulary tokens in text")
        dev = resolve_device(device) if device is not None \
            else self._W.device
        draws = draws if draws is not None \
            else Draws(self.seed ^ 0x1FE12, dev)
        K, D = self.negative, self.layerSize
        W, C = self._W.to(dev), self._C.to(dev)
        freq = device_table(self._freq, dev)
        lr = self.learningRate
        v = (draws.uniform("infer.v", (D,)).to(dev) - 0.5) / D
        dm = self.sequenceAlgorithm == "DM"
        hs = self.useHierarchicSoftmax and not dm
        if dm:
            c, x, m, _ = window_rows([ids], self.windowSize)
            ctr = device_table(c, dev, torch.int64)
            msk = device_table(m, dev)
            den = msk.sum(1, keepdim=True) + 1.0
            ctx_sum = (W[device_table(x, dev, torch.int64)]
                       * msk[..., None]).sum(1)
            n = ctr.shape[0]
        else:
            wids = device_table(np.asarray(ids), dev, torch.int64)
            n = wids.shape[0]
            if hs:
                pts, sgn, msk_hs = (t.to(dev) for t in self._hs_tables)
                hs_rows = C[pts[wids]]
        for i in range(int(steps)):
            if hs:
                with torch.enable_grad():
                    vv = leaf(v)
                    loss = hs_loss(vv.expand(n, D), hs_rows, sgn[wids],
                                   msk_hs[wids])
                    g, = torch.autograd.grad(loss, (vv,))
            else:
                neg = draws.choice("infer.neg", freq, (n, K), i).to(dev)
                if dm:
                    _, gh, _, _ = ns_step((ctx_sum + v) / den, C[ctr],
                                          C[neg])
                    g = (gh / den).sum(0)
                else:
                    _, gh, _, _ = ns_step(v.expand(n, D), C[wids], C[neg])
                    g = gh.sum(0)
            v = v - lr * g
        return host_array(v)

    def save(self, path):
        self._require_fit()
        if self._D is None:
            raise RuntimeError("call fit() first")
        np.savez(self._npz(path),
                 words=np.array(self._ivocab, dtype=object),
                 W=host_array(self._W), C=host_array(self._C),
                 D=host_array(self._D), freq=np.asarray(self._freq),
                 doc_trained=np.asarray(self._doc_trained),
                 counts=np.asarray(getattr(self, "_counts", [])),
                 hyper=np.asarray([self.negative, self.seed,
                                   self.learningRate,
                                   float(self.useHierarchicSoftmax),
                                   float(self.sequenceAlgorithm == "DM"),
                                   self.windowSize], "float64"))

    @staticmethod
    def load(path, device=None):
        z = np.load(Word2Vec._npz(path), allow_pickle=True)
        if "D" not in z.files:
            raise ValueError(
                "file holds a Word2Vec model (no doc vectors); load it "
                "with Word2Vec.load")
        dev = resolve_device(device)
        m = ParagraphVectors(device=device)
        m._ivocab = [str(w) for w in z["words"]]
        m.vocab = {w: i for i, w in enumerate(m._ivocab)}
        m._W = device_table(z["W"], dev)
        m._C = device_table(z["C"], dev)
        m._D = device_table(z["D"], dev)
        m._freq = np.asarray(z["freq"])
        m._doc_trained = np.asarray(z["doc_trained"])
        m.layerSize = int(z["W"].shape[1])
        m.negative = int(z["hyper"][0])
        m.seed = int(z["hyper"][1])
        m.learningRate = float(z["hyper"][2])
        if "counts" in z.files and len(z["counts"]):
            m._counts = np.asarray(z["counts"])
        if len(z["hyper"]) > 4:
            m.sequenceAlgorithm = "DM" if z["hyper"][4] else "DBOW"
            m.windowSize = int(z["hyper"][5])
        if len(z["hyper"]) > 3 and z["hyper"][3]:
            m.useHierarchicSoftmax = True
            m._hs_device_tables(dev)
        return m

    def similarityToDoc(self, text, docIndex):
        a = self.inferVector(text)
        b = self.getParagraphVector(docIndex)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
