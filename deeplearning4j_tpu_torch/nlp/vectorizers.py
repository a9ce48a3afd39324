"""Bag-of-words / TF-IDF text vectorizers.

The counterpart of ``deeplearning4j_tpu/nlp/vectorizers.py`` (reference:
deeplearning4j-nlp org.deeplearning4j.bagofwords.vectorizer.
{BagOfWordsVectorizer, TfidfVectorizer}): Builder-configured, fit()
scans the corpus on the host, transform(text) -> [1, V] ``INDArray``
(on the vectorizer's device: the card unless ``device="cpu"``),
vectorize(text, label) -> ``DataSet``, and the labelled corpus as a
``DataSetIterator``. The matrices equal the reference's.

TF-IDF: tf = raw count in the document; idf = ln(totalDocs / docFreq);
value = tf * idf.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nlp.word2vec import DefaultTokenizerFactory

__all__ = ["LabelAwareCollectionIterator", "BagOfWordsVectorizer",
           "TfidfVectorizer"]


class LabelAwareCollectionIterator:
    """Labelled documents from in-memory lists (reference:
    text.documentiterator.LabelAwareIterator implementations)."""

    def __init__(self, documents, labels):
        if len(documents) != len(labels):
            raise ValueError(
                f"{len(documents)} documents but {len(labels)} labels")
        self._docs = list(documents)
        self._labels = [str(l) for l in labels]
        self._i = 0

    def hasNext(self):
        return self._i < len(self._docs)

    def nextDocument(self):
        d, l = self._docs[self._i], self._labels[self._i]
        self._i += 1
        return d, l

    # SentenceIterator duck-typing so Word2Vec can reuse the same source
    def nextSentence(self):
        return self.nextDocument()[0]

    def reset(self):
        self._i = 0


class BagOfWordsVectorizer:
    """Counts vectorizer (reference: BagOfWordsVectorizer)."""

    class Builder:
        _cls = None  # set per subclass below

        def __init__(self):
            self._kw = {}

        def setIterator(self, it):
            self._kw["iterator"] = it
            return self

        def setTokenizerFactory(self, tf):
            self._kw["tokenizer"] = tf
            return self

        def setMinWordFrequency(self, n):
            self._kw["minWordFrequency"] = int(n)
            return self

        def setStopWords(self, words):
            self._kw["stopWords"] = list(words)
            return self

        def device(self, d):
            """Where transform() puts its rows (None: the card)."""
            self._kw["device"] = d
            return self

        def build(self):
            return type(self)._cls(**self._kw)

    def __init__(self, iterator=None, tokenizer=None, minWordFrequency=1,
                 stopWords=(), device=None):
        self.device = device
        self.iterator = iterator
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.minWordFrequency = int(minWordFrequency)
        self.stopWords = set(stopWords)
        self.vocab = {}
        self._ivocab = []
        self._labels = []
        self._doc_tokens = []   # per-document token-id Counters
        self._doc_labels = []
        self._df = None         # document frequency per vocab id

    # ---------------- fit -------------------------------------------
    def fit(self):
        if self.iterator is None:
            raise ValueError("setIterator(...) is required before fit()")
        counts = Counter()
        raw_docs = []
        self.iterator.reset()
        while self.iterator.hasNext():
            if hasattr(self.iterator, "nextDocument"):
                text, label = self.iterator.nextDocument()
            else:
                text, label = self.iterator.nextSentence(), None
            toks = [t for t in self.tokenizer.create(text)
                    if t not in self.stopWords]
            counts.update(toks)
            raw_docs.append((toks, label))
        vocab_words = sorted(
            (w for w, c in counts.items() if c >= self.minWordFrequency),
            key=lambda w: (-counts[w], w))
        if not vocab_words:
            raise ValueError(
                f"empty vocabulary: no token reached minWordFrequency="
                f"{self.minWordFrequency}")
        self.vocab = {w: i for i, w in enumerate(vocab_words)}
        self._ivocab = vocab_words
        self._labels = sorted({l for _, l in raw_docs if l is not None})
        df = np.zeros(len(vocab_words), "int64")
        self._doc_tokens = []
        self._doc_labels = []
        for toks, label in raw_docs:
            ids = Counter(self.vocab[t] for t in toks if t in self.vocab)
            for i in ids:
                df[i] += 1
            self._doc_tokens.append(ids)
            self._doc_labels.append(label)
        self._df = df
        self._n_docs = len(raw_docs)
        self._idf_cache = None  # re-fit invalidates the cached idf
        return self

    # ---------------- queries ---------------------------------------
    def _require_fit(self):
        if not self.vocab:
            raise RuntimeError("call fit() first")

    def vocabSize(self):
        self._require_fit()
        return len(self.vocab)

    def indexOf(self, word):
        self._require_fit()
        return self.vocab.get(word, -1)

    def _counts_row(self, text):
        ids = Counter(self.vocab[t]
                      for t in self.tokenizer.create(text)
                      if t not in self.stopWords and t in self.vocab)
        row = np.zeros(len(self.vocab), "float32")
        for i, c in ids.items():
            row[i] = c
        return row

    def _weight_row(self, counts_row):
        return counts_row  # raw counts; TfidfVectorizer overrides

    def transform(self, text) -> INDArray:
        """Text -> [1, V] row (reference: transform returning INDArray)."""
        self._require_fit()
        return INDArray(self._weight_row(self._counts_row(text))[None, :],
                       device=self.device)

    def vectorize(self, text, label):
        """Text + label -> DataSet (reference: vectorize)."""
        self._require_fit()
        if label not in self._labels:
            raise ValueError(
                f"unknown label {label!r}; fitted labels: {self._labels}")
        y = np.zeros((1, len(self._labels)), "float32")
        y[0, self._labels.index(label)] = 1.0
        return DataSet(self._weight_row(self._counts_row(text))[None, :], y)

    def iterator_over_corpus(self, batchSize=32, shuffle=False, seed=123):
        """The fitted labelled corpus as a DataSetIterator — the bridge
        into fit()/evaluate() (upstream feeds its vectorized corpus to
        nets through RecordReaderDataSetIterator the same way)."""
        self._require_fit()
        if not self._labels:
            raise ValueError("corpus has no labels; use a label-aware "
                             "iterator (e.g. LabelAwareCollectionIterator)")
        X = np.zeros((self._n_docs, len(self.vocab)), "float32")
        Y = np.zeros((self._n_docs, len(self._labels)), "float32")
        for d, (ids, label) in enumerate(
                zip(self._doc_tokens, self._doc_labels)):
            row = np.zeros(len(self.vocab), "float32")
            for i, c in ids.items():
                row[i] = c
            X[d] = self._weight_row(row)
            Y[d, self._labels.index(label)] = 1.0
        return DataSetIterator(X, Y, batchSize, shuffle=shuffle, seed=seed)


BagOfWordsVectorizer.Builder._cls = BagOfWordsVectorizer


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting over the same machinery (reference:
    TfidfVectorizer)."""

    class Builder(BagOfWordsVectorizer.Builder):
        pass

    def _idf(self):
        # ln(N / df); df >= 1 for every vocab word by construction.
        # df/n_docs are frozen after fit(), so compute once and reuse —
        # transform()/iterator_over_corpus would otherwise pay O(V) per
        # document for an unchanging vector.
        cached = getattr(self, "_idf_cache", None)
        if cached is None:
            cached = self._idf_cache = np.log(
                self._n_docs / np.maximum(self._df, 1)).astype("float32")
        return cached

    def _weight_row(self, counts_row):
        return counts_row * self._idf()

    def tfidfWord(self, word, text):
        """tf-idf of one word within one document (reference:
        TfidfVectorizer.tfidfWord)."""
        self._require_fit()
        i = self.vocab.get(word)
        if i is None:
            return 0.0
        return float(self._counts_row(text)[i] * self._idf()[i])


TfidfVectorizer.Builder._cls = TfidfVectorizer
