"""Sentence -> word-vector tensor iterator for CNN/RNN text classifiers.

The counterpart of ``deeplearning4j_tpu/nlp/cnn_sentence.py`` (reference:
deeplearning4j-nlp iterator.CnnSentenceDataSetIterator and
iterator.LabeledSentenceProvider). Every sentence is embedded on the
host once into one padded [n, ...] array with a length mask; batches are
fixed-shape slices served by the port's ``DataSetIterator`` (the final
batch padded), which the networks put on their device.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSetIterator

__all__ = ["CollectionLabeledSentenceProvider", "UnknownWordHandling",
           "CnnSentenceDataSetIterator"]


class CollectionLabeledSentenceProvider:
    """In-memory (sentence, label) provider (reference:
    iterator.provider.CollectionLabeledSentenceProvider)."""

    def __init__(self, sentences, labels):
        if len(sentences) != len(labels):
            raise ValueError(f"{len(sentences)} sentences vs "
                             f"{len(labels)} labels")
        if not sentences:
            raise ValueError("empty sentence collection")
        self._data = list(zip(sentences, labels))
        self._i = 0

    def hasNext(self):
        return self._i < len(self._data)

    def nextSentence(self):
        s = self._data[self._i]
        self._i += 1
        return s

    def reset(self):
        self._i = 0

    def allLabels(self):
        return sorted({l for _, l in self._data})

    def numLabelClasses(self):
        return len(self.allLabels())


class UnknownWordHandling:
    RemoveWord = "RemoveWord"
    UseUnknownVector = "UseUnknownVector"


class CnnSentenceDataSetIterator(DataSetIterator):
    """Reference: CnnSentenceDataSetIterator. Formats:
    "CNN"   -> [b, 1, maxLen, vectorSize] (2d conv over the sentence)
    "CNN1D" -> [b, vectorSize, maxLen]    (1d conv, channels = vector)
    "RNN"   -> [b, vectorSize, maxLen]    (recurrent, NCW like the rest
                                           of the recurrent stack)
    Features mask is [b, maxLen] (1 where a real token sits); labels
    are one-hot over the provider's sorted label set.
    """

    class Builder:
        def __init__(self):
            self._kw = {}

        def sentenceProvider(self, p):
            self._kw["provider"] = p
            return self

        def wordVectors(self, wv):
            self._kw["wordVectors"] = wv
            return self

        def tokenizerFactory(self, tf):
            self._kw["tokenizer"] = tf
            return self

        def maxSentenceLength(self, n):
            self._kw["maxSentenceLength"] = int(n)
            return self

        def minibatchSize(self, n):
            self._kw["minibatchSize"] = int(n)
            return self

        def unknownWordHandling(self, h):
            self._kw["unknownWordHandling"] = h
            return self

        def format(self, f):
            self._kw["format"] = f
            return self

        def build(self):
            return CnnSentenceDataSetIterator(**self._kw)

    def __init__(self, provider=None, wordVectors=None, tokenizer=None,
                 maxSentenceLength=64, minibatchSize=32,
                 unknownWordHandling=UnknownWordHandling.RemoveWord,
                 format="CNN"):
        if provider is None or wordVectors is None:
            raise ValueError("sentenceProvider and wordVectors are required")
        if format not in ("CNN", "CNN1D", "RNN"):
            raise ValueError(f"format {format!r} not in CNN/CNN1D/RNN")
        if unknownWordHandling not in (UnknownWordHandling.RemoveWord,
                                       UnknownWordHandling.UseUnknownVector):
            raise ValueError(
                f"unknownWordHandling {unknownWordHandling!r} unknown")
        if tokenizer is None:
            from deeplearning4j_tpu_torch.nlp.word2vec import \
                DefaultTokenizerFactory
            tokenizer = DefaultTokenizerFactory()
        self.labels = provider.allLabels()
        lab_idx = {l: i for i, l in enumerate(self.labels)}
        D = int(np.asarray(
            wordVectors.getWordVector(next(iter(wordVectors.vocab)))).shape[0])
        self._vectorSize = D
        unk = np.zeros(D, np.float32)  # reference UNKNOWN vector default
        maxL = int(maxSentenceLength)

        feats, lens, labs = [], [], []
        provider.reset()
        while provider.hasNext():
            sentence, label = provider.nextSentence()
            vecs = []
            for tok in tokenizer.create(sentence):
                if wordVectors.hasWord(tok):
                    vecs.append(np.asarray(wordVectors.getWordVector(tok),
                                           np.float32))
                elif (unknownWordHandling
                      == UnknownWordHandling.UseUnknownVector):
                    vecs.append(unk)
            vecs = vecs[:maxL]
            if not vecs:  # all-unknown sentence still needs a time step
                vecs = [unk]
            m = np.zeros((maxL, D), np.float32)
            m[:len(vecs)] = np.stack(vecs)
            feats.append(m)
            lens.append(len(vecs))
            labs.append(lab_idx[label])

        F = np.stack(feats)                       # [n, maxLen, D]
        mask = (np.arange(maxL)[None, :]
                < np.asarray(lens)[:, None]).astype(np.float32)
        y = np.eye(len(self.labels), dtype=np.float32)[np.asarray(labs)]
        self._format = format
        if format == "CNN":
            F = F[:, None, :, :]                  # [n, 1, maxLen, D]
        else:  # CNN1D / RNN want [n, channels=D, time=maxLen]
            F = np.transpose(F, (0, 2, 1))
        super().__init__(F, y, int(minibatchSize), featuresMask=mask)

    def getLabels(self):
        return list(self.labels)

    def inputColumns(self):
        return self._vectorSize
