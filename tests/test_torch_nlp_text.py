# -*- coding: utf-8 -*-
"""The port's NLP host tier against the reference, bitwise: tokenizer
factories and preprocessors (CJK included), the bag-of-words and TF-IDF
vectorizers' matrices, the sentence iterators and
CnnSentenceDataSetIterator's tensors (every format and unknown-word
rule) over the same static vectors."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as P

torch.set_num_threads(2)

SENTENCES = [
    "The quick brown fox's tail, 42 times!",
    "Running quickly: the foxes were jumping (over) lazy dogs.",
    "Alice [and] Bob/Carol; who? 3.14 apples",
    "glass bass moss classes ending endings",
    "",
]
CJK = [
    ("zh", {}, "我爱北京"),
    ("zh", {"dictionary": ["北京", "天安门", "我们"]}, "我们爱北京天安门"),
    ("zh", {"dictionary": ["模型"]}, "TPU模型v5e 和 GPU"),
    ("ja", {}, "私はコーヒーが好きです"),
    ("ja", {"dictionary": ["東京", "大学"]}, "東京大学へ行く JAXで学ぶ"),
    ("ko", {}, "서울은 크다 서울을 본다 은 화폐다"),
    ("ko", {"stripParticles": False}, "서울은 크다"),
    ("ko", {"dictionary": ["서울", "대학교"]}, "서울대학교에서 공부"),
]
_CJK_CLS = {"zh": "ChineseTokenizerFactory", "ja": "JapaneseTokenizerFactory",
            "ko": "KoreanTokenizerFactory"}
_PRE = [None, "LowCasePreProcessor", "CommonPreprocessor",
        "EndingPreProcessor"]


@pytest.mark.parametrize("pre", _PRE)
def test_default_tokenizer_and_preprocessors(pre):
    pt, jt = P.DefaultTokenizerFactory(), J.DefaultTokenizerFactory()
    if pre:
        pt.setTokenPreProcessor(getattr(P, pre)())
        jt.setTokenPreProcessor(getattr(J, pre)())
    for s in SENTENCES:
        assert pt.create(s) == jt.create(s)


@pytest.mark.parametrize("lo,hi", [(1, 1), (1, 3), (2, 2)])
def test_ngram_factory(lo, hi):
    pt = P.NGramTokenizerFactory(P.DefaultTokenizerFactory(), lo, hi)
    jt = J.NGramTokenizerFactory(J.DefaultTokenizerFactory(), lo, hi)
    pt.setTokenPreProcessor(P.EndingPreProcessor())
    jt.setTokenPreProcessor(J.EndingPreProcessor())
    for s in SENTENCES:
        assert pt.create(s) == jt.create(s)
    with pytest.raises(ValueError):
        P.NGramTokenizerFactory(P.DefaultTokenizerFactory(), 3, 2)


@pytest.mark.parametrize("case", range(len(CJK)))
def test_cjk_factories(case):
    lang, kw, text = CJK[case]
    pt = getattr(P, _CJK_CLS[lang])(**kw)
    jt = getattr(J, _CJK_CLS[lang])(**kw)
    pt.setTokenPreProcessor(P.LowCasePreProcessor())
    jt.setTokenPreProcessor(J.LowCasePreProcessor())
    assert pt.create(text) == jt.create(text)


def test_sentence_iterators(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("first line\n\n  second line  \nthird\n")
    for M in (P, J):
        it = M.LineSentenceIterator(str(path))
        got = []
        while it.hasNext():
            got.append(it.nextSentence())
        it.reset()
        assert got == ["first line", "second line", "third"]
        assert it.nextSentence() == "first line"
    it = P.CollectionSentenceIterator(["a", "b"])
    assert [it.nextSentence(), it.nextSentence()] == ["a", "b"]
    assert not it.hasNext()


DOCS = ["the cat sat on the mat", "the dog ate my homework",
        "cats and dogs are pets", "homework is due on monday",
        "the mat is red", "my dog likes the cat"]
LABELS = ["pets", "school", "pets", "school", "home", "pets"]


def _vectorizers(cls, **kw):
    out = []
    for M in (P, J):
        b = getattr(M, cls).Builder().setIterator(
            M.LabelAwareCollectionIterator(DOCS, LABELS))
        b.setMinWordFrequency(kw.get("minFreq", 1)).setStopWords(
            kw.get("stop", []))
        if M is P:
            b.device("cpu")
        out.append(b.build().fit())
    return out


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("minFreq,stop", [(1, []), (2, ["the"])])
def test_vectorizer_matrices(cls, minFreq, stop):
    pv, jv = _vectorizers(cls, minFreq=minFreq, stop=stop)
    assert pv._ivocab == jv._ivocab
    assert pv.vocabSize() == jv.vocabSize()
    assert pv.indexOf("cat") == jv.indexOf("cat")
    for text in DOCS + ["an unseen cat text", "dog dog dog"]:
        got = pv.transform(text)
        assert got.toNumpy().dtype == np.float32
        np.testing.assert_array_equal(
            got.toNumpy(), np.asarray(jv.transform(text).toNumpy()))
        pd, jd = pv.vectorize(text, "pets"), jv.vectorize(text, "pets")
        np.testing.assert_array_equal(pd.getFeatures(),
                                      np.asarray(jd.getFeatures()))
        np.testing.assert_array_equal(pd.getLabels(),
                                      np.asarray(jd.getLabels()))
    pit = pv.iterator_over_corpus(batchSize=4)
    jit = jv.iterator_over_corpus(batchSize=4)
    np.testing.assert_array_equal(pit._f, jit._f)
    np.testing.assert_array_equal(pit._l, jit._l)
    if cls == "TfidfVectorizer":
        for w in ("cat", "the", "absent"):
            assert pv.tfidfWord(w, DOCS[0]) == jv.tfidfWord(w, DOCS[0])
    with pytest.raises(ValueError, match="unknown label"):
        pv.vectorize("x", "nope")


def test_vectorizer_transform_needs_a_device():
    v = P.BagOfWordsVectorizer(
        iterator=P.LabelAwareCollectionIterator(DOCS, LABELS)).fit()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            v.transform("the cat")


def _static(M, words, W):
    return M.StaticWordVectors(words, W)


@pytest.mark.parametrize("fmt", ["CNN", "CNN1D", "RNN"])
@pytest.mark.parametrize("unknown", ["RemoveWord", "UseUnknownVector"])
def test_cnn_sentence_iterator(fmt, unknown):
    words = ["the", "cat", "sat", "dog", "mat", "red", "my"]
    W = np.random.default_rng(2).standard_normal((len(words), 6)).astype(
        np.float32)
    sents = ["the cat sat on the mat", "my dog", "zzz qqq",
             "the red red red cat sat on my mat again", "dog"]
    labs = ["a", "b", "a", "c", "b"]
    its = []
    for M in (P, J):
        its.append(M.CnnSentenceDataSetIterator.Builder()
                   .sentenceProvider(M.CollectionLabeledSentenceProvider(
                       sents, labs))
                   .wordVectors(_static(M, words, W)).maxSentenceLength(7)
                   .minibatchSize(2).unknownWordHandling(unknown)
                   .format(fmt).build())
    pi, ji = its
    assert pi.getLabels() == ji.getLabels()
    assert pi.inputColumns() == ji.inputColumns()
    np.testing.assert_array_equal(pi._f, ji._f)
    np.testing.assert_array_equal(pi._l, ji._l)
    np.testing.assert_array_equal(pi._fm, ji._fm)
    n = 0
    while pi.hasNext():
        pd, jd = pi.next(), ji.next()
        np.testing.assert_array_equal(pd.getFeatures(),
                                      np.asarray(jd.getFeatures()))
        n += 1
    assert n == 3


def test_cnn_sentence_iterator_refusals():
    prov = P.CollectionLabeledSentenceProvider(["a"], ["x"])
    wv = P.StaticWordVectors(["a"], np.ones((1, 2), np.float32))
    with pytest.raises(ValueError, match="CNN/CNN1D/RNN"):
        P.CnnSentenceDataSetIterator(provider=prov, wordVectors=wv,
                                     format="NHWC")
    with pytest.raises(ValueError):
        P.CnnSentenceDataSetIterator(provider=None, wordVectors=wv)
    with pytest.raises(ValueError, match="sentences vs"):
        P.CollectionLabeledSentenceProvider(["a"], [])
