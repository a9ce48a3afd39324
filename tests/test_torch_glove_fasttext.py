"""The port's GloVe and FastText against the reference.

Bitwise: GloVe's co-occurrence arrays (order, symmetric 1/distance
weights, f32 sums), FastText's char n-grams, FNV-1a hashes, subword
matrix and supervised feature rows. Under the reference's draws
(``tests/_torch_nlp_draws.py``) the trained tables lie within BAND of
their max-abs of the reference's (scattered row gradients sum duplicates
in another order); predictions and files cross both ways.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as P
from _torch_nlp_draws import RefDraws, max_abs_rel
from deeplearning4j_tpu.nlp import fasttext as jft
from deeplearning4j_tpu_torch.nlp import fasttext as pft
from deeplearning4j_tpu_torch.util.draws import Draws

torch.set_num_threads(2)

BAND = 2e-5


def _corpus(n=150, vocab=40, seed=1):
    rng = np.random.default_rng(seed)
    words = [f"tok{i}" for i in range(vocab)] + ["naïve", "café"]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(1, 12), p=p))
            for _ in range(n)]


SENTS = _corpus()


def _glove(M, **kw):
    b = (M.Glove.Builder().iterate(M.CollectionSentenceIterator(SENTS))
         .minWordFrequency(2).layerSize(6).windowSize(4).seed(3)
         .batchSize(64).epochs(3).xMax(10.0).alpha(0.75))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


@pytest.mark.parametrize("window", [1, 4, 10])
def test_glove_cooccurrences_bitwise(window):
    p, j = _glove(P, windowSize=window), _glove(J, windowSize=window)
    got, want = p._cooccurrences(), j._cooccurrences()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_glove_fit_matches_the_reference():
    p, j = _glove(P), _glove(J)
    j.fit()
    p.fit(device="cpu", draws=RefDraws(3))
    assert p.cooccurrenceEntries == len(j._cooccurrences()[0])
    assert max_abs_rel(p._W, j._W) < BAND
    assert max_abs_rel(p._C, j._C) < BAND
    assert p._score == pytest.approx(j._score, rel=1e-4)
    assert p.wordsNearest("tok2", 4) == j.wordsNearest("tok2", 4)


def test_glove_loss_falls_and_reference_tables_continue():
    g = _glove(P, epochs=1)
    g.fit(device="cpu", draws=Draws(0, "cpu"), steps=1)
    first = g._score
    g2 = _glove(P, epochs=25)
    g2.fit(device="cpu", draws=Draws(0, "cpu"))
    assert g2._score < first
    # the reference's raw tables and accumulators carry across: one more
    # epoch from them matches the reference's own continuation
    j = _glove(J, epochs=1)
    j.fit()
    p = _glove(P, epochs=1)
    p._scan_vocab()
    V, D = len(p.vocab), 6
    rng = np.random.default_rng(0)
    tables = {k: rng.standard_normal((V, D) if k in ("W", "Wt") else V)
              .astype(np.float32) * 0.1 for k in ("W", "Wt", "b", "bt")}
    acc = {k: np.ones_like(v) * 2.0 for k, v in tables.items()}
    p.load_reference_params(**tables, acc=acc, device="cpu")
    np.testing.assert_array_equal(p._W.numpy(), tables["W"] + tables["Wt"])
    p.fit(device="cpu", draws=RefDraws(3))
    assert not np.array_equal(p._params["W"].numpy(), tables["W"])
    assert float(p._acc["W"].min()) >= 2.0


@pytest.mark.parametrize("word", ["tok1", "naïve", "a", "café", "x" * 9])
@pytest.mark.parametrize("minn,maxn", [(3, 6), (1, 2), (5, 5)])
def test_ngrams_and_hashes_bitwise(word, minn, maxn):
    assert pft._ngrams(word, minn, maxn) == jft._ngrams(word, minn, maxn)
    for g in pft._ngrams(word, minn, maxn):
        assert pft._fnv1a(g) == jft._fnv1a(g)


def _ft(M, sup=False, sents=SENTS, **kw):
    b = (M.FastText.Builder().iterate(M.CollectionSentenceIterator(sents))
         .supervised(sup).dim(6).bucket(300).epochs(2).seed(4)
         .batchSize(48).wordNgrams(2).contextWindow(3).negativeSamples(4))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


LABELLED = [f"__label__{'ab'[i % 2]} " + s + (" tok1" if i % 2 else " tok3")
            for i, s in enumerate(SENTS)]


def test_fasttext_host_arrays_bitwise():
    p, j = _ft(P), _ft(J)
    p._scan()
    j._scan()
    assert p._ivocab == j._ivocab
    np.testing.assert_array_equal(p._freq, j._freq)
    for g, w in zip(p._subword_matrix(), j._subword_matrix()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(p._pairs()[0], _skipgram_pairs_ref(j))
    p, j = _ft(P, True, LABELLED), _ft(J, True, LABELLED)
    p._scan()
    j._scan()
    for toks in p._sents[:20]:
        assert p._features(toks) == j._features(toks)


def _skipgram_pairs_ref(j):
    centers = []
    for toks in j._sents:
        ids = [j.vocab[t] for t in toks if t in j.vocab]
        for i, c in enumerate(ids):
            lo = max(0, i - j.contextWindow)
            hi = min(len(ids), i + j.contextWindow + 1)
            centers.extend(c for jj in range(lo, hi) if jj != i)
    return np.asarray(centers, "int32")


@pytest.mark.parametrize("sup", [False, True], ids=["skipgram", "supervised"])
def test_fasttext_fit_matches_the_reference(sup, tmp_path):
    sents = LABELLED if sup else SENTS
    p, j = _ft(P, sup, sents), _ft(J, sup, sents)
    j.fit()
    p.fit(device="cpu", draws=RefDraws(4))
    assert max_abs_rel(p._W, j._W) < BAND
    if sup:
        assert p.labels == j.labels
        for a in ("_E", "_L", "_b"):
            assert max_abs_rel(getattr(p, a), getattr(j, a)) < BAND, a
        for s in sents[:10]:
            text = s.split(" ", 1)[1]
            assert p.predict(text) == j.predict(text)
            lp, pp = p.predictProbability(text)
            lj, pj = j.predictProbability(text)
            assert lp == lj and pp == pytest.approx(pj, rel=1e-4)
    else:
        for a in ("_Win", "_G", "_C"):
            assert max_abs_rel(getattr(p, a), getattr(j, a)) < BAND, a
        oov = "tok1x"
        np.testing.assert_allclose(p.getWordVector(oov),
                                   np.asarray(j.getWordVector(oov)),
                                   atol=BAND * float(np.abs(
                                       np.asarray(j._G)).max()))
    # files cross both ways
    p.save(tmp_path / "port")
    back = J.FastText.load(tmp_path / "port")
    np.testing.assert_allclose(np.asarray(back._W), p._W.numpy(),
                               rtol=1e-6, atol=1e-7)
    j.save(tmp_path / "ref")
    mine = P.FastText.load(tmp_path / "ref", device="cpu")
    np.testing.assert_allclose(mine._W.numpy(), np.asarray(j._W),
                               rtol=1e-6, atol=1e-7)
    assert mine._ivocab == j._ivocab


def test_fasttext_reference_tables_and_refusals():
    j = _ft(J)
    j.fit()
    p = _ft(P)
    p._scan()
    p.load_reference_params(Win=np.asarray(j._Win), G=np.asarray(j._G),
                            C=np.asarray(j._C), device="cpu")
    np.testing.assert_allclose(p._W.numpy(), np.asarray(j._W), rtol=1e-6,
                               atol=1e-8)
    assert p.wordsNearest("tok2", 3) == j.wordsNearest("tok2", 3)
    with pytest.raises(RuntimeError, match="supervised"):
        p.predict("tok1")
    with pytest.raises(ValueError, match="label"):
        _ft(P, True, ["no label here"]).fit(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _ft(P).fit()
