"""The port's Word2Vec and ParagraphVectors against the reference.

Host arrays are held bitwise: the vocabulary and its 0.75-power table,
the skip-gram pairs, the CBOW and PV-DM windows, the PV-DBOW pairs and
the Huffman codes. Each training mode runs under the reference's own
draws (``tests/_torch_nlp_draws.py``) and its tables must lie within
BAND of their max-abs of the reference's: the port scatters the rows'
gradients with ``index_add_`` where the reference adds a dense gradient,
so duplicate rows sum in another order. Files cross between the
packages; the query cache follows a re-fit; the port's own negatives
follow the 0.75-power table.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as P
from _torch_nlp_draws import RefDraws, max_abs_rel
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu_torch.nlp.word2vec import build_huffman, window_rows
from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

torch.set_num_threads(2)

#: trained tables, port vs reference, of the reference's max-abs
BAND = 2e-5


def _corpus(n=160, vocab=50, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(0, 14), p=p))
            for _ in range(n)]


SENTS = _corpus()


def _build(M, cls="Word2Vec", sents=SENTS, **kw):
    b = (getattr(M, cls).Builder()
         .iterate(M.CollectionSentenceIterator(sents)).minWordFrequency(2)
         .layerSize(8).windowSize(3).seed(1).batchSize(48).iterations(2)
         .learningRate(0.5))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


# ----------------------------------------------------------------------
# host arrays, bitwise
# ----------------------------------------------------------------------

def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_vocabulary_and_unigram_table():
    p, j = _build(P, stopWords=["w1"]), _build(J, stopWords=["w1"])
    p._scan_vocab()
    j._scan_vocab()
    assert p._ivocab == j._ivocab and p.vocab == j.vocab
    assert "w1" not in p.vocab
    _equal([p._counts, p._freq], [j._counts, j._freq])
    with pytest.raises(ValueError, match="empty vocabulary"):
        _build(P, minWordFrequency=10**6)._scan_vocab()


@pytest.mark.parametrize("window", [1, 3, 6])
def test_skipgram_pairs_and_cbow_windows(window):
    p, j = _build(P, windowSize=window), _build(J, windowSize=window)
    _equal(p._scan(), j._scan())
    _equal(p._cbow_examples(), j._cbow_examples())
    ids = [p.vocab[t] for t in SENTS[3].split() if t in p.vocab]
    c, x, m, _ = window_rows([ids], window)    # PV-DM inference's windows
    assert (c.tolist(), x.tolist(), m.tolist()) == JW2V._windows(ids, window)


def test_paragraph_vector_examples():
    p = _build(P, "ParagraphVectors", sequenceLearningAlgorithm="DM")
    j = _build(J, "ParagraphVectors", sequenceLearningAlgorithm="DM")
    _equal(p._dm_examples(), j._dm_examples())
    _equal([p._doc_trained], [j._doc_trained])
    assert not p._doc_trained.all()       # the corpus has empty docs
    p._scan_vocab()
    j._scan_vocab()
    _equal(p._doc_pairs(), j._doc_pairs())
    assert p._n_docs == j._n_docs


def test_huffman_codes_with_ties():
    counts = np.array([9, 5, 5, 5, 3, 3, 2, 2, 2, 1, 1, 1, 1], np.int64)
    _equal(build_huffman(counts), JW2V._build_huffman(counts))
    p = _build(P)
    p._scan_vocab()
    _equal(build_huffman(p._counts), JW2V._build_huffman(p._counts))
    with pytest.raises(ValueError, match="at least 2"):
        build_huffman(np.array([3]))


# ----------------------------------------------------------------------
# training under the reference's draws
# ----------------------------------------------------------------------

MODES = [("skipgram", False), ("cbow", False), ("skipgram", True),
         ("cbow", True)]


@pytest.mark.parametrize("alg,hs", MODES,
                         ids=["sgns", "cbow-ns", "sg-hs", "cbow-hs"])
def test_fit_matches_the_reference(alg, hs):
    kw = dict(elementsLearningAlgorithm=alg, useHierarchicSoftmax=hs)
    p, j = _build(P, **kw), _build(J, **kw)
    j.fit()
    draws = RefDraws(1)
    p.fit(device="cpu", draws=draws)
    assert max_abs_rel(p._W, j._W) < BAND
    assert max_abs_rel(p._C, j._C) < BAND
    assert p._score == pytest.approx(j._score, rel=1e-5)
    assert draws.names[0] == "word2vec.W"
    assert draws.names.count("word2vec.perm") == 2
    assert ("word2vec.neg" in draws.names) != hs
    assert p.wordsNearest("w3", 5) == j.wordsNearest("w3", 5)


@pytest.mark.parametrize("seq,hs", [("DBOW", False), ("DM", False),
                                    ("DBOW", True)],
                         ids=["dbow", "dm", "dbow-hs"])
def test_paragraph_vectors_match_the_reference(seq, hs):
    kw = dict(sequenceLearningAlgorithm=seq, useHierarchicSoftmax=hs)
    p = _build(P, "ParagraphVectors", **kw)
    j = _build(J, "ParagraphVectors", **kw)
    j.fit()
    p.fit(device="cpu", draws=RefDraws(1))
    for a in ("_W", "_C", "_D"):
        assert max_abs_rel(getattr(p, a), getattr(j, a)) < BAND, a
    doc = next(i for i, ok in enumerate(p._doc_trained) if ok)
    np.testing.assert_allclose(p.getParagraphVector(doc),
                               np.asarray(j.getParagraphVector(doc)),
                               atol=BAND * np.abs(np.asarray(j._D)).max())
    got = p.inferVector(SENTS[5], steps=20, draws=RefDraws(1))
    want = j.inferVector(SENTS[5], steps=20)
    assert max_abs_rel(got, want) < BAND
    bad = next(i for i, ok in enumerate(p._doc_trained) if not ok)
    with pytest.raises(ValueError, match="never trained"):
        p.getParagraphVector(bad)


def test_replayed_draws_and_step_cap_repeat_a_run():
    rec = Draws(7, "cpu", record=True)
    a = _build(P).fit(device="cpu", draws=rec, steps=3)
    assert a.stepsTaken == 3
    b = _build(P).fit(device="cpu", draws=ReplayDraws(rec.log), steps=3)
    assert torch.equal(a._W, b._W) and torch.equal(a._C, b._C)
    with pytest.raises(RuntimeError, match="replay"):
        _build(P).fit(device="cpu", draws=ReplayDraws(rec.log[:2]))


def test_query_cache_follows_a_refit():
    """The host copy is keyed on the table and its version: an in-place
    fit keeps the tensor's identity but not its version."""
    m = _build(P)
    m.fit(device="cpu", draws=Draws(1, "cpu"))
    v1 = m.getWordVector("w2")
    near1 = m.wordsNearest("w2", 5)
    W = m._W
    m._W.add_(1.0)                      # in place: same identity
    assert m._W is W
    np.testing.assert_allclose(m.getWordVector("w2"), v1 + 1.0, rtol=1e-6)
    m.fit(device="cpu", draws=Draws(2, "cpu"))
    np.testing.assert_array_equal(m.getWordVector("w2"),
                                  m._W[m.vocab["w2"]].numpy())
    assert not np.array_equal(m.getWordVector("w2"), v1)
    assert isinstance(near1, list) and len(near1) == 5


def test_own_negatives_follow_the_table():
    p = _build(P)
    p._scan_vocab()
    freq = torch.from_numpy(p._freq)
    idx = Draws(3, "cpu").choice("word2vec.neg", freq, (400, 250))
    assert idx.dtype == torch.int64 and idx.shape == (400, 250)
    n = idx.numel()
    hist = torch.bincount(idx.reshape(-1), minlength=len(freq)).double() / n
    f = freq.double()
    # each word's share within 5 binomial sigmas; the mean index too
    sigma = torch.sqrt(f * (1 - f) / n)
    assert bool(((hist - f).abs() <= 5 * sigma + 1e-12).all())
    ar = torch.arange(len(f), dtype=torch.float64)
    mean = (f * ar).sum()
    sd = torch.sqrt((f * (ar - mean) ** 2).sum() / n)
    assert abs(float(idx.double().mean() - mean)) < 5 * float(sd)


def test_analogy_and_reference_tables():
    j = _build(J)
    j.fit()
    p = _build(P)
    p._scan_vocab()
    p.load_reference_params(np.asarray(j._W), np.asarray(j._C),
                            device="cpu")
    assert p.wordsNearest(["w2", "w3"], 4, negative=["w5"]) == \
        j.wordsNearest(["w2", "w3"], 4, negative=["w5"])
    assert p.similarity("w2", "w4") == pytest.approx(j.similarity("w2", "w4"),
                                                     rel=1e-6)
    with pytest.raises(KeyError):
        p.wordsNearest("nope")
    with pytest.raises(ValueError, match="rows"):
        p.load_reference_params(np.zeros((3, 8)), np.zeros((3, 8)),
                                device="cpu")


@pytest.mark.parametrize("cls", ["Word2Vec", "ParagraphVectors"])
def test_model_files_cross_both_ways(cls, tmp_path):
    p = _build(P, cls)
    p.fit(device="cpu")
    j = _build(J, cls)
    j.fit()
    p.save(tmp_path / "port")
    back = getattr(J, cls).load(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(back._W), p._W.numpy())
    j.save(tmp_path / "ref")
    mine = getattr(P, cls).load(tmp_path / "ref", device="cpu")
    np.testing.assert_array_equal(mine._W.numpy(), np.asarray(j._W))
    np.testing.assert_array_equal(mine._C.numpy(), np.asarray(j._C))
    assert mine._ivocab == j._ivocab
    if cls == "ParagraphVectors":
        np.testing.assert_array_equal(mine._D.numpy(), np.asarray(j._D))
        assert mine.inferVector(SENTS[2], steps=5).shape == (8,)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build(P).fit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build(P, "ParagraphVectors").fit()
    m = _build(P, device="cpu").fit()     # the Builder's device
    assert m._W.device.type == "cpu"


def test_builder_refusals():
    with pytest.raises(ValueError, match="elementsLearningAlgorithm"):
        P.Word2Vec(elementsLearningAlgorithm="glove")
    with pytest.raises(ValueError, match="DM"):
        P.ParagraphVectors(sequenceLearningAlgorithm="DM",
                           useHierarchicSoftmax=True)
    with pytest.raises(RuntimeError, match="fit"):
        P.Word2Vec().getWordVector("a")
