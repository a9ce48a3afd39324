"""Word vectors and nearest neighbours on the card (``cuda`` marker):
each training step of Word2Vec (four modes), ParagraphVectors, GloVe and
FastText on the card against the same steps on the CPU under one set of
draws (recorded on the CPU, replayed on the card), k-means assignments
and LSH codes equal, t-SNE within 1e-4 of its max-abs after 10
iterations; with no card, every entry point asked for no device raises
instead of running on the CPU.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_nlp_card.py

Without a card every test but the last skips.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.clustering as PC
import deeplearning4j_tpu_torch.nlp as PN
import deeplearning4j_tpu_torch.plot as PP
from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

pytestmark = pytest.mark.cuda

BAND = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the steps run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _corpus(n=400, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(2, 20), p=p))
            for _ in range(n)]


def _rel(a, b):
    a = a.detach().cpu().double() if torch.is_tensor(a) else \
        torch.as_tensor(np.asarray(a, np.float64))
    b = b.detach().cpu().double() if torch.is_tensor(b) else \
        torch.as_tensor(np.asarray(b, np.float64))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _both(make, card, tables, steps=3):
    cpu = make()
    rec = Draws(0, "cpu", record=True)
    cpu.fit(device="cpu", draws=rec, steps=steps)
    gpu = make()
    gpu.fit(device=card, draws=ReplayDraws(rec.log, card), steps=steps)
    for t in tables:
        assert _rel(getattr(gpu, t), getattr(cpu, t)) < BAND, t
    return cpu, gpu


@pytest.mark.parametrize("alg,hs", [("skipgram", False), ("cbow", False),
                                    ("skipgram", True), ("cbow", True)])
def test_word2vec_steps_card_vs_cpu(card, alg, hs):
    def make():
        return (PN.Word2Vec.Builder().minWordFrequency(2).layerSize(64)
                .windowSize(4).negativeSample(10).batchSize(256)
                .learningRate(2.0).elementsLearningAlgorithm(alg)
                .useHierarchicSoftmax(hs)
                .iterate(PN.CollectionSentenceIterator(_corpus())).build())
    _, gpu = _both(make, card, ("_W", "_C"))
    assert gpu._W.is_cuda and gpu.stepsTaken == 3


@pytest.mark.parametrize("seq", ["DBOW", "DM"])
def test_paragraph_vectors_card_vs_cpu(card, seq):
    def make():
        return (PN.ParagraphVectors.Builder().minWordFrequency(2)
                .layerSize(32).windowSize(3).batchSize(128)
                .sequenceLearningAlgorithm(seq)
                .iterate(PN.CollectionSentenceIterator(_corpus())).build())
    cpu, gpu = _both(make, card, ("_W", "_C", "_D"))
    rec = Draws(1, "cpu", record=True)
    a = cpu.inferVector(_corpus()[3], steps=10, draws=rec)
    b = gpu.inferVector(_corpus()[3], steps=10,
                        draws=ReplayDraws(rec.log, card))
    assert _rel(b, a) < BAND


def test_glove_and_fasttext_card_vs_cpu(card):
    def glove():
        return (PN.Glove.Builder().minWordFrequency(2).layerSize(32)
                .windowSize(5).batchSize(512)
                .iterate(PN.CollectionSentenceIterator(_corpus())).build())
    _both(glove, card, ("_W", "_C"))

    def fasttext():
        return (PN.FastText.Builder().minCount(2).dim(32).bucket(20000)
                .batchSize(256)
                .iterate(PN.CollectionSentenceIterator(_corpus())).build())
    _both(fasttext, card, ("_Win", "_G", "_C", "_W"))


def test_kmeans_lsh_tsne_card_vs_cpu(card):
    rs = np.random.RandomState(0)
    X = (rs.randn(3000, 32) + np.repeat(rs.randn(30, 32) * 4, 100, 0)) \
        .astype(np.float32)
    rec = Draws(0, "cpu", record=True)     # the CPU's first centre
    a = PC.KMeansClustering.setup(30, 50).applyTo(X, device="cpu",
                                                  draws=rec)
    b = PC.KMeansClustering.setup(30, 50).applyTo(
        X, device=card, draws=ReplayDraws(rec.log, "cpu"))
    np.testing.assert_array_equal(b.getAssignments(), a.getAssignments())
    rec = Draws(2, "cpu", record=True)
    la = PC.RandomProjectionLSH(16, 4, 32).index(X, device="cpu", draws=rec)
    lb = PC.RandomProjectionLSH(16, 4, 32).index(
        X, device=card, draws=ReplayDraws(rec.log, card))
    for ta, tb in zip(la._tables, lb._tables):
        assert sorted(ta) == sorted(tb)
    rec = Draws(3, "cpu", record=True)
    ya = PP.BarnesHutTsne(maxIter=10, method="tiled").fit(
        X[:1500], device="cpu", draws=rec).getData()
    yb = PP.BarnesHutTsne(maxIter=10, method="tiled").fit(
        X[:1500], device=card, draws=ReplayDraws(rec.log, card)).getData()
    assert _rel(yb, ya) < 1e-4


def test_no_card_means_no_fit():
    """Asked for no device, every entry point needs the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    sents = _corpus(20, 10)
    calls = [
        lambda: PN.Word2Vec(iterator=PN.CollectionSentenceIterator(sents),
                            minWordFrequency=1).fit(),
        lambda: PN.Glove(iterator=PN.CollectionSentenceIterator(sents),
                         minWordFrequency=1).fit(),
        lambda: PN.FastText(iterator=PN.CollectionSentenceIterator(sents)
                            ).fit(),
        lambda: PC.KMeansClustering(2).applyTo(np.eye(4)),
        lambda: PC.RandomProjectionLSH(4, 2, 4).index(np.eye(4)),
        lambda: PP.BarnesHutTsne(perplexity=2).fit(np.eye(10)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
