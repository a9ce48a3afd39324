"""WeightInitEmbedding from a word-vector model in the port: the table of
an EmbeddingLayer / EmbeddingSequenceLayer takes the model's vectors in
its vocabulary index order (reference: nn/weights.py WeightInitEmbedding
over deeplearning4j-nlp's WordVectorsEmbeddingInitializer), bitwise the
model's, for every kind of model; the reference builds the same table
from the same vectors, and a seeded sequence classifier fine-tunes from
it (tests/test_embedding_init.py's case)."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as JN
import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nlp as PN
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.nn.conf.layers import \
    EmbeddingSequenceLayer as JEmbSeq
from deeplearning4j_tpu_torch.nn.conf.layers import \
    EmbeddingSequenceLayer as PEmbSeq

torch.set_num_threads(2)


def _corpus(n=200, seed=0):
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "horse", "sheep", "cow"]
    tech = ["cpu", "gpu", "ram", "disk", "cache"]
    return [" ".join(rng.choice(animals if rng.rand() < 0.5 else tech, 6))
            for _ in range(n)]


@pytest.fixture(scope="module")
def w2v():
    return (PN.Word2Vec.Builder().minWordFrequency(2).layerSize(12)
            .windowSize(3).negativeSample(4).seed(7).iterations(25)
            .learningRate(0.5)
            .iterate(PN.CollectionSentenceIterator(_corpus()))
            .build().fit(device="cpu"))


def _conf(M, layer, V, D, source, T=None):
    b = M.NeuralNetConfiguration.Builder().seed(1).list()
    if layer == "seq":
        cls = PEmbSeq if M is P else JEmbSeq
        b = b.layer(cls(nIn=V, nOut=D, inputLength=T,
                        weightInit=M.WeightInitEmbedding(source)))
        b = b.layer(M.GlobalPoolingLayer(poolingType="AVG"))
        it = M.InputType.recurrent(1, T)
    else:
        b = b.layer(M.EmbeddingLayer(nIn=V, nOut=D,
                                     weightInit=M.WeightInitEmbedding(source)))
        it = M.InputType.feedForward(1)
    return b.layer(M.OutputLayer(nOut=2, activation="softmax")) \
        .setInputType(it).build()


def _models(w2v):
    W = w2v._W.numpy()
    static = PN.StaticWordVectors(w2v._ivocab, W)
    ft = (PN.FastText.Builder().minCount(2).dim(12).bucket(100).epochs(2)
          .iterate(PN.CollectionSentenceIterator(_corpus()))
          .build().fit(device="cpu"))
    return {"word2vec": w2v, "static": static, "fasttext": ft}


@pytest.mark.parametrize("kind", ["word2vec", "static", "fasttext"])
@pytest.mark.parametrize("layer", ["ff", "seq"])
def test_table_is_the_models_vectors_in_vocab_order(w2v, kind, layer):
    src = _models(w2v)[kind]
    V, D = len(src.vocab), 12
    net = P.MultiLayerNetwork(_conf(P, layer, V, D, src, T=6),
                              device="cpu").init()
    got = net.getParam("0_W").toNumpy()
    want = np.stack([src.getWordVector(w) for w in src._ivocab])
    np.testing.assert_array_equal(got, want)
    for word, idx in src.vocab.items():
        np.testing.assert_array_equal(got[idx], src.getWordVector(word))
    # the reference builds the same table from the same vectors
    ref = JN.StaticWordVectors(src._ivocab, want)
    jnet = J.MultiLayerNetwork(_conf(J, layer, V, D, ref, T=6)).init()
    np.testing.assert_array_equal(np.asarray(jnet.getParam("0_W").toNumpy()),
                                  got)


def test_shape_mismatch_raises(w2v):
    V = len(w2v.vocab)
    with pytest.raises(ValueError, match="does not match"):
        P.MultiLayerNetwork(_conf(P, "ff", V + 3, 99, w2v),
                            device="cpu").init()


def test_sequence_layer_finetunes_from_pretrained(w2v):
    V, D, T = len(w2v.vocab), 12, 6
    sents = _corpus(120, seed=9)
    X = np.zeros((len(sents), T), "float32")
    y = np.zeros((len(sents),), int)
    animals = {"cat", "dog", "horse", "sheep", "cow"}
    for i, s in enumerate(sents):
        toks = [t for t in s.split() if t in w2v.vocab][:T]
        X[i, :len(toks)] = [w2v.vocab[t] for t in toks]
        y[i] = 0 if toks and toks[0] in animals else 1
    Y = np.eye(2, dtype="float32")[y]
    conf = (P.NeuralNetConfiguration.Builder().seed(2).updater(P.Adam(1e-2))
            .list()
            .layer(PEmbSeq(nIn=V, nOut=D, inputLength=T,
                           weightInit=P.WeightInitEmbedding(w2v)))
            .layer(P.GlobalPoolingLayer(poolingType="AVG"))
            .layer(P.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(P.InputType.recurrent(1, T)).build())
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    first = None
    for _ in range(25):
        net.fit(X, Y)
        if first is None:
            first = net.score()
    assert net.score() < first
    acc = (net.output(X).toNumpy().argmax(1) == y).mean()
    assert acc > 0.9, acc
