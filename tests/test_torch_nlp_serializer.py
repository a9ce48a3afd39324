"""WordVectorSerializer across the packages: every format written by one
package reads in the other, both ways — the text format (with and
without its header), the word2vec C binary format (bytes equal), the
native Word2Vec / ParagraphVectors files, and readWord2VecModel's
sniffing of each."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as P

torch.set_num_threads(2)

WORDS = ["alpha", "beta", "gamma", "δέλτα", "epsilon", "7", "zeta's"]


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (len(WORDS), 5)).astype(np.float32)


def _vectors(M, seed=0):
    return M.StaticWordVectors(WORDS, _table(seed))


PAIRS = [(P, J), (J, P)]
IDS = ["port->ref", "ref->port"]


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
@pytest.mark.parametrize("header", [True, False])
def test_text_format(writer, reader, header, tmp_path):
    path = tmp_path / "v.txt"
    writer.WordVectorSerializer.writeWordVectors(_vectors(writer), path,
                                                 writeHeader=header)
    got = reader.WordVectorSerializer.loadTxtVectors(path)
    assert got._ivocab == WORDS
    # within the printed digits (%.6g)
    np.testing.assert_allclose(got._W, _table(), rtol=5e-6, atol=1e-30)
    again = tmp_path / "again.txt"
    reader.WordVectorSerializer.writeWordVectors(got, again,
                                                 writeHeader=header)
    assert again.read_bytes() == path.read_bytes()
    assert type(reader.WordVectorSerializer.readWord2VecModel(path)) \
        is reader.StaticWordVectors


@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_binary_format(writer, reader, tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    writer.WordVectorSerializer.writeBinaryModel(_vectors(writer), a)
    reader.WordVectorSerializer.writeBinaryModel(_vectors(reader), b)
    assert a.read_bytes() == b.read_bytes()
    got = reader.WordVectorSerializer.readBinaryModel(a)
    assert got._ivocab == WORDS
    np.testing.assert_array_equal(got._W, _table())
    sniffed = reader.WordVectorSerializer.readWord2VecModel(a)
    np.testing.assert_array_equal(sniffed._W, _table())


def test_binary_refusals(tmp_path):
    path = tmp_path / "bad.bin"
    P.WordVectorSerializer.writeBinaryModel(_vectors(P), path)
    path.write_bytes(path.read_bytes()[:-7])
    for M in (P, J):
        with pytest.raises(ValueError, match="truncated"):
            M.WordVectorSerializer.readBinaryModel(path)
    with pytest.raises(ValueError, match="whitespace"):
        P.WordVectorSerializer.writeWordVectors(
            P.StaticWordVectors(["a b"], np.ones((1, 2))), tmp_path / "x")


SENTS = ["the cat sat on the mat", "the dog sat on the log",
         "a cat and a dog", "the mat and the log"] * 6


def _fit(M, cls):
    b = (getattr(M, cls).Builder()
         .iterate(M.CollectionSentenceIterator(SENTS)).minWordFrequency(1)
         .layerSize(6).windowSize(2).seed(2).batchSize(16))
    m = b.build()
    return m.fit(device="cpu") if M is P else m.fit()


@pytest.mark.parametrize("cls", ["Word2Vec", "ParagraphVectors"])
@pytest.mark.parametrize("writer,reader", PAIRS, ids=IDS)
def test_native_model_files(cls, writer, reader, tmp_path):
    m = _fit(writer, cls)
    path = tmp_path / "model"
    if cls == "ParagraphVectors":
        writer.WordVectorSerializer.writeParagraphVectors(m, path)
        kw = {"device": "cpu"} if reader is P else {}
        got = reader.WordVectorSerializer.readParagraphVectors(path, **kw)
        np.testing.assert_array_equal(np.asarray(got.getParagraphVector(0)),
                                      np.asarray(m.getParagraphVector(0)))
    else:
        m.save(path)
    kw = {"device": "cpu"} if reader is P else {}
    got = reader.WordVectorSerializer.readWord2VecModel(
        str(path) + ".npz", **kw)
    assert type(got).__name__ == cls
    assert got._ivocab == m._ivocab
    np.testing.assert_array_equal(np.asarray(got.getWordVector("cat")),
                                  np.asarray(m.getWordVector("cat")))
    # text and binary from a trained model cross too
    txt, bn = tmp_path / "m.txt", tmp_path / "m.bin"
    writer.WordVectorSerializer.writeWordVectors(m, txt)
    writer.WordVectorSerializer.writeBinaryModel(m, bn)
    t = reader.WordVectorSerializer.loadTxtVectors(txt)
    b = reader.WordVectorSerializer.readBinaryModel(bn)
    assert t._ivocab == b._ivocab == m._ivocab
    np.testing.assert_array_equal(b._W[t.vocab["dog"]],
                                  np.asarray(m.getWordVector("dog")))


def test_sniffing_refusals(tmp_path):
    m = _fit(P, "Word2Vec")
    m.save(tmp_path / "m")
    (tmp_path / "m.npz").rename(tmp_path / "renamed")
    with pytest.raises(ValueError, match="npz container"):
        P.WordVectorSerializer.readWord2VecModel(tmp_path / "renamed")
    with pytest.raises(TypeError, match="ParagraphVectors"):
        P.WordVectorSerializer.writeParagraphVectors(m, tmp_path / "pv")
    with pytest.raises(ValueError, match="Word2Vec model"):
        m.save(tmp_path / "w")
        P.ParagraphVectors.load(tmp_path / "w", device="cpu")
