"""Word-vector serialization and interop.

The counterpart of ``deeplearning4j_tpu/nlp/serializer.py`` (reference:
org.deeplearning4j.models.embeddings.loader.WordVectorSerializer): the
word2vec/GloVe text format (optional "V D" header, one "word v1 .. vD"
line per word), the word2vec C binary format, the native npz model files
of Word2Vec and ParagraphVectors, and readWord2VecModel's format
sniffing. Every format is the reference's byte for byte, so a file
written by either package reads in the other. Static tables stay host
numpy; native model files load onto a device (the card unless
``device="cpu"``).
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.nlp.query import WordVectorQuery

__all__ = ["StaticWordVectors", "WordVectorSerializer"]


class StaticWordVectors(WordVectorQuery):
    """Read-only word vectors (reference: the WordVectors interface as
    returned by loadTxtVectors). Shares Word2Vec's query surface
    (hasWord/getWordVector/similarity/wordsNearest + `vocab`), so it
    plugs into CnnSentenceDataSetIterator and friends."""

    def __init__(self, words, matrix):
        if isinstance(words, dict):
            # honor a {word: row index} mapping (the shape of
            # Word2Vec.vocab) — iterating the dict and renumbering
            # would silently rebind every vector to the wrong row
            if sorted(words.values()) != list(range(len(words))):
                raise ValueError(
                    "vocab dict values must be exactly the row indices "
                    f"0..{len(words) - 1}")
            self._ivocab = [None] * len(words)
            for w, i in words.items():
                self._ivocab[i] = w
        else:
            self._ivocab = list(words)
        self.vocab = {w: i for i, w in enumerate(self._ivocab)}
        if len(self.vocab) != len(self._ivocab):
            raise ValueError("duplicate words in vector table")
        self._W = np.asarray(matrix, np.float32)
        if self._W.ndim != 2 or self._W.shape[0] != len(self._ivocab):
            raise ValueError(
                f"matrix shape {self._W.shape} does not match "
                f"{len(self._ivocab)} words")



def _words_for_write(vectors, fmt):
    """Vocab order + whitespace validation shared by the text and binary
    writers — whole-vocab check BEFORE any file is opened so a failure
    can't leave a truncated file."""
    words = (vectors._ivocab if hasattr(vectors, "_ivocab")
             else sorted(vectors.vocab))
    if not words:
        raise ValueError("no words to write")
    bad = [w for w in words if any(c.isspace() for c in w)]
    if bad:
        raise ValueError(
            f"words {bad[:5]!r} contain whitespace — unrepresentable in "
            f"the {fmt} format")
    return words


class WordVectorSerializer:
    @staticmethod
    def writeWordVectors(vectors, path, writeHeader=True):
        """Text format (reference: WordVectorSerializer.writeWordVectors):
        optional "V D" header, then "word v1 .. vD" per line. Accepts a
        trained Word2Vec/ParagraphVectors/Glove or a StaticWordVectors."""
        words = _words_for_write(vectors, "text")
        first = np.asarray(vectors.getWordVector(words[0]))
        # one %-format a row: the bytes of the reference's per-value
        # f"{x:.6g}", about twice as fast
        fmt = " ".join(["%.6g"] * first.shape[0])
        with open(str(path), "w", encoding="utf-8") as f:
            if writeHeader:
                f.write(f"{len(words)} {first.shape[0]}\n")
            for w in words:
                vec = np.asarray(vectors.getWordVector(w), np.float32)
                f.write(w + " " + fmt % tuple(vec.tolist()) + "\n")

    @staticmethod
    def loadTxtVectors(path):
        """-> StaticWordVectors (reference: loadTxtVectors). Accepts
        files with or without the "V D" header line (GloVe ships
        headerless); any whitespace separates fields."""
        with open(str(path), encoding="utf-8") as f:
            lines = [(ln, parts) for ln, parts in
                     ((ln, line.split()) for ln, line in enumerate(f, 1))
                     if parts]
        if lines and len(lines[0][1]) == 2:
            # a "V D" header has exactly two int tokens AND a matching
            # body line count — the count check keeps a headerless
            # numeric-vocab 1-d file from losing its first row
            try:
                v, _ = int(lines[0][1][0]), int(lines[0][1][1])
                if v == len(lines) - 1:
                    lines = lines[1:]
            except ValueError:
                pass
        words, vals = [], []
        dim = None
        for ln, parts in lines:
            if dim is None:
                dim = len(parts) - 1
                if dim == 0:
                    raise ValueError(f"line {ln}: no vector components")
            elif len(parts) - 1 != dim:
                raise ValueError(f"line {ln}: expected {dim} components, "
                                 f"got {len(parts) - 1}")
            words.append(parts[0])
            vals.extend(parts[1:])
        if not words:
            raise ValueError(f"no vectors found in {path}")
        # one conversion for the whole table: the same str -> f32 as the
        # reference's row by row
        return StaticWordVectors(
            words, np.array(vals, np.float32).reshape(len(words), dim))


    @staticmethod
    def writeBinaryModel(vectors, path):
        """word2vec C binary format (the Google News .bin layout, what
        the reference's readWord2VecModel(binary) and gensim's
        load_word2vec_format(binary=True) consume): ASCII "V D\\n"
        header, then per word the UTF-8 token, one space, D
        little-endian float32s, one trailing newline."""
        words = _words_for_write(vectors, "word2vec binary")
        first = np.asarray(vectors.getWordVector(words[0]))
        with open(str(path), "wb") as f:
            f.write(f"{len(words)} {first.shape[0]}\n".encode("ascii"))
            for w in words:
                vec = np.asarray(vectors.getWordVector(w),
                                 "<f4")  # little-endian on any host
                f.write(w.encode("utf-8") + b" ")
                f.write(vec.tobytes())
                f.write(b"\n")

    @staticmethod
    def readBinaryModel(path):
        """-> StaticWordVectors from the word2vec C binary format."""
        with open(str(path), "rb") as f:
            header = b""
            while not header.endswith(b"\n"):
                c = f.read(1)
                if not c:
                    raise ValueError(f"{path}: truncated before header end")
                header += c
                if len(header) > 64:
                    raise ValueError(f"{path}: malformed binary header")
            try:
                V, D = (int(t) for t in header.split())
            except ValueError:
                raise ValueError(f"{path}: binary header is not 'V D'")
            words, rows = [], []
            for i in range(V):
                c = f.read(1)
                while c in (b"\n", b" ", b"\r"):  # inter-record padding
                    c = f.read(1)
                w = b""
                while c != b" ":
                    if not c:
                        raise ValueError(
                            f"{path}: truncated in word {i + 1}/{V}")
                    w += c
                    c = f.read(1)
                buf = f.read(4 * D)
                if len(buf) != 4 * D:  # incl. mid-float cuts, which
                    # would make frombuffer raise a pathless numpy error
                    buf = buf[:len(buf) - len(buf) % 4]
                vec = np.frombuffer(buf, "<f4")
                if vec.size != D:
                    raise ValueError(
                        f"{path}: truncated vector for "
                        f"{w.decode('utf-8', 'replace')!r} "
                        f"({vec.size}/{D} floats)")
                words.append(w.decode("utf-8"))
                rows.append(vec.astype(np.float32))
            trailing = f.read()
            if trailing.strip(b"\n\r "):
                raise ValueError(
                    f"{path}: {len(trailing)} unexpected bytes after the "
                    f"declared {V} records — not word2vec binary layout")
        return StaticWordVectors(words, np.stack(rows))

    @staticmethod
    def writeParagraphVectors(model, path):
        """Reference: WordVectorSerializer.writeParagraphVectors — the
        full ParagraphVectors state (word + context + doc tables)."""
        from deeplearning4j_tpu_torch.nlp.word2vec import ParagraphVectors

        if not isinstance(model, ParagraphVectors):
            raise TypeError("writeParagraphVectors expects a "
                            "ParagraphVectors model")
        model.save(path)

    @staticmethod
    def readParagraphVectors(path, device=None):
        """Reference: WordVectorSerializer.readParagraphVectors; the
        model's tables go to `device` (None: the card)."""
        from deeplearning4j_tpu_torch.nlp.word2vec import ParagraphVectors

        return ParagraphVectors.load(path, device=device)

    @staticmethod
    def _looks_binary(path):
        """Binary-vs-text sniff for readWord2VecModel: a text vector
        file is fully utf-8-decodable; raw float32 payloads essentially
        never are."""
        with open(str(path), "rb") as f:
            sample = f.read(4096)
        try:
            sample.decode("utf-8")
            return False
        except UnicodeDecodeError as e:
            # a multibyte char split at the sample boundary is not
            # evidence of binary content
            return e.start < len(sample) - 3

    @staticmethod
    def readWord2VecModel(path, device=None):
        """Type-dispatching load (reference: readWord2VecModel): a
        native npz (by extension, by the save()-appended '.npz', or by
        zip magic bytes) restores the full trainable model — a
        ParagraphVectors file (doc-vector table present) comes back as
        ParagraphVectors, not silently downgraded; anything else is
        parsed as the text format. A native model's tables go to
        `device` (None: the card); a text or binary table stays host
        numpy."""
        from deeplearning4j_tpu_torch.nlp.word2vec import ParagraphVectors, \
            Word2Vec

        def _load_native(q):
            with np.load(Word2Vec._npz(q), allow_pickle=True) as z:
                is_pv = "D" in z.files
            return (ParagraphVectors if is_pv else Word2Vec).load(
                q, device=device)

        p = str(path)
        if p.endswith(".npz"):
            return _load_native(p)
        if not os.path.exists(p) and os.path.exists(p + ".npz"):
            return _load_native(p)  # save() appended the suffix
        if os.path.exists(p):
            with open(p, "rb") as f:
                if f.read(4) == b"PK\x03\x04":  # npz = zip container
                    raise ValueError(
                        f"{p} is an npz container without the .npz suffix "
                        "(externally renamed?) — rename it to <name>.npz "
                        "so the native loader can open it")
        if os.path.exists(p) and WordVectorSerializer._looks_binary(p):
            return WordVectorSerializer.readBinaryModel(p)
        try:
            return WordVectorSerializer.loadTxtVectors(p)
        except ValueError as text_err:
            # binary payloads that happen to be valid UTF-8 (e.g.
            # all-zero vectors) fool the sniff; accept the binary
            # parse only if it consumes the file exactly
            try:
                return WordVectorSerializer.readBinaryModel(p)
            except ValueError:
                raise text_err
