"""Tokenizer factories and token preprocessors.

A copy of ``deeplearning4j_tpu/nlp/tokenization.py``, bitwise in
behaviour (reference: deeplearning4j-nlp text.tokenization —
tokenizerfactory.{DefaultTokenizerFactory, NGramTokenizerFactory},
tokenizer.preprocessor.{CommonPreprocessor, LowCasePreProcessor,
EndingPreProcessor} and the CJK satellites). Host-side string work: the
factories plug into Word2Vec, GloVe, FastText and the vectorizers
through their ``tokenizerFactory(...)`` hooks, which call
``create(sentence) -> [tokens]``.
"""

from __future__ import annotations

import re


class TokenPreProcess:
    """Per-token string transform (reference:
    tokenization.tokenizer.TokenPreProcess)."""

    def preProcess(self, token):
        raise NotImplementedError


def apply_preprocessor(words, pre):
    """Map `pre` over tokens, dropping tokens it empties — the one
    shared copy of the factory-side preprocessor contract (used by
    DefaultTokenizerFactory and NGramTokenizerFactory)."""
    if pre is None:
        return words
    return [w for w in (pre.preProcess(t) for t in words) if w]


class LowCasePreProcessor(TokenPreProcess):
    def preProcess(self, token):
        return token.lower()


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference:
    preprocessor.CommonPreprocessor, which applies the same
    [\\d.:,\"'()\\[\\]|/?!;]+ strip)."""

    _STRIP = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def preProcess(self, token):
        return self._STRIP.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude English suffix stripper (reference:
    preprocessor.EndingPreProcessor — same fixed suffix list, not a
    real stemmer)."""

    def preProcess(self, token):
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class NGramTokenizerFactory:
    """Emits all n-grams for n in [minN, maxN] over a base tokenizer's
    tokens, n-gram tokens joined by spaces (reference:
    tokenizerfactory.NGramTokenizerFactory)."""

    def __init__(self, tokenizerFactory, minN, maxN):
        self._base = tokenizerFactory
        self.minN, self.maxN = int(minN), int(maxN)
        if not (1 <= self.minN <= self.maxN):
            raise ValueError(f"need 1 <= minN <= maxN, got {minN}, {maxN}")
        self._pre = None

    def setTokenPreProcessor(self, pre):
        self._pre = pre

    def create(self, sentence):
        words = apply_preprocessor(self._base.create(sentence), self._pre)
        out = []
        for n in range(self.minN, self.maxN + 1):
            out.extend(" ".join(words[i:i + n])
                       for i in range(len(words) - n + 1))
        return out


# ---------------------------------------------------------------------
# CJK tokenizer factories
# (reference: the deeplearning4j-nlp-chinese / -japanese / -korean
# satellites — ChineseTokenizerFactory over ansj's dictionary
# segmenter, JapaneseTokenizerFactory over kuromoji, KoreanTokenizerFactory
# over open-korean-text. Those JVM analyzers embed large dictionaries;
# here segmentation is native and the dictionary is INJECTABLE: script-
# aware run splitting plus forward-maximum-matching over any word list
# the user supplies, with the standard single-character fallback that
# CJK embedding pipelines use when no dictionary is available.)
# ---------------------------------------------------------------------

_HAN = "一-鿿㐀-䶿豈-﫿"
_HIRAGANA = "぀-ゟ"
_KATAKANA = "゠-ヿ"
_HANGUL = "가-힯ᄀ-ᇿ㄰-㆏"
_CJK_RUN_RE = re.compile(
    f"([{_HAN}]+)|([{_HIRAGANA}]+)|([{_KATAKANA}]+)"
    f"|([{_HANGUL}]+)|([A-Za-z0-9_']+)")


def _fmm(run, dictionary, max_len):
    """Forward maximum matching: the classic dictionary segmenter
    (what ansj's core does for the upstream Chinese factory). Greedy
    longest dictionary word at each position; single character when
    nothing matches."""
    out = []
    i = 0
    n = len(run)
    while i < n:
        for w in range(min(max_len, n - i), 1, -1):
            if run[i:i + w] in dictionary:
                out.append(run[i:i + w])
                i += w
                break
        else:
            out.append(run[i])
            i += 1
    return out


class _CJKBase:
    def __init__(self, dictionary=None):
        self._dict = frozenset(dictionary) if dictionary else frozenset()
        self._max = max((len(w) for w in self._dict), default=1)
        self._pre = None

    def setTokenPreProcessor(self, pre):
        self._pre = pre

    def _runs(self, sentence):
        """[(kind, text)] with kind in han/hira/kata/hangul/latin."""
        kinds = ("han", "hira", "kata", "hangul", "latin")
        return [(kinds[m.lastindex - 1], m.group(m.lastindex))
                for m in _CJK_RUN_RE.finditer(sentence)]

    def create(self, sentence):
        return apply_preprocessor(self._tokenize(sentence), self._pre)


class ChineseTokenizerFactory(_CJKBase):
    """Reference: nlp-chinese ChineseTokenizerFactory. Han runs segment
    by dictionary FMM (single-character fallback — the standard
    character-level baseline for Chinese embeddings); embedded Latin /
    digit runs pass through whole."""

    def _tokenize(self, sentence):
        out = []
        for kind, run in self._runs(sentence):
            if kind == "han":
                out.extend(_fmm(run, self._dict, self._max)
                           if self._dict else list(run))
            else:
                out.append(run)
        return out


class JapaneseTokenizerFactory(_CJKBase):
    """Reference: nlp-japanese JapaneseTokenizerFactory (kuromoji).
    Without kuromoji's lattice, segmentation uses the script-boundary
    heuristic standard for lightweight Japanese pipelines: kanji /
    hiragana / katakana / Latin transitions delimit tokens (katakana
    loanwords and hiragana particle runs each stay whole), and a
    supplied dictionary refines kanji runs by FMM."""

    def _tokenize(self, sentence):
        out = []
        for kind, run in self._runs(sentence):
            if kind == "han" and self._dict:
                out.extend(_fmm(run, self._dict, self._max))
            else:
                out.append(run)
        return out


class KoreanTokenizerFactory(_CJKBase):
    """Reference: nlp-korean KoreanTokenizerFactory (open-korean-text).
    Korean spaces between words (eojeol); the analyzer's normalization
    step this reproduces is particle (josa) stripping so '서울은' and
    '서울' share an embedding row (stripParticles=False disables it).
    A supplied dictionary additionally FMM-segments each stripped
    eojeol — compound nouns split like the analyzer's compound-noun
    decomposition."""

    _JOSA = ("에서", "으로", "은", "는", "이", "가", "을", "를",
             "의", "에", "로", "와", "과", "도", "만")

    def __init__(self, dictionary=None, stripParticles=True):
        super().__init__(dictionary)
        self._strip = bool(stripParticles)

    def _tokenize(self, sentence):
        out = []
        for kind, run in self._runs(sentence):
            if kind == "hangul":
                if self._strip:
                    for j in self._JOSA:  # tuple is longest-first
                        if run.endswith(j) and len(run) > len(j):
                            run = run[:-len(j)]
                            break
                if self._dict:
                    # dictionary words split; non-matching spans stay
                    # whole (unlike zh/ja, Korean has real spaces, so
                    # single-syllable fallback would shred normal words)
                    segs = _fmm(run, self._dict, self._max)
                    out.extend(self._merge_nondict(segs))
                    continue
            out.append(run)
        return out

    def _merge_nondict(self, segs):
        """_fmm singles that are NOT dictionary words merge back into
        spans, so only dictionary hits split an eojeol."""
        out = []
        buf = ""
        for s in segs:
            if s in self._dict:
                if buf:
                    out.append(buf)
                    buf = ""
                out.append(s)
            else:
                buf += s
        if buf:
            out.append(buf)
        return out
