"""NLP: word and document embeddings and text vectorizers.

The counterpart of ``deeplearning4j_tpu/nlp`` (reference:
deeplearning4j-nlp Word2Vec [skip-gram and CBOW, negative sampling or
hierarchical softmax], ParagraphVectors [DBOW, DM], Glove, FastText,
BagOfWordsVectorizer / TfidfVectorizer, the tokenizers,
WordVectorSerializer and CnnSentenceDataSetIterator). Host arrays equal
the reference's; the training steps run on the fit's device (the card
unless ``device="cpu"``), their random numbers behind
``util.draws.Draws``.
"""

from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec, ParagraphVectors, DefaultTokenizerFactory,
    CollectionSentenceIterator, LineSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer, TfidfVectorizer, LabelAwareCollectionIterator,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess, LowCasePreProcessor, CommonPreprocessor,
    EndingPreProcessor, NGramTokenizerFactory,
    ChineseTokenizerFactory, JapaneseTokenizerFactory,
    KoreanTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.cnn_sentence import (
    CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider,
    UnknownWordHandling,
)
from deeplearning4j_tpu_torch.nlp.serializer import (
    WordVectorSerializer, StaticWordVectors,
)
from deeplearning4j_tpu_torch.nlp.fasttext import FastText

__all__ = ["Word2Vec", "ParagraphVectors", "DefaultTokenizerFactory",
           "CollectionSentenceIterator", "LineSentenceIterator", "Glove",
           "BagOfWordsVectorizer", "TfidfVectorizer",
           "LabelAwareCollectionIterator",
           "TokenPreProcess", "LowCasePreProcessor", "CommonPreprocessor",
           "EndingPreProcessor", "NGramTokenizerFactory",
           "ChineseTokenizerFactory", "JapaneseTokenizerFactory",
           "KoreanTokenizerFactory",
           "CnnSentenceDataSetIterator",
           "CollectionLabeledSentenceProvider", "UnknownWordHandling",
           "WordVectorSerializer", "StaticWordVectors", "FastText"]
