"""Data: DataSet, MultiDataSet, the iterators and the normalizers, the
DataVec record readers and transforms, columnar files, image
augmentation and audio features."""

from deeplearning4j_tpu_torch.data.dataset import (
    DataSet, DataSetIterator, ExistingDataSetIterator,
    ExistingMiniBatchDataSetIterator, KFoldIterator, ListDataSetIterator,
    MiniBatchFileDataSetIterator, MultipleEpochsIterator, SplitTestAndTrain,
    ViewIterator,
)
from deeplearning4j_tpu_torch.data.iterators import (
    Cifar10DataSetIterator, CifarDataSetIterator, EmnistDataSetIterator,
    FashionMnistDataSetIterator, IrisDataSetIterator, MnistDataSetIterator,
    RandomDataSetIterator,
)
from deeplearning4j_tpu_torch.data.multidataset import (
    MultiDataSet, MultiDataSetIterator,
)
from deeplearning4j_tpu_torch.data.normalizers import (
    DataNormalization, ImagePreProcessingScaler, NormalizerMinMaxScaler,
    NormalizerStandardize, VGG16ImagePreProcessor,
)
from deeplearning4j_tpu_torch.data.multireader import (
    RecordReaderMultiDataSetIterator,
)
from deeplearning4j_tpu_torch.data.transform import (
    Join, executeJoin, Reducer, ReduceOp, ConditionFilter, ConditionOp,
    ColumnCondition, DoubleColumnCondition, IntegerColumnCondition,
    CategoricalColumnCondition, StringColumnCondition, DataAnalysis,
    analyze, DataQualityAnalysis, analyzeQuality,
)
from deeplearning4j_tpu_torch.data.columnar import (
    ColumnarRecordReader, writeColumnar,
)
from deeplearning4j_tpu_torch.data.augment import (
    ImageTransform, FlipImageTransform, RandomCropTransform,
    ResizeImageTransform, RotateImageTransform, PipelineImageTransform,
    ImageAugmentationPreProcessor,
)
from deeplearning4j_tpu_torch.data.audio import (
    SpectrogramTransform, MelSpectrogramTransform, MFCCTransform,
    WavFileRecordReader, mel_filterbank,
)
from deeplearning4j_tpu_torch.data.records import (
    RecordReader, CSVRecordReader, CollectionRecordReader, ImageRecordReader,
    Schema, TransformProcess, RecordReaderDataSetIterator,
    CSVSequenceRecordReader, SequenceRecordReaderDataSetIterator,
)

from deeplearning4j_tpu_torch.data.resilient import RetryingDataSetIterator

__all__ = [
    "RetryingDataSetIterator",
    "DataSet", "DataSetIterator", "ExistingDataSetIterator",
    "ExistingMiniBatchDataSetIterator", "KFoldIterator",
    "ListDataSetIterator", "MiniBatchFileDataSetIterator",
    "MultipleEpochsIterator", "SplitTestAndTrain", "ViewIterator",
    "Cifar10DataSetIterator", "CifarDataSetIterator",
    "EmnistDataSetIterator", "FashionMnistDataSetIterator",
    "IrisDataSetIterator", "MnistDataSetIterator", "RandomDataSetIterator",
    "MultiDataSet", "MultiDataSetIterator", "DataNormalization",
    "ImagePreProcessingScaler", "NormalizerMinMaxScaler",
    "NormalizerStandardize", "VGG16ImagePreProcessor",
    "RecordReaderMultiDataSetIterator", "Join", "executeJoin", "Reducer",
    "ReduceOp", "ConditionFilter", "ConditionOp", "ColumnCondition",
    "DoubleColumnCondition", "IntegerColumnCondition",
    "CategoricalColumnCondition", "StringColumnCondition", "DataAnalysis",
    "analyze", "DataQualityAnalysis", "analyzeQuality",
    "ColumnarRecordReader", "writeColumnar", "ImageTransform",
    "FlipImageTransform", "RandomCropTransform", "ResizeImageTransform",
    "RotateImageTransform", "PipelineImageTransform",
    "ImageAugmentationPreProcessor", "SpectrogramTransform",
    "MelSpectrogramTransform", "MFCCTransform", "WavFileRecordReader",
    "mel_filterbank", "RecordReader", "CSVRecordReader",
    "CollectionRecordReader", "ImageRecordReader", "Schema",
    "TransformProcess", "RecordReaderDataSetIterator",
    "CSVSequenceRecordReader", "SequenceRecordReaderDataSetIterator",
]
