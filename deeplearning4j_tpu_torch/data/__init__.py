"""Data: DataSet, MultiDataSet, the iterators and the normalizers."""

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

__all__ = [
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
]
