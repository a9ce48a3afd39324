"""The port's array layer: INDArray + Nd4j over torch tensors.

The counterpart of ``deeplearning4j_tpu/ndarray/`` (reference modules:
nd4j-api's ndarray, factory and indexing packages): ``DataType``,
``INDArray`` (value semantics over a tensor payload), the ``Nd4j``
factory (the card unless ``device="cpu"``), ``NDArrayIndex``,
``Transforms``, ``Convolution`` (im2col/col2im), the seeded ``random``
facade, the ``TorchExecutioner`` (the reference's ``XlaExecutioner``)
and the compression codecs.
"""

from deeplearning4j_tpu_torch.ndarray.dtype import DataType
from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray
from deeplearning4j_tpu_torch.ndarray.factory import Nd4j
from deeplearning4j_tpu_torch.ndarray.convolution import Convolution
from deeplearning4j_tpu_torch.ndarray.indexing import NDArrayIndex
from deeplearning4j_tpu_torch.ndarray.executioner import (  # noqa: F401
    TorchExecutioner, XlaExecutioner,
)
from deeplearning4j_tpu_torch.ndarray.transforms import Transforms
from deeplearning4j_tpu_torch.ndarray.compression import (
    BasicNDArrayCompressor, CompressedNDArray, Int8Inference,
)

__all__ = ["Convolution", "DataType", "INDArray", "Nd4j", "NDArrayIndex",
           "TorchExecutioner", "XlaExecutioner", "Transforms",
           "BasicNDArrayCompressor",
           "CompressedNDArray", "Int8Inference"]
