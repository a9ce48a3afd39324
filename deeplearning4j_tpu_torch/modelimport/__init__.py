"""Model import (reference: deeplearning4j-modelimport and nd4j-api's
graph mappers): ``KerasModelImport`` (Keras configs and weights ->
MultiLayerNetwork / ComputationGraph), ``TFGraphMapper`` /
``importFrozenTF`` (a frozen GraphDef -> SameDiff, through the port's
own GraphDef codec ``tf_wire``) and ``OnnxGraphMapper`` / ``importOnnx``
(an ONNX model -> SameDiff, through ``onnx_wire``)."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    InvalidKerasConfigurationException,
    KerasModelImport,
    UnsupportedKerasConfigurationException,
)
from deeplearning4j_tpu_torch.modelimport.onnx import (
    ONNXImportException,
    OnnxGraphMapper,
    importOnnx,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow import (
    TFGraphMapper,
    TFImportException,
    importFrozenTF,
)

__all__ = [
    "KerasModelImport",
    "InvalidKerasConfigurationException",
    "UnsupportedKerasConfigurationException",
    "TFGraphMapper",
    "TFImportException",
    "importFrozenTF",
    "OnnxGraphMapper",
    "ONNXImportException",
    "importOnnx",
]
