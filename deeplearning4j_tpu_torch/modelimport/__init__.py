"""Model import (reference: deeplearning4j-modelimport and nd4j-api's
graph mappers).

The ONNX importer is ported: ``OnnxGraphMapper.importGraph`` maps an
ONNX model onto a SameDiff graph through the port's own wire codec.
Keras import (``KerasModelImport``) and the TF frozen-graph importer
(``TFGraphMapper``, ``importFrozenTF``) wait for ROADMAP.md Queue 1 item
12 and raise ``NotImplementedError`` naming it.
"""

from deeplearning4j_tpu_torch.modelimport.onnx import (
    ONNXImportException,
    OnnxGraphMapper,
    importOnnx,
)

__all__ = [
    "KerasModelImport",
    "TFGraphMapper",
    "importFrozenTF",
    "OnnxGraphMapper",
    "ONNXImportException",
    "importOnnx",
]


def _item12(what):
    return NotImplementedError(
        f"{what} waits for a later slice (ROADMAP.md Queue 1 item 12)")


def _keras(name):
    def m(*args, **kwargs):
        raise _item12(f"Keras import (KerasModelImport.{name})")
    m.__name__ = name
    return staticmethod(m)


class KerasModelImport:
    """Keras import builds networks, not SameDiff graphs: item 12."""

    for _n in ("importKerasModelAndWeights",
               "importKerasSequentialModelAndWeights",
               "importKerasModelConfiguration",
               "importKerasSequentialConfiguration"):
        locals()[_n] = _keras(_n)
    del _n


class TFGraphMapper:
    """The TF frozen-graph importer parses GraphDef through the
    ``tensorflow`` package, which the card's machine lacks: item 12."""

    @staticmethod
    def importGraph(*args, **kwargs):
        raise _item12("TF frozen-graph import (TFGraphMapper)")


def importFrozenTF(*args, **kwargs):
    raise _item12("TF frozen-graph import (importFrozenTF)")
