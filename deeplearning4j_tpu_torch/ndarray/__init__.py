"""The port's array layer: so far only ``DataType`` (``dtype.py``)."""

from deeplearning4j_tpu_torch.ndarray.dtype import DataType

__all__ = ["DataType"]
