"""Data types: a minimal ``DataType`` over torch dtypes.

The counterpart of ``deeplearning4j_tpu/ndarray/dtype.py`` for the
floating types the networks run in, so that ``.dataType(DataType.FLOAT)``
reads as it does in the reference. ``torch_dtype`` stands where the
reference keeps ``np_dtype``. The rest of ``ndarray/`` (``INDArray``,
``Nd4j``, the integer types) waits for the ndarray slice.
"""

from __future__ import annotations

import torch

__all__ = ["DataType", "resolve"]


class DataType:
    """Enum-like registry of the floating data types."""

    _registry: dict[str, "DataType"] = {}

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        DataType._registry[name] = self

    def __repr__(self) -> str:
        return f"DataType.{self.name}"

    def __eq__(self, other) -> bool:
        if isinstance(other, DataType):
            return self.name == other.name
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.name)

    @staticmethod
    def from_dtype(dt) -> "DataType":
        """A DataType, a torch dtype, or a name ("FLOAT", "bfloat16")."""
        if isinstance(dt, DataType):
            return dt
        if isinstance(dt, str):
            for v in DataType._registry.values():
                if dt.upper() == v.name or dt == str(v.torch_dtype)[6:]:
                    return v
        for v in DataType._registry.values():
            if v.torch_dtype == dt:
                return v
        raise ValueError(f"No DataType for dtype {dt!r}")


DataType.FLOAT = DataType("FLOAT", torch.float32)
DataType.DOUBLE = DataType("DOUBLE", torch.float64)
DataType.HALF = DataType("HALF", torch.float16)
DataType.BFLOAT16 = DataType("BFLOAT16", torch.bfloat16)


def resolve(dt) -> torch.dtype:
    """Any of DataType / name / torch dtype -> torch dtype."""
    return DataType.from_dtype(dt).torch_dtype
