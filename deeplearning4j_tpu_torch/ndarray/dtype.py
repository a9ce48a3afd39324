"""Data types for the array layer.

The counterpart of ``deeplearning4j_tpu/ndarray/dtype.py``: a
``DataType`` is a thin name over a torch dtype, with the reference's
floating, integer, unsigned, bool and complex (``COMPLEX64``,
``COMPLEX128``: the fft ops' results) members and its aliases (``INT``,
``LONG``, ``FLOAT32``, ``FLOAT64``, ``FLOAT16``). ``torch_dtype`` stands
where the reference keeps ``np_dtype``; ``np_name`` is the numpy name the
reference's files carry (``"float32"``, ``"bfloat16"``).

bf16 has no numpy dtype where the port runs (no ``ml_dtypes``), so
``INDArray.toNumpy()`` of a bf16 array is its exact float32 widening.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DataType", "resolve", "numpy_name"]


class DataType:
    """Enum-like registry of the data types, convertible to and from
    torch dtypes, numpy dtypes and their names."""

    _registry: dict[str, "DataType"] = {}

    def __init__(self, name: str, torch_dtype: torch.dtype, np_name: str):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_name = np_name
        DataType._registry[name] = self

    def __repr__(self) -> str:
        return f"DataType.{self.name}"

    def __eq__(self, other) -> bool:
        if isinstance(other, DataType):
            return self.name == other.name
        try:
            return self.torch_dtype == resolve(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.name)

    def is_floating(self) -> bool:
        return self.torch_dtype.is_floating_point

    def is_integer(self) -> bool:
        return not (self.torch_dtype.is_floating_point
                    or self.torch_dtype.is_complex
                    or self.torch_dtype == torch.bool)

    @staticmethod
    def from_dtype(dt) -> "DataType":
        """A DataType, a torch or numpy dtype, or a name (``"FLOAT"``,
        ``"LONG"``, ``"bfloat16"``, ``"int32"``)."""
        if isinstance(dt, DataType):
            return dt
        td = resolve(dt)
        for v in DataType._registry.values():
            if v.torch_dtype == td:
                return v
        raise ValueError(f"No DataType for dtype {dt!r}")


DataType.FLOAT = DataType("FLOAT", torch.float32, "float32")
DataType.DOUBLE = DataType("DOUBLE", torch.float64, "float64")
DataType.HALF = DataType("HALF", torch.float16, "float16")
DataType.BFLOAT16 = DataType("BFLOAT16", torch.bfloat16, "bfloat16")
DataType.INT8 = DataType("INT8", torch.int8, "int8")
DataType.INT16 = DataType("INT16", torch.int16, "int16")
DataType.INT32 = DataType("INT32", torch.int32, "int32")
DataType.INT64 = DataType("INT64", torch.int64, "int64")
DataType.UINT8 = DataType("UINT8", torch.uint8, "uint8")
DataType.UINT16 = DataType("UINT16", torch.uint16, "uint16")
DataType.UINT32 = DataType("UINT32", torch.uint32, "uint32")
DataType.UINT64 = DataType("UINT64", torch.uint64, "uint64")
DataType.BOOL = DataType("BOOL", torch.bool, "bool")
DataType.COMPLEX64 = DataType("COMPLEX64", torch.complex64, "complex64")
DataType.COMPLEX128 = DataType("COMPLEX128", torch.complex128, "complex128")

# the reference's aliases, registered so their names resolve too
for _alias, _target in [
    ("INT", DataType.INT32),
    ("LONG", DataType.INT64),
    ("FLOAT32", DataType.FLOAT),
    ("FLOAT64", DataType.DOUBLE),
    ("FLOAT16", DataType.HALF),
]:
    setattr(DataType, _alias, _target)
    DataType._registry[_alias] = _target

_BY_NP_NAME = {v.np_name: v.torch_dtype
               for v in list(DataType._registry.values())}
_BY_NP_NAME["bool_"] = torch.bool


def resolve(dt) -> torch.dtype:
    """Any of DataType / name / torch dtype / numpy dtype -> torch dtype."""
    if isinstance(dt, DataType):
        return dt.torch_dtype
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        if dt.upper() in DataType._registry:
            return DataType._registry[dt.upper()].torch_dtype
        name = dt[6:] if dt.startswith("torch.") else dt
        if name in _BY_NP_NAME:
            return _BY_NP_NAME[name]
    name = np.dtype(dt).name
    if name in _BY_NP_NAME:
        return _BY_NP_NAME[name]
    raise ValueError(f"No torch dtype for {dt!r}")


def numpy_name(dt) -> str:
    """The numpy name of a dtype (``"float32"``, ``"bfloat16"``): the
    string the reference writes into a saved graph's ``phDtype``."""
    td = resolve(dt)
    for v in DataType._registry.values():
        if v.torch_dtype == td:
            return v.np_name
    raise ValueError(f"No numpy name for {dt!r}")
