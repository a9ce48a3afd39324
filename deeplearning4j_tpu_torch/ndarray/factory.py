"""Nd4j — the static array factory.

The counterpart of ``deeplearning4j_tpu/ndarray/factory.py``
(reference: org.nd4j.linalg.factory.Nd4j). Creation lands on the card
unless the caller passes ``device="cpu"`` (``device.resolve_device``:
with no card and no explicit device it raises); arrays derived from
operands (concat, stack, tile, sort, gemm, ...) stay on their operands'
device. The default floating type is ``FLOAT``, overridable with
``setDefaultDataTypes``; ``create`` keeps the reference's dtype rules:
float data takes the default unless a dtype is given, integer and bool
data keep theirs.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray import random as _random
from deeplearning4j_tpu_torch.ndarray.dtype import DataType, resolve
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    INDArray, _promote, arg_reduce, as_tensor, to_numpy,
)

__all__ = ["Nd4j"]


def _shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(int(s) for s in shape)


def _ts(arrs):
    """A list of operands as tensors on the first one's device."""
    if len(arrs) == 1 and isinstance(arrs[0], (list, tuple)):
        arrs = tuple(arrs[0])
    first = next((a for a in arrs if isinstance(a, (INDArray, torch.Tensor))),
                 None)
    dev = None if first is None else as_tensor(first).device
    ts = [as_tensor(a, dev) for a in arrs]
    if ts:
        dt = ts[0].dtype
        for t in ts[1:]:
            dt = torch.promote_types(dt, t.dtype)
        ts = [t.to(dt) for t in ts]
    return ts


class Nd4j:
    _default_dtype = DataType.FLOAT

    # ----- dtype config ----------------------------------------------
    @staticmethod
    def setDefaultDataTypes(dtype, *_):
        Nd4j._default_dtype = DataType.from_dtype(dtype)

    @staticmethod
    def defaultFloatingPointType() -> DataType:
        return Nd4j._default_dtype

    @staticmethod
    def dataType() -> DataType:
        return Nd4j._default_dtype

    @staticmethod
    def _dt(dtype) -> torch.dtype:
        return resolve(dtype) if dtype is not None \
            else Nd4j._default_dtype.torch_dtype

    # ----- creation ---------------------------------------------------
    @staticmethod
    def create(data=None, *more, shape=None, dtype=None,
               device=None) -> INDArray:
        """Nd4j.create(data), Nd4j.create(rows, cols, ...),
        Nd4j.create(data, shape)."""
        if data is None and shape is not None:
            return Nd4j.zeros(*shape, dtype=dtype, device=device)
        if isinstance(data, int):
            # Nd4j.create(2, 3): a zero-filled array of that shape
            return Nd4j.zeros(data, *more, dtype=dtype, device=device)
        if more and shape is None and isinstance(more[0], (tuple, list)):
            shape = tuple(more[0])
        t = as_tensor(data, device)
        if t.is_floating_point() and dtype is None:
            t = t.to(Nd4j._dt(None))
        elif dtype is not None:
            t = t.to(resolve(dtype))
        if shape is not None:
            t = t.reshape(tuple(shape))
        return INDArray(t)

    @staticmethod
    def createFromArray(*values, device=None) -> INDArray:
        if len(values) == 1 and isinstance(values[0],
                                           (list, tuple, np.ndarray)):
            values = values[0]
        return Nd4j.create(np.asarray(values), device=device)

    @staticmethod
    def zeros(*shape, dtype=None, device=None) -> INDArray:
        return INDArray(torch.zeros(_shape(shape), dtype=Nd4j._dt(dtype),
                                    device=resolve_device(device)))

    @staticmethod
    def ones(*shape, dtype=None, device=None) -> INDArray:
        return INDArray(torch.ones(_shape(shape), dtype=Nd4j._dt(dtype),
                                   device=resolve_device(device)))

    @staticmethod
    def zerosLike(arr) -> INDArray:
        return INDArray(torch.zeros_like(as_tensor(arr)))

    @staticmethod
    def onesLike(arr) -> INDArray:
        return INDArray(torch.ones_like(as_tensor(arr)))

    @staticmethod
    def empty(dtype=None, device=None) -> INDArray:
        return Nd4j.zeros(0, dtype=dtype, device=device)

    @staticmethod
    def scalar(value, dtype=None, device=None) -> INDArray:
        dt = Nd4j._dt(dtype) if dtype or not isinstance(value, bool) \
            else torch.bool
        return INDArray(torch.tensor(value, dtype=dt,
                                     device=resolve_device(device)))

    @staticmethod
    def valueArrayOf(shape, value, dtype=None, device=None) -> INDArray:
        if isinstance(shape, int):
            shape = (shape,)
        return INDArray(torch.full(tuple(shape), value, dtype=Nd4j._dt(dtype),
                                   device=resolve_device(device)))

    @staticmethod
    def eye(n: int, dtype=None, device=None) -> INDArray:
        return INDArray(torch.eye(int(n), dtype=Nd4j._dt(dtype),
                                  device=resolve_device(device)))

    @staticmethod
    def diag(v) -> INDArray:
        t = as_tensor(v)
        return INDArray(torch.diag(t if t.ndim == 2 else t.reshape(-1)))

    @staticmethod
    def linspace(start, stop, num, dtype=None, device=None) -> INDArray:
        return INDArray(torch.linspace(start, stop, int(num),
                                       dtype=Nd4j._dt(dtype),
                                       device=resolve_device(device)))

    @staticmethod
    def arange(*args, dtype=None, device=None) -> INDArray:
        t = torch.arange(*args, device=resolve_device(device))
        return INDArray(t.to(Nd4j._dt(dtype)))

    # ----- random (reference: Nd4j.rand/randn via the backend RNG) ----
    @staticmethod
    def rand(*shape, dtype=None, seed=None, device=None) -> INDArray:
        dev = resolve_device(device)
        return INDArray(_random.uniform(_shape(shape), Nd4j._dt(dtype),
                                        seed=seed, device=dev))

    @staticmethod
    def randn(*shape, dtype=None, seed=None, device=None) -> INDArray:
        dev = resolve_device(device)
        return INDArray(_random.normal(_shape(shape), Nd4j._dt(dtype),
                                       seed=seed, device=dev))

    @staticmethod
    def getRandom():
        return _random.getRandom()

    # ----- joining / splitting ---------------------------------------
    @staticmethod
    def concat(dimension: int, *arrs) -> INDArray:
        return INDArray(torch.cat(_ts(arrs), dim=dimension))

    @staticmethod
    def vstack(*arrs) -> INDArray:
        return INDArray(torch.vstack(_ts(arrs)))

    @staticmethod
    def hstack(*arrs) -> INDArray:
        return INDArray(torch.hstack(_ts(arrs)))

    @staticmethod
    def stack(dimension: int, *arrs) -> INDArray:
        return INDArray(torch.stack(_ts(arrs), dim=dimension))

    @staticmethod
    def pile(*arrs) -> INDArray:
        return INDArray(torch.stack(_ts(arrs), dim=0))

    @staticmethod
    def tile(arr, *reps) -> INDArray:
        if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
            reps = tuple(reps[0])
        return INDArray(torch.tile(as_tensor(arr), tuple(reps)))

    @staticmethod
    def repeat(arr, repeats: int, axis: int = 0) -> INDArray:
        return INDArray(torch.repeat_interleave(as_tensor(arr), repeats,
                                                dim=axis))

    # ----- misc ops ---------------------------------------------------
    @staticmethod
    def where(condition, x=None, y=None):
        cond = as_tensor(condition).bool()
        if x is None:
            return [INDArray(i) for i in torch.where(cond)]
        xt = x._t if isinstance(x, INDArray) else x
        yt = y._t if isinstance(y, INDArray) else y
        return INDArray(torch.where(cond, xt, yt))

    @staticmethod
    def sort(arr, dimension: int = -1, ascending: bool = True) -> INDArray:
        s = torch.sort(as_tensor(arr), dim=dimension, stable=True).values
        return INDArray(s if ascending else torch.flip(s, (dimension,)))

    @staticmethod
    def argsort(arr, dimension: int = -1, ascending: bool = True) -> INDArray:
        s = torch.argsort(as_tensor(arr), dim=dimension, stable=True)
        return INDArray(s if ascending else torch.flip(s, (dimension,)))

    @staticmethod
    def reverse(arr, *dimension) -> INDArray:
        if len(dimension) == 1 and isinstance(dimension[0], (tuple, list)):
            dimension = tuple(dimension[0])
        t = as_tensor(arr)
        dims = tuple(int(d) for d in dimension) if dimension \
            else tuple(range(t.ndim))
        return INDArray(torch.flip(t, dims))

    @staticmethod
    def gemm(a, b, transposeA: bool = False, transposeB: bool = False,
             alpha: float = 1.0, beta: float = 0.0, c=None) -> INDArray:
        """General matrix multiply: ``alpha * op(A) @ op(B) + beta * C``
        (reference: cuBLAS sgemm)."""
        A, B = _promote(*_ts([a, b]))
        A = A.T if transposeA else A
        B = B.T if transposeB else B
        out = alpha * torch.matmul(A, B)
        if c is not None and beta != 0.0:
            out = out + beta * as_tensor(c, out.device)
        return INDArray(out)

    @staticmethod
    def matmul(a, b) -> INDArray:
        return INDArray(torch.matmul(*_ts([a, b])))

    @staticmethod
    def expandDims(arr, axis: int) -> INDArray:
        return INDArray(torch.unsqueeze(as_tensor(arr), axis))

    @staticmethod
    def squeeze(arr, axis: int) -> INDArray:
        return INDArray(as_tensor(arr)).squeeze(axis)

    @staticmethod
    def pad(arr, pad_width, mode: str = "constant",
            constant_values=0) -> INDArray:
        return INDArray(pad(as_tensor(arr), pad_width, mode,
                            constant_values))

    @staticmethod
    def max(a, b) -> INDArray:
        return INDArray(torch.maximum(*_ts([a, b])))

    @staticmethod
    def min(a, b) -> INDArray:
        return INDArray(torch.minimum(*_ts([a, b])))

    @staticmethod
    def kron(a, b) -> INDArray:
        """Kronecker product (reference: Nd4j.kron)."""
        return INDArray(torch.kron(*_ts([a, b])))

    @staticmethod
    def getCompressor():
        """Reference: Nd4j.getCompressor() -> the BasicNDArrayCompressor
        singleton (GZIP/FLOAT16/INT8/THRESHOLD/NOOP codecs)."""
        from deeplearning4j_tpu_torch.ndarray.compression import \
            BasicNDArrayCompressor

        return BasicNDArrayCompressor.getInstance()

    @staticmethod
    def argMax(arr, *dimension) -> INDArray:
        """Reference: Nd4j.argMax(arr, dims) — flat argmax with no dims;
        several dims raise rather than silently using the first."""
        if len(dimension) > 1:
            raise ValueError(
                "argMax over multiple dimensions is not supported; "
                "reshape to merge the dims first")
        return INDArray(arg_reduce(torch.argmax, as_tensor(arr),
                                   tuple(dimension) or None))

    @staticmethod
    def sortWithIndices(arr, dimension: int = -1, ascending: bool = True):
        """[indices, sorted] pair (reference: Nd4j.sortWithIndices)."""
        x = as_tensor(arr)
        idx = torch.argsort(x, dim=dimension, stable=True)
        if not ascending:
            idx = torch.flip(idx, (dimension,))
        return [INDArray(idx),
                INDArray(torch.take_along_dim(x, idx, dim=dimension))]

    @staticmethod
    def accumulate(*arrs) -> INDArray:
        """Elementwise sum of same-shaped arrays (reference:
        Nd4j.accumulate). Accepts varargs or one list."""
        if len(arrs) == 1 and isinstance(arrs[0], (list, tuple)):
            arrs = tuple(arrs[0])
        if not arrs:
            raise ValueError("accumulate needs at least one array")
        ts = _ts(arrs)
        total = ts[0]
        for t in ts[1:]:
            total = total + t
        return INDArray(total)

    @staticmethod
    def average(*arrs) -> INDArray:
        """Elementwise mean of same-shaped arrays. Accepts varargs or one
        list."""
        if len(arrs) == 1 and isinstance(arrs[0], (list, tuple)):
            arrs = tuple(arrs[0])
        if not arrs:
            raise ValueError("average needs at least one array")
        total = Nd4j.accumulate(*arrs)
        return INDArray(total.tensor() / float(len(arrs)))

    # ----- file IO (reference: Nd4j.writeNpy/readNpy, writeTxt/readTxt,
    # saveBinary/readBinary) -------------------------------------------
    @staticmethod
    def writeNpy(arr, path):
        """A standard .npy file, written through an open file object
        (np.save(str) appends ".npy" to an extension-less path)."""
        with open(str(path), "wb") as f:
            np.save(f, _host(arr), allow_pickle=False)

    @staticmethod
    def readNpy(path, device=None) -> INDArray:
        return INDArray(np.load(str(path), allow_pickle=False),
                        device=device)

    @staticmethod
    def saveBinary(arr, path):
        """Binary save (reference: Nd4j.saveBinary): the container is .npy,
        self-describing in shape and dtype."""
        Nd4j.writeNpy(arr, path)

    @staticmethod
    def readBinary(path, device=None) -> INDArray:
        return Nd4j.readNpy(path, device=device)

    @staticmethod
    def writeTxt(arr, path):
        """Text format: one "# shape: (..) dtype" header line, then the
        flattened values (the reference's own header-plus-values form)."""
        a = _host(arr)
        with open(str(path), "w", encoding="utf-8") as f:
            f.write(f"# shape: {','.join(map(str, a.shape))} "
                    f"dtype: {a.dtype.name}\n")
            flat = a.reshape(-1)
            if a.dtype.kind == "f":
                lines = (repr(float(v)) for v in flat)
            elif a.dtype.kind == "c":
                lines = (repr(complex(v)) for v in flat)
            else:
                lines = (str(v) for v in flat)
            f.write("\n".join(lines))
            f.write("\n")

    @staticmethod
    def readTxt(path, device=None) -> INDArray:
        with open(str(path), encoding="utf-8") as f:
            header = f.readline().strip()
            if not header.startswith("# shape:"):
                raise ValueError(
                    f"{path}: not an Nd4j.writeTxt file (missing header)")
            body = header[len("# shape:"):].strip()
            shape_part, _, dtype_part = body.partition("dtype:")
            shape = tuple(int(s) for s in shape_part.strip().split(",")
                          if s != "")
            dtype = np.dtype(dtype_part.strip() or "float32")
            vals = [ln.strip() for ln in f if ln.strip()]
        # parse by dtype kind: float('True') raises and float() of a big
        # int64 silently loses precision past 2**53
        if dtype.kind == "b":
            py = [v == "True" for v in vals]
        elif dtype.kind in "iu":
            py = [int(v) for v in vals]
        elif dtype.kind == "c":
            py = [complex(v) for v in vals]
        else:
            py = [float(v) for v in vals]
        return INDArray(np.asarray(py, dtype).reshape(shape), device=device)

    # ----- executioner / env (reference: Nd4j.getExecutioner()) -------
    @staticmethod
    def getExecutioner():
        from deeplearning4j_tpu_torch.ndarray.executioner import \
            TorchExecutioner

        return TorchExecutioner.instance()


def _host(arr) -> np.ndarray:
    if isinstance(arr, INDArray):
        return arr.toNumpy()
    if isinstance(arr, torch.Tensor):
        return to_numpy(arr)
    return np.asarray(arr)


_NP_MODES = ("edge", "reflect", "symmetric", "wrap")


def pad(t, pad_width, mode="constant", constant_values=0):
    """numpy's ``pad`` over a tensor: constant, edge, reflect, symmetric
    or wrap; pad_width an int, a (lo, hi) pair or one pair per axis."""
    pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64),
                         (t.ndim, 2))
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw.tolist()):
            flat += [lo, hi]
        return torch.nn.functional.pad(t, flat, value=constant_values)
    if mode not in _NP_MODES:
        raise ValueError(f"unsupported pad mode {mode!r}")
    for ax, (lo, hi) in enumerate(pw.tolist()):
        if lo or hi:
            idx = np.pad(np.arange(t.shape[ax]), (lo, hi), mode=mode)
            t = torch.index_select(t, ax,
                                   torch.as_tensor(idx, device=t.device))
    return t
