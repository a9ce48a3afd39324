"""INDArray — the n-dimensional array of the framework.

The counterpart of ``deeplearning4j_tpu/ndarray/ndarray.py`` (reference
surface: org.nd4j.linalg.api.ndarray.INDArray). The payload is a
``torch.Tensor`` on the card (or on the CPU where the caller asked for
it); ``tensor()`` is the accessor where the reference has ``jax()``.
Every op is one eager torch call.

Value semantics, as in the reference, where nothing aliases because JAX
buffers are immutable. The rule here: no torch op ever writes into an
``INDArray``'s payload. In-place methods (``addi``… , ``assign``,
``putScalar``, ``putRow``/``putColumn``, ``put``, ``__setitem__``,
``replaceWhere``) compute a new tensor, out of place or into a fresh
clone, and rebind the wrapper to it. So torch views may be shared freely:
``getRow``/``get``/``slice``/``__getitem__`` and ``INDArray(other)`` may
return arrays over the parent's storage, and ``a.getRow(0).addi(1)``
still leaves ``a`` as it was. numpy input is snapshotted (copied); a
tensor passed in is adopted as it is, and the caller hands it over (it
must not write into it afterwards). The tensor ``tensor()`` returns is
read-only by the same rule: clone it before an in-place op.

Bounds are checked on the host before any launch (``getDouble``,
``putScalar``, ``get``/``put`` with point or integer-array indices,
``getRows``): on the card an out-of-range advanced index is a
device-side assert that poisons the context for the rest of the
process, and the reference checks on the host too, because XLA clamps.

dtypes are kept as given: float64 input stays float64 (the reference
narrows it only when x64 is off). ``toNumpy()`` of a bf16 array is its
exact float32 widening (numpy has no bf16 here).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.dtype import DataType, resolve

__all__ = ["INDArray", "as_tensor", "to_numpy"]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bf16 widened to float32,
    exactly)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.resolve_conj().resolve_neg().cpu().numpy()


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    if a.dtype.kind == "U" or a.dtype == object:
        raise TypeError(f"INDArray cannot hold {a.dtype} data")
    # ascontiguousarray makes a 0-d array 1-d: keep the scalar's shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(
        a.shape).to(device)


def as_tensor(x, device=None) -> torch.Tensor:
    """An INDArray's payload, a tensor as it is, or array-like data as a
    new tensor on `device` (resolved: the card unless asked otherwise)."""
    if isinstance(x, INDArray):
        return x._t if device is None else x._t.to(device)
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return _from_numpy(x, resolve_device(device))


def _operand(x, like: torch.Tensor):
    """The other operand of a binary op: INDArray/tensor payloads, python
    scalars as they are (torch's weak typing, like JAX's), array-like
    data as a tensor on `like`'s device."""
    if isinstance(x, INDArray):
        return x._t
    if isinstance(x, (torch.Tensor, bool, int, float, complex)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    return _from_numpy(x, like.device)


def _unwrap(x):
    return x._t if isinstance(x, INDArray) else x


def _dims(dimension) -> tuple[int, ...] | None:
    """Normalise the reference's `int... dimension` varargs."""
    if len(dimension) == 0:
        return None
    if len(dimension) == 1 and isinstance(dimension[0], (tuple, list)):
        return tuple(dimension[0])
    return tuple(int(d) for d in dimension)


def _all_dims(t, axes):
    return tuple(range(t.ndim)) if axes is None else axes


def _promote(a, b):
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _check_int(i, n, what):
    if not -n <= i < n:
        raise IndexError(f"index {i} out of bounds for {what} with size {n}")


def _check_index_tuple(tup, shape, device):
    """Check a numpy-style index tuple against `shape` on the host and
    return it in a form torch takes: integer arrays and lists as long
    tensors on `device`, a negative-step slice as the index array it
    selects. Raises IndexError for any integer out of range."""
    out = []
    n_dims = sum(1 for ix in tup if ix is not None and ix is not Ellipsis
                 and not (isinstance(ix, torch.Tensor)
                          and ix.dtype == torch.bool))
    n_dims += sum(ix.ndim - 1 for ix in tup
                  if isinstance(ix, torch.Tensor) and ix.dtype == torch.bool)
    dim = 0
    for ix in tup:
        if ix is None:
            out.append(None)
            continue
        if ix is Ellipsis:
            out.append(Ellipsis)
            dim += len(shape) - n_dims
            continue
        if dim >= len(shape):
            raise IndexError(f"too many indices for an array of rank "
                             f"{len(shape)}")
        n = shape[dim]
        if isinstance(ix, (bool, np.bool_)):
            raise IndexError("a bare bool is not an index")
        if isinstance(ix, (int, np.integer)):
            _check_int(int(ix), n, f"axis {dim}")
            out.append(int(ix))
            dim += 1
            continue
        if isinstance(ix, slice):
            if ix.step is not None and ix.step < 0:
                ix = torch.arange(n, device=device)[
                    list(range(*ix.indices(n)))] if n else \
                    torch.zeros(0, dtype=torch.long, device=device)
            else:
                out.append(ix)
                dim += 1
                continue
        if not isinstance(ix, torch.Tensor):
            ix = torch.as_tensor(np.asarray(ix), device=device)
        else:
            ix = ix.to(device)
        if ix.dtype == torch.bool:
            want = tuple(shape[dim:dim + ix.ndim])
            if tuple(ix.shape) != want:
                raise IndexError(f"boolean index of shape {tuple(ix.shape)} "
                                 f"does not match axes of shape {want}")
            out.append(ix)
            dim += ix.ndim
            continue
        if ix.is_floating_point():
            raise IndexError("arrays used as indices must be of integer type")
        ix = ix.long()
        if ix.numel():
            lo, hi = int(ix.min()), int(ix.max())
            if lo < -n or hi >= n:
                raise IndexError(
                    f"index {hi if hi >= n else lo} out of bounds for axis "
                    f"{dim} with size {n}")
        out.append(ix)
        dim += 1
    return tuple(out)


class INDArray:
    """N-dimensional array over a torch tensor."""

    __slots__ = ("_t",)
    # let INDArray win in  np_array + indarray  style expressions
    __array_priority__ = 100

    def __init__(self, data, device=None):
        """``INDArray(other)`` shares ``other``'s payload; a tensor is
        adopted; anything else (numpy, lists, scalars) is copied onto
        `device` (the card unless the caller asks for the CPU)."""
        if isinstance(data, INDArray):
            t = data._t
        elif isinstance(data, torch.Tensor):
            t = data
        else:
            t = _from_numpy(data, resolve_device(device))
            device = None
        if device is not None:
            t = t.to(resolve_device(device))
        self._t = t

    # ----- structure -------------------------------------------------
    def shape(self) -> tuple[int, ...]:
        return tuple(self._t.shape)

    def rank(self) -> int:
        return self._t.ndim

    def length(self) -> int:
        return int(self._t.numel())

    def size(self, dimension: int) -> int:
        return int(self._t.shape[dimension])

    def rows(self) -> int:
        return self.size(0)

    def columns(self) -> int:
        return self.size(1)

    def dataType(self) -> DataType:
        return DataType.from_dtype(self._t.dtype)

    @property
    def device(self) -> torch.device:
        return self._t.device

    def isScalar(self) -> bool:
        return self._t.ndim == 0 or self._t.numel() == 1

    def isVector(self) -> bool:
        return self._t.ndim == 1 or (self._t.ndim == 2
                                     and 1 in self._t.shape)

    def isRowVector(self) -> bool:
        return self._t.ndim == 1 or (self._t.ndim == 2
                                     and self._t.shape[0] == 1)

    def isColumnVector(self) -> bool:
        return self._t.ndim == 2 and self._t.shape[1] == 1

    def isMatrix(self) -> bool:
        return self._t.ndim == 2

    def isEmpty(self) -> bool:
        return self._t.numel() == 0

    def ordering(self) -> str:
        return "c"

    # ----- conversion ------------------------------------------------
    def toNumpy(self) -> np.ndarray:
        return to_numpy(self._t)

    def tensor(self) -> torch.Tensor:
        """The payload (read-only by the value-semantics rule)."""
        return self._t

    def distribute(self, mesh, row_axis="data", col_axis=None):
        """-> ``linalg.DistributedMatrix`` of this 2-D array over `mesh`:
        this rank's block of it, on this array's device (rows over
        `row_axis`, columns over `col_axis`; never padded)."""
        from deeplearning4j_tpu_torch.linalg import DistributedMatrix

        return DistributedMatrix(self._t, mesh, row_axis=row_axis,
                                 col_axis=col_axis)

    def castTo(self, dtype) -> "INDArray":
        return INDArray(self._t.to(resolve(dtype)))

    def dup(self) -> "INDArray":
        return INDArray(self._t.clone())

    def detach(self) -> "INDArray":
        return INDArray(self._t.detach())

    def assign(self, other) -> "INDArray":
        o = _operand(other, self._t)
        o = torch.as_tensor(o, dtype=self._t.dtype, device=self._t.device)
        self._t = o.expand(self._t.shape).clone()
        return self

    # ----- scalar access ---------------------------------------------
    def _checked_index(self, indices) -> tuple:
        idx = tuple(int(i) for i in indices)
        if len(idx) > self._t.ndim:
            raise IndexError(f"index {idx} out of bounds for shape "
                             f"{self.shape()}")
        for i, n in zip(idx, self._t.shape):
            if not -n <= i < n:
                raise IndexError(f"index {idx} out of bounds for shape "
                                 f"{self.shape()}")
        return idx

    def _checked_flat_index(self, i: int) -> int:
        i = int(i)
        n = self._t.numel()
        if not -n <= i < n:
            raise IndexError(f"linear index {i} out of bounds for length {n}")
        return i

    def _element(self, indices) -> torch.Tensor:
        """One element; a single index into a non-1d array is linear into
        the flattened array (the reference's getDouble(long))."""
        if not indices:
            if self._t.numel() == 0:
                raise IndexError("empty array has no element")
            return self._t.reshape(-1)[0]
        if len(indices) == 1 and self._t.ndim != 1:
            return self._t.reshape(-1)[self._checked_flat_index(indices[0])]
        return self._t[self._checked_index(indices)]

    def getScalar(self, *indices) -> "INDArray":
        return INDArray(self._element(indices))

    def getDouble(self, *indices) -> float:
        return float(self._element(indices).item())

    def getFloat(self, *indices) -> float:
        return self.getDouble(*indices)

    def getInt(self, *indices) -> int:
        return int(self._element(indices).item())

    def putScalar(self, *args) -> "INDArray":
        *indices, value = args
        if len(indices) == 1 and isinstance(indices[0], (tuple, list)):
            indices = list(indices[0])
        t = self._t.clone(memory_format=torch.contiguous_format)
        if len(indices) == 1 and t.ndim > 1:
            t.view(-1)[self._checked_flat_index(indices[0])] = value
        else:
            t[self._checked_index(indices)] = value
        self._t = t
        return self

    # ----- elementwise arithmetic ------------------------------------
    def _binary(self, other, fn) -> "INDArray":
        return INDArray(fn(self._t, _operand(other, self._t)))

    def add(self, other) -> "INDArray":
        return self._binary(other, torch.add)

    def sub(self, other) -> "INDArray":
        return self._binary(other, torch.sub)

    def mul(self, other) -> "INDArray":
        return self._binary(other, torch.mul)

    def div(self, other) -> "INDArray":
        return self._binary(other, torch.true_divide)

    def rsub(self, other) -> "INDArray":
        return INDArray(_operand(other, self._t) - self._t)

    def rdiv(self, other) -> "INDArray":
        return INDArray(_operand(other, self._t) / self._t)

    def addi(self, other) -> "INDArray":
        self._t = self.add(other)._t
        return self

    def subi(self, other) -> "INDArray":
        self._t = self.sub(other)._t
        return self

    def muli(self, other) -> "INDArray":
        self._t = self.mul(other)._t
        return self

    def divi(self, other) -> "INDArray":
        self._t = self.div(other)._t
        return self

    def rsubi(self, other) -> "INDArray":
        self._t = self.rsub(other)._t
        return self

    def rdivi(self, other) -> "INDArray":
        self._t = self.rdiv(other)._t
        return self

    def neg(self) -> "INDArray":
        return INDArray(torch.neg(self._t))

    def negi(self) -> "INDArray":
        self._t = torch.neg(self._t)
        return self

    def fmod(self, other) -> "INDArray":
        return self._binary(other, torch.fmod)

    __add__ = add
    __radd__ = add
    __sub__ = sub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rsub__ = rsub
    __rtruediv__ = rdiv
    __neg__ = neg

    def __matmul__(self, other) -> "INDArray":
        return self.mmul(other)

    def __pow__(self, p) -> "INDArray":
        return INDArray(torch.pow(self._t, _operand(p, self._t)))

    # ----- comparison (BOOL results) ---------------------------------
    def eq(self, other) -> "INDArray":
        return self._binary(other, torch.eq)

    def neq(self, other) -> "INDArray":
        return self._binary(other, torch.ne)

    def gt(self, other) -> "INDArray":
        return self._binary(other, torch.gt)

    def gte(self, other) -> "INDArray":
        return self._binary(other, torch.ge)

    def lt(self, other) -> "INDArray":
        return self._binary(other, torch.lt)

    def lte(self, other) -> "INDArray":
        return self._binary(other, torch.le)

    __eq__ = eq
    __ne__ = neq
    __gt__ = gt
    __ge__ = gte
    __lt__ = lt
    __le__ = lte
    __hash__ = None

    def equals(self, other) -> bool:
        """Value equality (reference INDArray.equals: shape + values
        within 1e-5)."""
        o = _operand(other, self._t)
        o = torch.as_tensor(o, device=self._t.device)
        if tuple(o.shape) != self.shape():
            return False
        a, b = self._t, o
        if not (a.is_floating_point() or a.is_complex()):
            a = a.double()
        if not (b.is_floating_point() or b.is_complex()):
            b = b.double()
        a, b = _promote(a, b)
        return bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))

    # ----- linear algebra --------------------------------------------
    def mmul(self, other) -> "INDArray":
        a, b = _promote(self._t, as_tensor(other, self._t.device))
        return INDArray(torch.matmul(a, b))

    def tensorMmul(self, other, axes) -> "INDArray":
        a, b = _promote(self._t, as_tensor(other, self._t.device))
        if not isinstance(axes, int):
            axes = [list(axes[0]) if isinstance(axes[0], (list, tuple))
                    else [axes[0]],
                    list(axes[1]) if isinstance(axes[1], (list, tuple))
                    else [axes[1]]]
        return INDArray(torch.tensordot(a, b, dims=axes))

    def transpose(self) -> "INDArray":
        return INDArray(self._t.permute(*reversed(range(self._t.ndim))))

    def permute(self, *order) -> "INDArray":
        return INDArray(self._t.permute(*_dims(order)))

    def swapAxes(self, a: int, b: int) -> "INDArray":
        return INDArray(torch.transpose(self._t, a, b))

    # ----- shape ops --------------------------------------------------
    def reshape(self, *shape) -> "INDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return INDArray(self._t.reshape(shape))

    def ravel(self) -> "INDArray":
        return INDArray(self._t.reshape(-1))

    def flatten(self) -> "INDArray":
        return self.ravel()

    def broadcast(self, *shape) -> "INDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return INDArray(torch.broadcast_to(self._t, shape))

    def repeat(self, dimension: int, repeats: int) -> "INDArray":
        return INDArray(torch.repeat_interleave(self._t, repeats,
                                                dim=dimension))

    def squeeze(self, axis=None) -> "INDArray":
        if axis is None:
            return INDArray(self._t.squeeze())
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        for a in axes:
            if self._t.shape[a] != 1:
                raise ValueError(f"cannot squeeze axis {a} of size "
                                 f"{self._t.shape[a]}")
        return INDArray(self._t.squeeze(axes))

    def expandDims(self, axis: int) -> "INDArray":
        return INDArray(self._t.unsqueeze(axis))

    # ----- reductions -------------------------------------------------
    def _float(self):
        t = self._t
        return t if (t.is_floating_point() or t.is_complex()) \
            else t.to(torch.get_default_dtype())

    def sum(self, *dimension, keepDims: bool = False) -> "INDArray":
        axes = _dims(dimension)
        return INDArray(torch.sum(self._t, dim=axes, keepdim=keepDims))

    def mean(self, *dimension, keepDims: bool = False) -> "INDArray":
        axes = _dims(dimension)
        return INDArray(torch.mean(self._float(), dim=axes,
                                   keepdim=keepDims))

    def prod(self, *dimension, keepDims: bool = False) -> "INDArray":
        return INDArray(reduce_prod(self._t, _dims(dimension), keepDims))

    def max(self, *dimension, keepDims: bool = False) -> "INDArray":
        axes = _all_dims(self._t, _dims(dimension))
        return INDArray(torch.amax(self._t, dim=axes, keepdim=keepDims))

    def min(self, *dimension, keepDims: bool = False) -> "INDArray":
        axes = _all_dims(self._t, _dims(dimension))
        return INDArray(torch.amin(self._t, dim=axes, keepdim=keepDims))

    def std(self, *dimension, biasCorrected: bool = True,
            keepDims: bool = False) -> "INDArray":
        # the reference's default is the bias-corrected sample std (n-1)
        return INDArray(torch.std(self._float(), dim=_dims(dimension),
                                  correction=1 if biasCorrected else 0,
                                  keepdim=keepDims))

    def var(self, *dimension, biasCorrected: bool = True,
            keepDims: bool = False) -> "INDArray":
        return INDArray(torch.var(self._float(), dim=_dims(dimension),
                                  correction=1 if biasCorrected else 0,
                                  keepdim=keepDims))

    def norm1(self, *dimension, keepDims: bool = False) -> "INDArray":
        return INDArray(torch.sum(torch.abs(self._t), dim=_dims(dimension),
                                  keepdim=keepDims))

    def norm2(self, *dimension, keepDims: bool = False) -> "INDArray":
        return INDArray(torch.sqrt(torch.sum(
            torch.square(self._float()), dim=_dims(dimension),
            keepdim=keepDims)))

    def normmax(self, *dimension, keepDims: bool = False) -> "INDArray":
        axes = _all_dims(self._t, _dims(dimension))
        return INDArray(torch.amax(torch.abs(self._t), dim=axes,
                                   keepdim=keepDims))

    def _arg_reduce(self, fn, dimension) -> "INDArray":
        return INDArray(arg_reduce(fn, self._t, _dims(dimension)))

    def argMax(self, *dimension) -> "INDArray":
        return self._arg_reduce(torch.argmax, dimension)

    def argMin(self, *dimension) -> "INDArray":
        return self._arg_reduce(torch.argmin, dimension)

    def cumsum(self, dimension: int = 0) -> "INDArray":
        return INDArray(torch.cumsum(self._t, dim=dimension))

    def cumprod(self, dimension: int = 0) -> "INDArray":
        return INDArray(torch.cumprod(self._t, dim=dimension))

    def sumNumber(self) -> float:
        return float(torch.sum(self._t).item())

    def meanNumber(self) -> float:
        return float(torch.mean(self._float()).item())

    def maxNumber(self) -> float:
        return float(torch.max(self._t).item())

    def minNumber(self) -> float:
        return float(torch.min(self._t).item())

    def scan(self, condition) -> int:
        """Count of elements matching a boolean condition function (of
        the payload tensor)."""
        return int(torch.sum(condition(self._t)).item())

    # ----- row/column vector broadcast ops ---------------------------
    def _row_op(self, vec, fn) -> "INDArray":
        v = as_tensor(vec, self._t.device).reshape(1, -1)
        return INDArray(fn(self._t, v))

    def _col_op(self, vec, fn) -> "INDArray":
        v = as_tensor(vec, self._t.device).reshape(-1, 1)
        return INDArray(fn(self._t, v))

    def addRowVector(self, v) -> "INDArray":
        return self._row_op(v, torch.add)

    def subRowVector(self, v) -> "INDArray":
        return self._row_op(v, torch.sub)

    def mulRowVector(self, v) -> "INDArray":
        return self._row_op(v, torch.mul)

    def divRowVector(self, v) -> "INDArray":
        return self._row_op(v, torch.true_divide)

    def addColumnVector(self, v) -> "INDArray":
        return self._col_op(v, torch.add)

    def subColumnVector(self, v) -> "INDArray":
        return self._col_op(v, torch.sub)

    def mulColumnVector(self, v) -> "INDArray":
        return self._col_op(v, torch.mul)

    def divColumnVector(self, v) -> "INDArray":
        return self._col_op(v, torch.true_divide)

    def addiRowVector(self, v) -> "INDArray":
        self._t = self._row_op(v, torch.add)._t
        return self

    def muliRowVector(self, v) -> "INDArray":
        self._t = self._row_op(v, torch.mul)._t
        return self

    def addiColumnVector(self, v) -> "INDArray":
        self._t = self._col_op(v, torch.add)._t
        return self

    def muliColumnVector(self, v) -> "INDArray":
        self._t = self._col_op(v, torch.mul)._t
        return self

    # ----- rows / columns / slices -----------------------------------
    def getRow(self, i: int) -> "INDArray":
        return self[int(i)]

    def getColumn(self, i: int) -> "INDArray":
        return self[:, int(i)]

    def getRows(self, *rows) -> "INDArray":
        return self[list(_dims(rows))]

    def getColumns(self, *cols) -> "INDArray":
        return self[:, list(_dims(cols))]

    def putRow(self, i: int, row) -> "INDArray":
        self[int(i)] = row
        return self

    def putColumn(self, i: int, col) -> "INDArray":
        self[:, int(i)] = as_tensor(col, self._t.device).reshape(-1)
        return self

    def slice(self, i: int, dimension: int = 0) -> "INDArray":
        dimension %= max(self._t.ndim, 1)
        _check_int(int(i), self._t.shape[dimension], f"axis {dimension}")
        return INDArray(torch.select(self._t, dimension, int(i)))

    def tensorAlongDimension(self, index: int, *dimension) -> "INDArray":
        dims = _dims(dimension)
        other = [d for d in range(self._t.ndim) if d not in dims]
        moved = torch.movedim(self._t, other, list(range(len(other))))
        flat = moved.reshape((-1,) + tuple(moved.shape[len(other):]))
        _check_int(int(index), flat.shape[0], "tensorAlongDimension")
        return INDArray(flat[int(index)])

    # ----- fancy get/put (NDArrayIndex protocol) ----------------------
    def get(self, *indices) -> "INDArray":
        from deeplearning4j_tpu_torch.ndarray.indexing import to_index_tuple

        return self[to_index_tuple(indices, self.shape())]

    def put(self, indices, value) -> "INDArray":
        from deeplearning4j_tpu_torch.ndarray.indexing import to_index_tuple

        if not isinstance(indices, (tuple, list)):
            indices = (indices,)
        self[to_index_tuple(tuple(indices), self.shape())] = value
        return self

    def getWhere(self, comp, condition) -> "INDArray":
        mask = condition(self._t, _operand(comp, self._t))
        return INDArray(self._t[mask])

    def replaceWhere(self, replacement, mask) -> "INDArray":
        m = as_tensor(mask, self._t.device).bool()
        self._t = torch.where(m, _operand(replacement, self._t), self._t)
        return self

    def _index(self, item):
        if not isinstance(item, tuple):
            item = (item,)
        return _check_index_tuple(tuple(_unwrap(i) for i in item),
                                  tuple(self._t.shape), self._t.device)

    def __getitem__(self, item) -> "INDArray":
        return INDArray(self._t[self._index(item)])

    def __setitem__(self, item, value) -> None:
        idx = self._index(item)
        v = _operand(value, self._t)
        t = self._t.clone()
        t[idx] = v
        self._t = t

    def __len__(self) -> int:
        return self._t.shape[0]

    def __iter__(self):
        for i in range(self._t.shape[0]):
            yield INDArray(self._t[i])

    def __float__(self) -> float:
        return float(self._t.item())

    def __int__(self) -> int:
        return int(self._t.item())

    def __repr__(self) -> str:
        return (f"INDArray{self.shape()}{str(self._t.dtype)[6:]}\n"
                f"{self.toNumpy()}")

    def __array__(self, dtype=None, copy=None):
        a = self.toNumpy()
        return a.astype(dtype) if dtype is not None else a


def reduce_prod(t, axes, keepdim=False):
    """``torch.prod`` over several axes (it takes one)."""
    if axes is None:
        r = torch.prod(t)
        return r.reshape([1] * t.ndim) if keepdim else r
    for a in sorted((a % t.ndim for a in axes), reverse=True):
        t = torch.prod(t, dim=a, keepdim=keepdim)
    return t


def arg_reduce(fn, t, axes):
    """argmax/argmin over no axis (flat), one axis, or several: several
    are collapsed into one trailing axis and the result is a linear index
    within them (the reference's argMax(int...))."""
    if axes is None or len(axes) == 1:
        return fn(t, dim=None if axes is None else axes[0])
    axes = tuple(a % t.ndim for a in axes)
    keep = [d for d in range(t.ndim) if d not in axes]
    moved = t.permute(*(keep + list(axes)))
    flat = moved.reshape(tuple(t.shape[d] for d in keep) + (-1,))
    return fn(flat, dim=-1)
