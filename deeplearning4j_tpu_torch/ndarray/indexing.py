"""NDArrayIndex — structured slicing.

The port's own copy of ``deeplearning4j_tpu/ndarray/indexing.py``
(reference: org.nd4j.linalg.indexing.NDArrayIndex: all/point/interval/
newAxis and INDArray.get/put). Indices resolve to a numpy-style index
tuple; ``INDArray.get`` reads it into a new array and ``put`` writes a
new payload, so no index gives a view another array can see.
"""

from __future__ import annotations


class _Index:
    def resolve(self, dim_size: int):
        raise NotImplementedError


class _All(_Index):
    def resolve(self, dim_size: int):
        return slice(None)

    def __repr__(self):
        return "all()"


class _Point(_Index):
    def __init__(self, i: int):
        self.i = int(i)

    def resolve(self, dim_size: int):
        return self.i if self.i >= 0 else dim_size + self.i

    def __repr__(self):
        return f"point({self.i})"


class _Interval(_Index):
    def __init__(self, begin: int, end: int, stride: int = 1, inclusive: bool = False):
        self.begin, self.end, self.stride = int(begin), int(end), int(stride)
        self.inclusive = inclusive

    def resolve(self, dim_size: int):
        end = self.end + 1 if self.inclusive else self.end
        return slice(self.begin, end, self.stride)

    def __repr__(self):
        return f"interval({self.begin},{self.end},{self.stride})"


class _NewAxis(_Index):
    def resolve(self, dim_size: int):
        return None  # numpy newaxis

    def __repr__(self):
        return "newAxis()"


class NDArrayIndex:
    @staticmethod
    def all() -> _Index:
        return _All()

    @staticmethod
    def point(i: int) -> _Index:
        return _Point(i)

    @staticmethod
    def interval(*args, inclusive: bool = False) -> _Index:
        """interval(begin, end) | interval(begin, stride, end[, inclusive]).

        The 3-argument order is (begin, STRIDE, end), matching the
        reference's NDArrayIndex.interval(long, long, long).
        """
        if len(args) == 2:
            begin, end = args
            stride = 1
        elif len(args) == 3:
            begin, stride, end = args
        elif len(args) == 4:
            begin, stride, end, inclusive = args
        else:
            raise TypeError("interval(begin, end) or interval(begin, stride, end[, inclusive])")
        return _Interval(begin, end, stride, inclusive)

    @staticmethod
    def newAxis() -> _Index:
        return _NewAxis()

    @staticmethod
    def indices(*idx) -> list:
        return [int(i) for i in idx]


def to_index_tuple(indices, shape) -> tuple:
    """Translate a mix of NDArrayIndex objects / ints / slices / lists into
    a numpy-style index tuple."""
    out = []
    dim = 0
    for ix in indices:
        if isinstance(ix, _NewAxis):
            out.append(None)
            continue
        if isinstance(ix, _Index):
            out.append(ix.resolve(shape[dim] if dim < len(shape) else 0))
        elif isinstance(ix, (int, slice, list)):
            out.append(ix)
        else:
            out.append(ix)  # arrays for fancy indexing
        dim += 1
    return tuple(out)


# Convenience aliases matching common reference imports
all_ = NDArrayIndex.all
point = NDArrayIndex.point
interval = NDArrayIndex.interval
