"""Property-based checks of the port's INDArray against the reference's
(hypothesis), on the CPU.

Mirrors tests/test_ndarray_properties.py property by property; each
drawn input goes through the reference's INDArray and the port's and
the answers are compared (float32 inputs: tests/conftest.py turns x64
on). Tolerances: round trips, reshapes, get/put and comparisons
exactly; elementwise arithmetic within rtol 1e-6; sums and matrix
products, whose order of accumulation differs, within rtol 1e-5 and an
atol scaled by the inputs' magnitude. Out-of-bounds reads and writes
raise IndexError in both.
"""

import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed in this container; the "
           "deterministic oracle suite in test_torch_ndarray.py carries "
           "the coverage")

from hypothesis import given, settings, strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from deeplearning4j_tpu.ndarray import INDArray as JArray  # noqa: E402
from deeplearning4j_tpu_torch.ndarray import INDArray as PArray  # noqa: E402

torch.set_num_threads(2)
SETTINGS = dict(max_examples=25, deadline=None, derandomize=True)

shapes = hnp.array_shapes(min_dims=1, max_dims=4, min_side=1, max_side=5)
floats = hnp.arrays(np.float32, shapes,
                    elements=st.floats(-100, 100, width=32))


def both(a):
    return JArray(a), PArray(a, device="cpu")


@given(a=floats)
@settings(**SETTINGS)
def test_roundtrip(a):
    j, p = both(a)
    np.testing.assert_array_equal(p.toNumpy(), a)
    np.testing.assert_array_equal(p.toNumpy(), j.toNumpy())
    assert p.shape() == j.shape() and p.dataType().name == j.dataType().name


@given(a=floats, b=st.floats(-10, 10, width=32))
@settings(**SETTINGS)
def test_scalar_arithmetic(a, b):
    j, p = both(a)
    for f in (lambda x: x.add(b), lambda x: x.mul(b), lambda x: x.sub(b),
              lambda x: x.rsub(b)):
        np.testing.assert_allclose(f(p).toNumpy(), f(j).toNumpy(),
                                   rtol=1e-6, atol=1e-6)


@given(a=floats)
@settings(**SETTINGS)
def test_elementwise_pair(a):
    j, p = both(a)
    jy, py = both(a * 0.5 + 1.0)
    np.testing.assert_array_equal(p.sub(py).toNumpy(), j.sub(jy).toNumpy())
    np.testing.assert_array_equal(p.gt(py).toNumpy(), j.gt(jy).toNumpy())
    np.testing.assert_allclose(p.mul(py).toNumpy(), j.mul(jy).toNumpy(),
                               rtol=1e-6, atol=1e-6)


@given(a=floats, data=st.data())
@settings(**SETTINGS)
def test_reduction_over_random_axis(a, data):
    axis = data.draw(st.integers(-a.ndim, a.ndim - 1))
    j, p = both(a)
    np.testing.assert_allclose(p.sum(axis).toNumpy(), j.sum(axis).toNumpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(p.max(axis).toNumpy(),
                                  j.max(axis).toNumpy())
    np.testing.assert_array_equal(p.argMax(axis).toNumpy(),
                                  j.argMax(axis).toNumpy())


@given(a=floats)
@settings(**SETTINGS)
def test_reshape_transpose_roundtrip(a):
    j, p = both(a)
    flat = p.reshape(-1)
    assert flat.shape() == j.reshape(-1).shape() == (a.size,)
    back = flat.reshape(*a.shape)
    np.testing.assert_array_equal(back.toNumpy(), a)
    np.testing.assert_array_equal(p.transpose().toNumpy(),
                                  j.transpose().toNumpy())


@given(n=st.integers(1, 5), k=st.integers(1, 5), m=st.integers(1, 5),
       data=st.data())
@settings(**SETTINGS)
def test_mmul_matches_reference(n, k, m, data):
    el = st.floats(-10, 10, width=32)
    a = data.draw(hnp.arrays(np.float32, (n, k), elements=el))
    b = data.draw(hnp.arrays(np.float32, (k, m), elements=el))
    (ja, pa), (jb, pb) = both(a), both(b)
    np.testing.assert_allclose(pa.mmul(pb).toNumpy(),
                               ja.mmul(jb).toNumpy(), rtol=1e-5, atol=1e-4)


@given(a=floats, data=st.data())
@settings(**SETTINGS)
def test_scalar_get_put_roundtrip(a, data):
    idx = tuple(data.draw(st.integers(0, s - 1)) for s in a.shape)
    j, p = both(a.copy())
    assert p.getDouble(*idx) == j.getDouble(*idx)
    p.putScalar(*idx, 42.0)
    j.putScalar(*idx, 42.0)
    np.testing.assert_array_equal(p.toNumpy(), j.toNumpy())
    assert p.getDouble(*idx) == pytest.approx(42.0)


@given(a=floats, data=st.data())
@settings(**SETTINGS)
def test_out_of_bounds_always_raises(a, data):
    j, p = both(a)
    idx = [0 for _ in a.shape]
    ax = data.draw(st.integers(0, a.ndim - 1))
    idx[ax] = a.shape[ax]  # one past the end
    for x in (j, p):
        with pytest.raises(IndexError):
            x.getDouble(*idx)
        with pytest.raises(IndexError):
            x.putScalar(*idx, 1.0)
    np.testing.assert_array_equal(p.toNumpy(), a)
