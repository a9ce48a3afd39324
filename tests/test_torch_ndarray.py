"""The port's array layer against the reference's (deeplearning4j_tpu_torch.
ndarray vs deeplearning4j_tpu.ndarray), on the CPU.

Mirrors tests/test_ndarray.py case by case: the same numpy inputs (made
from a seed, as explicit float32: tests/conftest.py turns x64 on) go
through the reference's Nd4j/INDArray and the port's, and the answers
are compared. Tolerances: integer, bool and indexing results exactly;
float32 arithmetic, reductions and transforms within rtol 1e-6 (atol
1e-7 for values near 0, where a relative bound says nothing). Beyond
the mirror: value semantics (nothing aliases: getRow/INDArray(other)
and their in-place forms leave the parent as it was), host-side
IndexError, the dtype rules of create, multi-axis argMax, the bf16
toNumpy policy (float32) and im2col/col2im against the reference's.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ndarray as J
from deeplearning4j_tpu.ndarray.convolution import col2im as j_col2im
from deeplearning4j_tpu.ndarray.convolution import im2col as j_im2col
import deeplearning4j_tpu_torch.ndarray as P
from deeplearning4j_tpu_torch.ndarray.convolution import col2im as p_col2im
from deeplearning4j_tpu_torch.ndarray.convolution import im2col as p_im2col

torch.set_num_threads(2)
CPU = "cpu"
RTOL, ATOL = 1e-6, 1e-7


def rng(seed=0):
    return np.random.RandomState(seed)


def both(x, **kw):
    """(reference INDArray, port INDArray) of the same numpy data."""
    return J.Nd4j.create(x, **kw), P.Nd4j.create(x, device=CPU, **kw)


def same(j, p, exact=False):
    """The reference's and the port's answers agree (INDArray or
    number); exactly for integer/bool results or when `exact`."""
    jv = j.toNumpy() if hasattr(j, "toNumpy") else np.asarray(j)
    pv = p.toNumpy() if hasattr(p, "toNumpy") else np.asarray(p)
    assert jv.shape == pv.shape, (jv.shape, pv.shape)
    if exact or jv.dtype.kind in "biu":
        np.testing.assert_array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


M = rng(0).randn(3, 4).astype(np.float32)
N = rng(1).randn(3, 4).astype(np.float32)
POS = (np.abs(rng(2).randn(3, 4)) + 0.1).astype(np.float32)
T3 = rng(3).randn(2, 3, 4).astype(np.float32)


# ----------------------------------------------------------------------
# creation and its dtype rules
# ----------------------------------------------------------------------

class TestCreation:
    def test_zeros_ones(self):
        same(J.Nd4j.zeros(2, 3), P.Nd4j.zeros(2, 3, device=CPU))
        o = P.Nd4j.ones(4, device=CPU)
        assert o.sumNumber() == 4.0 and o.dataType() == P.DataType.FLOAT
        assert J.Nd4j.ones(4).dataType().name == o.dataType().name

    @pytest.mark.parametrize("data,dtype", [
        ([[1.0, 2.0], [3.0, 4.0]], None),        # float -> FLOAT
        (np.arange(6.0).reshape(2, 3), None),    # float64 -> FLOAT
        (np.arange(6).reshape(2, 3), None),      # ints keep theirs
        (np.array([True, False]), None),         # bool keeps bool
        ([1.5, 2.5], "DOUBLE"),
        (np.arange(4), "FLOAT"),
        ([1.9, -2.1], "INT32"),
    ])
    def test_create_dtype_rules(self, data, dtype):
        j, p = both(data, dtype=dtype)
        assert p.dataType().name == j.dataType().name, (
            p.dataType(), j.dataType())
        same(j, p, exact=True)

    def test_create_shape_varargs_and_shape_kw(self):
        same(J.Nd4j.create(3, 4), P.Nd4j.create(3, 4, device=CPU))
        same(J.Nd4j.create([1.0, 2.0, 3.0, 4.0], (2, 2)),
             P.Nd4j.create([1.0, 2.0, 3.0, 4.0], (2, 2), device=CPU))

    def test_linspace_arange_eye(self):
        same(J.Nd4j.linspace(0, 1, 5), P.Nd4j.linspace(0, 1, 5, device=CPU))
        same(J.Nd4j.arange(5), P.Nd4j.arange(5, device=CPU), exact=True)
        same(J.Nd4j.arange(2, 9, 3), P.Nd4j.arange(2, 9, 3, device=CPU),
             exact=True)
        same(J.Nd4j.eye(3), P.Nd4j.eye(3, device=CPU), exact=True)

    def test_value_array_scalar_empty(self):
        same(J.Nd4j.valueArrayOf((2, 2), 7.0),
             P.Nd4j.valueArrayOf((2, 2), 7.0, device=CPU), exact=True)
        js, ps = J.Nd4j.scalar(3.0), P.Nd4j.scalar(3.0, device=CPU)
        assert float(ps) == float(js) == 3.0
        assert P.Nd4j.scalar(True, device=CPU).dataType() == P.DataType.BOOL
        assert P.Nd4j.empty(device=CPU).isEmpty()

    def test_factories_need_a_device_here(self):
        # the card unless the caller asks for the CPU: none here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.Nd4j.zeros(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.INDArray(np.zeros(2))

    def test_rand_reproducible_and_in_range(self):
        P.Nd4j.getRandom().setSeed(42)
        a = P.Nd4j.rand(3, 3, device=CPU)
        P.Nd4j.getRandom().setSeed(42)
        b = P.Nd4j.rand(3, 3, device=CPU)
        assert a.equals(b)
        assert 0.0 <= a.minNumber() and a.maxNumber() < 1.0
        same(P.Nd4j.randn(5, seed=7, device=CPU),
             P.Nd4j.randn(5, seed=7, device=CPU), exact=True)


# ----------------------------------------------------------------------
# arithmetic and its in-place forms
# ----------------------------------------------------------------------

BINARY = {
    "add": lambda a, b: a.add(b), "sub": lambda a, b: a.sub(b),
    "mul": lambda a, b: a.mul(b), "div": lambda a, b: a.div(b),
    "rsub": lambda a, b: a.rsub(b), "rdiv": lambda a, b: a.rdiv(b),
    "fmod": lambda a, b: a.fmod(b), "op+": lambda a, b: a + b,
    "op-": lambda a, b: a - b, "op*": lambda a, b: a * b,
    "op/": lambda a, b: a / b, "pow": lambda a, b: abs_(a) ** b,
    "mmul_T": lambda a, b: a.mmul(b.transpose()),
    "eq": lambda a, b: a.eq(b), "neq": lambda a, b: a.neq(b),
    "gt": lambda a, b: a.gt(b), "gte": lambda a, b: a.gte(b),
    "lt": lambda a, b: a.lt(b), "lte": lambda a, b: a.lte(b),
}


def abs_(a):
    return a.mul(a.gt(0.0).castTo("FLOAT").mul(2.0).sub(1.0))


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_arrays(name):
    (ja, pa), (jb, pb) = both(M), both(POS)
    same(BINARY[name](ja, jb), BINARY[name](pa, pb))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "div", "rsub",
                                  "rdiv", "fmod", "gt", "eq"])
def test_binary_scalar(name):
    ja, pa = both(M)
    same(BINARY[name](ja, 1.5), BINARY[name](pa, 1.5))


@pytest.mark.parametrize("name", ["addi", "subi", "muli", "divi", "rsubi",
                                  "rdivi"])
def test_inplace_rebinds_and_matches(name):
    (ja, pa), (jb, pb) = both(M), both(POS)
    r = getattr(pa, name)(pb)
    assert r is pa
    same(getattr(ja, name)(jb), pa)
    pa.negi()
    same(ja.negi(), pa)


def test_row_col_vector_ops():
    ja, pa = both(M)
    (jr, pr), (jc, pc) = both(POS[0]), both(POS[:, 0])
    for n in ("addRowVector", "subRowVector", "mulRowVector",
              "divRowVector"):
        same(getattr(ja, n)(jr), getattr(pa, n)(pr))
    for n in ("addColumnVector", "subColumnVector", "mulColumnVector",
              "divColumnVector"):
        same(getattr(ja, n)(jc), getattr(pa, n)(pc))
    for n, v in (("addiRowVector", (jr, pr)), ("muliRowVector", (jr, pr)),
                 ("addiColumnVector", (jc, pc)),
                 ("muliColumnVector", (jc, pc))):
        same(getattr(ja, n)(v[0]), getattr(pa, n)(v[1]))


def test_equals_and_assign():
    ja, pa = both(M)
    assert pa.equals(P.Nd4j.create(M + 1e-7, device=CPU))
    assert not pa.equals(P.Nd4j.create(M + 1e-3, device=CPU))
    assert not pa.equals(P.Nd4j.create(M[:2], device=CPU))
    same(ja.assign(2.5), pa.assign(2.5), exact=True)
    assert pa.dataType() == P.DataType.FLOAT


# ----------------------------------------------------------------------
# reductions, including multi-axis argMax
# ----------------------------------------------------------------------

REDUCE = ["sum", "mean", "prod", "max", "min", "std", "var", "norm1",
          "norm2", "normmax"]


@pytest.mark.parametrize("name", REDUCE)
@pytest.mark.parametrize("dims", [(), (0,), (1,), (-1,), (0, 2)])
def test_reductions(name, dims):
    ja, pa = both(T3)
    same(getattr(ja, name)(*dims), getattr(pa, name)(*dims))
    same(getattr(ja, name)(*dims, keepDims=True),
         getattr(pa, name)(*dims, keepDims=True))


def test_std_var_bias_corrected():
    ja, pa = both(M)
    same(ja.std(biasCorrected=False), pa.std(biasCorrected=False))
    same(ja.var(1, biasCorrected=False), pa.var(1, biasCorrected=False))
    assert float(pa.std()) == pytest.approx(float(M.std(ddof=1)), rel=1e-6)


@pytest.mark.parametrize("dims", [(), (0,), (2,), (0, 2), (1, 2), (2, 0)])
@pytest.mark.parametrize("name", ["argMax", "argMin"])
def test_arg_reductions_multi_axis(name, dims):
    ja, pa = both(T3)
    same(getattr(ja, name)(*dims), getattr(pa, name)(*dims))


def test_number_reductions_cumulative_and_scan():
    ja, pa = both(M)
    for n in ("sumNumber", "meanNumber", "maxNumber", "minNumber"):
        assert getattr(pa, n)() == pytest.approx(getattr(ja, n)(), rel=1e-6)
    same(ja.cumsum(1), pa.cumsum(1))
    same(ja.cumprod(0), pa.cumprod(0))
    assert pa.scan(lambda t: t > 0) == ja.scan(lambda t: t > 0)


# ----------------------------------------------------------------------
# linear algebra and shape ops
# ----------------------------------------------------------------------

def test_linalg_and_shapes():
    (ja, pa), (jb, pb) = both(M), both(N.T.copy())
    same(ja.mmul(jb), pa.mmul(pb))
    same(ja @ jb, pa @ pb)
    (jt, pt), (jw, pw) = both(T3), both(rng(4).randn(4, 5).astype("f4"))
    same(jt.tensorMmul(jw, axes=([2], [0])),
         pt.tensorMmul(pw, axes=([2], [0])))
    for f in (lambda a: a.permute(2, 0, 1), lambda a: a.transpose(),
              lambda a: a.swapAxes(0, 2), lambda a: a.reshape(4, 6),
              lambda a: a.reshape((6, -1)), lambda a: a.ravel(),
              lambda a: a.expandDims(1), lambda a: a.repeat(1, 2),
              lambda a: a.get(J.NDArrayIndex.point(0)
                              if isinstance(a, J.INDArray)
                              else P.NDArrayIndex.point(0))
              .broadcast(2, 3, 4),
              lambda a: a.reshape(1, 2, 12).squeeze(0),
              lambda a: a.tensorAlongDimension(1, 0, 2),
              lambda a: a.slice(1, 2)):
        same(f(jt), f(pt), exact=True)


@pytest.mark.parametrize("op", ["gemm_plain", "gemm_tA", "gemm_tB",
                                "gemm_alpha_beta"])
def test_gemm(op):
    a, b = rng(5).randn(4, 3).astype("f4"), rng(6).randn(4, 3).astype("f4")
    c = rng(7).randn(3, 3).astype("f4")
    kw = {"gemm_plain": dict(transposeA=True),
          "gemm_tA": dict(transposeA=True),
          "gemm_tB": dict(transposeB=True),
          "gemm_alpha_beta": dict(transposeA=True, alpha=0.5, beta=2.0)}[op]
    if op == "gemm_tB":
        b = rng(6).randn(3, 3).astype("f4")
        a = rng(5).randn(3, 3).astype("f4")
    (ja, pa), (jb, pb), (jc, pc) = both(a), both(b), both(c)
    same(J.Nd4j.gemm(ja, jb, c=jc, **kw), P.Nd4j.gemm(pa, pb, c=pc, **kw))


def test_joining_sorting_and_long_tail():
    (ja, pa), (jb, pb) = both(M), both(N)
    JN, PN = J.Nd4j, P.Nd4j
    for jf, pf in [
        (lambda: JN.concat(0, ja, jb), lambda: PN.concat(0, pa, pb)),
        (lambda: JN.concat(1, ja, jb), lambda: PN.concat(1, pa, pb)),
        (lambda: JN.vstack(ja, jb), lambda: PN.vstack(pa, pb)),
        (lambda: JN.hstack(ja, jb), lambda: PN.hstack(pa, pb)),
        (lambda: JN.stack(1, ja, jb), lambda: PN.stack(1, pa, pb)),
        (lambda: JN.pile(ja, jb), lambda: PN.pile(pa, pb)),
        (lambda: JN.tile(ja, 2, 1), lambda: PN.tile(pa, 2, 1)),
        (lambda: JN.repeat(ja, 2, 1), lambda: PN.repeat(pa, 2, 1)),
        (lambda: JN.sort(ja, 1), lambda: PN.sort(pa, 1)),
        (lambda: JN.sort(ja, 0, False), lambda: PN.sort(pa, 0, False)),
        (lambda: JN.argsort(ja, 1), lambda: PN.argsort(pa, 1)),
        (lambda: JN.reverse(ja, 1), lambda: PN.reverse(pa, 1)),
        (lambda: JN.reverse(ja), lambda: PN.reverse(pa)),
        (lambda: JN.max(ja, jb), lambda: PN.max(pa, pb)),
        (lambda: JN.min(ja, jb), lambda: PN.min(pa, pb)),
        (lambda: JN.kron(ja, jb), lambda: PN.kron(pa, pb)),
        (lambda: JN.argMax(ja), lambda: PN.argMax(pa)),
        (lambda: JN.argMax(ja, 1), lambda: PN.argMax(pa, 1)),
        (lambda: JN.accumulate(ja, jb), lambda: PN.accumulate(pa, pb)),
        (lambda: JN.average([ja, jb]), lambda: PN.average([pa, pb])),
        (lambda: JN.diag(ja.getRow(0)), lambda: PN.diag(pa.getRow(0))),
        (lambda: JN.expandDims(ja, 0), lambda: PN.expandDims(pa, 0)),
        (lambda: JN.where(ja.gt(0.0), ja, jb),
         lambda: PN.where(pa.gt(0.0), pa, pb)),
        (lambda: JN.zerosLike(ja), lambda: PN.zerosLike(pa)),
        (lambda: JN.onesLike(ja), lambda: PN.onesLike(pa)),
    ]:
        same(jf(), pf())
    ji, js = JN.sortWithIndices(ja, 1, False)
    pi, ps = PN.sortWithIndices(pa, 1, False)
    same(ji, pi)
    same(js, ps)
    for jw, pw in zip(JN.where(ja.gt(0.0)), PN.where(pa.gt(0.0))):
        same(jw, pw)
    with pytest.raises(ValueError):
        PN.argMax(pa, 0, 1)
    with pytest.raises(ValueError):
        PN.average()


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "wrap"])
def test_pad_modes(mode):
    ja, pa = both(M)
    same(J.Nd4j.pad(ja, ((1, 2), (0, 3)), mode=mode),
         P.Nd4j.pad(pa, ((1, 2), (0, 3)), mode=mode), exact=True)


# ----------------------------------------------------------------------
# rows, columns, get/put with NDArrayIndex
# ----------------------------------------------------------------------

A24 = np.arange(24, dtype=np.float32).reshape(4, 6)


def test_rows_columns_and_slices():
    ja, pa = both(A24)
    same(ja.getRow(1), pa.getRow(1), exact=True)
    same(ja.getColumn(2), pa.getColumn(2), exact=True)
    same(ja.getRows(0, 3), pa.getRows(0, 3), exact=True)
    same(ja.getColumns(1, 5), pa.getColumns(1, 5), exact=True)
    same(ja[1:3, ::2], pa[1:3, ::2], exact=True)
    same(ja[::-1, 1], pa[::-1, 1], exact=True)
    same(ja[np.array([0, 2])], pa[np.array([0, 2])], exact=True)
    same(ja[np.array([0, 2])], pa[[0, 2]], exact=True)
    same(ja[None, 1], pa[None, 1], exact=True)


@pytest.mark.parametrize("idx", [
    lambda I: (I.interval(1, 3), I.all()),
    lambda I: (I.point(2), I.interval(0, 4)),
    lambda I: (I.all(), I.interval(0, 2, 6)),
    lambda I: (I.interval(0, 1, 2, True), I.point(-1)),
    lambda I: (I.newAxis(), I.point(1)),
    lambda I: (I.indices(0, 3), I.all()),
])
def test_ndarrayindex_get_put(idx):
    ja, pa = both(A24)
    jt, pt = idx(J.NDArrayIndex), idx(P.NDArrayIndex)
    jg, pg = ja.get(*jt), pa.get(*pt)
    same(jg, pg, exact=True)
    val = np.full(jg.shape(), -1.0, np.float32)
    if 0 not in jg.shape() and not any(
            type(i).__name__ == "_NewAxis" for i in pt):
        same(ja.put(list(jt), J.Nd4j.create(val)),
             pa.put(list(pt), P.Nd4j.create(val, device=CPU)), exact=True)


def test_put_scalar_get_double_and_setitem():
    ja, pa = both(np.zeros((2, 3), np.float32))
    for args in ((0, 1, 5.0), (4, 7.0), ((1, 2), 3.0)):
        ja.putScalar(*args)
        pa.putScalar(*args)
        same(ja, pa, exact=True)
    assert pa.getDouble(0, 1) == ja.getDouble(0, 1) == 5.0
    assert pa.getDouble(4) == ja.getDouble(4) == 7.0
    assert pa.getInt(1, 2) == 3
    ja[0] = 9.0
    pa[0] = 9.0
    ja[:, 1] = J.Nd4j.create([1.0, 2.0])
    pa[:, 1] = P.Nd4j.create([1.0, 2.0], device=CPU)
    same(ja, pa, exact=True)
    ja.putRow(1, J.Nd4j.create([4.0, 5.0, 6.0]))
    pa.putRow(1, P.Nd4j.create([4.0, 5.0, 6.0], device=CPU))
    ja.putColumn(2, J.Nd4j.create([[8.0], [9.0]]))
    pa.putColumn(2, P.Nd4j.create([[8.0], [9.0]], device=CPU))
    same(ja, pa, exact=True)


def test_where_replace_getwhere():
    ja, pa = both(M)
    same(ja.getWhere(0.0, lambda x, c: x > c),
         pa.getWhere(0.0, lambda x, c: x > c), exact=True)
    same(ja.replaceWhere(0.0, ja.lt(0.0)), pa.replaceWhere(0.0, pa.lt(0.0)),
         exact=True)


# ----------------------------------------------------------------------
# value semantics and host-side bounds
# ----------------------------------------------------------------------

class TestValueSemantics:
    """Nothing aliases, as in the reference (immutable JAX buffers)."""

    @pytest.mark.parametrize("view", [
        lambda a: a.getRow(0), lambda a: a.getColumn(1),
        lambda a: a.get(P.NDArrayIndex.interval(0, 2), P.NDArrayIndex.all()),
        lambda a: a.slice(0), lambda a: a[0], lambda a: a[:, 1:],
        lambda a: P.INDArray(a), lambda a: a.reshape(12),
        lambda a: a.transpose(), lambda a: a.tensorAlongDimension(0, 1),
    ])
    @pytest.mark.parametrize("mutate", [
        lambda v: v.addi(1.0), lambda v: v.muli(0.0), lambda v: v.negi(),
        lambda v: v.assign(7.0), lambda v: v.putScalar(0, 99.0),
        lambda v: v.__setitem__(0, -5.0),
        lambda v: v.replaceWhere(3.0, v.gt(-100.0)),
    ])
    def test_view_mutation_leaves_parent(self, view, mutate):
        a = P.Nd4j.create(A24[:3, :4].copy(), device=CPU)
        before = a.toNumpy().copy()
        v = view(a)
        mutate(v)
        np.testing.assert_array_equal(a.toNumpy(), before)

    def test_parent_mutation_leaves_views(self):
        a = P.Nd4j.create(A24[:3, :4].copy(), device=CPU)
        row, shared = a.getRow(0), P.INDArray(a)
        a.addi(1.0).putScalar(0, 0, 50.0)
        a[1] = 0.0
        np.testing.assert_array_equal(row.toNumpy(), A24[0, :4])
        np.testing.assert_array_equal(shared.toNumpy(), A24[:3, :4])

    def test_numpy_input_is_snapshotted_and_dup_is_independent(self):
        x = np.ones(3, np.float32)
        a = P.INDArray(x, device=CPU)
        x[0] = 5.0
        assert a.sumNumber() == 3.0
        b = a.dup()
        a.addi(1.0)
        assert b.meanNumber() == 1.0 and a.meanNumber() == 2.0

    def test_reference_agrees(self):
        ja = J.Nd4j.create(A24.copy())
        ja.getRow(0).addi(1.0)
        J.INDArray(ja).addi(1.0)
        same(ja, P.Nd4j.create(A24, device=CPU), exact=True)


class TestBounds:
    @pytest.mark.parametrize("call", [
        lambda a: a.getDouble(3, 0), lambda a: a.getDouble(0, 4),
        lambda a: a.getDouble(12), lambda a: a.getDouble(-13),
        lambda a: a.getInt(0, 0, 0), lambda a: a.getScalar(-4, 0),
        lambda a: a.putScalar(3, 0, 1.0), lambda a: a.putScalar(12, 1.0),
        lambda a: a.get(P.NDArrayIndex.point(3)),
        lambda a: a.get(P.NDArrayIndex.indices(0, 3)),
        lambda a: a.get(P.NDArrayIndex.all(), P.NDArrayIndex.point(4)),
        lambda a: a.put([P.NDArrayIndex.point(5)], 1.0),
        lambda a: a[[0, 3]], lambda a: a[:, [4]],
        lambda a: a.getRows(0, 3), lambda a: a.getRow(3),
        lambda a: a.slice(4, 1), lambda a: a.__setitem__(7, 0.0),
    ])
    def test_out_of_range_raises_index_error(self, call):
        a = P.Nd4j.create(A24[:3, :4].copy(), device=CPU)
        with pytest.raises(IndexError):
            call(a)
        np.testing.assert_array_equal(a.toNumpy(), A24[:3, :4])

    def test_reference_raises_too(self):
        ja = J.Nd4j.create(A24[:3, :4].copy())
        for call in (lambda: ja.getDouble(3, 0), lambda: ja.getDouble(12),
                     lambda: ja.putScalar(3, 0, 1.0)):
            with pytest.raises(IndexError):
                call()


# ----------------------------------------------------------------------
# dtypes
# ----------------------------------------------------------------------

class TestDtype:
    @pytest.mark.parametrize("name", ["FLOAT", "DOUBLE", "HALF", "BFLOAT16",
                                      "INT8", "INT16", "INT32", "INT64",
                                      "UINT8", "BOOL", "INT", "LONG"])
    def test_cast_names_match(self, name):
        ja, pa = both(np.array([[1.9, -2.1], [0.0, 3.5]], np.float32))
        jc, pc = ja.castTo(name), pa.castTo(name)
        assert pc.dataType().name == jc.dataType().name
        if name != "UINT8":   # float -> uint8 of a negative is UB
            same(jc.castTo("DOUBLE"), pc.castTo("DOUBLE"), exact=True)

    def test_resolve_forms(self):
        from deeplearning4j_tpu_torch.ndarray.dtype import resolve, numpy_name
        for f in (P.DataType.FLOAT, "FLOAT", "float32", np.float32,
                  np.dtype("float32"), torch.float32, "torch.float32"):
            assert resolve(f) == torch.float32
        assert resolve("LONG") == torch.int64
        assert numpy_name(torch.bfloat16) == "bfloat16"
        assert P.DataType.from_dtype("bfloat16") == P.DataType.BFLOAT16
        assert P.DataType.INT32.is_integer() and P.DataType.HALF.is_floating()

    def test_bf16_to_numpy_is_its_float32_widening(self):
        """numpy has no bf16 here: toNumpy() of a bf16 array is float32,
        the exact widening of the bf16 values."""
        x = np.array([1.0, 1.00390625, 3.14159, -2.5e-3], np.float32)
        b = P.Nd4j.create(x, device=CPU).castTo(P.DataType.BFLOAT16)
        assert b.dataType() == P.DataType.BFLOAT16
        got = b.toNumpy()
        assert got.dtype == np.float32
        want = torch.from_numpy(x).bfloat16().float().numpy()
        np.testing.assert_array_equal(got, want)
        # a bf16 sum is a bf16 number, in both packages
        assert b.sumNumber() == J.Nd4j.create(x).castTo("BFLOAT16").sumNumber()


# ----------------------------------------------------------------------
# Transforms
# ----------------------------------------------------------------------

UNARY_T = ["exp", "log", "log1p", "expm1", "sqrt", "cbrt", "reciprocal",
           "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "abs",
           "sign", "floor", "ceil", "round", "sigmoid", "relu", "relu6",
           "elu", "gelu", "softplus", "softsign", "mish", "swish",
           "hardTanh", "hardSigmoid", "step", "unitVec",
           "normalizeZeroMeanAndUnitVariance"]


@pytest.mark.parametrize("name", UNARY_T)
def test_transforms_unary(name):
    x = POS if name in ("log", "sqrt", "cbrt", "reciprocal") else M * 2.0
    ja, pa = both(x)
    same(getattr(J.Transforms, name)(ja), getattr(P.Transforms, name)(pa))


def test_transforms_with_arguments():
    (ja, pa), (jb, pb) = both(M), both(N)
    (jp, pp) = both(np.clip(M, -0.9, 0.9))
    JT, PT = J.Transforms, P.Transforms
    for f in (lambda T, a, b: T.asin(a), lambda T, a, b: T.acos(a),
              lambda T, a, b: T.atanh(a)):
        same(f(JT, jp, None), f(PT, pp, None))
    for f in (lambda T, a, b: T.clip(a, -0.5, 0.5),
              lambda T, a, b: T.pow(a, 2), lambda T, a, b: T.max(a, b),
              lambda T, a, b: T.min(a, 0.1),
              lambda T, a, b: T.leakyRelu(a, 0.2),
              lambda T, a, b: T.softmax(a), lambda T, a, b: T.softmax(a, 0),
              lambda T, a, b: T.logSoftmax(a),
              lambda T, a, b: T.isMax(a), lambda T, a, b: T.isMax(a, 1),
              lambda T, a, b: T.euclideanDistance(a, b),
              lambda T, a, b: T.manhattanDistance(a, b),
              lambda T, a, b: T.cosineSim(a, b),
              lambda T, a, b: T.cosineDistance(a, b),
              lambda T, a, b: T.hammingDistance(a.gt(0.0), b.gt(0.0)),
              lambda T, a, b: T.jaccardDistance(T.abs(a), T.abs(b)),
              lambda T, a, b: T.allEuclideanDistances(a, b, 1),
              lambda T, a, b: T.allManhattanDistances(a, b),
              lambda T, a, b: T.allCosineSimilarities(a, b)):
        same(f(JT, ja, jb), f(PT, pa, pb))
    with pytest.raises(ValueError, match="2-D"):
        PT.allEuclideanDistances(P.Nd4j.zeros(3, device=CPU),
                                 P.Nd4j.zeros(3, device=CPU))
    with pytest.raises(ValueError, match="dimensions"):
        PT.allCosineSimilarities(pa, pb, 0)


# ----------------------------------------------------------------------
# im2col / col2im
# ----------------------------------------------------------------------

GEOMS = [(3, 3, 1, 1, 0, 0, False), (2, 3, 2, 1, 1, 0, False),
         (3, 2, 2, 2, 1, 1, False), (3, 3, 2, 2, 0, 0, True),
         (2, 2, 3, 1, 0, 0, True)]


@pytest.mark.parametrize("geom", GEOMS)
def test_im2col_col2im_match_reference(geom):
    kh, kw, sy, sx, ph, pw, same_mode = geom
    x = rng(8).randn(2, 3, 7, 6).astype(np.float32)
    jx, px = both(x)
    jc = j_im2col(jx, kh, kw, sy, sx, ph, pw, same_mode)
    pc = p_im2col(px, kh, kw, sy, sx, ph, pw, same_mode)
    same(jc, pc, exact=True)   # a patch copies values: exact
    y = rng(9).randn(*jc.shape()).astype(np.float32)
    jy, py = both(y)
    same(j_col2im(jy, sy, sx, ph, pw, h=7, w=6, isSameMode=same_mode),
         p_col2im(py, sy, sx, ph, pw, h=7, w=6, isSameMode=same_mode))


def test_col2im_is_the_adjoint():
    x = torch.from_numpy(rng(2).randn(2, 2, 6, 5))
    y = torch.from_numpy(rng(3).randn(2, 2, 3, 2, 3, 4))
    lhs = float((p_im2col(x, 3, 2, 2, 1, 1, 0).tensor() * y).sum())
    rhs = float((x * p_col2im(y, 2, 1, 1, 0, h=6, w=5).tensor()).sum())
    assert abs(lhs - rhs) < 1e-9


def test_im2col_validation():
    with pytest.raises(ValueError, match="NCHW"):
        p_im2col(torch.zeros(3, 4, 5), 2, 2)
    with pytest.raises(ValueError, match="does not fit"):
        p_im2col(torch.zeros(1, 1, 3, 3), 5, 5)
    col = torch.zeros(1, 1, 2, 2, 2, 2)
    with pytest.raises(ValueError, match="needs the target"):
        p_col2im(col)
    with pytest.raises(ValueError, match="do not match"):
        p_col2im(col, h=9, w=9)


# ----------------------------------------------------------------------
# file I/O, the executioner
# ----------------------------------------------------------------------

class TestFileIO:
    def test_npy_binary_cross_read(self, tmp_path):
        pa = P.Nd4j.create(M, device=CPU)
        P.Nd4j.writeNpy(pa, tmp_path / "p.npy")
        J.Nd4j.writeNpy(J.Nd4j.create(M), tmp_path / "j.npy")
        same(J.Nd4j.readNpy(tmp_path / "p.npy"),
             P.Nd4j.readNpy(tmp_path / "j.npy", device=CPU), exact=True)
        P.Nd4j.saveBinary(pa, tmp_path / "model.bin")
        assert not (tmp_path / "model.bin.npy").exists()
        same(J.Nd4j.readBinary(tmp_path / "model.bin"),
             P.Nd4j.readBinary(tmp_path / "model.bin", device=CPU),
             exact=True)

    @pytest.mark.parametrize("data", [
        np.array([[1.5, -2.25], [3.0, 1e-7]], np.float32),
        np.array([[True, False], [False, True]]),
        np.array([2**60 + 1, -7], np.int64),
        np.array([1 + 2j, -0.5j], np.complex64),
    ])
    def test_txt_roundtrip_both_ways(self, tmp_path, data):
        p = P.INDArray(data, device=CPU)
        P.Nd4j.writeTxt(p, tmp_path / "p.txt")
        J.Nd4j.writeTxt(J.INDArray(data), tmp_path / "j.txt")
        assert (tmp_path / "p.txt").read_text() == \
            (tmp_path / "j.txt").read_text()
        back = P.Nd4j.readTxt(tmp_path / "j.txt", device=CPU)
        np.testing.assert_array_equal(back.toNumpy(), data)
        assert back.toNumpy().dtype == data.dtype
        q = tmp_path / "bad.txt"
        q.write_text("1 2 3\n")
        with pytest.raises(ValueError, match="header"):
            P.Nd4j.readTxt(q)


def test_executioner_surface(capsys):
    ex = P.Nd4j.getExecutioner()
    assert ex is P.TorchExecutioner.instance()
    assert ex.platform() in ("cpu", "cuda")
    assert ex.deviceCount() == len(ex.devices()) >= 1
    assert ex.exec(lambda a, b: a + b, 2, 3) == 5
    ex.enableProfiling(True)
    try:
        assert ex.exec(lambda a: a * 2, 4) == 8
    finally:
        ex.enableProfiling(False)
    assert "[TorchExecutioner]" in capsys.readouterr().out
    ex.commit()
    from deeplearning4j_tpu_torch.parallel import build_mesh

    dm = P.Nd4j.ones(4, 2, device=CPU).distribute(build_mesh())
    assert dm.shape == (4, 2) and dm.row_axis == "data"
    np.testing.assert_array_equal(dm.toNumpy(), np.ones((4, 2), np.float32))


class TestRandom:
    """The seeded facade over per-device torch generators (held to
    reproducibility and moments; Philox never matches threefry)."""

    def test_facade_reproducible_from_set_seed(self):
        r = P.Nd4j.getRandom()
        r.setSeed(3)
        a = (r.nextDouble(), r.nextGaussian(), r.nextInt(10))
        assert r.getSeed() == 3
        r.setSeed(3)
        assert (r.nextDouble(), r.nextGaussian(), r.nextInt(10)) == a
        assert 0.0 <= a[0] < 1.0 and 0 <= a[2] < 10

    def test_seed_gives_a_fresh_stream_and_leaves_the_global_one(self):
        from deeplearning4j_tpu_torch.ndarray import random as R
        R.setSeed(11)
        g1 = P.Nd4j.rand(4, device=CPU)
        R.setSeed(11)
        s = P.Nd4j.rand(4, seed=5, device=CPU)
        g2 = P.Nd4j.rand(4, device=CPU)
        same(g1, g2, exact=True)
        same(s, P.Nd4j.rand(4, seed=5, device=CPU), exact=True)
        assert not s.equals(g1)

    def test_uniform_integer_dtype_guard(self):
        from deeplearning4j_tpu_torch.ndarray import random as R
        with pytest.raises(ValueError, match="integer bounds"):
            R.uniform((3,), torch.int32)
        t = R.uniform((1000,), torch.int32, 2, 7, seed=0)
        assert t.dtype == torch.int32
        assert int(t.min()) >= 2 and int(t.max()) < 7

    def test_moments(self):
        n = 1 << 16
        u = P.Nd4j.rand(n, seed=1, device=CPU).tensor().double()
        z = P.Nd4j.randn(n, seed=2, device=CPU).tensor().double()
        from deeplearning4j_tpu_torch.ndarray import random as R
        b = R.bernoulli((n,), 0.25, torch.float32, seed=3).double()
        se = 5.0 / np.sqrt(n)
        assert abs(float(u.mean()) - 0.5) <= se * np.sqrt(1 / 12)
        assert abs(float(z.mean())) <= se
        assert abs(float(z.std()) - 1.0) <= se * np.sqrt(0.5)
        assert abs(float(b.mean()) - 0.25) <= se * np.sqrt(0.1875)
