"""SameDiff's namespaces in the port against the reference's, on the CPU
(deeplearning4j_tpu_torch.autodiff vs deeplearning4j_tpu.autodiff).

Every op the reference's OPS registers is in the port's (asserted), and
each family of the rest of SameDiff is held to the reference on the same
seeded numpy inputs, the same graph built in both packages:

* cnn (conv1d/2d/3d, deconv2d, the pools, upsampling2d, im2col, the block
  rearrangements), rnn (lstmLayer, gru, simpleRnn), image (resize both
  ways, cropAndResize, contrast, hsv) and the segment ops: values within
  rtol 1e-5 / atol 1e-6, gradients of a weighted sum within 1e-4 rel L2
  (absolute 1e-6 where the gradient is rounding noise);
* NMS indices and bitwise results exactly; uint16/uint32 bitwise ops
  widen exactly, uint64 keeps and/or/xor/not and refuses shifts;
* linalg: factors where LAPACK gives both packages the same ones (the
  CPU), plus reconstructions; ``lstsq`` on a rank-deficient A is the
  minimum-norm solution (the reference's and numpy's pinv);
* fft within 1e-5 of the max-abs, complex results complex;
* ``betainc`` within rtol 1e-5 of the reference (and, in f32, within
  1e-5 + 1e-5 |value| of scipy: the reference's own f32 reach), with the
  reference's gradient in x and its refusal in a and b.

The reference's tests of these namespaces (tests/test_samediff.py
:181-200, :582-1040, with the math and loss long tail and AdamW) each
have a port counterpart here, and updater state crosses both packages in
a file that also holds control flow and fft ops.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import scipy.special as sp
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSD
from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
from deeplearning4j_tpu.autodiff.ops_impl import OPS as JOPS
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.ops_impl import OPS
from deeplearning4j_tpu_torch.nn import updaters as tupd

torch.set_num_threads(2)
CPU = "cpu"


def psd():
    return SameDiff.create(device=CPU)


def rnd(*shape, seed=0, scale=1.0, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return np.asarray(rs.randn(*shape) * scale).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def both(build, feeds=None, wrt=()):
    """Build `build(sd)` in both packages; return per package the output
    values and, for `wrt` (variable names), the gradients of
    sum(out_0 * R) for a fixed random R."""
    res = {}
    for pkg in ("j", "p"):
        sd = JSD.create() if pkg == "j" else psd()
        out = build(sd)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        names = [o.name for o in outs]
        got = sd.output(feeds or {}, names)
        vals = [got[n].toNumpy() for n in names]
        grads = None
        if wrt:
            r = rnd(*vals[0].shape, seed=99)
            loss = sd.math.sum(outs[0] * sd.constant(r), name="wloss")
            sd.setLossVariables(loss.name)
            g = sd.calculateGradients(feeds or {}, *wrt)
            grads = {n: g[n].toNumpy() for n in wrt}
        res[pkg] = (names, vals, grads)
    return res


def check(res, rtol=1e-5, atol=1e-6, exact=False, grad_rel=1e-4):
    (jn, jv, jg), (pn, pv, pg) = res["j"], res["p"]
    assert pn == jn                       # the reference's naming
    for a, b in zip(pv, jv):
        assert a.shape == b.shape, (a.shape, b.shape)
        if exact or b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            assert a.dtype.kind == b.dtype.kind
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    if jg is not None:
        for n in jg:
            assert rel_l2(pg[n], jg[n]) <= grad_rel or \
                np.abs(pg[n] - jg[n]).max() <= 1e-6, n


def test_every_reference_op_is_registered():
    assert set(JOPS) <= set(OPS)
    assert set(OPS) == set(JOPS)


# ----------------------------------------------------------------------
# the reference's namespace tests, case by case
# ----------------------------------------------------------------------

def test_cnn_namespace_conv_and_pool():
    xv = np.random.RandomState(1).rand(1, 8, 8, 2).astype(np.float32)
    wv = (np.random.RandomState(0).rand(3, 3, 2, 4) * 0.1).astype(np.float32)

    def build(sd):
        x = sd.placeHolder("x", "float32", 1, 8, 8, 2)
        w = sd.var("w", wv)
        c = sd.cnn.conv2d(x, w, padding=((1, 1), (1, 1)), name="c")
        return sd.cnn.maxPooling2d(c, (2, 2), name="p")

    res = both(build, {"x": xv}, wrt=("w", "x"))
    assert res["p"][1][0].shape == (1, 4, 4, 4)
    check(res)


def test_rnn_namespace_lstm():
    T, B, F, H = 5, 2, 3, 4
    rs = np.random.RandomState(0)
    xv = rs.rand(T, B, F).astype(np.float32)
    ws = [(rs.rand(*s) * 0.1).astype(np.float32)
          for s in ((F, 4 * H), (H, 4 * H))] + [np.zeros(4 * H, np.float32)]

    def build(sd):
        x = sd.placeHolder("x", "float32", T, B, F)
        w, u, b = (sd.var(n, a) for n, a in zip("wub", ws))
        return sd.rnn.lstmLayer(x, w, u, b)

    res = both(build, {"x": xv}, wrt=("w", "u", "b", "x"))
    assert res["p"][1][0].shape == (T, B, H)
    check(res)


def test_cnn_namespace_conv3d():
    rs = np.random.RandomState(0)
    wv = (rs.rand(3, 3, 3, 2, 4) * 0.1).astype(np.float32)
    xv = rs.rand(1, 5, 6, 7, 2).astype(np.float32)

    def build(sd):
        x = sd.placeHolder("x", "float32", 1, 5, 6, 7, 2)
        return sd.cnn.conv3d(x, sd.var("w", wv),
                             padding=((1, 1), (1, 1), (1, 1)), name="c")

    res = both(build, {"x": xv}, wrt=("w", "x"))
    assert res["p"][1][0].shape == (1, 5, 6, 7, 4)
    check(res)


# ----------------------------------------------------------------------
# every cnn / rnn / image op, values and gradients
# ----------------------------------------------------------------------

X4 = rnd(2, 7, 6, 3, seed=1)


def _x(sd):
    return sd.var("x", X4)


CNN_CASES = {
    "conv2d_stride_dilation_asym": lambda sd: sd.cnn.conv2d(
        _x(sd), sd.var("w", rnd(3, 2, 3, 4, seed=2)), sd.var("b", rnd(4)),
        stride=(2, 1), padding=((1, 2), (0, 1)), dilation=(1, 2)),
    "conv2d_groups": lambda sd: sd._op(
        "conv2d", [sd.var("x", rnd(2, 5, 5, 4, seed=3)),
                   sd.var("w", rnd(3, 3, 2, 6, seed=4))],
        {"stride": [1, 1], "padding": [[1, 1], [1, 1]],
         "dilation": [1, 1], "groups": 2}),
    "conv1d": lambda sd: sd.cnn.conv1d(
        sd.var("x", rnd(2, 9, 3, seed=5)), sd.var("w", rnd(3, 3, 5, seed=6)),
        sd.var("b", rnd(5)), stride=2, padding=((2, 1),), dilation=1),
    "conv3d_stride": lambda sd: sd.cnn.conv3d(
        sd.var("x", rnd(1, 5, 4, 6, 2, seed=7)),
        sd.var("w", rnd(2, 3, 2, 2, 3, seed=8)), sd.var("b", rnd(3)),
        stride=(2, 1, 2), padding=((0, 1), (1, 1), (1, 0))),
    "deconv2d": lambda sd: sd.cnn.deconv2d(
        _x(sd), sd.var("w", rnd(3, 3, 3, 2, seed=9)), sd.var("b", rnd(2)),
        stride=(2, 2), padding=((1, 2), (2, 1))),
    "maxPooling2d_pad": lambda sd: sd.cnn.maxPooling2d(
        _x(sd), (3, 3), (2, 2), padding=((1, 1), (0, 1))),
    "avgPooling2d_include": lambda sd: sd.cnn.avgPooling2d(
        _x(sd), (3, 3), (2, 2), padding=((1, 1), (1, 1))),
    "avgPooling2d_exclude": lambda sd: sd.cnn.avgPooling2d(
        _x(sd), (3, 3), (2, 2), padding=((1, 1), (1, 1)),
        count_include_pad=False),
    "upsampling2d": lambda sd: sd.cnn.upsampling2d(_x(sd), (2, 3)),
    "im2col": lambda sd: sd.cnn.im2col(_x(sd), (3, 2), (2, 1),
                                       padding=((1, 0), (1, 1))),
    "spaceToBatch": lambda sd: sd.cnn.spaceToBatch(
        _x(sd), 2, padding=((1, 0), (0, 0))),
    "batchToSpace": lambda sd: sd.cnn.batchToSpace(
        sd.var("x", rnd(8, 3, 2, 2, seed=10)), 2, crops=((1, 0), (0, 1))),
    "spaceToDepth": lambda sd: sd.cnn.spaceToDepth(
        sd.var("x", rnd(2, 4, 6, 3, seed=11)), 2),
    "depthToSpace": lambda sd: sd.cnn.depthToSpace(
        sd.var("x", rnd(2, 2, 3, 8, seed=12)), 2),
}


@pytest.mark.parametrize("name", sorted(CNN_CASES))
def test_cnn_op_matches_reference(name):
    check(both(CNN_CASES[name], wrt=("x",)))


T, B, NIN, H = 6, 3, 5, 4


def _rnn_case(op, gates):
    def build(sd):
        x = sd.var("x", rnd(T, B, NIN, seed=20))
        w = sd.var("w", rnd(NIN, gates * H, seed=21, scale=0.4))
        u = sd.var("u", rnd(H, gates * H, seed=22, scale=0.4))
        b = sd.var("b", rnd(gates * H, seed=23, scale=0.1))
        return getattr(sd.rnn, op)(x, w, u, b)
    return build


@pytest.mark.parametrize("op,gates", [("lstmLayer", 4), ("gru", 3),
                                      ("simpleRnn", 1)])
def test_rnn_op_matches_reference(op, gates):
    check(both(_rnn_case(op, gates), wrt=("x", "w", "u", "b")))


IMG = rnd(2, 6, 8, 3, seed=30, lo=0.0, hi=1.0)
# no sample lands on a pixel row or column: there bilinear sampling has
# only one-sided derivatives, and f32 (port) and f64 (the reference under
# x64) positions may fall on either side
BOXES = np.array([[0.1, 0.2, 0.77, 0.71], [0.03, 0.02, 0.97, 0.99],
                  [0.5, 0.3, 0.61, 0.9]], np.float32)

IMAGE_CASES = {
    "resizeBilinear_up": lambda sd: sd.image.resizeBilinear(
        sd.var("x", IMG), 13, 11),
    "resizeBilinear_down": lambda sd: sd.image.resizeBilinear(
        sd.var("x", IMG), 4, 3),
    "resizeBilinear_mixed": lambda sd: sd.image.resizeBilinear(
        sd.var("x", IMG), 2, 16),
    "resizeNearest_up": lambda sd: sd.image.resizeNearest(
        sd.var("x", IMG), 13, 11),
    "resizeNearest_down": lambda sd: sd.image.resizeNearest(
        sd.var("x", IMG), 4, 3),
    "cropAndResize": lambda sd: sd.image.cropAndResize(
        sd.var("x", IMG), sd.var("boxes", BOXES),
        sd.constant(np.array([1, 0, 1], np.int32)), 5, 4),
    "adjustContrast": lambda sd: sd.image.adjustContrast(
        sd.var("x", IMG), 1.7),
    "hsvToRgb": lambda sd: sd.image.hsvToRgb(sd.var("x", IMG)),
    "rgbToHsv": lambda sd: sd.image.rgbToHsv(sd.var("x", IMG)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_image_op_matches_reference(name):
    wrt = ("x", "boxes") if name == "cropAndResize" else ("x",)
    if name in ("hsvToRgb", "rgbToHsv"):
        wrt = ()      # piecewise at the branch edges; values only
    check(both(IMAGE_CASES[name], wrt=wrt))


# ----------------------------------------------------------------------
# non-max suppression (the reference's TestNonMaxSuppression)
# ----------------------------------------------------------------------

def _nms_boxes():
    boxes = np.array([[0, 0, 1, 1], [0, 0, 1.05, 1.05], [2, 2, 3, 3],
                      [0, 0, 0.4, 0.4]], "float32")
    scores = np.array([0.9, 0.8, 0.7, 0.6], "float32")
    return boxes, scores


@pytest.mark.parametrize("kw,want", [
    (dict(maxOutputSize=4, iouThreshold=0.5), [0, 2, 3, -1]),
    (dict(maxOutputSize=4, iouThreshold=0.5, scoreThreshold=0.65),
     [0, 2, -1, -1]),
    (dict(maxOutputSize=1), [0]),
], ids=["greedy_selection_and_padding", "score_threshold_filters",
        "max_output_truncates"])
def test_non_max_suppression(kw, want):
    boxes, scores = _nms_boxes()
    res = both(lambda sd: sd.image.nonMaxSuppression(
        sd.constant(boxes), sd.constant(scores), name="nms", **kw))
    check(res, exact=True)
    got = res["p"][1][0]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_nms_nan_scores_and_empty_input():
    boxes = np.array([[0, 0, 1, 1], [5, 5, 6, 6], [2, 2, 3, 3]], "float32")
    scores = np.array([0.9, np.nan, 0.7], "float32")
    res = both(lambda sd: sd.image.nonMaxSuppression(
        sd.constant(boxes), sd.constant(scores), maxOutputSize=3))
    check(res, exact=True)
    np.testing.assert_array_equal(res["p"][1][0], [0, 2, -1])
    res = both(lambda sd: sd.image.nonMaxSuppression(
        sd.constant(np.zeros((0, 4), "float32")),
        sd.constant(np.zeros((0,), "float32")), maxOutputSize=2))
    check(res, exact=True)
    np.testing.assert_array_equal(res["p"][1][0], [-1, -1])


def test_nms_ties_take_the_first_index():
    # equal scores on disjoint boxes: the lower index goes first
    boxes = np.array([[0, 0, 1, 1], [2, 2, 3, 3], [4, 4, 5, 5],
                      [0, 0, 1, 1]], "float32")
    scores = np.array([0.5, 0.7, 0.7, 0.5], "float32")
    res = both(lambda sd: sd.image.nonMaxSuppression(
        sd.constant(boxes), sd.constant(scores), maxOutputSize=4))
    check(res, exact=True)
    np.testing.assert_array_equal(res["p"][1][0], [1, 2, 0, -1])


# ----------------------------------------------------------------------
# the math long tail: special functions and segment ops
# ----------------------------------------------------------------------

def test_special_functions_vs_scipy():
    rs = np.random.RandomState(1)
    a = rs.uniform(0.5, 5.0, (3, 4))
    b = rs.uniform(0.5, 5.0, (3, 4))
    x01 = rs.uniform(0.05, 0.95, (3, 4))
    n = np.full((2, 3), 2.0)
    xz = rs.uniform(1.5, 4.0, (2, 3))
    q = rs.uniform(1.0, 3.0, (2, 3))
    s = rs.uniform(2.0, 5.0, (2, 3))
    sd = psd()
    av, bv, xv = sd.constant(a), sd.constant(b), sd.constant(x01)
    for got, want, tol in (
            (sd.math.lgamma(av), sp.gammaln(a), 1e-5),
            (sd.math.digamma(av), sp.digamma(a), 1e-5),
            (sd.math.igamma(av, bv), sp.gammainc(a, b), 1e-5),
            (sd.math.igammac(av, bv), sp.gammaincc(a, b), 1e-5),
            (sd.math.betainc(av, bv, xv), sp.betainc(a, b, x01), 1e-5),
            (sd.math.polygamma(sd.constant(n), sd.constant(xz)),
             sp.polygamma(2, xz), 1e-4),
            (sd.math.zeta(sd.constant(s), sd.constant(q)), sp.zeta(s, q),
             1e-4)):
        np.testing.assert_allclose(got.eval().toNumpy(), want, rtol=tol,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_betainc_matches_reference_and_its_gradient(dtype):
    rs = np.random.RandomState(4)
    a = rs.uniform(0.5, 5.0, (5, 6)).astype(dtype)
    b = rs.uniform(0.5, 5.0, (5, 6)).astype(dtype)
    x = rs.uniform(0.01, 0.99, (5, 6)).astype(dtype)
    x[0, :3] = [0.0, 1.0, 0.5]        # the edges and the symmetry switch
    a[0, 2], b[0, 2] = 3.0, 3.0

    def build(sd):
        return sd.math.betainc(sd.constant(a), sd.constant(b),
                               sd.var("x", x))

    res = both(build, wrt=("x",))
    check(res, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res["p"][1][0], sp.betainc(a, b, x),
                               rtol=1e-5, atol=1e-7)
    assert res["p"][1][0].dtype == np.dtype(dtype)


def test_betainc_f32_reach_against_scipy():
    """The stated band (ROADMAP.md Queue 3): in f32 the reference's own
    continued fraction lies up to ~2e-5 (relative) from scipy, so the
    card's check is |got - scipy| <= 1e-5 + 1e-5 |scipy|. Both packages
    meet it on chip_smoke's draw shape, the port no further from scipy
    than 1.25x the reference's worst, and in f64 the port is within
    1e-12."""
    import jax

    rng = np.random.default_rng(5)
    a, b = (rng.uniform(0.5, 5.0, (64, 64)).astype(np.float32)
            for _ in range(2))
    x = rng.uniform(0.05, 0.95, (64, 64)).astype(np.float32)
    want = sp.betainc(*(t.astype(np.float64) for t in (a, b, x)))
    with jax.enable_x64(False):
        ref = np.asarray(jax.scipy.special.betainc(a, b, x))
    assert ref.dtype == np.float32
    port = OPS["betainc"](*(torch.from_numpy(t) for t in (a, b, x))).numpy()
    for got in (ref, port):
        assert np.all(np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want))
    rel = lambda g: np.max(np.abs(g - want) / np.abs(want))
    assert rel(port) <= 1.25 * rel(ref)
    p64 = OPS["betainc"](*(torch.from_numpy(t.astype(np.float64))
                           for t in (a, b, x))).numpy()
    assert rel(p64) <= 1e-12


def test_betainc_refuses_gradients_in_a_and_b():
    for pkg in ("j", "p"):
        sd = JSD.create() if pkg == "j" else psd()
        a = sd.var("a", np.float32(2.0))
        y = sd.math.betainc(a, sd.constant(np.float32(3.0)),
                            sd.constant(np.float32(0.4)))
        sd.setLossVariables(y.name)
        with pytest.raises(ValueError, match="with respect to a and b"):
            sd.calculateGradients({}, "a")


def test_segment_reductions():
    data = np.array([3.0, 1.0, 4.0, 1.0, 5.0, 9.0])
    ids = np.array([0, 0, 1, 1, 1, 2])
    sd = psd()
    d, i = sd.constant(data), sd.constant(ids)
    np.testing.assert_allclose(
        sd.math.segmentSum(d, i, numSegments=3).eval().toNumpy(),
        [4.0, 10.0, 9.0])
    np.testing.assert_allclose(
        sd.math.segmentMax(d, i, numSegments=3).eval().toNumpy(),
        [3.0, 5.0, 9.0])
    np.testing.assert_allclose(
        sd.math.segmentMean(d, i, numSegments=3).eval().toNumpy(),
        [2.0, 10.0 / 3, 9.0])
    np.testing.assert_allclose(
        sd.math.unsortedSegmentSum(
            sd.constant(data), sd.constant(np.array([2, 0, 1, 0, 1, 2])),
            numSegments=3).eval().toNumpy(),
        [2.0, 9.0, 12.0])


SEG_DATA = np.array([[1.0, -2.0], [3.0, 3.0], [3.0, 0.5], [-1.0, 2.0],
                     [0.5, 0.5], [2.0, -4.0]], np.float32)
SEG_IDS = np.array([0, 2, 2, 0, 5, 9], np.int32)   # 1, 3, 4 empty; 9 dropped


@pytest.mark.parametrize("op", ["segmentSum", "segmentMax", "segmentMin",
                                "segmentMean", "segmentProd"])
def test_segment_op_empty_ties_dropped_and_gradient(op):
    """Empty segments at the reducer's identity (0, -inf, +inf, 0 for the
    mean, 1), an out-of-range id dropped, ties in max/min splitting the
    gradient as the reference's: all against the reference."""
    # the reference has no gradient of a product over repeated ids
    # (scatter_mul); the port's is checked against d/dx_i = prod / x_i
    wrt = () if op == "segmentProd" else ("x",)
    res = both(lambda sd: getattr(sd.math, op)(
        sd.var("x", SEG_DATA), sd.constant(SEG_IDS), numSegments=6),
        wrt=wrt)
    check(res)
    if op == "segmentProd":
        x = torch.tensor(SEG_DATA, requires_grad=True)
        out = OPS[op](x, torch.tensor(SEG_IDS), numSegments=6)
        r = torch.tensor(rnd(6, 2, seed=6))
        (g,) = torch.autograd.grad((out * r).sum(), x)
        rows = torch.tensor(SEG_IDS).long()
        keep = rows < 6
        want = torch.zeros_like(x)
        want[keep] = (out[rows[keep]] * r[rows[keep]]) / x[keep]
        np.testing.assert_allclose(g.numpy(), want.detach().numpy(),
                                   rtol=1e-6)


def test_segment_needs_num_segments():
    sd = psd()
    v = sd.math.segmentSum(sd.constant(np.ones(3)),
                           sd.constant(np.array([0, 1, 1])))
    with pytest.raises(ValueError, match="numSegments"):
        v.eval()


# ----------------------------------------------------------------------
# the block ops and the linalg tail (TestBlockOpsAndLinalgTail)
# ----------------------------------------------------------------------

def test_space_depth_batch_roundtrips():
    rs = np.random.RandomState(0)
    sd = psd()
    x = sd.constant(rs.rand(2, 4, 4, 3))
    rt = sd.image.depthToSpace(sd.image.spaceToDepth(x, 2), 2, name="a")
    np.testing.assert_allclose(rt.eval().toNumpy(), x.eval().toNumpy())
    bt = sd.image.batchToSpace(sd.image.spaceToBatch(x, 2), 2, name="b")
    np.testing.assert_allclose(bt.eval().toNumpy(), x.eval().toNumpy())
    assert sd.image.spaceToDepth(x, 2, name="c").eval().shape() == \
        (2, 2, 2, 12)
    assert sd.image.spaceToBatch(x, 2, name="d").eval().shape() == \
        (8, 2, 2, 3)


def test_space_to_batch_padding_and_crops():
    rs = np.random.RandomState(1)
    sd = psd()
    x = sd.constant(rs.rand(1, 2, 2, 1))
    padded = sd.image.spaceToBatch(x, 2, padding=((1, 1), (1, 1)), name="p")
    assert padded.eval().shape() == (4, 2, 2, 1)
    back = sd.image.batchToSpace(padded, 2, crops=((1, 1), (1, 1)), name="q")
    np.testing.assert_allclose(back.eval().toNumpy(), x.eval().toNumpy())
    bad = sd.image.batchToSpace(sd.constant(np.ones((3, 2, 2, 1))), 2)
    with pytest.raises(ValueError, match="divisible"):
        bad.eval()


def test_lu_and_eigh_reconstruct():
    rs = np.random.RandomState(2)
    A = rs.rand(4, 4)
    for pkg in ("j", "p"):
        sd = JSD.create() if pkg == "j" else psd()
        p, l, u = sd.linalg.lu(sd.constant(A))
        np.testing.assert_allclose(p.eval().toNumpy() @ l.eval().toNumpy()
                                   @ u.eval().toNumpy(), A, atol=1e-6)
        S = A + A.T
        w, v = sd.linalg.eigh(sd.constant(S))
        V = v.eval().toNumpy()
        np.testing.assert_allclose(V @ np.diag(w.eval().toNumpy()) @ V.T, S,
                                   atol=1e-5)


SPD = (lambda m: m @ m.T + 4 * np.eye(4))(rnd(4, 4, seed=40)).astype(
    np.float32)
RHS = rnd(4, 2, seed=41)

LINALG_CASES = {
    # name: (build, compare factors exactly as values?)
    "cholesky": lambda sd: sd.linalg.cholesky(sd.var("x", SPD)),
    "inv": lambda sd: sd.linalg.inv(sd.var("x", SPD)),
    "det": lambda sd: sd.linalg.det(sd.var("x", SPD)),
    "solve": lambda sd: sd.linalg.solve(sd.var("x", SPD), sd.constant(RHS)),
    "lstsq_tall": lambda sd: sd.linalg.lstsq(sd.var("x", rnd(6, 3, seed=42)),
                                             sd.constant(rnd(6, 2, seed=43))),
    "lu": lambda sd: sd.linalg.lu(sd.var("x", rnd(4, 4, seed=44)))[2],
    "eigh_values": lambda sd: sd.linalg.eigh(sd.var("x", SPD))[0],
    "svd_values": lambda sd: sd.linalg.svd(sd.var("x", rnd(5, 3, seed=45)))[1],
    "qr_r": lambda sd: sd.linalg.qr(sd.var("x", rnd(5, 3, seed=46)))[1],
    "trace": lambda sd: sd.linalg.trace(sd.var("x", SPD)),
}


@pytest.mark.parametrize("name", sorted(LINALG_CASES))
def test_linalg_op_matches_reference(name):
    # the CPU runs LAPACK in both packages: factors agree, signs too
    check(both(LINALG_CASES[name], wrt=("x",)), rtol=1e-4, atol=1e-5,
          grad_rel=1e-3)


def test_svd_qr_eigh_factors_and_invariants():
    A = rnd(5, 3, seed=47).astype(np.float64)
    for full in (False, True):
        res = both(lambda sd: sd.linalg.svd(sd.constant(A), fullUV=full))
        (_, jv, _), (_, pv, _) = res["j"], res["p"]
        u, s, vh = pv
        assert [t.shape for t in pv] == [t.shape for t in jv]
        np.testing.assert_allclose(s, jv[1], rtol=1e-10)
        k = len(s)
        np.testing.assert_allclose(u[:, :k] * s @ vh[:k], A, atol=1e-12)
        # sign per singular pair: u_i s_i vh_i is sign-free
        for i in range(k):
            np.testing.assert_allclose(np.outer(u[:, i], vh[i]),
                                       np.outer(jv[0][:, i], jv[2][i]),
                                       atol=1e-10)
    res = both(lambda sd: sd.linalg.qr(sd.constant(A)))
    q, r = res["p"][1]
    np.testing.assert_allclose(q @ r, A, atol=1e-12)
    np.testing.assert_allclose(np.abs(r), np.abs(res["j"][1][1]), atol=1e-12)
    S = A.T @ A
    res = both(lambda sd: sd.linalg.eigh(sd.constant(S)))
    w, v = res["p"][1]
    np.testing.assert_allclose(w, res["j"][1][0], rtol=1e-10)
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, S, atol=1e-10)


def test_lstsq_rank_deficient_is_the_minimum_norm_solution():
    """torch's CUDA lstsq (gels) assumes full rank; the port takes the
    SVD route the reference's jnp.linalg.lstsq takes."""
    rs = np.random.RandomState(5)
    A = rs.randn(6, 2) @ rs.randn(2, 4)         # rank 2 of 4 columns
    Bv = rs.randn(6, 3)
    res = both(lambda sd: sd.linalg.lstsq(sd.constant(A), sd.constant(Bv)))
    got, want = res["p"][1][0], res["j"][1][0]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.pinv(A) @ Bv, atol=1e-10)
    vec = both(lambda sd: sd.linalg.lstsq(sd.constant(A),
                                          sd.constant(Bv[:, 0])))
    np.testing.assert_allclose(vec["p"][1][0], vec["j"][1][0], atol=1e-10)


# ----------------------------------------------------------------------
# fft (the reference's TestFFTOps)
# ----------------------------------------------------------------------

def _close_max_abs(got, want, frac=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.abs(got - want).max() <= frac * max(np.abs(want).max(), 1e-30)


FFT_X = rnd(4, 16, seed=50)

FFT_CASES = {
    "fft": lambda sd: sd.fft.fft(sd.constant(FFT_X)),
    "fft_n_dim0": lambda sd: sd.fft.fft(sd.constant(FFT_X), numPoints=6,
                                        dimension=0),
    "ifft": lambda sd: sd.fft.ifft(sd.fft.fft(sd.constant(FFT_X))),
    "rfft": lambda sd: sd.fft.rfft(sd.constant(FFT_X), numPoints=20),
    "irfft": lambda sd: sd.fft.irfft(sd.fft.rfft(sd.constant(FFT_X)),
                                     numPoints=16),
    "fft2": lambda sd: sd.fft.fft2(sd.constant(FFT_X)),
    "ifft2": lambda sd: sd.fft.ifft2(sd.constant(FFT_X)),
    "parts": lambda sd: tuple(getattr(sd.fft, p)(sd.fft.fft(sd.constant(
        FFT_X))) for p in ("real", "imag", "conj", "angle")),
    "toComplex": lambda sd: sd.fft.toComplex(sd.constant(FFT_X),
                                             sd.constant(FFT_X * 2)),
}


@pytest.mark.parametrize("name", sorted(FFT_CASES))
def test_fft_op_matches_reference(name):
    res = both(FFT_CASES[name])
    for got, want in zip(res["p"][1], res["j"][1]):
        assert got.shape == want.shape
        _close_max_abs(got, want)


def test_fft_ifft_roundtrip_oracle():
    xv = np.random.RandomState(0).randn(4, 16)
    sd = psd()
    x = sd.constant(xv, name="x")
    spec = sd.fft.fft(x, name="spec")
    back = sd.fft.real(sd.fft.ifft(spec), name="back")
    got = spec.eval()
    assert str(got.dataType()) == "DataType.COMPLEX128"
    np.testing.assert_allclose(got.toNumpy(), np.fft.fft(xv, axis=-1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(back.eval().toNumpy(), xv, rtol=1e-4,
                               atol=1e-4)


def test_rfft_irfft_numpoints_dimension():
    xv = np.random.RandomState(1).randn(8, 10)
    sd = psd()
    x = sd.constant(xv)
    r = sd.fft.rfft(x, numPoints=16, dimension=0)
    np.testing.assert_allclose(r.eval().toNumpy(),
                               np.fft.rfft(xv, n=16, axis=0), rtol=1e-4,
                               atol=1e-4)
    back = sd.fft.irfft(sd.fft.rfft(x), dimension=-1)
    np.testing.assert_allclose(back.eval().toNumpy(), xv, rtol=1e-4,
                               atol=1e-4)


def test_fft2_and_complex_parts():
    xv = np.random.RandomState(2).randn(6, 8)
    sd = psd()
    s = sd.fft.fft2(sd.constant(xv))
    oracle = np.fft.fft2(xv)
    np.testing.assert_allclose(sd.fft.real(s).eval().toNumpy(), oracle.real,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sd.fft.imag(s).eval().toNumpy(), oracle.imag,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sd.fft.angle(s).eval().toNumpy(),
                               np.angle(oracle), rtol=1e-4, atol=1e-4)
    rt = sd.fft.real(sd.fft.ifft2(s))
    np.testing.assert_allclose(rt.eval().toNumpy(), xv, rtol=1e-4, atol=1e-4)


def test_toComplex_conj():
    sd = psd()
    z = sd.fft.toComplex(sd.constant(np.array([1.0, 2.0])),
                         sd.constant(np.array([3.0, -4.0])))
    np.testing.assert_allclose(
        sd.fft.imag(sd.fft.conj(z)).eval().toNumpy(), [-3.0, 4.0])


def test_gradient_through_power_spectrum():
    xv = np.random.RandomState(3).randn(12)

    def build(sd):
        spec = sd.fft.rfft(sd.var("x", xv))
        return sd.math.sum(sd.math.square(sd.fft.real(spec))
                           + sd.math.square(sd.fft.imag(spec)),
                           name="power")

    got = {}
    for pkg in ("j", "p"):
        sd = JSD.create() if pkg == "j" else psd()
        build(sd)
        sd.setLossVariables("power")
        got[pkg] = sd.calculateGradients(None, "x")["x"].toNumpy()
    np.testing.assert_allclose(got["p"], got["j"], rtol=1e-9, atol=1e-9)


def test_fft_graph_serializes(tmp_path):
    """A graph with fft ops saves and loads, in both directions, and a
    complex constant stays complex in arrays.npz."""
    xv = np.random.RandomState(4).randn(4, 8).astype(np.float32)
    zc = (xv[0] + 1j * xv[1]).astype(np.complex64)
    for src_pkg in ("p", "j"):
        sd = psd() if src_pkg == "p" else JSD.create()
        x = sd.placeHolder("x", "float32", 4, 8)
        sd.math.sum(sd.math.square(sd.fft.real(sd.fft.rfft(x))), name="mag")
        sd.fft.real(sd.math.mul(sd.fft.fft(x), sd.constant(zc, name="zc")),
                    name="mixed")
        before = sd.output({"x": xv}, ["mag", "mixed"])
        p = str(tmp_path / f"fft_{src_pkg}.sdz")
        sd.save(p)
        with zipfile.ZipFile(p) as z:
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            assert npz["zc"].dtype == np.complex64
        back = (JSD.load(p) if src_pkg == "p"
                else SameDiff.load(p, device=CPU))
        after = back.output({"x": xv}, ["mag", "mixed"])
        for n in ("mag", "mixed"):
            np.testing.assert_allclose(after[n].toNumpy(),
                                       before[n].toNumpy(), rtol=1e-5)


# ----------------------------------------------------------------------
# bitwise
# ----------------------------------------------------------------------

BITS = {"a": np.array([[0, 1, 5, -8], [127, -128, 33, 7]], np.int32),
        "s": np.array([[0, 1, 2, 3], [4, 1, 31, 0]], np.int32)}


@pytest.mark.parametrize("op", ["leftShift", "rightShift", "bitwiseAnd",
                                "bitwiseOr", "bitwiseXor"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8"])
def test_bitwise_matches_reference(op, dtype):
    a = BITS["a"].astype(dtype)
    s = BITS["s"].astype(dtype) if op.endswith("Shift") else \
        BITS["s"].astype(dtype) * 3
    res = both(lambda sd: getattr(sd.bitwise, op)(sd.constant(a),
                                                  sd.constant(s)))
    check(res, exact=True)
    assert res["p"][1][0].dtype == np.dtype(dtype)


@pytest.mark.parametrize("dtype,wide", [("uint16", np.int64),
                                        ("uint32", np.int64)])
def test_bitwise_unsigned_widen_exactly(dtype, wide):
    """uint16/uint32 run widened (int32/int64) and come back wrapped to
    their width: exactly numpy's modular results, in the input dtype."""
    info = np.iinfo(dtype)
    a = np.array([0, 1, info.max, info.max // 3, 2 ** (info.bits - 1)],
                 dtype)
    s = np.array([0, 3, 1, info.bits - 1, 2], dtype)
    mask = int(info.max)
    want = {
        "shiftLeft": (a.astype(wide) << s.astype(wide)) & mask,
        "shiftRight": a.astype(wide) >> s.astype(wide),
        "bitwiseAnd": a & s, "bitwiseOr": a | s, "bitwiseXor": a ^ s,
    }
    for op, w in want.items():
        got = OPS[op](torch.from_numpy(a), torch.from_numpy(s))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                      np.asarray(w).astype(np.uint64), op)
    got = OPS["bitwiseNot"](torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), ~a)


def test_bitwise_uint64_keeps_bit_ops_and_refuses_shifts():
    a = np.array([0, 1, 2 ** 64 - 1, 2 ** 63 + 5], np.uint64)
    b = np.array([7, 2 ** 63, 12345, 2 ** 64 - 2], np.uint64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for op, fn in (("bitwiseAnd", np.bitwise_and),
                   ("bitwiseOr", np.bitwise_or),
                   ("bitwiseXor", np.bitwise_xor)):
        got = OPS[op](ta, tb)
        assert got.dtype == torch.uint64
        np.testing.assert_array_equal(got.numpy(), fn(a, b))
    np.testing.assert_array_equal(OPS["bitwiseNot"](ta).numpy(), ~a)
    for op in ("shiftLeft", "shiftRight"):
        with pytest.raises(TypeError, match="uint64"):
            OPS[op](ta, tb)


def test_bitwise_not_matches_reference():
    a = BITS["a"]
    res = both(lambda sd: sd._op("bitwiseNot", [sd.constant(a)]))
    check(res, exact=True)


# ----------------------------------------------------------------------
# updater state in model files, across both packages
# ----------------------------------------------------------------------

def _cf_graph(pkg):
    """A graph with an ifCond, a bounded whileLoop and fft ops, trained
    by Adam: its file carries recorded bodies and updater state."""
    rs = np.random.RandomState(8)
    sd = JSD.create() if pkg == "j" else psd()
    x = sd.placeHolder("x", "float32", 8, 6)
    y = sd.placeHolder("y", "float32", 8, 6)
    w = sd.var("w", (rs.randn(6, 6) * 0.3).astype(np.float32))
    g = sd.var("g", np.float32(0.9))
    h = sd.math.tanh(sd.linalg.mmul(x, w))
    h = sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(np.float32(-1e9))),
                  lambda s, a: s.math.mul(a, s.constant(np.float32(1.5))),
                  lambda s, a: a, inputs=[h], name="branch")
    c0 = sd.constant(np.float32(0.0), name="c0")
    h, _, _ = sd.whileLoop(lambda s, a, c, gg: s.math.lt(
        c, s.constant(np.float32(2.0))),
        lambda s, a, c, gg: (s.math.mul(a, gg),
                             c + s.constant(np.float32(1.0)), gg),
        [h, c0, g], maxIterations=3, name="loop")
    spec = sd.fft.rfft(h)
    mag = sd.math.add(sd.math.square(sd.fft.real(spec)),
                      sd.math.square(sd.fft.imag(spec)))
    p = sd.math.add(h, sd.math.mean(mag, 1, keepDims=True) * 0.01,
                    name="pred")
    sd.loss.meanSquaredError(y, p, name="loss")
    tc, upd = (JTC, jupd.Adam) if pkg == "j" else (TrainingConfig, tupd.Adam)
    sd.setTrainingConfig(tc.Builder().updater(upd(learningRate=0.01))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd, tc, upd


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_updater_state_crosses_packages(tmp_path, direction):
    """Either package trains 3 steps and saves with its updater state;
    the other loads it with loadUpdaterState, and its next two steps
    agree with the saver's own (f32 band: loss rtol 1e-5, weights 1e-5
    of their max-abs). Without the state the next step differs."""
    rs = np.random.RandomState(9)
    X = rs.randn(8, 6).astype(np.float32)
    Y = rs.randn(8, 6).astype(np.float32)
    src_pkg, dst_pkg = ("j", "p") if direction == "reference_to_port" \
        else ("p", "j")
    src, _, _ = _cf_graph(src_pkg)
    src.fit(features=X, labels=Y, epochs=3)
    path = str(tmp_path / "cf.zip")
    src.save(path, saveUpdaterState=True)
    with zipfile.ZipFile(path) as z:
        assert "updater.npz" in z.namelist()
        names = np.load(io.BytesIO(z.read("arrays.npz"))).files
        assert any(n.startswith("__body__/") for n in names)
        json.loads(z.read("graph.json"))
    _, dtc, dupd = _cf_graph(dst_pkg)
    load = JSD.load if dst_pkg == "j" else \
        (lambda p, **kw: SameDiff.load(p, device=CPU, **kw))
    dst = load(path, loadUpdaterState=True)
    dst.setTrainingConfig(dtc.Builder().updater(dupd(learningRate=0.01))
                          .dataSetFeatureMapping("x")
                          .dataSetLabelMapping("y").build())
    fresh = load(path)
    fresh.setTrainingConfig(dtc.Builder().updater(dupd(learningRate=0.01))
                            .dataSetFeatureMapping("x")
                            .dataSetLabelMapping("y").build())
    want = src.fit(features=X, labels=Y, epochs=2)
    got = dst.fit(features=X, labels=Y, epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in ("w", "g"):
        a = dst.getVariable(n).getArr().toNumpy()
        b = src.getVariable(n).getArr().toNumpy()
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), n
    assert dst._iteration == src._iteration == 5
    other = fresh.fit(features=X, labels=Y, epochs=2)
    assert abs(other[1] - want[1]) > 1e-6 * abs(want[1])


# ----------------------------------------------------------------------
# the rest of TestMathLongTail, TestLossLongTail and TestAdamW
# ----------------------------------------------------------------------

def test_distances():
    rs = np.random.RandomState(0)
    a, b = rs.rand(4, 6), rs.rand(4, 6)
    sd = psd()
    x, y = sd.constant(a), sd.constant(b)
    np.testing.assert_allclose(
        sd.math.cosineSimilarity(x, y, 1).eval().toNumpy(),
        np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1)), rtol=1e-6)
    np.testing.assert_allclose(
        sd.math.euclideanDistance(x, y, 1).eval().toNumpy(),
        np.linalg.norm(a - b, axis=1), rtol=1e-6)
    np.testing.assert_allclose(
        sd.math.manhattanDistance(x, y, 1).eval().toNumpy(),
        np.abs(a - b).sum(1), rtol=1e-6)
    np.testing.assert_allclose(
        sd.math.cosineDistance(x, y, 1).eval().toNumpy(),
        1 - sd.math.cosineSimilarity(x, y, 1).eval().toNumpy(), rtol=1e-6)
    np.testing.assert_allclose(
        sd.math.jaccardDistance(x, y, 1).eval().toNumpy(),
        1 - np.minimum(a, b).sum(1) / np.maximum(a, b).sum(1), rtol=1e-6)
    ai, bi = (a > 0.5).astype(float), (b > 0.5).astype(float)
    np.testing.assert_allclose(
        sd.math.hammingDistance(sd.constant(ai), sd.constant(bi),
                                1).eval().toNumpy(), (ai != bi).sum(1))


def test_confusion_and_counts():
    sd = psd()
    cm = sd.math.confusionMatrix(sd.constant(np.array([0, 1, 1, 2])),
                                 sd.constant(np.array([0, 1, 0, 2])),
                                 numClasses=3).eval().toNumpy()
    np.testing.assert_array_equal(cm, [[1, 0, 0], [1, 1, 0], [0, 0, 1]])
    x = sd.constant(np.array([[0.0, 1.0, 0.0], [2.0, 0.0, 3.0]]))
    assert float(sd.math.zeroFraction(x).eval().toNumpy()) == 0.5
    np.testing.assert_array_equal(
        sd.math.countNonZero(x, 1).eval().toNumpy(), [1, 2])
    np.testing.assert_array_equal(
        sd.math.countZero(x, 1).eval().toNumpy(), [2, 1])
    assert float(sd.math.matchConditionCount(
        x, "gt", 0.5).eval().toNumpy()) == 3


def test_entropy_iamax_creation():
    p = np.array([0.5, 0.25, 0.25, 0.0])
    sd = psd()
    x = sd.constant(p)
    np.testing.assert_allclose(sd.math.shannonEntropy(x).eval().toNumpy(),
                               1.5, rtol=1e-6)
    np.testing.assert_allclose(sd.math.entropy(x).eval().toNumpy(),
                               -(p[p > 0] * np.log(p[p > 0])).sum(),
                               rtol=1e-6)
    assert int(sd.math.iamax(sd.constant(
        np.array([1.0, -7.0, 3.0]))).eval().toNumpy()) == 1
    np.testing.assert_allclose(sd.math.linspace(0, 1, 5).eval().toNumpy(),
                               np.linspace(0, 1, 5))
    np.testing.assert_array_equal(
        sd.math.range(2, 10, 3, dtype="int32").eval().toNumpy(), [2, 5, 8])
    gx, gy = sd.math.meshgrid(sd.constant(np.arange(2.0)),
                              sd.constant(np.arange(3.0)))
    assert gx.eval().shape() == (3, 2) and gy.eval().shape() == (3, 2)


def test_sigmoid_and_weighted_ce_match_torch():
    import torch.nn.functional as F

    rs = np.random.RandomState(0)
    lab = (rs.rand(6, 3) > 0.5).astype("float32")
    log = rs.randn(6, 3).astype("float32")
    w = np.array([0.5, 2.0, 3.0], "float32")
    sd = psd()
    v = sd.loss.sigmoidCrossEntropy(sd.constant(lab), sd.constant(log),
                                    name="l")
    np.testing.assert_allclose(float(v.eval().toNumpy()), float(
        F.binary_cross_entropy_with_logits(torch.tensor(log),
                                           torch.tensor(lab))), rtol=1e-5)
    v = sd.loss.weightedCrossEntropyWithLogits(
        sd.constant(lab), sd.constant(log), sd.constant(w), name="lw")
    np.testing.assert_allclose(float(v.eval().toNumpy()), float(
        F.binary_cross_entropy_with_logits(
            torch.tensor(log), torch.tensor(lab),
            pos_weight=torch.tensor(w))), rtol=1e-5)


def test_l2_and_pairwise():
    rs = np.random.RandomState(2)
    x = rs.randn(3, 4)
    sd = psd()
    np.testing.assert_allclose(
        float(sd.loss.l2Loss(sd.constant(x), name="a").eval().toNumpy()),
        np.sum(x ** 2) / 2, rtol=1e-6)
    lab, pred = rs.randn(3, 4), rs.randn(3, 4)
    v = sd.loss.meanPairwiseSquaredError(sd.constant(lab),
                                         sd.constant(pred), name="b")
    d = pred - lab
    per = [sum((d[k, i] - d[k, j]) ** 2 for i in range(4) for j in range(4))
           / 12 for k in range(3)]
    np.testing.assert_allclose(float(v.eval().toNumpy()), np.mean(per),
                               rtol=1e-6)
    v0 = sd.loss.meanPairwiseSquaredError(
        sd.constant(np.zeros((2, 4), "float32")),
        sd.constant(np.full((2, 4), 1e3, "float32")), name="c")
    assert float(v0.eval().toNumpy()) == 0.0


def test_distance_ops_finite_gradients_at_degenerate_points():
    for op, other in (("euclideanDistance", torch.zeros(3)),
                      ("cosineSimilarity", torch.ones(3))):
        x = torch.zeros(3, requires_grad=True)
        (g,) = torch.autograd.grad(OPS[op](x, other).sum(), x)
        assert torch.isfinite(g).all(), op


def test_adamw_decoupled_decay_equals_adam_plus_wd():
    rs = np.random.RandomState(0)
    p = {"W": torch.tensor(rs.randn(4, 3), dtype=torch.float32)}
    g = {"W": torch.tensor(rs.randn(4, 3), dtype=torch.float32)}
    a, w = tupd.Adam(1e-2), tupd.AdamW(1e-2, weightDecay=0.1)
    ua, _ = a.apply(g, a.init(p), 0, params=p)
    uw, _ = w.apply(g, w.init(p), 0, params=p)
    np.testing.assert_allclose(uw["W"].numpy(),
                               ua["W"].numpy() + 1e-2 * 0.1 * p["W"].numpy(),
                               rtol=1e-6)
