"""The port's SameDiff against the reference's (deeplearning4j_tpu_torch.
autodiff vs deeplearning4j_tpu.autodiff), on the CPU.

The same graph is built in both packages from the same numpy arrays
(explicit float32: tests/conftest.py turns x64 on) and held to the
reference:

* BASELINE config 2's graph (bench.py's SameDiff MLP: linear -> relu ->
  linear -> softmaxCrossEntropy, Adam) at a small size (B 16, 32 -> 16
  -> 4): output, calculateGradients and a 5-step fit trajectory. Loss
  rel 1e-5, gradients rel L2 1e-4.
* A 2-block attention graph (B 2, T 16, E 32, 4 heads) through
  ``multiHeadDotProductAttention`` with ``layerNorm`` and ``gelu``: the
  reference takes its CPU dispatch, the port the flash kernels' plain
  versions (counted). Same tolerances.
* Every ported op family, op by op (values within rtol 1e-5; integer and
  index results exactly), l1/l2/weightDecay, name scopes and rename,
  multi-output ops.
* Cross-loading both ways: the reference saves and the port loads, the
  port saves and the reference loads, with equal outputs (rtol 1e-6).
* Each feature that waits raises NotImplementedError naming its ROADMAP
  Queue 1 item; those of item 9 (the rest of SameDiff) run now, each
  checked on a small case (``tests/test_torch_samediff_namespaces.py``
  and ``test_torch_samediff_control.py`` hold them to the reference).

Dropout and the random ops are held to in-port reproducibility and to
their moments, never to the reference's draws.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff import SameDiff as JSD
from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import (
    SameDiff, TrainingConfig, VariableType,
)
from deeplearning4j_tpu_torch.ndarray import INDArray, Nd4j
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
CPU = "cpu"


def psd():
    return SameDiff.create(device=CPU)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ----------------------------------------------------------------------
# BASELINE config 2's graph at a small size
# ----------------------------------------------------------------------

B, F, H, O = 16, 32, 16, 4


def mlp_data():
    rs = np.random.RandomState(7)
    X = rs.rand(B, F).astype("float32")
    Y = np.eye(O, dtype="float32")[rs.randint(0, O, B)]
    W1 = (rs.randn(F, H) * 0.05).astype("float32")
    W2 = (rs.randn(H, O) * 0.05).astype("float32")
    return X, Y, W1, W2


def build_mlp(pkg, W1, W2, l1=0.0, l2=0.0, wd=0.0, lr=1e-3):
    """bench.py's bench_samediff_mlp graph in `pkg` ("j" or "p")."""
    if pkg == "j":
        sd, dt, tc, upd = JSD.create(), jnp.float32, JTC, jupd.Adam
    else:
        sd, dt, tc, upd = psd(), torch.float32, TrainingConfig, tupd.Adam
    x = sd.placeHolder("x", dt, B, F)
    y = sd.placeHolder("y", dt, B, O)
    w1 = sd.var("w1", W1)
    b1 = sd.var("b1", np.zeros(H, dtype="float32"))
    w2 = sd.var("w2", W2)
    b2 = sd.var("b2", np.zeros(O, dtype="float32"))
    h = sd.nn.relu(sd.nn.linear(x, w1, b1), name="h")
    logits = sd.nn.linear(h, w2, b2, name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(tc.Builder().updater(upd(learningRate=lr))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y")
                         .l1(l1).l2(l2).weightDecay(wd).build())
    return sd


@pytest.fixture(scope="module")
def mlp_pair():
    X, Y, W1, W2 = mlp_data()
    return X, Y, build_mlp("j", W1, W2), build_mlp("p", W1, W2)


def test_mlp_output_matches(mlp_pair):
    X, Y, j, p = mlp_pair
    for name in ("h", "logits", "loss"):
        jo = j.output({"x": X, "y": Y}, [name])[name].toNumpy()
        po = p.output({"x": X, "y": Y}, [name])[name]
        assert isinstance(po, INDArray)
        np.testing.assert_allclose(po.toNumpy(), jo, rtol=1e-5, atol=1e-7)


def test_mlp_gradients_match(mlp_pair):
    X, Y, j, p = mlp_pair
    wrt = ("w1", "b1", "w2", "b2", "x")
    jg = j.calculateGradients({"x": X, "y": Y}, *wrt)
    pg = p.calculateGradients({"x": X, "y": Y}, *wrt)
    assert set(pg) == set(wrt)
    for n in wrt:
        assert rel_l2(pg[n].toNumpy(), jg[n].toNumpy()) <= 1e-4, n
    np.testing.assert_allclose(p.grad("w2").eval({"x": X, "y": Y}).toNumpy(),
                               pg["w2"].toNumpy(), rtol=0, atol=0)


@pytest.mark.parametrize("reg", [dict(), dict(l2=1e-2), dict(l1=1e-3),
                                 dict(wd=1e-2), dict(l1=1e-3, l2=1e-3,
                                                     wd=5e-3)],
                         ids=["plain", "l2", "l1", "weightDecay", "all"])
def test_mlp_adam_fit_trajectory_matches(reg):
    X, Y, W1, W2 = mlp_data()
    j, p = build_mlp("j", W1, W2, **reg), build_mlp("p", W1, W2, **reg)
    jl = j.fit(features=X, labels=Y, epochs=5)
    pl = p.fit(features=X, labels=Y, epochs=5)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[-1] < pl[0]
    assert p._iteration == 5
    for n in ("w1", "b1", "w2", "b2"):
        got = p.getVariable(n).getArr().toNumpy()
        want = j.getVariable(n).getArr().toNumpy()
        assert rel_l2(got, want) <= 1e-4, n


def test_fit_forms_and_fitsteps():
    X, Y, W1, W2 = mlp_data()
    a, b, c = (build_mlp("p", W1, W2) for _ in range(3))
    la = a.fit(features=X, labels=Y, epochs=3)
    lb = b.fit(data=[(X, Y)] * 3)
    assert la == lb
    from deeplearning4j_tpu_torch.data import DataSet
    assert c.fit(DataSet(X, Y), epochs=2) == la[:2]
    assert c.fitSteps(X, Y, numSteps=1) == la[2]
    d = build_mlp("p", W1, W2)
    assert d.fitSteps(X, Y, numSteps=3) == la[2]
    assert d._iteration == 3
    with pytest.raises(ValueError, match="feature array"):
        d.fit(data=[((X, X), Y)])


def test_graph_owns_its_arrays():
    X, Y, W1, W2 = mlp_data()
    w = Nd4j.create(W1, device=CPU)
    sd = psd()
    v = sd.var("w", w)
    held = v.getArr()
    x = sd.placeHolder("x", torch.float32, B, F)
    sd.loss.meanSquaredError(sd.constant(np.zeros((B, H), "f4")),
                             sd.nn.linear(x, v), name="l")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(tupd.Sgd(0.5))
                         .dataSetFeatureMapping("x").build())
    sd.fit(features=X, labels=None)
    np.testing.assert_array_equal(w.toNumpy(), W1)       # the input
    np.testing.assert_array_equal(held.toNumpy(), W1)    # an earlier read
    assert not np.array_equal(v.getArr().toNumpy(), W1)  # the variable
    out = sd.output({}, ["w"])["w"]
    out.addi(100.0)
    assert not np.array_equal(v.getArr().toNumpy(), out.toNumpy())


# ----------------------------------------------------------------------
# a 2-block attention graph through multiHeadDotProductAttention
# ----------------------------------------------------------------------

AB, AT, AE, AH, BLOCKS = 2, 16, 32, 4, 2


def attn_arrays():
    rs = np.random.RandomState(11)
    arr = {"x": rs.randn(AB, AT, AE).astype("f4"),
           "y": np.eye(3, dtype="f4")[rs.randint(0, 3, AB)]}
    for i in range(BLOCKS):
        for n, shp in (("wq", (AE, AE)), ("wk", (AE, AE)), ("wv", (AE, AE)),
                       ("wo", (AE, AE)), ("w1", (AE, 2 * AE)),
                       ("w2", (2 * AE, AE))):
            arr[f"{n}{i}"] = (rs.randn(*shp) * 0.2).astype("f4")
        arr[f"b1{i}"] = (rs.randn(2 * AE) * 0.1).astype("f4")
        arr[f"b2{i}"] = (rs.randn(AE) * 0.1).astype("f4")
        arr[f"g{i}"] = (1 + 0.1 * rs.randn(AE)).astype("f4")
        arr[f"be{i}"] = (0.1 * rs.randn(AE)).astype("f4")
    arr["wout"] = (rs.randn(AE, 3) * 0.2).astype("f4")
    arr["bout"] = np.zeros(3, "f4")
    return arr


def build_attn(pkg, arr):
    if pkg == "j":
        sd, dt, tc, upd = JSD.create(), jnp.float32, JTC, jupd.Adam
    else:
        sd, dt, tc, upd = psd(), torch.float32, TrainingConfig, tupd.Adam
    h = sd.placeHolder("x", dt, AB, AT, AE)
    y = sd.placeHolder("y", dt, AB, 3)
    v = {n: sd.var(n, a) for n, a in arr.items() if n not in ("x", "y")}
    for i in range(BLOCKS):
        ln = sd.nn.layerNorm(h, v[f"g{i}"], v[f"be{i}"], name=f"ln{i}")
        a = sd.nn.multiHeadDotProductAttention(
            ln, v[f"wq{i}"], v[f"wk{i}"], v[f"wv{i}"], v[f"wo{i}"], AH,
            name=f"attn{i}")
        h = h + a
        f = sd.nn.gelu(sd.nn.linear(h, v[f"w1{i}"], v[f"b1{i}"]))
        h = h + sd.nn.linear(f, v[f"w2{i}"], v[f"b2{i}"])
    logits = sd.nn.linear(h.mean(1), v["wout"], v["bout"], name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(tc.Builder().updater(upd(learningRate=1e-3))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd


def test_attention_graph_output_gradients_and_fit():
    arr = attn_arrays()
    j, p = build_attn("j", arr), build_attn("p", arr)
    feed = {"x": arr["x"], "y": arr["y"]}
    tfa.reset_launches()
    po = p.output(feed, ["logits", "loss"])
    assert tfa.flash_fwd_plain.launches == BLOCKS   # the port's route
    jo = j.output(feed, ["logits", "loss"])
    np.testing.assert_allclose(po["logits"].toNumpy(),
                               jo["logits"].toNumpy(), rtol=1e-5, atol=1e-6)
    jl, pl = float(jo["loss"].toNumpy()), float(po["loss"].toNumpy())
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    wrt = [n for n in arr if n != "y"]
    tfa.reset_launches()
    pg = p.calculateGradients(feed, *wrt)
    assert tfa.flash_bwd_dq_plain.launches == BLOCKS
    assert tfa.flash_bwd_dkv_plain.launches == BLOCKS
    jg = j.calculateGradients(feed, *wrt)
    for n in wrt:
        assert rel_l2(pg[n].toNumpy(), jg[n].toNumpy()) <= 1e-4, n
    jh = j.fit(features=arr["x"], labels=arr["y"], epochs=5)
    ph = p.fit(features=arr["x"], labels=arr["y"], epochs=5)
    np.testing.assert_allclose(ph, jh, rtol=1e-5, atol=0)


# ----------------------------------------------------------------------
# op families, op by op
# ----------------------------------------------------------------------

XA = f32(3, 4, seed=1)
YA = f32(3, 4, seed=2)
PA = (np.abs(f32(3, 4, seed=3)) + 0.2).astype("f4")
PROB = (np.abs(f32(3, 4, seed=4)) / 4 + 0.1).astype("f4")
LAB = np.eye(4, dtype="f4")[[0, 2, 3]]

OP_CASES = {
    # math, elementwise
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.math, n)(x))(n)
       for n in ("neg abs sign exp expm1 square floor ceil round sin cos tan "
                 "atan sinh cosh tanh asinh erf erfc isnan isfinite").split()},
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.math, n)(p))(n)
       for n in ("log log1p log2 sqrt reciprocal rsqrt lgamma digamma "
                 "acosh").split()},
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.math, n)(x, y))(n)
       for n in ("add sub mul div atan2 squaredDifference maximum minimum "
                 "floordiv mod eq neq gt gte lt lte").split()},
    "pow": lambda sd, x, y, p: sd.math.pow(p, y),
    "igamma": lambda sd, x, y, p: sd.math.igamma(p, p + 0.5),
    "zeta": lambda sd, x, y, p: sd.math.zeta(p + 1.5, p),
    "logic": lambda sd, x, y, p: sd.math.xor(sd.math.gt(x, 0.0),
                                             sd.math.logicalNot(
                                                 sd.math.lt(y, 0.0))),
    "where": lambda sd, x, y, p: sd.math.where(sd.math.gt(x, y), x, y),
    # reductions
    **{n + "".join(map(str, d)): (lambda n, d: lambda sd, x, y, p:
                   getattr(sd.math, n)(x, *d))(n, d)
       for n in "sum mean prod max min std variance norm1 norm2 normmax"
       .split() for d in ((), (1,))},
    "sum_keep": lambda sd, x, y, p: sd.math.sum(x, 0, keepDims=True),
    "argmax": lambda sd, x, y, p: sd.math.argmax(x, 1),
    "argmin": lambda sd, x, y, p: sd.math.argmin(x, 0),
    "cumsum": lambda sd, x, y, p: sd.math.cumsum(x, 1, exclusive=True,
                                                 reverse=True),
    "cumprod": lambda sd, x, y, p: sd.math.cumprod(p, 1),
    "distances": lambda sd, x, y, p: sd.math.stack(
        0, sd.math.cosineSimilarity(x, y, 1),
        sd.math.euclideanDistance(x, y, 1),
        sd.math.manhattanDistance(x, y, 1),
        sd.math.jaccardDistance(p, p * 2.0, 1),
        sd.math.cosineDistance(x, y, 1)),
    "counts": lambda sd, x, y, p: sd.math.stack(
        0, sd.math.countNonZero(sd.math.floor(x), 1),
        sd.math.countZero(sd.math.floor(x), 1),
        sd.math.matchConditionCount(x, "gt", 0.0, 1)),
    "entropy": lambda sd, x, y, p: sd.math.stack(
        0, sd.math.entropy(p, 1), sd.math.shannonEntropy(p, 1)),
    "zeroFraction": lambda sd, x, y, p: sd.math.zeroFraction(
        sd.math.floor(x)),
    "iamax": lambda sd, x, y, p: sd.math.iamax(x, 1),
    "clip": lambda sd, x, y, p: sd.math.clipByValue(x, -0.5, 0.5),
    "clipByNorm": lambda sd, x, y, p: sd.math.clipByNorm(x, 1.0, 1),
    "sort": lambda sd, x, y, p: sd.math.sort(x, 1, descending=True),
    "topK": lambda sd, x, y, p: sd.math.topK(x, 2)[1],
    "topK_values": lambda sd, x, y, p: sd.math.topK(x, 3)[0],
    "confusion": lambda sd, x, y, p: sd.math.confusionMatrix(
        sd.math.argmax(x, 1), sd.math.argmax(y, 1), 4),
    "linspace": lambda sd, x, y, p: sd.math.linspace(0.0, 1.0, 7) + x.sum(),
    "range": lambda sd, x, y, p: sd.math.range(0, 6, 2),
    "meshgrid": lambda sd, x, y, p: sd.math.meshgrid(
        sd.math.range(0, 3, 1), sd.math.range(0, 2, 1))[1],
    # shape and index ops
    "reshape": lambda sd, x, y, p: sd.math.reshape(x, (4, 3)),
    "permute": lambda sd, x, y, p: sd.math.permute(
        sd.math.expandDims(x, 0), 2, 0, 1),
    "transpose": lambda sd, x, y, p: x.transpose(),
    "squeeze": lambda sd, x, y, p: sd.math.squeeze(
        sd.math.expandDims(x, 1), 1),
    "concat": lambda sd, x, y, p: sd.math.concat(1, x, y),
    "tile": lambda sd, x, y, p: sd.math.tile(x, (2, 1)),
    "reverse": lambda sd, x, y, p: sd.math.reverse(x, 1),
    "gather": lambda sd, x, y, p: sd.math.gather(
        x, sd.constant(np.array([2, 0, 2], np.int32)), 1),
    "onehot": lambda sd, x, y, p: sd.math.oneHot(
        sd.constant(np.array([1, 0, 3], np.int32)), 4, on=2.0, off=-1.0),
    "scatterAdd": lambda sd, x, y, p: sd.math.scatterAdd(
        x, sd.constant(np.array([0, 0, 2], np.int32)), y),
    "scatterUpdate": lambda sd, x, y, p: sd.math.scatterUpdate(
        x, sd.constant(np.array([2], np.int32)), y.get(slice(0, 1))),
    "pad": lambda sd, x, y, p: sd.math.pad(x, ((1, 0), (0, 2)), 3.0),
    "cast": lambda sd, x, y, p: sd.math.cast(x, "int32"),
    "castTo": lambda sd, x, y, p: x.castTo("float64"),
    "get": lambda sd, x, y, p: x.get(1, slice(None, None, 2)),
    "identity": lambda sd, x, y, p: sd.math.identity(x),
    "dot": lambda sd, x, y, p: x.dot(y),
    # nn
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.nn, n)(x))(n)
       for n in ("relu relu6 sigmoid softplus softsign elu selu gelu swish "
                 "mish hardSigmoid hardTanh").split()},
    "leakyRelu": lambda sd, x, y, p: sd.nn.leakyRelu(x, 0.2),
    "softmax": lambda sd, x, y, p: sd.nn.softmax(x, 0),
    "logSoftmax": lambda sd, x, y, p: sd.nn.logSoftmax(x),
    "layerNorm": lambda sd, x, y, p: sd.nn.layerNorm(x, p.get(0), y.get(1)),
    "batchNorm": lambda sd, x, y, p: sd.nn.batchNorm(
        x, y.get(0), p.get(1), p.get(2), y.get(2)),
    "embedding": lambda sd, x, y, p: sd.nn.embeddingLookup(
        x, sd.constant(np.array([[2, 1], [0, 0]], np.int32))),
    "dpa": lambda sd, x, y, p: sd.nn.dotProductAttention(
        sd.math.reshape(x, (1, 1, 3, 4)), sd.math.reshape(y, (1, 1, 3, 4)),
        sd.math.reshape(p, (1, 1, 3, 4)), causal=True),
    "reluLayer": lambda sd, x, y, p: sd.nn.reluLayer(
        x, y.transpose(), p.get(0, slice(0, 3))),
    # losses
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.loss, n)(
        sd.constant(LAB), x))(n)
       for n in ("meanSquaredError absoluteDifference softmaxCrossEntropy "
                 "hingeLoss huberLoss meanPairwiseSquaredError "
                 "cosineDistance sigmoidCrossEntropy").split()},
    **{n: (lambda n: lambda sd, x, y, p: getattr(sd.loss, n)(
        sd.constant(PROB), p / 4.0))(n)
       for n in ("logLoss klDivergence poissonLoss").split()},
    "sparseSCE": lambda sd, x, y, p: sd.loss.sparseSoftmaxCrossEntropy(
        sd.constant(np.array([1, 3, 0], np.int32)), x),
    "weightedCE": lambda sd, x, y, p: sd.loss.weightedCrossEntropyWithLogits(
        sd.constant(LAB), x, p),
    "l2Loss": lambda sd, x, y, p: sd.loss.l2Loss(x),
    # linalg
    "mmul": lambda sd, x, y, p: sd.linalg.mmul(x, y, transposeB=True),
    "mmul_tA": lambda sd, x, y, p: sd.linalg.mmul(x, y, transposeA=True),
    "matmul": lambda sd, x, y, p: sd.linalg.matmul(
        sd.math.expandDims(x, 0), sd.math.expandDims(y.transpose(), 0)),
    "tensorMmul": lambda sd, x, y, p: sd.linalg.tensorMmul(x, y, [1], [1]),
    "trace": lambda sd, x, y, p: sd.linalg.trace(
        sd.linalg.mmul(x, y, transposeB=True)),
    "op_mmul": lambda sd, x, y, p: x @ y.transpose(),
}


def _run_case(sd, name, dt):
    x = sd.placeHolder("x", dt, 3, 4)
    y = sd.constant(YA, name="yc")
    p = sd.var("pv", PA)
    return OP_CASES[name](sd, x, y, p)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_reference(name):
    j, p = JSD.create(), psd()
    jo = _run_case(j, name, jnp.float32)
    po = _run_case(p, name, torch.float32)
    jv = j.output({"x": XA}, [jo.name])[jo.name].toNumpy()
    pv = p.output({"x": XA}, [po.name])[po.name].toNumpy()
    assert pv.shape == jv.shape
    if jv.dtype.kind in "biu":
        np.testing.assert_array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)
    assert po.name == jo.name     # the same naming scheme


GRAD_CASES = ["exp", "tanh", "mean1", "norm21", "prod", "cumsum",
              "distances", "layerNorm", "batchNorm", "softmax", "gelu",
              "mish", "huberLoss", "cosineDistance", "logLoss",
              "meanPairwiseSquaredError", "mmul", "tensorMmul", "gather",
              "scatterAdd", "pad", "get", "clipByNorm", "dpa"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_op_gradient_matches_reference(name):
    j, p = JSD.create(), psd()
    jo = _run_case(j, name, jnp.float32)
    po = _run_case(p, name, torch.float32)
    j.setLossVariables(jo.name)
    p.setLossVariables(po.name)
    jg = j.calculateGradients({"x": XA}, "x", "pv")
    pg = p.calculateGradients({"x": XA}, "x", "pv")
    for n in ("x", "pv"):
        want, got = jg[n].toNumpy(), pg[n].toNumpy()
        # a gradient that is 0 in exact arithmetic (softmax's sum, the
        # ratio in jaccardDistance) is rounding noise in both: held to
        # an absolute 1e-6 there
        assert rel_l2(got, want) <= 1e-4 or \
            np.abs(got - want).max() <= 1e-6, n


def test_multi_output_ops():
    for pkg in ("j", "p"):
        sd = JSD.create() if pkg == "j" else psd()
        x = sd.constant(np.arange(12.0, dtype="f4").reshape(3, 4), name="x")
        rows = sd.math.unstack(x, 0, 3)
        parts = sd.math.split(x, 2, 1)
        vals, idx = sd.math.topK(x, 2)
        assert len(rows) == 3 and len(parts) == 2
        out = sd.output({}, [rows[1], parts[1], idx])
        np.testing.assert_array_equal(out[rows[1].name].toNumpy(),
                                      [4, 5, 6, 7])
        np.testing.assert_array_equal(out[parts[1].name].toNumpy(),
                                      [[2, 3], [6, 7], [10, 11]])
        np.testing.assert_array_equal(out[idx.name].toNumpy(),
                                      [[3, 2]] * 3)


def test_name_scopes_rename_and_summary():
    sd = psd()
    x = sd.placeHolder("x", torch.float32, 2, 3)
    with sd.withNameScope("enc"):
        w = sd.var("w", 3, 4)
        h = sd.nn.relu(sd.math.mul(x, x), name="act")
        with sd.withNameScope("deep"):
            c = sd.constant(np.float32(2.0), "two")
    assert (w.name, h.name, c.name, x.name) == \
        ("enc/w", "enc/act", "enc/deep/two", "x")
    assert w.variableType == VariableType.VARIABLE
    assert tuple(w.getArr().shape()) == (3, 4)
    out = sd.getVariable("enc/act").eval({"x": np.ones((2, 3), "f4")})
    np.testing.assert_array_equal(out.toNumpy(), np.ones((2, 3)))
    e = sd.math.exp(sd.constant(np.ones(3, "f4"), name="a"), name="e")
    e.rename("expA")
    assert "expA" in sd.summary() and "enc/w" in sd.summary()
    np.testing.assert_allclose(sd.getVariable("expA").eval().toNumpy(),
                               np.e * np.ones(3), rtol=1e-6)
    assert e.shape == (3,)
    with pytest.raises(ValueError, match="already exists"):
        e.rename("x")
    with sd.withNameScope("a"):
        va = sd.var("w", np.ones((2, 2), "f4"))
    (va.sum() + 0.0).markAsLoss()
    np.testing.assert_array_equal(
        sd.calculateGradients({}, "a/w")["a/w"].toNumpy(), np.ones((2, 2)))


def test_shape_inference_without_data():
    sd = psd()
    x = sd.placeHolder("x", torch.float32, 5, 3)
    w = sd.var("w", np.ones((3, 7), "f4"))
    h = sd.nn.linear(x, w)
    assert h.shape == (5, 7)
    assert h.get(slice(1, 4), 2).shape == (3,)
    assert x.shape == (5, 3)


# ----------------------------------------------------------------------
# save / load across both packages
# ----------------------------------------------------------------------

def _scoped_graph(pkg):
    """A graph with a scoped variable, an int32 placeholder (gather) and
    a few kwarg-carrying ops, after 2 fit steps."""
    X, Y, W1, W2 = mlp_data()
    sd = build_mlp(pkg, W1, W2)
    dt = jnp.int32 if pkg == "j" else torch.int32
    ids = sd.placeHolder("ids", dt, 3)
    with sd.withNameScope("extra"):
        e = sd.var("emb", f32(5, 4, seed=9))
        g = sd.math.gather(e, ids, 0, name="rows")
        sd.math.cumsum(sd.nn.softmax(g, 0), 1, reverse=True, name="z")
    sd.fit(features=X, labels=Y, epochs=2)
    return sd


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_save_load_across_packages(tmp_path, direction):
    X, Y, _, _ = mlp_data()
    ids = np.array([4, 0, 2], np.int32)
    feed = {"x": X, "ids": ids}
    outs = ["logits", "h", "extra/z"]
    path = str(tmp_path / "g.zip")
    if direction == "reference_to_port":
        src = _scoped_graph("j")
        src.save(path)
        dst = SameDiff.load(path, device=CPU)
    else:
        src = _scoped_graph("p")
        src.save(path)
        dst = JSD.load(path)
    a, b = src.output(feed, outs), dst.output(feed, outs)
    for n in outs:
        np.testing.assert_allclose(b[n].toNumpy(), a[n].toNumpy(),
                                   rtol=1e-6, atol=1e-7)
    assert dst._iteration == src._iteration == 2
    assert list(dst._loss_vars) == list(src._loss_vars) == ["loss"]
    assert dst.getVariable("ids")._ph_shape == (3,)
    assert dst.getVariable("extra/emb").variableType == "VARIABLE"
    # the loaded graph trains on
    tc, upd = (TrainingConfig, tupd.Adam) if direction == \
        "reference_to_port" else (JTC, jupd.Adam)
    dst.setTrainingConfig(tc.Builder().updater(upd(learningRate=1e-3))
                          .dataSetFeatureMapping("x")
                          .dataSetLabelMapping("y").build())
    lb = dst.fit(features=X, labels=Y)
    assert np.isfinite(lb[0])


def test_port_save_load_is_bitwise(tmp_path):
    sd = _scoped_graph("p")
    path = str(tmp_path / "p.zip")
    sd.save(path)
    back = SameDiff.load(path, device=CPU)
    X, _, _, _ = mlp_data()
    feed = {"x": X, "ids": np.array([1, 1, 3], np.int32)}
    a = sd.output(feed, ["logits", "extra/z"])
    b = back.output(feed, ["logits", "extra/z"])
    for n in a:
        np.testing.assert_array_equal(a[n].toNumpy(), b[n].toNumpy())
    import json
    import zipfile
    with zipfile.ZipFile(path) as z:
        g = json.loads(z.read("graph.json"))
    ph = {v["name"]: v["phDtype"] for v in g["variables"]
          if v["type"] == "PLACEHOLDER"}
    assert ph == {"x": "float32", "y": "float32", "ids": "int32"}


# ----------------------------------------------------------------------
# stochastic ops: reproducible in the port, right in their moments
# ----------------------------------------------------------------------

def test_random_ops_reproducible_and_moments():
    sd = psd()
    n = 1 << 16
    a = sd.random.normal(1.0, 2.0, n, name="nrm")
    u = sd.random.uniform(-1.0, 3.0, n, name="uni")
    b = sd.random.bernoulli(0.3, n, name="ber")
    e = sd.random.exponential(2.0, n, name="exp")
    o1 = sd.output({}, [a, u, b, e])
    o2 = sd.output({}, [a, u, b, e])
    for k in o1:
        np.testing.assert_array_equal(o1[k].toNumpy(), o2[k].toNumpy())
    nv, uv = o1["nrm"].toNumpy(), o1["uni"].toNumpy()
    bv, ev = o1["ber"].toNumpy(), o1["exp"].toNumpy()
    z = 5.0 / np.sqrt(n)      # 5 sigma of a mean of n unit-variance draws
    assert abs(nv.mean() - 1.0) <= 2.0 * z
    assert abs(nv.std() - 2.0) <= 2.0 * 2.0 * z
    assert uv.min() >= -1.0 and uv.max() < 3.0
    assert abs(uv.mean() - 1.0) <= (4 / np.sqrt(12)) * z
    assert abs(bv.mean() - 0.3) <= np.sqrt(0.21) * z
    assert abs(ev.mean() - 0.5) <= 0.5 * z
    assert not np.array_equal(nv[: n // 2], nv[n // 2:])
    # two random ops of the same kind draw independently
    a2 = sd.random.normal(1.0, 2.0, n, name="nrm2")
    assert not np.array_equal(sd.output({}, [a2])["nrm2"].toNumpy(), nv)


def test_dropout_fit_streams_identity_in_output():
    sd = psd()
    x = sd.placeHolder("x", torch.float32, 64, 64)
    d = sd.nn.dropout(x, 0.25, name="d")
    sd.loss.meanSquaredError(sd.constant(np.zeros((64, 64), "f4")), d,
                             name="l")
    xv = np.ones((64, 64), "f4")
    np.testing.assert_array_equal(sd.output({"x": xv}, ["d"])["d"].toNumpy(),
                                  xv)
    env = dict(sd._arrays, x=torch.from_numpy(xv))
    s1 = sd._run_graph(dict(env), ["d"], train=True, stream=1)["d"]
    s1b = sd._run_graph(dict(env), ["d"], train=True, stream=1)["d"]
    s2 = sd._run_graph(dict(env), ["d"], train=True, stream=2)["d"]
    assert torch.equal(s1, s1b) and not torch.equal(s1, s2)
    kept = (s1 != 0).double().mean().item()
    n = s1.numel()
    assert abs(kept - 0.75) <= 5 * np.sqrt(0.75 * 0.25 / n)
    assert set(torch.unique(s1).tolist()) <= {0.0, float(
        np.float32(1.0) / np.float32(0.75))}
    sd.setTrainingConfig(TrainingConfig.Builder().updater(tupd.Sgd(0.0))
                         .dataSetFeatureMapping("x").build())
    hist = sd.fit(features=xv, labels=None, epochs=3)
    assert len(set(hist)) == 3      # a fresh mask every step
    again = psd()
    ad = again.nn.dropout(again.placeHolder("x", torch.float32, 64, 64),
                          0.25, name="d")
    again.loss.meanSquaredError(again.constant(np.zeros((64, 64), "f4")),
                                ad, name="l")
    again.setTrainingConfig(TrainingConfig.Builder()
                            .updater(tupd.Sgd(0.0))
                            .dataSetFeatureMapping("x").build())
    assert again.fit(features=xv, labels=None, epochs=3) == hist


# ----------------------------------------------------------------------
# what waits
# ----------------------------------------------------------------------

class _NanLossListener:
    """SameDiff's listeners see (sd, iteration, loss) after every step."""

    def iterationDone(self, sd, iteration, loss):
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at {iteration}")


def _save_load_trains_on(sd, tmp_path):
    """Item 9's updater state in model files: 2 steps, save with the
    state, load it, and the next step equals the unbroken graph's."""
    X, Y, _, _ = mlp_data()
    sd.fit(features=X, labels=Y, epochs=2)
    path = str(tmp_path / "upd.zip")
    sd.save(path, saveUpdaterState=True)
    back = SameDiff.load(path, loadUpdaterState=True, device=CPU)
    back.setTrainingConfig(sd._tc)
    assert back.fit(features=X, labels=Y) == sd.fit(features=X, labels=Y)
    return True


def _ported(fn, want):
    """An item 9 feature: `fn(sd, tmp_path)` builds it and `want` is its
    value."""
    def check(sd, tmp_path):
        got = fn(sd, tmp_path)
        got = got if isinstance(got, bool) else got.eval().toNumpy()
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    return check


def _sharded_is_stock(sd):
    """shardWeightUpdate over a one-rank group (min_shard_size 64: both
    weights shard) trains bitwise the stock graph, its updater state
    held flat, and saves it in the full-shape layout."""
    X, Y, W1, W2 = mlp_data()
    stock = build_mlp("p", W1, W2)
    assert sd.shardWeightUpdate(min_shard_size=64) is sd
    for _ in range(3):
        assert sd.fit(features=X, labels=Y) == \
            stock.fit(features=X, labels=Y)
    for n in ("w1", "b1", "w2", "b2"):
        assert torch.equal(sd._arrays[n], stock._arrays[n])
    shapes = {tuple(t.shape) for t in tree_leaves(sd._train_state)}
    assert (F * H,) in shapes and (F, H) not in shapes
    full = [tuple(t.shape) for t in tree_leaves(sd._canonical_train_state())]
    assert full == [tuple(t.shape) for t in tree_leaves(stock._train_state)]


_F = np.float32
DEFERRED = {
    "ifCond": (_ported(lambda sd, tmp: sd.ifCond(
        sd.constant(1.0), lambda s, a: a * 2.0, lambda s, a: a - 1.0,
        inputs=[sd.constant(_F(3.0))]), 6.0), None),
    "whileLoop": (_ported(lambda sd, tmp: sd.whileLoop(
        lambda s, v: s.math.lt(v, s.constant(_F(10.0))),
        lambda s, v: v * 2.0, [sd.constant(_F(1.0))]), 16.0), None),
    "cnn": (_ported(lambda sd, tmp: sd.cnn.conv2d(
        sd.constant(np.ones((1, 3, 3, 1), _F)),
        sd.constant(np.ones((2, 2, 1, 1), _F))),
        np.full((1, 2, 2, 1), 4.0)), None),
    "rnn": (_ported(lambda sd, tmp: sd.rnn.lstmLayer(
        *(sd.constant(np.zeros(s, _F)) for s in
          ((3, 2, 4), (4, 20), (5, 20), (20,))))[2], np.zeros((2, 5))),
        None),
    "image": (_ported(lambda sd, tmp: sd.image.resizeBilinear(
        sd.constant(np.ones((1, 4, 4, 1), _F)), 2, 2),
        np.ones((1, 2, 2, 1))), None),
    "fft": (_ported(lambda sd, tmp: sd.fft.fft(
        sd.constant(np.array([1, 0, 0, 0], _F))), np.ones(4)), None),
    "bitwise": (_ported(lambda sd, tmp: sd.bitwise.leftShift(
        sd.constant(np.array([1, 2], np.int32)),
        sd.constant(np.array([3, 1], np.int32))), [8, 4]), None),
    "svd": (_ported(lambda sd, tmp: sd.linalg.svd(
        sd.constant(np.eye(2)))[1], [1.0, 1.0]), None),
    "qr": (_ported(lambda sd, tmp: sd.linalg.mmul(*sd.linalg.qr(
        sd.constant(np.eye(2)))), np.eye(2)), None),
    "segment": (_ported(lambda sd, tmp: sd.math.segmentSum(
        sd.constant(np.array([1.0, 2.0, 3.0])),
        sd.constant(np.array([0, 0, 1])), 2), [3.0, 3.0]), None),
    "betainc": (_ported(lambda sd, tmp: sd.math.betainc(
        sd.constant(1.0), sd.constant(2.0), sd.constant(0.5)), 0.75),
        None),
    # ported since the data-parallel ZeRO slice
    "shardWeightUpdate": (lambda sd, tmp: _sharded_is_stock(sd), None),
    # ported since the training-runtime slice (precompile since the
    # capture slice): the reference's refusals
    "precompile": (lambda sd: (sd.setTrainingConfig(None),
                               sd.precompile()),
                   "setTrainingConfig first", ValueError),
    "fitDataSet": (lambda sd: sd.fitDataSet(iter([]), stepsPerSync=0),
                   "stepsPerSync must be >= 1", ValueError),
    "evaluate": (lambda sd: (sd.setTrainingConfig(None),
                             sd.evaluate(None, "x")),
                 "setTrainingConfig first", ValueError),
    "listeners": (lambda sd: sd.fit(
        features=np.full((B, F), np.nan, "f4"), labels=np.zeros((B, O), "f4"),
        listeners=[_NanLossListener()]), "non-finite loss",
        FloatingPointError),
    "saveUpdaterState": (_ported(lambda sd, tmp: _save_load_trains_on(
        sd, tmp), True), None),
    "loadUpdaterState": (_ported(lambda sd, tmp: _save_load_trains_on(
        sd, tmp), True), None),
}


@pytest.mark.parametrize("what", sorted(DEFERRED))
def test_deferred_features_name_their_item(what, tmp_path):
    _, _, W1, W2 = mlp_data()
    sd = build_mlp("p", W1, W2)
    call, item, *exc = DEFERRED[what]
    if item is None:            # item 9: ported, so it runs
        call(sd, tmp_path)
        return
    with pytest.raises(exc[0] if exc else NotImplementedError, match=item):
        call(sd)


def test_loading_a_deferred_op_raises(tmp_path):
    """A reference file naming an item 9 op (qr) loads and runs now."""
    j = JSD.create()
    x = j.constant(np.arange(4.0).reshape(2, 2), name="x")
    q, r = j.linalg.qr(x)
    path = str(tmp_path / "qr.zip")
    j.save(path)
    p = SameDiff.load(path, device=CPU)
    for n in (q.name, r.name):
        np.testing.assert_allclose(p.output({}, [n])[n].toNumpy(),
                                   j.output({}, [n])[n].toNumpy(),
                                   rtol=1e-6, atol=1e-12)


def test_samediff_needs_a_device_here():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.create()
