"""Port parity for the ComputationGraph training path
(deeplearning4j_tpu_torch/nn/graph.py and nn/conf/*) against the JAX
reference, on the encoder the card trains at BERT-base widths, cut to a
small size: 2 blocks of AttentionVertex (hasBias) -> add -> Dense(gelu) ->
Dense -> FeedForwardToRnn -> add, then avg pooling and a softmax/MCXENT
head; F 16, 2 heads, FFN 32, T 20, B 4.

Both networks are built through their own builders; the reference's
initial parameters are carried into the port (``load_reference_params``).
The reference's gradient runs with ``pallas_attention._INTERPRET`` True
through ``computeGradientAndScore`` (not jitted), so its K1-K3 run in
interpret mode; the port runs their plain versions on the CPU.

Tolerances (explicit float32 inputs):
- output max abs 1e-6, loss rel 1e-5; each gradient rel L2 1e-4. The key
  bias ``bk`` is the exception: softmax is invariant to a shift along
  the keys, so its gradient is 0 in exact arithmetic and both sides hold
  rounding noise (~1e-8); it is held to an absolute L2 of 1e-6.
- 5 Adam(5e-4) steps: losses rel 1e-5, params max-abs rel 1e-4 of each
  tensor. Again bar ``bk``: Adam divides its noise gradient by its own
  root mean square, so it drifts by up to lr per step differently on
  both sides while the output, which it cannot move, keeps agreeing.
- bf16 compute (fp32 master weights): loss rel 3e-2, each gradient bar
  ``bk`` rel L2 5e-2 — the two frameworks round the bf16 matmul outputs
  and the loss tail at different places (observed 1 % and <= 1.8 %);
  ``bk``'s rounding noise is bf16's, held to an absolute L2 of 1e-2
  (observed 1e-3 against a whole-gradient L2 of 3.8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.ndarray import DataType as JDataType
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf.preprocessors import \
    FeedForwardToRnnPreProcessor as JFFToRnn
from deeplearning4j_tpu.ops import pallas_attention as pa
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F, HEADS, FFN, T, B, BLOCKS = 16, 2, 32, 20, 4, 2


def encoder(M, ff_to_rnn, dtype, lr=5e-4):
    """The encoder of the training slice, built through package M's own
    builders (the same code for the reference and the port)."""
    b = (M.NeuralNetConfiguration.Builder().seed(0).updater(M.Adam(lr))
         .dataType(dtype).graphBuilder().addInputs("in"))
    prev = "in"
    for i in range(BLOCKS):
        b = (b.addVertex(f"attn{i}", M.AttentionVertex(
                nOut=F, nHeads=HEADS, hasBias=True), prev)
             .addVertex(f"res1_{i}", M.ElementWiseVertex("add"), prev,
                        f"attn{i}")
             .addLayer(f"ffn1_{i}", M.DenseLayer(nOut=FFN, activation="gelu"),
                       f"res1_{i}")
             .addLayer(f"ffn2_{i}", M.DenseLayer(
                 nOut=F, activation="identity"), f"ffn1_{i}")
             .addVertex(f"seq{i}", M.PreprocessorVertex(ff_to_rnn()),
                        f"ffn2_{i}")
             .addVertex(f"res2_{i}", M.ElementWiseVertex("add"), f"res1_{i}",
                        f"seq{i}"))
        prev = f"res2_{i}"
    return (b.addLayer("gp", M.GlobalPoolingLayer(poolingType="avg"), prev)
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax",
                                           lossFunction="mcxent"), "gp")
            .setOutputs("out").setInputTypes(M.InputType.recurrent(F, T))
            .build())


def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, F, T)).astype(np.float32)
    cls = (x[:, :4].mean(axis=(1, 2)) > 0).astype(int)
    return x, np.eye(2, dtype=np.float32)[cls]


def pair(dtype_name):
    jn = J.ComputationGraph(encoder(J, JFFToRnn,
                                    getattr(JDataType, dtype_name))).init()
    pn = P.ComputationGraph(encoder(P, P.FeedForwardToRnnPreProcessor,
                                    getattr(P.DataType, dtype_name)),
                            device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    return jn, pn


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def check_grads(jg, pg, rtol, bk_atol):
    assert set(jg) == set(pg)
    for n in jg:
        assert set(jg[n]) == set(pg[n]), n
        for k in jg[n]:
            want = np.asarray(jg[n][k], np.float32)
            got = pg[n][k].float().numpy()
            if k == "bk":
                assert np.linalg.norm(got - want) <= bk_atol, (n, k)
            else:
                assert rel_l2(got, want) <= rtol, (n, k, rel_l2(got, want))


@pytest.fixture(scope="module")
def f32_pair():
    x, y = data()
    jn, pn = pair("FLOAT")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pa, "_INTERPRET", True)
        jg, js = jn.computeGradientAndScore(x, y)
    jo = np.asarray(jn.output(x).toNumpy())
    return dict(x=x, y=y, jn=jn, pn=pn, jg=jg, js=js, jo=jo)


def test_encoder_output_loss_and_gradients_match(f32_pair):
    d = f32_pair
    tfa.reset_launches()
    pg, ps = d["pn"].computeGradientAndScore(d["x"], d["y"])
    # both attention blocks went through FlashAttentionFn (plain on CPU)
    assert tfa.flash_fwd_plain.launches == BLOCKS
    assert tfa.flash_bwd_dq_plain.launches == BLOCKS
    assert tfa.flash_bwd_dkv_plain.launches == BLOCKS
    assert abs(ps - d["js"]) <= 1e-5 * abs(d["js"])
    check_grads(d["jg"], pg, 1e-4, 1e-6)
    out = d["pn"].output(d["x"])
    assert isinstance(out, INDArray) and out.shape() == (B, 2)
    np.testing.assert_allclose(out.toNumpy(), d["jo"], rtol=0, atol=1e-6)


def test_encoder_adam_trajectory_matches(f32_pair):
    d = f32_pair
    jn, pn = d["jn"], d["pn"]
    jl, pl = [], []
    for _ in range(5):
        jn.fit(d["x"], d["y"])
        jl.append(jn.score())
        pn.fit(d["x"], d["y"])
        pl.append(pn.score())
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[-1] < pl[0]
    assert pn.getIterationCount() == 5
    for n, p in jn._params.items():
        for k, a in p.items():
            if k == "bk":
                continue
            want = np.asarray(a, np.float64)
            got = pn._params[n][k].detach().double().numpy()
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                (n, k)
    np.testing.assert_allclose(pn.output(d["x"]).toNumpy(),
                               np.asarray(jn.output(d["x"]).toNumpy()),
                               rtol=0, atol=1e-5)


def test_encoder_bf16_matches():
    x, y = data()
    jn, pn = pair("BFLOAT16")
    # computeGradientAndScore's own loss and gradient, jitted: eager
    # dispatch of the bf16 graph costs ~10 s on the CPU
    (js, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jn._loss_fn(p, jn._states, {"in": x}, [y], None, None,
                              None), has_aux=True))(jn._params)
    js = float(js)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert pn._params["out"]["W"].dtype == torch.float32  # fp32 master
    assert abs(ps - js) <= 3e-2 * abs(js)
    check_grads(jg, pg, 5e-2, 1e-2)
    assert pn.output(x).tensor().dtype == torch.bfloat16


def test_gelu_is_the_tanh_form():
    """The reference's "gelu" is jax.nn.gelu, whose default is the tanh
    approximation; torch's F.gelu default is the exact erf form."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = tact.get("gelu")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_adam_puts_epsilon_where_the_reference_does():
    """Adam's update is lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps): at
    gradients near eps it differs from torch.optim.Adam, whose eps sits
    beside the bias-corrected sqrt(v_hat)."""
    g = np.array([3e-8, -1e-7, 2e-6, 0.5], np.float32)
    p0 = np.ones(4, np.float32)
    ju = jupd.Adam(1e-2)
    js = ju.init({"W": jnp.asarray(p0)})
    tu = tupd.Adam(1e-2)
    ts = tu.init({"W": torch.from_numpy(p0)})
    for it in range(3):
        jd, js = ju.apply({"W": jnp.asarray(g)}, js, it)
        with torch.no_grad():
            td, ts = tu.apply({"W": torch.from_numpy(g)}, ts, it)
        np.testing.assert_allclose(td["W"].numpy(), np.asarray(jd["W"]),
                                   rtol=1e-6, atol=0)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([w], lr=1e-2)
    for _ in range(3):
        w.grad = torch.from_numpy(g.copy())
        opt.step()
    ours = p0 - sum_updates(tupd.Adam(1e-2), g, 3)
    assert np.abs(w.detach().numpy() - ours)[:2].max() > 1e-4


def sum_updates(updater, g, steps):
    state = updater.init({"W": torch.zeros(len(g))})
    total = np.zeros(len(g), np.float32)
    with torch.no_grad():
        for it in range(steps):
            d, state = updater.apply({"W": torch.from_numpy(g)}, state, it)
            total += d["W"].numpy()
    return total


def test_entry_points_need_a_device_or_the_card():
    conf = encoder(P, P.FeedForwardToRnnPreProcessor, P.DataType.FLOAT)
    if torch.cuda.is_available():
        assert P.ComputationGraph(conf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.ComputationGraph(conf)


@pytest.mark.parametrize("call,exc,match", [
    (lambda net: net.fitDataSet(None, stepsPerSync=0), ValueError,
     "stepsPerSync must be >= 1"),
    (lambda net: net.precompile(batchSize=2, stepsPerSync=0), ValueError,
     "stepsPerSync must be >= 1"),
    (lambda net: net.doEvaluation(None), ValueError,
     "at least one IEvaluation")],
    ids=["fitDataSet", "precompile", "evaluate"])
def test_later_slices_raise_and_name_themselves(call, exc, match):
    """What waits names its slice; fitDataSet and evaluation (ported in
    the training-runtime slice) keep the reference's refusals, and
    precompile (ported in the capture slice) refuses the block size
    fitDataSet refuses."""
    conf = encoder(P, P.FeedForwardToRnnPreProcessor, P.DataType.FLOAT)
    net = P.ComputationGraph(conf, device="cpu").init()
    with pytest.raises(exc, match=match):
        call(net)


def test_fit_and_score_name_what_they_take():
    """fit and score take arrays, a DataSet or (fit) an iterator; any
    other object is a TypeError naming them."""
    conf = encoder(P, P.FeedForwardToRnnPreProcessor, P.DataType.FLOAT)
    net = P.ComputationGraph(conf, device="cpu").init()
    with pytest.raises(TypeError, match="DataSet, or a DataSetIterator"):
        net.fit(object())
    with pytest.raises(TypeError, match="DataSet"):
        net.score(object())
