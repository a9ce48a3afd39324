"""The rest of SameDiff and ONNX import on the card (``cuda`` marker):
control flow against the same graph on the CPU, with the bounded loop's
steps free of host syncs; uint16/uint32 bitwise ops widened exactly and
uint64 shifts refused; the minimum-norm ``lstsq`` of a rank-deficient
matrix (cuSOLVER's ``gels`` would assume full rank); a cut ResNet-50
imported from ONNX against the zoo net; a SameDiff's updater state
through save/load resuming bitwise. Without a card, a graph or an import
asked for no device cannot be built (the last test, which runs here).

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_samediff_card.py

Without a card every test but the last skips.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.ops_impl import OPS
from deeplearning4j_tpu_torch.nn.updaters import Adam

pytestmark = pytest.mark.cuda
F32 = np.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _loop_graph(device):
    rs = np.random.RandomState(0)
    sd = SameDiff.create(device)
    x = sd.placeHolder("x", "float32", 16, 8)
    y = sd.placeHolder("y", "float32", 16, 8)
    w = sd.var("w", (rs.randn(8, 8) * 0.3).astype(F32))
    h, _, _ = sd.whileLoop(
        lambda s, a, c, ww: s.math.lt(c, s.constant(F32(2.0))),
        lambda s, a, c, ww: (s.math.tanh(s.linalg.mmul(a, ww)),
                             c + s.constant(F32(1.0)), ww),
        [x, sd.constant(F32(0.0)), w], maxIterations=3)
    sd.loss.meanSquaredError(y, h, name="loss")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(Adam(1e-2))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd


def test_bounded_loop_trains_without_host_syncs(card):
    rs = np.random.RandomState(1)
    X, Y = rs.randn(16, 8).astype(F32), rs.randn(16, 8).astype(F32)
    g, c = _loop_graph(card), _loop_graph("cpu")
    lg, lc = (s.fitSteps(features=X, labels=Y, numSteps=4) for s in (g, c))
    assert g._control_syncs == 0
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert _rel(g._arrays["w"], c._arrays["w"]) <= 1e-5
    tc, names, params, state = g._fit_setup()
    phs = {"x": torch.from_numpy(X).to(card),
           "y": torch.from_numpy(Y).to(card)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g._step(tc, names, params, state, phs, g._iteration)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_if_and_unbounded_loop_match_the_cpu(card):
    def build(sd):
        x = sd.placeHolder("x", "float32", 64)
        a, n = sd.whileLoop(
            lambda s, v, k: s.math.lt(s.math.sum(s.math.abs(v)),
                                      s.constant(F32(1e3))),
            lambda s, v, k: (s.math.mul(v, s.constant(F32(1.5))),
                             k + s.constant(F32(1.0))),
            [x, sd.constant(F32(0.0))])
        return sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0))),
                         lambda s, v: s.math.exp(s.math.neg(s.math.abs(v))),
                         lambda s, v: s.math.sin(v), inputs=[a]), n

    xv = np.random.RandomState(2).randn(64).astype(F32)
    for sign in (1.0, -1.0):
        outs = []
        for d in (card, "cpu"):
            sd = SameDiff.create(d)
            o, n = build(sd)
            r = sd.output({"x": np.abs(xv) * sign}, [o, n])
            outs.append((r[o.name].tensor(), int(r[n.name].toNumpy()),
                         sd._control_syncs))
        (og, ng, sg), (oc, nc, sc) = outs
        assert ng == nc and sg == sc == ng + 2
        assert _rel(og, oc) <= 1e-5


def test_unsigned_bitwise_on_the_card(card):
    rs = np.random.RandomState(3)
    for dt in (np.uint8, np.uint16, np.uint32):
        info = np.iinfo(dt)
        a = rs.randint(0, int(info.max) + 1, 512, dtype=np.int64).astype(dt)
        s = rs.randint(0, info.bits, 512).astype(dt)
        ta, ts = torch.from_numpy(a).to(card), torch.from_numpy(s).to(card)
        for op in ("shiftLeft", "shiftRight", "bitwiseAnd", "bitwiseOr",
                   "bitwiseXor"):
            got = OPS[op](ta, ts)
            want = OPS[op](torch.from_numpy(a), torch.from_numpy(s))
            assert got.dtype == want.dtype == torch.from_numpy(a).dtype
            assert torch.equal(got.cpu(), want), (dt, op)
        assert torch.equal(OPS["bitwiseNot"](ta).cpu(),
                           torch.from_numpy(~a))
    u = torch.from_numpy(np.array([1, 2 ** 64 - 1], np.uint64)).to(card)
    assert torch.equal(OPS["bitwiseXor"](u, u).cpu(),
                       torch.zeros(2, dtype=torch.uint64))
    with pytest.raises(TypeError, match="uint64"):
        OPS["shiftLeft"](u, u)


def test_lstsq_is_the_minimum_norm_solution_on_the_card(card):
    # f64: in f32 the numerically-zero singular values of a rank-6 matrix
    # sit near eps*max(M, N)*s_max, the cut itself
    rs = np.random.RandomState(4)
    A = rs.randn(40, 6) @ rs.randn(6, 24)                   # rank 6
    B = rs.randn(40, 3)
    got = OPS["lstsq"](torch.from_numpy(A).to(card),
                       torch.from_numpy(B).to(card))
    assert _rel(got, torch.from_numpy(np.linalg.pinv(A) @ B)) <= 1e-9


def test_cut_resnet50_from_onnx_on_the_card(card):
    import _torch_onnx_models as om

    from deeplearning4j_tpu_torch.analysis import validate_samediff
    from deeplearning4j_tpu_torch.modelimport import importOnnx, onnx_wire
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries

    net = ComputationGraph(om.resnet50_conf(
        blocks=(1, 1, 1, 1), numClasses=10, inputShape=(3, 64, 64)),
        device=card).init()
    x = torch.from_numpy(np.random.RandomState(5).randn(
        8, 3, 64, 64).astype(F32)).to(card)
    sd = importOnnx(onnx_wire.encode(om.resnet_onnx(net, 8)), device=card)
    lv = sd._onnx_vars["logits"]
    assert validate_samediff(sd, placeholders=["input"], outputs=[lv]).ok
    got = sd.output({"input": x}, [lv.name])[lv.name].tensor()
    with torch.no_grad():
        _, pre, _ = net._run_graph(net._params, strip_carries(net._states),
                                   net._coerce_inputs(x), False, None, None)
    assert _rel(got, pre["fc"]) <= 1e-4
    assert torch.equal(got.argmax(1), pre["fc"].argmax(1))


def test_updater_state_resumes_bitwise_on_the_card(card, tmp_path):
    rs = np.random.RandomState(6)
    data = [(rs.randn(16, 8).astype(F32), rs.randn(16, 8).astype(F32))
            for _ in range(6)]
    whole = _loop_graph(card)
    want = [whole.fit(features=x, labels=y)[0] for x, y in data]
    part = _loop_graph(card)
    got = [part.fit(features=x, labels=y)[0] for x, y in data[:3]]
    path = str(tmp_path / "g.zip")
    part.save(path, saveUpdaterState=True)
    back = SameDiff.load(path, loadUpdaterState=True, device=card)
    back.setTrainingConfig(part._tc)
    got += [back.fit(features=x, labels=y)[0] for x, y in data[3:]]
    assert got == want
    assert torch.equal(back._arrays["w"], whole._arrays["w"])


def test_no_card_means_no_graph_and_no_import():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines without")
    from deeplearning4j_tpu_torch.modelimport import importOnnx, onnx_wire

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.create()
    model = onnx_wire.make_model(onnx_wire.make_graph(
        [onnx_wire.make_node("Relu", ["x"], ["y"])], "g",
        inputs=[onnx_wire.make_value_info("x", F32, (2,))],
        outputs=[onnx_wire.make_value_info("y", F32, (2,))]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importOnnx(onnx_wire.encode(model))
