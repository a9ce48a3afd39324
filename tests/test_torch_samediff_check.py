"""The port's SameDiff graph validator against the reference's, on the CPU
(deeplearning4j_tpu_torch.analysis vs deeplearning4j_tpu.analysis).

tests/test_static_analysis.py's TestSameDiffValidator (:266-334) case by
case: the same (broken) graph is built in both packages and both
validators must report the same codes. Added: the port's validator
passes the port's own graphs with control flow and the new namespaces,
and an ONNX-imported graph, and keeps the reference's diagnostic model
(an unknown code raises; suppressed findings are not errors).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import validate_samediff as jvalidate
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSD
from deeplearning4j_tpu.autodiff.samediff import SDVariable as JSDVariable
from deeplearning4j_tpu.autodiff.samediff import _Op as JOp
from deeplearning4j_tpu_torch.analysis import (
    ALL_CODES, Diagnostic, Report, validate_samediff,
)
from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff, SDVariable, VariableType, _Op,
)

torch.set_num_threads(2)


def _codes(report):
    return set(report.codes())


class _Pkg:
    def __init__(self, name):
        self.j = name == "j"
        self.Op = JOp if self.j else _Op
        self.Var = JSDVariable if self.j else SDVariable
        self.validate = jvalidate if self.j else validate_samediff

    def new(self):
        return JSD.create() if self.j else SameDiff.create(device="cpu")


PKGS = [_Pkg("j"), _Pkg("p")]


def _mlp(k):
    sd = k.new()
    x = sd.placeHolder("x", "float32", 4, 3)
    w = sd.var("w", np.ones((3, 2), np.float32))
    y = sd.nn.softmax(x @ w)
    return sd, x, y


def _both(case):
    """The codes each package's validator reports for `case(k)`."""
    out = [case(k) for k in PKGS]
    assert out[0] == out[1], out
    return out[1]


def test_clean_graph():
    def case(k):
        sd, _, _ = _mlp(k)
        rep = k.validate(sd)
        assert rep.ok and not rep.warnings, rep.format()
        return _codes(rep)
    assert _both(case) == set()


def test_grf01_unknown_op():
    def case(k):
        sd, _, y = _mlp(k)
        sd._ops.append(k.Op("definitely_not_an_op", [y.name], ["zz"], {}))
        sd._producer["zz"] = len(sd._ops) - 1
        return _codes(k.validate(sd))
    assert "GRF01" in _both(case)


def test_grf02_duplicate_variable():
    def case(k):
        sd, _, y = _mlp(k)
        sd._ops.append(k.Op("neg", [y.name], [y.name], {}))
        return _codes(k.validate(sd))
    assert "GRF02" in _both(case)


def test_grf03_dangling_variable():
    def case(k):
        sd, _, _ = _mlp(k)
        sd._ops.append(k.Op("neg", ["ghost"], ["z9"], {}))
        sd._producer["z9"] = len(sd._ops) - 1
        return _codes(k.validate(sd))
    assert "GRF03" in _both(case)


def test_grf04_cycle():
    def case(k):
        sd = k.new()
        sd.placeHolder("p", "float32", 2)
        for n in ("late", "early"):
            sd._vars[n] = k.Var(sd, n, VariableType.ARRAY)
        sd._ops.append(k.Op("neg", ["late"], ["early"], {}))
        sd._ops.append(k.Op("neg", ["p"], ["late"], {}))
        sd._producer.update({"early": 0, "late": 1})
        return _codes(k.validate(sd))
    assert "GRF04" in _both(case)


def test_grf05_unfed_placeholder():
    def case(k):
        sd, _, y = _mlp(k)
        rep = k.validate(sd, placeholders=[], outputs=[y])
        rep2 = k.validate(sd, placeholders=["x"], outputs=[y])
        assert "GRF05" not in _codes(rep2), rep2.format()
        return _codes(rep)
    assert "GRF05" in _both(case)


def test_grf06_dead_subgraph():
    def case(k):
        sd = k.new()
        x = sd.placeHolder("x", "float32", 3)
        live = sd.math.square(x + sd.constant(np.float32(1.0)))
        live.markAsLoss()
        sd.math.mul(x, x)   # dead: feeds nothing
        return _codes(k.validate(sd))
    assert _both(case) == {"GRF06"}


def test_dty02_promotion():
    def case(k):
        sd = k.new()
        x = sd.placeHolder("x", "float32", 3)
        c = sd.constant(np.ones(3, np.float64), name="c64")
        sd.math.mul(x, c).markAsLoss()
        rep = k.validate(sd)
        assert rep.ok                  # a warning, not an error
        return _codes(rep)
    assert _both(case) == {"DTY02"}


def test_cast_clears_dty02():
    def case(k):
        sd = k.new()
        x = sd.placeHolder("x", "float32", 3)
        c = sd.constant(np.ones(3, np.float64), name="c64")
        sd.math.mul(x, c.castTo("float32")).markAsLoss()
        return _codes(k.validate(sd))
    assert _both(case) == set()


# ----------------------------------------------------------------------
# the port's own graphs
# ----------------------------------------------------------------------

def test_control_flow_and_namespace_graph_is_clean():
    sd = SameDiff.create(device="cpu")
    x = sd.placeHolder("x", "float32", 2, 8, 8, 3)
    w = sd.var("w", np.ones((3, 3, 3, 4), np.float32))
    h = sd.cnn.maxPooling2d(sd.cnn.conv2d(x, w, padding=((1, 1), (1, 1))),
                            (2, 2))
    h = sd.ifCond(sd.math.gt(sd.math.sum(h), sd.constant(np.float32(0.0))),
                  lambda s, a: s.nn.relu(a), lambda s, a: a, inputs=[h])
    h, _ = sd.whileLoop(lambda s, a, c: s.math.lt(c, s.constant(
        np.float32(2.0))), lambda s, a, c: (a * 0.5, c + s.constant(
            np.float32(1.0))), [h, sd.constant(np.float32(0.0))],
        maxIterations=3)
    spec = sd.fft.rfft(sd.math.reshape(h, [2, -1]))
    sd.math.sum(sd.fft.real(spec), name="out").markAsLoss()
    rep = validate_samediff(sd, placeholders=["x"])
    assert rep.ok and not rep.warnings, rep.format()


def test_onnx_imported_graph_is_clean():
    from deeplearning4j_tpu_torch.modelimport import importOnnx
    from deeplearning4j_tpu_torch.modelimport import onnx_wire as wire

    rs = np.random.RandomState(0)
    nodes = [wire.make_node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3],
                            pads=[1, 1, 1, 1]),
             wire.make_node("Relu", ["c"], ["r"]),
             wire.make_node("GlobalAveragePool", ["r"], ["g"]),
             wire.make_node("Flatten", ["g"], ["f"], axis=1),
             wire.make_node("Gemm", ["f", "wd"], ["y"])]
    graph = wire.make_graph(
        nodes, "cnn", inputs=[wire.make_value_info("x", np.float32,
                                                   (2, 3, 6, 6))],
        outputs=[wire.make_value_info("y", np.float32, (2, 5))],
        initializers=[wire.make_tensor("w", rs.randn(4, 3, 3, 3).astype(
            np.float32)), wire.make_tensor("wd", rs.randn(4, 5).astype(
                np.float32))])
    sd = importOnnx(wire.encode(wire.make_model(graph)), device="cpu")
    y = sd._onnx_vars["y"]
    rep = validate_samediff(sd, placeholders=["x"], outputs=[y])
    assert rep.ok and not rep.warnings, rep.format()
    rep = validate_samediff(sd, placeholders=[], outputs=[y])
    assert _codes(rep) == {"GRF05"}


def test_report_model():
    from deeplearning4j_tpu.analysis.diagnostics import \
        ALL_CODES as REF_CODES

    # the whole catalogue since the analysis slice: the reference's codes
    assert list(ALL_CODES) == list(REF_CODES)
    assert {"DTY02", "GRF01", "GRF02", "GRF03", "GRF04", "GRF05",
            "GRF06"} <= set(ALL_CODES)
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        Diagnostic("XYZ99", "error", "here", "not a code of the port")
    rep = Report(subject="g")
    rep.add("GRF03", "error", "op 1", "dangling", suppressed=True)
    rep.add("DTY02", "warning", "op 2", "mixed", hint="cast")
    assert rep.ok and rep.codes() == ["DTY02"]
    assert len(rep.suppressed) == 1 and len(rep.warnings) == 1
    assert "hint: cast" in rep.format()
    assert "GRF03 [suppressed]" in rep.format(verbose=True)
