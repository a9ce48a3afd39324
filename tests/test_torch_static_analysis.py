"""The port's shape/dtype pass, ``init(validate=True)``, the zoo corpus,
the capture-purity lint and the recapture lint against the reference's
(``tests/test_static_analysis.py``, ``tests/test_partition_analysis.py``'s
retrace cases).

- Parity: each configuration, built in both packages from the same
  description, gives the same diagnostic codes and severities at the
  same layer/vertex names, and the same per-layer parameter counts, in
  both packages' ``validate_model``.
- ``init(validate=True)`` raises ``ConfigValidationError`` where the
  reference raises it, takes no draw from the init generators (the
  parameters are bitwise those of ``init()``), and allocates nothing:
  the shape pass runs on the meta device.
- ``zoo_corpus()`` names the reference's models, and every one
  validates clean.
- The purity lint's codes fire on torch capture snippets that mirror
  the reference's JAX ones; the port's own source lints clean (with
  reasoned suppressions); so does the recapture lint.
"""

import textwrap

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.analysis import validate_model as ref_validate
from deeplearning4j_tpu.analysis import zoo_corpus as ref_corpus
from deeplearning4j_tpu.nn.conf import graph as Jg
from deeplearning4j_tpu.nn.conf import layers as Jl
from deeplearning4j_tpu_torch.analysis import (
    ALL_CODES, ConfigValidationError, lint_paths, lint_retrace,
    lint_retrace_paths, lint_source, validate_model, validate_or_raise,
    zoo_corpus,
)
from deeplearning4j_tpu_torch.nn.conf import graph as Pg
from deeplearning4j_tpu_torch.nn.conf import layers as Pl

torch.set_num_threads(1)


def _M(port):
    """(nn, conf.layers, conf.graph, DataType) of one package."""
    if port:
        from deeplearning4j_tpu_torch.ndarray.dtype import DataType
        return P, Pl, Pg, DataType
    from deeplearning4j_tpu.ndarray.dtype import DataType
    return J, Jl, Jg, DataType


# ----------------------------------------------------------------------
# configurations, each a function of one package's namespace
# ----------------------------------------------------------------------

def _ff(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(n.DenseLayer(nOut=32, activation="relu"))
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.feedForward(20)))


def _cnn(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.ConvolutionLayer(nOut=20, kernelSize=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(n.DenseLayer(nOut=64, activation="relu"))
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.convolutionalFlat(28, 28, 1)))


def _rnn(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(n.LSTM(nOut=16))
            .layer(n.RnnOutputLayer(nOut=5, activation="softmax"))
            .setInputType(n.InputType.recurrent(8, 12)))


def _merge(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("a", L.ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                              convolutionMode="same"), "in")
            .addLayer("b", L.ConvolutionLayer(nOut=4, kernelSize=(5, 5),
                                              convolutionMode="same"), "in")
            .addVertex("m", G.MergeVertex(), "a", "b")
            .addLayer("out", n.OutputLayer(nOut=3, activation="softmax"),
                      "m")
            .setOutputs("out")
            .setInputTypes(n.InputType.convolutional(16, 16, 3)))


def _shp01(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(n.DenseLayer(nIn=100, nOut=32))
            .layer(n.OutputLayer(nIn=64, nOut=10, activation="softmax"))
            .setInputType(n.InputType.feedForward(100)))


def _shp02(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.ConvolutionLayer(nOut=8, kernelSize=(7, 7)))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(nOut=8, kernelSize=(5, 5)))
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.convolutionalFlat(8, 8, 1)))


def _shp03(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.ConvolutionLayer(nOut=8, kernelSize=(5, 5)))
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.feedForward(784)))


def _shp04_merge(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("a", L.ConvolutionLayer(nOut=8, kernelSize=(3, 3)),
                      "in")
            .addLayer("b", L.ConvolutionLayer(nOut=8, kernelSize=(5, 5)),
                      "in")
            .addVertex("m", G.MergeVertex(), "a", "b")
            .addLayer("out", n.OutputLayer(nOut=10, activation="softmax"),
                      "m")
            .setOutputs("out")
            .setInputTypes(n.InputType.convolutional(16, 16, 3)))


def _shp04_add(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("a", n.DenseLayer(nOut=32), "in")
            .addLayer("b", n.DenseLayer(nOut=16), "in")
            .addVertex("add", G.ElementWiseVertex("add"), "a", "b")
            .addLayer("out", n.OutputLayer(nOut=10, activation="softmax"),
                      "add")
            .setOutputs("out")
            .setInputTypes(n.InputType.feedForward(8)))


def _shp05_embedding(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.EmbeddingLayer(nOut=8))
            .layer(n.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(n.InputType.feedForward(1)))


def _shp05_cycle(n, L, G, D):
    gb = n.NeuralNetConfiguration.Builder().graphBuilder().addInputs("in")
    gb.addLayer("a", n.DenseLayer(nOut=4), "b")
    gb.addLayer("b", n.DenseLayer(nOut=4), "a")
    gb.addLayer("out", n.OutputLayer(nOut=2, activation="softmax"), "b")
    gb.setOutputs("out").setInputTypes(n.InputType.feedForward(4))
    return gb


def _shp06(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(n.DenseLayer())
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.feedForward(10)))


def _loss_activation(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(n.OutputLayer(nOut=10, activation="identity",
                                 lossFunction="mcxent"))
            .setInputType(n.InputType.feedForward(4)))


def _dty01(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder()
            .dataType(D.DOUBLE).list()
            .layer(n.DenseLayer(nOut=4))
            .layer(n.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(n.InputType.feedForward(3)))


def _embedding_sequence(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.EmbeddingSequenceLayer(nIn=50, nOut=8, inputLength=6))
            .layer(n.RnnOutputLayer(nOut=2, activation="softmax"))
            .setInputType(n.InputType.recurrent(1)))


def _bn_cnn(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.ConvolutionLayer(nOut=6, kernelSize=(3, 3)))
            .layer(L.BatchNormalization(nOut=5))
            .layer(n.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(n.InputType.convolutional(8, 8, 3)))


def _unknown_output(n, L, G, D):
    return (n.NeuralNetConfiguration.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("d", n.DenseLayer(nOut=4), "in")
            .setOutputs("nope")
            .setInputTypes(n.InputType.feedForward(3)))


CONFIGS = {f.__name__[1:]: f for f in (
    _ff, _cnn, _rnn, _merge, _shp01, _shp02, _shp03, _shp04_merge,
    _shp04_add, _shp05_embedding, _shp05_cycle, _shp06, _loss_activation,
    _dty01, _embedding_sequence, _bn_cnn, _unknown_output)}


def _summary(rep):
    diags = sorted((d.code, d.severity, d.where) for d in rep.diagnostics)
    layers = [(r["name"], r["type"], r["params"], r["in"], r["out"])
              for r in rep.layers]
    return diags, layers


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_validate_model_matches_the_reference(name):
    ref = ref_validate(CONFIGS[name](*_M(False)), batchSize=16)
    got = validate_model(CONFIGS[name](*_M(True)), batchSize=16)
    assert _summary(got) == _summary(ref), (got.format(True),
                                           ref.format(True))


def test_codes_fired_cover_the_shape_catalogue():
    codes = set()
    for f in CONFIGS.values():
        codes |= set(validate_model(f(*_M(True))).codes())
    assert {"SHP01", "SHP02", "SHP03", "SHP04", "SHP05", "SHP06",
            "DTY01"} <= codes
    assert codes <= set(ALL_CODES)


def test_dty01_names_the_card_and_the_kernels():
    rep = validate_model(_dty01(*_M(True)))
    msg = [d.message for d in rep.warnings if d.code == "DTY01"][0]
    assert "K1-K5" in msg and "TPU" not in msg


def test_forward_disagreement_is_shp05_on_meta_tensors():
    class Lying(P.DenseLayer):
        def forward(self, params, state, x, train, key, mask=None):
            y, s = super().forward(params, state, x, train, key, mask)
            return torch.cat([y, y[:, :1]], dim=-1), s

    b = (P.NeuralNetConfiguration.Builder().list()
         .layer(Lying(nOut=8))
         .layer(P.OutputLayer(nOut=2, activation="softmax"))
         .setInputType(P.InputType.feedForward(4)))
    rep = validate_model(b)
    assert any(e.code == "SHP05" and "forward()" in e.message
               for e in rep.errors), rep.format()


def test_a_layer_without_getoutputtype_is_named_not_a_crash():
    class NoShape(P.DenseLayer):
        def getOutputType(self, it):
            raise NotImplementedError("no getOutputType")

    rep = validate_model(
        (P.NeuralNetConfiguration.Builder().list()
         .layer(NoShape(nOut=3))
         .layer(P.OutputLayer(nOut=2, activation="softmax"))
         .setInputType(P.InputType.feedForward(4))))
    assert [e.code for e in rep.errors] == ["SHP05"]
    assert "layer 0 (NoShape)" in rep.errors[0].where


def test_the_validator_does_not_mutate_the_config():
    b = _ff(*_M(True))
    validate_model(b)
    assert b._layers[0].nIn is None


# ----------------------------------------------------------------------
# init(validate=True)
# ----------------------------------------------------------------------

def _conf_ok(n):
    return (n.NeuralNetConfiguration.Builder().seed(3).list()
            .layer(n.DenseLayer(nOut=8))
            .layer(n.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(n.InputType.feedForward(4)).build())


def _graph_ok(n):
    return (n.NeuralNetConfiguration.Builder().seed(3).graphBuilder()
            .addInputs("in")
            .addLayer("d", n.DenseLayer(nOut=4), "in")
            .addLayer("out", n.OutputLayer(nOut=2, activation="softmax"),
                      "d")
            .setOutputs("out")
            .setInputTypes(n.InputType.feedForward(3)).build())


def _leaves(params):
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _leaves(params[k])]
    if isinstance(params, list):
        return [t for p in params for t in _leaves(p)]
    return [params]


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("kw", [dict(validate=True),
                                dict(mesh={"data": 2}, batchSize=8),
                                dict(hbm_gb=1.0)])
def test_validated_init_is_bitwise_plain_init(kind, kw):
    net_cls, conf = ((P.MultiLayerNetwork, _conf_ok(P)) if kind == "mln"
                     else (P.ComputationGraph, _graph_ok(P)))
    a = net_cls(conf, device="cpu").init(**kw)
    b = net_cls(conf, device="cpu").init()
    la, lb = _leaves(a._params), _leaves(b._params)
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_validated_init_raises_where_the_reference_raises():
    from deeplearning4j_tpu.analysis import \
        ConfigValidationError as RefError

    def bad(n):
        return (n.NeuralNetConfiguration.Builder().list()
                .layer(n.DenseLayer(nIn=5, nOut=8))
                .layer(n.OutputLayer(nIn=9, nOut=2, activation="softmax"))
                .setInputType(n.InputType.feedForward(5)).build())

    with pytest.raises(RefError) as want:
        J.MultiLayerNetwork(bad(J)).init(validate=True)
    with pytest.raises(ConfigValidationError) as got:
        P.MultiLayerNetwork(bad(P), device="cpu").init(validate=True)
    assert sorted(want.value.report.codes()) == sorted(
        got.value.report.codes()) == ["SHP01"]


def test_validate_or_raise_returns_the_report():
    rep = validate_or_raise(_conf_ok(P), batchSize=8)
    assert rep.ok and rep.totalParams() == 4 * 8 + 8 + 8 * 2 + 2


# ----------------------------------------------------------------------
# the zoo corpus
# ----------------------------------------------------------------------

def test_zoo_corpus_names_are_the_references():
    assert [n for n, _ in zoo_corpus()] == [n for n, _ in ref_corpus()]


def test_zoo_corpus_validates_clean_with_the_references_params():
    """Every zoo model: 0 errors, and per layer the reference's
    parameter count (the fast half: the whole corpus on the meta
    device; the reference's counts for three models)."""
    bad = {}
    for name, model in zoo_corpus():
        rep = validate_model(model, batchSize=8)
        if not rep.ok:
            bad[name] = rep.format()
    assert not bad, bad
    ref = dict(ref_corpus())
    for name in ("LeNet", "SimpleCNN", "TextGenerationLSTM"):
        want = [r["params"] for r in ref_validate(ref[name], 8).layers]
        got = [r["params"] for r in
               validate_model(dict(zoo_corpus())[name], 8).layers]
        assert got == want, name


# ----------------------------------------------------------------------
# capture purity
# ----------------------------------------------------------------------

_FIXTURE = textwrap.dedent('''
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.runtime import aot

    history = []

    def step(params, x):
        print("capturing", x)            # PUR01
        lr = float(x.mean())             # PUR02
        noise = np.random.randn(4)       # PUR03
        history.append(lr)               # PUR04
        return params - lr * x

    cap = aot.CapturedStep(step, entry="step")

    counter = 0

    def body(x):
        global counter                   # PUR04
        counter += 1
        return x

    g = torch.cuda.CUDAGraph()

    def run(x, y):
        with torch.cuda.graph(g):
            y.copy_(body(x))
            torch.cuda.synchronize()     # PUR02

    def loss(w, mode=[1, 2]):            # PUR05
        return w.sum()

    f = torch.compile(loss, static_argnames=("mode",))

    class M:
        def _step(self, x):
            self.cache = x               # PUR04
            return x * 2

        def go(self):
            self._cap = aot.CapturedStep(self._step)
''')

_HOST_ONLY = textwrap.dedent('''
    import numpy as np

    def host_fn(x):
        print("host", x)
        v = float(np.mean(x))
        r = np.random.randn(3)
        return v + r.sum()
''')


class TestPurity:
    def test_every_code_fires(self):
        vio = lint_source(_FIXTURE, "fixture.py")
        got = sorted((v.line, v.code) for v in vio if not v.suppressed)
        lines = _FIXTURE.splitlines()
        want = sorted((i + 1, line.split("# ")[1].split()[0])
                      for i, line in enumerate(lines) if "# PUR" in line)
        assert got == want, "\n".join(v.format() for v in vio)

    @pytest.mark.parametrize("surface", [
        "aot.CapturedStep(step)", "aot.cached_jit(step)",
        "torch.compile(step)",
        "torch.cuda.make_graphed_callables((step,), (x,))"])
    def test_each_capture_surface_is_linted(self, surface):
        src = textwrap.dedent(f'''
            import torch
            from deeplearning4j_tpu_torch.runtime import aot

            def step(x):
                return x.sum().item()

            c = {surface}
        ''')
        assert [v.code for v in lint_source(src, "s.py")] == ["PUR02"]

    @pytest.mark.parametrize("read", ["t.cpu()", "t.numpy()", "t.tolist()",
                                      "t.item()", "bool(t.any())",
                                      "np.asarray(t)"])
    def test_host_reads_are_pur02(self, read):
        src = textwrap.dedent(f'''
            import numpy as np
            import torch

            @torch.compile
            def step(t):
                return {read}
        ''')
        assert [v.code for v in lint_source(src, "s.py")] == ["PUR02"]

    def test_decorated_step_and_transitive_call(self):
        src = textwrap.dedent('''
            import torch

            def helper(x):
                print("inner", x)
                return x

            @torch.compile(dynamic=False)
            def step(x):
                return helper(x) * 2
        ''')
        assert [v.code for v in lint_source(src, "t.py")] == ["PUR01"]

    def test_host_code_and_closed_over_scalars_not_flagged(self):
        assert lint_source(_HOST_ONLY, "host.py") == []
        src = textwrap.dedent('''
            from deeplearning4j_tpu_torch.runtime import aot

            def make(numSamples):
                return aot.CapturedStep(lambda x: x[: int(numSamples)])
        ''')
        assert lint_source(src, "t.py") == []

    def test_builtin_compile_is_not_a_capture(self):
        src = textwrap.dedent('''
            def f(x):
                print(x)

            code = compile("f(1)", "<s>", "exec")
        ''')
        assert lint_source(src, "t.py") == []

    def test_suppression_requires_justification(self):
        src = textwrap.dedent('''
            import torch

            g = torch.compile(lambda x: float(x))  # purity-ok[PUR02]: a host scalar
            h = torch.compile(lambda x: float(x))  # purity-ok[PUR02]
        ''')
        vio = sorted(lint_source(src, "s.py"), key=lambda v: v.line)
        assert [v.suppressed for v in vio] == [True, False]

    def test_the_ports_source_is_pure(self):
        import os

        import deeplearning4j_tpu_torch as pkg

        rep = lint_paths([os.path.dirname(pkg.__file__)])
        assert rep.ok, rep.format()
        assert all(d.code == "PUR04" for d in rep.suppressed)


# ----------------------------------------------------------------------
# recapture hazards
# ----------------------------------------------------------------------

_RETRACE = textwrap.dedent('''
    import torch
    from deeplearning4j_tpu_torch.runtime import aot, autotune

    def body(x, scale):
        return x * scale

    step = aot.CapturedStep(body)

    def train(xs, n):
        for i in range(n):
            g = torch.cuda.CUDAGraph()                     # RTC01
            step(xs, i)                                    # RTC01
            step(xs[:i], 1.0)                              # RTC03
            step(torch.arange(i), 1.0)                     # RTC03
            with autotune.applied({"maxpool_bwd": i}):     # RTC01
                step(xs, 1.0)
        with autotune.applied({"maxpool_bwd": [1, 2]}):    # RTC02
            step(xs, 1.0)
''')


class TestRetraceLint:
    def test_every_code_fires_on_its_line(self):
        rep = lint_retrace(_RETRACE, "r.py")
        got = sorted((int(d.where.split(":")[1]), d.code)
                     for d in rep.diagnostics)
        lines = _RETRACE.splitlines()
        want = sorted((i + 1, line.split("# ")[1].split()[0])
                      for i, line in enumerate(lines) if "# RTC" in line)
        assert got == want, rep.format()

    def test_capture_built_in_a_loop(self):
        src = textwrap.dedent('''
            import torch
            from deeplearning4j_tpu_torch.runtime import aot

            def run(xs, f):
                for x in xs:
                    aot.CapturedStep(f)(x)
                    torch.compile(f)(x)
        ''')
        assert lint_retrace(src, "r.py").codes() == ["RTC01"]
        assert len(lint_retrace(src, "r.py").errors) == 2

    def test_number_at_one_site_tensor_at_another(self):
        src = textwrap.dedent('''
            from deeplearning4j_tpu_torch.runtime import aot

            step = aot.CapturedStep(lambda x, lr: x * lr)

            def a(x, lr_t):
                step(x, 0.1)
                step(x, lr_t)
        ''')
        assert lint_retrace(src, "r.py").codes() == ["RTC01"]

    def test_fixed_width_minibatch_window_not_flagged(self):
        src = textwrap.dedent('''
            from deeplearning4j_tpu_torch.runtime import aot

            step = aot.CapturedStep(lambda x: x)

            def run(x, B):
                for s in range(0, 1024, B):
                    step(x[s:s + B])
        ''')
        assert lint_retrace(src, "r.py").ok

    def test_suppression(self):
        src = textwrap.dedent('''
            import torch

            def run(xs):
                for x in xs:
                    g = torch.cuda.CUDAGraph()  # purity-ok[RTC01]: one graph per bucket, kept
        ''')
        rep = lint_retrace(src, "r.py")
        assert rep.ok and len(rep.suppressed) == 1

    def test_the_ports_source_is_recapture_clean(self):
        import os

        import deeplearning4j_tpu_torch as pkg

        rep = lint_retrace_paths([os.path.dirname(pkg.__file__)])
        assert rep.ok, rep.format()


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    from deeplearning4j_tpu_torch.analysis.cli import main

    good = tmp_path / "clean.py"
    good.write_text("x = 1\n")
    assert main([str(good)]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text(_FIXTURE)
    assert main([str(bad)]) == 1
    assert main([]) == 2
    assert main(["--codes"]) == 0
    assert main(["--linalg", "--hbm-gb", "16"]) == 0
    assert "linalg@data4xmodel2" in capsys.readouterr().out
    conf = _conf_ok(P)
    p = tmp_path / "model.json"
    p.write_text(conf.toJson())
    assert main([str(p)]) == 0
    assert main(["--zoo"]) == 0
    capsys.readouterr()


def test_python_dash_m_runs_the_cli():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis",
         "--codes"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert sum(1 for line in out.stdout.splitlines()
               if line[:3].isalpha()) == len(ALL_CODES)


def test_no_parameter_is_allocated_by_the_shape_pass(monkeypatch):
    """The pass materializes nothing: every tensor a layer's initialize
    makes under it is on the meta device."""
    made = []
    real = torch.empty

    def spy(*a, **k):
        t = real(*a, **k)
        made.append(t.device.type)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    rep = validate_model(_cnn(*_M(True)), batchSize=4)
    assert rep.ok
    assert made and set(made) == {"meta"}
    assert np.isfinite(rep.totalParams())
