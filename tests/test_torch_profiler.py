"""The port's profiler, telemetry kill switch, spans and trace exports,
and workspace shim (deeplearning4j_tpu_torch/util/{profiler,workspace}.py,
runtime/telemetry.py), under the reference's cases: tests/test_telemetry.py
``TestOpProfilerFacade`` and its span, JSONL and disabled cases, and
tests/test_serde.py ``TestWorkspace``/``TestProfiler``.

``compiled_cost`` of a matrix product equals the reference's (XLA's cost
analysis) exactly, flops and bytes; on a network it is held to the
operation count written out from the shapes (exact).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.util.profiler import compiled_cost as ref_cost
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.telemetry import MetricsRegistry
from deeplearning4j_tpu_torch.serving.queue import ManualClock
from deeplearning4j_tpu_torch.util import (MemoryWorkspace, OpProfiler,
                                           WorkspaceManager, annotate, trace)
from deeplearning4j_tpu_torch.util.profiler import (compiled_cost,
                                                    device_peak_flops, mfu)

torch.set_num_threads(1)


@pytest.fixture
def switch_restored():
    yield
    telemetry.set_enabled(True)


class TestOpProfilerFacade:
    def test_injectable_clock_deterministic(self):
        clk = ManualClock()
        prof = OpProfiler(clock=clk, registry=MetricsRegistry(clock=clk))
        for dt in (2.0, 0.25, 0.75):
            with prof.section("step"):
                clk.advance(dt)
        assert prof.compileTime("step") == 2.0
        assert prof.timeSpent("step") == 1.0
        assert prof.invocations("step") == 3
        assert prof.averageTime("step") == 0.5
        assert "step" in prof.printOutDashboard()

    def test_reset_and_registry_backing(self):
        clk = ManualClock()
        reg = MetricsRegistry(clock=clk)
        prof = OpProfiler(clock=clk, registry=reg)
        with prof.section("s"):
            clk.advance(1.0)
        with prof.section("s"):
            clk.advance(0.5)
        fam = reg.get("dl4j_profiler_section_seconds")
        assert fam.labels(section="s").count == 1
        assert reg.get("dl4j_profiler_compile_seconds") \
            .labels(section="s").value == 1.0
        assert [s["name"] for s in reg.trace.spans()] == ["profiler.s"] * 2
        prof.reset()
        assert prof.invocations("s") == 0
        assert prof.compileTime("s") == 0.0

    def test_thread_safety(self):
        prof = OpProfiler(registry=MetricsRegistry())
        n_threads, n_calls = 8, 200

        def work():
            for _ in range(n_calls):
                with prof.section("hot"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert prof.invocations("hot") == n_threads * n_calls

    def test_singleton_api_kept(self):
        assert OpProfiler.getInstance() is OpProfiler.getInstance()

    def test_reads_never_create_series(self):
        reg = MetricsRegistry()
        prof = OpProfiler(registry=reg)
        assert prof.timeSpent("never-timed") == 0.0
        assert prof.invocations("never-timed") == 0
        assert prof.averageTime("never-timed") == 0.0
        assert reg.get("dl4j_profiler_section_seconds") \
            .labels_get(section="never-timed") is None

    def test_disabled_mode_consistent(self, switch_restored):
        clk = ManualClock()
        prof = OpProfiler(clock=clk, registry=MetricsRegistry(clock=clk))
        telemetry.set_enabled(False)
        with prof.section("off"):
            clk.advance(1.0)
        telemetry.set_enabled(True)
        assert prof.invocations("off") == 0
        assert prof.compileTime("off") == 0.0
        assert prof.timeSpent("off") == 0.0

    def test_sections_and_compile_split_on_the_wall_clock(self):
        prof = OpProfiler.getInstance()
        prof.reset()
        import time
        for _ in range(3):
            with prof.section("step"):
                time.sleep(0.001)
        assert prof.invocations("step") == 3
        assert prof.compileTime("step") > 0
        assert prof.timeSpent("step") > 0
        assert "step" in prof.printOutDashboard()


class TestKillSwitchAndSpans:
    def test_disabled_is_noop(self, switch_restored):
        reg = MetricsRegistry()
        c = reg.counter("c").labels()
        g = reg.gauge("g")
        h = reg.histogram("h", buckets=(1.0,))
        assert telemetry.set_enabled(False) is False
        assert not telemetry.enabled()
        c.inc()
        g.set(3)
        h.labels().observe(0.5)
        with reg.span("s"):
            pass
        reg.event("e")
        reg.add_span("x", "c", 0.0, 1.0)
        telemetry.set_enabled(True)
        assert c.value == 0 and g.value == 0 and h.count == 0
        assert reg.trace.spans() == []
        c.inc()
        assert c.value == 1

    def test_span_and_event_round_trip(self, tmp_path):
        reg = MetricsRegistry()
        with reg.span("work", "cat", key="v"):
            pass
        reg.event("marker", "cat", n=1)
        path = reg.export_chrome_trace(str(tmp_path / "trace.json"))
        with open(path) as fh:
            evs = json.load(fh)["traceEvents"]
        assert len(evs) == 2
        x = [e for e in evs if e["ph"] == "X"][0]
        i = [e for e in evs if e["ph"] == "i"][0]
        assert x["name"] == "work" and x["cat"] == "cat"
        assert isinstance(x["ts"], float) and x["dur"] >= 0
        assert x["args"] == {"key": "v"}
        assert i["name"] == "marker" and i["s"] == "t" and "dur" not in i
        assert all(isinstance(e[k], int) for e in evs
                   for k in ("pid", "tid"))
        assert not os.path.exists(path + ".tmp")

    def test_jsonl_export(self, tmp_path):
        reg = MetricsRegistry()
        with reg.span("a"):
            pass
        with reg.span("b"):
            pass
        path = reg.export_jsonl(str(tmp_path / "trace.jsonl"))
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        assert [r["name"] for r in recs] == ["a", "b"]
        assert all(r["dur"] >= 0 for r in recs)

    def test_manual_clock_determinism(self):
        clk = ManualClock()
        reg = MetricsRegistry(clock=clk)
        with reg.span("step", "train", i=0):
            clk.advance(1.5)
        (s,) = reg.trace.spans()
        assert s["ts"] == 0.0 and s["dur"] == 1.5

    def test_the_span_records_when_its_block_raises(self):
        reg = MetricsRegistry()
        with pytest.raises(KeyError):
            with reg.span("boom"):
                raise KeyError("x")
        assert [s["name"] for s in reg.trace.spans()] == ["boom"]


class TestCosts:
    @pytest.mark.parametrize("m,k,n", [(64, 32, 16), (128, 256, 8)])
    def test_matmul_cost_equals_the_references(self, m, k, n):
        rng = np.random.RandomState(0)
        a = rng.randn(m, k).astype("float32")
        b = rng.randn(k, n).astype("float32")
        mine = compiled_cost(lambda x, y: x @ y, torch.from_numpy(a),
                             torch.from_numpy(b))
        want = ref_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
        assert mine == want
        assert mine["flops"] == 2 * m * k * n

    def test_network_flops_are_the_products_counted_from_the_shapes(self):
        from deeplearning4j_tpu_torch.nn import (ConvolutionLayer,
                                                 DenseLayer, InputType,
                                                 MultiLayerNetwork,
                                                 NeuralNetConfiguration,
                                                 OutputLayer)

        conf = (NeuralNetConfiguration.Builder().seed(0).list()
                .layer(ConvolutionLayer(nOut=8, kernelSize=(4, 4),
                                        stride=(2, 2), activation="relu"))
                .layer(DenseLayer(nOut=16, activation="relu"))
                .layer(OutputLayer(nOut=3, activation="identity",
                                   lossFunction="mse"))
                .setInputType(InputType.convolutional(12, 12, 2)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        x = torch.zeros(4, 2, 12, 12)
        macs = 5 * 5 * 8 * (4 * 4 * 2) + 5 * 5 * 8 * 16 + 16 * 3
        cost = compiled_cost(net._forward_infer, net._params, x)
        assert cost["flops"] == 2 * macs * 4
        assert cost["bytes_accessed"] > 0

    def test_no_peak_on_the_cpu(self):
        assert device_peak_flops("cpu") == 0.0
        assert mfu(1e12, 1.0, "cpu") == 0.0

    def test_peak_by_card_name(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "NVIDIA H100 80GB HBM3")
        assert device_peak_flops() == 989e12
        assert mfu(989e12, 2.0) == 0.5
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "NVIDIA A100-SXM4-80GB")
        assert device_peak_flops() == 0.0


class TestTrace:
    def test_trace_writes_a_chrome_trace_with_the_annotated_region(
            self, tmp_path):
        d = str(tmp_path / "prof")
        with trace(d):
            with annotate("rl.learn"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as fh:
            evs = json.load(fh)["traceEvents"]
        assert any(e.get("name") == "rl.learn" for e in evs)
        assert any("mm" in str(e.get("name")) for e in evs)


class TestWorkspace:
    def test_scoping(self):
        assert WorkspaceManager.getCurrentWorkspace() is None
        with MemoryWorkspace("A") as a:
            assert WorkspaceManager.getCurrentWorkspace() is a
            with MemoryWorkspace("B") as b:
                assert WorkspaceManager.getCurrentWorkspace() is b
            assert WorkspaceManager.getCurrentWorkspace() is a
        assert WorkspaceManager.getCurrentWorkspace() is None

    def test_corruption_detection(self):
        a = MemoryWorkspace("A").__enter__()
        b = MemoryWorkspace("B").__enter__()
        with pytest.raises(RuntimeError, match="corruption"):
            a.__exit__(None, None, None)
        b.__exit__(None, None, None)
        a.__exit__(None, None, None)

    def test_scope_out_and_activate(self):
        with WorkspaceManager.scopeOutOfWorkspaces():
            pass
        ws = WorkspaceManager.getAndActivateWorkspace("W")
        assert ws.isScopeActive()
        ws.notifyScopeLeft()
        assert WorkspaceManager.getCurrentWorkspace() is None
