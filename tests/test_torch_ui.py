"""The port's training report and UIServer against the reference's
(``deeplearning4j_tpu/optimize/ui.py``): the same StatsListener logs
render to the same report (but for its timestamp line), logs written by
either package's StatsListener render, and the live server answers its
routes with the reference's codes and bodies. Mirrors
``tests/test_serving.py::TestUIServerLive`` (stdlib urllib against
127.0.0.1, ephemeral ports)."""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import ui as jui
from deeplearning4j_tpu_torch.optimize import StatsListener, UIServer
from deeplearning4j_tpu_torch.optimize import ui as pui

torch.set_num_threads(1)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


@pytest.fixture
def stats_log(tmp_path):
    p = tmp_path / "stats.jsonl"
    with open(p, "w") as fh:
        for i in range(8):
            fh.write(json.dumps({"type": "stats", "iteration": i,
                                 "score": 2.0 / (i + 1),
                                 "iterationsPerSec": 10.0 + i,
                                 "paramMeanAbs": 0.1 * i,
                                 "time": 100.0 + i}) + "\n")
        fh.write(json.dumps({"type": "stats", "iteration": 8,
                             "score": float("nan")}) + "\n")
        fh.write(json.dumps({"type": "epochEnd", "epoch": 0}) + "\n")
        fh.write('{"type": "stats", "iter')          # torn tail
    return p


def _undated(doc):
    return re.sub(r"generated [0-9: -]+ from", "generated from", doc)


def test_report_equals_the_reference(stats_log, tmp_path):
    got = pui.render_report(stats_log, tmp_path / "r.html", title="T")
    want = jui.render_report(stats_log, title="T")
    assert _undated(got) == _undated(want)
    assert (tmp_path / "r.html").read_text() == got
    assert "non-finite scores dropped" in got and "<svg" in got


def _port_log(tmp_path):
    from deeplearning4j_tpu_torch.nn import (
        Adam, DenseLayer, MultiLayerNetwork, NeuralNetConfiguration,
        OutputLayer,
    )

    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .list().layer(DenseLayer(nIn=4, nOut=8, activation="tanh"))
            .layer(OutputLayer(nOut=2, activation="softmax",
                               lossFunction="MCXENT")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    log = tmp_path / "port.jsonl"
    net.setListeners(StatsListener(logFile=log, frequency=1))
    rng = np.random.RandomState(0)
    X = rng.randn(16, 4).astype("float32")
    Y = np.eye(2, dtype="float32")[rng.randint(0, 2, 16)]
    for _ in range(5):
        net.fit(X, Y)
    return log


def _ref_log(tmp_path):
    from deeplearning4j_tpu.nn import (
        Adam, DenseLayer, MultiLayerNetwork, NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.optimize import StatsListener as JStats

    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .list().layer(DenseLayer(nIn=4, nOut=8, activation="tanh"))
            .layer(OutputLayer(nOut=2, activation="softmax",
                               lossFunction="MCXENT")).build())
    net = MultiLayerNetwork(conf).init()
    log = tmp_path / "ref.jsonl"
    net.setListeners(JStats(logFile=str(log), frequency=1))
    rng = np.random.RandomState(0)
    X = rng.randn(16, 4).astype("float32")
    Y = np.eye(2, dtype="float32")[rng.randint(0, 2, 16)]
    for _ in range(5):
        net.fit(X, Y)
    return log


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stats_listener_logs_of_either_package_render(writer, tmp_path):
    log = (_port_log if writer == "port" else _ref_log)(tmp_path)
    got = pui.render_report(log)
    assert _undated(got) == _undated(jui.render_report(log))
    assert "score vs iteration" in got and "final score" in got
    assert "<polyline" in got


def test_dashboard_and_polling_roundtrip(stats_log):
    ui = UIServer().attach(str(stats_log)).start(port=0)
    try:
        base = f"http://127.0.0.1:{ui.port}"
        status, html_doc = _get(base + "/")
        assert status == 200
        assert "http-equiv='refresh'" in html_doc
        assert "score vs iteration" in html_doc
        assert "0.25" in html_doc  # final finite score 2/8
        status, body = _get(base + "/train/0/updates?since=0")
        upd = json.loads(body)
        assert status == 200 and upd["next"] == 10
        assert upd["records"][0]["score"] == 2.0
        with open(stats_log, "a") as fh:    # complete the torn tail
            fh.write('ation": 9, "score": 0.2}\n')
        status, body = _get(base + f"/train/0/updates?since={upd['next']}")
        upd2 = json.loads(body)
        assert [r["iteration"] for r in upd2["records"]] == [9]
        status, body = _get(base + "/sources")
        assert json.loads(body)["sources"] == [str(stats_log)]
        status, body = _get(base + "/train/updates?since=9")
        assert json.loads(body)["records"][0]["type"] == "epochEnd"
    finally:
        ui.stop()
    assert ui.port is None


@pytest.mark.parametrize("bad,code", [("/train/5", 404), ("/train/-1", 404),
                                      ("/nope", 404), ("/train/abc", 400),
                                      ("/train/0/updates?since=abc", 400)])
def test_error_routes_as_the_reference(stats_log, bad, code):
    ui = UIServer().attach(str(stats_log)).start(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{ui.port}{bad}")
        assert ei.value.code == code
    finally:
        ui.stop()


def test_attach_detach_and_render(tmp_path, stats_log):
    ui = UIServer()
    with pytest.raises(ValueError, match="logFile"):
        ui.attach(StatsListener())
    ui.attach(StatsListener(logFile=stats_log)).attach(str(stats_log))
    docs = ui.render(outFile=tmp_path / "out")
    assert len(docs) == 2 and (tmp_path / "out.1.html").exists()
    ui.detach(str(stats_log))
    assert ui.render() == []
    assert UIServer.getInstance() is UIServer.getInstance()
