"""The port's thread-safety lint (``analysis/threads.py``) against the
reference's (``tests/test_thread_analysis.py``).

- Parity: every source snippet of the reference's thread tests gives
  the same THR codes on the same lines through both packages' passes.
- The retargeted THR03: the device round trips of the port
  (``torch.cuda.synchronize``, ``Event.synchronize``, ``.item()``,
  ``.cpu()``, ``.tolist()``, a graph's ``replay()``, a ``CapturedStep``
  call) under a held lock are flagged; the same calls outside it are
  not.
- Suppressions need a reason; the port's threaded tier lints clean with
  reasoned suppressions only; the CLI's ``--concurrency`` contract.
- The repairs the pass paid for: ``ParallelInference`` builds one
  ``CapturedStep`` under concurrent first calls, and a threaded
  scheduler's ``warm()`` no longer waits forever on a dead loop.
"""

import os
import textwrap
import threading
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu.analysis.threads import \
    lint_thread_source as ref_lint
from deeplearning4j_tpu_torch.analysis.threads import (
    THREADED_TIER, lint_thread_paths, lint_thread_source,
    threaded_tier_paths,
)

from _torch_analysis_snippets import snippets

torch.set_num_threads(1)

_SNIPPETS = snippets("test_thread_analysis.py")


def _found(rep):
    return sorted((d.code, d.where.rsplit(":", 2)[-2], d.suppressed)
                  for d in rep.diagnostics)


@pytest.mark.parametrize("i", range(len(_SNIPPETS)))
def test_reference_snippets_give_the_same_codes_and_lines(i):
    src = _SNIPPETS[i]
    want = _found(ref_lint(src, "s.py"))
    got = _found(lint_thread_source(src, "s.py"))
    assert got == want, src


def test_the_snippets_cover_every_thr_code():
    codes = set()
    for src in _SNIPPETS:
        codes |= set(lint_thread_source(src, "s.py").codes())
    assert {"THR01", "THR02", "THR03", "THR04"} <= codes


_LOCKED = textwrap.dedent('''
    import threading
    import torch

    class Server:
        def __init__(self):
            self._lock = threading.Lock()
            self._graph = torch.cuda.CUDAGraph()
            self._captured = None
            self._ev = torch.cuda.Event()

        def step(self, t):
            with self._lock:
                {call}
''')


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()", "self._ev.synchronize()", "t.item()",
    "t.cpu()", "t.tolist()", "self._graph.replay()", "self._captured(t)",
])
def test_device_round_trip_under_a_lock_is_thr03(call):
    rep = lint_thread_source(_LOCKED.format(call=call), "s.py")
    assert rep.codes() == ["THR03"], rep.format()
    outside = _LOCKED.format(call="pass").replace(
        "            with self._lock:\n                pass",
        f"            {call}")
    assert lint_thread_source(outside, "s.py").codes() == []


def test_suppression_needs_a_reason():
    src = _LOCKED.format(call="t.item()  # thread-ok[THR03]: a 0-d host "
                              "tensor, no device round trip")
    rep = lint_thread_source(src, "s.py")
    assert rep.ok and len(rep.suppressed) == 1
    bare = _LOCKED.format(call="t.item()  # thread-ok[THR03]")
    assert not lint_thread_source(bare, "s.py").ok


# ----------------------------------------------------------------------
# the port's own tier
# ----------------------------------------------------------------------

class TestSelfCheck:
    def test_threaded_tier_lints_clean(self):
        rep = lint_thread_paths()
        assert rep.ok, rep.format(verbose=True)
        for d in rep.suppressed:
            assert "thread-ok" in Path(d.where.split(":")[0]).read_text()

    def test_tier_paths_exist(self):
        assert all(os.path.exists(p) for p in threaded_tier_paths())
        assert THREADED_TIER[0] == "serving"

    def test_every_serving_module_is_in_the_tier(self):
        import deeplearning4j_tpu_torch.serving as s
        from deeplearning4j_tpu_torch.analysis.purity import iter_py_files

        base = Path(s.__file__).parent
        linted = {os.path.abspath(p)
                  for p in iter_py_files(threaded_tier_paths())}
        assert {str(p) for p in base.glob("*.py")} <= linted

    def test_cli_concurrency_contract(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.analysis.cli import main

        assert main(["--concurrency"]) == 0
        bad = tmp_path / "bad.py"
        bad.write_text(_LOCKED.format(call="torch.cuda.synchronize()"))
        assert main(["--concurrency", str(bad)]) == 1
        assert main(["--concurrency", str(tmp_path / "missing.py")]) == 2
        assert main(["--concurrency", "--failpaths"]) == 2
        capsys.readouterr()


# ----------------------------------------------------------------------
# the repairs
# ----------------------------------------------------------------------

def _inference_model():
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(P.DenseLayer(nOut=4))
            .layer(P.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(P.InputType.feedForward(3)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def test_concurrent_first_captures_build_one_captured_step():
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    pi = ParallelInference(_inference_model())
    barrier = threading.Barrier(8)
    got = []

    def first():
        barrier.wait()
        got.append(pi._forward_capture())

    ts = [threading.Thread(target=first) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert len(got) == 8 and len({id(c) for c in got}) == 1


def test_warm_on_a_dead_scheduler_thread_raises_instead_of_hanging():
    from deeplearning4j_tpu_torch.serving import ManualClock, \
        SequenceScheduler
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder().seed(7).list()
            .layer(P.LSTM(nOut=4))
            .layer(P.RnnOutputLayer(nOut=3, activation="softmax"))
            .setInputType(P.InputType.recurrent(2, 4)).build())
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    s = SequenceScheduler(net, slot_buckets=(2,), clock=ManualClock(),
                          start_thread=False)
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    s._thread = dead                    # a loop thread that has ended
    with pytest.raises(RuntimeError, match="ended before it warmed"):
        s.warm()
    s._thread = None
    s.close()
