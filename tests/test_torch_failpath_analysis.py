"""The port's failure-path lint and seam-coverage proof
(``analysis/faults.py``) against the reference's
(``tests/test_failpath_analysis.py``).

- Parity: every source snippet of the reference's fail-path tests gives
  the same FLT codes on the same lines through both packages' passes,
  over one seam universe.
- The pass finds the faults the port carried: the previous warm-start
  record read and write (no ``aot.disk_*`` seam: FLT02 on each), and,
  against the reference's ten-name inventory, the seams the previous
  tree never fired (FLT06). The repaired ``runtime/aot.py`` lints clean.
- The port's threaded tier lints clean with reasoned suppressions only;
  the CLI's ``--failpaths`` contract.
- The runtime twin: under a soak over the fleet, the carry-slot and
  paged schedulers, HTTP, the warm-start records and ResilientFit, every
  registered seam fires (``coverage_gaps`` is empty).
"""

import json
import textwrap
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis.faults import \
    lint_fault_source as ref_lint
from deeplearning4j_tpu.runtime import chaos as jchaos
from deeplearning4j_tpu_torch.analysis.faults import (
    coverage_gaps, lint_fault_paths, lint_fault_source, seam_coverage,
)
from deeplearning4j_tpu_torch.runtime import chaos

from _torch_analysis_snippets import snippets

torch.set_num_threads(1)

_SNIPPETS = snippets("test_failpath_analysis.py")
_UNIVERSE = tuple(jchaos.SEAMS) + ("x.y", "kv.page_alloc",
                                   "sequence.prefill")


@pytest.fixture(autouse=True)
def _only_the_ports_seams(monkeypatch):
    """Seams other test files register in this process (a worker runs
    several files) are not the port's: the tier's dead-seam check and
    the coverage soak are about the port's own."""
    monkeypatch.setattr(chaos, "_EXTRA_SEAMS",
                        {"kv.page_alloc", "sequence.prefill"})


def _found(rep):
    return sorted((d.code, d.where.rsplit(":", 2)[-2], d.suppressed)
                  for d in rep.diagnostics)


@pytest.mark.parametrize("i", range(len(_SNIPPETS)))
def test_reference_snippets_give_the_same_codes_and_lines(i):
    src = _SNIPPETS[i]
    want = _found(ref_lint(src, "s.py", seams=_UNIVERSE))
    got = _found(lint_fault_source(src, "s.py", seams=_UNIVERSE))
    assert got == want, src


def test_the_snippets_cover_every_flt_code():
    codes = set()
    for src in _SNIPPETS:
        codes |= set(lint_fault_source(src, "s.py", seams=_UNIVERSE).codes())
    assert {f"FLT0{i}" for i in range(1, 7)} <= codes


# the warm-start record read and write as the previous tree had them:
# no seam on either
_PREVIOUS_AOT = textwrap.dedent('''
    import json
    import os
    import tempfile


    class ExecutableCache:
        def record(self, key, ambient=None):
            path = self._path(key)
            if not os.path.exists(path):
                return None
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    rec = json.load(fh)
                if not isinstance(rec, dict):
                    raise ValueError("not a record")
            except (OSError, ValueError, UnicodeDecodeError):
                self._bad(path, "corrupt")
                return None
            return rec

        def put(self, key, entry, owner=None, record=None):
            try:
                fd, tmp = tempfile.mkstemp(dir=self.directory)
                try:
                    with os.fdopen(fd, "w", encoding="utf-8") as fh:
                        json.dump(record, fh, indent=1)
                    os.replace(tmp, self._path(key))
                except BaseException:
                    self._remove(tmp)
                    raise
            except OSError:
                with self._lock:
                    self.stats["store_errors"] += 1
''')


def test_the_previous_record_io_is_flagged(tmp_path):
    """FLT02 on the read (``open``) and on the atomic write
    (``os.fdopen``); and, with the two aot seams as the universe, both
    are dead inventory (FLT06) there and fired in the repaired file."""
    rep = lint_fault_source(_PREVIOUS_AOT, "aot.py", seams=_UNIVERSE)
    fns = sorted(d.message.split("`")[1] for d in rep.errors
                 if d.code == "FLT02")
    assert fns == ["put", "record"], rep.format()
    prev = tmp_path / "aot.py"
    prev.write_text(_PREVIOUS_AOT)
    aot_seams = ("aot.disk_read", "aot.disk_write")
    dead = lint_fault_paths([str(prev)], seams=aot_seams)
    assert sorted(d.where for d in dead.errors if d.code == "FLT06") == [
        "chaos.SEAMS:aot.disk_read", "chaos.SEAMS:aot.disk_write"]
    import deeplearning4j_tpu_torch.runtime.aot as aot

    assert lint_fault_paths([aot.__file__], seams=aot_seams).ok


def test_the_repaired_aot_lints_clean():
    import deeplearning4j_tpu_torch.runtime.aot as aot

    rep = lint_fault_paths([aot.__file__])
    assert rep.ok, rep.format()
    assert any(d.code == "FLT01" for d in rep.suppressed)


def test_the_references_inventory_is_fired_by_the_port():
    """Against the reference's ten seams (plus the two the serving tier
    registers), no seam of the port's tier is dead: the previous tree's
    tier fired neither ``aot.disk_*`` seam and would fail this."""
    rep = lint_fault_paths(seams=_UNIVERSE[:10] + _UNIVERSE[11:])
    assert not [d for d in rep.errors if d.code == "FLT06"], rep.format()
    prev = lint_fault_source(_PREVIOUS_AOT, "aot.py", seams=_UNIVERSE)
    assert "FLT02" in prev.codes()


class TestSelfCheck:
    def test_threaded_tier_lints_clean(self):
        rep = lint_fault_paths()
        assert rep.ok, rep.format(verbose=True)
        assert len(rep.suppressed) >= 1

    def test_cli_failpaths_contract(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.analysis.cli import main

        assert main(["--failpaths"]) == 0
        bad = tmp_path / "bad.py"
        bad.write_text(_PREVIOUS_AOT)
        assert main(["--failpaths", str(bad)]) == 1
        assert main(["--failpaths", str(tmp_path / "nope.py")]) == 2
        assert main(["--codes"]) == 0
        out = capsys.readouterr().out
        assert all(f"FLT0{i}" in out for i in range(1, 7))

    def test_cli_failpaths_json(self, capsys):
        from deeplearning4j_tpu_torch.analysis.cli import main

        assert main(["--failpaths", "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["ok"] is True


def test_the_seam_inventory_is_the_references():
    assert chaos.SEAMS == jchaos.SEAMS


# ----------------------------------------------------------------------
# the runtime twin over a live soak
# ----------------------------------------------------------------------

def _mln(seed=7):
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Nesterovs(0.1, 0.9)).list()
            .layer(P.DenseLayer(nOut=16, activation="relu"))
            .layer(P.OutputLayer(nOut=4, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(P.InputType.feedForward(8)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _rnn_net(seed=7):
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Nesterovs(0.1, 0.9)).list()
            .layer(P.LSTM(nOut=8))
            .layer(P.RnnOutputLayer(nOut=5, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(P.InputType.recurrent(4, 6)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _mlp_net(seed=42):
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder().seed(seed)
            .updater(P.Adam(1e-2)).activation("relu").list()
            .layer(P.DenseLayer(nOut=16))
            .layer(P.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(P.InputType.feedForward(4)).build())
    return P.MultiLayerNetwork(conf, device="cpu").init()


def _data_iter(n=16, batch=8, seed=0):
    from deeplearning4j_tpu_torch.data import DataSetIterator

    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, n)]
    return DataSetIterator(x, y, batch)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def test_every_registered_seam_fires(tmp_path):
    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM
    from deeplearning4j_tpu_torch.runtime.aot import ExecutableCache
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilientFit, RetryPolicy,
    )
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter, InferenceServer, ModelHost,
    )

    fleet = FleetRouter()
    for _ in range(2):
        fleet.add_replica(ModelHost())
    fleet.register("m", _mln(), batchBuckets=(8,), maxWaitMs=1.0)
    host = ModelHost()
    host.register_sequence("s", _rnn_net(), slotBuckets=(4,))
    host.register_sequence(
        "g", CausalTransformerLM(vocab=11, d_model=8, n_heads=1,
                                 n_layers=1, max_context=8, page_size=4,
                                 seed=0, device="cpu"),
        slotBuckets=(2,), numPages=8)
    srv = InferenceServer(host).start(port=0, warmup=False)
    disk = ExecutableCache(str(tmp_path / "aot"))
    seq = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    fast = RetryPolicy(maxRetries=2, initialDelay=0.001, maxDelay=0.002,
                       sleep=lambda s: None)
    base = f"http://127.0.0.1:{srv.port}"

    class _Owner:
        pass

    owner, entry = _Owner(), _Owner()

    def run():
        fleet.submit("m", np.random.RandomState(0).randn(2, 8)
                     .astype(np.float32))
        host.submit_sequence("s", seq)
        host.generate("g", [1, 2, 3, 4, 5], max_new_tokens=1)
        _get(base + "/v1/models")
        disk.put("k" * 16, entry, owner=owner, record={"entry": "step"})
        assert disk.record("k" * 16) is not None
        net = _mlp_net()
        ResilientFit(net, tmp_path / "ck", saveEveryNIterations=1,
                     keepLast=2, retryPolicy=fast).fit(_data_iter())
        net2 = _mlp_net()
        ResilientFit(net2, tmp_path / "ck", saveEveryNIterations=1,
                     keepLast=2, retryPolicy=fast).fit(_data_iter())

    try:
        counts = seam_coverage(run)
    finally:
        srv.stop()
        host.close(drain=True)
        fleet.close()
    assert set(jchaos.SEAMS) <= set(counts)
    assert coverage_gaps(counts) == [], counts
