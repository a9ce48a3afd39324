"""The port's chaos seams against the reference's.

- ``SEAMS`` is the reference's ten names in the reference's order, so a
  plan the reference arms (the aot and checkpoint seams included) is
  armed by the port without any other module imported first.
- ``aot.disk_read`` and ``aot.disk_write`` sit on the warm-start
  records' read and write: an injected raise or a corrupted path on a
  read is a miss; a fault on a write costs the record, never the
  process (the reference's ``ExecutableCache.get``/``put`` contract).
- A ``corrupt`` fault at ``sequence.step`` reaches the step in both of
  the port's schedulers (the payload is written back into the staging
  a captured step replays), and gives the reference's per-request
  outcome: which requests fail, which rows or tokens come out
  non-finite or different from the clean run.
- ``CausalTransformerLM`` gathers embedding and position rows with XLA's
  gather semantics: a token past the table takes the last row, a
  negative one counts from the end and is then clamped to row 0, so a
  corrupted token gives the reference's logits (f32 rtol 1e-4, atol
  1e-5, the decode test's band) instead of an index error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.nn.transformer as jtr
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.nn.transformer as ttr
from deeplearning4j_tpu.runtime import chaos as jchaos
from deeplearning4j_tpu.serving import ManualClock as RefClock
from deeplearning4j_tpu.serving import \
    PagedSequenceScheduler as RefPaged
from deeplearning4j_tpu.serving import SequenceScheduler as RefSeq
from deeplearning4j_tpu_torch.runtime import aot
from deeplearning4j_tpu_torch.runtime import chaos
from deeplearning4j_tpu_torch.serving import (
    ManualClock, PagedSequenceScheduler, SequenceScheduler,
)

torch.set_num_threads(1)

_LM = dict(vocab=23, d_model=32, n_heads=2, n_layers=2, max_context=64,
           page_size=8, seed=3)
_TOL = dict(rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# the inventory
# ----------------------------------------------------------------------

def test_seams_are_the_references_in_its_order():
    assert chaos.SEAMS == jchaos.SEAMS
    assert len(chaos.SEAMS) == 10


@pytest.mark.parametrize("seam", ["aot.disk_read", "aot.disk_write",
                                  "checkpoint.write", "checkpoint.restore"])
def test_reference_plans_arm_without_registration(seam):
    """A plan on the four seams the port used to lack arms as the
    reference's does: built in, no register_seam needed."""
    plan = chaos.ChaosPlan().raise_n(seam)
    chaos.arm(plan)
    try:
        with pytest.raises(chaos.ChaosError):
            chaos.fault_point(seam)
    finally:
        chaos.disarm()
    assert plan.events == [(seam, "raise", 0)]


# ----------------------------------------------------------------------
# aot.disk_read / aot.disk_write on the warm-start records
# ----------------------------------------------------------------------

class _Owner:
    pass


def _cache_with_record(tmp_path):
    cache = aot.ExecutableCache(str(tmp_path / "aot"))
    owner, entry = _Owner(), _Owner()
    cache.put("k" * 16, entry, owner=owner, record={"entry": "step"})
    assert cache.record("k" * 16)["entry"] == "step"
    return cache


class TestAotSeams:
    def test_injected_read_raise_is_a_miss(self, tmp_path):
        cache = _cache_with_record(tmp_path)
        with chaos.ChaosPlan().raise_n("aot.disk_read") as plan:
            assert cache.record("k" * 16) is None
        assert plan.fired("aot.disk_read") == 1
        assert cache.stats["corrupt"] == 1

    def test_corrupted_read_path_is_a_miss(self, tmp_path):
        cache = _cache_with_record(tmp_path)
        with chaos.ChaosPlan().corrupt("aot.disk_read", at=0):
            assert cache.record("k" * 16) is None
        assert cache.stats["corrupt"] == 1
        # the real record was never touched: the next read hits
        assert cache.record("k" * 16)["entry"] == "step"

    @pytest.mark.parametrize("exc", ["ChaosError", "OSError"])
    def test_write_fault_costs_the_record_not_the_process(self, tmp_path,
                                                          exc):
        cache = aot.ExecutableCache(str(tmp_path / "aot"))
        plan = chaos.ChaosPlan()
        if exc == "ChaosError":
            plan.raise_n("aot.disk_write")
        else:
            plan.raise_n("aot.disk_write", exc=OSError,
                         message="disk full")
        owner, entry = _Owner(), _Owner()
        with plan:
            cache.put("w" * 16, entry, owner=owner,
                      record={"entry": "step"})
        assert plan.fired("aot.disk_write") == 1
        assert cache.stats["store_errors"] == 1
        assert cache.record("w" * 16) is None
        # the memory level still works
        assert cache.get("w" * 16, owner) is entry

    def test_seam_coverage_reaches_both_aot_seams(self, tmp_path):
        from deeplearning4j_tpu_torch.analysis.faults import (
            coverage_gaps, seam_coverage,
        )

        def run():
            cache = _cache_with_record(tmp_path)
            assert cache.record("missing") is None
            cache.record("k" * 16)

        seams = ("aot.disk_read", "aot.disk_write")
        counts = seam_coverage(run, seams=seams)
        assert coverage_gaps(counts) == [], counts


# ----------------------------------------------------------------------
# the token clamp
# ----------------------------------------------------------------------

def _lm_pair():
    ref = jtr.CausalTransformerLM(dtype="float32", **_LM)
    port = ttr.CausalTransformerLM(dtype="float32", device="cpu", **_LM)
    port.load_reference_params(jax.tree.map(np.asarray, ref._params))
    return ref, port


@pytest.mark.parametrize("bad", [2 ** 31 - 1, 23, -1, -7, -(2 ** 31)])
def test_out_of_range_token_gives_the_references_logits(bad):
    """One decode step, slot 0 fed an out-of-range token, slot 1 a good
    one, both after a 5-token prefill: the port's clamped gather gives
    the reference's logits and pools."""
    ref, port = _lm_pair()
    L, Pn, page, H, Dh = 2, 6, 8, 2, 16
    jk = jnp.zeros((L, Pn, page, H, Dh), jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((L, Pn, page, H, Dh))
    tv = torch.zeros_like(tk)
    bts = np.zeros((2, 8), np.int32)
    bts[0, 0], bts[1, 0] = 4, 2
    prompt = np.zeros((8,), np.int32)
    prompt[:5] = [3, 1, 4, 1, 5]
    for slot in (0, 1):
        _, jk, jv = ref._jit_prefill(
            ref._params, prompt, jnp.asarray(0, jnp.int32),
            jnp.asarray(5, jnp.int32), jk, jv, bts[slot])
        _, tk, tv = port.prefill_paged(torch.from_numpy(prompt), 0, 5, tk,
                                       tv, torch.from_numpy(bts[slot]))
    toks = np.asarray([bad, 9], np.int64).astype(np.int32)
    sls = np.asarray([5, 5], np.int32)
    jl, jk, jv = ref._jit_decode(ref._params, toks, jk, jv, bts, sls)
    tl, tk, tv = port.decode_paged(torch.from_numpy(toks), tk, tv,
                                   torch.from_numpy(bts),
                                   torch.from_numpy(sls))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_TOL)
    np.testing.assert_allclose(tk[:, [4, 2]].numpy(),
                               np.asarray(jk)[:, [4, 2]], **_TOL)


def test_row_gather_is_xla_gather():
    """The gather behind tokens and positions takes the rows jnp's
    indexing takes, for every index from far below to far above the
    table (positions use the same gather, as the reference's
    ``pos[sls]``)."""
    table = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    idx = np.asarray([-(2 ** 31), -11, -10, -3, -1, 0, 4, 9, 10, 64,
                      2 ** 31 - 1], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = ttr._rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# corrupt at sequence.step, both schedulers, both packages
# ----------------------------------------------------------------------

def _rnn_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(7)
            .updater(M.Nesterovs(0.1, 0.9)).list()
            .layer(M.LSTM(nOut=8)).layer(M.GRU(nOut=8))
            .layer(M.RnnOutputLayer(nOut=5, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(4, 6)).build())


def _carry_outcome(sched, seqs, plan):
    reqs = [sched.submit(s, wait=False) for s in seqs]
    if plan is None:
        sched.drain()
    else:
        with plan:
            sched.drain()
    sched.close()
    out = []
    for r in reqs:
        if r.error is not None:
            out.append(("failed", type(r.error).__name__, None))
        else:
            res = np.asarray(r.result, np.float32)
            out.append(("served", None, res))
    return out


def test_corrupt_step_carry_slot_scheduler_matches_reference():
    jn = J.MultiLayerNetwork(_rnn_conf(J)).init()
    net = P.MultiLayerNetwork(_rnn_conf(P), device="cpu").init()
    net.load_reference_params(jax.tree.map(np.asarray, jn._params))
    rng = np.random.RandomState(21)
    seqs = [rng.randn(t, 4).astype(np.float32) for t in (5, 2, 7, 3)]

    def ref_run(plan):
        s = RefSeq(jn, slot_buckets=(4,), queue_limit=32, clock=RefClock(),
                   start_thread=False)
        return _carry_outcome(s, seqs, plan)

    def port_run(plan):
        s = SequenceScheduler(net, slot_buckets=(4,), queue_limit=32,
                              clock=ManualClock(), start_thread=False)
        return _carry_outcome(s, seqs, plan)

    rclean, pclean = ref_run(None), port_run(None)
    rbad = ref_run(jchaos.ChaosPlan(seed=5).corrupt("sequence.step", at=0))
    pbad = port_run(chaos.ChaosPlan(seed=5).corrupt("sequence.step", at=0))
    hit = 0
    for rc, pc, rb, pb in zip(rclean, pclean, rbad, pbad):
        assert rb[:2] == pb[:2]
        if rb[0] != "served":
            continue
        # the same rows come out non-finite, and the same rows differ
        # from the clean run
        np.testing.assert_array_equal(~np.isfinite(pb[2]),
                                      ~np.isfinite(rb[2]))
        rdiff = ~np.all(np.isclose(rb[2], rc[2], equal_nan=False), axis=-1)
        pdiff = ~np.all(np.isclose(pb[2], pc[2], equal_nan=False), axis=-1)
        np.testing.assert_array_equal(pdiff, rdiff)
        fin = np.isfinite(rb[2])
        np.testing.assert_allclose(pb[2][fin], rb[2][fin], rtol=1e-5,
                                   atol=1e-6)
        hit += int(rdiff.any())
    assert hit == 1      # the corruption reached exactly one request


def test_corrupt_step_paged_scheduler_matches_reference():
    """The corrupted token (int32 max) of request 0's first decode step
    takes the embedding's last row in both packages: the port replays the
    reference's chaos-run tokens and serves its logits."""
    prompts = [[5, 1, 7], [2, 9, 11, 4, 8], [13, 3]]

    def ref_run(plan):
        m = jtr.CausalTransformerLM(**_LM)
        s = RefPaged(m, num_pages=24, slot_buckets=(4,), clock=RefClock(),
                     start_thread=False, prefix_sharing=False)
        reqs = [s.submit(p, max_new_tokens=4, wait=False) for p in prompts]
        if plan is None:
            s.drain()
        else:
            with plan:
                s.drain()
        s.close()
        return reqs

    def port_run(plan, teacher):
        m = ttr.CausalTransformerLM(device="cpu", **_LM)
        s = PagedSequenceScheduler(m, num_pages=24, slot_buckets=(4,),
                                   clock=ManualClock(), start_thread=False,
                                   prefix_sharing=False)
        reqs = [s.submit(p, max_new_tokens=4, wait=False,
                         sampler=_replay(t.result))
                for p, t in zip(prompts, teacher)]
        if plan is None:
            s.drain()
        else:
            with plan:
                s.drain()
        s.close()
        return reqs

    rclean = ref_run(None)
    rbad = ref_run(jchaos.ChaosPlan(seed=5).corrupt("sequence.step", at=0))
    pclean = port_run(None, rclean)
    pbad = port_run(chaos.ChaosPlan(seed=5).corrupt("sequence.step", at=0),
                    rbad)
    changed = []
    for rc, pc, rb, pb in zip(rclean, pclean, rbad, pbad):
        assert (rb.error is None) == (pb.error is None)
        np.testing.assert_allclose(pb.logits, rb.logits, **_TOL)
        np.testing.assert_allclose(pc.logits, rc.logits, **_TOL)
        assert np.isfinite(pb.logits).all() == np.isfinite(
            rb.logits).all()
        rdiff = not np.allclose(rb.logits, rc.logits, **_TOL)
        pdiff = not np.allclose(pb.logits, pc.logits, **_TOL)
        assert rdiff == pdiff
        changed.append(pdiff)
    assert changed == [True, False, False]


def _replay(tokens):
    it = iter(list(np.asarray(tokens).tolist()))
    return lambda logits, rng: int(next(it))
