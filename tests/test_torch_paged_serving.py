"""The port's paged serving path (deeplearning4j_tpu_torch/serving/) on the
CPU: scheduler, host and HTTP tier, mirroring tests/test_paged_serving.py
for the reference.

What must hold:
- the port's served logits match the JAX scheduler's for the same
  prompts, teacher-forced (the port replays the reference's sampled
  tokens, so both condition on the same history): f32 rtol 1e-4,
  atol 1e-5, as in test_torch_transformer;
- within a fixed slot bucket, paged generation (tokens AND logits) is
  BITWISE the port's own serial dense trajectory — ragged prompts,
  chunked prefill, prefix adoption and temperature sampling included;
- scheduling: one prefill chunk per iteration interleaved with decode,
  per-step deadlines free pages, pool exhaustion fails the victim only,
  an injected prefill fault fails only its request, staging is reused;
- the HTTP tier's status contract: 200, 404, 429 (full pool), 400 (a
  "steps" body, bad token ids), /healthz, /metrics, /v1/models.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.transformer import \
    CausalTransformerLM as RefLM
from deeplearning4j_tpu.serving import ManualClock as RefClock
from deeplearning4j_tpu.serving import \
    PagedSequenceScheduler as RefScheduler
from deeplearning4j_tpu_torch.nn.transformer import (
    CausalTransformerLM, dense_serial_trajectory,
)
from deeplearning4j_tpu_torch.ops import paged_attention as tpa
from deeplearning4j_tpu_torch.runtime.chaos import ChaosError, ChaosPlan
from deeplearning4j_tpu_torch.serving import (
    DeadlineExceededError, InferenceServer, KVCacheFullError, ManualClock,
    ModelHost, PagedSequenceScheduler, ServingClosedError, greedy_sampler,
    stream_rng, temperature_sampler,
)

torch.set_num_threads(1)

_CFG = dict(vocab=23, d_model=32, n_heads=2, n_layers=2, seed=3)


def _lm(max_context=64, page_size=8, **kw):
    return CausalTransformerLM(max_context=max_context, page_size=page_size,
                               device="cpu", **_CFG, **kw)


def _sched(model, **kw):
    kw.setdefault("num_pages", 48)
    kw.setdefault("slot_buckets", (4,))
    clk = kw.pop("clock", None) or ManualClock()
    return PagedSequenceScheduler(model, clock=clk, start_thread=False,
                                  **kw), clk


def _prompts(lens, vocab=23, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def _replay(tokens):
    """A sampler that returns the given tokens in order: teacher
    forcing through the scheduler's own sampling seam."""
    it = iter(list(tokens))
    return lambda logits, rng: int(next(it))


class TestAgainstReference:
    def test_served_logits_match_reference_teacher_forced(self):
        """Ragged prompts through the JAX scheduler (greedy), then the
        same prompts through the port's scheduler replaying the JAX
        tokens: every served logits row agrees (f32 rtol 1e-4,
        atol 1e-5) and the pages are all returned."""
        prompts = _prompts((5, 11, 3, 16))
        ref_model = RefLM(max_context=64, page_size=8, **_CFG)
        ref = RefScheduler(ref_model, num_pages=48, slot_buckets=(4,),
                           clock=RefClock(), start_thread=False)
        rreqs = [ref.submit(p, max_new_tokens=6, wait=False)
                 for p in prompts]
        ref.drain()
        ref.close()
        s, _ = _sched(_lm())
        reqs = [s.submit(p, max_new_tokens=6, wait=False,
                         sampler=_replay(r.wait(1.0)))
                for p, r in zip(prompts, rreqs)]
        s.drain()
        for got, want in zip(reqs, rreqs):
            assert got.wait(1.0).tolist() == want.result.tolist()
            np.testing.assert_allclose(got.logits, want.logits,
                                       rtol=1e-4, atol=1e-5)
        # only the prefix registry still holds pages: the prompts'
        assert s.cache.pages_in_use == sum(
            s.cache.pages_for(len(p)) for p in prompts)
        s.close()
        assert s.cache.pages_in_use == 0


class TestBitwiseVsSerial:
    def test_ragged_batch_bitwise_vs_serial_dense(self):
        m = _lm()
        s, _ = _sched(m)
        tpa.reset_launches()
        prompts = _prompts((5, 11, 3, 16))
        reqs = [s.submit(p, max_new_tokens=6, wait=False)
                for p in prompts]
        s.drain()
        # on the CPU every attention call is the plain version
        assert tpa.paged_attend.launches > 0
        assert tpa.paged_flash_decode.launches == 0
        for i, p in enumerate(prompts):
            toks, logits = dense_serial_trajectory(
                m, p, 6, greedy_sampler(), stream_rng(0, i), bucket=4)
            assert reqs[i].wait(1.0).tolist() == toks
            assert np.array_equal(reqs[i].logits.view(np.uint8),
                                  logits.view(np.uint8))
        s.close()

    def test_temperature_sampling_bitwise_vs_serial(self):
        m = _lm()
        smp = temperature_sampler(0.8, top_k=5)
        s, _ = _sched(m, sampler=temperature_sampler(0.8, top_k=5),
                      sampler_seed=42)
        prompts = _prompts((6, 9), seed=5)
        reqs = [s.submit(p, max_new_tokens=5, wait=False)
                for p in prompts]
        s.drain()
        for i, p in enumerate(prompts):
            toks, _ = dense_serial_trajectory(
                m, p, 5, smp, stream_rng(42, i), bucket=4)
            assert reqs[i].wait(1.0).tolist() == toks
        s.close()

    def test_prefix_adoption_stays_bitwise(self):
        m = _lm()
        s, _ = _sched(m)
        p = _prompts((13,), seed=9)[0]
        first = s.submit(p, max_new_tokens=4, wait=False)
        s.drain()
        chunks = s.prefill_chunks
        again = s.submit(p, max_new_tokens=4, wait=False)
        s.drain()
        assert s.prefill_chunks == chunks      # exact adopt: no prefill
        assert again.wait(1.0).tolist() == first.wait(1.0).tolist()
        toks, _ = dense_serial_trajectory(
            m, p, 4, greedy_sampler(), stream_rng(0, 1), bucket=4)
        assert again.result.tolist() == toks
        s.close()


class TestScheduling:
    def test_prefill_interleaves_without_stalling_decode(self):
        m = _lm()
        s, _ = _sched(m, slot_buckets=(2,), prefix_sharing=False)
        short = s.submit(_prompts((4,))[0], max_new_tokens=3, wait=False)
        s.poll()   # short: prefill + first decode -> 2 tokens
        long = s.submit(_prompts((32,), seed=2)[0], max_new_tokens=2,
                        wait=False)
        s.poll()   # long chunk 1 of 4; short token 3 -> done
        assert short.done and not long.done
        assert long.prefilled == 8 < 32
        s.drain()
        assert long.wait(1.0).shape == (2,)
        s.close()

    def test_deadline_mid_generation_frees_pages(self):
        m = _lm()
        s, clk = _sched(m, prefix_sharing=False)
        req = s.submit(_prompts((9,))[0], max_new_tokens=30, deadline=5.0,
                       wait=False)
        s.poll()
        s.poll()
        assert s.cache.pages_in_use > 0 and not req.done
        clk.advance(10.0)
        s.poll()
        with pytest.raises(DeadlineExceededError):
            req.wait(1.0)
        assert s.cache.pages_in_use == 0
        assert s.stats["expired"] == 1
        s.close()

    def test_close_without_drain_fails_and_frees(self):
        s, _ = _sched(_lm(), prefix_sharing=False)
        req = s.submit(_prompts((6,))[0], max_new_tokens=20, wait=False)
        s.poll()
        s.close(drain=False)
        with pytest.raises(ServingClosedError):
            req.wait(1.0)
        assert s.cache.pages_in_use == 0

    def test_midflight_exhaustion_fails_victim_only(self):
        s, _ = _sched(_lm(), num_pages=5, prefix_sharing=False,
                      slot_buckets=(2,))
        p = _prompts((4, 4))
        a = s.submit(p[0], max_new_tokens=14, wait=False)
        b = s.submit(p[1], max_new_tokens=14, wait=False)
        s.drain()
        results = []
        for r in (a, b):
            try:
                results.append(r.wait(1.0).tolist())
            except KVCacheFullError:
                results.append("full")
        assert results.count("full") == 1
        assert [len(r) for r in results if r != "full"] == [14]
        assert s.stats["errors"] == 1 and s.stats["completed"] == 1
        s.close()

    def test_injected_prefill_fault_fails_only_its_request(self):
        s, _ = _sched(_lm(), prefix_sharing=False)
        p = _prompts((5, 6))
        with ChaosPlan().raise_n("sequence.prefill", at=0) as plan:
            a = s.submit(p[0], max_new_tokens=3, wait=False)
            b = s.submit(p[1], max_new_tokens=3, wait=False)
            s.drain()
        assert plan.fired("sequence.prefill") == 1
        with pytest.raises(ChaosError):
            a.wait(1.0)
        assert b.wait(1.0).shape == (3,)
        assert s.cache.pages_in_use == 0
        s.close()

    @pytest.mark.parametrize("seam", ["host.submit_sequence",
                                      "kv.page_alloc", "sequence.prefill",
                                      "sequence.step"])
    def test_each_seam_fails_one_request_then_recovers(self, seam):
        """An injected fault at any serving seam fails exactly the
        request it hit (typed ChaosError), frees its pages, and the next
        request is served."""
        host = ModelHost(clock=ManualClock())
        host.register_sequence("lm", _lm(), slotBuckets=(1,), numPages=8,
                               prefixSharing=False)
        sched = host.sequence_model("lm").scheduler
        with ChaosPlan().raise_n(seam) as plan:
            try:
                req = host.generate("lm", [1, 2, 3], max_new_tokens=2,
                                    wait=False)
            except ChaosError:
                req = None                 # refused at submit
            sched.drain()
        assert plan.fired(seam) == 1
        if req is not None:
            with pytest.raises(ChaosError):
                req.wait(1.0)
        ok = host.generate("lm", [1, 2, 3], max_new_tokens=2, wait=False)
        sched.drain()
        assert ok.wait(1.0).shape == (2,)
        assert sched.cache.pages_in_use == 0
        host.close()

    def test_staging_reused_and_residency_bounded(self):
        """Decode staging is allocated once per bucket and reused; with
        6 of 8 slots live at ragged lengths the live pages cost <= 0.6x
        the dense twin's reservation, and every page comes back."""
        m = _lm()
        s, _ = _sched(m, slot_buckets=(8,), num_pages=64,
                      prefix_sharing=False)
        reqs = [s.submit(p, max_new_tokens=24, wait=False)
                for p in _prompts((10, 14, 18, 22, 26, 30))]
        for _ in range(20):
            s.poll()
        assert s.active_slots == 6 and s.occupancy[-1] == (6, 8)
        assert s.cache.bytes_in_use() <= 0.6 * m.dense_cache_bytes(8)
        s.drain()
        for r in reqs:
            assert r.wait(1.0).shape == (24,)
        assert s.staging_reuse_bytes > 0
        assert s.cache.pages_in_use == 0
        summary = s.occupancy_summary()
        assert summary["dispatches"] == len(s.occupancy)
        assert summary["mean_occupancy"] == round(
            sum(n / b for n, b in s.occupancy) / len(s.occupancy), 4)
        assert sum(summary["histogram"].values()) == len(s.occupancy)
        s.close()

    def test_warm_runs_every_bucket_and_the_prefill(self):
        s, _ = _sched(_lm(), slot_buckets=(1, 2))
        rep = s.warm()
        assert set(rep) == {"build", 1, 2, "prefill"}
        assert s.cache.pages_in_use == 0   # warm touches the null page only
        s.close()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class TestHostAndServer:
    def test_register_generate_swap(self):
        m = _lm()
        host = ModelHost()
        rep = host.register_sequence("lm", m, slotBuckets=(4,), numPages=32)
        assert rep["version"] == 1 and "prefill" in rep["warm"]
        pol = host.describe()["lm"]
        assert pol["paged"] and pol["pageSize"] == 8 \
            and pol["numPages"] == 32 and pol["device"] == "cpu"
        out = host.generate("lm", [1, 2, 3], max_new_tokens=4)
        toks, _ = dense_serial_trajectory(
            m, [1, 2, 3], 4, greedy_sampler(), stream_rng(0, 0), bucket=4)
        assert out.tolist() == toks
        assert host.queued_work("lm") == 0
        assert host.queued_work("nope") is None
        with pytest.raises(ValueError, match="register_sequence"):
            host.register("oneshot", m)
        assert "oneshot" not in host
        with pytest.raises(ValueError):
            host.register_sequence("lm", m)
        rep = host.swap_sequence("lm", _lm())
        assert rep["version"] == 2
        assert host.generate("lm", [1, 2, 3], max_new_tokens=4).tolist() \
            == toks
        host.close()

    def test_http_status_contract(self):
        host = ModelHost()
        host.register_sequence("lm", _lm(), slotBuckets=(2,), numPages=3)
        srv = InferenceServer(host).start(port=0)
        port = srv.port
        try:
            for _ in range(200):
                st, _ = _get(port, "/healthz")
                if st == 200:
                    break
                time.sleep(0.05)
            assert st == 200
            st, body = _post(port, "/v1/models/lm:generate",
                             {"tokens": [1, 2, 3], "maxNewTokens": 3})
            assert st == 200 and len(body["tokens"]) == 3 \
                and body["steps"] == 3 and body["version"] == 1
            # capacity 2 pages = 16 rows: never admissible -> 429
            st, body = _post(port, "/v1/models/lm:generate",
                             {"tokens": list(range(17)),
                              "maxNewTokens": 1})
            assert st == 429 and "pages" in body["error"]
            st, _ = _post(port, "/v1/models/lm:generate",
                          {"tokens": [9999], "maxNewTokens": 1})
            assert st == 400
            st, body = _post(port, "/v1/models/lm:generate",
                             {"steps": [[0.0, 1.0]]})
            assert st == 400 and "steps" in body["error"]
            st, _ = _post(port, "/v1/models/nope:generate",
                          {"tokens": [1]})
            assert st == 404
            st, text = _get(port, "/v1/models")
            assert st == 200 and json.loads(text)["models"]["lm"]["paged"]
            assert _get(port, "/v1/models/nope")[0] == 404
            with ChaosPlan().raise_n("server.request"):
                assert _get(port, "/v1/models")[0] == 500
            st, text = _get(port, "/metrics")
            assert st == 200 and "dl4j_seq_ttft_seconds_count" in text \
                and 'dl4j_http_requests_total{route="generate",code="429"}' \
                in text
        finally:
            srv.stop()
            host.close()

    def test_request_deadline_mode_keeps_the_status_contract(self):
        """With a per-request deadline each handler runs on a watched
        thread: answers and typed errors still reach the client."""
        host = ModelHost()
        host.register_sequence("lm", _lm(), slotBuckets=(1,), numPages=8)
        srv = InferenceServer(host).start(port=0, requestDeadline=60,
                                          warmup=None)
        try:
            st, body = _post(srv.port, "/v1/models/lm:generate",
                             {"tokens": [4, 5], "maxNewTokens": 2})
            assert st == 200 and len(body["tokens"]) == 2
            assert _get(srv.port, "/v1/models/nope")[0] == 404
            assert _get(srv.port, "/healthz")[0] == 200
        finally:
            srv.stop()
            host.close()
