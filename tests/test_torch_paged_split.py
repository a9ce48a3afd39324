"""The split plan of the paged kernels K4 and K5 (deeplearning4j_tpu_torch/
ops/paged_attention.py and csrc/paged_attention.cu), modelled in plain
PyTorch on the CPU where no kernel can run.

The kernels cut each row's KV walk into spans of ``SPLIT_PAGES`` logical
pages, compute a softmax partial (m, l, acc) per span and merge a row's
live spans in split order. ``split_partials_plain`` / ``combine_plain``
model that; here they are held against the reference K4 and K5 in
Pallas interpret mode at the span boundaries (span * page - 1, span *
page, span * page + 1 and 2 * span * page + 1 keys, a length-0 slot,
prefill tail chunks and chunks whose t0 starts a new span), and the
combine's algebra and batch invariance are checked on their own.

Tolerances (model vs reference, same inputs), as in
tests/test_torch_paged_attention.py:
- f32: rtol 1e-5, atol 1e-6 — both sum in f32; the split only regroups
  the sums (per span, then a weighted merge).
- bf16: at most 1 bf16 ulp — both round one f32 value once.
- lse: rtol 1e-5, atol 1e-5.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import pallas_attention as pa
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

H, D, PAGE = 2, 8, 4
SPAN = tpa.SPLIT_PAGES * PAGE          # keys per split: 16
BOUNDARY_LENS = [SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 1, 0, 1]


def bf16_ulp_distance(a, b):
    def ordered(x):
        bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


def assert_close(got, ref, dtype):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "bfloat16":
        assert bf16_ulp_distance(got, ref).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _to(dtype, x):
    """numpy f32 -> (torch tensor in dtype, numpy array JAX takes in the
    same dtype) carrying identical values."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, t.float().numpy().astype(jnp.bfloat16)
    return t, t.numpy().copy()


def _tables(rng, lens, P, MP):
    """Block tables over a permutation of pages 1..P-1; unused entries
    point at the null page 0."""
    order = rng.permutation(np.arange(1, P))
    bts = np.zeros((len(lens), MP), np.int32)
    k = 0
    for s, n in enumerate(lens):
        for j in range(-(-n // PAGE)):
            bts[s, j] = order[k]
            k += 1
    return bts


def _inputs(seed, lens, MP, P=40):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((P, PAGE, H, D)).astype(np.float32)
    vp = rng.standard_normal((P, PAGE, H, D)).astype(np.float32)
    q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
    return rng, q, kp, vp, _tables(rng, lens, P, MP)


def test_split_constant_is_the_kernel_source_constant():
    """The wrapper sizes the workspace and the model plans the spans with
    SPLIT_PAGES; the kernels with kSplitPages. They must be one number."""
    src = next(s for s in _kernels.SOURCES if s.name == "paged_attention.cu")
    found = re.findall(r"constexpr int kSplitPages = (\d+);", src.read_text())
    assert found == [str(tpa.SPLIT_PAGES)]


class TestSplitModelVsReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_at_span_boundaries(self, dtype):
        """The split model of K4 vs the reference K4 in interpret mode:
        lengths around one and two spans, a length-0 slot, output and
        lse."""
        MP = 3 * tpa.SPLIT_PAGES - 1     # a last split of fewer pages
        _, q, kp, vp, bts = _inputs(0, BOUNDARY_LENS, MP)
        (tq, jq), (tk, jk), (tv, jv) = (_to(dtype, x) for x in (q, kp, vp))
        sls = np.asarray(BOUNDARY_LENS, np.int32)
        ref, ref_lse = pa.paged_flash_decode(
            jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv), bts, sls,
            need_lse=True, interpret=True)
        out, lse = tpa.paged_decode_split_plain(
            tq, tk, tv, torch.from_numpy(bts), torch.from_numpy(sls),
            need_lse=True)
        assert out.dtype == tq.dtype
        assert_close(out.float().numpy(), np.asarray(ref, np.float32), dtype)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   rtol=1e-5, atol=1e-5)
        assert torch.all(out[4] == 0)
        assert torch.all(lse[4] == tpa.LSE_EMPTY)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("T", [2 * SPAN + 1, 2 * SPAN - 2])
    def test_prefill_chunks_across_spans(self, dtype, T):
        """Every page-sized chunk of a T-token prompt through the split
        model of K5 vs the reference K5 in interpret mode: chunks whose
        t0 starts a new span (16, 32) and a tail chunk."""
        MP = -(-T // PAGE)
        rng, _, kp, vp, bts = _inputs(1, [T], MP, P=16)
        (tk, jk), (tv, jv) = (_to(dtype, x) for x in (kp, vp))
        bt = bts[0]
        for c in range(MP):
            t0 = c * PAGE
            n_valid = min(PAGE, T - t0)
            tq, jq = _to(dtype, rng.standard_normal((PAGE, H, D)))
            ref = pa.paged_flash_prefill(jnp.asarray(jq), jnp.asarray(jk),
                                         jnp.asarray(jv), bt, t0, n_valid,
                                         interpret=True)
            out = tpa.paged_prefill_split_plain(tq, tk, tv,
                                                torch.from_numpy(bt), t0,
                                                n_valid)
            assert out.shape == tq.shape and out.dtype == tq.dtype
            assert_close(out[:n_valid].float().numpy(),
                         np.asarray(ref, np.float32)[:n_valid], dtype)

    @pytest.mark.parametrize("lens", [[SPAN], [SPAN + 1, 2 * SPAN + 1],
                                      [0, 3]])
    def test_model_matches_the_single_walk(self, lens):
        """The split model against the page-sequential plain version
        (the kernels' oracle), f32: the regrouped sums agree within the
        f32 tolerance, lse within 1e-5."""
        _, q, kp, vp, bts = _inputs(2, lens, 2 * tpa.SPLIT_PAGES + 1)
        args = (torch.from_numpy(q), torch.from_numpy(kp),
                torch.from_numpy(vp), torch.from_numpy(bts),
                torch.tensor(lens, dtype=torch.int32))
        out, lse = tpa.paged_decode_split_plain(*args, need_lse=True)
        ref, ref_lse = tpa.paged_decode_plain(*args, need_lse=True)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


def _partials(lens, MP=3 * tpa.SPLIT_PAGES, seed=3):
    _, q, kp, vp, bts = _inputs(seed, lens, MP)
    bt = torch.from_numpy(bts).long()
    sl = torch.tensor(lens, dtype=torch.int32)
    q = torch.from_numpy(q)[:, None]
    kp, vp = torch.from_numpy(kp)[bt], torch.from_numpy(vp)[bt]
    return (q, kp, vp, sl), tpa.split_partials_plain(q, kp, vp, sl,
                                                     sl.long() - 1)


class TestCombine:
    def test_live_split_counts(self):
        """n_live = ceil(length / (SPLIT_PAGES * page)): the plan reads
        only the row's own length."""
        _, (m, _, _, n_live) = _partials(BOUNDARY_LENS)
        assert n_live.tolist() == [1, 1, 2, 3, 0, 1]
        assert m.shape[2] == 3           # NS = ceil(MP / SPLIT_PAGES)

    def test_dead_splits_contribute_nothing(self):
        """Whatever the spans at or past a row's n_live hold (here NaN and
        huge values) never reaches its output or lse."""
        _, (m, l, acc, n_live) = _partials([SPAN - 1, SPAN + 1, 0])
        clean = tpa.combine_plain(m, l, acc, n_live)
        m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
        for s, n in enumerate(n_live.tolist()):
            m2[s, :, n:] = float("nan")
            l2[s, :, n:] = 1e30
            acc2[s, :, n:] = float("inf")
        dirty = tpa.combine_plain(m2, l2, acc2, n_live)
        for a, b in zip(clean, dirty):
            assert torch.equal(a, b)

    def test_empty_row_gives_zeros_and_the_sentinel(self):
        _, (m, l, acc, n_live) = _partials([0, 0])
        o, lse = tpa.combine_plain(m, l, acc, n_live)
        assert torch.all(o == 0)
        assert torch.all(lse == tpa.LSE_EMPTY)

    def test_one_live_split_is_that_span_alone(self):
        """With one live span the merge weight is e^0 = 1 exactly: o is
        acc / l and lse m + log l of that span, bit for bit."""
        _, (m, l, acc, n_live) = _partials([SPAN, 1])
        o, lse = tpa.combine_plain(m, l, acc, n_live)
        assert torch.equal(o, acc[:, :, 0] / l[:, :, 0, :, None])
        assert torch.equal(lse, m[:, :, 0] + torch.log(l[:, :, 0]))

    @pytest.mark.parametrize("lens", [[2 * SPAN + 1, SPAN + 1],
                                      [3 * SPAN, 5]])
    def test_lse_matches_the_single_walk(self, lens):
        """The merged lse equals the page-sequential ``paged_attend``'s
        within 1e-5, and the merged output within the f32 tolerance."""
        (q, kp, vp, sl), parts = _partials(lens)
        o, lse = tpa.combine_plain(*parts)
        ref, ref_lse = tpa.paged_attend(q, kp, vp, sl, sl.long() - 1,
                                        need_lse=True)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o.permute(0, 2, 1, 3), ref, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_slot_row_is_the_same_bits_alone_and_in_a_batch(dtype):
    """The plan depends only on a slot's own length: each slot's decode
    row and lse through the split model are bitwise equal computed alone
    and inside a batch of 8 slots of other lengths."""
    lens = [2 * SPAN + 1, 0, SPAN, 5, SPAN - 1, 3 * SPAN, 1, SPAN + 1]
    _, q, kp, vp, bts = _inputs(4, lens, 3 * tpa.SPLIT_PAGES, P=64)
    q, kp, vp = (torch.from_numpy(x).to(dtype) for x in (q, kp, vp))
    bt = torch.from_numpy(bts)
    sl = torch.tensor(lens, dtype=torch.int32)
    out, lse = tpa.paged_decode_split_plain(q, kp, vp, bt, sl, need_lse=True)
    for s in range(len(lens)):
        one, one_lse = tpa.paged_decode_split_plain(
            q[s:s + 1], kp, vp, bt[s:s + 1], sl[s:s + 1], need_lse=True)
        assert torch.equal(one[0], out[s]), s
        assert torch.equal(one_lse[0], lse[s]), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_smokes_f64_gate_passes_a_reordered_sum_and_fails_a_wrong_one(
        dtype):
    """chip_smoke.py's seed-independent gate (no value more than one step
    further from an f64 answer than the plain version's) accepts the
    split plan's sums, which only run in another order, on every seed, and
    rejects a decode that drops each slot's last key and a prefill that
    reads another slot's pages."""
    import chip_smoke

    lens = BOUNDARY_LENS + [3 * SPAN]
    for seed in range(4):
        rng, q, kp, vp, bts = _inputs(20 + seed, lens, 3 * tpa.SPLIT_PAGES,
                                      P=64)
        q, kp, vp = (torch.from_numpy(x).to(dtype) for x in (q, kp, vp))
        bt = torch.from_numpy(bts)
        sl = torch.tensor(lens, dtype=torch.int32)
        plain = tpa.paged_decode_plain(q, kp, vp, bt, sl)
        exact = chip_smoke.exact_decode(q, kp, vp, bt, sl)
        split = tpa.paged_decode_split_plain(q, kp, vp, bt, sl)
        assert chip_smoke.excess_over_plain(split, plain, exact) <= 1
        short = tpa.paged_decode_plain(q, kp, vp, bt,
                                       (sl - 1).clamp(min=0).int())
        assert chip_smoke.excess_over_plain(short, plain, exact) > 1
        qc = torch.from_numpy(rng.standard_normal((PAGE, H, D)).astype(
            np.float32)).to(dtype)
        t0, n = 2 * SPAN, PAGE - 1
        plain = tpa.paged_prefill_plain(qc, kp, vp, bt[-1], t0, n)[:n]
        exact = chip_smoke.exact_prefill(qc, kp, vp, bt[-1], t0, n)[:n]
        split = tpa.paged_prefill_split_plain(qc, kp, vp, bt[-1], t0, n)[:n]
        assert chip_smoke.excess_over_plain(split, plain, exact) <= 1
        other = tpa.paged_prefill_plain(qc, kp, vp, bt[3], t0, n)[:n]
        assert chip_smoke.excess_over_plain(other, plain, exact) > 1
