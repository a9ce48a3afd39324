"""The port's CUDA kernels on the card (``cuda`` marker): K4 decode and K5
prefill (deeplearning4j_tpu_torch/csrc/paged_attention.cu) against their
plain PyTorch version on the same CUDA tensors, at the split plan's span
boundaries too; a K4 row bitwise the same alone and in a batch of 8; two
launches bitwise equal; over 8 input seeds, both no further from an f64
answer than the plain version plus one step; a tiny model's paged
serving bitwise against its dense serial trajectory through the kernels;
K1 (flash forward), K2 (dq) and K3 (dk, dv) of
deeplearning4j_tpu_torch/csrc/flash_attention.cu against their plain
versions, over 4 input seeds against an f64 answer at every padded head
width (chip_smoke.py's flash gate: the forward's o and lse, the
backward's dq, dk and dv), the forward's and the backward's bitwise
repeatability, strided operands, and autograd through FlashAttentionFn
launching all three. Then the attention dispatch outside the kernels'
domain (a SelfAttentionLayer at fp64, at fp16 and at head widths 100 and
256 answers through the fused or blockwise form on the card, held to
blockwise_attention in f64; f32 and bf16 at D 64 still launch K1-K3),
the CNN path's ops on the card: max pooling's first-match gradient on
tied maxima in channels_last f32 and bf16, and the BN autograd
Functions against the same functions on the CPU; then the ND4J array
layer and SameDiff: an out-of-range INDArray read or write raises
IndexError with the context still usable, seeded draws repeat on the
card, a SameDiff attention graph launches K1-K3 and not their plain
versions, and a SameDiff fit step through them equals the same step
with attention routed to the plain versions (loss rel 1e-5, each
updated variable within 1e-4 of its max-abs).

This file imports neither jax nor the reference package, so it runs on a
machine with PyTorch alone:

    python3 -m pytest --noconftest -q tests/test_torch_kernels_card.py

Without a card every test skips (the kernels have no CPU mode).

Tolerances: f32 rtol 1e-5, atol 1e-6 (both accumulate in f32; only the
order inside dot products and page sums differs); bf16 at most 1 bf16
ulp (one rounding of nearly equal f32 values); lse rtol/atol 1e-5.
Flash kernels: f32 within 1e-4 of each tensor's max-abs (the kernels take
32-row tiles where the plain version takes whole 512-row blocks, so every
sum runs in another order, and their products in 3xTF32); bf16 within 2 ulp on o (both round one f32 value
that differs only by that order; the ulp of values below 1/256 of o's
max-abs is taken at that floor, where a cancelling weighted mean turns
an f32 difference of ~1e-7 into many ulps) and a relative L2 of 1e-2 on the
gradients (the bf16-rounded o enters delta); lse rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import norm as tnorm
from deeplearning4j_tpu_torch.ops import paged_attention as tpa
from deeplearning4j_tpu_torch.ops import pooling as tpool

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulps(a, b):
    def ordered(x):
        bits = x.contiguous().view(torch.int16).long() & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def _assert_close(got, want):
    if got.dtype == torch.bfloat16:
        assert int(_ulps(got, want).max()) <= 1
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _tables(rng, lens, page, P, MP):
    order = rng.permutation(np.arange(1, P))
    bts = np.zeros((len(lens), MP), np.int32)
    k = 0
    for s, n in enumerate(lens):
        for j in range(-(-n // page)):
            bts[s, j] = order[k]
            k += 1
    return bts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 64])
def test_kernels_match_plain(card, D, dtype):
    rng = np.random.default_rng(5)
    page, H, P, MP = 16, 3, 40, 16
    lens = [0, 1, 16, 17, 200]

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(card, dtype)

    kp, vp = randn(P, page, H, D), randn(P, page, H, D)
    bt = torch.from_numpy(_tables(rng, lens, page, P, MP)).to(card)
    sl = torch.tensor(lens, dtype=torch.int32, device=card)
    q = randn(len(lens), H, D)
    tpa.reset_launches()
    out, lse = tpa.paged_flash_decode(q, kp, vp, bt, sl, need_lse=True)
    ref, ref_lse = tpa.paged_decode_plain(q, kp, vp, bt, sl, need_lse=True)
    torch.cuda.synchronize()
    assert tpa.paged_flash_decode.launches == 1
    _assert_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == tpa.LSE_EMPTY)
    qc = randn(page, H, D)
    for t0, n_valid in ((0, 16), (16, 5), (192, 8)):
        got = tpa.paged_flash_prefill(qc, kp, vp, bt[4], t0, n_valid)
        want = tpa.paged_prefill_plain(qc, kp, vp, bt[4], t0, n_valid)
        torch.cuda.synchronize()
        _assert_close(got[:n_valid], want[:n_valid])
    assert tpa.paged_flash_prefill.launches == 3


def _paged_inputs(rng, dev, dtype, lens, page, H, D, P, MP):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    kp, vp = randn(P, page, H, D), randn(P, page, H, D)
    bt = torch.from_numpy(_tables(rng, lens, page, P, MP)).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return randn(len(lens), H, D), kp, vp, bt, sl, randn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 64, 128])
def test_split_kernels_match_plain_at_span_boundaries(card, D, dtype):
    """K4 at lengths one below, at and one above a span (SPLIT_PAGES
    pages) and one past two spans, beside 0 and 1; K5 at chunks whose
    t0 ends a span, starts one, and ends past two."""
    rng = np.random.default_rng(6)
    page, H, P, MP = 16, 3, 48, 16
    span = tpa.SPLIT_PAGES * page
    lens = [span - 1, span, span + 1, 2 * span + 1, 0, 1]
    q, kp, vp, bt, sl, randn = _paged_inputs(rng, card, dtype, lens, page,
                                             H, D, P, MP)
    out, lse = tpa.paged_flash_decode(q, kp, vp, bt, sl, need_lse=True)
    ref, ref_lse = tpa.paged_decode_plain(q, kp, vp, bt, sl, need_lse=True)
    torch.cuda.synchronize()
    _assert_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[4] == 0) and torch.all(lse[4] == tpa.LSE_EMPTY)
    for t0, n_valid in ((span - page, page), (span, 1), (span, page),
                        (2 * span, 1), (3 * span - page, 9)):
        qc = randn(page, H, D)
        got = tpa.paged_flash_prefill(qc, kp, vp, bt[3], t0, n_valid)
        want = tpa.paged_prefill_plain(qc, kp, vp, bt[3], t0, n_valid)
        torch.cuda.synchronize()
        _assert_close(got[:n_valid], want[:n_valid])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_row_is_the_same_bits_alone_and_in_a_batch(card, dtype):
    """The split plan depends on a slot's own length only: each slot's
    output row and lse are bitwise equal decoded alone and among 8."""
    rng = np.random.default_rng(7)
    page, H, D, P, MP = 16, 4, 64, 160, 64
    lens = [1024, 0, 17, 300, 64, 65, 511, 1]
    q, kp, vp, bt, sl, _ = _paged_inputs(rng, card, dtype, lens, page, H,
                                         D, P, MP)
    out, lse = tpa.paged_flash_decode(q, kp, vp, bt, sl, need_lse=True)
    for s in range(len(lens)):
        one, one_lse = tpa.paged_flash_decode(q[s:s + 1], kp, vp,
                                              bt[s:s + 1], sl[s:s + 1],
                                              need_lse=True)
        assert torch.equal(one[0], out[s]), s
        assert torch.equal(one_lse[0], lse[s]), s


def test_paged_kernels_are_bitwise_repeatable(card):
    """No atomics and one sum order: two launches give the same bits."""
    rng = np.random.default_rng(8)
    page, H, D, P, MP = 16, 12, 64, 160, 64
    lens = [1024, 300, 5, 64]
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, sl, randn = _paged_inputs(rng, card, dtype, lens,
                                                 page, H, D, P, MP)
        a = tpa.paged_flash_decode(q, kp, vp, bt, sl, need_lse=True)
        b = tpa.paged_flash_decode(q, kp, vp, bt, sl, need_lse=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        qc = randn(page, H, D)
        a = tpa.paged_flash_prefill(qc, kp, vp, bt[0], 1008, 16)
        b = tpa.paged_flash_prefill(qc, kp, vp, bt[0], 1008, 16)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 64, 128])
def test_split_kernels_no_further_from_f64_than_plain(card, D, dtype):
    """Over 8 input seeds, K4 and K5 land at most one step (a bf16 ulp
    with a floor at 1/256 of the max-abs, or 1e-6 + 1e-5 |value| in f32)
    further from an f64 answer than the plain version: a sum taken in
    another order passes on every input, a wrong kernel fails. The
    1-ulp checks against the plain version above hold input by input.
    The f64 answer and the step are chip_smoke.py's (phase 3)."""
    import chip_smoke

    page, H, P, MP = 16, 3, 48, 16
    span = tpa.SPLIT_PAGES * page
    lens = [span - 1, span, span + 1, 2 * span + 1, 0, 1, MP * page]
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        q, kp, vp, bt, sl, randn = _paged_inputs(rng, card, dtype, lens,
                                                 page, H, D, P, MP)
        got = tpa.paged_flash_decode(q, kp, vp, bt, sl)
        plain = tpa.paged_decode_plain(q, kp, vp, bt, sl)
        exact = chip_smoke.exact_decode(q, kp, vp, bt, sl)
        assert chip_smoke.excess_over_plain(got, plain, exact) <= 1, seed
        for t0, n_valid in ((span, 9), (MP * page - page, page)):
            qc = randn(page, H, D)
            got = tpa.paged_flash_prefill(qc, kp, vp, bt[-1], t0, n_valid)
            plain = tpa.paged_prefill_plain(qc, kp, vp, bt[-1], t0, n_valid)
            exact = chip_smoke.exact_prefill(qc, kp, vp, bt[-1], t0,
                                             n_valid)
            assert chip_smoke.excess_over_plain(
                got[:n_valid], plain[:n_valid], exact[:n_valid]) <= 1, \
                (seed, t0)


def test_paged_serving_bitwise_vs_dense_on_card(card):
    """The reference's internal contract, through the kernels: paged
    generation at a fixed bucket is bitwise the serial dense trajectory
    (identity block table, same kernels, no atomics)."""
    from deeplearning4j_tpu_torch.nn.transformer import (
        CausalTransformerLM, dense_serial_trajectory,
    )
    from deeplearning4j_tpu_torch.serving import (
        ManualClock, PagedSequenceScheduler, greedy_sampler, stream_rng,
    )

    m = CausalTransformerLM(vocab=97, d_model=64, n_heads=2, n_layers=2,
                            max_context=64, page_size=16,
                            dtype="bfloat16", seed=1, device=card)
    s = PagedSequenceScheduler(m, num_pages=24, slot_buckets=(4,),
                               clock=ManualClock(), start_thread=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, size=n).tolist() for n in (5, 23, 40)]
    tpa.reset_launches()
    reqs = [s.submit(p, max_new_tokens=7, wait=False) for p in prompts]
    s.drain()
    assert tpa.paged_flash_decode.launches > 0
    assert tpa.paged_flash_prefill.launches > 0
    assert tpa.paged_attend.launches == 0
    for i, p in enumerate(prompts):
        toks, logits = dense_serial_trajectory(
            m, p, 7, greedy_sampler(), stream_rng(0, i), bucket=4)
        assert reqs[i].wait(1.0).tolist() == toks
        assert np.array_equal(reqs[i].logits.view(np.uint8),
                              logits.view(np.uint8))
    s.close()


def _flash_inputs(rng, dev, dtype, B, H, Tq, Tk, D):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    return randn(B, H, Tq, D), randn(B, H, Tk, D), randn(B, H, Tk, D), \
        randn(B, H, Tq, D)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (x > 0)."""
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _flash_close(got, want, what):
    if got.dtype == torch.bfloat16 and what == "o":
        # 2 ulps of each value, with the ulp of values below 1/256 of the
        # tensor's max-abs taken at that floor: o is a weighted mean, and
        # where it cancels to near 0 an f32 difference of ~1e-7 is many
        # ulps of the tiny result
        w = want.float()
        floor = w.abs().max().clamp_min(1e-30) / 256
        tol = 2 * _bf16_ulp(torch.maximum(w.abs(), floor))
        assert bool(((got.float() - w).abs() <= tol).all()), what
    elif got.dtype == torch.bfloat16:
        rel = float((got.float() - want.float()).norm()
                    / want.float().norm().clamp_min(1e-30))
        assert rel <= 1e-2, (what, rel)
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-7, (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Tq,Tk,D", [
    (2, 3, 128, 128, 64),   # aligned tiles
    (1, 2, 70, 70, 32),     # T not a multiple of the 64-row tile
    (2, 2, 24, 56, 16),     # cross lengths
    (1, 2, 33, 17, 8),      # ragged both sides, the narrowest head
    (1, 1, 130, 100, 128),  # the widest head
    (1, 2, 40, 40, 24),     # a width padded up to the next tile width
])
def test_flash_kernels_match_plain(card, dtype, causal, B, H, Tq, Tk, D):
    rng = np.random.default_rng(11)
    q, k, v, do = _flash_inputs(rng, card, dtype, B, H, Tq, Tk, D)
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
    delta = tfa._delta(do, o_ref)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    dq_ref = tfa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = tfa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                             causal)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (1, 1, 1)
    _flash_close(o, o_ref, "o")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    for got, want, what in ((dq, dq_ref, "dq"), (dk, dk_ref, "dk"),
                            (dv, dv_ref, "dv")):
        _flash_close(got, want, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [8, 32, 64, 128])
def test_flash_backward_no_further_from_f64_than_plain(card, D, causal,
                                                       dtype):
    """chip_smoke.py's flash gate (phase 6) at every padded head width:
    over 4 input seeds, K2's dq and K3's dk and dv (3xTF32 products on
    the tensor cores) land at most one step (a bf16 ulp with a floor at
    1/256 of the max-abs, or 1e-6 + 1e-5 |value| in f32) further from an
    f64 answer than the plain version. A single TF32 pass fails it
    (tests/test_torch_flash_tf32.py). T 200 leaves a ragged last tile."""
    import chip_smoke

    worst = chip_smoke.flash_seed_sweep(tfa, card, dtype, causal, seeds=4,
                                        shape=(1, 3, 200, D))
    assert set(worst) == {"o", "lse", "dq", "dk", "dv"}
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [8, 32, 64, 128])
def test_flash_forward_no_further_from_f64_than_plain(card, D, causal,
                                                      dtype):
    """chip_smoke.py's flash gate on K1 alone at every padded head width
    and at cross lengths: over 4 input seeds, o (3xTF32 S and P.V on the
    tensor cores) and the lse land at most one step (o: as for the
    backward; the lse, fp32 in both dtypes: 1e-6 + 1e-5 |value|) further
    from an f64 answer than the plain version. Tq 200 and Tk 72 leave
    ragged last tiles; causal, rows past the keys see them all."""
    import chip_smoke

    worst = {}
    for seed in range(4):
        rng = np.random.default_rng(2000 + seed)
        q, k, v, do = chip_smoke.flash_inputs(rng, card, dtype, 1, 3, 200,
                                              72, D)
        o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
        o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
        delta = tfa._delta(do, o_ref)
        got = chip_smoke.flash_excess(tfa, q, k, v, do, lse_ref, delta,
                                      causal, {"o": o, "lse": lse})
        for w, x in got.items():
            worst[w] = max(worst.get(w, -np.inf), x)
    assert set(worst) == {"o", "lse"}
    assert max(worst.values()) <= 1, worst


def test_flash_forward_is_bitwise_repeatable(card):
    """o and lse belong to K1 alone: no atomics, one sum order."""
    rng = np.random.default_rng(15)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = _flash_inputs(rng, card, dtype, 2, 4, 200, 200, 64)
        for causal in (False, True):
            first = tfa.flash_fwd(q, k, v, causal, need_lse=True)
            second = tfa.flash_fwd(q, k, v, causal, need_lse=True)
            assert torch.equal(first[0], second[0])
            assert torch.equal(first[1], second[1])


def test_flash_backward_is_bitwise_repeatable(card):
    """dq belongs to K2 and dk/dv to K3: no atomics, one sum order."""
    rng = np.random.default_rng(12)
    q, k, v, do = _flash_inputs(rng, card, torch.float32, 2, 4, 200, 200, 64)
    o, lse = tfa.flash_fwd(q, k, v, True, need_lse=True)
    first = tfa.flash_bwd(q, k, v, o, lse, do, True)
    second = tfa.flash_bwd(q, k, v, o, lse, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_strided_operands_need_no_copy(card):
    """[B,T,H,D] -> [B,H,T,D] views (the layers' layout) give the same
    bits as contiguous copies: the kernels read through the strides."""
    rng = np.random.default_rng(13)
    B, T, H, D = 2, 96, 4, 32
    x = [torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(
        np.float32)).to(card) for _ in range(4)]
    q, k, v, do = (t.transpose(1, 2) for t in x)
    assert not q.is_contiguous()
    o, lse = tfa.flash_fwd(q, k, v, need_lse=True)
    o2, lse2 = tfa.flash_fwd(*(t.contiguous() for t in (q, k, v)),
                             need_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g = tfa.flash_bwd(q, k, v, o, lse, do)
    g2 = tfa.flash_bwd(*(t.contiguous() for t in (q, k, v)), o, lse,
                       do.contiguous())
    for a, b in zip(g, g2):
        assert torch.equal(a, b)


def test_flash_autograd_runs_the_kernels(card):
    rng = np.random.default_rng(14)
    q, k, v, _ = _flash_inputs(rng, card, torch.float32, 2, 2, 80, 80, 16)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    tfa.reset_launches()
    out = tfa.flash_attention(q, k, v, causal=True)
    (out.square().sum()).backward()
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (1, 1, 1)
    assert (tfa.flash_fwd_plain.launches + tfa.flash_bwd_dq_plain.launches
            + tfa.flash_bwd_dkv_plain.launches) == 0
    qr, kr, vr = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    tfa.flash_attention(qr, kr, vr, causal=True).square().sum().backward()
    for a, b in ((q, qr), (k, kr), (v, vr)):
        _flash_close(a.grad.cpu(), b.grad, "grad")


def test_flash_rejects_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 1, 8, 12, device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_fwd(q, q, q)
    q = torch.zeros(1, 1, 8, 136, device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_fwd(q, q, q)
    q = torch.zeros(1, 1, 8, 16, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_fwd(q, q, q)


# ----------------------------------------------------------------------
# attention outside the kernels' domain
# ----------------------------------------------------------------------

def _attention_layer(rng, dev, dtype, F_, H, T, B=2):
    layer = SelfAttentionLayer(nIn=F_, nOut=F_, nHeads=H)
    layer.mergeGlobals({})
    params, _ = layer.initialize(torch.Generator().manual_seed(3),
                                 InputType.recurrent(F_, T), torch.float64,
                                 "cpu")
    x = torch.from_numpy(rng.standard_normal((B, F_, T)))
    return layer, params, x


def _layer_through_blockwise(layer, params, x, monkeypatch):
    """The layer's f64 forward on the CPU with its attention core taken
    by ``blockwise_attention``."""
    with monkeypatch.context() as m:
        m.setattr(tfa, "flash_attention",
                  lambda q, k, v, **kw: tatt.blockwise_attention(q, k, v))
        return layer.forward(params, {}, x, False, None)[0]


@pytest.mark.parametrize("dtype,F_,H,T,route,band", [
    (torch.float64, 64, 4, 40, "fused", 1e-12),
    (torch.float16, 64, 4, 40, "fused", 1e-2),
    (torch.float16, 64, 4, 600, "blockwise", 1e-2),
    (torch.float32, 200, 2, 40, "fused", 1e-5),
    (torch.float32, 256, 1, 40, "fused", 1e-5),
], ids=["fp64", "fp16", "fp16_T600", "D100", "D256"])
def test_attention_outside_the_kernels_domain_answers(card, monkeypatch,
                                                      dtype, F_, H, T, route,
                                                      band):
    """A SelfAttentionLayer whose dtype or head width the kernels do not
    take answers on the card through the fused (T < 512) or blockwise
    form, never the kernels, within its dtype's band of the f64 answer
    (fp16: rel L2 1e-2, an 11-bit mantissa through three projections,
    the softmax and P.V; f32 with TF32 off: 1e-5; fp64: 1e-12)."""
    rng = np.random.default_rng(21)
    layer, params, x = _attention_layer(rng, card, dtype, F_, H, T)
    want = _layer_through_blockwise(layer, params, x, monkeypatch)
    tfa.reset_launches()
    got = layer.forward({k: v.to(card, dtype) for k, v in params.items()},
                        {}, x.to(card, dtype), False, None)[0]
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == dtype
    assert tfa.flash_fwd.launches == 0
    counts = {"fused": tatt.dot_product_attention.launches,
              "blockwise": tatt.blockwise_attention.launches}
    assert counts[route] == 1 and sum(counts.values()) == 1, counts
    rel = float((got.double().cpu() - want).norm() / want.norm())
    assert rel <= band, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_inside_the_domain_launches_the_kernels(card, dtype):
    rng = np.random.default_rng(22)
    layer, params, x = _attention_layer(rng, card, dtype, 128, 2, 96)
    p = {k: v.to(card, dtype).requires_grad_(True) for k, v in params.items()}
    tfa.reset_launches()
    y = layer.forward(p, {}, x.to(card, dtype), True, None)[0]
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (1, 1, 1)
    assert tatt.dot_product_attention.launches == 0
    assert tatt.blockwise_attention.launches == 0


# ----------------------------------------------------------------------
# the CNN path's ops on the card
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s,pad", [(3, 2, ((1, 1), (1, 1))),
                                     (2, 2, ((0, 0), (0, 0))),
                                     (3, 2, "SAME")])
def test_max_pool_first_match_on_the_card(card, dtype, k, s, pad):
    """channels_last max pooling over ReLU outputs on a 1/8 grid (most
    windows hold tied maxima): the card's output and gradient equal the
    CPU's exactly, which tests/test_torch_cnn_ops.py holds to the
    reference's first-match rule. The cotangent is small integers, so an
    input that wins overlapping windows sums them exactly in bf16 too,
    in any order: only the routing can differ."""
    rng = np.random.default_rng(23)
    x = np.maximum(np.round(rng.standard_normal((4, 16, 33, 31)) * 8) / 8, 0)
    xc = torch.from_numpy(x.astype(np.float32)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    outs = []
    for dev in ("cpu", card):
        xd = xc.to(dev).requires_grad_(True)
        y = tpool.max_pool2d(xd, k, s, pad)
        dy = torch.from_numpy(rng.integers(1, 9, y.shape).astype(
            np.float32)).to(dev, dtype) if dev == "cpu" else outs[0][2].to(
                dev)
        (g,) = torch.autograd.grad(y, [xd], dy)
        outs.append((y.detach().cpu(), g.cpu(), dy.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("act,residual", [("relu", False), ("identity", True),
                                          ("tanh", False), (None, False)])
def test_bn_functions_on_the_card_match_the_cpu(card, dtype, act, residual):
    """BNTrainFn / BNActTrainFn / BNActAddTrainFn on channels_last CUDA
    tensors against the same functions on the CPU: outputs, statistics
    and the gradients of x, gamma, beta (and the residual). Bands: f64
    1e-12; f32 1e-5 of each tensor's max-abs (reductions in another
    order); bf16 outputs within 2 ulps, gradients rel L2 2e-2."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal((8, 32, 14, 14)) * 2 + 0.5
    g = 1 + 0.3 * rng.standard_normal(32)
    b = 0.2 * rng.standard_normal(32)
    dy = rng.standard_normal(x.shape)
    r = rng.standard_normal(x.shape)
    res = {}
    for dev in ("cpu", card):
        def t(a, cl=False):
            v = torch.from_numpy(a).to(dev, dtype)
            if cl:
                v = v.contiguous(memory_format=torch.channels_last)
            return v.requires_grad_(True)
        ins = [t(x, True), t(g), t(b)] + ([t(r, True)] if residual else [])
        if act is None:
            out, m, v = tnorm.BNTrainFn.apply(ins[0], ins[1], ins[2], 1e-5)
        elif residual:
            out, m, v = tnorm.BNActAddTrainFn.apply(ins[0], ins[1], ins[2],
                                                    ins[3], 1e-5, act)
        else:
            out, m, v = tnorm.BNActTrainFn.apply(ins[0], ins[1], ins[2],
                                                 1e-5, act)
        grads = torch.autograd.grad(out, ins, t(dy).detach())
        res[dev if dev == "cpu" else "cuda"] = [
            a.detach().cpu().double() for a in (out, m, v) + tuple(grads)]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(res["cuda"], res["cpu"])):
        scale = float(want.abs().max().clamp_min(1e-30))
        if dtype == torch.float64:
            assert float((got - want).abs().max()) <= 1e-12 * scale, i
        elif dtype == torch.float32 or i in (1, 2):
            assert float((got - want).abs().max()) <= 1e-5 * scale, i
        elif i == 0:
            floor = scale / 256
            ulp = _bf16_ulp(torch.maximum(want.abs(), torch.tensor(floor)))
            assert bool(((got - want).abs() <= 2 * ulp).all()), i
        else:
            assert float((got - want).norm() / want.norm()) <= 2e-2, i


# ----------------------------------------------------------------------
# the ND4J array layer and SameDiff on the card
# ----------------------------------------------------------------------

def test_indarray_out_of_range_raises_and_the_context_survives(card):
    """Bounds are checked on the host: IndexError, never a device-side
    assert (which would poison the context for the rest of the
    process)."""
    from deeplearning4j_tpu_torch.ndarray import NDArrayIndex as I
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = Nd4j.create(base)
    assert a.tensor().is_cuda
    for call in (lambda: a.getDouble(3, 0), lambda: a.getDouble(12),
                 lambda: a.get(I.indices(0, 3)), lambda: a.get(I.point(3)),
                 lambda: a.putScalar(0, 4, 1.0), lambda: a[[0, 5]],
                 lambda: a.getRows(1, 3), lambda: a.__setitem__(9, 0.0)):
        with pytest.raises(IndexError):
            call()
    torch.cuda.synchronize()
    assert float((a.tensor() * 2).sum()) == 132.0
    np.testing.assert_array_equal(a.toNumpy(), base)


def test_seeded_rng_repeats_on_the_card(card):
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    for draw in (Nd4j.rand, Nd4j.randn):
        x = draw(1 << 20, seed=5)
        assert x.tensor().is_cuda
        assert torch.equal(x.tensor(), draw(1 << 20, seed=5).tensor())
        Nd4j.getRandom().setSeed(17)
        g1 = draw(4096)
        Nd4j.getRandom().setSeed(17)
        assert torch.equal(g1.tensor(), draw(4096).tensor())
        # the CUDA and CPU Philox streams differ: reproducible per device
        assert not torch.equal(draw(4096, seed=5).tensor().cpu(),
                               draw(4096, seed=5, device="cpu").tensor())


class _PlainFlash(torch.autograd.Function):
    """flash_attention through the kernels' plain versions, for the
    comparison below."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = tfa.flash_fwd_plain(q, k, v, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return tfa.flash_bwd_plain(q, k, v, o, lse, do)


def _sd_attention_graph(B=2, T=64, E=64, heads=4, blocks=2, seed=3):
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.nn import Sgd

    sd = SameDiff.create()
    h = sd.placeHolder("x", "float32", B, T, E)
    y = sd.placeHolder("y", "float32", B, 3)
    n = [seed * 100]

    def w(name, *shape):
        n[0] += 1
        return sd.var(name, Nd4j.randn(*shape, seed=n[0]).mul(0.2))

    for i in range(blocks):
        a = sd.nn.multiHeadDotProductAttention(
            sd.nn.layerNorm(h, sd.var(f"g{i}", Nd4j.ones(E))),
            w(f"wq{i}", E, E), w(f"wk{i}", E, E), w(f"wv{i}", E, E),
            w(f"wo{i}", E, E), heads)
        h = h + a
        h = h + sd.nn.linear(sd.nn.gelu(sd.nn.linear(h, w(f"w1{i}", E, E))),
                             w(f"w2{i}", E, E))
    sd.loss.softmaxCrossEntropy(y, sd.nn.linear(h.mean(1), w("wo", E, 3)),
                                name="loss")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(Sgd(0.1))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, E).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rs.randint(0, 3, B)]
    return sd, x, lab


def test_samediff_attention_graph_launches_the_kernels(card):
    sd, x, y = _sd_attention_graph()
    assert sd.device.type == "cuda"
    tfa.reset_launches()
    losses = sd.fit(features=x, labels=y, epochs=2)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (4, 4, 4)
    assert tfa.flash_fwd_plain.launches == tfa.flash_bwd_dq_plain.launches \
        == tfa.flash_bwd_dkv_plain.launches == 0
    assert all(np.isfinite(losses))


def test_samediff_fit_step_equals_the_plain_attention_step(card,
                                                          monkeypatch):
    """One SGD step through K1-K3 against the same step with attention
    routed to the plain versions: loss rel 1e-5, every updated variable
    within 1e-4 of its max-abs (the flash kernels' f32 tolerance)."""
    sd, x, y = _sd_attention_graph()
    ref, _, _ = _sd_attention_graph()
    tfa.reset_launches()
    (got,) = sd.fit(features=x, labels=y)
    assert tfa.flash_fwd.launches == 2
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v, causal=False, **_:
                        _PlainFlash.apply(q, k, v))
    (want,) = ref.fit(features=x, labels=y)
    assert tfa.flash_fwd.launches == 2 and tfa.flash_fwd_plain.launches == 2
    assert abs(got - want) <= 1e-5 * abs(want)
    for v in sd.variables():
        a = sd.getVariable(v.name).getArr().tensor()
        b = ref.getVariable(v.name).getArr().tensor()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            v.name
