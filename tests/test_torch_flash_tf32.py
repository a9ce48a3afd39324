"""A plain model of the arithmetic of the flash kernels K1 (o, lse), K2
(dq) and K3 (dk, dv) in deeplearning4j_tpu_torch/csrc/flash_attention.cu,
on the CPU where no kernel runs, and what it shows about chip_smoke.py's
f64 gate (phase 6).

The kernels take every product on the tensor cores in 3xTF32: each fp32
operand x is split into big = tf32(x) and small = tf32(x - big), with
tf32 the round to nearest (ties away from zero) to TF32's 10 mantissa
bits that ``cvt.rna.tf32.f32`` does, and that the kernels compute by
integer masking, as this model does; a.b is then small(a).big(b) +
big(a).small(b) + big(a).big(b). A product of two TF32 values is exact,
so the model sums exact products: each k-step of 8 into a fresh fp32
partial, added to a running fp32 sum, as the kernels do (the tensor
cores truncate inside the partial where the model rounds; the smoke
measures the kernels themselves).

The gate holds each value to at most one step (1e-6 + 1e-5 |value| in
f32) further from an f64 answer than the plain version's. At B 1, H 2,
T 128, D 64 the model's 3xTF32 dq, dk and dv pass it on every seed and a
single TF32 pass (about 3 decimal digits) fails it on every tensor; so
do K1's o and lse (S = (q*scale).K^T, then the online softmax over tiles
of 32 keys with acc rescaled and each k-step of P.V added to it in turn),
and a single pass fails it on o: the gate separates the kernels'
arithmetic from the forbidden one without a card. In bf16 the inputs are TF32 values already, so only the fp32
intermediates are rounded; the bf16 gate is not asked to tell the two
apart.

This file imports neither jax nor the reference package.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

B, H, T, D = 1, 2, 128, 64


def tf32(x):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, passes, acc=None):
    """acc + a @ b (acc 0 by default) with TF32 products, one pass
    (big.big) or the kernels' three (small.big, big.small, big.big), as
    the kernels sum them: each k-step of 8 into a fresh fp32 partial (the
    products are exact; here the partial rounds once), added to the
    running fp32 sum in k order."""
    ab, bb = tf32(a), tf32(b)
    terms = [(ab, bb)] if passes == 1 else \
        [(tf32(a - ab), bb), (ab, tf32(b - bb)), (ab, bb)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for c in range(0, a.shape[-1], 8):
        out = out + sum(x[..., c:c + 8].double() @ y[..., c:c + 8, :].double()
                        for x, y in terms).float()
    return out


def model_bwd(q, k, v, do, lse, delta, causal, passes):
    """K2's dq and K3's dk, dv with every product in `passes` TF32
    passes, the rest in fp32 as in the kernels: s = q.k^T unscaled, p =
    exp(s * scale - lse), dS = p (dP - delta), dq and dk scaled once at
    the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = tf32_matmul(qf, kf.transpose(-1, -2), passes)
    pos = torch.arange(q.shape[2])
    valid = (pos[:, None] >= pos[None, :]) if causal else \
        torch.ones(q.shape[2], k.shape[2], dtype=torch.bool)
    p = torch.where(valid, torch.exp(torch.addcmul(
        -lse.view(*s.shape[:3], 1), s, torch.tensor(scale))), 0.0)
    dp = tf32_matmul(gf, vf.transpose(-1, -2), passes)
    ds = p * (dp - delta.view(*s.shape[:3], 1))
    return {"dq": (tf32_matmul(ds, kf, passes) * scale).to(q.dtype),
            "dk": (tf32_matmul(ds.transpose(-1, -2), qf, passes)
                   * scale).to(k.dtype),
            "dv": tf32_matmul(p.transpose(-1, -2), gf, passes).to(v.dtype)}


def model_fwd(q, k, v, causal, passes, block=32):
    """K1's o and lse with every product in `passes` TF32 passes, the
    rest in fp32 as in the kernel: S = (q*scale).K^T; per tile of `block`
    keys the mask, m_new = max(m, rowmax S), corr = exp(m - m_new), p =
    exp(S - m_new) (0 where masked), l = l*corr + rowsum p and acc =
    acc*corr + P.V, each k-step of P.V added to acc in turn; o = acc / l
    (exact zeros where l == 0), lse = m + log l (the 1e30 sentinel)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    Tq, Tk = q.shape[2], k.shape[2]
    s_all = tf32_matmul(qf, kf.transpose(-1, -2), passes)
    m = torch.full(q.shape[:3], tfa.NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],))
    q_pos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, block):
        s = s_all[..., k0:k0 + block]
        k_pos = k0 + torch.arange(s.shape[-1])[None, :]
        valid = (q_pos >= k_pos) if causal else \
            torch.ones(Tq, s.shape[-1], dtype=torch.bool)
        s = torch.where(valid, s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = tf32_matmul(p, vf[..., k0:k0 + block, :], passes,
                          acc * corr[..., None])
        m = m_new
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    lse = torch.where(l > 0, m + torch.log(l), tfa.LSE_EMPTY)
    return {"o": o.to(q.dtype), "lse": lse.reshape(-1, Tq)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = chip_smoke.flash_inputs(rng, "cpu", torch.float32, B, H,
                                          T, T, D)
    return q, k, v, do


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor(1.0)
    ulp = 2.0 ** -10                      # TF32's spacing at 1
    x = torch.tensor([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4,
                      -(1 + ulp / 2), 3.0, 0.0, 1e-30])
    want = torch.tensor([1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0, 0.0,
                         float(tf32(torch.tensor(1e-30)))])
    assert torch.equal(tf32(x), want)
    assert torch.equal(tf32(one), one)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    assert torch.all(tf32(r).view(torch.int32) & 0x1FFF == 0)
    assert float(((tf32(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11


def test_the_split_keeps_fp32_accuracy():
    """big + small is x to ~2^-22; a 3xTF32 product is as close to the
    f64 product as an fp32 one is to a few ulps, a single pass ~2^-11."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    big = tf32(a)
    rel = ((big + tf32(a - big)) - a).abs() / a.abs()
    assert float(rel.max()) <= 2.0 ** -21
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err3 = float((tf32_matmul(a, b, 3).double() - exact).abs().max())
    err1 = float((tf32_matmul(a, b, 1).double() - exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    assert err3 <= 8 * err32 + 1e-6 * scale
    assert err1 >= 100 * err3


@pytest.mark.parametrize("causal", [False, True])
def test_the_smokes_f64_gate_passes_3xtf32_and_fails_one_tf32_pass(causal):
    for seed in range(3):
        q, k, v, do = _inputs(seed)
        o, lse = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
        delta = tfa._delta(do, o)
        three = chip_smoke.flash_excess(
            tfa, q, k, v, do, lse, delta, causal,
            model_bwd(q, k, v, do, lse, delta, causal, 3))
        one = chip_smoke.flash_excess(
            tfa, q, k, v, do, lse, delta, causal,
            model_bwd(q, k, v, do, lse, delta, causal, 1))
        assert set(three) == set(one) == {"dq", "dk", "dv"}
        assert max(three.values()) <= 1, (seed, three)
        assert min(one.values()) > 1, (seed, one)


@pytest.mark.parametrize("causal", [False, True])
def test_the_smokes_f64_gate_passes_k1s_3xtf32_and_fails_one_tf32_pass(
        causal):
    """K1's model: o and lse within one step of the f64 answer beyond the
    plain version, and the lse within rtol/atol 1e-5 of the plain one
    (phase 6's check), on every seed; a single TF32 pass fails on o."""
    for seed in range(3):
        q, k, v, do = _inputs(seed)
        o, lse = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
        delta = tfa._delta(do, o)
        three = model_fwd(q, k, v, causal, 3)
        torch.testing.assert_close(three["lse"], lse, rtol=1e-5, atol=1e-5)
        excess = chip_smoke.flash_excess(tfa, q, k, v, do, lse, delta,
                                         causal, three)
        assert set(excess) == {"o", "lse"}
        assert max(excess.values()) <= 1, (seed, excess)
        one = chip_smoke.flash_excess(tfa, q, k, v, do, lse, delta, causal,
                                      {"o": model_fwd(q, k, v, causal,
                                                      1)["o"]})
        assert one["o"] > 1, (seed, one)


def test_k1s_model_keeps_the_empty_row_contract():
    """Rows with no valid key (Tk 0 here) give exact zeros and the 1e30
    lse sentinel, as the plain version does."""
    q = torch.ones(1, 1, 4, 8)
    kv = torch.ones(1, 1, 0, 8)
    got = model_fwd(q, kv, kv, False, 3)
    assert torch.equal(got["o"], torch.zeros(1, 1, 4, 8))
    assert torch.equal(got["lse"], torch.full((1, 4), tfa.LSE_EMPTY))
    o, lse = tfa.flash_fwd_plain(q, kv, kv, False, need_lse=True)
    assert torch.equal(got["o"], o) and torch.equal(got["lse"], lse)


def test_the_gate_passes_the_plain_version_itself():
    """The plain version is 0 steps from itself: the gate's zero."""
    q, k, v, do = _inputs(7)
    o, lse = tfa.flash_fwd_plain(q, k, v, False, need_lse=True)
    delta = tfa._delta(do, o)
    got = chip_smoke.flash_plain(tfa, q, k, v, do, lse, delta, False)
    excess = chip_smoke.flash_excess(tfa, q, k, v, do, lse, delta, False,
                                     got)
    assert set(excess) == {"o", "lse", "dq", "dk", "dv"}
    assert all(x == 0 for x in excess.values()), excess
