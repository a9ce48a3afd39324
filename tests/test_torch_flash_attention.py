"""Port parity for the flash attention ops (deeplearning4j_tpu_torch/ops/
flash_attention.py, ops/attention.py) against the JAX reference
(ops/pallas_attention.py, ops/attention.py).

On the CPU the port's K1-K3 wrappers run their plain versions; the
reference kernels run in Pallas interpret mode (``_INTERPRET`` patched
to True, as tests/test_attention.py does). The grids are the
reference's own (tests/test_attention.py): aligned, padded, cross-length
and ragged, each causal and not.

Tolerances (port vs reference, same inputs, explicit float32):
- f32: rtol 1e-5, atol 1e-5 — the same block order and f32 sums on both
  sides; only the order inside each dot product differs (observed
  <= 1.2e-6 on O(1) values).
- bf16: o within 1 bf16 ulp, gradients within 2 — both sides compute in
  f32 and round once; the ulp of values below 1/256 of the tensor's
  max-abs is taken at that floor (a weighted mean that cancels to near 0
  turns a 1e-7 difference into many ulps of the tiny value).
- lse: rtol 1e-5, atol 1e-5.
- the fused/blockwise mask forms: rtol 2e-5, atol 2e-5, the reference
  test's own.

The CUDA kernels run only on the card: tests/test_torch_kernels_card.py
holds them to these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import attention as ja
from deeplearning4j_tpu.ops import pallas_attention as pa
from deeplearning4j_tpu_torch.ops import attention as ta
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)

GRID = [(64, 64, 16, 16), (70, 70, 32, 32), (24, 56, 16, 16), (33, 17, 16, 8)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    return pa


@pytest.fixture(autouse=True)
def _fresh_counts():
    tfa.reset_launches()
    old = tfa.set_flash_bwd("kernel")
    yield
    tfa.set_flash_bwd(old)


def _qkv(Tq, Tk, D=8, B=2, H=2, seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda T: rng.standard_normal((B, H, T, D)).astype(np.float32)
    return mk(Tq), mk(Tk), mk(Tk), mk(Tq)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _bf16_ulp_close(got, want, ulps):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    floor = max(float(np.abs(want).max()), 1e-30) / 256
    mag = np.maximum(np.abs(want), floor)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk,bq,bk", GRID)
def test_plain_versions_match_pallas_kernels(interpret, Tq, Tk, bq, bk,
                                             causal):
    """flash_fwd_plain / flash_bwd_plain vs K1 / K2+K3 in interpret mode:
    o, lse and dq, dk, dv on the same blocks."""
    q, k, v, do = _qkv(Tq, Tk)
    jo, jlse = pa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, bq, bk,
                                  need_lse=True)
    jg = pa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jo, jlse, jnp.asarray(do), causal, bq, bk)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tfa.flash_fwd(tq, tk, tv, causal, bq, bk, need_lse=True)
    grads = tfa.flash_bwd(tq, tk, tv, o, lse, tdo, causal, bq, bk)
    # on the CPU the wrappers ARE the plain versions, bit for bit
    plain = tfa.flash_bwd_plain(tq, tk, tv, o, lse, tdo, causal, bq, bk)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :Tq], **F32)
    for got, want, nm in zip(grads, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=nm)
    # the CPU wrappers ran the plain versions, never a kernel
    assert (tfa.flash_fwd_plain.launches, tfa.flash_bwd_dq_plain.launches,
            tfa.flash_bwd_dkv_plain.launches) == (1, 2, 2)
    assert tfa.flash_fwd.launches + tfa.flash_bwd_dq.launches \
        + tfa.flash_bwd_dkv.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_through_flash(interpret, causal):
    """torch.autograd through the port's flash_attention (FlashAttentionFn
    on CPU) vs jax.grad through the reference's (the custom VJP with the
    Pallas backward kernels)."""
    q, k, v, _ = _qkv(32, 32, seed=4)
    jgr = jax.grad(lambda a, b, c: jnp.sum(interpret.flash_attention(
        a, b, c, causal=causal, block_q=16, block_k=16) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=16,
                              block_k=16)
    out.square().sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert tfa.flash_bwd_dq_plain.launches == 1
    assert tfa.flash_bwd_dkv_plain.launches == 1


def test_bf16_matches_pallas_kernels(interpret):
    q, k, v, do = _qkv(40, 40, seed=6)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = pa._flash_fwd_impl(jq, jk, jv, True, 16, 16, need_lse=True)
    jg = pa._flash_bwd_impl(jq, jk, jv, jo, jlse, jdo, True, 16, 16)
    tq, tk, tv, tdo = (x.to(torch.bfloat16) for x in _t(q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, True, 16, 16, need_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _bf16_ulp_close(o.float().numpy(), np.asarray(jo, np.float32), 1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :40],
                               rtol=1e-5, atol=1e-5)
    # the backward from the reference's own o and lse: same inputs
    to = torch.from_numpy(np.asarray(jo, np.float32)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.asarray(jlse)[:, :40].copy())
    grads = tfa.flash_bwd(tq, tk, tv, to, tlse, tdo, True, 16, 16)
    for got, want in zip(grads, jg):
        assert got.dtype == torch.bfloat16
        _bf16_ulp_close(got.float().numpy(), np.asarray(want, np.float32), 2)


def test_lse_matches_direct_logsumexp():
    q, k, v, _ = _qkv(32, 32, seed=7)
    _, lse = tfa.flash_fwd(*_t(q, k, v), False, 16, 16, need_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(8)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref.reshape(4, 32), rtol=1e-5,
                               atol=1e-5)


def test_empty_rows_give_zero_and_the_sentinel():
    """A zero-length key axis: every row has no valid key, so each emits
    exact zeros and the +1e30 lse sentinel."""
    q = torch.randn(1, 2, 5, 8)
    k = torch.zeros(1, 2, 0, 8)
    o, lse = tfa.flash_fwd(q, k, k, need_lse=True)
    assert torch.all(o == 0) and torch.all(lse == tfa.LSE_EMPTY)


def test_recompute_knob_matches_kernel_backward():
    """"recompute" (autograd through blockwise_attention, no lse) and the
    kernel backward give the same gradients; the knob restores."""
    q, k, v, _ = _qkv(48, 48, seed=5)

    def grads():
        ts = [x.requires_grad_(True) for x in _t(q, k, v)]
        tfa.flash_attention(*ts, causal=True, block_q=16,
                            block_k=16).square().sum().backward()
        return [t.grad for t in ts]

    g_kernel = grads()
    assert tfa.flash_bwd_dq_plain.launches == 1
    old = tfa.set_flash_bwd("recompute")
    try:
        g_rec = grads()
    finally:
        tfa.set_flash_bwd(old)
    assert old == "kernel" and tfa._BWD_IMPL == "kernel"
    assert tfa.flash_bwd_dq_plain.launches == 1  # recompute ran no K2 twin
    for a, b in zip(g_kernel, g_rec):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError):
        tfa.set_flash_bwd("fused")


def test_lse_only_when_a_gradient_is_needed(monkeypatch):
    q, k, v, _ = _qkv(16, 16, seed=8)
    calls = []
    orig = tfa.flash_fwd

    def spy(*a):
        calls.append(a[-1])
        return orig(*a)

    monkeypatch.setattr(tfa, "flash_fwd", spy)
    tq, tk, tv = _t(q, k, v)
    with torch.no_grad():
        tfa.flash_attention(tq, tk, tv)
    tfa.flash_attention(tq, tk, tv)               # no input needs grad
    tfa.flash_attention(tq.requires_grad_(True), tk, tv)
    assert calls == [False, False, True]


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_float64(causal):
    """FlashAttentionFn's backward is the derivative of its forward
    (finite differences in float64, padded and ragged blocks)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, T, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for T in (7, 5, 5))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal,
                                            block_q=3, block_k=2),
        (q, k, v))


class TestFusedMaskParity:
    """Mirror of tests/test_attention.py::TestFusedMaskParity for the
    port, plus each port form against the reference's."""

    def _qkv(self):
        rng = np.random.RandomState(3)
        return [rng.randn(2, 2, 16, 8).astype("float32") for _ in range(3)]

    def _check(self, km, causal=False):
        q, k, v = self._qkv()
        tq, tk, tv = _t(q, k, v)
        tkm = torch.from_numpy(km)
        o_f = ta.dot_product_attention(tq, tk, tv, causal=causal,
                                       key_mask=tkm)
        o_b = ta.blockwise_attention(tq, tk, tv, block_size=4,
                                     causal=causal, key_mask=tkm)
        ref = ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       key_mask=jnp.asarray(km))
        np.testing.assert_allclose(o_f.numpy(), o_b.numpy(), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(o_f.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
        return o_f

    def test_fused_masked_equals_blockwise_masked(self):
        km = np.ones((2, 16), bool)
        km[0, 10:] = False
        self._check(km)

    def test_fully_masked_rows_emit_zero(self):
        km = np.ones((2, 16), bool)
        km[0, :] = False
        assert torch.all(self._check(km)[0] == 0)

    def test_causal_key_mask_row_with_no_valid_key(self):
        km = np.ones((2, 16), bool)
        km[0, 0] = False
        assert torch.all(self._check(km, causal=True)[0, :, 0] == 0)

    def test_flash_attention_mask_dispatch_parity(self):
        """With a key mask flash_attention takes the fused form below
        512 and the blockwise scan from there (or when streaming is
        forced), never the flash path, and matches the reference."""
        q, k, v = self._qkv()
        km = np.ones((2, 16), bool)
        km[0, 7:] = False
        tkm = torch.from_numpy(km)
        o = tfa.flash_attention(*_t(q, k, v), key_mask=tkm)
        o_s = tfa.flash_attention(*_t(q, k, v), key_mask=tkm,
                                  force_streaming=True, block_k=4)
        ref = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), key_mask=jnp.asarray(km))
        for got in (o, o_s):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=2e-5, atol=2e-5)
        assert tfa.flash_fwd_plain.launches == 0


def test_blockwise_matches_reference_blockwise():
    q, k, v, _ = _qkv(21, 21, seed=9)
    for causal in (False, True):
        got = ta.blockwise_attention(*_t(q, k, v), block_size=8,
                                     causal=causal)
        ref = ja.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_size=8,
                                     causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_mha_routes_through_flash():
    """multi_head_attention reaches FlashAttentionFn (its plain versions
    on the CPU) and matches the reference's."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20, 8).astype("float32")
    W = [rng.randn(8, 8).astype("float32") for _ in range(4)]
    got = ta.multi_head_attention(*_t(x, *W), nHeads=2)
    assert tfa.flash_fwd_plain.launches == 1
    ref = ja.multi_head_attention(jnp.asarray(x), *map(jnp.asarray, W),
                                  nHeads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T,D,dtype,on_cuda,has_mask,streaming,want", [
    (512, 64, torch.float32, True, False, False, "flash"),
    (40, 128, torch.bfloat16, True, False, False, "flash"),
    (40, 64, torch.float64, True, False, False, "fused"),
    (40, 64, torch.float16, True, False, False, "fused"),
    (600, 64, torch.float16, True, False, False, "blockwise"),
    (40, 100, torch.float32, True, False, False, "fused"),
    (40, 256, torch.float32, True, False, True, "blockwise"),
    (40, 12, torch.bfloat16, True, False, False, "fused"),
    (40, 64, torch.float64, False, False, False, "flash"),
    (40, 256, torch.float32, False, False, False, "flash"),
    (40, 64, torch.float32, True, True, False, "fused"),
    (40, 64, torch.float32, False, True, False, "fused"),
    (512, 64, torch.float32, False, True, False, "blockwise"),
])
def test_dispatch_is_a_domain_decision(T, D, dtype, on_cuda, has_mask,
                                       streaming, want):
    """On the card the kernels take f32/bf16 at a head width that is a
    multiple of 8 in 8..128 and no key mask; anything else takes the
    fused (T < 512, not streaming) or blockwise form on the same device.
    On the CPU the plain versions take every dtype and width."""
    assert tfa._choose_impl(T, D, dtype, on_cuda=on_cuda, has_mask=has_mask,
                            force_streaming=streaming) == want


def test_masked_call_counts_its_route():
    """The launch counts show the route a call took."""
    q = torch.randn(1, 2, 40, 8)
    tfa.reset_launches()
    tfa.flash_attention(q, q, q, key_mask=torch.ones(1, 40, dtype=torch.bool))
    assert (ta.dot_product_attention.launches,
            ta.blockwise_attention.launches, tfa.flash_fwd_plain.launches) \
        == (1, 0, 0)
    tfa.flash_attention(q.double(), q.double(), q.double())
    assert tfa.flash_fwd_plain.launches == 1


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_masked_forms_stay_finite(causal):
    """-1e30 does not fit in fp16: the masked scores take fp16's lowest
    finite value there, and the fused and blockwise forms still agree
    with the f64 answer (a padded last block at T 600)."""
    q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(
        1, 2, 600, 16)) for i in range(3))
    want = ta.dot_product_attention(q, k, v, causal=causal)
    for fn in (ta.dot_product_attention, ta.blockwise_attention):
        got = fn(q.half(), k.half(), v.half(), causal=causal)
        assert bool(got.isfinite().all())
        assert float((got.double() - want).norm() / want.norm()) <= 2e-3


def test_wrapper_rejects_bad_operands():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="k, v"):
        tfa.flash_fwd(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16))
    with pytest.raises(TypeError):
        tfa.flash_fwd(q, q.double(), q)
    with pytest.raises(ValueError, match="lse and delta"):
        tfa.flash_bwd_dq(q, q, q, q, torch.zeros(2, 4), torch.zeros(2, 3))


def test_loader_builds_every_source_at_once(tmp_path, monkeypatch):
    """ops/_kernels.py starts one nvcc per source together, keys each
    library by its source's hash, reuses a built one, and reports every
    failing source. A stand-in nvcc (a shell script that sleeps and
    writes its -o file) stands in for the CUDA toolkit, so the test needs
    none."""
    from deeplearning4j_tpu_torch.ops import _kernels

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\nsleep 1\nwhile [ $# -gt 0 ]; do\n"
        "  case \"$1\" in -o) out=\"$2\"; shift;; *.cu) src=\"$1\";; esac\n"
        "  shift\ndone\n"
        "grep -q broken \"$src\" && { echo \"bad $src\" >&2; exit 2; }\n"
        "cp \"$src\" \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    srcs = []
    for name in ("a.cu", "b.cu", "c.cu"):
        srcs.append(tmp_path / name)
        srcs[-1].write_text(f"// {name}\n")
    import time

    t0 = time.perf_counter()
    outs = _kernels._build_all(srcs)
    assert time.perf_counter() - t0 < 2.5       # three 1 s builds at once
    assert [o.read_text() for o in outs] == [s.read_text() for s in srcs]
    assert all(_kernels.BUILD_SECONDS[s.name] >= 1.0 for s in srcs)
    assert _kernels._build_all(srcs) == outs    # keyed by hash: reused
    assert all(_kernels.BUILD_SECONDS[s.name] == 0.0 for s in srcs)
    srcs[1].write_text("// broken\n")
    with pytest.raises(RuntimeError, match="b.cu"):
        _kernels._build_all(srcs)
