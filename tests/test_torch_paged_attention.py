"""Port parity for the paged attention ops (deeplearning4j_tpu_torch/
ops/paged_attention.py) against the JAX reference (ops/pallas_attention.py).

On the CPU the port's ``paged_flash_decode`` / ``paged_flash_prefill``
run their plain version; the reference kernels run in Pallas interpret
mode. Grids follow tests/test_paged_attention.py: aligned and padded,
f32 and bf16, pool pages scattered through a permuted block table, a
zero-length slot, a tail chunk.

Tolerances (port vs reference, same inputs):
- f32: rtol 1e-5, atol 1e-6 — both accumulate in f32 page by page; only
  the order inside each dot product and page sum differs.
- bf16: at most 1 bf16 ulp — both accumulate in f32 and round the
  output once, so the f32 difference above can move the rounding by one
  step at most.
- lse (f32): rtol 1e-5, atol 1e-5.

The CUDA kernels themselves run only on the card:
tests/test_torch_kernels_card.py holds them to the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import pallas_attention as pa
from deeplearning4j_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def bf16_ulp_distance(a, b):
    """Elementwise distance in bf16 steps between two bf16 arrays
    (given as float32 values exactly representable in bf16)."""
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
        np.testing.assert_allclose(got, ref, **F32_TOL)


def _to(dtype, x):
    """numpy f32 -> (torch tensor in dtype, numpy array JAX takes in the
    same dtype) carrying identical values."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, t.float().numpy().astype(jnp.bfloat16)
    return t, t.numpy().copy()


def _pool(rng, P, page, H, D):
    kp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    return kp, vp


def _tables(rng, lens, page, P, MP):
    """Block tables for slots of the given lengths, pages drawn from a
    permutation of 1..P-1 (physical order != logical order); unused
    entries point at the null page 0."""
    order = rng.permutation(np.arange(1, P))
    bts = np.zeros((len(lens), MP), np.int32)
    k = 0
    for s, n in enumerate(lens):
        for j in range(-(-n // page)):
            bts[s, j] = order[k]
            k += 1
    return bts


GRIDS = [
    pytest.param(8, 4, "float32", id="aligned-f32"),
    pytest.param(7, 4, "float32", id="padded-f32"),
    pytest.param(8, 4, "bfloat16", id="aligned-bf16"),
    pytest.param(7, 4, "bfloat16", id="padded-bf16"),
]


class TestDecodeVsReference:
    @pytest.mark.parametrize("T,page,dtype", GRIDS)
    def test_decode_matches_interpret_kernel(self, T, page, dtype):
        """Port decode (plain on CPU) vs the reference K4 in interpret
        mode: ragged slots incl. a zero-length one, scattered pages,
        output AND lse."""
        rng = np.random.default_rng(0)
        H, D, P = 2, 8, 16
        lens = [T, 0, T - 3, 1]
        MP = -(-T // page) + 1            # one trailing null entry
        kp, vp = _pool(rng, P, page, H, D)
        bts = _tables(rng, lens, page, P, MP)
        q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
        (tq, jq), (tk, jk), (tv, jv) = (_to(dtype, x) for x in (q, kp, vp))
        sls = np.asarray(lens, np.int32)
        ref, ref_lse = pa.paged_flash_decode(
            jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv), bts, sls,
            need_lse=True, interpret=True)
        out, lse = tpa.paged_flash_decode(
            tq, tk, tv, torch.from_numpy(bts), torch.from_numpy(sls),
            need_lse=True)
        assert out.dtype == tq.dtype
        assert_close(out.float().numpy(), np.asarray(ref, np.float32),
                     dtype)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   rtol=1e-5, atol=1e-5)
        # the zero-length slot: exact zeros and the sentinel
        assert torch.all(out[1] == 0)
        assert torch.all(lse[1] == tpa.LSE_EMPTY)

    @pytest.mark.parametrize("T,page,dtype", GRIDS)
    def test_paged_attend_matches_reference_core(self, T, page, dtype):
        """The plain ``paged_attend`` vs the reference's portable
        ``paged_attend`` on the same gathered pages, a prefill-shaped
        (R = page) query block at offset 0."""
        rng = np.random.default_rng(3)
        H, D, P = 2, 8, 12
        kp, vp = _pool(rng, P, page, H, D)
        MP = -(-T // page)
        bt = _tables(rng, [T], page, P, MP)[0]
        q = rng.standard_normal((1, page, H, D)).astype(np.float32)
        (tq, jq), (tk, jk), (tv, jv) = (_to(dtype, x) for x in (q, kp, vp))
        lens = np.asarray([T], np.int32)
        starts = np.asarray([0], np.int32)
        ref = pa.paged_attend(jnp.asarray(jq), jnp.asarray(jk)[bt[None]],
                              jnp.asarray(jv)[bt[None]], jnp.asarray(lens),
                              jnp.asarray(starts))
        got = tpa.paged_attend(tq, tk[torch.from_numpy(bt).long()][None],
                               tv[torch.from_numpy(bt).long()][None],
                               torch.from_numpy(lens),
                               torch.from_numpy(starts))
        assert_close(got.float().numpy(), np.asarray(ref, np.float32),
                     dtype)

    def test_trailing_null_pages_are_noops(self):
        """Pages past a slot's length are masked, not relied on to be
        zero: a poisoned null page and a wider table leave the output
        bitwise unchanged."""
        rng = np.random.default_rng(2)
        T, page, H, D, P = 12, 4, 2, 8, 16
        kp, vp = _pool(rng, P, page, H, D)
        kp[0] = 7.5
        vp[0] = -3.25
        bt = _tables(rng, [T], page, P, 3)
        q = torch.from_numpy(rng.standard_normal((1, H, D)).astype(
            np.float32))
        sls = torch.tensor([T], dtype=torch.int32)
        tight = tpa.paged_flash_decode(q, torch.from_numpy(kp),
                                       torch.from_numpy(vp),
                                       torch.from_numpy(bt), sls)
        wide = np.zeros((1, 6), np.int32)
        wide[0, :3] = bt[0]
        out = tpa.paged_flash_decode(q, torch.from_numpy(kp),
                                     torch.from_numpy(vp),
                                     torch.from_numpy(wide), sls)
        assert torch.equal(tight, out)


class TestPrefillVsReference:
    @pytest.mark.parametrize("T,page,dtype", GRIDS)
    def test_prefill_chunks_match_interpret_kernel(self, T, page, dtype):
        """Every page-sized chunk of a T-token prompt (the last one a
        tail when T is padded) vs the reference K5 in interpret mode."""
        rng = np.random.default_rng(1)
        H, D, P = 2, 8, 12
        kp, vp = _pool(rng, P, page, H, D)
        MP = -(-T // page)
        bt = _tables(rng, [T], page, P, MP)[0]
        (tk, jk), (tv, jv) = (_to(dtype, x) for x in (kp, vp))
        for c in range(MP):
            t0 = c * page
            n_valid = min(page, T - t0)
            q = rng.standard_normal((page, H, D)).astype(np.float32)
            tq, jq = _to(dtype, q)
            ref = pa.paged_flash_prefill(jnp.asarray(jq), jnp.asarray(jk),
                                         jnp.asarray(jv), bt, t0, n_valid,
                                         interpret=True)
            out = tpa.paged_flash_prefill(tq, tk, tv, torch.from_numpy(bt),
                                          t0, n_valid)
            assert_close(out[:n_valid].float().numpy(),
                         np.asarray(ref, np.float32)[:n_valid], dtype)


class TestWrapperContract:
    def test_cpu_tensors_run_the_plain_version(self):
        """On CPU tensors the wrappers count a plain call, never a
        kernel launch."""
        tpa.reset_launches()
        rng = np.random.default_rng(4)
        kp, vp = (torch.from_numpy(a) for a in _pool(rng, 4, 4, 2, 8))
        q = torch.zeros((1, 2, 8))
        bt = torch.tensor([[1, 2]], dtype=torch.int32)
        tpa.paged_flash_decode(q, kp, vp, bt,
                               torch.tensor([5], dtype=torch.int32))
        tpa.paged_flash_prefill(torch.zeros((4, 2, 8)), kp, vp, bt[0], 4, 1)
        assert tpa.paged_attend.launches == 2
        assert tpa.paged_flash_decode.launches == 0
        assert tpa.paged_flash_prefill.launches == 0

    @pytest.mark.parametrize("bad", ["dtype", "int64-table", "shape",
                                     "noncontig", "chunk", "t0", "n_valid"])
    def test_rejects_what_the_kernels_do_not_take(self, bad):
        kp = torch.zeros((4, 4, 2, 8))
        vp = torch.zeros((4, 4, 2, 8))
        q = torch.zeros((1, 2, 8))
        bt = torch.tensor([[1, 2]], dtype=torch.int32)
        sl = torch.tensor([5], dtype=torch.int32)
        qc = torch.zeros((4, 2, 8))
        with pytest.raises((ValueError, TypeError)):
            if bad == "dtype":
                tpa.paged_flash_decode(q.double(), kp, vp, bt, sl)
            elif bad == "int64-table":
                tpa.paged_flash_decode(q, kp, vp, bt.long(), sl)
            elif bad == "shape":
                tpa.paged_flash_decode(torch.zeros((1, 3, 8)), kp, vp, bt,
                                       sl)
            elif bad == "noncontig":
                tpa.paged_flash_decode(q, kp.transpose(0, 1), vp, bt, sl)
            elif bad == "chunk":
                tpa.paged_flash_prefill(torch.zeros((3, 2, 8)), kp, vp,
                                        bt[0], 0, 1)
            elif bad == "t0":
                tpa.paged_flash_prefill(qc, kp, vp, bt[0], 2, 1)
            else:
                tpa.paged_flash_prefill(qc, kp, vp, bt[0], 4, 5)


def test_ctypes_signatures_match_the_c_interface():
    """Every extern "C" entry point of every csrc/*.cu (the paged pair
    and the flash kernels) is bound with one ctypes type per C
    parameter, in order (a pointer or the stream -> c_void_p, int ->
    c_int, float -> c_float): ctypes would otherwise pass a wrong
    argument list without complaint at build."""
    import ctypes
    import re

    from deeplearning4j_tpu_torch.ops import _kernels

    assert {s.name for s in _kernels.SOURCES} >= {
        "paged_attention.cu", "flash_attention.cu"}
    decls = {}
    for source in _kernels.SOURCES:
        src = source.read_text()
        c_api = src[src.index('extern "C" {'):]
        decls.update(re.findall(r"int (dl4j_\w+)\(([^)]*)\)", c_api))
    assert set(decls) == set(_kernels._SIGNATURES)
    to_ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float}
    for name, params in decls.items():
        kinds = [to_ctype["void*" if "*" in p else p.split()[0]]
                 for p in (x.strip() for x in params.split(","))]
        assert kinds == _kernels._SIGNATURES[name], name
