"""The port's gradient exchanges and synchronised BN
(deeplearning4j_tpu_torch/parallel/{collectives,sharding}.py,
ops/norm.py), on gloo ranks on the CPU (rank bodies in
tests/_torch_parallel_ranks.py), against exact arithmetic and, in the
parity cases, against the reference's own exchange code run in
``shard_map`` on its virtual CPU mesh.

Bars:
- int8/block_int8: the packed-lane sum equals the exact integer sum of
  every rank's lanes; the lanes and the dequantized means equal the
  reference's (``sharding._quantize`` / ``quantized_psum_mean``) bit for
  bit on equal inputs (0 lanes off).
- threshold: each rank's wire codes (sign(val) · (idx + 1)) and its
  residual equal the reference encoder's (idx, val) and residual, bit
  for bit; the mean equals the reference's gathered scatter-add bitwise
  at dp 2 and within 1 f32 ulp at dp 4 (the port scales the exact signed
  count by tau once, the reference adds ±tau one by one).
- ``compressed_wire_bytes`` equals the reference's for every mode and dp
  in {2, 4, 8, 128}.
- bytes the collective counter records against the bill: dense within
  10 %; int8 and block_int8 send 4/k bytes a lane (k lanes a packed
  int32 word: 3 up to dp 4, 2 up to dp 129; block_int8 pads each leaf's
  lanes to whole blocks) plus one scale a leaf (a block): int8 1.33x the
  bill at dp 2 and 4 (block_int8 too on ResNet-50's leaves; this test's
  37- and 3-element leaves pad to 256 lanes each); threshold sends 4
  bytes a pair where the bill counts 5 (0.8x).
  Each is checked against its own formula exactly.
- sync BN (all three autograd Functions, f64): per-rank y, dx and the
  residual's gradient, the batch mean/var and the summed dgamma/dbeta
  within 1e-12 of one process on the concatenated batch; one
  collective in each backward.
- the dry run's legs on two ranks; its sync-BN leg in f32 within
  SYNC_BN_F32_ATOL of single-device training (the bar chip_smoke.py
  phase 13(b) holds the card to), and its int8 step inside the grid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu.ndarray.compression import (
    threshold_cap as jcap, threshold_encode_fixed as jencode,
)
from deeplearning4j_tpu.parallel import data_parallel_mesh as jmesh
from deeplearning4j_tpu.parallel import sharding as jsh
from deeplearning4j_tpu.parallel._compat import shard_map

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.parallel import collectives as coll
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel import sharding as psh
from deeplearning4j_tpu_torch.parallel.dryrun import (
    SYNC_BN_F32_ATOL, dryrun_multichip, sync_bn_leg,
)

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def exchange(request):
    dp = request.param
    return dp, launch(R.exchange_rank, dp, device="cpu",
                      timeout=LAUNCH_TIMEOUT)


def grads(dp):
    return [R.exchange_grads(r) for r in range(dp)]


def ref_per_rank(dp, body, outs=2):
    """body(g) over each leaf inside one jitted shard_map on the
    reference's dp-device mesh; returns, per leaf, body's `outs` outputs
    stacked [dp, ...]."""
    g = grads(dp)
    n = len(R.EXCHANGE_SIZES)
    stacked = tuple(jnp.asarray(np.stack([g[r][leaf] for r in range(dp)]))
                    for leaf in range(n))

    def per_rank(*leaves):
        return tuple(o[None] for leaf in leaves for o in body(leaf[0], dp))

    fn = jax.jit(shard_map(per_rank, mesh=jmesh(dp),
                           in_specs=(P("data"),) * n,
                           out_specs=(P("data"),) * (outs * n),
                           check_vma=False))
    got = [np.asarray(o) for o in fn(*stacked)]
    return [got[outs * i:outs * (i + 1)] for i in range(n)]


@pytest.mark.parametrize("mode", ["int8", "block_int8"])
def test_lane_sum_is_the_exact_integer_sum(exchange, mode):
    dp, res = exchange
    for leaf in range(len(R.EXCHANGE_SIZES)):
        lanes = np.stack([r[mode]["lanes"][leaf].astype(np.int64)
                          for r in res])
        for r in res:
            np.testing.assert_array_equal(r[mode]["sum"][leaf],
                                          lanes.sum(0))


@pytest.mark.parametrize("mode", ["int8", "block_int8"])
def test_means_are_the_dequantized_exact_sum(exchange, mode):
    """sum · (sc/127) / dp in f32, bitwise, on every rank."""
    dp, res = exchange
    for leaf in range(len(R.EXCHANGE_SIZES)):
        s = res[0][mode]["sum"][leaf].astype(np.float32)
        sc = res[0][mode]["scales"][leaf]
        want = s * (sc / np.float32(127.0)) / np.float32(dp)
        for r in res:
            np.testing.assert_array_equal(r[mode]["means"][leaf], want)


@pytest.mark.parametrize("mode", ["int8", "block_int8"])
def test_lanes_and_means_equal_the_reference(exchange, mode):
    dp, res = exchange

    def body(g, dp):
        q, _, _ = jsh._quantize(g, "data", dp, mode, 256)
        return q, jsh.quantized_psum_mean(g, "data", dp, mode, 256)

    for leaf, (q, mean) in enumerate(ref_per_rank(dp, body)):
        for rank, r in enumerate(res):
            np.testing.assert_array_equal(
                r[mode]["lanes"][leaf].astype(np.int32), q[rank])
            np.testing.assert_array_equal(r[mode]["means"][leaf],
                                          mean[rank])


def test_threshold_equals_the_reference(exchange):
    """The reference's trainer.py:672-690 per leaf: encode, all-gather
    (idx, val), scatter-add, / dp."""
    dp, res = exchange
    tau = jnp.float32(1e-2)

    def body(g, dp):
        idx, val, _, rest = jencode(g, tau, jcap(g.size, 0.125))
        gi = lax.all_gather(idx, "data", tiled=True)
        gv = lax.all_gather(val, "data", tiled=True)
        code = ((idx + 1) * jnp.sign(val).astype(idx.dtype))
        return jnp.zeros_like(g).at[gi].add(gv) / dp, rest, code

    caps = [jcap(n, 0.125) for n in R.EXCHANGE_SIZES]
    sent = 0
    for leaf, (mean, rest, code) in enumerate(ref_per_rank(dp, body, 3)):
        for rank, r in enumerate(res):
            got = r["threshold"]
            # the wire: sign(val) * (idx + 1), 0 where nothing crosses tau
            np.testing.assert_array_equal(
                np.split(got["codes"], np.cumsum(caps)[:-1])[leaf],
                code[rank])
            np.testing.assert_array_equal(got["residuals"][leaf], rest[rank])
            m = got["means"][leaf]
            if dp == 2:
                np.testing.assert_array_equal(m, mean[rank])
            else:
                ulp = np.spacing(np.abs(mean[rank]).astype(np.float32))
                assert np.all(np.abs(m - mean[rank]) <= ulp), leaf
        sent += int(np.count_nonzero(
            np.asarray(grads(dp)[0][leaf]) - rest[0]))
    assert res[0]["threshold"]["sent"] == sent


@pytest.mark.parametrize("dp", [2, 4, 8, 128])
@pytest.mark.parametrize("mode", [None, "int8", "block_int8", "threshold",
                                  "hierarchical"])
def test_compressed_wire_bytes_equal_the_reference(mode, dp):
    G = 4 * 25_557_032
    for kw in ({}, {"block": 64, "capacity": 0.01}):
        try:
            want = jsh.compressed_wire_bytes(G, dp, mode, **kw)
        except ValueError as e:   # hierarchical at dp 2: no factorization
            with pytest.raises(ValueError) as got:
                psh.compressed_wire_bytes(G, dp, mode, **kw)
            assert str(got.value) == str(e)
            continue
        assert psh.compressed_wire_bytes(G, dp, mode, **kw) == want
    if mode == "hierarchical" and dp >= 8:
        kw = dict(group_size=dp // 2, intra_mode=None)
        assert psh.compressed_wire_bytes(G, dp, mode, **kw) \
            == jsh.compressed_wire_bytes(G, dp, mode, **kw)


def test_counted_bytes_against_the_bill(exchange):
    dp, res = exchange
    N = sum(R.EXCHANGE_SIZES)
    k = 31 // coll.lane_bits(dp)
    ring = 2 * (dp - 1) / dp
    blocks = sum(-(-n // 256) for n in R.EXCHANGE_SIZES)
    leaves = len(R.EXCHANGE_SIZES)
    for mode, scales in (("int8", leaves), ("block_int8", blocks)):
        # block_int8 sends each leaf's lanes padded to whole blocks
        lanes = N if mode == "int8" else 256 * blocks
        assert res[0][mode]["wire_lanes"] == lanes
        words = 4 * -(-lanes // k)
        count, payload, wire = res[0][mode]["comm"]
        assert (count, payload) == (2, words + 4 * scales)
        assert wire == (2 * (dp - 1) * words // dp
                        + 2 * (dp - 1) * 4 * scales // dp)
        if mode == "int8":
            bill = psh.compressed_wire_bytes(4 * N, dp, mode)["wire_bytes"]
            assert 1.2 < wire / bill < 1.45, wire / bill
    count, payload, wire = res[0]["threshold"]["comm"]
    caps = sum(psh.threshold_cap(n, 0.125) for n in R.EXCHANGE_SIZES)
    assert (count, payload, wire) == (1, 4 * caps, (dp - 1) * 4 * caps)
    bill = psh.compressed_wire_bytes(4 * N, dp, "threshold")["wire_bytes"]
    assert 0.75 < wire / bill < 0.85
    count, payload, wire = res[0]["dense"]["comm"]
    bill = psh.compressed_wire_bytes(4 * N, dp)["wire_bytes"]
    assert count == 1 and abs(wire - bill) <= 0.1 * bill


def test_lane_packing_holds_every_sum():
    """At every dp the packed lanes have room for 254·dp and k lanes fit
    31 bits; the packing is exact at world size 1 too."""
    for dp in (1, 2, 3, 4, 5, 8, 64, 128, 129, 4096):
        bits = coll.lane_bits(dp)
        assert 254 * dp < 2 ** bits and 31 // bits >= 1
    from deeplearning4j_tpu_torch.parallel import data_parallel_mesh
    q = torch.arange(-127, 128, dtype=torch.int8).repeat(5)
    np.testing.assert_array_equal(
        coll.int8_lane_sum(q, data_parallel_mesh()).numpy(), q.numpy())


@pytest.fixture(scope="module")
def sync_bn():
    rng = np.random.RandomState(7)
    x = rng.randn(16, 5, 3, 3)
    w = rng.randn(16, 5, 3, 3)
    res = rng.randn(16, 5, 3, 3)
    return x, w, res, launch(R.sync_bn_rank, 4, device="cpu",
                             timeout=LAUNCH_TIMEOUT, args=(x, w, res))


@pytest.mark.parametrize("kind", ["plain", "act", "act_add"])
def test_sync_bn_equals_bn_on_the_whole_batch(sync_bn, kind):
    from deeplearning4j_tpu_torch.ops import norm

    x, w, res, ranks = sync_bn
    xt = torch.from_numpy(x).requires_grad_(True)
    gamma = torch.linspace(0.5, 1.5, 5, dtype=torch.float64) \
        .requires_grad_(True)
    beta = torch.linspace(-0.2, 0.3, 5, dtype=torch.float64) \
        .requires_grad_(True)
    rt = torch.from_numpy(res).requires_grad_(True)
    if kind == "plain":
        y, mean, var = norm.BNTrainFn.apply(xt, gamma, beta, 1e-5)
    elif kind == "act":
        y, mean, var = norm.BNActTrainFn.apply(xt, gamma, beta, 1e-5,
                                               "relu")
    else:
        y, mean, var = norm.BNActAddTrainFn.apply(xt, gamma, beta, rt, 1e-5,
                                                  "relu")
    (y * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=0, atol=1e-12)
    b = x.shape[0] // len(ranks)
    for r, got in enumerate(ranks):
        got = got[kind]
        rows = slice(r * b, (r + 1) * b)
        np.testing.assert_allclose(got["y"], y.detach().numpy()[rows], **tol)
        np.testing.assert_allclose(got["dx"], xt.grad.numpy()[rows], **tol)
        np.testing.assert_allclose(got["mean"], mean.numpy(), **tol)
        np.testing.assert_allclose(got["var"], var.numpy(), **tol)
        if kind == "act_add":
            np.testing.assert_allclose(got["dres"], rt.grad.numpy()[rows],
                                       **tol)
        assert got["bwd_collectives"] == 1
    for name, want in (("dgamma", gamma.grad), ("dbeta", beta.grad)):
        total = sum(g[kind][name] for g in ranks)
        np.testing.assert_allclose(total, want.numpy(), **tol)


def test_sync_bn_without_a_group_is_the_local_code():
    """A group of one rank is no group: the Functions' local path."""
    from deeplearning4j_tpu_torch.ops import norm
    from deeplearning4j_tpu_torch.parallel import data_parallel_mesh

    x = torch.randn(8, 3, 4, 4, generator=torch.Generator().manual_seed(1))
    g, b = torch.ones(3), torch.zeros(3)
    want = norm.BNActTrainFn.apply(x, g, b, 1e-5, "relu")
    with norm.sync_batch_norm(data_parallel_mesh()):
        assert norm._SYNC_GROUP.get() is None
        got = norm.BNActTrainFn.apply(x, g, b, 1e-5, "relu")
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_dryrun_multichip_on_two_ranks():
    out = dryrun_multichip(2, "cpu", timeout=LAUNCH_TIMEOUT)
    assert set(out) == {"resnet50_dp", "int8", "averaging", "threshold",
                        "sync_bn"}
    # ResNet-50: gradients + loss, 3 for each of its 53 BN layers
    assert out["resnet50_dp"]["comm"]["collectives"] == 2 + 3 * 53
    assert out["sync_bn"]["max_abs_vs_single"] <= SYNC_BN_F32_ATOL
    assert out["sync_bn"]["int8_grid_excess"] <= 1e-5


def test_sync_bn_leg_f32_bound():
    """The f32 bar phase 13(b) holds the card's two gloo ranks to."""
    res = launch(sync_bn_leg, 2, device="cpu", timeout=LAUNCH_TIMEOUT,
                 args=("FLOAT", 3))
    assert np.abs(res[0]["dense"] - res[0]["single"]).max() \
        <= SYNC_BN_F32_ATOL
    np.testing.assert_allclose(res[0]["dense_losses"],
                               res[0]["single_losses"], rtol=1e-6)
    assert res[0]["replicated"] and res[1]["replicated"]
    assert max(r["int8_grid_excess"] for r in res) <= 1e-5
