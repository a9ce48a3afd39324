"""The data-parallel trainers on the card (``cuda`` marker): a real NCCL
process group at world 1 gives dense training bitwise equal to ``fit``;
the sharded (ZeRO) update at world 1 is bitwise the replicated one;
the int8/block_int8 lanes and the threshold exchange computed on the card
equal the same functions on the CPU for the same gradient (the plain
arithmetic of one rank: lanes, means and residuals bitwise); two gloo
ranks share one card and hold the sync-BN leg to single-device training
(parallel.dryrun.sync_bn_leg, SYNC_BN_F32_ATOL) and an int8 step to its
grid.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_parallel_card.py

Without a card every test skips (NCCL and the CUDA exchanges need one).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as R  # noqa: E402

from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    DataGroup, ParallelWrapper, initializeMultiHost, launch,
)
from deeplearning4j_tpu_torch.parallel import sharding as sh  # noqa: E402
from deeplearning4j_tpu_torch.parallel.dryrun import (  # noqa: E402
    SYNC_BN_F32_ATOL, sync_bn_leg,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the CUDA exchanges")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


@pytest.fixture
def nccl(card, tmp_path):
    import torch.distributed as dist

    group = initializeMultiHost(init_method=f"file://{tmp_path}/store",
                                num_processes=1, process_id=0, device=card,
                                timeout=120)
    try:
        yield group
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["mlp", "bn_cnn"])
def test_nccl_world1_dense_is_bitwise_fit(nccl, name):
    assert nccl.backend == "nccl" and nccl.pg is not None
    if name == "bn_cnn":
        x, y = R.bn_cnn_batch(16)
    else:
        x, y, _ = R.data(64)
    a = R.build(name, device="cuda")
    b = R.build(name, device="cuda")
    pw = ParallelWrapper(b, mesh=nccl)
    for _ in range(3):
        a.fit(x, y)
        pw.fit(x, y)
        assert a.score() == b.score()
    for k, v in R.ref_params(a).items():
        np.testing.assert_array_equal(R.ref_params(b)[k], v, err_msg=k)
    # the gradients' and the loss's NCCL all-reduce; no BN group at world 1
    assert pw.last_step["collectives"] == 2


@pytest.mark.parametrize("comp", [None, "int8"], ids=["dense", "int8"])
def test_nccl_world1_sharded_is_bitwise_replicated(nccl, comp):
    """weight_update="sharded" over a world-1 NCCL group: the flat view
    is a reshape and the updaters elementwise, so the trajectory is the
    replicated wrapper's bit for bit; the state is held flat."""
    x, y = R.zero_data()
    nets = []
    for wu in ("replicated", "sharded"):
        net = R.MultiLayerNetwork(R.zero_mlp_conf(), device="cuda").init()
        pw = ParallelWrapper(net, mesh=nccl, weight_update=wu,
                             gradient_compression=comp, min_shard_size=256)
        for _ in range(3):
            pw.fit(x, y)
        nets.append(net)
    a, b = nets
    assert a.score() == b.score()
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert (32 * 64,) in {tuple(t.shape) for p in b._upd_states
                          for t in p["m"].values()}


def _grads(device):
    return [torch.from_numpy(g).to(device) for g in R.exchange_grads(0)]


@pytest.mark.parametrize("mode", ["int8", "block_int8"])
def test_int8_lanes_on_the_card_equal_the_cpu(card, mode):
    local = DataGroup()
    q_card, s_card, _ = sh._quantize(_grads(card), local, mode, 256)
    q_cpu, s_cpu, _ = sh._quantize(_grads("cpu"), local, mode, 256)
    assert torch.equal(q_card.cpu(), q_cpu)
    assert torch.equal(s_card.cpu(), s_cpu)
    m_card = sh.quantized_psum_mean(_grads(card), local, mode)
    m_cpu = sh.quantized_psum_mean(_grads("cpu"), local, mode)
    for a, b in zip(m_card, m_cpu):
        assert torch.equal(a.cpu(), b)


def test_threshold_exchange_on_the_card_equals_the_cpu(card):
    local = DataGroup()
    out = []
    for dev in (card, torch.device("cpu")):
        g = _grads(dev)
        res = torch.zeros(sum(t.numel() for t in g), device=dev)
        tau = torch.tensor(1e-2, dtype=torch.float32, device=dev)
        out.append(sh.threshold_psum_mean(g, res, tau, 0.125, local))
    (m1, r1, s1), (m2, r2, s2) = out
    assert int(s1) == int(s2)
    assert torch.equal(r1.cpu(), r2)
    for a, b in zip(m1, m2):
        assert torch.equal(a.cpu(), b)


def test_two_gloo_ranks_share_one_card(card):
    res = launch(sync_bn_leg, 2, device="cuda", backend="gloo", timeout=300,
                 args=("FLOAT", 3))
    assert np.abs(res[0]["dense"] - res[0]["single"]).max() \
        <= SYNC_BN_F32_ATOL
    assert res[0]["replicated"] and res[1]["replicated"]
    assert max(r["int8_grid_excess"] for r in res) <= 1e-5
