"""The hierarchical 2-hop gradient exchange
(deeplearning4j_tpu_torch/parallel/sharding.py ``hierarchical_mesh``,
``hierarchical_grad_exchange``; ``ParallelWrapper(gradient_compression=
"hierarchical")``). Mirrors tests/test_hier_compression.py.

The reference factors one process's 8-device mesh; the port factors a
group of gloo ranks into ``torch.distributed`` subgroups (dp 4, node
groups of 2; one launch, rank bodies in tests/_torch_parallel_ranks.py).
Bars:

- the factorization: node groups of contiguous ranks, intra innermost;
  the validation messages and the default group size are the
  reference's, word for word;
- parity: 10 steps within the reference's 25 % of the dense run's loss
  for both hop-1 encodings, the hierarchical loss falling every step;
  one node group fed the same rows is one virtual Strom replica: the
  flat threshold run's params within rtol 1e-5 / atol 1e-6;
- the residual is this rank's blocks (``hierarchical_shard_elems`` a
  leaf: its row of the reference's [groups, group, shard]); a
  ResilientFit preempted mid-epoch resumes bitwise, residual and tau
  included; fitDataSet's blocks carry the residual; a flat threshold
  wrapper refuses the hierarchical trainer state;
- the bytes: a step's recorded sites equal ``port_wire_bill`` exactly
  and meet the declared contract;
- the trainer's and the Spark builder's mapping and refusals.
"""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.parallel.sharding as jsh
from deeplearning4j_tpu.parallel import (
    build_mesh as jbuild_mesh, data_parallel_mesh as jmesh,
)

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.analysis import validate_plan
from deeplearning4j_tpu_torch.analysis.collectives import (
    compression_contract, port_wire_bill,
)
from deeplearning4j_tpu_torch.analysis.partitioning import ShardingPlan
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DataGroup, ParallelWrapper, SharedTrainingMaster,
    SharedTrainingMasterBuilder, SparkDl4jMultiLayer, launch,
)
from deeplearning4j_tpu_torch.parallel import sharding as psh

torch.set_num_threads(1)

DP, GROUP = 4, 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hier"))
    return launch(R.hier_rank, DP, device="cpu", timeout=300, args=(tmp,))


class _Mesh2D:
    """A data x model mesh's shape (what the refusal reads)."""
    shape = {"data": 4, "model": 2}


# ----------------------------------------------------------------------
# the factorization
# ----------------------------------------------------------------------
def test_factorization_shape_and_rank_order():
    for rank in range(8):
        h = psh.hierarchical_mesh(DataGroup(rank=rank, size=8), 4)
        assert h.shape == {"group": 2, "intra": 4}
        # intra innermost: ranks 4k..4k+3 are node group k
        assert (h.group.rank, h.intra.rank) == divmod(rank, 4)
        assert h.intra.shape == {"intra": 4} and h.group.size == 2


@pytest.mark.parametrize("g", [3, 1, 8, 16, 5],
                         ids=["divisor", "one_chip", "single_group",
                              "exceeds", "builder_divisor"])
def test_validation_messages_are_the_reference(g):
    with pytest.raises(ValueError) as want:
        jsh.hierarchical_mesh(jmesh(8), g)
    with pytest.raises(ValueError) as got:
        psh.hierarchical_mesh(DataGroup(size=8), g)
    assert str(got.value) == str(want.value)


def test_needs_pure_data_mesh():
    with pytest.raises(ValueError) as want:
        jsh.hierarchical_mesh(jbuild_mesh({"data": 4, "model": 2}), 2)
    with pytest.raises(ValueError) as got:
        psh.hierarchical_mesh(_Mesh2D(), 2)
    assert str(got.value) == str(want.value)
    assert "1-D pure data-parallel" in str(got.value)


def test_default_group_and_shard_elems_are_the_reference():
    for dp in (4, 8, 32, 128):
        assert psh.default_compression_group(dp) == \
            jsh.default_compression_group(dp)
    for dp in (2, 7):
        with pytest.raises(ValueError, match="no hierarchical factoriz"):
            psh.default_compression_group(dp)
    for n, g in ((1000, 4), (1001, 4), (3, 4)):
        assert psh.hierarchical_shard_elems(n, g) == \
            jsh.hierarchical_shard_elems(n, g)
    with pytest.raises(ValueError, match="2 <= group_size <= dp/2"):
        psh.compressed_wire_bytes(4000, 8, "hierarchical", group_size=8)


# ----------------------------------------------------------------------
# parity at dp 4
# ----------------------------------------------------------------------
@pytest.mark.parametrize("intra_mode", ["block_int8", None],
                         ids=["block_int8", "dense"])
def test_hierarchical_trains_to_loss_parity(ranks, intra_mode):
    losses = ranks[0][("loss", intra_mode)]
    dense, hier = losses[None], losses["hierarchical"]
    assert all(b < a for a, b in zip(hier, hier[1:])), hier
    assert abs(hier[-1] - dense[-1]) <= 0.25 * max(dense[-1], 0.5), \
        (hier[-1], dense[-1])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[("params", intra_mode)],
                                      ranks[0][("params", intra_mode)])


@pytest.mark.parametrize("intra_mode", ["block_int8", None],
                         ids=["block_int8", "dense"])
def test_exchange_is_the_reference(ranks, intra_mode):
    """A training step's exchange (the second, so the residual it reads
    is not zero) against the reference's on the same gradients: the
    means, each rank's residual blocks and the count sent."""
    from jax.sharding import PartitionSpec as PS

    from deeplearning4j_tpu.parallel._compat import shard_map

    calls = [r[("call", intra_mode)] for r in ranks]
    res_in, tau, capacity, mode, block = calls[0]["args"]
    assert mode == intra_mode and all(
        c["args"][1] == tau for c in calls)
    sizes = [g.size for g in calls[0]["grads"]]
    ns = [psh.hierarchical_shard_elems(n, GROUP) for n in sizes]
    cut = np.cumsum(ns)[:-1]
    hm = jsh.hierarchical_mesh(jmesh(DP), GROUP)
    ax = PS((jsh.GROUP_AXIS, jsh.INTRA_AXIS))

    def body(g, r):
        m, res, sent = jsh.hierarchical_grad_exchange(
            g[0], r[0], tau, group_size=GROUP, n_groups=DP // GROUP,
            capacity=capacity, intra_mode=intra_mode, block=block)
        return m[None], res[None], sent[None]

    f = jax.jit(shard_map(body, mesh=hm, in_specs=(ax, ax),
                          out_specs=(ax, ax, ax), check_vma=False))
    sent = np.zeros(DP, dtype=np.int64)
    for j in range(len(sizes)):
        g = np.stack([c["grads"][j] for c in calls])
        r = np.stack([np.split(c["args"][0], cut)[j] for c in calls])
        m, res, s = (np.asarray(a) for a in f(g, r))
        for rank, c in enumerate(calls):
            np.testing.assert_allclose(c["out"][0][j], m[rank],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(np.split(c["out"][1], cut)[j],
                                       res[rank], rtol=1e-6, atol=1e-7)
        sent += s.astype(np.int64)
    assert [int(c["out"][2]) for c in calls] == sent.tolist()
    assert np.abs(res_in).max() > 0 and sent.min() > 0


def test_group_is_one_virtual_replica(ranks):
    v = ranks[0]["virtual"]
    np.testing.assert_allclose(v["hierarchical"], v["threshold"],
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the residual, resilience and the k-loop
# ----------------------------------------------------------------------
def test_residual_layout_is_this_ranks_blocks(ranks):
    lay = ranks[0]["layout"]
    assert lay["ef"] == [(psh.hierarchical_shard_elems(n, GROUP),)
                         for n in lay["params"]]
    assert lay["tau"] == pytest.approx(1e-2)


def test_cross_mode_trainer_state_raises(ranks):
    assert "incompatible" in ranks[0]["cross_mode"]


def test_mid_epoch_resume_bitwise_with_residuals(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["killed"]
        np.testing.assert_array_equal(res["resumed"], res["unbroken"])
        np.testing.assert_array_equal(*res["ef"])
        assert res["tau"][0] == res["tau"][1]
    # each rank holds its own residual
    assert not np.array_equal(ranks[0]["resume"]["ef"][0],
                              ranks[1]["resume"]["ef"][0])


def test_fit_dataset_k_loop_carries_residual(ranks):
    k = ranks[0]["k_loop"]
    assert np.isfinite(k["score"]) and k["syncs"] == 4
    assert k["ef_max"] > 0


# ----------------------------------------------------------------------
# the bytes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("intra_mode", ["block_int8", None],
                         ids=["block_int8", "dense"])
def test_recorded_sites_meet_the_bill_and_contract(ranks, intra_mode):
    sites = ranks[0][("sites", intra_mode)]
    sizes = ranks[0][("sizes", intra_mode)]
    grad = [s for s in sites if not (s[0] == "all_reduce"
                                     and s[1] == ("data",))]
    assert sum(s[4] for s in grad) == port_wire_bill(
        "hierarchical", sizes, DP, capacity=1.0, group_size=GROUP,
        intra_mode=intra_mode)
    counts = {}
    for s in sites:
        counts[s[0]] = counts.get(s[0], 0) + 1
    rep = compression_contract("hierarchical", 1,
                               intra_quantized=intra_mode is not None
                               ).check(counts)
    assert rep.ok, rep.format()
    axes = {s[1] for s in sites}
    assert ("group",) in axes and ("intra",) in axes


# ----------------------------------------------------------------------
# the trainer's mapping and refusals
# ----------------------------------------------------------------------
def _net():
    return MultiLayerNetwork(R.hier_mlp_conf(), device="cpu").init()


def _mesh():
    return DataGroup(size=8)


@pytest.mark.parametrize("kw,match", [
    (dict(gradient_compression="hierarchical", compressionGroupSize=3),
     "divisor"),
    (dict(gradient_compression="threshold", compressionGroupSize=4),
     "node-group size"),
    (dict(gradient_compression="hierarchical", compressionGroupSize=4,
          weight_update="sharded"), "reduce-scatter form"),
    (dict(gradient_compression="hierarchical", compressionGroupSize=4,
          intraGroupCompression="int8"), "intraGroupCompression"),
    (dict(gradient_compression="hierarchical", compressionGroupSize=4,
          threshold=0.0), "tau"),
], ids=["indivisible", "other_mode", "sharded", "intra_mode", "tau"])
def test_wrapper_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        ParallelWrapper(_net(), mesh=_mesh(), **kw)


def test_stm_maps_group_size():
    m = SharedTrainingMaster(_net(), mesh=_mesh(), compressionGroupSize=4,
                             thresholdAlgorithm=5e-2)
    assert m.gradient_compression == "hierarchical"
    assert m.compression_group == 4 and m.threshold == 5e-2
    with pytest.raises(ValueError, match="node-group size"):
        SharedTrainingMaster(_net(), mesh=_mesh(), compressionGroupSize=4,
                             gradient_compression="int8")
    d = SharedTrainingMaster(_net(), mesh=_mesh(),
                             gradient_compression="hierarchical")
    assert d.compression_group == psh.default_compression_group(8) == 4
    assert d._n_groups == 2


def test_builder_maps_group_size():
    master = (SharedTrainingMasterBuilder().compressionGroupSize(4)
              .thresholdAlgorithm(5e-2).intraGroupCompression(None)
              .build())
    s = SparkDl4jMultiLayer(_mesh(), R.hier_mlp_conf(), master,
                            device="cpu")
    m = s.getTrainingMaster()
    assert m.gradient_compression == "hierarchical"
    assert m.compression_group == 4 and m.intra_compression is None
    bad = SharedTrainingMasterBuilder().compressionGroupSize(5).build()
    with pytest.raises(ValueError, match="divisor"):
        SparkDl4jMultiLayer(_mesh(), R.hier_mlp_conf(), bad, device="cpu")


def test_sharding_plan_group_knob_and_par06_bills_both_hops():
    p = ShardingPlan(gradient_compression="hierarchical",
                     compression_group=4)
    assert p.compression_group == 4
    with pytest.raises(ValueError, match="node-group size"):
        ShardingPlan(gradient_compression="block_int8", compression_group=4)
    with pytest.raises(ValueError, match="sharded"):
        ShardingPlan(gradient_compression="hierarchical",
                     weight_update="sharded")
    r = validate_plan(R.zero_mlp_conf(nin=256, hidden=512, nout=8),
                      {"data": 8}, batchSize=64, plan=p)
    gc = r.plan["memory"]["grad_collective"]
    assert gc["mode"] == "hierarchical"
    assert gc["group_size"] == 4 and gc["groups"] == 2
    assert gc["wire_bytes"] == \
        gc["intra_wire_bytes"] + gc["leader_wire_bytes"]
    assert 0 < gc["leader_wire_bytes"] < gc["intra_wire_bytes"]
