"""The ZeRO weight update (deeplearning4j_tpu_torch/parallel/sharding.py
``ZeroShardedUpdate``; ``ParallelWrapper(weight_update="sharded")``,
``SameDiff.shardWeightUpdate``). Mirrors tests/test_zero_sharding.py.

The reference runs its mesh in one process; the port runs gloo ranks
(rank bodies in tests/_torch_parallel_ranks.py, one launch of two ranks
for every multi-rank case here). Bars:

- trajectory parity at dp 2: sharded against replicated for
  MultiLayerNetwork (dense, int8, block_int8, and through fitDataSet's
  blocks), ComputationGraph and SameDiff, within the reference's band
  (params rtol 2e-6 / atol 1e-7, losses rtol 1e-6); an Sgd power-of-two
  run bitwise, as the reference demands;
- layout: the updater state is allocated in flat 1/dp blocks, every
  other leaf replicated (never padded); files and checkpoints hold the
  canonical full-shape layout; a replicated wrapper uninstalls the hook;
- the bill: ``dp_weight_update_bytes`` equals the reference's; the wire
  bytes a sharded step records for its reduce-scatter and all-gather
  equal the bill's ``collective_wire_bytes``, and the whole step's equal
  ``analysis.collectives.port_wire_bill`` (the port's int8 lanes cost
  4/k bytes, see tests/test_torch_parallel_exchange.py); the step meets
  its declared collective contract; PAR06's weight-update factor and
  PAR03's indivisible-leaf warning;
- resilience: a ResilientFit over the sharded wrapper preempted
  mid-epoch resumes bitwise, updater state included, and its guarded
  blocks (stepsPerSync=2) match the per-batch run; a checkpoint write
  that fails on the writing rank raises on every rank.
"""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.parallel.sharding as jsh
from deeplearning4j_tpu.parallel import (
    ParallelWrapper as JPW, data_parallel_mesh as jmesh,
)
import deeplearning4j_tpu.nn as J

import _torch_parallel_ranks as R
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.analysis import validate_plan
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.analysis.collectives import (
    compression_contract, port_wire_bill,
)
from deeplearning4j_tpu_torch.analysis.partitioning import ShardingPlan
from deeplearning4j_tpu_torch.parallel import (
    DataGroup, ParallelWrapper, SharedTrainingMasterBuilder,
    SparkDl4jMultiLayer, launch,
)
from deeplearning4j_tpu_torch.parallel import sharding as psh
from deeplearning4j_tpu_torch.util.hbm_ledger import weight_update_bill

torch.set_num_threads(1)

DP = 2
BAND = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("zero"))
    return launch(R.zero_rank, DP, device="cpu", timeout=300, args=(tmp,))


def _both_ranks_equal(ranks, key):
    np.testing.assert_array_equal(ranks[0][key]["params"],
                                  ranks[1][key]["params"])


# ----------------------------------------------------------------------
# trajectory parity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("comp", [None, "int8", "block_int8"],
                         ids=["dense", "int8", "block_int8"])
def test_fit_matches_replicated(ranks, comp):
    r = ranks[0]
    rep, sh = r[(comp, "replicated")], r[(comp, "sharded")]
    np.testing.assert_allclose(sh["params"], rep["params"], **BAND)
    np.testing.assert_allclose(sh["scores"], rep["scores"], rtol=1e-6)
    for a, b in zip(sh["upd"], rep["upd"]):
        np.testing.assert_allclose(a, b, **BAND)
    _both_ranks_equal(ranks, (comp, "sharded"))


@pytest.mark.parametrize("comp", ["int8", "block_int8"])
def test_compressed_reduce_scatter_is_the_reference(ranks, comp):
    """A sharded step's compressed reduce-scatter against the
    reference's on the same gradients: each rank's block of each
    eligible leaf's mean."""
    from jax.sharding import PartitionSpec as PS

    from deeplearning4j_tpu.parallel._compat import shard_map

    calls = [r[(comp, "sharded")]["call"] for r in ranks]
    mode, block = calls[0]["args"]
    assert mode == comp and calls[0]["grads"]

    def body(g):
        return jsh.quantized_psum_scatter_mean(g[0].reshape(-1), "data",
                                               DP, mode, block)

    f = jax.jit(shard_map(body, mesh=jmesh(DP), in_specs=PS("data"),
                          out_specs=PS("data"), check_vma=False))
    for j in range(len(calls[0]["grads"])):
        want = np.asarray(f(np.stack([c["grads"][j] for c in calls])))
        got = np.concatenate([c["out"][j] for c in calls])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_channels_last_kernels_are_written_back(ranks):
    """An NHWC CNN's kernels are held channels-last, so its flat blocks
    are copies: the update writes them back (through the all-gather at
    dp 2, by a copy at one rank), bitwise the replicated run."""
    np.testing.assert_array_equal(ranks[0][("nhwc", "sharded")],
                                  ranks[0][("nhwc", "replicated")])
    x = np.random.RandomState(5).rand(8, 16, 16, 3).astype("float32")
    y = np.eye(10, dtype="float32")[np.arange(8) % 10]
    nets = []
    for mode in ("replicated", "sharded"):
        net = R._nhwc_cnn()
        assert any(not t.is_contiguous() for p in net._params
                   for t in p.values())
        pw = ParallelWrapper(net, weight_update=mode, min_shard_size=64)
        for _ in range(2):
            pw.fit(x, y)
        nets.append(net)
    assert torch.equal(nets[0].params().tensor(), nets[1].params().tensor())


def test_fit_dataset_steps_per_sync_composes(ranks):
    r = ranks[0]
    rep, sh = r[("fds", "replicated")], r[("fds", "sharded")]
    assert sh["syncs"] == 2 and sh["it"] == 4
    np.testing.assert_allclose(sh["params"], rep["params"], **BAND)


def test_power_of_two_sgd_bitwise(ranks):
    np.testing.assert_array_equal(ranks[0][("sgd", "sharded")],
                                  ranks[0][("sgd", "replicated")])


def test_graph_fit_dataset_matches_replicated(ranks):
    np.testing.assert_allclose(ranks[0][("graph", "sharded")],
                               ranks[0][("graph", "replicated")], **BAND)


def test_samediff_fit_matches_replicated(ranks):
    sd = ranks[0]["sd"]
    np.testing.assert_allclose(sd["h"][1], sd["h"][0], rtol=1e-6)
    for a, b in sd["vars"]:
        np.testing.assert_allclose(b, a, **BAND)
    # allocated sharded: w (32x64) and w2 (64x4) as flat 1/dp blocks
    assert (32 * 64 // DP,) in sd["shapes"]
    assert (64 * 4 // DP,) in sd["shapes"]
    assert (64,) in sd["shapes"]       # b: below min_shard_size


def test_samediff_updater_state_save_restore_canonical(ranks):
    """The file holds the canonical layout: a replicated graph loads it
    and continues the sharded graph's trajectory."""
    h_r, h_s = ranks[0]["sd_restore"]
    np.testing.assert_allclose(h_r, h_s, rtol=1e-6)


# ----------------------------------------------------------------------
# eligibility and layout
# ----------------------------------------------------------------------
def test_eligibility_rule_is_the_reference():
    z = psh.ZeroShardedUpdate(DataGroup(size=8), min_shard_size=64)
    jz = jsh.ZeroShardedUpdate(jmesh(8), min_shard_size=64)
    assert z.dp == jz.dp == 8
    for shape in ((8, 16), (63,), (9, 9), (5, 64), (64,), (0,)):
        assert z.eligible(torch.zeros(shape)) == \
            jz.eligible(np.zeros(shape)), shape
    with pytest.raises(ValueError, match="no axis 'model'"):
        psh.ZeroShardedUpdate(DataGroup(size=2), axis="model")


def test_state_allocated_sharded_from_init(ranks):
    """Adam's two moments: W (32x64) and W2 (64x4) in 1/dp blocks, the
    biases (64, 4) below min_shard_size whole."""
    sh = ranks[0][(None, "sharded")]
    want = 2 * 4 * (32 * 64 // DP + 64 + 64 * 4 // DP + 4)
    assert sh["state_bytes"] == want
    assert set(sh["shapes"]) == {(32 * 64 // DP,), (64,),
                                 (64 * 4 // DP,), (4,)}
    assert ranks[0][(None, "replicated")]["state_bytes"] == \
        2 * 4 * sum(sh["sizes"])


def test_indivisible_leaf_replicates_never_pads():
    """A 567-element leaf (9x63) at dp 8 stays whole: its state is the
    full leaf, the hook's view passes it through."""
    z = psh.ZeroShardedUpdate(DataGroup(size=8), min_shard_size=64)
    p = {"W": torch.zeros(9, 63), "b": torch.zeros(63), "V": torch.ones(8, 16)}
    view = z.view(p)
    assert view["W"] is p["W"] and view["b"] is p["b"]
    st = z.init_state(P.Adam(1e-2), p)
    assert tuple(st["m"]["W"].shape) == (9, 63)
    # one process (no group): its block is the whole flat leaf
    assert tuple(st["m"]["V"].shape) == (128,)
    full = z.unview_state(st, P.Adam(1e-2), p)
    assert tuple(full["m"]["V"].shape) == (8, 16)


def test_rewrapping_replicated_uninstalls_the_hook(ranks):
    f = ranks[0]["files"]
    assert f["uninstalled"]
    assert all(len(s) == 2 or s in ((64,), (4,)) for s in f["shapes"])
    assert (32, 64) in f["shapes"]


def test_files_and_checkpoints_hold_the_canonical_layout(ranks):
    f = ranks[0]["files"]
    for a, b, c in zip(f["canon"], f["npz"], f["ckpt"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(f["canon"]) == len(f["npz"]) == 8


def _jnet(**kw):
    b = J.NeuralNetConfiguration.Builder().seed(42).updater(J.Adam(1e-2))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return J.MultiLayerNetwork(
        b.activation("relu").list().layer(J.DenseLayer(nOut=64))
        .layer(J.OutputLayer(nOut=4, activation="softmax"))
        .setInputType(J.InputType.feedForward(32)).build()).init()


def _pnet(**kw):
    b = P.NeuralNetConfiguration.Builder().seed(42).updater(P.Adam(1e-2))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return P.MultiLayerNetwork(
        b.activation("relu").list().layer(P.DenseLayer(nOut=64))
        .layer(P.OutputLayer(nOut=4, activation="softmax"))
        .setInputType(P.InputType.feedForward(32)).build(),
        device="cpu").init()


@pytest.mark.parametrize("net_kw,kw", [
    ({}, dict(gradient_compression="threshold")),
    ({}, dict(gradient_compression="hierarchical",
              compressionGroupSize=4)),
    ({"gradientNormalization":
      P.GradientNormalization.ClipL2PerLayer},
     dict(gradient_compression="int8")),
], ids=["threshold", "hierarchical", "int8_gradient_normalization"])
def test_trainer_rejections(net_kw, kw):
    """The reference's refusals of the sharded update, word for word (a
    one-process group of 8 stands for the reference's mesh)."""
    jkw = {k: getattr(J.GradientNormalization, "ClipL2PerLayer")
           for k in net_kw}
    with pytest.raises(ValueError) as want:
        JPW(_jnet(**jkw), mesh=jmesh(8), weight_update="sharded", **kw)
    with pytest.raises(ValueError) as got:
        ParallelWrapper(_pnet(**net_kw), mesh=DataGroup(size=8),
                        weight_update="sharded", **kw)
    assert str(got.value) == str(want.value)


def test_dense_sharded_under_gradient_normalization_reduces_first():
    """The dense mode keeps the reference's semantics under gradient
    normalization (which needs the whole reduced gradient): the hook
    takes its blocks of the mean; at one rank bitwise replicated."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32).astype("float32")
    y = np.eye(4, dtype="float32")[rng.randint(0, 4, 16)]
    gn = {"gradientNormalization": P.GradientNormalization.ClipL2PerLayer}
    a, b = _pnet(**gn), _pnet(**gn)
    pa = ParallelWrapper(a)
    pb = ParallelWrapper(b, weight_update="sharded", min_shard_size=64)
    assert pb._zero.pre_reduced
    for _ in range(3):
        pa.fit(x, y)
        pb.fit(x, y)
    assert torch.equal(a.params().tensor(), b.params().tensor())


def test_spark_builder_maps_weight_update():
    master = SharedTrainingMasterBuilder().weightUpdate("sharded") \
        .gradientCompression(None).build()
    s = SparkDl4jMultiLayer(None, R.zero_mlp_conf(), master, device="cpu")
    m = s.getTrainingMaster()
    assert m.weight_update == "sharded" and m._zero is not None
    x, y = R.zero_data()
    s.fit(DataSet(x, y))
    assert s.getNetwork()._update_impl is m._zero


# ----------------------------------------------------------------------
# the analytic bill and the recorded bytes
# ----------------------------------------------------------------------
#: LeNet's and a ResNet block's f32 gradient bytes (the reference's)
BILLS = [(1724320, 8), (42408, 4), (1724320, 2), (42408, 1)]


@pytest.mark.parametrize("G,dp", BILLS)
@pytest.mark.parametrize("comp", [None, "int8", "block_int8"])
def test_dp_weight_update_bytes_is_the_reference(G, dp, comp):
    for sharded in (False, True):
        want = jsh.dp_weight_update_bytes(G, dp, sharded=sharded,
                                          compression=comp)
        got = psh.dp_weight_update_bytes(G, dp, sharded=sharded,
                                         compression=comp)
        assert got == want
    for mode in ("threshold", "hierarchical"):
        with pytest.raises(ValueError, match="reduce-scatter form"):
            psh.dp_weight_update_bytes(G, 8, sharded=True,
                                       compression=mode)


def test_lenet_bill_hand_computed():
    """The reference's hand-computed LeNet figures, through the port's
    own LeNet (``weight_update_bill``: G and S from the net)."""
    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet(numClasses=10, device="cpu").init()
    G = 1724320
    rec = weight_update_bill(net, 8, sharded=True)
    assert rec["reduce_scatter_bytes"] == 7 * G // 8 == 1508780
    assert rec["all_gather_bytes"] == 1508780
    # the zoo's LeNet trains with Adam: two state leaves a param
    assert rec["update_bytes"] == (2 * G + 4 * G + G) // 8
    assert rec["opt_state_resident_bytes"] == 2 * G // 8
    assert rec == jsh.dp_weight_update_bytes(G, 8, master_bytes=G,
                                             opt_state_bytes=2 * G,
                                             sharded=True)
    # the reference's hand figures (one state leaf a param)
    one = psh.dp_weight_update_bytes(G, 8, sharded=True)
    assert one["update_bytes"] == 5 * G // 8 == 1077700
    assert one["opt_state_resident_bytes"] == G // 8 == 215540
    assert weight_update_bill(net)["mode"] == "replicated"


def _grad_sites(sites):
    """The gradient exchange's sites: all but the loss mean (the last
    1-element all-reduce)."""
    return [s for s in sites if not (s[0] == "all_reduce" and s[3] == 4)]


@pytest.mark.parametrize("comp", [None, "int8", "block_int8"],
                         ids=["dense", "int8", "block_int8"])
def test_recorded_bytes_meet_the_bill(ranks, comp):
    sh = ranks[0][(comp, "sharded")]
    sizes = sh["sizes"]
    elig = [n for n in sizes if n >= 256 and n % DP == 0]
    grad = _grad_sites(sh["sites"])
    assert sum(s[4] for s in grad) == port_wire_bill(
        comp, sizes, DP, sharded=True, min_shard_size=256)
    if comp is None:
        zero = [s for s in sh["sites"]
                if s[0] in ("reduce_scatter", "all_gather")]
        bill = psh.dp_weight_update_bytes(4 * sum(elig), DP, sharded=True)
        assert sum(s[4] for s in zero) == bill["collective_wire_bytes"]
        assert sh["bill"]["mode"] == "sharded"
    counts = {}
    for s in sh["sites"]:
        counts[s[0]] = counts.get(s[0], 0) + 1
    rep = compression_contract(comp, sharded=True).check(counts)
    assert rep.ok, rep.format()


def test_par06_factor_and_tp_heavy_honesty():
    conf = R.zero_mlp_conf(nin=256, hidden=512, nout=8)
    plan = ShardingPlan(weight_update="sharded",
                        weight_update_min_shard=1024)
    m_s = validate_plan(conf, {"data": 8}, batchSize=64,
                        plan=plan).plan["memory"]
    m_r = validate_plan(conf, {"data": 8}, batchSize=64).plan["memory"]
    assert 1 < m_s["weight_update_sharding"] <= 8
    assert m_s["optimizer_state_bytes"] < m_r["optimizer_state_bytes"]
    tp = validate_plan(conf, {"data": 2, "model": 8}, batchSize=64,
                       plan=ShardingPlan(weight_update="sharded",
                                         weight_update_min_shard=1024))
    tp_base = validate_plan(conf, {"data": 2, "model": 8}, batchSize=64)
    assert tp.plan["memory"]["weight_update_sharding"] < 1
    assert tp.plan["memory"]["optimizer_state_bytes"] > \
        tp_base.plan["memory"]["optimizer_state_bytes"]


def test_par03_warns_indivisible_only():
    conf = R.zero_mlp_conf(nin=9, hidden=63)   # W1 567, W2 252: % 8 != 0
    r = validate_plan(conf, {"data": 8}, batchSize=64,
                      plan=ShardingPlan(weight_update="sharded",
                                        weight_update_min_shard=64))
    wu = [d for d in r.diagnostics
          if d.code == "PAR03" and "weight-update" in d.where]
    assert len(wu) == 2 and any("567" in d.message for d in wu)
    clean = validate_plan(R.zero_mlp_conf(), {"data": 8}, batchSize=64,
                          plan=ShardingPlan(weight_update="sharded",
                                            weight_update_min_shard=256))
    assert not [d for d in clean.diagnostics
                if d.code == "PAR03" and "weight-update" in d.where]


# ----------------------------------------------------------------------
# resilience
# ----------------------------------------------------------------------
def test_mid_epoch_resume_bitwise(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["killed"]
        np.testing.assert_array_equal(res["resumed"], res["unbroken"])
        for a, b in zip(*res["upd"]):
            np.testing.assert_array_equal(a, b)


def test_failed_write_raises_on_every_rank(ranks):
    """The writing rank's write fails past the retry policy: it raises
    its error and the other rank raises naming it, both at that save
    (no rank is left waiting for the other)."""
    lead, other = (r["write_fault"] for r in ranks)
    # the third try (ordinal 2) is the last the policy allows
    assert lead["err"] == "chaos[checkpoint.write#2]: injected fault"
    assert lead["fired"] == 3
    assert "failed on the writing rank" in other["err"]
    assert other["fired"] == 0
    assert lead["iteration"] == other["iteration"] == 2


def test_guarded_k_loop_matches_k1(ranks):
    res = ranks[0]["resume"]
    np.testing.assert_array_equal(res["k2"], res["k1"])


def test_ranks_hold_blocks_of_one_state(ranks):
    """The ranks hold different blocks of one state: their canonical
    unviews agree bitwise."""
    for a, b in zip(ranks[0][(None, "sharded")]["upd"],
                    ranks[1][(None, "sharded")]["upd"]):
        np.testing.assert_array_equal(a, b)
