"""Port parity for the data-parallel trainers (deeplearning4j_tpu_torch/
parallel/) against the reference's (deeplearning4j_tpu/parallel/).

The reference's own tests (tests/test_parallel.py: TestDataParallel,
TestParameterAveraging, TestThresholdGradientSharing,
TestComputationGraphDataParallel, TestSparkFacade, TestMultiHostTwoProcess)
run its trainers on ``data_parallel_mesh(n)`` of the virtual 8-device
CPU mesh. Here the reference runs at dp 2 and 4 in this process, and the
port at the same dp as gloo ranks on the CPU (``parallel.launch``; rank
bodies in tests/_torch_parallel_ranks.py, which imports no jax), from the
reference's initial weights, on the same global batches.

Bars:
- dense (the MLP, the graph, parameter averaging at frequency 1 with
  Sgd): params within the reference's rtol 1e-5 / atol 1e-6 of the
  reference's dp training and of the port's single-device training on
  the combined batch; the params bitwise equal on every rank.
- the BN CNN (parallel.dryrun.bn_cnn) in f64 on both sides: dense within
  1e-10 of the port's single-device training and of the reference's dp
  training (params and BN running statistics); int8 with per-rank BN
  within 1e-9 of the reference's int8 (a flipped lane would move a param
  by ~1e-3), its running statistics (f32 state) within 2 f32 ulps (their
  mean over the ranks sums in another order).
- int8/block_int8 on the MLP: within the reference's 5e-2 of dense and
  not equal to it; within 1e-2 of the reference's int8 trajectory (the
  two frameworks' gradients differ in the last f32 bits, which can move
  a lane across a rounding boundary).
- threshold: a first step bitwise-equal in its transmitted ±tau (params
  within 1e-6 of the reference's); with tau 1e9 nothing moves and rank
  r's residual is within rtol 1e-5 of the reference's residual row r.
  Lanes and messages bitwise on equal inputs are held in
  tests/test_torch_parallel_exchange.py.
- the reference's convergence and property tests, port side, as it
  states them (accuracy 0.9, score halves, tau adapts 5x).
- refusals: the reference's ValueError messages, word for word.

Every spawning test finishes inside LAUNCH_TIMEOUT (``launch`` kills the
ranks and raises at its timeout; the two-process test kills its children).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn import (
    Adam as JAdam, BatchNormalization as JBN, ComputationGraph as JCG,
    ConvolutionLayer as JConv, DenseLayer as JDense,
    ElementWiseVertex as JEW, GlobalPoolingLayer as JGP,
    InputType as JIT, MultiLayerNetwork as JMLN,
    NeuralNetConfiguration as JConf, OutputLayer as JOut, Sgd as JSgd,
)
from deeplearning4j_tpu.ndarray import DataType as JDataType
from deeplearning4j_tpu.parallel import (
    ParallelWrapper as JPW, ParameterAveragingTrainingMaster as JPA,
    SharedTrainingMaster as JSTM, data_parallel_mesh as jmesh,
)

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DataGroup, ParallelWrapper, ParameterAveragingTrainingMaster,
    ResidualClippingPostProcessor, SharedTrainingMaster,
    SharedTrainingMasterBuilder, SparkDl4jMultiLayer, build_mesh,
    hybrid_mesh, launch,
)
from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves
from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0
DENSE = dict(rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the reference's nets (tests/test_parallel.py), built with its API
# ----------------------------------------------------------------------

def jmlp(seed=42):
    return JMLN(JConf.Builder().seed(seed).updater(JAdam(1e-2))
                .activation("relu").list()
                .layer(JDense(nOut=32))
                .layer(JOut(nOut=3, activation="softmax"))
                .setInputType(JIT.feedForward(4)).build()).init()


def jsgd_mlp(seed=42):
    return JMLN(JConf.Builder().seed(seed).updater(JSgd(0.1))
                .activation("relu").list()
                .layer(JDense(nOut=32))
                .layer(JOut(nOut=3, activation="softmax"))
                .setInputType(JIT.feedForward(4)).build()).init()


def jthr(seed=5):
    return JMLN(JConf.Builder().seed(seed).updater(JSgd(0.5))
                .activation("tanh").list()
                .layer(JDense(nOut=16))
                .layer(JOut(nOut=3, activation="softmax"))
                .setInputType(JIT.feedForward(8)).build()).init()


def jgraph(seed=11):
    return JCG(JConf.Builder().seed(seed).updater(JSgd(0.1))
               .activation("tanh").graphBuilder().addInputs("in")
               .addLayer("h", JDense(nOut=16), "in")
               .addLayer("out", JOut(nOut=3, activation="softmax"), "h")
               .setOutputs("out")
               .setInputTypes(JIT.feedForward(4)).build()).init()


def jbn_cnn64(seed=3, lr=0.05):
    """parallel.dryrun.bn_cnn in the reference's API, f64."""
    def conv():
        return JConv(nOut=4, kernelSize=(3, 3), convolutionMode="same",
                     activation="identity", hasBias=False)

    g = (JConf.Builder().seed(seed).updater(JSgd(lr))
         .dataType(JDataType.DOUBLE).graphBuilder().addInputs("in"))
    g.addLayer("c1", conv(), "in")
    g.addLayer("b1", JBN(activation="relu"), "c1")
    g.addLayer("c2", conv(), "b1")
    g.addLayer("b2", JBN(activation="softplus"), "c2")
    g.addVertex("add", JEW("add"), "b2", "b1")
    g.addLayer("gap", JGP(poolingType="avg"), "add")
    g.addLayer("out", JOut(nOut=3, activation="softmax",
                           lossFunction="mcxent"), "gap")
    return JCG(g.setOutputs("out")
               .setInputTypes(JIT.convolutional(8, 8, 3)).build()).init()


JNETS = {"mlp": jmlp, "sgd_mlp": jsgd_mlp, "thr": jthr, "graph": jgraph,
         "bn_cnn64": jbn_cnn64}


def tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def init_weights(*names):
    """{name: (params, states)} of each reference net's own init."""
    out = {}
    for name in names:
        j = JNETS[name]()
        out[name] = (tree_np(j._params), tree_np(j._states))
    return out


def jflat(tree):
    """A reference net's params (or states) as {"layer.name": f64}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {f"{k}.{n}": np.asarray(v, np.float64)
            for k, p in items for n, v in p.items()}


def assert_params(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def max_abs(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def ref_fit(net, master, x, y, n):
    for _ in range(n):
        master.fit(x, y)
    return jflat(net._params)


def port_single(name, init, x, y, n):
    net = R.build(name, init)
    for _ in range(n):
        net.fit(x, y)
    return R.ref_params(net)


# ----------------------------------------------------------------------
# the rank runs: one launch per dp for each group of scenarios
# ----------------------------------------------------------------------

PARITY_NETS = ("mlp", "sgd_mlp", "thr", "graph")


@pytest.fixture(scope="module")
def init():
    return init_weights(*PARITY_NETS, "bn_cnn64")


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def parity(request, init):
    dp = request.param
    res = launch(R.parity_rank, dp, device="cpu", timeout=LAUNCH_TIMEOUT,
                 args=({k: init[k] for k in PARITY_NETS},))
    return dp, res


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def props(request):
    return request.param, launch(R.property_rank, request.param,
                                 device="cpu", timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def bn_runs(request, init):
    dp = request.param
    return dp, launch(R.bn_cnn_rank, dp, device="cpu",
                      timeout=LAUNCH_TIMEOUT,
                      args=({"bn_cnn64": init["bn_cnn64"]},))


# ----------------------------------------------------------------------
# TestDataParallel
# ----------------------------------------------------------------------

def test_dp_matches_single_device(parity, init):
    """Dense sharing == the reference's dp training == single-device
    training on the combined batch (the reference's property)."""
    dp, res = parity
    x, y, _ = R.data(64)
    j = jmlp()
    want = ref_fit(j, JPW(j, mesh=jmesh(dp)), x, y, 5)
    assert_params(res[0]["dense"]["params"], want, **DENSE)
    assert_params(res[0]["dense"]["params"],
                  port_single("mlp", init, x, y, 5), **DENSE)
    np.testing.assert_allclose(res[0]["dense"]["scores"][-1], j.score(),
                               rtol=1e-5)


def test_params_replicated_after_dp(parity):
    dp, res = parity
    for r in res[1:]:
        for k, v in res[0]["dense"]["params"].items():
            np.testing.assert_array_equal(r["dense"]["params"][k], v)
    # 1 gradient all-reduce + 1 loss all-reduce a step, no BN
    assert res[0]["dense"]["comm"]["collectives"] == 2


@pytest.mark.parametrize("mode", ["int8", "block_int8"])
def test_quantized_allreduce_close_to_exact(parity, init, mode):
    """SharedTrainingMaster defaults to int8; both quantized modes stay
    within the reference's 5e-2 of dense, differ from it, and follow the
    reference's own quantized trajectory."""
    dp, res = parity
    x, y, _ = R.data(64)
    got = res[0][mode]
    assert got["mode"] == mode
    dense = port_single("mlp", init, x, y, 3)
    assert max_abs(got["params"], dense) < 5e-2
    assert max_abs(got["params"], dense) > 0
    j = jmlp()
    jm = JSTM(j, mesh=jmesh(dp)) if mode == "int8" \
        else JSTM(j, mesh=jmesh(dp), gradient_compression=mode)
    assert max_abs(got["params"], ref_fit(j, jm, x, y, 3)) < 1e-2


def test_shared_master_dense_opt_out(parity, init):
    """gradient_compression=None through SharedTrainingMaster is the
    dense exchange."""
    dp, _ = parity
    x, y, _ = R.data(64)
    net = R.build("mlp", init)
    pw = SharedTrainingMaster(net, gradient_compression=None)
    assert pw.gradient_compression is None
    for _ in range(3):
        pw.fit(x, y)
    assert_params(R.ref_params(net), port_single("mlp", init, x, y, 3),
                  rtol=0, atol=0)


# ----------------------------------------------------------------------
# TestParameterAveraging
# ----------------------------------------------------------------------

def test_freq1_sgd_matches_sync(parity, init):
    dp, res = parity
    x, y, _ = R.data(64)
    got = res[0]["pa_freq1"]["params"]
    assert_params(got, port_single("sgd_mlp", init, x, y, 4), **DENSE)
    j = jsgd_mlp()
    want = ref_fit(j, JPA(j, mesh=jmesh(dp), averagingFrequency=1),
                   x, y, 4)
    assert_params(got, want, **DENSE)


def test_replicas_diverge_then_average(parity):
    """Between averaging points the ranks' replicas drift apart; right
    after one they are bitwise equal, and so is the net's model."""
    dp, res = parity
    after3 = np.stack([r["pa_replicas"]["after3"] for r in res])
    after5 = np.stack([r["pa_replicas"]["after5"] for r in res])
    assert np.abs(after3 - after3.mean(0)).max() > 0
    for a in after5[1:]:
        np.testing.assert_array_equal(a, after5[0])
    nets = [np.concatenate([v.ravel() for v in r["pa_replicas"]["net"]
                            .values()]) for r in res]
    for n in nets[1:]:
        np.testing.assert_array_equal(n, nets[0])


def test_bad_frequency_raises():
    net = R.build("mlp")
    with pytest.raises(ValueError, match="averagingFrequency"):
        ParameterAveragingTrainingMaster(net, averagingFrequency=0)


# ----------------------------------------------------------------------
# TestComputationGraphDataParallel
# ----------------------------------------------------------------------

def test_graph_dense_matches_single_device(parity, init):
    dp, res = parity
    x, y, _ = R.data(64)
    got = res[0]["graph_dense"]["params"]
    assert_params(got, port_single("graph", init, x, y, 4), **DENSE)
    j = jgraph()
    assert_params(got, ref_fit(j, JPW(j, mesh=jmesh(dp)), x, y, 4),
                  **DENSE)


def test_threshold_mode_trains_graph(parity):
    s = parity[1][0]["graph_threshold"]["scores"]
    assert np.all(np.isfinite(s)) and s[-1] < s[0]


def test_multi_io_graph_rejected_clearly():
    net = ComputationGraph(R.multi_io_conf(), device="cpu").init()
    x, y, _ = R.data(64)
    with pytest.raises(ValueError, match="single-input"):
        ParallelWrapper(net).fit(x[:, :2], y)


# ----------------------------------------------------------------------
# TestThresholdGradientSharing
# ----------------------------------------------------------------------

def test_huge_threshold_transmits_nothing(parity, init):
    """Nothing crosses tau 1e9, so nothing moves; the gradient waits in
    each rank's residual, which is the reference's residual row."""
    dp, res = parity
    start = jflat(init["thr"][0])
    xt, yt = R.thr_data()
    j = jthr()
    jpw = JPW(j, mesh=jmesh(dp), gradient_compression="threshold",
              threshold=1e9)
    jpw.fit(xt, yt)
    ref_ef = tree_np(jpw._residual[0])
    for rank, r in enumerate(res):
        got = r["thr_huge"]
        assert_params(got["params"], start, rtol=0, atol=0)
        assert got["tau"] == np.float32(1e9)
        assert max(np.abs(v).max() for p in got["residual"]
                   for v in p.values()) > 0
        for layer, want in zip(got["residual"], ref_ef):
            for k, v in layer.items():
                np.testing.assert_allclose(v, want[k][rank], rtol=1e-5,
                                           atol=1e-7)


def test_threshold_first_step_matches_reference(parity):
    """tau 1e-2 at capacity 1.0: the same entries cross tau on both
    sides, so one step moves the params by the same ±tau multiples."""
    dp, res = parity
    xt, yt = R.thr_data()
    j = jthr()
    want = ref_fit(j, JPW(j, mesh=jmesh(dp),
                          gradient_compression="threshold", threshold=1e-2,
                          encodingCapacity=1.0), xt, yt, 1)
    assert_params(res[0]["thr_step1"]["params"], want, rtol=0, atol=1e-6)


def test_error_feedback_flushes_small_gradients(props):
    s = props[1][0]["thr_feedback"]
    assert np.isfinite(s[-1]) and s[-1] < 0.5 * s[0], (s[0], s[-1])


def test_threshold_converges_comparable_to_dense(props):
    s = props[1][0]["thr_converges"]
    assert s[-1] < 0.25, s[-1]


def test_capacity_limited_encoder_still_converges(props):
    r = props[1][0]["thr_capacity"]
    assert r["capacity"] == 0.125
    assert r["scores"][-1] < 0.5 * r["scores"][0]


def test_adaptive_threshold_tracks_target_sparsity(props):
    (t_down, s_down), (t_up, s_up) = props[1][0]["thr_adaptive"]
    assert t_down < 100.0 / 5, t_down
    assert t_up > 1e-8 * 5, t_up
    assert np.isfinite(s_down) and np.isfinite(s_up)


def test_residual_clipping_bounds_the_residual(props):
    """residualClip=1.0: every residual within 1.0 * tau after the step."""
    assert props[1][0]["thr_clip"] <= np.float32(1e-2)


def test_shared_master_threshold_algorithm_arg():
    m = SharedTrainingMaster(R.build("thr"), thresholdAlgorithm=1e-2)
    assert m.gradient_compression == "threshold"
    assert m.threshold == 1e-2
    assert SharedTrainingMaster(R.build("thr")).gradient_compression \
        == "int8"
    with pytest.raises(ValueError, match="thresholdAlgorithm"):
        SharedTrainingMaster(R.build("thr"), thresholdAlgorithm=1e-2,
                             gradient_compression="int8")
    m2 = SharedTrainingMaster(R.build("thr"), thresholdAlgorithm=1e-3,
                              gradient_compression="threshold")
    assert m2.threshold == 1e-3
    m3 = SharedTrainingMaster(
        R.build("thr"),
        residualPostProcessor=ResidualClippingPostProcessor(2.0, 3))
    assert (m3.gradient_compression, m3.residual_clip,
            m3.residual_clip_frequency) == ("threshold", 2.0, 3)


# ----------------------------------------------------------------------
# the BN CNN: sync BN in dense mode, per-rank BN in int8 (f64)
# ----------------------------------------------------------------------

def test_bn_cnn_dense_matches_single_device_f64(bn_runs, init):
    """Synchronised BN: dp training == single-device training on the
    combined batch, params and running statistics, and == the
    reference's dp training (GSPMD's global-batch BN)."""
    dp, res = bn_runs
    x, y = R.bn_cnn_batch(8 * dp)
    single = R.build("bn_cnn64", init)
    for _ in range(3):
        single.fit(x, y)
    got = res[0]["dense"]
    assert_params(got["params"], R.ref_params(single), rtol=0, atol=1e-10)
    for k, v in got["states"].items():
        layer, name = k.split(".")
        np.testing.assert_allclose(v, single._states[layer][name].numpy(),
                                   rtol=0, atol=1e-10, err_msg=k)
    j = jbn_cnn64()
    want = ref_fit(j, JPW(j, mesh=jmesh(dp)), x, y, 3)
    assert_params(got["params"], want, rtol=0, atol=1e-10)
    for k, v in jflat(tree_np(j._states)).items():
        np.testing.assert_allclose(got["states"][k], v, rtol=0, atol=1e-10)
    # 1 gradient + 1 loss all-reduce, 3 for each of the 2 BN layers
    assert got["comm"]["collectives"] == 8
    for r in res[1:]:
        for k, v in got["params"].items():
            np.testing.assert_array_equal(r["dense"]["params"][k], v)


def test_bn_cnn_int8_uses_per_rank_bn_like_the_reference(bn_runs):
    """Compressed modes keep the reference's shard_map semantics: BN
    statistics per rank, the running statistics averaged after the
    step."""
    dp, res = bn_runs
    x, y = R.bn_cnn_batch(8 * dp)
    got = res[0]["int8"]
    j = jbn_cnn64()
    want = ref_fit(j, JSTM(j, mesh=jmesh(dp)), x, y, 1)
    assert_params(got["params"], want, rtol=0, atol=1e-9)
    # the running statistics are f32 state (BatchNormalization keeps
    # them so); their mean over 4 ranks sums in another order than XLA's
    for k, v in jflat(tree_np(j._states)).items():
        np.testing.assert_allclose(got["states"][k], v, rtol=2.4e-7,
                                   atol=0)
    np.testing.assert_allclose(got["scores"][0], j.score(), rtol=1e-10)
    # scales, lanes, loss, layer state
    assert got["comm"]["collectives"] == 4


# ----------------------------------------------------------------------
# the reference's convergence tests and the Spark facades, port side
# ----------------------------------------------------------------------

def test_dp_iterator_training_converges(props):
    assert props[1][0]["dp_iterator_acc"] > 0.9


def test_averaging_converges(props):
    assert props[1][0]["pa_converges_acc"] > 0.9


def test_padded_last_batch_matches_single_device(props):
    """DataSetIterator pads the last batch (40 rows at 32) under a zero
    label mask; dense dp weights each rank by its unmasked share, so it
    still equals single-device training."""
    x40, y40, _ = R.data(40, seed=4)
    net = R.build("mlp")
    net.fit(DataSetIterator(x40, y40, 32), epochs=2)
    assert_params(props[1][0]["masked_last_batch"], R.ref_params(net),
                  **DENSE)


def test_spark_fit_with_parameter_averaging_builder(props):
    assert props[1][0]["spark_pa_acc"] > 0.9
    assert props[1][0]["spark_pa_master"] == \
        "ParameterAveragingTrainingMaster"


def test_spark_fit_with_shared_master(props):
    assert props[1][0]["spark_shared_acc"] > 0.9


def test_spark_rdd_analog_list_of_datasets(props):
    assert props[1][0]["spark_rdd_acc"] > 0.85


def test_spark_computation_graph_facade(props):
    assert props[1][0]["spark_graph_acc"] > 0.85


def test_spark_rdd_list_honors_epochs():
    class CountingMaster(ParallelWrapper):
        fits = 0

        def fit(self, data, labels=None, epochs=None):
            CountingMaster.fits += 1
            return super().fit(data, labels, epochs)

    x, y, _ = R.data(32)
    net = R.build("mlp")
    spark = SparkDl4jMultiLayer(None, net, CountingMaster(net))
    spark.fit([DataSet(x, y)], epochs=3)
    assert CountingMaster.fits == 3


def test_spark_accepts_prebuilt_net_and_bound_master():
    net = R.build("mlp")
    pw = ParallelWrapper(net)
    spark = SparkDl4jMultiLayer(None, net, pw)
    assert spark.getNetwork() is net
    assert spark.getTrainingMaster() is pw
    with pytest.raises(ValueError, match="different network"):
        SparkDl4jMultiLayer(None, R.build("mlp"), pw)


def test_spark_rejects_bad_master():
    with pytest.raises(ValueError, match="trainingMaster"):
        SparkDl4jMultiLayer(None, R.mlp_conf(), trainingMaster="averaging",
                            device="cpu")


def test_spark_evaluate_waits_for_item_10():
    """Ported with item 10: the facade's evaluate* score its network,
    exactly as the network's own calls do."""
    spark = SparkDl4jMultiLayer(None, R.build("mlp"))
    net = spark.getNetwork()
    x, y, _ = R.data(20)
    for name in ("evaluate", "evaluateRegression"):
        got = getattr(spark, name)(DataSetIterator(x, y, 8))
        want = getattr(net, name)(DataSetIterator(x, y, 8))
        assert type(got) is type(want)
        assert got.stats() == want.stats(), name


# ----------------------------------------------------------------------
# in process: world 1, the refusals, the deferred modes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "graph", "bn_cnn"])
def test_world1_dense_is_bitwise_fit(name):
    """No process group: every collective is the identity, BN local,
    so dense data-parallel training IS fit, bit for bit."""
    if name == "bn_cnn":
        x, y = R.bn_cnn_batch(16)
    else:
        x, y, _ = R.data(64)
    a, b = R.build(name), R.build(name)
    pw = ParallelWrapper(b)
    for _ in range(3):
        a.fit(x, y)
        pw.fit(x, y)
        assert a.score() == b.score()
    assert_params(R.ref_params(b), R.ref_params(a), rtol=0, atol=0)
    assert pw.last_step == {"collectives": 0, "payload_bytes": 0,
                            "wire_bytes": 0}


def test_dp_batch_not_divisible_raises():
    """30 rows over 8 ranks: the reference's error, before any step."""
    net = R.build("mlp")
    x, y, _ = R.data(30)
    pw = ParallelWrapper(net, mesh=DataGroup(rank=0, size=8))
    with pytest.raises(ValueError, match="divisible") as e:
        pw.fit(x, y)
    assert "refusing to silently pad" in str(e.value)
    assert net.getIterationCount() == 0


REFUSALS = [
    ("PW", dict(gradient_compression="sparse")),
    ("PW", dict(gradient_compression="threshold", threshold=0.0)),
    ("PW", dict(encodingCapacity=1.5)),
    ("PW", dict(targetSparsity=0.5, encodingCapacity=0.2)),
    ("PW", dict(residualClip=-1.0)),
    ("PW", dict(residualClipFrequency=0)),
    ("PW", dict(compressionBlock=0)),
    ("PW", dict(intraGroupCompression="int8")),
    ("PW", dict(gradient_compression="int8", compressionGroupSize=4)),
    ("PW", dict(weight_update="zero")),
    ("PW", dict(gradient_compression="threshold", weight_update="sharded")),
    ("STM", dict(thresholdAlgorithm=1e-2, gradient_compression="int8")),
    ("STM", dict(thresholdAlgorithm="fancy")),
    ("STM", dict(residualPostProcessor=object())),
    ("STM", dict(residualPostProcessor=ResidualClippingPostProcessor(),
                 gradient_compression="int8")),
    ("STM", dict(compressionGroupSize=2, gradient_compression="int8")),
    ("PA", dict(averagingFrequency=0)),
    ("PA", dict(weight_update="sharded")),
    ("PA_graph", dict()),
]


@pytest.mark.parametrize("cls,kw", REFUSALS,
                         ids=[f"{c}-{'-'.join(k)}" for c, k in REFUSALS])
def test_refusals_match_the_reference(cls, kw):
    """The ValueErrors of ParallelWrapper.__init__ and the two masters
    that the ported modes reach, with the reference's messages."""
    kinds = {"PW": (JPW, ParallelWrapper), "STM": (JSTM, SharedTrainingMaster),
             "PA": (JPA, ParameterAveragingTrainingMaster),
             "PA_graph": (JPA, ParameterAveragingTrainingMaster)}
    jcls, pcls = kinds[cls]
    jnet, pnet = (jgraph(), R.build("graph")) if cls == "PA_graph" \
        else (jmlp(), R.build("mlp"))
    with pytest.raises(ValueError) as want:
        jcls(jnet, mesh=jmesh(2), **kw)
    with pytest.raises(ValueError) as got:
        pcls(pnet, **kw)
    assert str(got.value) == str(want.value)


def _two_model_ranks_on_one_process():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        build_mesh({"data": 1, "model": 2})


def _hybrid_one_node():
    assert hybrid_mesh({"data": 1}, {"model": 1}).shape == {"data": 1,
                                                            "model": 1}


def _dryrun(legs):
    def run():
        res = dryrun_multichip(2, "cpu", legs=legs, timeout=LAUNCH_TIMEOUT)
        assert all(np.isfinite(res[leg]["loss"]) and res[leg]["replicated"]
                   for leg in legs), res
    return run


@pytest.mark.parametrize("call", [
    _two_model_ranks_on_one_process, _hybrid_one_node, _dryrun(("tp",)),
    _dryrun(("sequence", "pipeline")),
], ids=["model_axis", "hybrid_mesh", "dryrun_tp", "dryrun_sp_pp"])
def test_deferred_modes_name_item_7(call):
    """The modes item 7 deferred run now: a model axis is refused only
    for the ranks it lacks (the reference's message), one node's hybrid
    mesh is build_mesh's, and the tp, sequence and pipeline dry-run legs
    pass on two gloo ranks. What item 7 still holds:
    tests/test_torch_public_surface.py."""
    call()


@pytest.mark.parametrize("kind,kw", [
    ("PW", dict(gradient_compression="hierarchical")),
    ("STM", dict(compressionGroupSize=2)),
    ("builder", dict(compressionGroupSize=2)),
], ids=["hierarchical", "group_size", "builder_group_size"])
def test_hierarchical_needs_two_groups_of_two(kind, kw):
    """The 2-hop exchange is ported (tests/test_torch_hier_compression.py);
    on one rank it has no factorization, refused with the reference's
    message at the same degree."""
    jnet = jmlp()
    if kind == "builder":
        from deeplearning4j_tpu.parallel import \
            SharedTrainingMasterBuilder as JSTMB

        with pytest.raises(ValueError) as want:
            JSTMB().compressionGroupSize(2).build().bind(jnet, jmesh(1))
        with pytest.raises(ValueError) as got:
            SharedTrainingMasterBuilder().compressionGroupSize(2).build() \
                .bind(R.build("mlp"), None)
    else:
        jcls, pcls = (JPW, ParallelWrapper) if kind == "PW" \
            else (JSTM, SharedTrainingMaster)
        with pytest.raises(ValueError) as want:
            jcls(jnet, mesh=jmesh(1), **kw)
        with pytest.raises(ValueError) as got:
            pcls(R.build("mlp"), **kw)
    assert str(got.value) == str(want.value)


def test_sharded_update_at_one_rank_is_replicated():
    """weight_update="sharded" over a one-rank group trains bitwise the
    replicated wrapper (the flat view is a reshape, the update
    elementwise); the hook is the net's, its state held flat."""
    x, y, _ = R.data(64)
    nets = []
    for mode in ("replicated", "sharded"):
        net = R.build("mlp")
        pw = ParallelWrapper(net, weight_update=mode, min_shard_size=64)
        for _ in range(3):
            pw.fit(x, y)
        nets.append((net, pw))
    (a, _), (b, pw) = nets
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert b._update_impl is pw._zero and a._update_impl is None
    assert (32 * 3,) in {tuple(t.shape) for t in
                         tree_leaves(b._upd_states)}


def test_fit_dataset_steps_per_sync():
    net = R.build("mlp")
    x, y, _ = R.data(64)
    pw = ParallelWrapper(net)
    with pytest.raises(ValueError, match="stepsPerSync"):
        pw.fitDataSet(DataSetIterator(x, y, 32), stepsPerSync=0)
    pw.fitDataSet(DataSetIterator(x, y, 32), epochs=2)
    assert pw._fit_dataset_syncs == 4 and net.getIterationCount() == 4
    # k = 2 blocks (since the training-runtime slice): one sync a block,
    # the per-batch trajectory bit for bit
    ref = R.build("mlp")
    ParallelWrapper(ref).fit(DataSetIterator(x, y, 16), epochs=2)
    blk = R.build("mlp")
    pwb = ParallelWrapper(blk)
    pwb.fitDataSet(DataSetIterator(x, y, 16), stepsPerSync=2, epochs=2)
    assert pwb._fit_dataset_syncs == 4 and blk.getIterationCount() == 8
    assert torch.equal(blk.params().tensor(), ref.params().tensor())
    assert blk.score() == ref.score()


# ----------------------------------------------------------------------
# TestMultiHostTwoProcess: two processes joined by initialize()
# ----------------------------------------------------------------------

_TWO_PROC_CHILD = r'''
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.nn import (
    InputType, MultiLayerNetwork, NeuralNetConfiguration, OutputLayer, Sgd)
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, initializeMultiHost, is_coordinator, num_hosts)

torch.set_num_threads(1)
pid, store = int(sys.argv[1]), sys.argv[2]
group = initializeMultiHost(init_method=f"file://{store}", num_processes=2,
                            process_id=pid, device="cpu", timeout=120)
assert group.size == 2 and group.rank == pid, group
rng = np.random.RandomState(0)
X = rng.randn(64, 8).astype("float32")
W = rng.randn(8, 4).astype("float32")
Y = rng.randn(64, 4).astype("float32")
conf = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1)).list()
        .layer(OutputLayer(nOut=4, activation="identity",
                           lossFunction="mse"))
        .setInputType(InputType.feedForward(8)).build())
net = MultiLayerNetwork(conf, device="cpu").init()
net.load_reference_params([{"W": W, "b": np.zeros(4, np.float32)}])
ParallelWrapper(net).fit(X, Y)
w2 = net._params[0]["W"].detach().numpy()
print("CHILDREC " + json.dumps({
    "process": pid, "is_coord": bool(is_coordinator()),
    "hosts": int(num_hosts()), "loss": float(net.score()),
    "w2_sum": float(w2.sum(dtype=np.float64))}), flush=True)
'''


def test_two_process_dp_step_parity(tmp_path):
    """Two OS processes join through initialize() (a FileStore
    rendezvous), each trains on its half of the batch through
    ParallelWrapper, and both agree with a single-process numpy oracle."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    script = tmp_path / "child.py"
    script.write_text(_TWO_PROC_CHILD)
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(store)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=here) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LAUNCH_TIMEOUT)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"two-process step hung ({LAUNCH_TIMEOUT} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    recs = {}
    for rc, out, err in outs:
        assert rc == 0, err.strip()[-800:]
        for line in out.splitlines():
            if line.startswith("CHILDREC "):
                r = json.loads(line[len("CHILDREC "):])
                recs[r["process"]] = r
    assert sorted(recs) == [0, 1], outs
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype("float32")
    W = rng.randn(8, 4).astype("float32")
    Y = rng.randn(64, 4).astype("float32")
    pred = X.astype(np.float64) @ W
    loss_ref = float(np.mean((pred - Y) ** 2))
    g = 2.0 * X.T @ (pred - Y) / pred.size
    w2_ref = float(np.sum(W - 0.1 * g))
    for pid in (0, 1):
        assert recs[pid]["hosts"] == 2
        np.testing.assert_allclose(recs[pid]["loss"], loss_ref, rtol=1e-5)
        np.testing.assert_allclose(recs[pid]["w2_sum"], w2_ref, rtol=1e-4)
    assert recs[0]["is_coord"] and not recs[1]["is_coord"]
