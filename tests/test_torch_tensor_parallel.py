"""Tensor parallelism: the port's ``shard_params`` and column-parallel
layer rule (deeplearning4j_tpu_torch/parallel/{sharding,tensor}.py)
against the reference's ``shard_params`` under GSPMD.

The reference's own tests (tests/test_parallel.py ``TestTensorParallel``
:196, tests/test_partition_analysis.py :433) place a net's params on
``build_mesh({"data": 4, "model": 2})`` of the virtual 8-device CPU mesh
and run ``net.output``/``net.fit`` on it; here the reference does that
in this process, and the port runs four gloo ranks on
``{"data": 2, "model": 2}`` (``parallel.launch``; rank bodies in
tests/_torch_parallel_ranks.py, ``tp_rank``) from the reference's
initial weights, on the same global batches. Beside the reference's two
nets: an AttentionVertex with nHeads % 2 == 0 (its heads split, K1's
plain version on 2 heads a rank) and with nHeads % 2 != 0 (the exact
gather path), and an LSTM (its gates gathered every step).

Bars: the forward within the reference test's rtol 2e-5 / atol 1e-6 of
the reference's sharded output; params after 2 fit steps within rtol
1e-5 / atol 1e-6 of the reference's sharded training (the data-parallel
tests' bar), and of the port's own unsharded training; the whole params
and layer states bitwise equal on every rank after the steps; a model
written by a tensor-parallel net restores to its ``params()`` bitwise.
Where the arithmetic is exact (f64), the column path equals the
unsharded net to 1e-12. Per-layer remat on a placed net trains to the
placed net's params bit for bit; its ``feedForward`` lies within 1e-5
of the unsharded net's.
"""

import os

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.nn.conf.preprocessors import (
    FeedForwardToRnnPreProcessor as JFFtoRnn,
    RnnToFeedForwardPreProcessor as JRnnToFF,
)
from deeplearning4j_tpu.parallel import (
    build_mesh as jbuild_mesh, shard_params as jshard_params,
)

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel import sharding as sh

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0
FORWARD = dict(rtol=2e-5, atol=1e-6)
DENSE = dict(rtol=1e-5, atol=1e-6)
STEPS = 2


# ----------------------------------------------------------------------
# the reference's nets, built with its API (R.TP_NETS' twins)
# ----------------------------------------------------------------------

def j_tp_mlp():
    return J.MultiLayerNetwork(
        J.NeuralNetConfiguration.Builder().seed(3).updater(J.Sgd(0.1))
        .activation("relu").list()
        .layer(J.DenseLayer(nOut=256)).layer(J.DenseLayer(nOut=256))
        .layer(J.OutputLayer(nOut=4, activation="softmax"))
        .setInputType(J.InputType.feedForward(8)).build()).init()


def j_tp_adam():
    return J.MultiLayerNetwork(
        J.NeuralNetConfiguration.Builder().seed(3).updater(J.Adam(1e-2))
        .activation("relu").list()
        .layer(J.DenseLayer(nOut=128))
        .layer(J.OutputLayer(nOut=4, activation="softmax"))
        .setInputType(J.InputType.feedForward(8)).build()).init()


def j_attn(heads, F=16, T=6, nout=12):
    b = (J.NeuralNetConfiguration.Builder().seed(4).updater(J.Sgd(0.1))
         .activation("tanh").graphBuilder().addInputs("in"))
    b.addVertex("ff", J.PreprocessorVertex(JRnnToFF()), "in")
    b.addLayer("d1", J.DenseLayer(nOut=F), "ff")
    b.addVertex("seq", J.PreprocessorVertex(JFFtoRnn()), "d1")
    b.addVertex("attn", J.AttentionVertex(nOut=nout, nHeads=heads,
                                          hasBias=True), "seq")
    b.addLayer("gp", J.GlobalPoolingLayer(poolingType="avg"), "attn")
    b.addLayer("out", J.OutputLayer(nOut=3, activation="softmax"), "gp")
    return J.ComputationGraph(b.setOutputs("out").setInputTypes(
        J.InputType.recurrent(F, T)).build()).init()


def j_lstm():
    return J.MultiLayerNetwork(
        J.NeuralNetConfiguration.Builder().seed(6).updater(J.Sgd(0.1))
        .list().layer(J.LSTM(nOut=32, activation="tanh"))
        .layer(J.RnnOutputLayer(nOut=4, activation="softmax"))
        .setInputType(J.InputType.recurrent(8, 5)).build()).init()


JNETS = {"tp_mlp": j_tp_mlp, "tp_adam": j_tp_adam,
         "attn_even": lambda: j_attn(4), "attn_odd": lambda: j_attn(3),
         "lstm": j_lstm}


def tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def jflat(tree):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {f"{k}.{n}": np.asarray(v, np.float64)
            for k, p in items for n, v in p.items()}


def reference_run(name, net):
    """The reference's sharded run of `net` (TestTensorParallel's
    recipe): params placed by its shard_params at the net's
    min_shard_size on {data: 4, model: 2}, the output, STEPS fit steps."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jbuild_mesh({"data": 4, "model": 2})
    net._params = jshard_params(net._params, mesh,
                                min_shard_size=R.TP_NETS[name][3])
    net._upd_states = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())),
        net._upd_states)
    x, y = R.tp_batches()[name]
    out = np.asarray(net.output(x).toNumpy())
    scores = []
    for _ in range(STEPS):
        net.fit(x, y)
        scores.append(net.score())
    return {"output": out, "params": jflat(net._params), "scores": scores}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's runs, the ranks' results): the ranks start from
    the reference's initial weights and run while the reference does."""
    import threading

    nets = {name: make() for name, make in JNETS.items()}
    init = {name: (tree_np(n._params), tree_np(n._states))
            for name, n in nets.items()}
    tmp = str(tmp_path_factory.mktemp("tp"))
    box = {}

    def spawn():
        try:
            box["ranks"] = launch(R.tp_rank, 4, device="cpu",
                                  timeout=LAUNCH_TIMEOUT,
                                  args=(init, tmp, STEPS))
        except BaseException as e:     # re-raised in the test's thread
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    ref = {name: (init[name], reference_run(name, net))
           for name, net in nets.items()}
    th.join()
    if "error" in box:
        raise box["error"]
    return ref, box["ranks"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def port_single(name, init):
    net = R.tp_build(name, {name: init})
    x, y = R.tp_batches()[name]
    out = net.output(x).toNumpy()
    for _ in range(STEPS):
        net.fit(x, y)
    return out, R.ref_params(net)


def assert_params(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ----------------------------------------------------------------------
# the reference's TestTensorParallel
# ----------------------------------------------------------------------

def test_spec_rules():
    assert sh.spec_for_param("W", (512, 512)) == (None, "model")
    assert sh.spec_for_param("W", (256, 256, 3, 3)) == ("model", None, None,
                                                        None)
    assert sh.spec_for_param("b", (16,)) == ()


@pytest.mark.parametrize("name", sorted(R.TP_NETS))
def test_sharded_forward_matches_replicated(ranks, reference, name):
    """Sharding does not change the function: every rank's output equals
    the reference's sharded output (and so its replicated one)."""
    want = reference[name][1]["output"]
    for r in ranks:
        np.testing.assert_allclose(r[name]["output"], want, **FORWARD)


@pytest.mark.parametrize("name", sorted(R.TP_NETS))
def test_sharded_training_step(ranks, reference, name):
    """STEPS fit steps on {data: 2, model: 2} against the reference's on
    {data: 4, model: 2} and the port's unsharded fit: scores and whole
    params."""
    want = reference[name][1]
    _, single = port_single(name, reference[name][0])
    for r in ranks:
        got = r[name]
        assert all(np.isfinite(got["scores"]))
        np.testing.assert_allclose(got["scores"], want["scores"], **DENSE)
        assert_params(got["params"], want["params"], **DENSE)
        assert_params(got["params"], single, **DENSE)


@pytest.mark.parametrize("name", sorted(R.TP_NETS))
def test_replicated_leaves_stay_bitwise_equal(ranks, name):
    assert all(r[name]["replicated"] for r in ranks)


def test_layer_paths(ranks):
    """The column rule runs every sharded layer of the aligned nets; the
    unaligned head split (3 heads over 2 ranks) takes the gather path."""
    r = ranks[0]
    for name in ("tp_mlp", "tp_adam", "attn_even", "lstm"):
        assert r[name]["calls"]["gather"] == 0, (name, r[name]["calls"])
        assert r[name]["calls"]["column"] > 0, name
    assert r["attn_odd"]["calls"]["gather"] > 0
    assert r["attn_even"]["sharded"]["attn"] == {
        "Wq": 1, "Wk": 1, "Wv": 1, "Wo": 1, "bq": 0, "bk": 0, "bv": 0,
        "bo": 0}
    assert r["lstm"]["sharded"] == {"0": {"W": 1, "RW": 1}}


@pytest.mark.parametrize("name", ["tp_mlp", "attn_even"])
def test_activation_checkpointing_runs_the_rule(ranks, name):
    """Per-layer remat on a placed net recomputes each layer through the
    column rule (its exchanges run again, so the column count grows) and
    trains to the same params bit for bit."""
    for r in ranks:
        got = r["remat"][name]
        assert got["calls"]["gather"] == 0, got["calls"]
        assert got["calls"]["column"] > r[name]["calls"]["column"]
        assert sorted(got["params"]) == sorted(r[name]["params"])
        for k, v in r[name]["params"].items():
            assert np.array_equal(got["params"][k], v), k


def test_feed_forward_and_pretraining_on_a_placed_net(ranks):
    """feedForward runs each layer through the rule (every activation
    whole, within the forward bar of the unsharded net's); layerwise
    pretraining of a layer held as blocks is refused, naming the axis."""
    for r in ranks:
        ff = r["feed_forward"]
        assert ff["shapes_equal"] and ff["calls"]["column"] > 0
        assert ff["max_abs"] < 1e-5, ff
        assert r["pretrain_refused"] == (
            "layerwise pretraining reads layer 0's whole params, which "
            "shard_params placed as blocks over the 'model' axis: run it "
            "before shard_params or after replicate_params")


def test_written_model_is_whole(ranks):
    """params() of a placed net is the unsharded net's, bitwise;
    writeModel on a tensor-parallel net writes the whole model: it
    restores to the net's params() bitwise; replicate_params gathers the
    leaves back to their whole shapes."""
    for r in ranks:
        assert all(r[name]["whole_at_start"] for name in R.TP_NETS)
        assert r["tp_adam"]["restored_equal"]
        assert r["tp_adam"]["after_replicate"] == {
            "0": {"W": (8, 128), "b": (128,)}, "1": {"W": (128, 4),
                                                   "b": (4,)}}


def test_tp_step_signature_passes_the_collective_checks(ranks):
    """A tensor-parallel step's signature, record-only through
    verify_program and executed under recording(), runs over the mesh's
    axes (COL02), equal on every rank (COL01)."""
    for r in ranks:
        t = r["tp_adam"]
        assert t["signature_errors"] == [] and t["executed_errors"] == []
        assert t["signature_axes"] == ["data", "model"]
        assert t["executed_axes"] == ["data", "model"]
        assert t["signature_ops"]["all_gather"] >= 2


def test_tp_step_refuses_capture_and_counts_it(ranks):
    """precompile refuses a tensor-parallel step (its exchanges wait for
    NCCL capture) and the eager steps after it count as uncaptured."""
    for r in ranks:
        assert "NCCL capture" in r["tp_adam"]["capture"]
        assert r["tp_adam"]["uncaptured"] >= 1


# ----------------------------------------------------------------------
# tests/test_partition_analysis.py :433, the strict mode
# ----------------------------------------------------------------------

def test_shard_params_strict_mode(ranks):
    mesh = jbuild_mesh({"model": 8})
    params = [{"W": jax.numpy.ones((512, 513))}]
    assert jshard_params(params, mesh)[0]["W"].shape == (512, 513)
    with pytest.raises(ValueError, match="'model'") as want:
        jshard_params(params, mesh, on_indivisible="error")
    for r in ranks:
        assert r["lenient"] == (512, 513)
        assert "'model'" in r["strict"] and "(PAR03)" in r["strict"]
        assert r["strict"].replace("(size 2)", "(size 8)") == str(want.value)


def test_l2_gradient_normalization_is_refused(ranks):
    """A per-layer or per-param-type L2 norm over a sharded leaf would
    read one block, and weight noise would draw over one: shard_params
    refuses both (stated deviations)."""
    for r in ranks:
        assert "gradientNormalization=clip_l2_per_layer" in \
            r["norm_refused"]
        assert r["noise_refused"].startswith("layers [0] draw weight noise")


def test_on_indivisible_must_be_known():
    with pytest.raises(ValueError, match="on_indivisible"):
        sh.shard_plan([{"W": torch.ones(4, 4)}], {"model": 2},
                      on_indivisible="pad")


# ----------------------------------------------------------------------
# the analyzer agrees with the executor
# ----------------------------------------------------------------------

def _encoder_conf():
    """chip_smoke.py's encoder (phase 7) at narrow widths."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_conf", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dict(cs.BERT_BASE, hidden=64, heads=4, intermediate=128,
               layers=2, seq=16)
    return cs.bert_encoder_conf(cfg)


@pytest.mark.parametrize("model,min_shard", [("resnet50", 2 ** 16),
                                             ("resnet50", 4096),
                                             ("encoder", 512)])
def test_validate_plan_names_the_leaves_shard_params_shards(model,
                                                            min_shard):
    """validate_plan on {data: 4, model: 2} shards exactly the leaves
    shard_params shards (and replicates the rest) for ResNet-50 and the
    encoder."""
    from deeplearning4j_tpu_torch.analysis import validate_plan
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    if model == "resnet50":
        conf = ResNet50(numClasses=1000, inputShape=(3, 64, 64),
                        device="cpu").conf()
    else:
        conf = _encoder_conf()
    mesh = {"data": 4, "model": 2}
    rep = validate_plan(conf, mesh=mesh, plan={"min_shard_size": min_shard},
                        batchSize=8)
    net = ComputationGraph(conf, device="cpu").init()
    plan = sh.shard_plan(net, mesh, min_shard_size=min_shard)
    got = {f"{k}.{n}": d for k, dims in plan.items() for n, d in dims.items()}
    assert rep.plan["shards"] == got
    whole = {f"{k}.{n}" for k in net._unit_keys() for n in net._params[k]}
    assert got and set(got) < whole


# ----------------------------------------------------------------------
# exactness of the column path (f64)
# ----------------------------------------------------------------------

def test_column_path_is_exact_in_f64(ranks):
    """bn_cnn in f64 on {model: 4}: its column-parallel convolutions
    train to the unsharded net's params within 1e-12."""
    for r in ranks:
        f = r["f64"]
        assert f["calls"]["column"] > 0 and f["calls"]["gather"] == 0
        assert f["max_abs"] < 1e-12, f
        assert f["replicated"]
