"""checkpointPolicy="save_conv_outputs" in the port
(``nn/multilayer.py`` ``remat_segment``; both networks), against the
stock path and the JAX reference. Mirrors tests/test_remat_policy.py.

The training forward runs in segments cut after each convolution and
dense product, each under ``torch.utils.checkpoint``, which keeps only a
segment's inputs (the product outputs before it); the backward
recomputes a segment when it reaches it. The contract, as the
reference's: the trajectory is the stock one (here bitwise: the
recompute runs the same ops on the same inputs, dropout re-seeds from its
key), BN's running statistics move once a step (the recompute's copies
are dropped), the forward really is cut at the products, the zoo threads
the option through both network types, and an unknown policy is
rejected. Synchronised BN
recomputes its all-reduces on two gloo ranks with the same result.
Against the reference's own remat trajectory (weights carried, Nesterovs):
params rtol 1e-5 / atol 1e-7 and the loss rel 1e-6 after 5 steps (f32;
the reference's own bar against its stock path).
"""

import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.nn import multilayer as ML
from deeplearning4j_tpu_torch.parallel import launch

import _torch_parallel_ranks as R

torch.set_num_threads(1)


def _gconf(M, policy, dropout=None, updater=None):
    """tests/test_remat_policy.py's graph (and a dropout on d1)."""
    b = (M.NeuralNetConfiguration.Builder().seed(11)
         .updater(updater or M.Adam(1e-2)).checkpointPolicy(policy))
    return (b.graphBuilder().addInputs("in")
            .addLayer("c1", M.ConvolutionLayer(nOut=6, kernelSize=(3, 3),
                                               padding=(1, 1),
                                               activation="identity"), "in")
            .addLayer("bn1", M.BatchNormalization(activation="relu"), "c1")
            .addLayer("p1", M.SubsamplingLayer(poolingType="max",
                                               kernelSize=(2, 2),
                                               stride=(2, 2)), "bn1")
            .addLayer("c2", M.ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                               padding=(1, 1),
                                               activation="identity"), "p1")
            .addLayer("bn2", M.BatchNormalization(activation="relu"), "c2")
            .addLayer("gap", M.GlobalPoolingLayer(poolingType="avg"), "bn2")
            .addLayer("d1", M.DenseLayer(nOut=16, activation="relu",
                                         dropOut=dropout), "gap")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                      "d1")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(8, 8, 2)).build())


def _mconf(M, policy, updater=None):
    """tests/test_remat_policy.py's MultiLayerNetwork."""
    b = (M.NeuralNetConfiguration.Builder().seed(9)
         .updater(updater or M.Adam(1e-2)).checkpointPolicy(policy))
    return (b.list()
            .layer(M.ConvolutionLayer(nOut=5, kernelSize=(3, 3),
                                      padding=(1, 1), activation="identity"))
            .layer(M.BatchNormalization(activation="relu"))
            .layer(M.GlobalPoolingLayer(poolingType="avg"))
            .layer(M.DenseLayer(nOut=8, activation="relu"))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.convolutional(6, 6, 2)).build())


def _data(seed=0, n=8, c=2, hw=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, hw, hw).astype("float32")
    return x, np.eye(3, dtype="float32")[rng.randint(0, 3, n)]


def _graph(policy, dropout=None):
    return P.ComputationGraph(_gconf(P, policy, dropout),
                              device="cpu").init()


@pytest.mark.parametrize("dropout", [None, 0.7], ids=["plain", "dropout"])
def test_trajectory_parity_with_stock(dropout):
    x, y = _data()
    stock, remat = _graph(None, dropout), _graph("save_conv_outputs",
                                                 dropout)
    assert remat.conf.checkpointPolicy == "save_conv_outputs"
    for _ in range(5):
        stock.fit(x, y)
        remat.fit(x, y)
        assert stock.score() == remat.score()
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    for n in ("bn1", "bn2"):
        for k in ("mean", "var"):
            assert torch.equal(stock._states[n][k], remat._states[n][k])


def test_bn_running_stats_track():
    """BN state leaves the checkpointed region as an output of the first
    forward; the recompute's copies are dropped, so the statistics move
    once a step: after one step, mean = (1 - decay) * batch mean."""
    x, y = _data(1)
    remat = _graph("save_conv_outputs")
    stock = _graph(None)
    for _ in range(3):
        stock.fit(x, y)
        remat.fit(x, y)
    assert torch.equal(stock._states["bn1"]["mean"],
                       remat._states["bn1"]["mean"])
    assert float(remat._states["bn1"]["mean"].abs().sum()) > 0
    one = _graph("save_conv_outputs")
    with torch.no_grad():
        c1 = torch.nn.functional.conv2d(
            torch.from_numpy(x), one._params["c1"]["W"],
            one._params["c1"]["b"], padding=1)
    one.fit(x, y)
    want = 0.1 * c1.double().mean((0, 2, 3))
    torch.testing.assert_close(one._states["bn1"]["mean"].double(), want,
                               rtol=1e-5, atol=1e-7)


def test_policy_cuts_a_segment_after_each_product(monkeypatch):
    """One checkpointed segment a product (c1, c2, d1, out), each fed
    only by the product output before it (or the network input)."""
    inputs = []
    real = ML.remat_segment

    def spy(fn, *args):
        inputs.append([tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor)])
        return real(fn, *args)

    from deeplearning4j_tpu_torch.nn import graph as G

    monkeypatch.setattr(G, "remat_segment", spy)
    x, y = _data(2)
    net = _graph("save_conv_outputs")
    net.fit(x, y)
    assert inputs == [[(8, 2, 8, 8)],       # the input -> c1
                      [(8, 6, 8, 8)],       # c1 -> bn1, p1, c2
                      [(8, 8, 4, 4)],       # c2 -> bn2, gap, d1
                      [(8, 16)]], inputs    # d1 -> out
    net.output(x)                           # inference runs no segment
    assert len(inputs) == 4


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="checkpointPolicy"):
        P.NeuralNetConfiguration.Builder().checkpointPolicy(
            "save_everything")
    with pytest.raises(ValueError, match="checkpointPolicy"):
        PZ.SimpleCNN(checkpointPolicy="everything", device="cpu").init()


def test_mln_trajectory_parity():
    rng = np.random.RandomState(4)
    x = rng.randn(8, 2, 6, 6).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, 8)]
    stock = P.MultiLayerNetwork(_mconf(P, None), device="cpu").init()
    remat = P.MultiLayerNetwork(_mconf(P, "save_conv_outputs"),
                                device="cpu").init()
    for _ in range(5):
        stock.fit(x, y)
        remat.fit(x, y)
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    assert stock.score() == remat.score()


def test_zoo_threads_the_policy_through_both_network_types():
    kw = dict(numClasses=3, device="cpu", checkpointPolicy="save_conv_outputs")
    for net in (PZ.SimpleCNN(inputShape=(3, 12, 12), **kw).init(),
                PZ.UNet(inputShape=(3, 8, 8), **kw).init()):
        assert net.conf.checkpointPolicy == "save_conv_outputs"
    x = np.random.RandomState(0).randn(2, 3, 12, 12).astype("float32")
    y = np.eye(3, dtype="float32")[[0, 2]]
    a = PZ.SimpleCNN(inputShape=(3, 12, 12), numClasses=3,
                     device="cpu").init()
    b = PZ.SimpleCNN(inputShape=(3, 12, 12), **kw).init()
    for _ in range(2):     # SimpleCNN trains with its DropoutLayer on
        a.fit(x, y)
        b.fit(x, y)
    assert torch.equal(a.params().tensor(), b.params().tensor())


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_matches_the_reference_remat_trajectory(kind):
    """Nesterovs here: Adam's first steps divide tiny gradients by their
    own magnitude, so two summation orders move a near-zero gradient's
    parameter by a whole step (observed 3e-3 apart after 5 steps)."""
    x, y = _data(3) if kind == "graph" else _data(3, hw=6)
    policy = "save_conv_outputs"
    if kind == "graph":
        jn = J.ComputationGraph(_gconf(J, policy, updater=J.Nesterovs(
            0.05, 0.9))).init()
        pn = P.ComputationGraph(_gconf(P, policy, updater=P.Nesterovs(
            0.05, 0.9)), device="cpu").init()
    else:
        jn = J.MultiLayerNetwork(_mconf(J, policy, J.Nesterovs(
            0.05, 0.9))).init()
        pn = P.MultiLayerNetwork(_mconf(P, policy, P.Nesterovs(0.05, 0.9)),
                                 device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    for _ in range(5):
        jn.fit(x, y)
        pn.fit(x, y)
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-7)
    assert abs(pn.score() - jn.score()) <= 1e-6 * abs(jn.score())


def test_sync_bn_recomputes_its_all_reduces_with_the_same_result():
    """Two gloo ranks, dense ParallelWrapper (synchronised BN): under the
    policy the recompute issues the BN all-reduces again, and every rank
    ends bitwise where the stock run ends."""
    ranks = launch(R.remat_sync_bn_rank, 2, device="cpu", timeout=240,
                   args=(3,))
    for r in ranks:
        s, m = r["stock"], r["save_conv_outputs"]
        np.testing.assert_array_equal(s["params"], m["params"])
        for n in s["bn"]:
            np.testing.assert_array_equal(s["bn"][n], m["bn"][n])
        assert s["losses"] == m["losses"]
        assert m["collectives"] > s["collectives"]
    np.testing.assert_array_equal(ranks[0]["stock"]["params"],
                                  ranks[1]["stock"]["params"])


# ----------------------------------------------------------------------
# per-layer activation remat: activationCheckpointing
# (tests/test_multilayer.py::TestActivationCheckpointing)
# ----------------------------------------------------------------------

def _ck_mconf(M, ck, updater=None, dropout=None, bn=False):
    """TestActivationCheckpointing's MultiLayerNetwork (a BN layer and a
    dropout on the first dense layer when asked)."""
    b = (M.NeuralNetConfiguration.Builder().seed(7)
         .updater(updater or M.Adam(1e-2)).activation("tanh"))
    if ck:
        b = b.activationCheckpointing(True)
    lb = b.list().layer(M.DenseLayer(nOut=16, dropOut=dropout))
    if bn:
        lb = lb.layer(M.BatchNormalization())
    return (lb.layer(M.DenseLayer(nOut=16)).layer(M.DenseLayer(nOut=16))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.feedForward(6)).build())


def _ck_gconf(M, ck, updater=None):
    """TestActivationCheckpointing's ComputationGraph."""
    b = (M.NeuralNetConfiguration.Builder().seed(3)
         .updater(updater or M.Adam(1e-2)).activation("relu"))
    if ck:
        b = b.activationCheckpointing(True)
    return (b.graphBuilder().addInputs("in")
            .addLayer("h1", M.DenseLayer(nOut=12), "in")
            .addLayer("h2", M.DenseLayer(nOut=12), "h1")
            .addLayer("out", M.OutputLayer(nOut=2, activation="softmax"),
                      "h2")
            .setOutputs("out")
            .setInputTypes(M.InputType.feedForward(5)).build())


def _ck_data(kind):
    rng = np.random.RandomState(0 if kind == "mln" else 1)
    n, f, o = (16, 6, 3) if kind == "mln" else (8, 5, 2)
    x = rng.randn(n, f).astype("float32")
    return x, np.eye(o, dtype="float32")[rng.randint(0, o, n)]


def _ck_pair(kind, **kw):
    if kind == "mln":
        return [P.MultiLayerNetwork(_ck_mconf(P, ck, **kw),
                                    device="cpu").init()
                for ck in (False, True)]
    return [P.ComputationGraph(_ck_gconf(P, ck, **kw), device="cpu").init()
            for ck in (False, True)]


class _Spy:
    """Counts ``checkpointed_forward`` regions by layer type name."""

    def __init__(self, monkeypatch):
        from deeplearning4j_tpu_torch.nn import graph as G

        self.calls = []
        real = ML.checkpointed_forward

        def spy(layer, l_train, *a):
            self.calls.append(type(layer).__name__)
            return real(layer, l_train, *a)

        monkeypatch.setattr(ML, "checkpointed_forward", spy)
        monkeypatch.setattr(G, "checkpointed_forward", spy)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_activation_checkpointing_bitwise_stock(kind, monkeypatch):
    """The recompute runs the same ops on the same inputs: the trajectory
    is the stock one bit for bit, each layer but the output head runs
    under its own region, and inference runs none."""
    spy = _Spy(monkeypatch)
    x, y = _ck_data(kind)
    stock, remat = _ck_pair(kind)
    assert remat.conf.activationCheckpointing is True
    assert stock.conf.activationCheckpointing is False
    for _ in range(5):
        stock.fit(x, y)
        remat.fit(x, y)
        assert stock.score() == remat.score()
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    assert spy.calls == ["DenseLayer"] * (3 if kind == "mln" else 2) * 5
    spy.calls.clear()
    assert torch.equal(remat.output(x).tensor(), stock.output(x).tensor())
    assert spy.calls == []


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_activation_checkpointing_matches_the_reference(kind):
    """Against the reference's own activationCheckpointing trajectory
    with its weights carried (TestActivationCheckpointing's nets and
    updater): params rtol 1e-5 / atol 1e-7 after 5 steps, the loss rel
    1e-6."""
    x, y = _ck_data(kind)
    if kind == "mln":
        jn = J.MultiLayerNetwork(_ck_mconf(J, True)).init()
        pn = P.MultiLayerNetwork(_ck_mconf(P, True), device="cpu").init()
    else:
        jn = J.ComputationGraph(_ck_gconf(J, True)).init()
        pn = P.ComputationGraph(_ck_gconf(P, True), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    for _ in range(5):
        jn.fit(x, y)
        pn.fit(x, y)
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=1e-5, atol=1e-7)
    assert abs(pn.score() - jn.score()) <= 1e-6 * abs(jn.score())


def test_activation_checkpointing_dropout_and_bn_stats():
    """Dropout re-seeds each recomputed draw from its key (the same
    DrawSites masks), and BN's running statistics come from the first
    forward only: both bitwise stock after 4 steps."""
    x, y = _ck_data("mln")
    stock, remat = _ck_pair("mln", dropout=0.7, bn=True)
    for _ in range(4):
        stock.fit(x, y)
        remat.fit(x, y)
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    for k in ("mean", "var"):
        assert torch.equal(stock._states[1][k], remat._states[1][k])
    one = P.MultiLayerNetwork(_ck_mconf(P, True, bn=True),
                              device="cpu").init()
    with torch.no_grad():
        h = torch.tanh(torch.from_numpy(x) @ one._params[0]["W"]
                       + one._params[0]["b"])
    one.fit(x, y)
    torch.testing.assert_close(one._states[1]["mean"].double(),
                               0.1 * h.double().mean(0), rtol=1e-5,
                               atol=1e-7)


def _attn_graph(M, ck, policy=None, inputs=("in", "in")):
    b = M.NeuralNetConfiguration.Builder().seed(5).updater(M.Sgd(0.1))
    if ck:
        b = b.activationCheckpointing(True)
    if policy:
        b = b.checkpointPolicy(policy)
    return (b.graphBuilder().addInputs("in")
            .addVertex("attn", M.AttentionVertex(nOut=8, nHeads=2),
                       *inputs)
            .addLayer("sa", M.SelfAttentionLayer(nOut=8, nHeads=2), "attn")
            .addLayer("gp", M.GlobalPoolingLayer(poolingType="avg"), "sa")
            .addLayer("d", M.DenseLayer(nOut=6, activation="tanh"), "gp")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                      "d")
            .setOutputs("out")
            .setInputTypes(M.InputType.recurrent(4, 6)).build())


@pytest.mark.parametrize("policy,inputs", [
    (None, ("in", "in")), ("save_conv_outputs", ("in", "in")),
    (None, ("in",))], ids=["per_layer", "both_flags",
                           "one_edge_departs_from_reference"])
def test_multi_input_attention_keeps_the_plain_path(policy, inputs,
                                                    monkeypatch):
    """An AttentionVertex fed two edges runs outside any per-layer region
    (the reference's rule for multi-input layers); the self-attention
    layer runs inside one and its flash forward runs again in the
    backward (the plain version's launches: 3 a step against stock's 2).
    An AttentionVertex fed one edge (self-attention, as the encoder's)
    takes a region too, 4 a step: the port's rule is the node's edge
    count, where the reference exempts every multi-input layer
    (deeplearning4j_tpu/nn/graph.py), so the port rematerialises a
    self-attention vertex the reference keeps. With checkpointPolicy
    set as well the per-layer regions nest inside the policy's segments.
    Bitwise stock either way."""
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    spy = _Spy(monkeypatch)
    rng = np.random.RandomState(2)
    x = rng.randn(4, 4, 6).astype("float32")
    y = np.eye(3, dtype="float32")[[0, 1, 2, 1]]
    stock = P.ComputationGraph(_attn_graph(P, False, inputs=inputs),
                               device="cpu").init()
    remat = P.ComputationGraph(_attn_graph(P, True, policy, inputs),
                               device="cpu").init()
    launches = []
    for net in (stock, remat):
        tfa.reset_launches()
        for _ in range(3):
            net.fit(x, y)
        launches.append(tfa.flash_fwd_plain.launches)
    # per layer: sa's forward again in the backward (3 a step); under
    # the policy too, its segments' recomputes (attn's and sa's) run the
    # flash forward once more each (4 a step)
    assert launches == [2 * 3, (3 if policy is None else 4) * 3
                        if len(inputs) == 2 else 4 * 3]
    assert torch.equal(stock.params().tensor(), remat.params().tensor())
    assert ("AttentionVertex" in spy.calls) == (len(inputs) == 1)
    assert "SelfAttentionLayer" in spy.calls


def test_both_flags_nest_inside_the_policy_segments(monkeypatch):
    """checkpointPolicy and activationCheckpointing together: every
    policy segment holds its layers' per-layer regions; bitwise stock."""
    segs = []
    real = ML.remat_segment

    def spy(fn, *args):
        segs.append(len(args))
        return real(fn, *args)

    monkeypatch.setattr(ML, "remat_segment", spy)
    x, y = _data(3, hw=6)
    stock = P.MultiLayerNetwork(_mconf(P, None), device="cpu").init()
    conf = _mconf(P, "save_conv_outputs")
    conf.activationCheckpointing = True
    both = P.MultiLayerNetwork(conf, device="cpu").init()
    for _ in range(3):
        stock.fit(x, y)
        both.fit(x, y)
    assert torch.equal(stock.params().tensor(), both.params().tensor())
    # the first forward: the policy's 3 segments (conv | BN, pooling,
    # dense | output; 3 arguments each) and, inside them, one per-layer
    # region (5 arguments) for each of the 4 layers before the head
    assert segs[:7] == [3, 5, 3, 5, 5, 5, 3], segs


def test_recurrent_carries_and_tbptt_unchanged():
    """An LSTM under truncated BPTT keeps its carries across windows
    (bitwise stock), and rnnTimeStep's state is the stock one."""
    def conf(ck):
        b = P.NeuralNetConfiguration.Builder().seed(4).updater(P.Adam(1e-2))
        if ck:
            b = b.activationCheckpointing(True)
        return (b.list().layer(P.LSTM(nOut=6, activation="tanh"))
                .layer(P.RnnOutputLayer(nOut=3, activation="softmax"))
                .setInputType(P.InputType.recurrent(4))
                .backpropType(P.BackpropType.TruncatedBPTT)
                .tBPTTForwardLength(3).tBPTTBackwardLength(3).build())

    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 9).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, (2, 9))] \
        .transpose(0, 2, 1).copy()
    a = P.MultiLayerNetwork(conf(False), device="cpu").init()
    b = P.MultiLayerNetwork(conf(True), device="cpu").init()
    for _ in range(2):
        a.fit(x, y)
        b.fit(x, y)
    assert torch.equal(a.params().tensor(), b.params().tensor())
    sa, sb = a.rnnTimeStep(x[:, :, :2]), b.rnnTimeStep(x[:, :, :2])
    assert torch.equal(sa.tensor(), sb.tensor())


def test_serde_round_trip_keeps_the_flag():
    for conf, cls in ((_ck_mconf(P, True), P.MultiLayerConfiguration),
                      (_ck_gconf(P, True),
                       P.ComputationGraphConfiguration)):
        back = cls.fromJson(conf.toJson())
        assert back.activationCheckpointing is True
        assert json.loads(conf.toJson())["attrs"][
            "activationCheckpointing"] is True
    # a reference configuration with the flag reads into the port
    jc = _ck_mconf(J, True)
    assert P.MultiLayerConfiguration.fromJson(
        jc.toJson()).activationCheckpointing is True


def test_capture_key_holds_the_flag():
    """A remat net and a stock net never share a captured graph (the
    key's fingerprint holds the flag, as the reference's holds the remat
    policy), nor does a net with a ZeRO hook installed."""
    from deeplearning4j_tpu_torch.parallel import DataGroup
    from deeplearning4j_tpu_torch.parallel.sharding import ZeroShardedUpdate
    from deeplearning4j_tpu_torch.runtime import aot

    stock, remat = _ck_pair("mln")
    f0, f1 = aot.network_fingerprint(stock), aot.network_fingerprint(remat)
    assert f0 != f1
    assert aot.network_fingerprint(_ck_pair("mln")[1]) == f1
    keys = [next(iter(n.precompile(batchSize=16,
                                   entries=("train",)).values()))["key"]
            for n in (stock, remat)]
    assert keys[0] != keys[1]
    stock._update_impl = ZeroShardedUpdate(DataGroup(), min_shard_size=64)
    assert aot.network_fingerprint(stock) not in (f0, f1)


def test_par06_sees_the_lower_peak():
    """PAR06 runs the network's own train step on meta tensors, so the
    per-layer regions lower its predicted peak by themselves."""
    from deeplearning4j_tpu_torch.analysis.partitioning import \
        step_high_water

    def conf(ck, act):
        b = P.NeuralNetConfiguration.Builder().seed(1).updater(P.Sgd(0.1))
        if ck:
            b = b.activationCheckpointing(True)
        lb = b.activation(act).list()
        for _ in range(6):
            lb = lb.layer(P.DenseLayer(nOut=256))
        return (lb.layer(P.OutputLayer(nOut=10, activation="softmax"))
                .setInputType(P.InputType.feedForward(256)).build())

    # softplus saves its input beside the product's: stock holds two
    # tensors a layer for the backward, remat one
    stock, remat = step_high_water(conf(False, "softplus"), 512), \
        step_high_water(conf(True, "softplus"), 512)
    assert remat["step_peak_bytes"] < 0.7 * stock["step_peak_bytes"]
    assert remat["params_bytes"] == stock["params_bytes"]
    # relu saves its output, the next product's input: a layer already
    # holds one tensor, and remat has nothing to drop
    stock, remat = step_high_water(conf(False, "relu"), 512), \
        step_high_water(conf(True, "relu"), 512)
    assert remat["step_peak_bytes"] <= stock["step_peak_bytes"]
