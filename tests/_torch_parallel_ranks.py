"""Rank bodies and port-side nets for the data-parallel tests.

Imports neither jax nor the reference package: ``parallel.launch``
spawns ranks that import this module, and the card tests run it with
``--noconftest``. The nets mirror the reference's test nets
(``tests/test_parallel.py``: ``_mlp``, ``TestParameterAveraging._sgd_mlp``,
``TestThresholdGradientSharing._mlp``,
``TestComputationGraphDataParallel._graph``) and ``parallel.dryrun.
bn_cnn``; a rank loads the reference's initial weights where the caller
passes them (``init`` below: {name: (params, states)}).
"""

import numpy as np
import torch

from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.nn import (
    Adam, ComputationGraph, DenseLayer, ElementWiseVertex, InputType,
    MultiLayerNetwork, NeuralNetConfiguration, OutputLayer, Sgd,
)
from deeplearning4j_tpu_torch.nn import graph as _graph
from deeplearning4j_tpu_torch.nn import multilayer as _ml
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, ParameterAveragingTrainingMaster,
    ParameterAveragingTrainingMasterBuilder, SharedTrainingMaster,
    SharedTrainingMasterBuilder, SparkComputationGraph, SparkDl4jMultiLayer,
    data_parallel_mesh,
)
from deeplearning4j_tpu_torch.parallel import collectives as coll
from deeplearning4j_tpu_torch.parallel import sharding as sh
from deeplearning4j_tpu_torch.parallel.dryrun import bn_cnn, bn_cnn_batch


# ----------------------------------------------------------------------
# nets and data (the reference's, tests/test_parallel.py)
# ----------------------------------------------------------------------

def mlp_conf(seed=42):
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Adam(1e-2)).activation("relu").list()
            .layer(DenseLayer(nOut=32))
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())


def sgd_mlp_conf(seed=42):
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Sgd(0.1)).activation("relu").list()
            .layer(DenseLayer(nOut=32))
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())


def thr_conf(seed=5):
    return (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Sgd(0.5)).activation("tanh").list()
            .layer(DenseLayer(nOut=16))
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())


def graph_conf(seed=11):
    return (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(0.1))
            .activation("tanh").graphBuilder().addInputs("in")
            .addLayer("h", DenseLayer(nOut=16), "in")
            .addLayer("out", OutputLayer(nOut=3, activation="softmax"), "h")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(4)).build())


def cg_facade_conf():
    return (NeuralNetConfiguration.Builder()
            .seed(1).updater(Adam(1e-2)).graphBuilder()
            .addInputs("in")
            .addLayer("h", DenseLayer(nOut=32, activation="relu"), "in")
            .addLayer("out", OutputLayer(nOut=3, activation="softmax"), "h")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(4)).build())


def multi_io_conf():
    return (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
            .graphBuilder().addInputs("a", "b")
            .addVertex("m", ElementWiseVertex("add"), "a", "b")
            .addLayer("out", OutputLayer(nOut=2, activation="softmax"), "m")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(2), InputType.feedForward(2))
            .build())


def data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    w = rng.randn(4, 3)
    yi = np.argmax(x @ w, axis=1)
    return x, np.eye(3, dtype="float32")[yi], yi


def thr_data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    yi = rng.randint(0, 3, n)
    x = (np.eye(3)[yi] @ np.array([[2.0] * 8, [-2.0] * 8, [0.0] * 8])
         + 0.1 * rng.randn(n, 8)).astype("float32")
    return x, np.eye(3, dtype="float32")[yi]


NETS = {"mlp": (MultiLayerNetwork, mlp_conf),
        "sgd_mlp": (MultiLayerNetwork, sgd_mlp_conf),
        "thr": (MultiLayerNetwork, thr_conf),
        "graph": (ComputationGraph, graph_conf)}


def build(name, init=None, device="cpu", **kw):
    """The port's net `name` (NETS, or "bn_cnn"/"bn_cnn64"), with the
    reference's weights when `init` carries them."""
    if name.startswith("bn_cnn"):
        net = bn_cnn(device, "DOUBLE" if name == "bn_cnn64" else "FLOAT")
    else:
        cls, conf = NETS[name]
        net = cls(conf(**kw), device=device).init()
    if init is not None and name in init:
        net.load_reference_params(*init[name])
    return net


def ref_params(net):
    """The params of a port net in the reference's layout and names, as
    one flat {"layer.name": f64 numpy} dict."""
    if isinstance(net, ComputationGraph):
        tree = _graph.params_to_reference(net.conf, net._params)
        items = tree.items()
    else:
        items = enumerate(_ml.params_to_reference(net.layers, net._params))
    return {f"{k}.{n}": np.asarray(v, np.float64)
            for k, p in items for n, v in p.items()}


def accuracy(net, x, yi):
    return float((net.output(x).toNumpy().argmax(1) == yi).mean())


# ----------------------------------------------------------------------
# the rank body of tests/test_torch_parallel.py
# ----------------------------------------------------------------------

def _fits(master, net, x, y, n):
    scores = []
    for _ in range(n):
        master.fit(x, y)
        scores.append(net.score())
    return scores


def parity_rank(rank, world, device, init):
    """Every data-parallel scenario of the parity tests on this rank;
    returns {scenario: result}, params in ref_params form."""
    out = {}
    x, y, yi = data(64)

    net = build("mlp", init)
    pw = ParallelWrapper(net)
    out["dense"] = {"scores": _fits(pw, net, x, y, 5),
                    "params": ref_params(net), "comm": pw.last_step}
    for mode in ("int8", "block_int8"):
        net = build("mlp", init)
        m = SharedTrainingMaster(net, gradient_compression=mode) \
            if mode != "int8" else SharedTrainingMaster(net)
        out[mode] = {"mode": m.gradient_compression,
                     "scores": _fits(m, net, x, y, 3),
                     "params": ref_params(net)}

    net = build("graph", init)
    out["graph_dense"] = {"scores": _fits(ParallelWrapper(net), net, x, y, 4),
                          "params": ref_params(net)}
    net = build("graph")
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e-2)
    out["graph_threshold"] = {"scores": _fits(pw, net, x, y, 30)}

    net = build("sgd_mlp", init)
    pm = ParameterAveragingTrainingMaster(net, averagingFrequency=1)
    out["pa_freq1"] = {"scores": _fits(pm, net, x, y, 4),
                       "params": ref_params(net)}
    x3, y3, _ = data(64, seed=3)
    net = build("mlp")
    pm = ParameterAveragingTrainingMaster(net, averagingFrequency=5)
    replicas = []
    for n in (3, 2):
        _fits(pm, net, x3, y3, n)
        replicas.append(np.concatenate(
            [t.detach().reshape(-1).numpy()
             for p in pm._replica[0] for t in p.values()]))
    out["pa_replicas"] = {"after3": replicas[0], "after5": replicas[1],
                          "net": ref_params(net)}

    xt, yt = thr_data()
    net = build("thr", init)
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e9)
    pw.fit(xt, yt)
    res, tau = pw._residual
    out["thr_huge"] = {"params": ref_params(net),
                       "residual": _ml.params_to_reference(
                           net.layers, res),
                       "tau": float(tau)}
    net = build("thr", init)
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e-2, encodingCapacity=1.0)
    out["thr_step1"] = {"scores": _fits(pw, net, xt, yt, 1),
                        "params": ref_params(net)}
    return out


def property_rank(rank, world, device):
    """The reference's convergence and property tests, port-side only
    (they hold each trainer to an outcome, not to the reference's
    numbers); returns {scenario: result}."""
    out = {}
    xt, yt = thr_data()
    net = build("thr")
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=0.05)
    out["thr_feedback"] = _fits(pw, net, xt, yt, 40)
    net = build("thr")
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e-2, encodingCapacity=1.0)
    out["thr_converges"] = _fits(pw, net, xt, yt, 100)
    net = build("thr")
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e-2)
    out["thr_capacity"] = {"capacity": pw.encoding_capacity,
                           "scores": _fits(pw, net, xt, yt, 150)}
    taus = []
    for t0 in (100.0, 1e-8):
        net = build("thr")
        pw = ParallelWrapper(net, gradient_compression="threshold",
                             threshold=t0, targetSparsity=0.2)
        _fits(pw, net, xt, yt, 30)
        taus.append((float(pw._residual[1]), net.score()))
    out["thr_adaptive"] = taus
    net = build("thr")
    pw = ParallelWrapper(net, gradient_compression="threshold",
                         threshold=1e-2, residualClip=1.0)
    _fits(pw, net, xt, yt, 3)
    res = torch.cat([a.reshape(-1) for p in pw._residual[0]
                     for a in p.values()])
    out["thr_clip"] = float(res.abs().max())

    x, y, yi = data(256)
    net = build("mlp")
    pw = ParallelWrapper(net)
    it = DataSetIterator(x, y, 64, shuffle=True)
    for _ in range(20):
        pw.fit(it)
    out["dp_iterator_acc"] = accuracy(net, x, yi)
    net = build("mlp")
    pm = ParameterAveragingTrainingMaster(net, averagingFrequency=4)
    it = DataSetIterator(x, y, 64, shuffle=True)
    for _ in range(20):
        pm.fit(it)
    out["pa_converges_acc"] = accuracy(net, x, yi)

    # a padded last batch: 40 rows at batch 32, the pad masked
    x40, y40, _ = data(40, seed=4)
    net = build("mlp")
    ParallelWrapper(net).fit(DataSetIterator(x40, y40, 32), epochs=2)
    out["masked_last_batch"] = ref_params(net)

    # the Spark facades, fit only
    x96, y96, yi96 = data(96)
    tm = (ParameterAveragingTrainingMasterBuilder()
          .averagingFrequency(1).build())
    spark = SparkDl4jMultiLayer(None, mlp_conf(), tm, device=device)
    it = DataSetIterator(x96, y96, 32)
    for _ in range(30):
        spark.fit(it)
    out["spark_pa_acc"] = accuracy(spark.getNetwork(), x96, yi96)
    out["spark_pa_master"] = type(spark.getTrainingMaster()).__name__
    x96, y96, yi96 = data(96, seed=3)
    tm = SharedTrainingMasterBuilder().gradientCompression(None).build()
    spark = SparkDl4jMultiLayer(None, mlp_conf(7), tm, device=device)
    it = DataSetIterator(x96, y96, 32)
    for _ in range(30):
        spark.fit(it)
    out["spark_shared_acc"] = accuracy(spark.getNetwork(), x96, yi96)
    x64, y64, yi64 = data(64, seed=5)
    rdd = [DataSet(x64[i:i + 32], y64[i:i + 32]) for i in (0, 32)]
    spark = SparkDl4jMultiLayer(None, mlp_conf(9), device=device)
    for _ in range(25):
        spark.fit(rdd)
    out["spark_rdd_acc"] = accuracy(spark.getNetwork(), x64, yi64)
    x64, y64, yi64 = data(64, seed=8)
    spark_g = SparkComputationGraph(None, cg_facade_conf(), device=device)
    it = DataSetIterator(x64, y64, 32)
    for _ in range(25):
        spark_g.fit(it)
    out["spark_graph_acc"] = float(
        (spark_g.getNetwork().output(x64).toNumpy().argmax(1)
         == yi64).mean())
    return out


def bn_cnn_rank(rank, world, device, init, steps=3):
    """bn_cnn in f64 from the reference's weights: `steps` dense steps
    and 1 int8 step, on the global batch of bn_cnn_batch(8 * world)."""
    x, y = bn_cnn_batch(8 * world)
    out = {}
    net = build("bn_cnn64", init)
    pw = ParallelWrapper(net)
    out["dense"] = {"scores": _fits(pw, net, x, y, steps),
                    "params": ref_params(net), "comm": pw.last_step,
                    "states": {f"{k}.{n}": v.numpy() for k, s in
                               net._states.items() for n, v in s.items()}}
    net = build("bn_cnn64", init)
    m = SharedTrainingMaster(net)
    out["int8"] = {"scores": _fits(m, net, x, y, 1),
                   "params": ref_params(net), "comm": m.last_step,
                   "states": {f"{k}.{n}": v.numpy() for k, s in
                              net._states.items() for n, v in s.items()}}
    return out


# ----------------------------------------------------------------------
# the rank body of tests/test_torch_parallel_exchange.py
# ----------------------------------------------------------------------

EXCHANGE_SIZES = (1000, 256, 37, 3)


def exchange_grads(rank, seed=0, sizes=EXCHANGE_SIZES):
    """Rank `rank`'s seeded gradient leaves (f32 numpy), one per size,
    magnitudes spread over three decades."""
    rng = np.random.RandomState(seed * 1000 + rank)
    return [(rng.randn(n) * 10.0 ** rng.uniform(-3, 0, n))
            .astype(np.float32) for n in sizes]


def exchange_rank(rank, world, device, seed=0):
    """The exchanges on this rank's exchange_grads: int8 and block_int8
    lanes and means, the dense all-reduce, the threshold exchange, and
    each one's collectives and bytes."""
    group = data_parallel_mesh()
    leaves = [torch.from_numpy(g).to(device)
              for g in exchange_grads(rank, seed)]
    out = {}
    for mode in ("int8", "block_int8"):
        q, scale, spans = sh._quantize(leaves, group, mode, 256)
        before = coll.totals()
        means = sh.quantized_psum_mean(leaves, group, mode)
        after = coll.totals()
        out[mode] = {
            "lanes": [v[:g.numel()].cpu().numpy()
                      for v, g in zip(q.split(spans), leaves)],
            "scales": [v[:g.numel()].cpu().numpy()
                       for v, g in zip(scale.split(spans), leaves)],
            "wire_lanes": q.numel(),
            "sum": [v[:g.numel()].cpu().numpy() for v, g in zip(
                coll.int8_lane_sum(q, group).split(spans), leaves)],
            "means": [m.cpu().numpy() for m in means],
            "comm": [a - b for a, b in zip(after, before)]}
    before = coll.totals()
    coll.all_reduce(torch.cat(leaves), group)
    out["dense"] = {"comm": [a - b for a, b in zip(coll.totals(), before)]}
    tau = torch.tensor(1e-2, dtype=torch.float32, device=device)
    res = torch.zeros(sum(g.numel() for g in leaves), device=device)
    wire = []
    gather = coll.all_gather

    def keep(t, g):    # the codes this rank puts on the wire
        wire.append(t.cpu().numpy())
        return gather(t, g)

    sh._coll.all_gather = keep
    before = coll.totals()
    try:
        means, new_res, sent = sh.threshold_psum_mean(leaves, res, tau,
                                                      0.125, group)
    finally:
        sh._coll.all_gather = gather
    after = coll.totals()
    out["threshold"] = {"means": [m.cpu().numpy() for m in means],
                        "residuals": [r.cpu().numpy() for r in new_res.split(
                            [g.numel() for g in leaves])],
                        "sent": int(sent), "codes": wire[0],
                        "comm": [a - b for a, b in zip(after, before)]}
    return out


def sync_bn_rank(rank, world, device, x, w_dy, residual):
    """The three BN Functions over this rank's rows of `x` (f64) in a
    synchronised group: y, the batch mean/var, dx, dgamma, dbeta (and the
    residual's gradient) for each, with the upstream gradient w_dy."""
    from deeplearning4j_tpu_torch.ops import norm

    group = data_parallel_mesh()
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for kind in ("plain", "act", "act_add"):
        xt = torch.from_numpy(x[rows]).requires_grad_(True)
        gamma = torch.linspace(0.5, 1.5, x.shape[1],
                               dtype=torch.float64).requires_grad_(True)
        beta = torch.linspace(-0.2, 0.3, x.shape[1],
                              dtype=torch.float64).requires_grad_(True)
        res = torch.from_numpy(residual[rows]).requires_grad_(True)
        with norm.sync_batch_norm(group):
            if kind == "plain":
                y, mean, var = norm.BNTrainFn.apply(xt, gamma, beta, 1e-5)
            elif kind == "act":
                y, mean, var = norm.BNActTrainFn.apply(xt, gamma, beta,
                                                       1e-5, "relu")
            else:
                y, mean, var = norm.BNActAddTrainFn.apply(
                    xt, gamma, beta, res, 1e-5, "relu")
        before = coll.totals()
        (y * torch.from_numpy(w_dy[rows])).sum().backward()
        after = coll.totals()
        out[kind] = {"y": y.detach().numpy(), "mean": mean.numpy(),
                     "var": var.numpy(), "dx": xt.grad.numpy(),
                     "dgamma": gamma.grad.numpy(),
                     "dbeta": beta.grad.numpy(),
                     "dres": None if res.grad is None else res.grad.numpy(),
                     "bwd_collectives": after[0] - before[0]}
    return out


# ----------------------------------------------------------------------
# the rank body of tests/test_torch_fit_dataset.py (TestFitDataSetSharded)
# ----------------------------------------------------------------------

def fit_dataset_rank(rank, world, device, init, n=8, k=4, batch=16):
    """fitDataSet(stepsPerSync=k) against per-batch fit on this rank,
    dense, int8 and threshold; returns params in ref_params form, the
    syncs, and the refusals' messages."""

    def it(nb=n, b=batch, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.randn(nb * b, 4).astype("float32")
        y = np.eye(3, dtype="float32")[rng.randint(0, 3, nb * b)]
        return DataSetIterator(x, y, b)

    def pair(make, steps_per_sync, nb=n):
        a, b = build("mlp", init), build("mlp", init)
        make(a).fit(it(nb))
        mb = make(b)
        mb.fitDataSet(it(nb), stepsPerSync=steps_per_sync)
        return a, b, mb

    out = {}
    for name, steps in (("dense", k), ("k1", 1), ("k3", 3)):
        a, b, pw = pair(ParallelWrapper, steps)
        out[name] = {"fit": ref_params(a), "blocks": ref_params(b),
                     "syncs": pw._fit_dataset_syncs,
                     "iteration": b.getIterationCount()}
    a, b, tm = pair(SharedTrainingMaster, 2, nb=4)
    out["int8"] = {"fit": ref_params(a), "blocks": ref_params(b),
                   "score": b.score(), "iteration": b.getIterationCount()}
    a, b = build("mlp", init), build("mlp", init)
    pa = ParallelWrapper(a, gradient_compression="threshold", threshold=1e-2)
    pb = ParallelWrapper(b, gradient_compression="threshold", threshold=1e-2)
    pa.fit(it(4))
    pb.fitDataSet(it(4), stepsPerSync=2)
    out["threshold"] = {"fit": ref_params(a), "blocks": ref_params(b),
                        "res_fit": pa._ef.numpy().copy(),
                        "res_blocks": pb._ef.numpy().copy(),
                        "syncs": pb._fit_dataset_syncs}
    try:
        ParallelWrapper(build("mlp", init)).fitDataSet(it(4, b=5),
                                                       stepsPerSync=2)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


# ----------------------------------------------------------------------
# the rank body of tests/test_torch_remat.py (synchronised BN recomputed)
# ----------------------------------------------------------------------

def remat_sync_bn_rank(rank, world, device, steps=3):
    """``bn_cnn`` through dense ParallelWrapper steps (synchronised BN)
    with and without checkpointPolicy="save_conv_outputs", on one seeded
    global batch: each run's params, BN statistics, losses and the
    collectives its steps issued."""
    x, y = bn_cnn_batch(8 * world)
    out = {}
    for policy in (None, "save_conv_outputs"):
        net = bn_cnn(device)
        net.conf.checkpointPolicy = policy
        pw = ParallelWrapper(net)
        before = coll.totals()
        losses = []
        for _ in range(steps):
            pw.fit(x, y)
            losses.append(net.score())
        out[policy or "stock"] = {
            "params": net.params().tensor().cpu().numpy(),
            "bn": {n: net._states[n]["mean"].cpu().numpy()
                   for n in ("b1", "b2")},
            "losses": losses,
            "collectives": coll.totals()[0] - before[0]}
    return out


# ----------------------------------------------------------------------
# the rank body of tests/test_torch_dropout.py (each rank's masks)
# ----------------------------------------------------------------------

def dropout_rank(rank, world, device, steps=2):
    """A dense ParallelWrapper over an MLP with dropout: the keys this
    rank drew its masks from, and the params after `steps` steps."""
    from deeplearning4j_tpu_torch.nn.conf import dropout as D

    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Sgd(0.1))
            .activation("relu").list()
            .layer(DenseLayer(nOut=8, dropOut=0.5))
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf, device=device).init()
    rng = np.random.RandomState(0)
    x = rng.randn(8 * world, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8 * world)]
    keys, real = [], D.Dropout.apply

    def spy(self, t, key):
        keys.append(key.ints)
        return real(self, t, key)

    D.Dropout.apply = spy
    try:
        pw = ParallelWrapper(net)
        for _ in range(steps):
            pw.fit(x, y)
    finally:
        D.Dropout.apply = real
    return {"keys": keys, "params": net.params().tensor().numpy()}


# ----------------------------------------------------------------------
# the collective-safety pass (analysis.collectives.verify_program)
# ----------------------------------------------------------------------

def divergent_signature_rank(rank, world, device):
    """A record-only dense step on every rank, rank 1 adding one
    all-reduce (the deadlock shape COL01 must name): the codes and
    errors ``verify_program`` reports on this rank."""
    from deeplearning4j_tpu_torch.analysis.collectives import verify_program

    group = data_parallel_mesh()
    net = bn_cnn(device)
    x, y = bn_cnn_batch(8 * world)
    master = ParallelWrapper(net, mesh=group)
    master.fit(x, y)

    def step():
        master.fit(x, y)
        if rank == 1:
            coll.all_reduce(torch.zeros(1, device=net.device), group)

    rep = verify_program(step, group=group)
    return {"codes": rep.codes(), "errors": [d.format() for d in rep.errors]}


def record_only_rank(rank, world, device):
    """A dense step's record-only run, through the trainer's own ``fit``
    (a bound method: its owner is put back) and through a closure (whose
    side effects stand): the params after each, as f64 numpy, and the
    params before."""
    from deeplearning4j_tpu_torch.analysis.collectives import verify_program
    from deeplearning4j_tpu_torch.parallel.dryrun import params_vector

    group = data_parallel_mesh()
    net = bn_cnn(device)
    x, y = bn_cnn_batch(8 * world)
    master = ParallelWrapper(net, mesh=group)
    master.fit(x, y)
    before = params_vector(net)
    it = net._iteration
    verify_program(master.fit, x, y, group=group)
    held = params_vector(net)
    held_it = net._iteration
    verify_program(lambda: master.fit(x, y), group=group)
    return {"before": before, "held": held, "held_iteration": held_it,
            "iteration": it, "unheld": params_vector(net)}


# ----------------------------------------------------------------------
# the rank bodies of tests/test_torch_zero_sharding.py and
# tests/test_torch_hier_compression.py
# ----------------------------------------------------------------------

def zero_mlp_conf(seed=42, nin=32, hidden=64, nout=4, updater=None):
    """tests/test_zero_sharding.py's ``_mlp``."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(updater or Adam(1e-2)).activation("relu")
            .list()
            .layer(DenseLayer(nOut=hidden))
            .layer(OutputLayer(nOut=nout, activation="softmax"))
            .setInputType(InputType.feedForward(nin)).build())


def zero_graph_conf(seed=9):
    """tests/test_zero_sharding.py's ``TestParityGraph._conf``."""
    return (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-2)).activation("relu").graphBuilder()
            .addInputs("in")
            .addLayer("d", DenseLayer(nOut=64), "in")
            .addLayer("out", OutputLayer(nOut=4, activation="softmax",
                                         lossFunction="mcxent"), "d")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(32)).build())


def zero_data(n=64, nin=32, nout=4, seed=0):
    """tests/test_zero_sharding.py's ``_data``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, nin).astype("float32")
    return x, np.eye(nout, dtype="float32")[rng.randint(0, nout, n)]


def _np_tree(tree):
    return [t.detach().cpu().numpy().copy() for t in _ml.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _sites(rec):
    return [(s.op, s.axes, s.size, s.payload_bytes, s.wire_bytes, s.lanes)
            for s in rec.sites]


def _np(t):
    return t.detach().cpu().numpy().copy()


def _spy_call(name, sink, at=0):
    """Wrap ``sharding.<name>`` so that its call number `at` leaves, in
    `sink`, its gradient leaves and the other tensor arguments (as
    numpy), its other arguments and its result; returns the undo."""
    fn = getattr(sh, name)
    count = [0]

    def spy(leaves, *args):
        out = fn(leaves, *args)
        if count[0] == at:
            def keep(a):
                if isinstance(a, torch.Tensor):
                    return _np(a)
                if isinstance(a, (list, tuple)):
                    return [keep(t) for t in a]
                return a
            sink.update(grads=keep(leaves), args=[
                keep(a) for a in args if not hasattr(a, "pg")
                and not hasattr(a, "intra")], out=keep(out))
        count[0] += 1
        return out

    setattr(sh, name, spy)
    return lambda: setattr(sh, name, fn)


def _zero_wrap(comp=None, mode="sharded", seed=42, updater=None,
               min_shard=256):
    net = MultiLayerNetwork(zero_mlp_conf(seed, updater=updater),
                            device="cpu").init()
    return net, ParallelWrapper(net, weight_update=mode,
                                gradient_compression=comp,
                                min_shard_size=min_shard)


def _samediff(min_shard=None):
    """tests/test_zero_sharding.py's ``TestParitySameDiff._make``."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig

    rs = np.random.RandomState(7)
    sd = SameDiff.create(device="cpu")
    x = sd.placeHolder("x", "float32", 8, 32)
    y = sd.placeHolder("y", "float32", 8, 4)
    w = sd.var("w", (rs.randn(32, 64) * 0.1).astype("float32"))
    b = sd.var("b", np.zeros(64, dtype="float32"))
    w2 = sd.var("w2", (rs.randn(64, 4) * 0.1).astype("float32"))
    h = sd.nn.relu(sd.nn.linear(x, w, b, name="h0"), name="h")
    logits = sd.nn.linear(h, w2, None, name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(
        TrainingConfig.Builder().updater(Adam(learningRate=1e-2))
        .dataSetFeatureMapping("x").dataSetLabelMapping("y").build())
    if min_shard is not None:
        sd.shardWeightUpdate(min_shard_size=min_shard)
    return sd


def _sd_batches(n):
    out = []
    for i in range(n):
        r = np.random.RandomState(i)
        out.append(DataSet(r.rand(8, 32).astype("float32"),
                           np.eye(4, dtype="float32")[r.randint(0, 4, 8)]))
    return out


def _nhwc_cnn():
    """Zoo SimpleCNN, NHWC: its 3x3 kernels are held channels-last."""
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    return SimpleCNN(numClasses=10, inputShape=(3, 16, 16),
                     dataFormat="NHWC", device="cpu").init()


def zero_rank(rank, world, device, tmp):
    """Every scenario of tests/test_torch_zero_sharding.py on this rank:
    sharded vs replicated (MLN in three modes, fitDataSet, an Sgd
    power-of-two run, CG, SameDiff), the layout, the recorded sites of a
    step, the files and the ResilientFit resume."""
    import os

    from deeplearning4j_tpu_torch.runtime.resilience import (
        FaultInjector, Preemption, ResilientFit,
    )
    from deeplearning4j_tpu_torch.util.hbm_ledger import weight_update_bill
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedModelSerializer

    out = {}
    x, y = zero_data()
    for comp in (None, "int8", "block_int8"):
        for mode in ("replicated", "sharded"):
            net, pw = _zero_wrap(comp, mode)
            call = {}
            undo = _spy_call("quantized_psum_scatter_mean", call)
            scores = []
            for _ in range(3):
                pw.fit(x, y)
                scores.append(net.score())
            undo()
            with coll.recording() as rec:
                pw.fit(x, y)
            scores.append(net.score())
            out[(comp, mode)] = {
                "params": net.params().tensor().numpy(),
                "scores": scores, "sites": _sites(rec),
                "upd": _np_tree(pw.net._canonical_upd_states()),
                "state_bytes": sh.ZeroShardedUpdate.per_rank_state_bytes(
                    net._upd_states),
                "shapes": [tuple(t.shape) for t in
                           _ml.tree_leaves(net._upd_states)],
                "bill": weight_update_bill(net, world), "call": call,
                "sizes": [t.numel() for p in net._params
                          for t in p.values()]}
    # fitDataSet(stepsPerSync=2) and the Sgd power-of-two run
    X, Y = zero_data(4 * 16)
    for mode in ("replicated", "sharded"):
        net, pw = _zero_wrap(mode=mode)
        pw.fitDataSet(DataSetIterator(X, Y, 16), stepsPerSync=2)
        out[("fds", mode)] = {"params": net.params().tensor().numpy(),
                              "syncs": pw._fit_dataset_syncs,
                              "it": net.getIterationCount()}
    rng = np.random.RandomState(3)
    xp = (2.0 ** rng.randint(-3, 3, (64, 32))).astype("float32") \
        * rng.choice([-1.0, 1.0], (64, 32)).astype("float32")
    yp = np.eye(4, dtype="float32")[rng.randint(0, 4, 64)]
    for mode in ("replicated", "sharded"):
        net, pw = _zero_wrap(mode=mode, updater=Sgd(0.5), min_shard=64)
        for _ in range(3):
            pw.fit(xp, yp)
        out[("sgd", mode)] = net.params().tensor().numpy()
    for mode in ("replicated", "sharded"):
        g = ComputationGraph(zero_graph_conf(), device="cpu").init()
        pw = ParallelWrapper(g, weight_update=mode, min_shard_size=256)
        pw.fitDataSet(DataSetIterator(X, Y, 16), stepsPerSync=2)
        out[("graph", mode)] = g.params().tensor().numpy()
    # channels-last kernels (an NHWC CNN): each block written back
    xc = np.random.RandomState(5).rand(8, 16, 16, 3).astype("float32")
    yc = np.eye(10, dtype="float32")[np.arange(8) % 10]
    for mode in ("replicated", "sharded"):
        net = _nhwc_cnn()
        pw = ParallelWrapper(net, weight_update=mode, min_shard_size=64)
        for _ in range(2):
            pw.fit(xc, yc)
        out[("nhwc", mode)] = net.params().tensor().numpy()
    # SameDiff: every rank fits the same batches
    a, b = _samediff(), _samediff(128)
    h1, h2 = a.fit(data=_sd_batches(4)), b.fit(data=_sd_batches(4))
    out["sd"] = {"h": (h1, h2),
                 "vars": [(a._arrays[n].numpy().copy(),
                           b._arrays[n].numpy().copy())
                          for n in ("w", "b", "w2")],
                 "shapes": [tuple(t.shape) for t in
                            _ml.tree_leaves(b._train_state)]}
    p = os.path.join(tmp, f"sd_{rank}.zip")
    b.save(p, saveUpdaterState=True)
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    c = SameDiff.load(p, loadUpdaterState=True, device="cpu")
    c.setTrainingConfig(b._tc)
    c._iteration = b._iteration
    out["sd_restore"] = (c.fit(data=_sd_batches(1)),
                         b.fit(data=_sd_batches(1)))
    # rewrapping replicated uninstalls the hook; files hold canonical
    net, pw = _zero_wrap()
    pw.fit(x, y)
    canon = _np_tree(pw.net._canonical_upd_states())
    mp = os.path.join(tmp, f"m_{rank}.npz")
    ModelSerializer.writeModel(net, mp)
    restored = ModelSerializer.restoreMultiLayerNetwork(mp, device="cpu")
    cp = os.path.join(tmp, f"ck_{rank}")
    ShardedModelSerializer.writeModel(net, cp)
    ck = ShardedModelSerializer.restore(cp, device="cpu")
    pw2 = ParallelWrapper(net)
    pw2.fit(x, y)
    out["files"] = {"canon": canon,
                    "npz": _np_tree(restored._upd_states),
                    "ckpt": _np_tree(ck._upd_states),
                    "uninstalled": net._update_impl is None,
                    "shapes": [tuple(t.shape) for t in
                               _ml.tree_leaves(net._upd_states)]}
    # ResilientFit over the sharded wrapper: preempted and resumed
    X8, Y8 = zero_data(8 * 16)

    def it():
        return DataSetIterator(X8, Y8, 16)

    n1, w1 = _zero_wrap()
    ResilientFit(w1).fit(it(), epochs=2)
    d = os.path.join(tmp, "resume")
    n2, w2 = _zero_wrap()
    try:
        ResilientFit(w2, d, saveEveryNIterations=3,
                     injector=FaultInjector().killAfterStep(11)).fit(
            it(), epochs=2)
        killed = False
    except Preemption:
        killed = True
    n3, w3 = _zero_wrap()
    ResilientFit(w3, d, saveEveryNIterations=3).fit(it(), epochs=2)
    n4, w4 = _zero_wrap()
    ResilientFit(w4).fit(it(), epochs=1, stepsPerSync=2)
    n5, w5 = _zero_wrap()
    ResilientFit(w5).fit(it(), epochs=1)
    out["resume"] = {"killed": killed,
                     "unbroken": n1.params().tensor().numpy(),
                     "resumed": n3.params().tensor().numpy(),
                     "upd": (_np_tree(n1._canonical_upd_states()),
                             _np_tree(n3._canonical_upd_states())),
                     "k2": n4.params().tensor().numpy(),
                     "k1": n5.params().tensor().numpy()}
    # a write failing past the retry policy on the writing rank raises
    # on every rank at that save
    from deeplearning4j_tpu_torch.runtime import chaos
    from deeplearning4j_tpu_torch.runtime.resilience import RetryPolicy

    n6, w6 = _zero_wrap()
    plan = chaos.ChaosPlan().raise_n("checkpoint.write", times=10,
                                     exc=OSError)
    if rank == 0:
        chaos.arm(plan)
    try:
        ResilientFit(w6, os.path.join(tmp, "fail"), saveEveryNIterations=2,
                     retryPolicy=RetryPolicy(maxRetries=2,
                                             sleep=lambda s: None)).fit(
            it(), epochs=1)
        err = None
    except OSError as e:
        err = str(e)
    finally:
        chaos.disarm()
    out["write_fault"] = {"err": err, "iteration": n6._iteration,
                          "fired": plan.fired("checkpoint.write")}
    return out


def hier_mlp_conf(seed=3, nin=32, h1=64, h2=32, nout=8, updater=None,
                  act="tanh"):
    """tests/test_hier_compression.py's ``_mlp``."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(updater or Sgd(0.1)).activation(act)
            .list()
            .layer(DenseLayer(nOut=h1))
            .layer(DenseLayer(nOut=h2))
            .layer(OutputLayer(nOut=nout, activation="softmax"))
            .setInputType(InputType.feedForward(nin)).build())


def hier_data(n=64, nin=32, nout=8, seed=0):
    """tests/test_hier_compression.py's ``_data``."""
    rng = np.random.RandomState(seed)
    yi = rng.randint(0, nout, n)
    x = (np.eye(nout)[yi] @ rng.randn(nout, nin)
         + 0.1 * rng.randn(n, nin)).astype("float32")
    return x, np.eye(nout, dtype="float32")[yi]


def _hier_wrap(nout=8, updater=None, **kw):
    net = MultiLayerNetwork(hier_mlp_conf(nout=nout, updater=updater),
                            device="cpu").init()
    kw.setdefault("gradient_compression", "hierarchical")
    return net, ParallelWrapper(net, **kw)


def hier_rank(rank, world, device, tmp):
    """Every scenario of tests/test_torch_hier_compression.py on this
    rank (dp 4, node groups of 2)."""
    import os

    from deeplearning4j_tpu_torch.runtime.resilience import (
        FaultInjector, Preemption, ResilientFit,
    )

    out = {}
    x, y = hier_data(world * 4)
    for im in ("block_int8", None):
        losses = {}
        for mode in (None, "hierarchical"):
            kw = {} if mode is None else {
                "threshold": 1e-1, "encodingCapacity": 1.0,
                "compressionGroupSize": 2, "intraGroupCompression": im}
            net, pw = _hier_wrap(gradient_compression=mode, **kw)
            call = {}
            # the second step's: its residual is the first step's
            undo = _spy_call("hierarchical_grad_exchange", call, at=1)
            traj = []
            for _ in range(9):
                pw.fit(x, y)
                traj.append(net.score())
            undo()
            with coll.recording() as rec:
                pw.fit(x, y)
            traj.append(net.score())
            losses[mode] = traj
            if mode is not None:
                out[("sites", im)] = _sites(rec)
                out[("sizes", im)] = [t.numel() for p in net._params
                                      for t in p.values()]
                out[("params", im)] = net.params().tensor().numpy()
                out[("call", im)] = call
        out[("loss", im)] = losses
    # one group is one virtual replica: every rank fed the same rows
    xs, ys = np.tile(x[:2], (world, 1)), np.tile(y[:2], (world, 1))
    virtual = {}
    for mode, kw in (("threshold", {}),
                     ("hierarchical", {"compressionGroupSize": 2,
                                       "intraGroupCompression": None})):
        net, pw = _hier_wrap(gradient_compression=mode, threshold=5e-2,
                             encodingCapacity=1.0, **kw)
        pw.fit(xs, ys)
        virtual[mode] = net.params().tensor().numpy()
    out["virtual"] = virtual
    # the residual's layout, resume, the k-loop, a cross-mode restore
    X, Y = hier_data(world * 12, nout=4)

    def it():
        return DataSetIterator(X, Y, world * 2)

    kw = dict(nout=4, updater=Sgd(0.25), threshold=1e-2,
              compressionGroupSize=2)
    net, pw = _hier_wrap(**kw)
    pw.fit(X[:world * 2], Y[:world * 2])
    ef, tau = pw._residual
    out["layout"] = {"ef": [tuple(t.shape) for t in _ml.tree_leaves(ef)],
                     "params": [t.numel() for t in
                                _ml.tree_leaves(net._params)],
                     "tau": float(tau)}
    try:
        flat = ParallelWrapper(net, gradient_compression="threshold",
                               threshold=1e-2)
        flat._place_replicated()
        flat._load_trainer_state(pw._trainer_state())
        out["cross_mode"] = None
    except ValueError as e:
        out["cross_mode"] = str(e)
    n1, w1 = _hier_wrap(**kw)
    ResilientFit(w1).fit(it(), epochs=2)
    d = os.path.join(tmp, "resume")
    n2, w2 = _hier_wrap(**kw)
    try:
        ResilientFit(w2, d, saveEveryNIterations=3,
                     injector=FaultInjector().killAfterStep(7)).fit(
            it(), epochs=2)
        killed = False
    except Preemption:
        killed = True
    n3, w3 = _hier_wrap(**kw)
    ResilientFit(w3, d, saveEveryNIterations=3).fit(it(), epochs=2)
    out["resume"] = {"killed": killed,
                     "unbroken": n1.params().tensor().numpy(),
                     "resumed": n3.params().tensor().numpy(),
                     "ef": (w1._ef.numpy(), w3._ef.numpy()),
                     "tau": (float(w1._tau), float(w3._tau))}
    Xk, Yk = hier_data(world * 8)
    net, pw = _hier_wrap(threshold=5e-2, encodingCapacity=1.0,
                         compressionGroupSize=2)
    pw.fitDataSet(DataSetIterator(Xk, Yk, world * 2), stepsPerSync=2,
                  epochs=2)
    out["k_loop"] = {"score": net.score(), "syncs": pw._fit_dataset_syncs,
                     "ef_max": float(pw._ef.abs().max())}
    return out


# ----------------------------------------------------------------------
# the mesh axes (tests/test_torch_{tensor,sequence,pipeline}_parallel.py)
# ----------------------------------------------------------------------

def tp_mlp_conf(seed=3):
    """TestTensorParallel.test_sharded_forward_matches_replicated's net."""
    from deeplearning4j_tpu_torch.nn import Sgd as _Sgd

    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(_Sgd(0.1)).activation("relu").list()
            .layer(DenseLayer(nOut=256))
            .layer(DenseLayer(nOut=256))
            .layer(OutputLayer(nOut=4, activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())


def tp_adam_conf(seed=3):
    """TestTensorParallel.test_sharded_training_step_runs's net."""
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Adam(1e-2)).activation("relu").list()
            .layer(DenseLayer(nOut=128))
            .layer(OutputLayer(nOut=4, activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())


def tp_attn_conf(heads, seed=4, F=16, T=6, nout=12):
    """An attention vertex (nHeads `heads`, biases) between two dense
    layers, pooled to a softmax head."""
    from deeplearning4j_tpu_torch.nn import (
        AttentionVertex, FeedForwardToRnnPreProcessor, GlobalPoolingLayer,
        PreprocessorVertex, RnnToFeedForwardPreProcessor,
    )

    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(0.1))
         .activation("tanh").graphBuilder().addInputs("in"))
    b.addVertex("ff", PreprocessorVertex(RnnToFeedForwardPreProcessor()),
                "in")
    b.addLayer("d1", DenseLayer(nOut=F), "ff")
    b.addVertex("seq", PreprocessorVertex(FeedForwardToRnnPreProcessor()),
                "d1")
    b.addVertex("attn", AttentionVertex(nOut=nout, nHeads=heads,
                                        hasBias=True), "seq")
    b.addLayer("gp", GlobalPoolingLayer(poolingType="avg"), "attn")
    b.addLayer("out", OutputLayer(nOut=3, activation="softmax"), "gp")
    return (b.setOutputs("out")
            .setInputTypes(InputType.recurrent(F, T)).build())


def tp_lstm_conf(seed=6):
    """An LSTM (its W and RW column-sharded, its bias replicated) under an
    RnnOutputLayer."""
    from deeplearning4j_tpu_torch.nn import LSTM, RnnOutputLayer

    return (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(0.1))
            .list()
            .layer(LSTM(nOut=32, activation="tanh"))
            .layer(RnnOutputLayer(nOut=4, activation="softmax"))
            .setInputType(InputType.recurrent(8, 5)).build())


TP_NETS = {"tp_mlp": (MultiLayerNetwork, tp_mlp_conf, {}, 1024),
           "tp_adam": (MultiLayerNetwork, tp_adam_conf, {}, 256),
           "attn_even": (ComputationGraph, tp_attn_conf, {"heads": 4}, 8),
           "attn_odd": (ComputationGraph, tp_attn_conf, {"heads": 3}, 8),
           "lstm": (MultiLayerNetwork, tp_lstm_conf, {}, 256)}


def tp_batches(seed=0):
    """{net: (x, y)} global batches of 16 rows for TP_NETS."""
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]
    xs = rng.randn(16, 16, 6).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    xl = rng.randn(16, 8, 5).astype(np.float32)
    yl = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (16, 5))] \
        .transpose(0, 2, 1).copy()
    return {"tp_mlp": (x, y), "tp_adam": (x, y), "attn_even": (xs, ys),
            "attn_odd": (xs, ys), "lstm": (xl, yl)}


def tp_build(name, init=None, device="cpu"):
    cls, conf, kw, _ = TP_NETS[name]
    net = cls(conf(**kw), device=device).init()
    if init is not None and name in init:
        net.load_reference_params(*init[name])
    return net


def _whole_equal(net, group):
    """Whether the whole params (gathered) and the layer states are
    bitwise equal on every rank of `group`."""
    from deeplearning4j_tpu_torch.parallel.dryrun import whole_vector

    vec = torch.from_numpy(whole_vector(net))
    allv = coll.all_gather(vec, group)
    return bool(all(torch.equal(allv[0], v) for v in allv))


def tp_rank(rank, world, device, init, tmp, steps=2):
    """Every tensor-parallel scenario on one rank of {data: 2, model: 2}
    (world 4) or {model: world}: each of TP_NETS from the reference's
    weights, placed by shard_params at its min_shard_size, its output,
    `steps` fit steps (params and scores in ref_params form), the layer
    paths it took and whether the whole params stayed bitwise equal on
    every rank; a written and restored model; the strict mode; the
    signature of a step, checked."""
    from deeplearning4j_tpu_torch.analysis import collectives as C
    from deeplearning4j_tpu_torch.parallel import (
        build_mesh, replicate_params, shard_params,
    )
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

    axes = {"data": 2, "model": 2} if world == 4 else {"model": world}
    mesh = build_mesh(axes)
    data = tp_batches()
    out = {}
    for name, (_, _, _, min_shard) in TP_NETS.items():
        net = tp_build(name, init, device)
        shard_params(net, mesh, min_shard_size=min_shard)
        x, y = data[name]
        whole_at_start = np.array_equal(
            net.params().toNumpy(),
            tp_build(name, init, device).params().toNumpy())
        r = {"output": net.output(x).toNumpy(), "scores": [],
             "sharded": {str(k): dict(v) for k, v in net._tp.sharded.items()}}
        for _ in range(steps):
            net.fit(x, y)
            r["scores"].append(net.score())
        r["params"] = ref_params_whole(net)
        r["whole_at_start"] = whole_at_start
        r["calls"] = dict(net._tp.calls)
        r["replicated"] = _whole_equal(net, mesh)
        if name == "tp_adam":
            path = f"{tmp}/tp_adam_{rank}.zip"
            ModelSerializer.writeModel(net, path)
            back = MultiLayerNetwork.load(path, device=device)
            r["restored_equal"] = bool(np.array_equal(
                back.params().toNumpy(), net.params().toNumpy()))
            rep = C.verify_program(net.fit, x, y, group=mesh)
            r["signature_errors"] = [d.format() for d in rep.errors]
            r["signature_axes"] = sorted(rep.signature.axes())
            r["signature_ops"] = rep.signature.counts()
            with coll.recording() as rec:
                net.fit(x, y)
            sig = C.CollectiveSignature(rec.sites)
            r["executed_errors"] = [d.format() for d in C.check_signature(
                sig, mesh_axes=axes).errors]
            r["executed_axes"] = sorted(sig.axes())
            from deeplearning4j_tpu_torch.runtime import aot

            try:
                net.precompile(batchSize=16)
                r["capture"] = None
            except aot.CaptureRefused as e:
                r["capture"] = str(e)
            net.fit(x, y)
            r["uncaptured"] = net._captured.uncaptured
            replicate_params(net, mesh)
            r["after_replicate"] = {str(k): {n: tuple(t.shape)
                                             for n, t in p.items()}
                                    for k, p in enumerate(net._params)}
        out[name] = r
    out["remat"] = tp_remat(init, mesh, steps, device)
    out["feed_forward"] = tp_feed_forward(init, mesh, device)
    out["pretrain_refused"] = tp_pretrain_refused(mesh, device)
    try:
        shard_params([{"W": torch.ones(512, 513)}], mesh,
                     on_indivisible="error")
        out["strict"] = None
    except ValueError as e:
        out["strict"] = str(e)
    out["lenient"] = tuple(shard_params([{"W": torch.ones(512, 513)}],
                                        mesh)[0]["W"].shape)
    out["f64"] = tp_f64(world, device)
    from deeplearning4j_tpu_torch.nn import GradientNormalization

    conf = tp_adam_conf()
    conf.gradientNormalization = GradientNormalization.ClipL2PerLayer
    try:
        shard_params(MultiLayerNetwork(conf, device=device).init(), mesh,
                     min_shard_size=256)
        out["norm_refused"] = None
    except ValueError as e:
        out["norm_refused"] = str(e)
    from deeplearning4j_tpu_torch.nn import DropConnect

    conf = tp_adam_conf()
    conf.layers[0].weightNoise = DropConnect(0.9)
    try:
        shard_params(MultiLayerNetwork(conf, device=device).init(), mesh,
                     min_shard_size=256)
        out["noise_refused"] = None
    except ValueError as e:
        out["noise_refused"] = str(e)
    return out


def tp_remat(init, mesh, steps, device):
    """tp_mlp and attn_even under per-layer activation remat, placed as
    tp_rank places them: their whole params after `steps` fit steps and
    their layer paths (a recompute runs the rule again)."""
    from deeplearning4j_tpu_torch.parallel import shard_params

    out = {}
    for name in ("tp_mlp", "attn_even"):
        net = tp_build(name, init, device)
        net.conf.activationCheckpointing = True
        shard_params(net, mesh, min_shard_size=TP_NETS[name][3])
        x, y = tp_batches()[name]
        for _ in range(steps):
            net.fit(x, y)
        out[name] = {"params": ref_params_whole(net),
                     "calls": dict(net._tp.calls)}
    return out


def tp_feed_forward(init, mesh, device):
    """feedForward of a placed tp_mlp beside the unsharded net's: the
    largest |difference| over the activations, and the layer paths."""
    from deeplearning4j_tpu_torch.parallel import shard_params

    net, one = tp_build("tp_mlp", init, device), tp_build("tp_mlp", init,
                                                          device)
    shard_params(net, mesh, min_shard_size=TP_NETS["tp_mlp"][3])
    x, _ = tp_batches()["tp_mlp"]
    got = [a.toNumpy() for a in net.feedForward(x)]
    want = [a.toNumpy() for a in one.feedForward(x)]
    return {"shapes_equal": [g.shape for g in got] == [w.shape
                                                       for w in want],
            "max_abs": max(float(np.abs(g - w).max())
                           for g, w in zip(got, want)),
            "calls": dict(net._tp.calls)}


def tp_pretrain_refused(mesh, device):
    """pretrainLayer on an AutoEncoder whose W shard_params sharded: the
    refusal's words."""
    from deeplearning4j_tpu_torch.nn import AutoEncoder
    from deeplearning4j_tpu_torch.parallel import shard_params

    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).list()
        .layer(AutoEncoder(nOut=256))
        .layer(OutputLayer(nOut=4, activation="softmax"))
        .setInputType(InputType.feedForward(8)).build(), device=device).init()
    shard_params(net, mesh, min_shard_size=256)
    try:
        net.pretrainLayer(0, tp_batches()["tp_mlp"][0])
    except ValueError as e:
        return str(e)
    return None


def ref_params_whole(net):
    """ref_params of a (possibly tensor-parallel) net: its whole params in
    the reference's layout and names."""
    whole = net._whole_params()
    if isinstance(net, ComputationGraph):
        items = _graph.params_to_reference(net.conf, whole).items()
    else:
        items = enumerate(_ml.params_to_reference(net.layers, whole))
    return {f"{k}.{n}": np.asarray(v, np.float64)
            for k, p in items for n, v in p.items()}


def seq_rank(rank, world, device, q, k, v, g):
    """Ring (causal and not) and Ulysses attention on {seq: world}, and
    the causal ring on {data: 2, seq: world/2} (batch row d on data rank
    d), each forward and backward (cotangent `g`): this rank's output and
    gradient shards as numpy."""
    from deeplearning4j_tpu_torch.parallel import (
        build_mesh, ring_attention, ulysses_attention,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    def run(fn, mesh, rows, causal):
        s = axis_group(mesh, "seq")
        T = q.shape[2]
        tl = T // s.size
        sl = slice(s.rank * tl, (s.rank + 1) * tl)
        loc = [torch.from_numpy(a[rows, :, sl].copy()).to(device)
               .requires_grad_(True) for a in (q, k, v)]
        o = fn(*loc, mesh, causal=causal)
        o.backward(torch.from_numpy(g[rows, :, sl].copy()).to(device))
        return [o.detach().cpu().numpy()] + [t.grad.cpu().numpy()
                                             for t in loc]

    out = {}
    mesh = build_mesh({"seq": world})
    out["ring"] = run(ring_attention, mesh, slice(None), False)
    out["ring_causal"] = run(ring_attention, mesh, slice(None), True)
    out["ulysses"] = run(ulysses_attention, mesh, slice(None), False)
    if world % 2 == 0 and world > 2:
        mesh2 = build_mesh({"data": 2, "seq": world // 2})
        d = mesh2.coords["data"]
        out["dp_ring_causal"] = run(ring_attention, mesh2,
                                    slice(d, d + 1), True)
    with coll.recording(execute=False) as rec:
        loc = torch.zeros(1, 1, 4, 2, requires_grad=True)
        ring_attention(loc, loc, loc, mesh).sum().backward()
    out["ring_sites"] = [(s.op, s.reduce, s.perm) for s in rec.sites]
    return out


def pp_mlp_conf(seed=5, H=32, constrained=False, lr=0.05):
    """TestPipelineParallel._deep_mlp (and the constraint test's net)."""
    from deeplearning4j_tpu_torch.nn import MaxNormConstraint
    from deeplearning4j_tpu_torch.nn import Sgd as _Sgd

    b = (NeuralNetConfiguration.Builder()
         .seed(seed).updater(_Sgd(lr)).activation("tanh"))
    if constrained:
        b = b.constrainWeights(MaxNormConstraint(0.3))
    b = b.list().layer(DenseLayer(nOut=H))
    for _ in range(4):
        b = b.layer(DenseLayer(nOut=H))
    return (b.layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())


def pp_data(n=64, seed=0):
    """tests/test_parallel.py's _data."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    w = rng.randn(4, 3)
    yi = np.argmax(x @ w, axis=1)
    return x, np.eye(3, dtype=np.float32)[yi], yi


def pp_rank(rank, world, device, init):
    """The pipeline scenarios on one of four ranks: {pipe: 4} 3 steps
    and {data: 2, pipe: 2} 2 steps from the reference's weights, 30
    steps of convergence, the constrained net (5 steps at Sgd 0.5), and
    the refusals; params in ref_params form."""
    from deeplearning4j_tpu_torch.nn import BatchNormalization
    from deeplearning4j_tpu_torch.parallel import (
        PipelineParallel, build_mesh,
    )

    def net_of(**kw):
        n = MultiLayerNetwork(pp_mlp_conf(**kw), device=device).init()
        if init is not None and not kw:
            n.load_reference_params(*init["pp_mlp"])
        return n

    out = {}
    pipe = build_mesh({"pipe": 4})
    dp_pp = build_mesh({"data": 2, "pipe": 2})
    x, y, _ = pp_data(64)
    for key, mesh, steps in (("pp4", pipe, 3), ("dp2pp2", dp_pp, 2)):
        net = net_of()
        pp = PipelineParallel(net, mesh, n_microbatches=4)
        scores = []
        for _ in range(steps):
            pp.fit(x, y)
            scores.append(net.score())
        out[key] = {"params": ref_params(net), "scores": scores,
                    "replicated": _whole_equal(net, mesh),
                    "comm": {k: v for k, v in pp.last_step.items()
                             if k != "tick_s"}}
        if key == "pp4":
            from deeplearning4j_tpu_torch.analysis import collectives as C

            before = ref_params(net)
            rep = C.verify_program(pp.fit, x, y, group=mesh)
            out[key]["signature_errors"] = [d.format() for d in rep.errors]
            out[key]["signature"] = [(s.op, s.axes, s.perm)
                                     for s in rep.signature]
            out[key]["held"] = all(np.array_equal(before[k], v) for k, v
                                   in ref_params(net).items())
    xc, yc, _ = pp_data(128, seed=4)
    net = net_of(seed=5, H=32)
    pp = PipelineParallel(net, pipe, n_microbatches=4)
    scores = []
    for _ in range(30):
        pp.fit(xc, yc)
        scores.append(net.score())
    out["converge"] = scores
    net = net_of(H=16, constrained=True, lr=0.5)
    pp = PipelineParallel(net, pipe, n_microbatches=4)
    for _ in range(5):
        pp.fit(x, y)
    out["max_norm"] = max(float(p["W"].detach().norm(dim=0).max())
                          for p in net._params)
    errors = {}
    x30, y30, _ = pp_data(30)
    for case, call in (
            ("divisible", lambda: PipelineParallel(
                net_of(), pipe, n_microbatches=4).fit(x30, y30)),
            ("microbatches", lambda: PipelineParallel(
                net_of(), pipe, n_microbatches=0)),
            ("stateful", lambda: PipelineParallel(
                MultiLayerNetwork(
                    NeuralNetConfiguration.Builder().seed(1).list()
                    .layer(DenseLayer(nOut=8))
                    .layer(BatchNormalization())
                    .layer(DenseLayer(nOut=8)).layer(DenseLayer(nOut=8))
                    .layer(DenseLayer(nOut=8)).layer(DenseLayer(nOut=8))
                    .layer(OutputLayer(nOut=3, activation="softmax"))
                    .setInputType(InputType.feedForward(4)).build(),
                    device=device).init(), pipe,
                n_microbatches=4).fit(x, y))):
        try:
            call()
            errors[case] = None
        except ValueError as e:
            errors[case] = str(e)
    out["errors"] = errors
    return out


def tp_f64(world, device, steps=3):
    """parallel.dryrun.bn_cnn in f64 on {model: world} (its convolutions
    column-parallel) against the same steps unsharded: the largest
    |difference| of the whole params, the layer paths, and whether the
    whole params and BN statistics are bitwise equal on every rank."""
    from deeplearning4j_tpu_torch.parallel import build_mesh, shard_params

    mesh = build_mesh({"model": world})
    net, one = bn_cnn(device, "DOUBLE"), bn_cnn(device, "DOUBLE")
    shard_params(net, mesh, min_shard_size=64)
    x, y = bn_cnn_batch(16)
    for _ in range(steps):
        net.fit(x, y)
        one.fit(x, y)
    return {"calls": dict(net._tp.calls),
            "max_abs": float(np.abs(net.params().toNumpy()
                                    - one.params().toNumpy()).max()),
            "replicated": _whole_equal(net, mesh)}


def tp_digest(net):
    """sha256 of a tensor-parallel net's replicated leaves and layer
    states (BN running statistics)."""
    import hashlib

    tp = net._tp
    h = hashlib.sha256()
    for k in net._unit_keys():
        for n, t in net._params[k].items():
            if n not in tp.sharded.get(k, {}):
                h.update(t.detach().float().cpu().numpy().tobytes())
    for t in _ml.tree_leaves(_ml.strip_carries(net._states)):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_card_rank(rank, world, device, steps=3):
    """On the card: zoo ResNet50 (32x32, 8 classes, bf16 NHWC over f32
    masters, Nesterovs) and bn_cnn (f32) on {model: world}, `steps` fit
    steps each: the digests of their replicated leaves and BN statistics,
    and the layer paths."""
    from deeplearning4j_tpu_torch.nn import DataType, Nesterovs
    from deeplearning4j_tpu_torch.parallel import build_mesh, shard_params
    from deeplearning4j_tpu_torch.zoo import ResNet50

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = build_mesh({"model": world})
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(8, 32, 32, 3).astype(np.float32)).to(
        device, torch.bfloat16)
    y = np.eye(8, dtype=np.float32)[rng.randint(0, 8, 8)]
    res = ResNet50(numClasses=8, inputShape=(3, 32, 32),
                   dataType=DataType.BFLOAT16, dataFormat="NHWC",
                   updater=Nesterovs(0.1, 0.9), device=device).init()
    shard_params(res, mesh, min_shard_size=4096)
    cnn = bn_cnn(device)
    shard_params(cnn, mesh, min_shard_size=64)
    xc, yc = bn_cnn_batch(16)
    for _ in range(steps):
        res.fit(x, y)
        cnn.fit(xc, yc)
    return {"resnet": tp_digest(res), "bn_cnn": tp_digest(cnn),
            "calls": {"resnet": dict(res._tp.calls),
                      "bn_cnn": dict(cnn._tp.calls)},
            "scores": [res.score(), cnn.score()]}


# ----------------------------------------------------------------------
# distributed linear algebra (tests/test_torch_linalg.py)
# ----------------------------------------------------------------------

class FixedDraws:
    """A ``util.draws.Draws`` stand-in answering the two draws the linalg
    consumers take with given values: rsvd's sketch Omega and k-means'
    first centre."""

    def __init__(self, omega=None, first=None):
        self.omega, self.first = omega, first

    def normal(self, what, shape, *index):
        assert what == "linalg.rsvd.omega"
        assert tuple(shape) == self.omega.shape, (shape, self.omega.shape)
        return torch.from_numpy(self.omega)

    def randint(self, what, high, *index):
        assert what == "kmeans.first"
        return int(self.first)


def _linalg_values(g, data, tag, mesh22, mesh4, dm):
    """Every routine on {data: 2, model: 2} and {data: 4} at one dtype:
    the results gathered to numpy."""
    from deeplearning4j_tpu_torch import linalg

    D, M = "data", "model"
    res = {}
    C = linalg.matmul(dm(g["A1"], mesh22, D, M), dm(g["B1"], mesh22, D, M))
    res["summa2d"], res["summa2d_spec"] = C.toNumpy(), C.spec
    res["summa1d"] = linalg.matmul(dm(g["A1"], mesh4),
                                   dm(g["B1"], mesh4)).toNumpy()
    res["replb1d"] = linalg.matmul(dm(g["A1"], mesh4), g["B1"]).toNumpy()
    res["replb2d"] = linalg.matmul(dm(g["A1"], mesh22, D, M),
                                   g["B1"]).toNumpy()
    dA, dB = dm(g["A2"], mesh4), dm(g["B2"], mesh4)
    ta = linalg.matmul(dA, dB, transpose_a=True)
    tb = linalg.matmul(dA, dA, transpose_b=True)
    res["ta"], res["ta_replicated"] = ta.toNumpy(), ta.is_replicated()
    res["tb"], res["tb_row_axis"] = tb.toNumpy(), tb.row_axis
    C = linalg.matmul(dm(g["A3"], mesh4), dm(g["B3"], mesh4, None))
    res["repl_dm"], res["repl_dm_row_axis"] = C.toNumpy(), C.row_axis
    res["gram1d"] = linalg.gram(dm(g["A4"], mesh4)).toNumpy()
    res["gram2d"] = linalg.gram(dm(g["A4"], mesh22, D, M)).toNumpy()
    res["cov"] = linalg.covariance(dm(g["A5"], mesh4)).toNumpy()
    res["pairwise"] = linalg.pairwise_sq_dists(dm(g["A6"], mesh4),
                                               g["B6"]).toNumpy()
    for name, a, b, kw in (("lstsq", dm(g["A7"], mesh4), g["b7"], {}),
                           ("ridge", dm(g["A7"], mesh4), g["b7"],
                            {"l2": 0.5}),
                           ("multi", dm(g["A8"], mesh22, D, M), g["B8"],
                            {})):
        r = linalg.lstsq(a, b, tol=1e-7, **kw)
        res[name] = (r.x.numpy(), r.iterations, r.converged)
    U, s, Vt = linalg.rsvd(dm(g["A9"], mesh4), 5, n_iter=4,
                           draws=FixedDraws(data["omega9"][tag]))
    res["rsvd"] = (U.toNumpy(), s.numpy(), Vt.numpy())
    comps, ev, mu = linalg.pca(dm(g["A10"], mesh4), 3,
                               draws=FixedDraws(data["omega10"][tag]))
    res["pca"] = (comps.numpy(), ev.numpy(), mu.numpy())
    return res


def _linalg_contracts(g, mesh22, mesh4, dm):
    """Each routine's executed signature against its linalg_contract
    (COL01 across the ranks, COL04, COL06), its wire bytes beside the
    plan's, and the record-only counts of the SUMMA and Gram programs."""
    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.analysis import collectives as colan
    from deeplearning4j_tpu_torch.parallel import data_parallel_mesh

    D, M = "data", "model"
    world = data_parallel_mesh()
    dA22, dB22 = dm(g["A1"], mesh22, D, M), dm(g["B1"], mesh22, D, M)
    dA4, dB4 = dm(g["A1"], mesh4), dm(g["B1"], mesh4)
    dT = dm(g["A7"], mesh4)
    got, out = {}, {}
    runs = (("matmul2d", lambda: linalg.matmul(dA22, dB22), {"ring": 2},
             mesh22),
            ("matmul1d", lambda: linalg.matmul(dA4, dB4), {"ring": 4},
             mesh4),
            ("matmul_ta", lambda: linalg.matmul(dA4, dA4, transpose_a=True),
             {}, mesh4),
            ("matmul_tb", lambda: linalg.matmul(dA4, dA4, transpose_b=True),
             {}, mesh4),
            ("gram", lambda: linalg.gram(dA22), {}, mesh22),
            ("covariance", lambda: linalg.covariance(dA4), {}, mesh4),
            ("pairwise_sq_dists",
             lambda: linalg.pairwise_sq_dists(dA4, g["A1"][:3]), {}, mesh4),
            ("lstsq", lambda: linalg.lstsq(dT, g["b7"], tol=1e-7), None,
             mesh4),
            ("rsvd", lambda: linalg.rsvd(dm(g["A9"], mesh4), 5, n_iter=4),
             None, mesh4))
    for name, fn, pin, mesh in runs:
        rep = colan.verify_program(
            lambda: got.__setitem__(name, fn()), mesh=mesh.shape,
            group=world, execute=True, subject=name)
        if name == "lstsq":
            pin = {"iterations": got[name].iterations}
        if pin is not None:
            rep.extend(colan.linalg_contract(name, **pin).check(
                rep.signature))
        out[name] = {"codes": rep.codes(), "ok": rep.ok,
                     "counts": rep.signature.counts(),
                     "wire": rep.signature.wire_bytes(),
                     "ranks_agree": len(set(map(tuple,
                                                rep.rank_signatures))) == 1}
    out["lstsq"]["iterations"] = got["lstsq"].iterations
    out["record_only"] = {
        "summa2d": linalg.collective_counts(
            lambda: linalg.matmul(dA22, dB22)),
        "gram2d": linalg.collective_counts(lambda: linalg.gram(dA22)),
        "gram_rows": linalg.collective_counts(
            lambda: linalg.gram(dm(g["A1"], mesh22, D)))}
    return out


def _linalg_placement(g, mesh22, mesh4, dm, device):
    """Blocks, metadata, replicate, INDArray.distribute, and the capture
    refusals of multi-rank entries."""
    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.linalg import distributed as LD
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    dA = dm(g["A1"], mesh22, "data", "model")
    out = {"coords": dict(mesh22.coords), "block": dA.tensor().numpy(),
           "block_shape": dA.block_shape(),
           "per_chip_bytes": dA.per_chip_bytes(),
           "whole": dA.toNumpy()}
    r = dm(g["A2"], mesh4).replicate()
    out["replicated"], out["replicate"] = r.is_replicated(), r.toNumpy()
    G = linalg.gram(Nd4j.create(g["A4"], device=device).distribute(mesh4))
    out["distribute_gram"] = G.toINDArray().toNumpy()
    out["precompile"] = linalg.precompile(mesh4, 16, 8, 4, device=device)
    step = LD._entry("matmul1d", mesh4, ("data",), None)
    before = step.uncaptured
    linalg.matmul(dm(g["A1"], mesh4), dm(g["B1"], mesh4))
    out["refused_dispatches"] = step.uncaptured - before
    out["refusal"] = step.refusal
    return out


def _linalg_consumers(data, mesh4, device):
    """Sharded k-means, LSH's distributed projection and DeepWalk's mesh
    products on {data: 4}, beside the same routines unsharded."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.lsh import RandomProjectionLSH
    from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, Graph

    X = data["kmeans_X"]
    out = {}
    local = KMeansClustering.setup(3, seed=1).applyTo(X, device=device)
    shard = KMeansClustering.setup(3, seed=1, mesh=mesh4).applyTo(
        X, device=device)
    ref_first = KMeansClustering.setup(3, seed=1, mesh=mesh4).applyTo(
        X, device=device, draws=FixedDraws(first=data["kmeans_first"]))
    out["kmeans"] = {n: (c.getAssignments(), c.inertia, c.getCenters())
                     for n, c in (("local", local), ("shard", shard),
                                  ("ref_first", ref_first))}
    try:
        KMeansClustering.setup(3, seed=1, mesh=mesh4).applyTo(
            X[:90], device=device)
        out["kmeans_pad"] = "no error"
    except ValueError as e:
        out["kmeans_pad"] = str(e)
    L = data["lsh_X"]
    lsh = RandomProjectionLSH(10, 3, 6, seed=2, mesh=mesh4) \
        .load_reference_params(data["lsh_R"]).index(L, device=device)
    out["lsh"] = ([sorted(t) for t in lsh._tables], lsh.search(L[7], 5))
    g = Graph(8)
    for a in range(8):
        g.addEdge(a, (a + 1) % 8)
    dw = DeepWalk.Builder().vectorSize(8).windowSize(2).seed(1).build()
    dw.fit(g, walkLength=6, walksPerVertex=2, iterations=1, device=device)
    E = dw.embeddings()
    out["deepwalk"] = (E, dw.embeddingGram(mesh=mesh4),
                       dw.similarityMatrix(mesh=mesh4),
                       dw.similarityMatrix())
    return out


def linalg_rank(rank, world, device, data):
    """The linalg tier on {data: 2, model: 2} and {data: 4}: every
    routine in f64 and f32 (``data["inputs"]``), the contracts, the
    placement, and the consumers."""
    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.parallel import build_mesh

    torch.set_num_threads(1)
    mesh22 = build_mesh({"data": 2, "model": 2})
    mesh4 = build_mesh({"data": 4})

    def dm(a, mesh, r="data", c=None):
        return linalg.DistributedMatrix(a, mesh, r, c, device=device)

    out = {}
    for tag, dt in (("f64", np.float64), ("f32", np.float32)):
        g = {k: v.astype(dt) for k, v in data["inputs"].items()}
        out[tag] = _linalg_values(g, data, tag, mesh22, mesh4, dm)
    g32 = {k: v.astype(np.float32) for k, v in data["inputs"].items()}
    out["contracts"] = _linalg_contracts(g32, mesh22, mesh4, dm)
    out["placement"] = _linalg_placement(g32, mesh22, mesh4, dm, device)
    out["consumers"] = _linalg_consumers(data, mesh4, device)
    return out
