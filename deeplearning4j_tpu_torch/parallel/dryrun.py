"""The multi-chip dry run.

The counterpart of ``__graft_entry__.dryrun_multichip`` (:40), which
runs one sharded training step of each parallel mode on an n-device
mesh. The port runs the legs on n ranks (``multihost.launch``), each a
real step through the ranks' collectives:

* "resnet50_dp": zoo ResNet50 (8 classes, 32x32, Adam) through a dense
  ParallelWrapper at global batch 2n, BN synchronised over the ranks;
* "int8": a small MLP through SharedTrainingMaster's default int8
  all-reduce;
* "averaging": parameter averaging at averagingFrequency 2, two steps;
* "threshold": the Strom threshold exchange;
* "sync_bn": ``bn_cnn`` (conv -> BN -> relu -> conv -> BN -> softplus ->
  residual add -> global pool -> softmax, so the fused and the plain BN
  Functions are both crossed) trained dense at dp n beside the same net
  trained on the combined batch on rank 0 alone, and one int8 step held
  to the exact mean of the ranks' own gradients (``sync_bn_leg``).

and the mesh axes' legs, with the reference's shapes (:82-184 there):

* "tp": zoo ResNet50 (8 classes, 32x32, Adam 1e-3) placed by
  ``shard_params`` (``min_shard_size=4096``) on ``{data: n/2, model:
  2}`` (model 1 at odd n), one ``fit`` step at global batch 2·dp;
* "sequence": causal ``ring_attention`` forward and backward on
  ``{seq: n}`` at B 2, H 4, T 8n, D 16 (the gradient must be finite);
* "pipeline": ``PipelineParallel`` of ``tiny_mlp(body=min(4, n))`` on
  ``{data: n/pp, pipe: pp}``, 4 microbatches, one step.

and the linalg leg (:437-475 there):

* "linalg": SUMMA GEMM and the Gram of a [8dp, 8dp·tp] x [8dp·tp, 4tp]
  pair block-sharded on ``{data: dp, model: tp}`` (tp 2 at an even world
  of 4 or more, else 1), and CG least squares of a tall [32dp, 8] matrix
  row-sharded over the data axis, each against numpy at the reference's
  bars and each run under ``analysis.collectives.verify_program``
  (executed: COL01 across the ranks, COL06 on the ring) against its
  ``linalg_contract``.

Each leg checks its losses are finite and the params (whole, gathered)
bitwise equal on every rank. ``signature_leg`` (not a default leg)
records one step's collective signature for the static analyzer's COL
checks (``analysis.collectives``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel import mesh as _mesh

__all__ = ["DP_LEGS", "AXIS_LEGS", "LINALG_LEGS", "SYNC_BN_F32_ATOL", "tiny_mlp", "dryrun_multichip", "bn_cnn",
           "bn_cnn_batch", "sync_bn_leg", "params_vector", "signature_leg",
           "signature_legs"]

#: how far sync_bn_leg's dense f32 params may lie from single-device
#: training on the combined batch (sums in another order: the batch
#: statistics over ranks, the gradient all-reduce; measured 1.5e-8 on
#: two CPU ranks after 3 steps)
SYNC_BN_F32_ATOL = 1e-6
#: the legs dryrun_multichip runs by default
DP_LEGS = ("resnet50_dp", "int8", "averaging", "threshold", "sync_bn")
#: the mesh axes' legs (not run by default: ``legs=`` names them)
AXIS_LEGS = ("tp", "sequence", "pipeline")
#: the distributed linear algebra leg (not run by default either)
LINALG_LEGS = ("linalg",)
#: the reference dry run's bars against numpy: (rtol, atol)
LINALG_BARS = {"gemm": (2e-4, 1e-4), "gram": (2e-4, 2e-3),
               "lstsq": (5e-3, 5e-3)}


def params_vector(net):
    """Every parameter of `net`, flattened and concatenated, as f64 numpy
    (layers in order, names in order)."""
    from deeplearning4j_tpu_torch.parallel.trainer import _leaves

    return torch.cat([t.detach().reshape(-1).double().cpu()
                      for t in _leaves(net._params)]).numpy()


def _mlp(device, seed=7):
    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, InputType, MultiLayerNetwork, NeuralNetConfiguration,
        OutputLayer, Sgd,
    )

    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(0.05))
            .activation("tanh").list()
            .layer(DenseLayer(nOut=16))
            .layer(OutputLayer(nOut=4, activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())
    return MultiLayerNetwork(conf, device=device).init()


def bn_cnn(device, dtype="FLOAT", seed=3, lr=0.05):
    """The small BN CNN of the sync-BN leg and the tests: 3x8x8 NCHW in,
    3 classes, Sgd(lr)."""
    from deeplearning4j_tpu_torch.nn import (
        BatchNormalization, ComputationGraph, ConvolutionLayer, DataType,
        ElementWiseVertex, GlobalPoolingLayer, InputType,
        NeuralNetConfiguration, OutputLayer, Sgd,
    )

    def conv():
        return ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                convolutionMode="same",
                                activation="identity", hasBias=False)

    g = (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(lr))
         .dataType(getattr(DataType, dtype)).graphBuilder()
         .addInputs("in"))
    g.addLayer("c1", conv(), "in")
    g.addLayer("b1", BatchNormalization(activation="relu"), "c1")
    g.addLayer("c2", conv(), "b1")
    g.addLayer("b2", BatchNormalization(activation="softplus"), "c2")
    g.addVertex("add", ElementWiseVertex("add"), "b2", "b1")
    g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), "add")
    g.addLayer("out", OutputLayer(nOut=3, activation="softmax",
                                  lossFunction="mcxent"), "gap")
    conf = (g.setOutputs("out")
            .setInputTypes(InputType.convolutional(8, 8, 3)).build())
    return ComputationGraph(conf, device=device).init()


def bn_cnn_batch(batch, seed=0):
    """A seeded (x [batch, 3, 8, 8] f32, one-hot y [batch, 3]) batch."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 3, 8, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)]
    return x, y


def _equal_on_all_ranks(vec, group):
    """True when `vec` (f64 numpy) is bitwise the same on every rank."""
    t = torch.from_numpy(vec)
    if group.pg is None:
        return True
    dev = group.device or torch.device("cpu")
    allv = _coll.all_gather(t.to(dev), group).cpu()
    return bool(all(torch.equal(allv[0], v) for v in allv))


def sync_bn_leg(rank, world, device, dtype="FLOAT", steps=3, batch=None):
    """The "sync_bn" leg on one rank: `steps` dense ParallelWrapper steps
    of ``bn_cnn`` on one seeded global batch (8 rows a rank unless
    `batch`), then one SharedTrainingMaster int8 step from a fresh net.
    Returns {"dense": params after the dense steps, "single": (rank 0)
    params after the same steps of ``fit`` on the combined batch alone,
    "dense_losses", "single_losses", "replicated": dense params bitwise
    equal on every rank, "int8_grid_excess": the worst |int8 mean -
    exact mean| of the first step's gradients over scale/254, minus 1
    (<= 0 inside the grid, up to f32 rounding of the two means),
    "int8_loss"}."""
    from deeplearning4j_tpu_torch.parallel.trainer import (
        ParallelWrapper, SharedTrainingMaster, _leaves, _rebuild,
    )

    group = _mesh.data_parallel_mesh()
    lr = 0.05
    x, y = bn_cnn_batch(batch or 8 * world)
    net = bn_cnn(device, dtype, lr=lr)
    pw = ParallelWrapper(net, mesh=group)
    dense_losses = []
    for _ in range(steps):
        pw.fit(x, y)
        dense_losses.append(net.score())
    out = {"dense": params_vector(net), "dense_losses": dense_losses,
           "comm": pw.last_step}
    out["replicated"] = _equal_on_all_ranks(out["dense"], group)

    net = bn_cnn(device, dtype, lr=lr)
    master = SharedTrainingMaster(net, mesh=group)
    seen = []
    exchange = master._exchange_grads

    def spy(grads):
        seen.append((_leaves(grads), _leaves(exchange(grads))))
        return _rebuild(grads, iter(seen[-1][1]))

    master._exchange_grads = spy
    master.fit(x, y)
    worst = -math.inf
    for g, got in zip(*seen[0]):
        exact = _coll.all_reduce(g.detach().double().clone(), group) / world
        sc = _coll.all_reduce(g.detach().float().abs().max()
                              .clamp_min(1e-12).reshape(1), group, "max")
        grid = float(sc[0]) / 254.0
        worst = max(worst, float((got.double() - exact).abs().max()) / grid
                    - 1.0)
    out["int8_grid_excess"] = worst
    out["int8_loss"] = net.score()
    if rank == 0:
        single = bn_cnn(device, dtype, lr=lr)
        single_losses = []
        for _ in range(steps):
            single.fit(x, y)
            single_losses.append(single.score())
        out["single"] = params_vector(single)
        out["single_losses"] = single_losses
    return out


def signature_leg(rank, world, device, mode=None):
    """The collective signature of one data-parallel step of `mode`
    (None: dense ParallelWrapper; "int8"/"block_int8"/"threshold":
    SharedTrainingMaster) of ``bn_cnn`` on this rank: a first step
    (which also places the replicas), then one executed step under a
    recording (its signature and the wire bytes the trainer reports),
    then ``analysis.collectives.verify_program`` over a record-only step
    on every rank against the mode's contract, the int8 lane contract
    and the port's bill (the trainer's state is put back after it).
    Returns plain data: the executed and record-only signatures' keys,
    codes, wire bytes and bill, and whether the params came out of the
    record-only step as they went in (`held`) and bitwise equal on every
    rank (`replicated`)."""
    from deeplearning4j_tpu_torch.analysis import collectives as C
    from deeplearning4j_tpu_torch.parallel.trainer import (
        ParallelWrapper, SharedTrainingMaster, _leaves,
    )

    group = _mesh.data_parallel_mesh()
    net = bn_cnn(device)
    x, y = bn_cnn_batch(8 * world)
    master = (ParallelWrapper(net, mesh=group) if mode is None
              else SharedTrainingMaster(net, mesh=group,
                                        gradient_compression=mode))
    master.fit(x, y)
    with _coll.recording() as rec:
        master.fit(x, y)
    executed = C.CollectiveSignature(rec.sites)
    reported = dict(master.last_step)
    sizes = [t.numel() for t in _leaves(net._params)]
    bn = sum(1 for layer in _leaves_layers(net)
             if type(layer).__name__ == "BatchNormalization")
    stateful = bool(_leaves(net._states))
    contract = C.compression_contract(mode, len(sizes),
                                      sync_bn_layers=bn if mode is None
                                      else 0, stateful=stateful)

    k = 31 // _coll.lane_bits(world)
    before = params_vector(net)
    rep = C.verify_program(master.fit, x, y, group=group,
                           contract=contract, dp=world,
                           billed_acc_bytes=4.0 / k)
    after = params_vector(net)
    exchange = sum(s.wire_bytes for s in executed
                   if s.op in ("int8_lane_sum", "all_gather")
                   or (mode is None and s.count == sum(sizes))
                   or (mode in ("int8", "block_int8")
                       and s.reduce == "max"))
    bill = C.port_wire_bill(mode, sizes, world)
    rep.extend(C.check_bill(exchange, bill, rel=0.10,
                            where=f"{mode or 'dense'} exchange"))
    rep.extend(C.check_bill(reported["wire_bytes"],
                            executed.wire_bytes(), rel=0.0,
                            where="trainer-reported vs recorded"))
    return {"mode": mode or "dense", "executed": executed.keys(),
            "recorded_only": rep.signature.keys(),
            "codes": rep.codes(), "errors": [d.format() for d in rep.errors],
            "wire_bytes": reported["wire_bytes"],
            "recorded_wire_bytes": executed.wire_bytes(),
            "exchange_wire_bytes": exchange, "bill": bill,
            "counts": executed.counts(), "lanes": [
                s.lanes for s in executed if s.op == "int8_lane_sum"],
            "held": bool(np.array_equal(before, after)),
            "replicated": _equal_on_all_ranks(after, group)}


def signature_legs(rank, world, device, modes=(None, "int8")):
    """``signature_leg`` for each of `modes`, in one rank process."""
    return [signature_leg(rank, world, device, m) for m in modes]


def _leaves_layers(net):
    if hasattr(net, "_layer_names"):
        return [net.conf.nodes[n].payload for n in net._layer_names]
    return list(net.layers)


def _leg_resnet50_dp(rank, world, device):
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(numClasses=8, inputShape=(3, 32, 32), updater=Adam(1e-3),
                   device=device).init()
    rng = np.random.RandomState(0)
    B = 2 * world
    x = rng.rand(B, 3, 32, 32).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.randint(0, 8, B)]
    pw = ParallelWrapper(net)
    pw.fit(x, y)
    return net, pw


def _leg_small(mode):
    def leg(rank, world, device):
        from deeplearning4j_tpu_torch.parallel.trainer import (
            ParallelWrapper, ParameterAveragingTrainingMaster,
            SharedTrainingMaster,
        )

        net = _mlp(device)
        rng = np.random.RandomState(1)
        x = rng.randn(8 * world, 8).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8 * world)]
        if mode == "averaging":
            m = ParameterAveragingTrainingMaster(net, averagingFrequency=2)
            for _ in range(2):
                m.fit(x, y)
        elif mode == "threshold":
            m = ParallelWrapper(net, gradient_compression="threshold")
            m.fit(x, y)
        else:
            m = SharedTrainingMaster(net)
            assert m.gradient_compression == "int8"
            m.fit(x, y)
        return net, m
    return leg


_LEGS = {"resnet50_dp": _leg_resnet50_dp, "int8": _leg_small("int8"),
         "averaging": _leg_small("averaging"),
         "threshold": _leg_small("threshold")}


def tiny_mlp(device, body=4):
    """The reference dry run's pipeline net: Dense(8->16), `body` x
    Dense(16), softmax head of 4, Sgd(0.05), tanh, seed 7."""
    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, InputType, MultiLayerNetwork, NeuralNetConfiguration,
        OutputLayer, Sgd,
    )

    b = (NeuralNetConfiguration.Builder().seed(7).updater(Sgd(0.05))
         .activation("tanh").list().layer(DenseLayer(nOut=16)))
    for _ in range(body):
        b = b.layer(DenseLayer(nOut=16))
    conf = (b.layer(OutputLayer(nOut=4, activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())
    return MultiLayerNetwork(conf, device=device).init()


def whole_vector(net):
    """Every parameter (whole: a tensor-parallel net's blocks gathered)
    and every layer state, flattened into one f64 numpy vector."""
    from deeplearning4j_tpu_torch.nn.multilayer import _unwrap, strip_carries
    from deeplearning4j_tpu_torch.parallel.trainer import _leaves

    states = [t.detach().reshape(-1).double().cpu()
              for t in _leaves(strip_carries(net._states))]
    return torch.cat([_unwrap(net.params()).detach().double().cpu()]
                     + states).numpy()


def _leg_tp(rank, world, device):
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel.sharding import shard_params
    from deeplearning4j_tpu_torch.zoo import ResNet50

    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = _mesh.build_mesh({_mesh.DATA_AXIS: dp, _mesh.MODEL_AXIS: tp})
    net = ResNet50(numClasses=8, inputShape=(3, 32, 32), updater=Adam(1e-3),
                   device=device).init()
    shard_params(net, mesh, min_shard_size=4096)
    rng = np.random.RandomState(0)
    B = 2 * dp
    x = rng.rand(B, 3, 32, 32).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.randint(0, 8, B)]
    before = _coll.totals()
    net.fit(x, y)
    calls, _, wire = (a - b for a, b in zip(_coll.totals(), before))
    return {"loss": net.score(), "vector": whole_vector(net),
            "comm": {"collectives": calls, "wire_bytes": wire,
                     "layers": dict(net._tp.calls), "mesh": mesh.shape}}


def _leg_sequence(rank, world, device):
    from deeplearning4j_tpu_torch.parallel.sequence import ring_attention

    mesh = _mesh.build_mesh({_mesh.SEQ_AXIS: world})
    g = _mesh.axis_group(mesh, _mesh.SEQ_AXIS)
    B, H, T, D = 2, 4, 8 * world, 16
    q = torch.from_numpy(np.random.RandomState(0).randn(B, H, T, D)
                         .astype(np.float32))
    Tl = T // world
    ql = q[:, :, g.rank * Tl:(g.rank + 1) * Tl].to(device) \
        .requires_grad_(True)
    loss = (ring_attention(ql, ql, ql, mesh, causal=True) ** 2).sum()
    loss.backward()
    total = _coll.all_reduce(loss.detach().reshape(1).clone(), g)
    finite = bool(torch.isfinite(ql.grad).all())
    return {"loss": float(total[0]) if finite else math.nan,
            "vector": np.zeros(1), "comm": {"grad_finite": finite}}


def _leg_pipeline(rank, world, device):
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel

    pp = min(4, world)
    dp = world // pp
    mesh = _mesh.build_mesh({_mesh.DATA_AXIS: dp, _mesh.PIPE_AXIS: pp})
    net = tiny_mlp(device, body=pp)
    x = np.random.RandomState(1).randn(8 * dp, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[
        np.random.RandomState(2).randint(0, 4, 8 * dp)]
    trainer = PipelineParallel(net, mesh, n_microbatches=4)
    trainer.fit(x, y)
    return {"loss": net.score(), "vector": whole_vector(net),
            "comm": dict(trainer.last_step, mesh=mesh.shape)}


def _leg_linalg(rank, world, device):
    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.analysis import collectives as _colan

    tp = 2 if world % 2 == 0 and world >= 4 else 1
    dp = world // tp
    mesh = _mesh.build_mesh({_mesh.DATA_AXIS: dp, _mesh.MODEL_AXIS: tp})
    group = _mesh.data_parallel_mesh()
    rng = np.random.RandomState(9)
    A = rng.randn(8 * dp, 8 * dp * tp).astype(np.float32)
    B = rng.randn(8 * dp * tp, 4 * tp).astype(np.float32)
    At = rng.randn(32 * dp, 8).astype(np.float32)
    bt = rng.randn(32 * dp).astype(np.float32)
    dA, dB = (linalg.DistributedMatrix(m, mesh, _mesh.DATA_AXIS,
                                       _mesh.MODEL_AXIS, device=device)
              for m in (A, B))
    dA1 = linalg.DistributedMatrix(At, mesh, _mesh.DATA_AXIS,
                                   device=device)
    got, comm = {}, {}
    runs = (("gemm", lambda: linalg.matmul(dA, dB),
             _colan.linalg_contract("matmul2d", ring=tp)),
            ("gram", lambda: linalg.gram(dA),
             _colan.linalg_contract("gram")),
            ("lstsq", lambda: linalg.lstsq(dA1, bt, tol=1e-7), None))
    for name, fn, contract in runs:
        rep = _colan.verify_program(
            lambda: got.__setitem__(name, fn()), mesh=mesh.shape,
            group=group if world > 1 else None, contract=contract,
            execute=True, subject=f"linalg.{name}")
        if name == "lstsq":
            rep.extend(_colan.linalg_contract(
                "lstsq", iterations=got[name].iterations).check(
                    rep.signature))
        if world > 1 and not rep.ok:
            raise AssertionError(rep.format())
        comm[name] = rep.signature.counts()
    res = got["lstsq"]
    if not res.converged:
        raise AssertionError(f"lstsq CG did not converge (residual "
                             f"{res.residual_norm})")
    C, G = got["gemm"].toNumpy(), got["gram"].toNumpy()
    x = res.x.cpu().numpy()
    for name, have, want in (("gemm", C, A @ B), ("gram", G, A.T @ A),
                             ("lstsq", x,
                              np.linalg.lstsq(At, bt, rcond=None)[0])):
        rtol, atol = LINALG_BARS[name]
        np.testing.assert_allclose(have, want, rtol=rtol, atol=atol,
                                   err_msg=f"sharded {name} diverged "
                                           "from numpy")
    comm.update(mesh=mesh.shape, cg_iterations=res.iterations)
    return {"loss": res.residual_norm,
            "vector": np.concatenate([C.ravel(), G.ravel(),
                                      x.ravel()]).astype(np.float64),
            "comm": comm}


_AXIS_LEGS = {"tp": _leg_tp, "sequence": _leg_sequence,
              "pipeline": _leg_pipeline, "linalg": _leg_linalg}


def _dryrun_rank(rank, world, device, legs):
    group = _mesh.data_parallel_mesh()
    out = {}
    for name in legs:
        if name in _AXIS_LEGS:
            r = _AXIS_LEGS[name](rank, world, device)
            out[name] = {"loss": r["loss"], "comm": r["comm"],
                         "replicated": _equal_on_all_ranks(r["vector"],
                                                           group)}
            continue
        if name == "sync_bn":
            r = sync_bn_leg(rank, world, device, steps=2)
            out[name] = {"loss": r["dense_losses"][-1],
                         "replicated": r["replicated"],
                         "int8_grid_excess": r["int8_grid_excess"]}
            if rank == 0:
                out[name]["max_abs_vs_single"] = float(
                    np.abs(r["dense"] - r["single"]).max())
            continue
        net, master = _LEGS[name](rank, world, device)
        vec = params_vector(net)
        out[name] = {"loss": net.score(),
                     "replicated": _equal_on_all_ranks(vec, group),
                     "comm": master.last_step}
    return out


def dryrun_multichip(n_devices, device=None, legs=DP_LEGS, timeout=600.0,
                     backend=None):
    """Run `legs` (the data-parallel legs by default; "tp", "sequence",
    "pipeline" and "linalg" when named) on `n_devices` ranks
    (``multihost.launch``; `device` None means the cards, NCCL; `backend`
    as ``launch`` takes it). Raises unless every leg's loss is finite and
    its params are equal on every rank; returns rank 0's results."""
    from deeplearning4j_tpu_torch.parallel.multihost import launch

    legs = tuple(legs)
    known = DP_LEGS + AXIS_LEGS + LINALG_LEGS
    unknown = [leg for leg in legs if leg not in known]
    if unknown:
        raise ValueError(f"unknown dry-run legs {unknown}; pick from "
                         f"{known}")
    results = launch(_dryrun_rank, int(n_devices), device=device,
                     backend=backend, timeout=timeout, args=(legs,))
    for rank, res in enumerate(results):
        for name, r in res.items():
            if not math.isfinite(r["loss"]):
                raise RuntimeError(f"dry run {name}: rank {rank} loss "
                                   f"{r['loss']}")
            if not r["replicated"]:
                raise RuntimeError(f"dry run {name}: params differ "
                                   "between ranks")
    return results[0]
