"""Pipeline parallelism: the port's executing ``PipelineParallel``
(deeplearning4j_tpu_torch/parallel/pipeline.py) against the reference's
(deeplearning4j_tpu/parallel/pipeline.py), and ``hybrid_mesh``'s layout.

The reference's own tests (tests/test_parallel.py ``TestPipelineParallel``
:303 and ``TestPipelineRegressions`` :405) run its GPipe schedule over
a "pipe" axis of the virtual 8-device CPU mesh; here the reference runs
``{"pipe": 4}`` (3 steps) and ``{"data": 2, "pipe": 4}`` (2 steps) and
single-device ``fit`` in this process, and the port runs four gloo ranks
(``parallel.launch``; rank body ``pp_rank`` in
tests/_torch_parallel_ranks.py) from the reference's initial weights:
``{"pipe": 4}`` 3 steps, ``{"data": 2, "pipe": 2}`` 2 steps, 30 steps of
convergence, the MaxNorm-constrained net, and the refusals.

Bars: the reference test's rtol 1e-4 / atol 1e-5 against single-device
``fit`` (the reference's and the port's) and against the reference's
pipeline; scores within 1e-4; the params bitwise equal on every rank
after ``sync_to_net``; convergence and the constraint as the reference
states them; the refusals' messages the reference's.
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
from deeplearning4j_tpu.parallel import (
    PipelineParallel as JPP, build_mesh as jbuild_mesh,
    partition_stages as jpartition,
)

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.nn import (
    DenseLayer, Dropout, InputType, MultiLayerNetwork,
    NeuralNetConfiguration, OutputLayer, Sgd,
)
from deeplearning4j_tpu_torch.parallel import (
    PipelineParallel, build_mesh, launch, partition_stages,
)
from deeplearning4j_tpu_torch.parallel.multihost import hybrid_rank_grid

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0
BAR = dict(rtol=1e-4, atol=1e-5)


def j_deep_mlp(seed=5, H=32):
    b = (J.NeuralNetConfiguration.Builder()
         .seed(seed).updater(J.Sgd(0.05)).activation("tanh").list()
         .layer(J.DenseLayer(nOut=H)))
    for _ in range(4):
        b = b.layer(J.DenseLayer(nOut=H))
    return J.MultiLayerNetwork(
        b.layer(J.OutputLayer(nOut=3, activation="softmax"))
        .setInputType(J.InputType.feedForward(4)).build()).init()


def jflat(tree):
    return {f"{k}.{n}": np.asarray(v, np.float64)
            for k, p in enumerate(tree) for n, v in p.items()}


@pytest.fixture(scope="module")
def reference():
    x, y, _ = R.pp_data(64)
    net = j_deep_mlp()
    init = (jax.tree_util.tree_map(np.asarray, net._params),
            jax.tree_util.tree_map(np.asarray, net._states))
    out = {"init": init}
    for steps in (2, 3):
        single = j_deep_mlp()
        for _ in range(steps):
            single.fit(x, y)
        out[f"single{steps}"] = (jflat(single._params), single.score())
    for key, axes, steps in (("pp4", {"pipe": 4}, 3),
                             ("dp2pp4", {"data": 2, "pipe": 4}, 2)):
        net = j_deep_mlp()
        pp = JPP(net, jbuild_mesh(axes), n_microbatches=4)
        for _ in range(steps):
            pp.fit(x, y)
        out[key] = (jflat(net._params), net.score())
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return launch(R.pp_rank, 4, device="cpu", timeout=LAUNCH_TIMEOUT,
                  args=({"pp_mlp": reference["init"]},))


def assert_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BAR)


# ----------------------------------------------------------------------
# TestPipelineParallel
# ----------------------------------------------------------------------

def test_partition_stages():
    net = MultiLayerNetwork(R.pp_mlp_conf(), device="cpu").init()
    assert partition_stages(net.layers, net._params, 4) == (
        [0], [1, 2, 3, 4], [5])


def test_partition_rejects_heterogeneous():
    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
            .list().layer(DenseLayer(nOut=16)).layer(DenseLayer(nOut=8))
            .layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="identical"):
        partition_stages(net.layers, net._params, 4)


def test_pipeline_matches_single_device(ranks, reference):
    """3 steps on {pipe: 4}: the params within the reference test's bar
    of single-device fit (the reference's) and of the reference's own
    pipeline, on every rank, bitwise equal across the ranks."""
    want, score = reference["single3"]
    for r in ranks:
        got = r["pp4"]
        assert_params(got["params"], want)
        assert_params(got["params"], reference["pp4"][0])
        assert abs(got["scores"][-1] - score) < 1e-4
        assert got["replicated"]


def test_pipeline_signature_passes_the_collective_checks(ranks):
    """A record-only pipelined step (verify_program): equal on every
    rank, over the "pipe" axis only, its shifts open-ended permutations
    (COL06), the params put back as they were."""
    for r in ranks:
        p = r["pp4"]
        assert p["signature_errors"] == [] and p["held"]
        assert {a for _, axes, _ in p["signature"] for a in axes} == {"pipe"}
        perms = [perm for op, _, perm in p["signature"] if op == "ppermute"]
        assert perms and all(perm in ([(0, 1), (1, 2), (2, 3)],
                                      [(1, 0), (2, 1), (3, 2)])
                             for perm in perms)


def test_pipeline_composes_with_dp(ranks, reference):
    """2 steps on {data: 2, pipe: 2} (the reference's {data: 2, pipe: 4}
    takes 8 devices): single-device fit's params."""
    want, _ = reference["single2"]
    for r in ranks:
        assert_params(r["dp2pp2"]["params"], want)
        assert_params(r["dp2pp2"]["params"], reference["dp2pp4"][0])
        assert r["dp2pp2"]["replicated"]


def test_pipeline_converges(ranks):
    scores = ranks[0]["converge"]
    assert scores[-1] < 0.7 * scores[0]


def test_bad_microbatch_divisibility(ranks):
    x, y, _ = R.pp_data(30)
    net = j_deep_mlp()
    with pytest.raises(ValueError, match="divisible") as want:
        JPP(net, jbuild_mesh({"pipe": 4}), n_microbatches=4).fit(x, y)
    for r in ranks:
        assert r["errors"]["divisible"] == str(want.value)


def test_refusals_name_the_reference_messages(ranks):
    with pytest.raises(ValueError) as want:
        JPP(j_deep_mlp(), jbuild_mesh({"pipe": 4}), n_microbatches=0)
    for r in ranks:
        assert r["errors"]["microbatches"] == str(want.value)
        assert "persistent state" in r["errors"]["stateful"]
        assert r["errors"]["stateful"].startswith(
            "Layer 1 (BatchNormalization)")
    with pytest.raises(ValueError, match="mesh has no 'pipe' axis"):
        PipelineParallel(None, build_mesh({"data": 1}))


# ----------------------------------------------------------------------
# TestPipelineRegressions
# ----------------------------------------------------------------------

def test_equal_dropout_objects_are_homogeneous():
    b = (NeuralNetConfiguration.Builder().seed(5).updater(Sgd(0.05))
         .activation("tanh").list().layer(DenseLayer(nOut=16)))
    for _ in range(4):
        b = b.layer(DenseLayer(nOut=16, dropOut=Dropout(0.9)))
    conf = (b.layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert partition_stages(net.layers, net._params, 4)[1] == [1, 2, 3, 4]


def test_heterogeneous_activation_rejected():
    b = (NeuralNetConfiguration.Builder().seed(5).updater(Sgd(0.05))
         .list().layer(DenseLayer(nOut=16, activation="tanh")))
    for i in range(4):
        b = b.layer(DenseLayer(nOut=16,
                               activation="relu" if i % 2 else "tanh"))
    conf = (b.layer(OutputLayer(nOut=3, activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="identical"):
        partition_stages(net.layers, net._params, 4)
    jnet = j_deep_mlp()
    assert jpartition(jnet.layers, jnet._params, 4) == partition_stages(
        MultiLayerNetwork(R.pp_mlp_conf(), device="cpu").init().layers,
        MultiLayerNetwork(R.pp_mlp_conf(), device="cpu").init()._params, 4)


def test_pipeline_applies_constraints(ranks):
    """5 steps at Sgd(0.5) under MaxNormConstraint(0.3): every column's
    norm stays within the bound, as under fit."""
    for r in ranks:
        assert r["max_norm"] <= 0.3 + 1e-4


# ----------------------------------------------------------------------
# TestMultiHost: hybrid_mesh's layout, a pure function
# ----------------------------------------------------------------------

def test_hybrid_mesh_single_slice_fallback():
    grid = hybrid_rank_grid({"data": 2}, {"model": 4}, [list(range(8))])
    assert grid.shape == (2, 4)
    # ici axis innermost: each model group is 4 contiguous ranks
    assert grid.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_hybrid_mesh_multi_slice_keeps_ici_in_slice():
    nodes = [[0, 1, 2, 3], [4, 5, 6, 7]]
    grid = hybrid_rank_grid({"data": 2}, {"model": 4}, nodes)
    for row, node in zip(grid, nodes):
        assert sorted(row.tolist()) == node
    assert hybrid_rank_grid({"data": 2}, {"model": 2, "seq": 2},
                            nodes).shape == (2, 2, 2)


def test_hybrid_mesh_errors_are_the_references():
    with pytest.raises(ValueError, match="devices|slices"):
        hybrid_rank_grid({"data": 16}, {"model": 4}, [list(range(8))])
    with pytest.raises(ValueError, match="cover"):
        hybrid_rank_grid({"data": 2}, {}, [[0, 1, 2, 3], [4, 5, 6, 7]])
