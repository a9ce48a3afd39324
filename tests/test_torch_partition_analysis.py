"""The port's partition-plan pass (``analysis/partitioning.py``) and its
planning functions (``parallel.sharding.spec_for_param``,
``parallel.pipeline.partition_stages``) against the reference's
(``tests/test_partition_analysis.py``).

- Parity: each plan (data, model and pipe meshes, explicit specs,
  ShardingPlan options, budgets far below and far above the need) gives
  the same PAR01-06 codes and severities at the same places in both
  packages; the trainer-path lint is compared separately, on the
  reference's snippets.
- PAR06 is the port's own model: its bytes are a stated deviation, so
  the tests hold the codes, and hold the model to what it claims: the
  meta step's count equals the same count over the same step run on
  CPU tensors, parameters and Adam state are counted exactly, the
  per-card batch shrinks the step, a budget below the need raises at
  ``init(validate=True, hbm_gb=...)`` before any parameter exists, and
  the budget defaults to the card's memory.
"""

import textwrap

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.analysis import ShardingPlan as RefPlan
from deeplearning4j_tpu.analysis import check_collectives as ref_cc
from deeplearning4j_tpu.analysis import validate_plan as ref_plan
from deeplearning4j_tpu.parallel.pipeline import \
    partition_stages as ref_partition
from deeplearning4j_tpu.parallel.sharding import \
    spec_for_param as ref_spec
from deeplearning4j_tpu_torch.analysis import (
    ConfigValidationError, ShardingPlan, check_collectives, validate_plan,
)
from deeplearning4j_tpu_torch.analysis.partitioning import (
    _LiveBytes, normalize_mesh, pipeline_balance, step_high_water,
)
from deeplearning4j_tpu_torch.parallel import partition_stages, \
    spec_for_param

from _torch_analysis_snippets import snippets

torch.set_num_threads(1)

DP4TP2 = {"data": 4, "model": 2}
DP2PP4 = {"data": 2, "pipe": 4}


def _mlp(n, widths=(32, 10), nIn=16, updater=None):
    b = n.NeuralNetConfiguration.Builder()
    if updater is not None:
        b = b.updater(updater(n))
    b = b.list()
    for w in widths[:-1]:
        b.layer(n.DenseLayer(nOut=w, activation="relu"))
    b.layer(n.OutputLayer(nOut=widths[-1], activation="softmax"))
    return b.setInputType(n.InputType.feedForward(nIn)).build()


def _stack(n, n_body, width=64, nIn=16, nOut=4):
    b = (n.NeuralNetConfiguration.Builder().list()
         .layer(n.DenseLayer(nOut=width, activation="relu")))
    for _ in range(n_body):
        b.layer(n.DenseLayer(nOut=width, activation="relu"))
    b.layer(n.OutputLayer(nOut=nOut, activation="softmax"))
    return b.setInputType(n.InputType.feedForward(nIn)).build()


def _cnn(n):
    from importlib import import_module

    L = import_module(n.__name__ + ".conf.layers")
    return (n.NeuralNetConfiguration.Builder().list()
            .layer(L.ConvolutionLayer(nOut=64, kernelSize=(3, 3)))
            .layer(L.ConvolutionLayer(nOut=1025, kernelSize=(1, 1)))
            .layer(n.OutputLayer(nOut=10, activation="softmax"))
            .setInputType(n.InputType.convolutional(12, 12, 3)).build())


#: name -> (conf of a package, mesh, plan kwargs, batch, hbm_gb)
CASES = {
    "dp_only_clean": (lambda n: _mlp(n), {"data": 8}, None, 32, None),
    "par01_plan_axis": (lambda n: _mlp(n), DP4TP2,
                        {"model_axis": "tensor"}, 32, None),
    "par01_param_axis": (lambda n: _mlp(n), DP4TP2,
                         {"param_specs": {"0.W": (None, "ghost")}}, 32,
                         None),
    "par01_pipeline_placement": (
        lambda n: _stack(n, 8), DP2PP4,
        {"param_specs": {"9.W": ("bogus_axis",)}}, 32, None),
    "par01_axis_twice": (lambda n: _mlp(n), DP4TP2,
                         {"param_specs": {"0.W": ("model", "model")}}, 32,
                         None),
    "par01_nonpositive": (lambda n: _mlp(n), {"data": 0}, None, 32, None),
    "par02_rank": (lambda n: _mlp(n), DP4TP2,
                   {"param_specs": {"0.W": (None, None, "model")}}, 32,
                   None),
    "par03_explicit": (lambda n: _mlp(n, (33, 10)), DP4TP2,
                       {"param_specs": {"0.W": (None, "model")}}, 32,
                       None),
    "par03_default": (lambda n: _mlp(n, (513, 10), nIn=256), DP4TP2, None,
                      32, None),
    "par03_batch": (lambda n: _mlp(n), DP4TP2, None, 30, None),
    "par03_conv_default": (_cnn, DP4TP2, None, 32, None),
    "par03_zero_update": (lambda n: _mlp(n, (257, 10), nIn=256),
                          {"data": 2},
                          {"weight_update": "sharded"}, 32, None),
    "par03_microbatches": (lambda n: _stack(n, 8), DP2PP4,
                           {"microbatches": 3}, 32, None),
    "par05_balanced": (lambda n: _stack(n, 8), DP2PP4, None, 32, None),
    "par05_skewed": (lambda n: _stack(n, 4, width=8, nIn=4096), DP2PP4,
                     None, 32, None),
    "par05_not_pipelineable": (lambda n: _mlp(n), DP2PP4, None, 32, None),
    "par06_over": (lambda n: _mlp(n, (4096, 10), nIn=4096), {"data": 2},
                   None, 32, 0.0001),
    "par06_far_under": (lambda n: _mlp(n, (4096, 10), nIn=4096),
                        {"data": 2}, None, 32, 1e6),
    "compressed_plan": (lambda n: _mlp(n), {"data": 4},
                        {"gradient_compression": "int8"}, 32, None),
}


def _summary(rep):
    return sorted((d.code, d.severity, d.where) for d in rep.diagnostics)


@pytest.mark.parametrize("name", sorted(CASES))
def test_validate_plan_matches_the_reference(name):
    conf, mesh, plan, batch, hbm = CASES[name]
    want = ref_plan(conf(J), mesh, plan=None if plan is None
                    else RefPlan(**plan), batchSize=batch, hbm_gb=hbm,
                    check_trainers=False)
    got = validate_plan(conf(P), mesh, plan=None if plan is None
                        else ShardingPlan(**plan), batchSize=batch,
                        hbm_gb=hbm, check_trainers=False)
    strip = {"PAR06"} if hbm is None else set()
    assert [d for d in _summary(got) if d[0] not in strip] == [
        d for d in _summary(want) if d[0] not in strip], (
        got.format(), want.format())


def test_plan_refusals_match():
    for kw in ({"weight_update": "zero"},
               {"gradient_compression": "nope"},
               {"gradient_compression": "threshold",
                "weight_update": "sharded"},
               {"compression_group": 4, "gradient_compression": "int8"}):
        with pytest.raises(ValueError):
            RefPlan(**kw)
        with pytest.raises(ValueError):
            ShardingPlan(**kw)


def test_mesh_forms():
    assert normalize_mesh("data=4,model=2") == DP4TP2
    assert normalize_mesh(DP4TP2) == DP4TP2
    from deeplearning4j_tpu_torch.parallel import DataGroup

    assert normalize_mesh(DataGroup(0, 4)) == {"data": 4}
    with pytest.raises(ValueError):
        normalize_mesh("data:4")


@pytest.mark.parametrize("shape", [(512, 256), (1024,), (10, 10),
                                   (3, 3, 64, 128), (4, 4, 4)])
def test_spec_for_param_is_the_references_rule(shape):
    want = tuple(ref_spec("W", shape))
    if len(shape) == 4:       # the port's kernels are OIHW: out first
        o = (shape[3], shape[2], shape[0], shape[1])
        got = spec_for_param("W", o)
        assert (got[0],) + tuple(got[1:]) == (
            (want[3],) + want[:3] if want else ())
    else:
        assert spec_for_param("W", shape) == want


def test_partition_stages_is_the_references():
    for n_body, stages in ((8, 4), (4, 2), (6, 4), (3, 2)):
        jc, pc = _stack(J, n_body), _stack(P, n_body)
        jn = J.MultiLayerNetwork(jc).init()
        pn = P.MultiLayerNetwork(pc, device="cpu").init()
        from deeplearning4j_tpu.parallel.pipeline import \
            stage_input_sizes as ref_sizes
        from deeplearning4j_tpu_torch.parallel.pipeline import \
            stage_input_sizes

        assert partition_stages(pn.layers, pn._params, stages,
                                stage_input_sizes(pc)) == ref_partition(
            jn.layers, jn._params, stages, ref_sizes(jc))
    with pytest.raises(ValueError, match="homogeneous"):
        partition_stages(pn.layers, pn._params, 8, stage_input_sizes(pc))


def test_pipeline_parallel_waits_for_item_7():
    """PipelineParallel executes the pipe plans PAR05 checks
    (tests/test_torch_pipeline_parallel.py); on a mesh with no pipe axis
    it refuses with the reference's message."""
    from deeplearning4j_tpu.parallel import PipelineParallel as RefPP
    from deeplearning4j_tpu.parallel.mesh import build_mesh as ref_mesh
    from deeplearning4j_tpu_torch.parallel import PipelineParallel, build_mesh

    with pytest.raises(ValueError) as want:
        RefPP(None, ref_mesh({"data": 8}))
    with pytest.raises(ValueError) as got:
        PipelineParallel(None, build_mesh({"data": 1}))
    assert str(got.value) == str(want.value)


def test_balance_numbers_match_the_reference():
    from deeplearning4j_tpu.analysis import validate_model as ref_vm
    from deeplearning4j_tpu.analysis.partitioning import \
        pipeline_balance as ref_balance
    from deeplearning4j_tpu_torch.analysis import validate_model

    jc, pc = _stack(J, 4, width=32), _stack(P, 4, width=32)
    want = ref_balance(jc, ref_vm(jc, batchSize=8).layers, 2, 8)
    got = pipeline_balance(pc, validate_model(pc, batchSize=8).layers, 2, 8)
    assert got == want


# ----------------------------------------------------------------------
# PAR04
# ----------------------------------------------------------------------

_SNIPPETS = snippets("test_partition_analysis.py")


@pytest.mark.parametrize("i", range(len(_SNIPPETS)))
def test_reference_snippets_give_the_same_par04(i):
    src = _SNIPPETS[i]
    for axes in (DP4TP2, DP2PP4, {"data": 8}):
        want = _summary(ref_cc(src, axes, path="s.py"))
        got = _summary(check_collectives(src, axes, path="s.py"))
        assert got == want, src


def test_group_strings_handed_to_the_choke_point_are_checked():
    src = textwrap.dedent('''
        from deeplearning4j_tpu_torch.parallel import collectives as C

        AX = "model"

        def step(t, g):
            C.all_reduce(t, "data")
            C.all_gather(t, group=AX)
            C.int8_lane_sum(t, "seq")
    ''')
    rep = check_collectives(src, {"data": 4}, path="s.py")
    assert sorted(int(d.where.split(":")[1]) for d in rep.errors) == [8, 9]


def test_the_ports_trainer_paths_are_clean_on_the_canonical_meshes():
    for mesh in (DP4TP2, DP2PP4, {"data": 8}):
        rep = validate_plan(_mlp(P), mesh, batchSize=32)
        assert not [d for d in rep.diagnostics if d.code == "PAR04"], \
            rep.format()


# ----------------------------------------------------------------------
# PAR06: the port's own high-water model
# ----------------------------------------------------------------------

def _live_count_on_cpu(conf, B):
    """The same count over the same step, run on CPU tensors."""
    from deeplearning4j_tpu_torch.analysis.shapes import _leaves

    net = P.MultiLayerNetwork(conf, device="cpu").init()
    x = torch.randn(B, conf.inputType.size)
    y = torch.eye(conf.layers[-1].nOut)[torch.arange(B) %
                                        conf.layers[-1].nOut]
    resident = _leaves(net._params) + _leaves(net._states) \
        + _leaves(net._upd_states) + [x, y]
    with _LiveBytes([t.untyped_storage()._cdata for t in resident]) as lb:
        net._train_step(x, y, None, None, iteration=0)
    return lb.peak


@pytest.mark.parametrize("updater", ["Sgd", "Adam", "Nesterovs"])
def test_the_meta_step_counts_what_the_cpu_step_allocates(updater):
    def upd(n):
        return getattr(n, updater)(1e-2)

    conf = _mlp(P, (64, 32, 10), nIn=48, updater=upd)
    meta = step_high_water(conf, 16)
    assert meta["step_peak_bytes"] == _live_count_on_cpu(conf, 16)
    n = 48 * 64 + 64 + 64 * 32 + 32 + 32 * 10 + 10
    assert meta["params_bytes"] >= 4 * n
    from deeplearning4j_tpu_torch.analysis.partitioning import _nbytes
    from deeplearning4j_tpu_torch.analysis.shapes import _leaves

    real = P.MultiLayerNetwork(conf, device="cpu").init()
    mem = validate_plan(conf, {"data": 1}, batchSize=16).plan["memory"]
    assert mem["optimizer_state_bytes"] == _nbytes(
        _leaves(real._upd_states))
    assert mem["params_bytes"] == _nbytes(_leaves(real._params))


def test_the_step_shrinks_with_the_per_card_batch():
    conf = _mlp(P, (512, 10), nIn=256)
    one = validate_plan(conf, {"data": 1}, batchSize=4096).plan["memory"]
    four = validate_plan(conf, {"data": 4}, batchSize=4096).plan["memory"]
    assert four["per_card_batch"] == 1024
    assert four["step_peak_bytes"] < one["step_peak_bytes"]
    assert four["total_bytes"] < one["total_bytes"]


def test_tensor_sharding_shrinks_per_card_params():
    conf = _mlp(P, (4096, 10), nIn=4096)
    dp = validate_plan(conf, {"data": 2}).plan["memory"]
    tp = validate_plan(conf, {"data": 1, "model": 2}).plan["memory"]
    assert tp["params_bytes"] < dp["params_bytes"]


def test_near_budget_warns():
    conf = _mlp(P)
    total = validate_plan(conf, {"data": 2}).plan["memory"][
        "captured_total_bytes"]
    rep = validate_plan(conf, {"data": 2}, hbm_gb=total * 1.05 / 1e9)
    assert rep.ok and [w.code for w in rep.warnings] == ["PAR06"]


def test_the_gate_holds_the_captured_high_water():
    """A batch that fits eagerly but not captured (``precompile``) is
    refused: the gate holds the larger of the two totals."""
    conf = _mlp(P, (1024, 10), nIn=1024)
    mem = validate_plan(conf, {"data": 1}, batchSize=64).plan["memory"]
    assert mem["captured_total_bytes"] > mem["total_bytes"]
    between = (mem["total_bytes"] + mem["captured_total_bytes"]) / 2e9
    rep = validate_plan(conf, {"data": 1}, batchSize=64, hbm_gb=between)
    assert [e.code for e in rep.errors] == ["PAR06"]
    assert "(captured)" in rep.errors[0].message


def test_over_budget_raises_at_validated_init_before_any_parameter():
    conf = _mlp(P, (1024, 10), nIn=1024)
    net = P.MultiLayerNetwork(conf, device="cpu")
    with pytest.raises(ConfigValidationError) as ei:
        net.init(validate=True, hbm_gb=0.001, batchSize=64)
    assert "PAR06" in ei.value.report.codes()
    assert net._params is None


@pytest.mark.parametrize("tf32", [True, False])
def test_f32_convolutions_with_tf32_off_warn(monkeypatch, tf32):
    """cuDNN's workspaces are not counted; with TF32 off an f32
    convolution's may exceed the prediction many times over, so PAR06
    says so instead of reporting a clean fit."""
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    conf = SimpleCNN(numClasses=10, inputShape=(3, 16, 16)).conf()
    rep = validate_plan(conf, {"data": 1}, batchSize=4, hbm_gb=80)
    assert rep.ok and rep.plan["memory"] is not None
    warned = [w for w in rep.warnings if w.code == "PAR06"]
    assert len(warned) == (0 if tf32 else 1)
    if not tf32:
        assert "8 f32 convolution calls" in warned[0].message


def test_the_budget_defaults_to_the_cards_memory(monkeypatch):
    class _Props:
        total_memory = 1_000_000

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props())
    rep = validate_plan(_mlp(P, (1024, 10), nIn=1024), {"data": 1},
                        batchSize=64)
    assert [e.code for e in rep.errors] == ["PAR06"]
    assert "0.001 GB budget" in rep.errors[0].message


def test_a_step_that_does_not_run_on_meta_is_a_warning_not_clean(
        monkeypatch):
    import deeplearning4j_tpu_torch.analysis.partitioning as part

    def boom(conf, B):
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(part, "step_high_water", boom)
    rep = validate_plan(_mlp(P), {"data": 1})      # no card, no budget
    assert [w.code for w in rep.warnings] == ["PAR06"]
    assert "no meta kernel" in rep.warnings[0].message
    assert rep.plan["memory"] is None


def test_a_step_that_does_not_run_on_meta_under_a_budget_is_an_error(
        monkeypatch):
    """With a budget the fit gate cannot be off unseen: the step that
    does not run on meta is an error naming its layer, and a validated
    init raises before any parameter is drawn."""
    import deeplearning4j_tpu_torch.nn.conf.layers as L

    real = L.DenseLayer.forward

    def boom(self, params, state, x, *a, **k):
        if x.device.type == "meta":
            raise NotImplementedError("no meta kernel")
        return real(self, params, state, x, *a, **k)

    monkeypatch.setattr(L.DenseLayer, "forward", boom)
    rep = validate_plan(_mlp(P), {"data": 1}, hbm_gb=80)
    assert [e.code for e in rep.errors] == ["PAR06"]
    msg = rep.errors[0].message
    assert "no meta kernel" in msg and "layer 0 (DenseLayer)" in msg
    net = P.MultiLayerNetwork(_mlp(P), device="cpu")
    with pytest.raises(ConfigValidationError):
        net.init(validate=True, hbm_gb=80)
    assert net._params is None


def test_zoo_corpus_plans_on_the_canonical_meshes():
    from deeplearning4j_tpu_torch.analysis import zoo_corpus

    bad = {}
    for name, model in zoo_corpus()[:6]:
        for mesh in (DP4TP2, {"data": 1}):
            rep = validate_plan(model, mesh, batchSize=8, hbm_gb=80)
            if not rep.ok:
                bad[f"{name}@{mesh}"] = rep.format()
            assert rep.plan["memory"] is not None, name
    assert not bad, bad
    assert np.isfinite(len(bad))


def test_a_conf_holding_arrays_has_a_stable_fingerprint():
    """YOLO2's anchor priors are an array in its conf: its toJson
    refuses, and its capture key (so ``precompile``, and PAR06's
    captured prediction's subject) takes the arrays' bytes instead."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.runtime import aot

    def net(anchors=None):
        return zoo.YOLO2(inputShape=(3, 64, 64), numClasses=3,
                         anchors=anchors, device="cpu").init()

    with pytest.raises(ValueError, match="arrays"):
        net().conf.toJson()
    a, b = aot.network_fingerprint(net()), aot.network_fingerprint(net())
    other = aot.network_fingerprint(net(((1.0, 1.0), (2.0, 2.5))))
    assert a == b != other
    n = net()
    rep = n.precompile(batchSize=2, featuresShape=(2, 3, 64, 64),
                       labelsShape=(2, 7, 2, 2), entries=("train",))
    assert [r["status"] for r in rep.values()] == ["cold"], rep
