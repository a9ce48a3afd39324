"""The memory-traffic ledger (``util/hbm_ledger.py``, ``analysis/hbm.py``)
against the reference's, on the CPU: ``train_step_floor``,
``static_memory_terms`` and ``boundary_activation_elems`` equal the
reference's for its two attribution subjects (``build_subject("lenet")``
and ``("resnet_block")``, bf16), the arithmetic being the model's, not
the compiler's. The ledger itself is the port's own count (each aten
op's bytes as one step dispatches them): its total equals
``util.profiler.compiled_cost``'s for the same step, and the attribution
puts every byte in exactly one bin, so the bins sum to that total, the
port's oracle where the reference's XLA cross-check
(``test_lenet_step_matches_xla_cost_analysis``) is its own red test. The
dtype audit is clean under the default BN and loss tails and flags the
wide BN tail.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.analysis import hbm as ref_hbm
from deeplearning4j_tpu.util import hbm_ledger as ref_ledger
from deeplearning4j_tpu_torch.analysis import hbm
from deeplearning4j_tpu_torch.ops import norm as N
from deeplearning4j_tpu_torch.util import hbm_ledger as H
from deeplearning4j_tpu_torch.util.profiler import compiled_cost

torch.set_num_threads(1)

B = 8


@pytest.fixture(scope="module", params=hbm.SUBJECTS)
def pair(request):
    name = request.param
    rnet, rshape, rslots = ref_hbm.build_subject(name, batch_size=B)
    pnet, pshape, pslots = hbm.build_subject(name, batch_size=B,
                                             device="cpu")
    return name, (rnet, rshape, rslots), (pnet, pshape, pslots)


def test_subjects_are_the_references(pair):
    _, (rnet, rshape, rslots), (pnet, pshape, pslots) = pair
    assert tuple(rshape) == tuple(pshape) and rslots == pslots
    assert sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(rnet._params)) \
        == sum(t.numel() for t in H._params_list(pnet))


def test_boundary_activation_elems_equal_the_references(pair):
    _, (rnet, rshape, _), (pnet, pshape, _) = pair
    assert H.boundary_activation_elems(pnet, pshape) \
        == ref_ledger.boundary_activation_elems(rnet, rshape)


@pytest.mark.parametrize("slots", [1, 2])
def test_train_step_floor_equals_the_references(pair, slots):
    _, (rnet, rshape, _), (pnet, pshape, _) = pair
    assert H.train_step_floor(pnet, pshape, slots) \
        == ref_ledger.train_step_floor(rnet, rshape, slots)


@pytest.mark.parametrize("args", [
    (1000, 2000, 4096, 2, 4), (1000, 0, 4096, 4, 4, 512),
    (3, 6, 7, 2, 4, 0, 2, 2.5), (10, 20, 0, 2, 4, 0, None, 0.5)])
def test_static_memory_terms_equal_the_references(args):
    assert H.static_memory_terms(*args) \
        == ref_ledger.static_memory_terms(*args)
    with pytest.raises(ValueError):
        H.static_memory_terms(1, 1, 1, 2, 4, weight_update_sharding=0)


def test_static_memory_for_a_net_uses_the_references_terms(pair):
    _, _, (pnet, pshape, _) = pair
    got = H.static_memory_for(pnet, pshape)
    P = sum(t.numel() for t in H._params_list(pnet))
    assert got["params_bytes"] == 4 * P
    assert got["params_cast_copy_bytes"] == 2 * P
    assert got["activations_bytes"] == 2 * sum(
        H.boundary_activation_elems(pnet, pshape))


def test_ledger_total_is_compiled_costs_and_the_bins_sum_to_it(pair):
    from deeplearning4j_tpu_torch.runtime.autotune import _step_args

    _, _, (net, shape, slots) = pair
    rows = H.record_step(net, shape)
    led = H.ledger(rows)
    args = _step_args(net, shape)
    snap = net._snapshot()
    cc = compiled_cost(lambda: net._train_step(*args, iteration=0))
    net._restore(snap)
    assert led["total_bytes"] == int(cc["bytes_accessed"])
    rec = H.attribute_ledger(net, shape, optimizer_slots=slots, rows=rows)
    assert sum(rec["bins"].values()) == rec["ledger_total_bytes"] \
        == led["total_bytes"]
    assert rec["floor_bytes"] == H.train_step_floor(
        net, shape, slots)["floor_bytes"]
    assert rec["gap_bytes"] == rec["ledger_total_bytes"] - rec["floor_bytes"]
    assert rec["bins"]["weight_update"] > 0 and rec["bins"]["compute"] > 0
    assert rec["bins"]["collective"] == 0
    assert sum(led["by_scope"].values()) == led["total_bytes"]
    assert any(s.startswith("forward:") for s in led["by_scope"])
    assert {"backward", "update"} <= set(led["by_scope"])


def test_recording_leaves_the_net_as_it_was(pair):
    _, _, (net, shape, _) = pair
    before = [t.clone() for t in net._step_state()]
    H.record_step(net, shape)
    assert all(torch.equal(a, b) for a, b in zip(before, net._step_state()))
    assert all("forward" not in l.__dict__ for _, l in H._named_layers(net))


def test_the_dtype_audit_is_clean_under_compute_and_flags_wide():
    net, shape, _ = hbm.build_subject("resnet_block", batch_size=B,
                                      device="cpu")
    assert H.audit_activation_dtypes(net, shape) == []
    H.assert_activation_dtype_clean(net, shape)
    old, N._TAIL_MODE = N._TAIL_MODE, "wide"
    try:
        off = H.audit_activation_dtypes(net, shape)
        with pytest.raises(AssertionError, match="wide-float"):
            H.assert_activation_dtype_clean(net, shape)
    finally:
        N._TAIL_MODE = old
    assert off and all(r["dtype"] == "float32" for r in off)
    assert any(r["scope"].startswith("forward:1:BatchNormalization")
               or r["scope"] == "backward" for r in off)
    rec = H.attribute_ledger(net, shape)
    assert rec["bins"]["dtype_widening"] == 0
    N._TAIL_MODE = "wide"
    try:
        assert H.attribute_ledger(net, shape)["bins"]["dtype_widening"] > 0
    finally:
        N._TAIL_MODE = old


def test_run_attribution_and_precompile_subject():
    rec, text = hbm.run_attribution("lenet", batch_size=4, device="cpu")
    assert rec["subject"] == "lenet" and rec["wide_activation_buffers"] == 0
    assert "ledger total" in text and "bin.weight_update" in text
    rep = hbm.precompile_subject("lenet", batch_size=4, device="cpu")
    assert rep["train_step"]["status"] in ("cold", "warm")
    with pytest.raises(ValueError, match="unknown attribution subject"):
        hbm.build_subject("nope", device="cpu")


def test_residency_reads_the_card_and_refuses_the_cpu():
    net, shape, _ = hbm.build_subject("lenet", batch_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="card's allocator"):
        H.residency(net, shape)
