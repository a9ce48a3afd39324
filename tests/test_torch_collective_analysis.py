"""The port's collective-safety pass (``analysis/collectives.py``) over
the signature its collective choke point records
(``parallel/collectives.py``), against the reference's checks
(``tests/test_collective_analysis.py``).

- COL05 (``check_bill``), COL06 (rings) and COL04 (contracts) give the
  reference's codes on the same inputs.
- COL03: the analyzer's lane width equals the packing's at every dp, a
  site that sends the wrong word count or a bill that charges the wrong
  bytes a lane is flagged, and a quantized contract with no packed
  lanes is flagged.
- COL01: the source twin flags a collective under a branch on the rank
  and nothing in the port's own parallel code; at run time, on two gloo
  ranks, every mode's recorded signature is the same on both ranks,
  matches its declared contract, and bills within 10 % (exactly, here)
  of the port's wire format, and the bytes the trainer reports equal the
  recorded ones; a rank that adds one all-reduce is named (COL01) from
  record-only runs, without a hang; a record-only run leaves the
  trainer it ran as it was, so the replicas stay bitwise equal.
- ``linalg_contract`` declares the linalg routines' call counts; the
  hierarchical and sharded contracts are declared.
"""

import textwrap

import pytest
import torch

from deeplearning4j_tpu.analysis import check_bill as ref_bill
from deeplearning4j_tpu.analysis.collectives import \
    CollectiveContract as RefContract
from deeplearning4j_tpu_torch.analysis.collectives import (
    CollectiveContract, CollectiveSignature, check_acc_dtype, check_bill,
    check_ring, check_signature, collective_counts, collective_signature,
    compression_contract, expected_lane_bits, linalg_contract,
    lint_collective_paths, lint_collective_source, port_wire_bill,
)
from deeplearning4j_tpu_torch.parallel import collectives as coll
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel.dryrun import signature_leg

import _torch_parallel_ranks as R

torch.set_num_threads(1)


@pytest.mark.parametrize("measured,analytic,rel", [
    (100, 100, 0.1), (109, 100, 0.1), (111, 100, 0.1), (89, 100, 0.1),
    (0, 0, 0.1), (5, 0, 0.1), (150, 100, 0.6)])
def test_check_bill_is_the_references(measured, analytic, rel):
    assert check_bill(measured, analytic, rel).codes() == \
        ref_bill(measured, analytic, rel).codes()


@pytest.mark.parametrize("perm,bad", [
    ([(0, 1), (1, 2), (2, 0)], False), ([(0, 1), (1, 1)], True),
    ([(0, 1), (0, 2)], True), ([(0, 0), (1, 1)], True)])
def test_rings(perm, bad):
    assert (check_ring(perm).codes() == ["COL06"]) == bad


@pytest.mark.parametrize("counts,got", [
    ({"psum": 2}, {"psum": 2}), ({"psum": 2}, {"psum": 3}),
    ({"psum": (1, None)}, {"psum": 7}), ({"psum": (2, 3)}, {"psum": 1}),
    ({}, {"all_gather": 1}), ({"psum": 1}, {})])
def test_contract_checks_are_the_references(counts, got):
    assert CollectiveContract("c", counts).check(got).codes() == \
        RefContract("c", counts).check(got).codes()


class _G:
    """A group that never communicates (record-only runs)."""

    def __init__(self, size=2, axis="data"):
        self.size, self.shape, self.pg = size, {axis: size}, object()


def test_the_choke_point_records_one_site_a_call():
    g = _G(4)

    def step():
        coll.all_reduce(torch.ones(10), g)
        coll.all_gather(torch.ones(3, dtype=torch.int32), g)
        coll.broadcast(torch.ones(5, dtype=torch.float64), g)
        coll.int8_lane_sum(torch.zeros(100, dtype=torch.int8), g)
        coll.all_reduce(torch.ones(1), g, "max")

    sig = collective_signature(step)
    assert [s.op for s in sig] == ["all_reduce", "all_gather", "broadcast",
                                   "int8_lane_sum", "all_reduce"]
    lane = sig.sites[3]
    k = 31 // coll.lane_bits(4)
    assert (lane.dtype, lane.count, lane.lanes) == ("int32", -(-100 // k),
                                                   100)
    assert sig.sites[0].wire_bytes == coll.wire_bytes("all_reduce", 40, 4)
    assert sig.sites[-1].reduce == "max"
    assert collective_counts(step) == {"all_reduce": 2, "all_gather": 1,
                                       "broadcast": 1, "int8_lane_sum": 1}
    assert check_acc_dtype(sig, 4).ok
    assert check_signature(sig, {"data": 4}).ok
    assert check_signature(sig, {"model": 4}).codes() == ["COL02"]


def test_record_only_runs_do_not_communicate_and_nest_refuses():
    with coll.recording(execute=False) as rec:
        t = coll.all_reduce(torch.ones(3), _G())
        with pytest.raises(RuntimeError):
            with coll.recording():
                pass
    assert torch.equal(t, torch.ones(3)) and len(rec.sites) == 1


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8, 64, 129, 4096])
def test_lane_contract_holds_at_every_dp(dp):
    assert expected_lane_bits(dp) == coll.lane_bits(dp)
    k = 31 // coll.lane_bits(dp)
    assert check_acc_dtype(CollectiveSignature([]), dp,
                           billed_acc_bytes=4.0 / k).ok


def test_lane_disagreements_are_col03():
    g = _G(2)
    with coll.recording(execute=False) as rec:
        coll.int8_lane_sum(torch.zeros(30, dtype=torch.int8), g)
    site = rec.sites[0]
    site.count += 1
    assert check_acc_dtype(CollectiveSignature([site]), 2).codes() == \
        ["COL03"]
    assert check_acc_dtype(CollectiveSignature([]), 2,
                           billed_acc_bytes=1).codes() == ["COL03"]
    assert check_acc_dtype(CollectiveSignature([]), 2 ** 30).codes() == \
        ["COL03"]


def test_port_bill_of_each_mode():
    sizes, dp = [1000, 10], 2
    k = 31 // coll.lane_bits(dp)
    ring = 2 * (dp - 1) / dp
    assert port_wire_bill(None, sizes, dp) == int(ring * 4 * 1010)
    assert port_wire_bill("int8", sizes, dp) == \
        int(ring * 8) + int(ring * 4 * -(-1010 // k))
    with pytest.raises(ValueError):
        port_wire_bill("hierarchical", sizes, dp)


def test_contracts_of_each_mode_and_the_waiting_ones():
    assert compression_contract(None, 8, sync_bn_layers=2).counts == {
        "all_reduce": 8}
    assert compression_contract("int8", 8).expects_quantized
    assert compression_contract("threshold", 8, adaptive=True).counts == {
        "all_gather": 1, "all_reduce": 2}
    # ported since the hierarchical slice: one exchange of every leaf
    assert compression_contract("hierarchical", 8).counts == {
        "int8_lane_scatter": 1, "all_gather": 2, "all_reduce": 2}
    assert compression_contract("hierarchical", 8, intra_quantized=False,
                                adaptive=True).counts == {
        "reduce_scatter": 1, "all_gather": 2, "all_reduce": 2}
    assert compression_contract(None, 8, sharded=True).counts == {
        "reduce_scatter": 1, "all_gather": 1, "all_reduce": 2}
    with pytest.raises(ValueError):
        compression_contract("threshold", 8, sharded=True)
    with pytest.raises(ValueError):
        compression_contract("bogus", 8)
    assert linalg_contract("matmul2d", ring=4).counts == {
        "all_gather": 1, "ppermute": 3}
    assert linalg_contract("lstsq", iterations=5).counts == {
        "all_reduce": 7, "all_gather": (0, 1)}
    assert linalg_contract("matmul1d").counts == {"ppermute": (1, None)}
    with pytest.raises(ValueError, match="unknown linalg routine"):
        linalg_contract("bogus")


_RANK_BRANCH = textwrap.dedent('''
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import collectives as C

    def step(t, g):
        r = dist.get_rank()
        if r == 0:
            C.all_reduce(t, g)
        while g.rank > 0:
            C.broadcast(t, g)
        x = C.all_gather(t, g) if r else t
        C.all_reduce(t, g)
        if t.numel() > 4:
            C.all_reduce(t, g)
''')


def test_the_source_twin_flags_collectives_under_rank_branches():
    rep = lint_collective_source(_RANK_BRANCH, "s.py")
    assert sorted(int(d.where.split(":")[1]) for d in rep.errors) == [
        8, 10, 11]
    assert rep.codes() == ["COL01"]


def test_the_ports_parallel_code_has_no_rank_branch_collective():
    rep = lint_collective_paths()
    assert rep.ok, rep.format()
    assert rep.suppressed == []
    bare = _RANK_BRANCH.replace("C.all_reduce(t, g)\n    while",
                                "C.all_reduce(t, g)  # collective-ok[COL01]"
                                "\n    while")
    assert len(lint_collective_source(bare, "s.py").errors) == 3


@pytest.mark.parametrize("mode", [None, "int8", "block_int8",
                                  "threshold"])
def test_two_rank_signatures_meet_their_contracts(mode):
    res = launch(signature_leg, 2, device="cpu", timeout=180,
                 args=(mode,))
    for r in res:
        assert r["codes"] == [], r["errors"]
    assert res[0]["executed"] == res[1]["executed"]
    assert res[0]["executed"] == res[0]["recorded_only"]
    assert res[0]["exchange_wire_bytes"] == res[0]["bill"]
    assert res[0]["wire_bytes"] == res[0]["recorded_wire_bytes"] > 0
    if mode in ("int8", "block_int8"):
        assert res[0]["counts"]["int8_lane_sum"] == 1
    assert all(r["held"] and r["replicated"] for r in res)


def test_a_divergent_rank_is_named_without_a_hang():
    res = launch(R.divergent_signature_rank, 2, device="cpu", timeout=180)
    assert "COL01" in res[0]["codes"] and "COL01" in res[1]["codes"]
    assert any("rank 1 vs rank 0" in e for e in res[0]["errors"])


def test_a_record_only_run_leaves_the_replicas_equal():
    """Record-only collectives return each rank's own values, so the
    step verify_program runs is a one-rank step on the rank's shard:
    the trainer it runs is put back (bitwise, the iteration too), and
    without that the replicas would drift apart."""
    res = launch(R.record_only_rank, 2, device="cpu", timeout=180)
    for r in res:
        assert (r["before"] == r["held"]).all()
        assert r["held_iteration"] == r["iteration"]
    assert (res[0]["held"] == res[1]["held"]).all()
    assert not (res[0]["unheld"] == res[1]["unheld"]).all()
