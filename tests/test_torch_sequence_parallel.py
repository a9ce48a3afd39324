"""Sequence parallelism: the port's ``ring_attention`` and
``ulysses_attention`` (deeplearning4j_tpu_torch/parallel/sequence.py)
against the reference's (deeplearning4j_tpu/parallel/sequence.py).

The reference's own tests (tests/test_parallel.py ``TestSequenceParallel``
:237) run its shard_map programs over a "seq" axis of the virtual
8-device CPU mesh; here the reference runs on ``{"seq": 4}`` and
``{"seq": 2}`` in this process, forward and backward (``jax.grad`` of
``sum(out * g)``), and the port on four gloo ranks (``parallel.launch``;
rank body ``seq_rank`` in tests/_torch_parallel_ranks.py): ring attention
causal and not and Ulysses on ``{"seq": 4}``, and the causal ring on
``{"data": 2, "seq": 2}`` (each data rank one batch row). Each rank
holds rows [r·T/s, (r+1)·T/s) of q, k and v and returns its rows of the
output and of the three gradients; the test puts them together.

Bar: the reference test's rtol 2e-4 / atol 2e-5, against the
reference's outputs and gradients and against plain full attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from deeplearning4j_tpu.parallel import (
    build_mesh as jbuild_mesh, ring_attention as jring,
    ulysses_attention as julysses,
)

import _torch_parallel_ranks as R
from deeplearning4j_tpu_torch.parallel import (
    build_mesh, launch, ring_attention, ulysses_attention,
)

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 240.0
BAR = dict(rtol=2e-4, atol=2e-5)
B, H, T, D = 2, 4, 32, 8


def _qkvg(seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype("float32") for _ in range(4))


def _full_attention(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        m = np.arange(T)[:, None] >= np.arange(T)[None, :]
        s = np.where(m[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def reference(fn, n, causal):
    """The reference's fn on {seq: n}: (out, dq, dk, dv) of sum(out·g)."""
    q, k, v, g = _qkvg()
    mesh = jbuild_mesh({"seq": n})
    spec = NamedSharding(mesh, P(None, None, "seq", None))
    args = [jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)]
    kw = {} if fn is julysses else {"causal": causal}

    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, **kw), q, k, v)
        return (out,) + vjp(g)

    return [np.asarray(t) for t in fwd_bwd(*args, jnp.asarray(g))]


@pytest.fixture(scope="module")
def ranks():
    q, k, v, g = _qkvg()
    return launch(R.seq_rank, 4, device="cpu", timeout=LAUNCH_TIMEOUT,
                  args=(q, k, v, g))


def assembled(ranks, name, dp=False):
    """Each rank's [out, dq, dk, dv] rows put back together over T (and
    over the batch for the {data: 2, seq: 2} run)."""
    if not dp:
        return [np.concatenate([r[name][i] for r in ranks], axis=2)
                for i in range(4)]
    # ranks 0,1 are data row 0 (seq 0, 1); ranks 2,3 data row 1
    return [np.concatenate([np.concatenate([ranks[d * 2 + s][name][i]
                                            for s in range(2)], axis=2)
                            for d in range(2)], axis=0) for i in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_exact(ranks, causal):
    name = "ring_causal" if causal else "ring"
    got = assembled(ranks, name)
    want = reference(jring, 4, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BAR)
    q, k, v, _ = _qkvg()
    np.testing.assert_allclose(got[0], _full_attention(q, k, v, causal),
                               **BAR)


def test_ulysses_attention_exact(ranks):
    got = assembled(ranks, "ulysses")
    want = reference(julysses, 4, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BAR)
    q, k, v, _ = _qkvg()
    np.testing.assert_allclose(got[0], _full_attention(q, k, v, False),
                               **BAR)


def test_ring_composes_with_the_data_axis(ranks):
    """The causal ring on {data: 2, seq: 2}: each data rank's batch row
    over its seq pair equals the reference's ring on {seq: 2}."""
    got = assembled(ranks, "dp_ring_causal", dp=True)
    want = reference(jring, 2, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BAR)


def test_ring_signature_is_a_permutation(ranks):
    """The ring's exchanges: s-1 shifts of K and of V forward, each
    recorded with its (source, destination) pairs, and the inverse shifts
    backward; COL06 finds them well formed."""
    from deeplearning4j_tpu_torch.analysis.collectives import check_ring

    sites = ranks[0]["ring_sites"]
    fwd = [s for s in sites if s[1] == "shift+1"]
    bwd = [s for s in sites if s[1] == "shift-1"]
    assert len(fwd) == 2 * 3 and len(bwd) == 2 * 3
    assert all(s[0] == "ppermute" for s in sites)
    assert fwd[0][2] == [(0, 1), (1, 2), (2, 3), (3, 0)]
    for _, _, perm in sites:
        assert check_ring(perm).ok


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention],
                         ids=["ring", "ulysses"])
def test_one_rank_seq_axis_is_plain_attention(fn):
    """{seq: 1} in this process (no process group): the same code with no
    exchange equals full attention."""
    q, k, v, _ = _qkvg()
    mesh = build_mesh({"seq": 1})
    out = fn(*(torch.from_numpy(a) for a in (q, k, v)), mesh,
             causal=True).numpy()
    np.testing.assert_allclose(out, _full_attention(q, k, v, True), **BAR)


def test_ulysses_needs_divisible_heads():
    """3 heads over a seq axis of 2 is refused before any exchange."""
    from deeplearning4j_tpu_torch.parallel.mesh import AxisGroup

    q = torch.zeros(1, 3, 4, 2)
    two = AxisGroup("seq", 0, 2, "gloo", None, None, (0, 1))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, two)


def test_dryrun_axis_legs_on_four_ranks():
    """dryrun_multichip(4)'s tp (dp 2 x tp 2 ResNet-50), sequence (the
    causal ring at T 32) and pipeline (tiny_mlp on {pipe: 4}) legs: finite
    losses, the whole params bitwise equal on every rank."""
    from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

    legs = ("tp", "sequence", "pipeline")
    res = dryrun_multichip(4, device="cpu", legs=legs,
                           timeout=LAUNCH_TIMEOUT)
    for leg in legs:
        assert np.isfinite(res[leg]["loss"]) and res[leg]["replicated"]
    assert res["tp"]["comm"]["mesh"] == {"data": 2, "model": 2}
    assert res["tp"]["comm"]["layers"]["gather"] == 0
    assert res["pipeline"]["comm"]["mesh"] == {"data": 1, "pipe": 4}
