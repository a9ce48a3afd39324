"""The linalg tier on the card (``cuda`` marker): every routine at world 1
on the card against the same routine on the CPU in f64, the captured
entries (``precompile``, a ``RetraceSentinel``) replaying what the eager
path computes, and with two or more cards the dry run's linalg leg over
NCCL.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_linalg_card.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import linalg
from deeplearning4j_tpu_torch.parallel import build_mesh

pytestmark = pytest.mark.cuda

F64 = 1e-10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the linalg routines run on the "
                    "card by default")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _both(fn, *arrays):
    """fn on DistributedMatrices of `arrays` on the card and on the CPU."""
    out = []
    for dev in ("cuda", "cpu"):
        mesh = build_mesh()
        out.append(fn(*[linalg.DistributedMatrix(a, mesh, device=dev)
                        for a in arrays]))
    return out


def _close(got, want):
    got = got.cpu().double() if torch.is_tensor(got) else torch.as_tensor(got)
    want = want.cpu().double() if torch.is_tensor(want) \
        else torch.as_tensor(want)
    assert float((got - want).abs().max()) <= F64 * float(want.abs().max())


def test_routines_on_the_card_equal_the_cpu(card):
    A, B = _rand((512, 256), 1), _rand((256, 128), 2)
    c, p = _both(lambda a, b: linalg.matmul(a, b).toNumpy(), A, B)
    _close(c, p)
    c, p = _both(lambda a: linalg.gram(a).toNumpy(), A)
    _close(c, p)
    c, p = _both(lambda a: linalg.covariance(a).toNumpy(), A + 3.0)
    _close(c, p)
    b = _rand((512,), 3)
    c, p = _both(lambda a: linalg.lstsq(a, b, tol=1e-10), A)
    assert c.converged and p.converged
    _close(c.x, p.x)
    # rsvd draws Omega from the block's device: the card's Philox and the
    # CPU's mt19937 differ, so hold the values and the projector
    L = _rand((512, 8), 4) @ _rand((8, 256), 5) + 1e-6 * _rand((512, 256), 6)
    (Uc, sc, _), (Up, sp, _) = _both(lambda a: linalg.rsvd(a, 8), L)
    _close(sc, sp)
    Pc, Pp = Uc.toNumpy(), Up.toNumpy()
    np.testing.assert_allclose(Pc @ Pc.T, Pp @ Pp.T, atol=1e-8)


def test_captured_entries_replay_the_eager_result(card):
    from deeplearning4j_tpu_torch.analysis import RetraceSentinel

    mesh = build_mesh()
    out = linalg.precompile(mesh, 256, 128, 64)
    assert out["lstsq"] == ("refused", 0.0)
    assert {out[k][0] for k in ("matmul1d", "matmul_ta", "gram")} <= {
        "cold", "warm"}
    A = torch.randn(256, 128, device=card, dtype=torch.float32)
    B = torch.randn(128, 64, device=card, dtype=torch.float32)
    dA = linalg.DistributedMatrix(A, mesh)
    dB = linalg.DistributedMatrix(B, mesh)
    C1 = linalg.matmul(dA, dB).tensor()
    C2 = linalg.matmul(dA, dB).tensor()
    assert C1.data_ptr() != C2.data_ptr()       # cloned out of the graph
    assert torch.equal(C1, C2)
    torch.testing.assert_close(C1, A @ B, rtol=1e-6, atol=1e-5)
    sentinel = RetraceSentinel(max_compiles=1)
    linalg.install_retrace_sentinel(sentinel)
    try:
        for _ in range(3):
            G = linalg.gram(dA).tensor()
        assert sentinel.compiles("gram") == 1
        torch.testing.assert_close(G, A.T @ A, rtol=1e-6, atol=1e-4)
    finally:
        linalg.install_retrace_sentinel(None)


def test_the_dry_runs_linalg_leg_over_nccl(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("the NCCL leg needs two cards")
    from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

    n = 4 if torch.cuda.device_count() >= 4 else 2
    res = dryrun_multichip(n, legs=("linalg",))
    assert res["linalg"]["replicated"]
