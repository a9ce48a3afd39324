"""The mesh axes on the card (``cuda`` marker): two gloo ranks on one
card train a tensor-parallel ResNet-50 (bf16 NHWC over f32 masters) and
the BN CNN of parallel.dryrun, and their replicated leaves and BN
running statistics stay bitwise equal across the ranks; ring attention
on ``{"seq": 1}`` (the same code with no exchange) equals
``dot_product_attention`` forward and backward at the reference test's
rtol 2e-4 / atol 2e-5.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_mesh_axes_card.py

Without a card every test skips.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as R  # noqa: E402

from deeplearning4j_tpu_torch.ops.attention import (  # noqa: E402
    dot_product_attention,
)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    build_mesh, launch, ring_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: tensor parallelism and ring "
                    "attention on it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_tp_replicated_leaves_bitwise_equal_on_the_card(card):
    one = torch.device("cuda", torch.cuda.current_device())
    res = launch(R.tp_card_rank, 2, device=one, backend="gloo",
                 timeout=600)
    for key in ("resnet", "bn_cnn"):
        assert res[0][key] == res[1][key], key
        assert res[0]["calls"][key]["column"] > 0
    assert all(math.isfinite(s) for r in res for s in r["scores"])


@pytest.mark.parametrize("causal", [False, True])
def test_ring_on_one_seq_rank_is_dot_product_attention(card, causal):
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 12, 1024, 64).astype(
        np.float32)).to(card) for _ in range(4))
    mesh = build_mesh({"seq": 1})
    got, want = [], []
    for fn, out in ((lambda a, b, c: ring_attention(a, b, c, mesh,
                                                    causal=causal), got),
                    (lambda a, b, c: dot_product_attention(
                        a, b, c, causal=causal), want)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(g)
        out.extend([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
