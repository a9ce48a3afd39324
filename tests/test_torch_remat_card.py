"""Per-layer activation remat on the card (``cuda`` marker):
``activationCheckpointing(True)`` trains zoo ResNet-50 (bf16 NHWC,
Nesterovs(0.1, 0.9), deterministic cuDNN) bitwise the stock net from the
same weights, captured too; the BERT-width encoder's self-attention
vertices run K1 again in the backward (twice a block a step) while K2
and K3 run once, and its losses are the stock ones.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_remat_card.py

Without a card every test skips.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda

RESNET = dict(batch=16, image=224, classes=1000)
ENCODER = dict(cs.BERT_BASE, layers=2, seq=128, batch=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels and cuDNN")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _resnet(dev, remat):
    from deeplearning4j_tpu_torch.nn import Nesterovs

    net = cs.resnet_net(dev, RESNET, "BFLOAT16", dataFormat="NHWC",
                        updater=Nesterovs(0.1, 0.9))
    net.conf.activationCheckpointing = remat
    return net


@pytest.mark.parametrize("captured", [False, True],
                         ids=["eager", "captured"])
def test_resnet50_remat_is_bitwise_stock(card, captured):
    x, y = cs.resnet_batch(card, RESNET, RESNET["batch"])
    x = x.float()
    runs = []
    for remat in (False, True):
        net = _resnet(card, remat)
        if captured and remat:
            net.precompile(batchSize=RESNET["batch"], entries=("train",))
        losses = []
        for _ in range(3):
            net.fit(x, y)
            losses.append(net.score())
        if captured and remat:
            cap = net._captured
            assert cap.replays == 3 and cap.uncaptured == 0
            assert cap.captures == 1
        runs.append((losses, [t.detach().cpu() for t in net._step_state()]))
        del net
    (la, sa), (lb, sb) = runs
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))


def test_encoder_remat_runs_k1_twice_a_block(card):
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    x, y = cs.encoder_batch(ENCODER, card)
    out = {}
    for remat in (False, True):
        conf = cs.bert_encoder_conf(ENCODER)
        conf.activationCheckpointing = remat
        net = ComputationGraph(conf).init()
        tfa.reset_launches()
        losses = []
        for _ in range(2):
            net.fit(x, y)
            losses.append(net.score())
        out[remat] = (losses, {"K1": tfa.flash_fwd.launches,
                               "K2": tfa.flash_bwd_dq.launches,
                               "K3": tfa.flash_bwd_dkv.launches})
        del net
    n = ENCODER["layers"] * 2
    assert out[False][1] == {"K1": n, "K2": n, "K3": n}
    assert out[True][1] == {"K1": 2 * n, "K2": n, "K3": n}
    np.testing.assert_allclose(out[True][0], out[False][0],
                               rtol=cs.REMAT_LOSS_REL)
