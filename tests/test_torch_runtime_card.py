"""The training runtime on the card (``cuda`` marker): a fitDataSet block
issues its k steps with no host sync (under
``torch.cuda.set_sync_debug_mode("error")``), fitDataSet is bitwise
``fit`` for zoo LeNet, the non-finite guard rolls a poisoned step back
on the card, and a ModelSerializer file goes from the card to the CPU
and back.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_runtime_card.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import sync_free_blocks
from deeplearning4j_tpu_torch.optimize import CollectScoresListener
from deeplearning4j_tpu_torch.runtime.resilience import (
    FaultInjector, ResilientFit,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import LeNet

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block's streams and the sync "
                    "check exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _data(n=640, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 28, 28).astype("float32")
    y = np.eye(10, dtype="float32")[rng.randint(0, 10, n)]
    return x, y


def _it(batch=64):
    return DataSetIterator(*_data(), batch, shuffle=True, seed=3)


def _lenet(device):
    return LeNet(numClasses=10, seed=0, device=device).init()


def test_block_issues_no_host_sync(card):
    net = _lenet(card)
    net.fit(_it())                       # warm cuDNN/cuBLAS up first
    with sync_free_blocks():
        net.fitDataSet(_it(), stepsPerSync=5)
    assert net._fit_dataset_syncs == 2
    assert np.isfinite(net.score())


def test_fit_dataset_bitwise_fit_for_lenet(card):
    a, b = _lenet(card), _lenet(card)
    sa, sb = CollectScoresListener(), CollectScoresListener()
    a.setListeners(sa)
    b.setListeners(sb)
    a.fit(_it(), epochs=2)
    b.fitDataSet(_it(), stepsPerSync=4, epochs=2)
    assert sa.scores == sb.scores
    assert torch.equal(a.params().tensor(), b.params().tensor())
    assert b._fit_dataset_syncs == 2 * (2 + 2)   # 10 batches: 2 blocks + 2


def test_guard_rolls_back_on_the_card(card):
    net = _lenet(card)
    snaps = {}

    class Grab:
        def iterationDone(self, model, iteration, epoch):
            snaps[iteration] = model.params().tensor().clone()

    net.setListeners(Grab())
    rf = ResilientFit(net, injector=FaultInjector().poisonStep(3))
    rf.fit(_it(), epochs=1, stepsPerSync=4)
    assert rf.skippedSteps == 1
    assert torch.equal(snaps[3], snaps[4])
    assert not torch.equal(snaps[4], snaps[5])
    assert torch.isfinite(net.params().tensor()).all()


def test_model_serializer_card_cpu_card(card, tmp_path):
    net = _lenet(card)
    net.fit(_it())
    x, _ = _data(64, seed=1)
    p = str(tmp_path / "lenet.npz")
    ModelSerializer.writeModel(net, p)
    cpu = ModelSerializer.restore(p, device="cpu")
    assert cpu.device.type == "cpu"
    np.testing.assert_allclose(cpu.output(x).toNumpy(),
                               net.output(x).toNumpy(), rtol=0, atol=1e-5)
    q = str(tmp_path / "back.npz")
    ModelSerializer.writeModel(cpu, q)
    back = ModelSerializer.restore(q, device=card)
    assert torch.equal(back.params().tensor(), net.params().tensor())
    assert torch.equal(back.output(x).tensor(), net.output(x).tensor())
    net.fit(x[:64], _data(64, seed=1)[1])
    back.fit(x[:64], _data(64, seed=1)[1])
    assert back.score() == net.score()
