"""One-shot serving on the card (``cuda`` marker): coalesced answers are
bitwise the same rows' ParallelInference output padded to the same
bucket, whatever shares the dispatch and wherever a row sits; a model
registered on ModelHost serves concurrent requests of every size with
zero cold dispatches (forwards at a batch its warm never ran); and with
no card, a network asked for no device cannot be built, so nothing
reaches ParallelInference or moves to the CPU by itself.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_serving_card.py

Without a card every test but the last skips.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import DataType
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import (
    ManualClock, MicroBatcher, ModelHost,
)
from deeplearning4j_tpu_torch.zoo import LeNet, ResNet50

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the served forwards run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _nets(dev):
    """Zoo LeNet in f32 and ResNet-50 in bf16 NHWC at 64^2."""
    return {
        "lenet": (LeNet(numClasses=10, seed=0, device=dev).init(),
                  (1, 28, 28)),
        "resnet": (ResNet50(numClasses=10, seed=0, inputShape=(3, 64, 64),
                            dataType=DataType.BFLOAT16, dataFormat="NHWC",
                            device=dev).init(), (64, 64, 3)),
    }


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_same_bucket_coalescing_is_bitwise(card, which):
    net, shape = _nets(card)[which]
    rng = np.random.RandomState(1)
    sizes = (3, 2, 1, 2)
    reqs = [rng.rand(n, *shape).astype(np.float32) for n in sizes]
    pi = ParallelInference(net, batchBuckets=(1, 8))
    pi.precompile()
    want = [ParallelInference(net, batchBuckets=(8,)).output(r).toNumpy()
            for r in reqs]
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
        mb = MicroBatcher(pi._dispatch_coalesced, max_rows=8,
                          bucket_for=pi._target_batch, clock=ManualClock(),
                          start_thread=False)
        handles = {i: mb.submit(reqs[i], wait=False) for i in order}
        mb.flush()
        assert mb.occupancy == [(8, 8)]
        for i in order:
            np.testing.assert_array_equal(handles[i].wait(0), want[i])
        mb.close()
    assert pi.cold_dispatches == 0


def test_register_warms_every_bucket_no_cold_dispatch(card):
    net, shape = _nets(card)["resnet"]
    host = ModelHost()
    try:
        rep = host.register("m", net, batchBuckets=(1, 4, 16),
                            maxWaitMs=1.0)
        assert set(rep["warm"]) == {1, 4, 16}
        rng = np.random.RandomState(2)
        feats = [rng.rand(1 + i % 16, *shape).astype(np.float32)
                 for i in range(24)]
        got = [None] * len(feats)

        def client(i):
            got[i] = host.submit("m", feats[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feats))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert all(g.shape == (f.shape[0], 10) and np.isfinite(g).all()
                   for g, f in zip(got, feats))
        assert host.model("m").pi.cold_dispatches == 0
    finally:
        host.close()


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    """The port has no silent CPU fallback: without a card, a network
    built with no device raises, and a served network stays on the
    device it was built on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet(numClasses=10, seed=0).init()
    cpu = LeNet(numClasses=10, seed=0, device="cpu").init()
    with pytest.raises(ValueError, match="network's device"):
        ParallelInference(cpu, mesh=["cuda"])
    assert ParallelInference(cpu).device == torch.device("cpu")
