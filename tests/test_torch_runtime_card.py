"""The training runtime on the card (``cuda`` marker): a fitDataSet block
issues its k steps with no host sync (under
``torch.cuda.set_sync_debug_mode("error")``), fitDataSet is bitwise
``fit`` for zoo LeNet, the non-finite guard rolls a poisoned step back
on the card, and a ModelSerializer file goes from the card to the CPU
and back. The data and fine-tuning runtime: fit through an
``AsyncDataSetIterator`` over the native ring is bitwise fit through its
base (its batches handed over through pinned buffers and a side
stream), augmentation and MFCCs of host batches land on the card and
equal their CPU results (the augmentation under the same draws), a
frozen trunk stays bitwise unchanged, a solver step runs on the
card, and the int8 forward on the card matches the CPU's.

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


def test_async_fit_is_bitwise_fit_on_the_card(card):
    from deeplearning4j_tpu_torch.runtime import AsyncDataSetIterator

    def it():        # unshuffled: every reset gives the same batches
        return DataSetIterator(*_data(), 64)

    a, b = _lenet(card), _lenet(card)
    a.fit(it())
    ait = AsyncDataSetIterator(it(), queueSize=3, device=card)
    assert ait.ring.kind == "native"
    b.fit(ait)
    assert a.score() == b.score()
    assert torch.equal(a.params().tensor(), b.params().tensor())
    c = _lenet(card)
    c.fitDataSet(AsyncDataSetIterator(it(), device=card), stepsPerSync=4)
    assert torch.equal(a.params().tensor(), c.params().tensor())


def test_augmentation_on_the_card_equals_the_cpu(card):
    from deeplearning4j_tpu_torch.data import (
        DataSet, FlipImageTransform, ImageAugmentationPreProcessor,
        PipelineImageTransform, RandomCropTransform, RotateImageTransform,
    )

    x = np.random.RandomState(0).rand(8, 3, 32, 32).astype(np.float32)

    def pre(device):
        return ImageAugmentationPreProcessor(PipelineImageTransform(
            FlipImageTransform(0.5), RandomCropTransform(32, 32, pad=4),
            RotateImageTransform(15)), seed=3, device=device)

    on_card = pre(card)
    got = on_card.preProcess(DataSet(x, np.zeros((8, 2), np.float32)))
    got = got.getFeatures()
    assert got.device.type == "cuda"
    draws = [tuple(t.cpu() for t in d) if isinstance(d, tuple) else d.cpu()
             for d in on_card.lastDraws]
    want = pre("cpu").run(x, draws=draws)
    assert (got.cpu() - want).abs().max() <= 1e-5


def test_mfcc_on_the_card_equals_the_cpu(card):
    """Host waveforms, as WavFileRecordReader gives them, go to the
    card: within 1e-5 of the CPU's max-abs."""
    from deeplearning4j_tpu_torch.data import MFCCTransform

    rng = np.random.RandomState(1)
    clips = (0.5 * np.sin(np.arange(16000) * rng.uniform(0.05, 0.5, (8, 1)))
             + 0.05 * rng.randn(8, 16000)).astype(np.float32)
    got = MFCCTransform(numCoeffs=13, device=card).apply(clips)
    assert got.device.type == "cuda"
    want = MFCCTransform(numCoeffs=13, device="cpu").apply(clips)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


def test_frozen_trunk_and_solver_on_the_card(card):
    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, MultiLayerNetwork, NeuralNetConfiguration, OutputLayer,
        TransferLearning,
    )

    x, y = _data(256)
    conf = (NeuralNetConfiguration.Builder().seed(1)
            .optimizationAlgo("LBFGS").list()
            .layer(DenseLayer(nIn=784, nOut=64, activation="relu"))
            .layer(DenseLayer(nOut=32, activation="relu"))
            .layer(OutputLayer(nOut=10, activation="softmax")).build())
    net = MultiLayerNetwork(conf, device=card).init()
    net = TransferLearning.Builder(net).setFeatureExtractor(0).build()
    w0 = net._params[0]["W"].detach().clone()
    flat = x.reshape(256, -1)
    losses = []
    for _ in range(5):
        net.fit(flat, y)
        losses.append(net.score())
    assert torch.equal(w0, net._params[0]["W"])
    assert losses[-1] < losses[0]


def test_int8_forward_on_the_card_matches_the_cpu(card):
    from deeplearning4j_tpu_torch.nn.quantize import int8_infer_fn

    net = _lenet("cpu")
    x = torch.from_numpy(_data(32)[0])
    infer, qp, sc = int8_infer_fn(net)
    want = infer(qp, sc, x)
    gpu = _lenet(card)
    ginfer, gqp, gsc = int8_infer_fn(gpu)
    got = ginfer(gqp, gsc, x.to(card)).cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max() + 1e-6


def test_async_multi_dataset_iterator_on_the_card(card):
    """The MultiDataSet path: arrays (masks included) land on the card
    equal to the wrapped iterator's, and a two-input graph's fit through
    the ring is bitwise its fit through the wrapped iterator."""
    from deeplearning4j_tpu_torch.data import MultiDataSetIterator
    from deeplearning4j_tpu_torch.nn import (
        Adam, ComputationGraph, DenseLayer, InputType, MergeVertex,
        NeuralNetConfiguration, OutputLayer,
    )
    from deeplearning4j_tpu_torch.runtime import AsyncMultiDataSetIterator

    rng = np.random.RandomState(4)
    a, b = rng.rand(50, 3).astype("f4"), rng.rand(50, 2).astype("f4")
    y = np.eye(2, dtype="float32")[rng.randint(0, 2, 50)]

    def it():
        return MultiDataSetIterator([a, b], [y], 16)

    ait = AsyncMultiDataSetIterator(it(), device=card)
    want = it()
    while want.hasNext():
        w, g = want.next(), ait.next()
        for x, t in zip(w.getFeatures() + w.getLabels(),
                        g.getFeatures() + g.getLabels()):
            assert t.is_cuda and torch.equal(t.cpu(), torch.from_numpy(x))
        wl, gl = w.getLabelsMaskArrays(), g.getLabelsMaskArrays()
        assert (wl is None) == (gl is None)
        if wl is not None:
            assert torch.equal(gl[0].cpu(), torch.from_numpy(wl[0]))
    assert not ait.hasNext()

    def graph():
        conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
                .graphBuilder().addInputs("inA", "inB")
                .addLayer("dA", DenseLayer(nIn=3, nOut=8, activation="tanh"),
                          "inA")
                .addLayer("dB", DenseLayer(nIn=2, nOut=8, activation="tanh"),
                          "inB")
                .addVertex("merge", MergeVertex(), "dA", "dB")
                .addLayer("out", OutputLayer(nOut=2, activation="softmax"),
                          "merge")
                .setOutputs("out")
                .setInputTypes(InputType.feedForward(3),
                               InputType.feedForward(2)).build())
        return ComputationGraph(conf, device=card).init()

    p, q = graph(), graph()
    p.fit(it())
    q.fit(AsyncMultiDataSetIterator(it(), device=card))
    assert p.score() == q.score()
    assert torch.equal(p.params().tensor(), q.params().tensor())
