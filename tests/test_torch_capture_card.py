"""Captured steps on the card (``cuda`` marker): a step replayed from its
CUDA graph (``runtime.aot``) trains, draws and decodes bitwise as the
eager step does; a replay adds the kernels its graph holds to their
launch counts; and what cannot replay is refused or counted, never
hidden: a step after the parameters were rebound, a SameDiff graph whose
``ifCond`` reads its predicate on the host.

This file imports neither jax nor the reference package:

    python3 -m pytest --noconftest -q tests/test_torch_capture_card.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import (
    Adam, BatchNormalization, ConvolutionLayer, DenseLayer,
    InputType, MultiLayerNetwork, NeuralNetConfiguration, Nesterovs,
    OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.schedules import StepSchedule
from deeplearning4j_tpu_torch.runtime import aot

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _cnn(dev, updater, dropout=None, seed=5):
    """conv -> BN -> 2x2 max pool -> dense -> softmax, NCHW f32."""
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
         .activation("relu").list()
         .layer(ConvolutionLayer(nOut=8, kernelSize=(3, 3)))
         .layer(BatchNormalization())
         .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                 stride=(2, 2))))
    b = b.layer(DenseLayer(nOut=32, dropOut=dropout) if dropout
                else DenseLayer(nOut=32))
    conf = (b.layer(OutputLayer(nOut=10, activation="softmax",
                                lossFunction="mcxent"))
            .setInputType(InputType.convolutional(12, 12, 1)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def _batch(seed=0, n=16):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 12, 12).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return x, y


def _params(net):
    """Parameters, updater state and layer state (BN statistics)."""
    return [t.detach().clone() for t in net._step_state()]


def _trajectory(net, steps=5, captured=False):
    x, y = _batch()
    if captured:
        net.precompile(batchSize=16)
    losses = []
    for _ in range(steps):
        net.fit(x, y)
        losses.append(net._score)
    return losses, _params(net)


def _same(a, b):
    la, pa = a
    lb, pb = b
    assert la == lb, (la, lb)
    for u, v in zip(pa, pb):
        assert torch.equal(u, v)


@pytest.mark.parametrize("case", ["cnn_bn_maxpool", "adam_schedule",
                                  "dropout"])
def test_captured_training_is_bitwise_the_eager_steps(card, case):
    upd = {"cnn_bn_maxpool": lambda: Nesterovs(0.1, 0.9),
           "adam_schedule": lambda: Adam(StepSchedule(
               "ITERATION", 1e-2, 0.5, 2)),
           "dropout": lambda: Nesterovs(0.1, 0.9)}[case]
    drop = 0.5 if case == "dropout" else None
    eager = _trajectory(_cnn(card, upd(), drop))
    net = _cnn(card, upd(), drop)
    captured = _trajectory(net, captured=True)
    _same(eager, captured)
    cap = net._captured
    assert cap.replays == 5 and cap.uncaptured == 0


def test_zoo_lenet_adam_captured_bitwise(card):
    from deeplearning4j_tpu_torch.zoo import LeNet

    def run(captured):
        net = LeNet(numClasses=10, seed=1, device=card,
                    updater=Adam(StepSchedule("ITERATION", 1e-3, 0.5, 3))
                    ).init()
        rng = np.random.RandomState(2)
        x = rng.rand(32, 1, 28, 28).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
        if captured:
            net.precompile(batchSize=32)
        out = []
        for _ in range(6):
            net.fit(x, y)
            out.append(net._score)
        return out, _params(net)

    _same(run(False), run(True))


def _lm(dev):
    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM

    return CausalTransformerLM(vocab=97, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_context=128, page_size=16,
                               dtype="bfloat16", seed=3, device=dev)


@pytest.mark.parametrize("bucket", [1, 8])
def test_decode_graphs_bitwise_and_launch_counts(card, bucket):
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa
    from deeplearning4j_tpu_torch.serving import (
        ManualClock, PagedSequenceScheduler,
    )

    lm = _lm(card)
    rng = np.random.RandomState(bucket)
    prompts = [rng.randint(0, 97, size=int(n)).tolist()
               for n in rng.randint(20, 60, size=bucket)]

    def serve(capture):
        s = PagedSequenceScheduler(lm, num_pages=65, slot_buckets=(bucket,),
                                   clock=ManualClock(), start_thread=False)
        if not capture:
            s._step_capture = None       # the eager baseline
        s.warm()
        cap = s._step_capture
        before = tpa.paged_flash_decode.launches
        replays = 0 if cap is None else cap.replays
        reqs = [s.submit(p, max_new_tokens=8, wait=False) for p in prompts]
        s.drain()
        launches = tpa.paged_flash_decode.launches - before
        replays = 0 if cap is None else cap.replays - replays
        s.close()
        return reqs, launches, cap, replays

    eager, l_eager, _, _ = serve(False)
    replayed, l_rep, cap, replays = serve(True)
    for a, b in zip(eager, replayed):
        assert a.wait(1.0).tolist() == b.wait(1.0).tolist()
        assert np.array_equal(a.logits.view(np.uint8),
                              b.logits.view(np.uint8))
    assert cap.uncaptured == 0 and replays > 0
    # K4 once a layer a decode step, eager or replayed
    assert l_rep == l_eager == replays * lm.n_layers


def test_rebound_params_are_counted_not_replayed(card):
    x, y = _batch()
    net = _cnn(card, Nesterovs(0.1, 0.9))
    net.precompile(batchSize=16)
    net.fit(x, y)
    net.init()                       # rebinds every parameter tensor
    ref = _cnn(card, Nesterovs(0.1, 0.9))
    net.fit(x, y)
    ref.fit(x, y)
    assert net._captured.uncaptured == 1
    assert net._score == ref._score
    net.precompile(batchSize=16)     # captured again, counted
    net.fit(x, y)
    assert net._captured.uncaptured == 1 and net._captured.replays == 2


def test_samediff_if_cond_refuses_capture_and_is_counted(card):
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        SameDiff, TrainingConfig,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    sd = SameDiff.create(device=card)
    x = sd.placeHolder("x", torch.float32, 4, 3)
    y = sd.placeHolder("y", torch.float32, 4, 1)
    w = sd.var("w", np.ones((3, 1), np.float32))
    p = sd.nn.linear(x, w, name="p")
    pred = sd.math.gt(sd.math.sum(p), sd.constant(0.0))
    out = sd.ifCond(pred, lambda s, a: a * 2.0, lambda s, a: a * 3.0,
                    inputs=[p])
    sd.loss.meanSquaredError(y, out, name="l")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(Sgd(0.01))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    X = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    Y = np.ones((4, 1), np.float32)
    with pytest.raises(aot.CaptureRefused, match="predicate"):
        sd.precompile(features=X, labels=Y)
    before = aot.session_cache().stats["uncaptured"]
    sd.fit(features=X, labels=Y, epochs=2)
    assert aot.session_cache().stats["uncaptured"] == before + 2


def test_inference_graph_replays_the_state_an_eager_fit_wrote(card):
    """A captured forward holds the BN statistics by pointer: an eager
    fit writes them in place, so the replay reads the new values."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    x, y = _batch()
    net, twin = _cnn(card, Nesterovs(0.1, 0.9)), _cnn(card,
                                                      Nesterovs(0.1, 0.9))
    pi = ParallelInference(net, batchBuckets=(16,))
    pi.precompile()
    cap = pi._capture
    for _ in range(2):
        net.fit(x, y)
        twin.fit(x, y)
    replays = cap.replays
    out = pi.output(x).toNumpy()
    plain = ParallelInference(twin, batchBuckets=(16,)).output(x).toNumpy()
    assert np.array_equal(out.view(np.uint32), plain.view(np.uint32))
    assert cap.replays == replays + 1 and cap.uncaptured == 0
    net.init()                        # a rebind: counted, never replayed
    pi.output(x)
    assert cap.uncaptured == 1 and cap.replays == replays + 1


def test_a_capture_counts_only_its_own_streams_launches(card):
    """K4 launched on another thread and stream while a graph captures is
    counted as it runs; the graph holds only its own launches, added per
    replay (the capture's warm-up runs the step once, for real)."""
    import threading
    import time

    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    lm = _lm(card)
    S, MP = 8, 4
    shape = (lm.n_layers, 65, lm.page_size, lm.n_heads, lm.head_dim)
    gen = torch.Generator(device=card).manual_seed(0)
    kps, vps = (torch.randn(shape, generator=gen, device=card,
                            dtype=torch.bfloat16) for _ in range(2))
    bt = torch.arange(S * MP, dtype=torch.int32,
                      device=card).reshape(S, MP) + 1
    sl = torch.full((S,), 40, dtype=torch.int32, device=card)
    tokens = torch.zeros(S, dtype=torch.int64, device=card)
    q = torch.randn((S, lm.n_heads, lm.head_dim), device=card,
                    dtype=torch.bfloat16)
    step = aot.CapturedStep(lambda t: lm.decode_paged(t, kps, vps, bt,
                                                      sl)[0],
                            entry="test.decode", fingerprint="test.decode")
    stop = threading.Event()
    served = [0]

    def serve():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not stop.is_set():
                tpa.paged_flash_decode(q, kps[0], vps[0], bt, sl)
                served[0] += 1
            torch.cuda.synchronize()

    tpa.reset_launches()
    t = threading.Thread(target=serve)
    t.start()
    try:
        while served[0] < 5:
            time.sleep(0.001)
        step.capture((tokens,))
    finally:
        stop.set()
        t.join()
    assert served[0] >= 5
    assert tpa.paged_flash_decode.launches == served[0] + lm.n_layers
    step(tokens)
    assert tpa.paged_flash_decode.launches == served[0] + 2 * lm.n_layers


def test_a_replayed_backward_adds_k2_and_k3(card):
    """The backward runs on autograd's worker thread, on the forward's
    stream: its K2/K3 launches belong to the capture and come back at
    each replay."""
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, 2, 64, 32), generator=gen, device=card)
               for _ in range(3))
    w = torch.ones((), device=card, requires_grad=True)

    def step(x):
        w.grad = None
        tfa.flash_attention(x * w, k * w, v * w).sum().backward()
        return w.grad

    def counts():
        return (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                tfa.flash_bwd_dkv.launches)

    cap = aot.CapturedStep(step, entry="test.attention",
                           fingerprint="test.attention")
    tfa.reset_launches()
    cap.capture((q,))                # the warm-up runs one step
    assert counts() == (1, 1, 1)
    eager = step(q).clone()
    replayed = cap(q).clone()
    assert torch.equal(eager, replayed)
    assert counts() == (3, 3, 3)
