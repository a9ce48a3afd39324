"""Detection, the 3-d layers and model import on the card (``cuda``
marker): the Yolo2 loss and its gradient on the card against the CPU in
f64; a cut YOLO2's first step, card vs CPU in f64, and its detections; a
cut C3D-shaped 3-d net; a Keras MultiHeadAttention config whose
attention runs K1 (its plain version never); a cut zoo ResNet-50 through
the port's GraphDef codec. Without a card, an import asked for no device
cannot be built (the last test, which runs here).

This file imports neither jax, tensorflow, h5py nor the reference
package:

    python3 -m pytest --noconftest -q tests/test_torch_zoo_detection_card.py

Without a card every test but the last skips.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.modelimport import (
    KerasModelImport, TFGraphMapper, importFrozenTF, tf_wire,
)
from deeplearning4j_tpu_torch.nn import (
    Convolution3D, DataType, Deconvolution3D, DenseLayer, InputType,
    MultiLayerNetwork, NeuralNetConfiguration, OutputLayer, Sgd,
    Subsampling3DLayer,
)
from deeplearning4j_tpu_torch.nn.graph import params_to_reference
from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer, YoloUtils

pytestmark = pytest.mark.cuda
_TESTS = Path(__file__).resolve().parent


def _helper(name):
    spec = importlib.util.spec_from_file_location(
        name, _TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the nets run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _yolo_labels(rows, grid, classes, seed):
    rng = np.random.default_rng(seed)
    lab = np.zeros((rows, 4 + classes, grid, grid))
    for b in range(rows):
        for _ in range(rng.integers(1, 4)):
            w, h = rng.uniform(0.5, 2.0, 2)
            cx, cy = rng.uniform(0.5, grid - 0.5, 2)
            lab[b, :, int(cy), int(cx)] = 0
            lab[b, 0:4, int(cy), int(cx)] = (cx - w / 2, cy - h / 2,
                                             cx + w / 2, cy + h / 2)
            lab[b, 4 + rng.integers(0, classes), int(cy), int(cx)] = 1
    return lab


def test_yolo_loss_and_gradient_on_the_card(card):
    layer = Yolo2OutputLayer(boundingBoxes=((1.0, 1.2), (2.5, 2.0),
                                            (0.6, 0.7)))
    rng = np.random.default_rng(0)
    pre = rng.standard_normal((4, 13, 13, 3 * 25)) * 1.5
    lab = torch.tensor(_yolo_labels(4, 13, 20, 1))
    res = {}
    for d in ("cpu", card):
        p = torch.tensor(pre, device=d, requires_grad=True)
        loss = layer.computeLoss(p, lab.to(d))
        (g,) = torch.autograd.grad(loss, p)
        res[str(d)] = (loss.detach().cpu(), g.cpu())
    (lc, gc), (lg, gg) = res["cpu"], res[str(card)]
    assert abs(float(lg - lc)) <= 1e-12 * abs(float(lc))
    assert _rel_l2(gg, gc) <= 1e-12


def test_yolo2_first_step_and_detections_on_the_card(card):
    kw = dict(numClasses=5, inputShape=(3, 96, 96), seed=0,
              dataType=DataType.DOUBLE)
    cpu = zoo.YOLO2(device="cpu", **kw).init()
    gpu = zoo.YOLO2(device=card, **kw).init()
    gpu.load_reference_params(params_to_reference(cpu.conf, cpu._params),
                              params_to_reference(cpu.conf, cpu._states))
    x = np.random.default_rng(2).random((2, 3, 96, 96))
    y = _yolo_labels(2, 3, 5, 3)
    gc_, lc = cpu.computeGradientAndScore(x, y)
    gg, lg = gpu.computeGradientAndScore(x, y)
    assert abs(lg - lc) <= 1e-10 * abs(lc)
    for n in gc_:
        for k in gc_[n]:
            assert _rel_l2(gg[n][k], gc_[n][k]) <= 1e-9, (n, k)
    layer = cpu.conf.nodes["out"].payload
    dets = [YoloUtils.getPredictedObjects(
        layer, net.output(x).toNumpy().transpose(0, 2, 3, 1), 0.5, 0.4)
        for net in (gpu, cpu)]
    assert len(dets[0]) == len(dets[1]) > 0
    for a, b in zip(*dets):
        assert (a.exampleNumber, a.predictedClass) == \
            (b.exampleNumber, b.predictedClass)
        assert abs(a.centerX - b.centerX) <= 1e-9
        assert abs(a.confidence - b.confidence) <= 1e-9


def _net3d(device):
    lb = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(0.1))
          .dataType(DataType.DOUBLE).list()
          .layer(Convolution3D(nOut=8, kernelSize=3, padding=1,
                               activation="relu"))
          .layer(Subsampling3DLayer(kernelSize=(1, 2, 2), stride=(1, 2, 2)))
          .layer(Deconvolution3D(nOut=4, kernelSize=2, stride=2,
                                 activation="tanh"))
          .layer(Subsampling3DLayer(poolingType="avg", kernelSize=2,
                                    stride=2, padding=(0, 1, 1)))
          .layer(DenseLayer(nOut=16, activation="relu"))
          .layer(OutputLayer(nOut=3, activation="softmax")))
    conf = lb.setInputType(InputType.convolutional3D(4, 12, 12, 2)).build()
    return MultiLayerNetwork(conf, device=device).init()


def test_3d_net_on_the_card(card):
    cpu, gpu = _net3d("cpu"), _net3d(card)
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference \
        as mln_to_reference

    gpu.load_reference_params(mln_to_reference(cpu.layers, cpu._params))
    x = np.random.default_rng(4).standard_normal((3, 2, 4, 12, 12))
    y = np.eye(3)[[0, 2, 1]]
    gc_, lc = cpu.computeGradientAndScore(x, y)
    gg, lg = gpu.computeGradientAndScore(x, y)
    assert abs(lg - lc) <= 1e-10 * abs(lc)
    for a, b in zip(gg, gc_):
        for k in b:
            assert _rel_l2(a[k], b[k]) <= 1e-9, k


def test_keras_attention_runs_k1_on_the_card(card):
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    km = _helper("_torch_keras_models")
    cfg = km.mha_encoder_config(seq=128, dim=128, heads=2, key_dim=64,
                                blocks=2, classes=4)
    w = km.mha_encoder_weights(cfg, seed=0)
    cpu = KerasModelImport.importKerasModelAndWeights(cfg, weights=w,
                                                      device="cpu")
    gpu = KerasModelImport.importKerasModelAndWeights(cfg, weights=w,
                                                      device=card)
    x = np.random.default_rng(5).standard_normal((4, 128, 128)).astype(
        np.float32)
    want = cpu.output(x).toNumpy()
    tfa.flash_fwd.launches = tfa.flash_fwd_plain.launches = 0
    got = gpu.output(x).toNumpy()
    assert tfa.flash_fwd.launches == 2 and tfa.flash_fwd_plain.launches == 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_tf_graphdef_resnet_on_the_card(card):
    om, tm = _helper("_torch_onnx_models"), _helper("_torch_tf_models")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(om.resnet50_conf(
        blocks=(1, 1, 1, 1), numClasses=7, inputShape=(3, 64, 64)),
        device=card).init()
    data = tf_wire.encode(tm.resnet_graphdef(net, 2))
    sd = importFrozenTF(data, device=card)
    x = np.random.default_rng(6).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    probs = TFGraphMapper.outputVariable(sd, "probs").eval(
        {"input": x.transpose(0, 2, 3, 1).copy()}).toNumpy()
    np.testing.assert_allclose(probs, net.output(x).toNumpy(), atol=1e-5)


def test_imports_need_a_device_here():
    """With no card, an import asked for no device raises (the device
    policy); asked for the CPU it builds."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    km = _helper("_torch_keras_models")
    cfg = km.mha_encoder_config(seq=4, dim=8, heads=2, key_dim=4, blocks=1,
                                classes=2)
    w = km.mha_encoder_weights(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasModelImport.importKerasModelAndWeights(cfg, weights=w)
    assert KerasModelImport.importKerasModelAndWeights(
        cfg, weights=w, device="cpu") is not None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importFrozenTF(tf_wire.encode(tf_wire.make_graph([])))
