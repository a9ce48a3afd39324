"""Port parity for ZooModel.initPretrained(localFile=) and
zoo/pretrained.py (deeplearning4j_tpu_torch): a Keras-applications
file written here from seeded weights (no download), mapped onto the
port's zoo network and held to Keras's own ``predict`` within the
reference test's band (rtol 1e-3, atol 1e-5), and to the reference's
mapped network within 1e-5 of the logits' max-abs (f32). Mirrors
tests/test_pretrained.py, its slow cases included (the port's side is
fast), and holds the file-free mapping (``_map_keras_weights`` over a
{layer name: arrays} dict, what the card runs without h5py) to the
file's.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
keras = tf.keras

from deeplearning4j_tpu.zoo import ResNet50 as JResNet50  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    InvalidKerasConfigurationException,
)
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning  # noqa
from deeplearning4j_tpu_torch.zoo import (  # noqa: E402
    VGG16, LeNet, ResNet50, convertPretrained,
)
from deeplearning4j_tpu_torch.zoo.pretrained import (  # noqa: E402
    _map_keras_weights,
)

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def resnet_h5(tmp_path_factory):
    """keras.applications.ResNet50 at 64x64 and 10 classes (seeded random
    weights) in the legacy h5 layout, its predict() output and its
    weights by layer name."""
    keras.utils.set_random_seed(7)
    km = keras.applications.ResNet50(weights=None, include_top=True,
                                     input_shape=(64, 64, 3), classes=10)
    path = str(tmp_path_factory.mktemp("resnet") / "resnet50.h5")
    km.save(path)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    wmap = {l.name: l.get_weights() for l in km.layers if l.get_weights()}
    return path, x, km.predict(x, verbose=0), wmap


def _model(**kw):
    return ResNet50(numClasses=10, inputShape=(3, 64, 64), device=CPU, **kw)


def test_golden_activation_parity(resnet_h5):
    path, x, golden, _ = resnet_h5
    net = _model().initPretrained(localFile=path)
    ours = net.output(x.transpose(0, 3, 1, 2)).toNumpy()
    np.testing.assert_allclose(ours, golden, rtol=1e-3, atol=1e-5)
    ref = JResNet50(numClasses=10, inputShape=(3, 64, 64)).initPretrained(
        localFile=path)
    want = np.asarray(ref.output(x.transpose(0, 3, 1, 2)).toNumpy())
    np.testing.assert_allclose(ours, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_the_mapping_needs_no_file(resnet_h5):
    """The arrays by layer name map to the same network as the file."""
    path, x, golden, wmap = resnet_h5
    model = _model()
    net = _map_keras_weights(model, model.init(), wmap)
    from_file = model.initPretrained(localFile=path)
    xn = x.transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(net.output(xn).toNumpy(),
                                  from_file.output(xn).toNumpy())


def test_convert_to_native_checkpoint_roundtrip(resnet_h5, tmp_path):
    path, x, golden, _ = resnet_h5
    model = _model()
    ckpt = str(tmp_path / "resnet50_native.dl4j.npz")
    net = convertPretrained(model, path, ckpt)
    restored = model.initPretrained(localFile=ckpt)
    xn = x.transpose(0, 3, 1, 2)
    a, b = net.output(xn).toNumpy(), restored.output(xn).toNumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(b, golden, rtol=1e-3, atol=1e-5)


def test_transfer_learning_finetunes_from_pretrained(resnet_h5):
    path, _, _, _ = resnet_h5
    net = _model().initPretrained(localFile=path)
    tnet = (TransferLearning.GraphBuilder(net)
            .setFeatureExtractor("gap")
            .nOutReplace("fc", 3)
            .build())
    rng = np.random.RandomState(1)
    xb = rng.rand(8, 3, 64, 64).astype(np.float32)
    yb = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
    losses = []
    for _ in range(8):
        tnet.fit(xb, [yb])
        losses.append(tnet.score())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_refusals(resnet_h5):
    path, _, _, _ = resnet_h5
    with pytest.raises(InvalidKerasConfigurationException,
                       match="block1_conv1"):
        VGG16(numClasses=10, inputShape=(3, 64, 64),
              device=CPU).initPretrained(localFile=path)
    with pytest.raises(InvalidKerasConfigurationException,
                       match="no Keras-applications weight mapping"):
        LeNet(numClasses=10, device=CPU).initPretrained(localFile=path)
    with pytest.raises(NotImplementedError, match="localFile"):
        _model().initPretrained()
    with pytest.raises(NotImplementedError, match="imagenet"):
        _model().initPretrained("imagenet")
    with pytest.raises(FileNotFoundError, match="no/such/file"):
        _model().initPretrained(localFile="/no/such/file.h5")
    with pytest.raises(InvalidKerasConfigurationException,
                       match="s2d"):
        _model(stemMode="space_to_depth").initPretrained(localFile=path)


def test_vgg16_golden_activation_parity(tmp_path):
    keras.utils.set_random_seed(11)
    km = keras.applications.VGG16(weights=None, include_top=True,
                                  input_shape=(48, 48, 3), classes=10)
    path = str(tmp_path / "vgg16.h5")
    km.save(path)
    x = np.random.RandomState(2).rand(2, 48, 48, 3).astype(np.float32)
    golden = km.predict(x, verbose=0)
    net = VGG16(numClasses=10, inputShape=(3, 48, 48),
                device=CPU).initPretrained(localFile=path)
    np.testing.assert_allclose(net.output(x.transpose(0, 3, 1, 2)).toNumpy(),
                               golden, rtol=1e-3, atol=1e-5)


def test_resnet50_from_keras_archive(tmp_path):
    keras.utils.set_random_seed(17)
    km = keras.applications.ResNet50(weights=None, include_top=True,
                                     input_shape=(64, 64, 3), classes=7)
    path = str(tmp_path / "resnet50.keras")
    km.save(path)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    golden = km.predict(x, verbose=0)
    net = ResNet50(numClasses=7, inputShape=(3, 64, 64),
                   device=CPU).initPretrained(localFile=path)
    np.testing.assert_allclose(net.output(x.transpose(0, 3, 1, 2)).toNumpy(),
                               golden, rtol=1e-3, atol=1e-5)
