"""Port parity for Keras import (deeplearning4j_tpu_torch/modelimport/
keras.py): every test of tests/test_modelimport.py but the whole
keras.applications imports the reference runs outside tier-1 (those are
tests/test_torch_keras_applications.py's), the same Keras
configs and weights (and the same .h5 and .keras files) through both
importers, each network held to Keras's own ``predict`` within the
reference test's band and the port's to the reference's within 1e-5 of
the output's max-abs (f32).

Keras models are built here from seeds, as the reference's tests build
them (``keras.utils.set_random_seed``, ``weights=None``); inputs are
seeded numpy draws, NHWC/[B, T, F] for Keras and NCHW/NCW for the
networks, as the reference's API takes them. A headless network (a conv
last) returns NCHW from the port where the reference returns its
internal NHWC, so that case is compared through a permute.
"""

import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
keras = tf.keras

from deeplearning4j_tpu.modelimport import KerasModelImport as JK  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    InvalidKerasConfigurationException,
    KerasModelImport as PK,
    UnsupportedKerasConfigurationException,
)
from deeplearning4j_tpu_torch.nn.conf.layers import \
    BaseOutputLayer  # noqa: E402

torch.set_num_threads(2)
CPU = "cpu"


def _wmap(model):
    return {l.name: l.get_weights() for l in model.layers if l.get_weights()}


def _nchw(x):
    return x.transpose(0, 3, 1, 2) if x.ndim == 4 else \
        x.transpose(0, 4, 1, 2, 3) if x.ndim == 5 else x.transpose(0, 2, 1)


def _seq(*layers):
    return keras.Sequential(list(layers))


def _functional(build):
    inp, out = build()
    return keras.Model(inp, out)


L = keras.layers

#: case -> (model factory, input shape in Keras's layout, the map to the
#: networks' layout or None)
CASES = {
    "mlp": (lambda: _seq(L.Input((20,)), L.Dense(32, activation="relu"),
                         L.Dense(10, activation="softmax")), (8, 20), None),
    "mlp_dropout_activation": (lambda: _seq(
        L.Input((12,)), L.Dense(16), L.Activation("tanh"), L.Dropout(0.4),
        L.Dense(3, activation="softmax")), (4, 12), None),
    "cnn_flatten_reorder": (lambda: _seq(
        L.Input((8, 8, 3)), L.Conv2D(4, 3, activation="relu"),
        L.MaxPooling2D(2), L.Flatten(), L.Dense(5, activation="softmax")),
        (4, 8, 8, 3), _nchw),
    "cnn_same_avgpool": (lambda: _seq(
        L.Input((6, 6, 2)), L.Conv2D(3, 3, padding="same",
                                     activation="relu"),
        L.AveragePooling2D(2), L.Flatten(), L.Dense(4, activation="softmax")),
        (2, 6, 6, 2), _nchw),
    "lstm": (lambda: _seq(L.Input((6, 5)), L.LSTM(7),
                          L.Dense(3, activation="softmax")), (4, 6, 5),
             _nchw),
    "global_pooling": (lambda: _seq(
        L.Input((8, 8, 3)), L.Conv2D(4, 3, activation="relu"),
        L.GlobalAveragePooling2D(), L.Dense(2, activation="softmax")),
        (2, 8, 8, 3), _nchw),
    "trailing_activation": (lambda: _seq(
        L.Input((6,)), L.Dense(8, activation="relu"), L.Dense(3),
        L.Activation("softmax")), (4, 6), None),
    "depthwise": (lambda: _seq(
        L.Input((6, 6, 3)), L.DepthwiseConv2D(3, depth_multiplier=2,
                                              activation="relu"),
        L.Flatten(), L.Dense(2, activation="softmax")), (2, 6, 6, 3), _nchw),
    "separable": (lambda: _seq(
        L.Input((10, 10, 3)), L.SeparableConv2D(8, 3, depth_multiplier=2,
                                                activation="relu"),
        L.GlobalAveragePooling2D(), L.Dense(4, activation="softmax")),
        (2, 10, 10, 3), _nchw),
    "conv3d_global_pool": (lambda: _seq(
        L.Input((4, 6, 6, 2)), L.Conv3D(5, 2, activation="relu"),
        L.GlobalAveragePooling3D(), L.Dense(3, activation="softmax")),
        (2, 4, 6, 6, 2), _nchw),
    "conv3d_flatten": (lambda: _seq(
        L.Input((4, 5, 6, 2)), L.Conv3D(3, 2, activation="relu"),
        L.Flatten(), L.Dense(3, activation="softmax")),
        (2, 4, 5, 6, 2), _nchw),
    "noise_layers": (lambda: _seq(
        L.Input((8,)), L.Dense(16, activation="relu"), L.GaussianDropout(0.3),
        L.GaussianNoise(0.2), L.AlphaDropout(0.1),
        L.Dense(3, activation="softmax")), (4, 8), None),
    "cropping2d": (lambda: _seq(
        L.Input((6, 8, 3)), L.Cropping2D(((1, 0), (2, 1))),
        L.Conv2D(4, 2, activation="relu"), L.GlobalAveragePooling2D(),
        L.Dense(2, activation="softmax")), (2, 6, 8, 3), _nchw),
    "pooling_padding_1d": (lambda: _seq(
        L.Input((12, 4)), L.ZeroPadding1D(2), L.Cropping1D((1, 1)),
        L.MaxPooling1D(2), L.LSTM(8), L.Dense(3, activation="softmax")),
        (2, 12, 4), _nchw),
    "leaky_relu_alpha": (lambda: _seq(
        L.Input((6,)), L.Dense(8), L.LeakyReLU(negative_slope=0.05),
        L.ReLU(negative_slope=0.1), L.Dense(3)), (4, 6), None),
    "reshape_wildcard": (lambda: _seq(
        L.Input((6, 6, 2)), L.Conv2D(3, 3, name="c"),
        L.Reshape((-1,), name="rs"), L.Dense(4, name="d")), (2, 6, 6, 2),
        _nchw),
    "reshape_to_image": (lambda: _seq(
        L.Input((12,)), L.Dense(48), L.Reshape((4, 4, 3)),
        L.Conv2D(2, 3, activation="relu"), L.Flatten(),
        L.Dense(3, activation="softmax")), (2, 12), None),
    "residual_add": (lambda: _functional(_residual), (6, 16), None),
    "concat_branches": (lambda: _functional(_concat), (4, 10), None),
    "functional_cnn_flatten": (lambda: _functional(_cnn_flatten),
                               (2, 6, 6, 2), _nchw),
    "mha_self_attention": (lambda: _functional(_mha), (4, 6, 8), _nchw),
    "rescaling_normalization": (lambda: _functional(_rescale), (2, 8, 8, 3),
                                _nchw),
}


def _residual():
    inp = L.Input((16,), name="in0")
    h1 = L.Dense(16, activation="relu", name="d1")(inp)
    h2 = L.Dense(16, activation="relu", name="d2")(h1)
    s = L.Add(name="res")([h1, h2])
    return inp, L.Dense(4, activation="softmax", name="out")(s)


def _concat():
    inp = L.Input((10,), name="in0")
    a = L.Dense(6, activation="tanh", name="a")(inp)
    b = L.Dense(6, activation="relu", name="b")(inp)
    c = L.Concatenate(name="cat")([a, b])
    return inp, L.Dense(3, activation="softmax", name="out")(c)


def _cnn_flatten():
    inp = L.Input((6, 6, 2), name="in0")
    c = L.Conv2D(3, 3, activation="relu", name="c")(inp)
    return inp, L.Dense(4, activation="softmax", name="out")(
        L.Flatten(name="fl")(c))


def _mha():
    inp = L.Input((6, 8), name="seq")
    att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(inp, inp)
    pool = L.GlobalAveragePooling1D(name="gp")(att)
    return inp, L.Dense(3, activation="softmax", name="out")(pool)


def _rescale():
    inp = keras.Input((8, 8, 3), name="in0")
    x = L.Rescaling(scale=1 / 127.5, offset=-1.0, name="resc")(inp)
    x = L.Normalization(axis=-1, mean=[0.2, -0.1, 0.4],
                        variance=[1.5, 0.7, 2.0], name="nrm")(x)
    x = L.Conv2D(4, 3, activation="relu", name="cv")(x)
    x = L.GlobalAveragePooling2D(name="gap")(x)
    return inp, L.Dense(3, activation="softmax", name="d")(x)


def _set_nontrivial(name, m):
    """The reference tests' non-trivial BN statistics and PReLU alphas."""
    if name == "batchnorm":
        bn = m.layers[1]
        gamma, beta, mean, var = bn.get_weights()
        bn.set_weights([gamma * 1.3, beta + 0.2, mean + 0.5, var * 2.0])
    if name == "batchnorm_scale_false":
        bn = m.layers[0]
        beta, mean, var = bn.get_weights()
        bn.set_weights([beta + 0.3, mean + 0.1, var * 1.7])
    if name == "prelu":
        m.layers[1].set_weights([np.full((8,), 0.3, np.float32)])


CASES.update({
    "batchnorm": (lambda: _seq(L.Input((10,)), L.Dense(8, activation="relu"),
                               L.BatchNormalization(),
                               L.Dense(3, activation="softmax")), (6, 10),
                  None),
    "batchnorm_scale_false": (lambda: _seq(
        L.Input((5,)), L.BatchNormalization(scale=False),
        L.Dense(2, activation="softmax")), (6, 5), None),
    "prelu": (lambda: _seq(L.Input((6,)), L.Dense(8), L.PReLU(),
                           L.Dense(3, activation="softmax")), (4, 6), None),
})


#: a dense layer after a 3-d conv: the reference refuses it ("No
#: preprocessor"); the port flattens (d, h, w, c), Keras's order, so the
#: Keras kernel carries unchanged (ROADMAP.md Queue 3)
REFERENCE_REFUSES = {"conv3d_flatten"}


def _import_both(m, weights=None):
    seq = isinstance(m, keras.Sequential)
    js = m.to_json()
    w = _wmap(m) if weights is None else weights
    if seq:
        return (JK.importKerasSequentialModelAndWeights(js, w),
                PK.importKerasSequentialModelAndWeights(js, w, device=CPU))
    return (JK.importKerasModelAndWeights(js, w),
            PK.importKerasModelAndWeights(js, w, device=CPU))


def _out(net, x):
    out = net.output(x)
    out = out[0] if isinstance(out, list) else out
    return np.asarray(out.toNumpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_keras_and_the_reference(name):
    factory, shape, to_native = CASES[name]
    keras.utils.set_random_seed(sum(map(ord, name)) % 1000)
    m = factory()
    _set_nontrivial(name, m)
    rng = np.random.RandomState(len(name))
    x = rng.rand(*shape).astype(np.float32)
    if name == "rescaling_normalization":
        x = x * 255
    if name in REFERENCE_REFUSES:
        with pytest.raises(ValueError, match="No preprocessor"):
            _import_both(m)
        jn, pn = None, PK.importKerasSequentialModelAndWeights(
            m.to_json(), _wmap(m), device=CPU)
    else:
        jn, pn = _import_both(m)
    xn = to_native(x) if to_native else x
    want = np.asarray(m.predict(x, verbose=0))
    got = _out(pn, xn)
    rtol, atol = ((1e-3, 1e-4) if name == "pooling_padding_1d"
                  else (2e-4, 2e-5))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if jn is None:
        return
    ref = _out(jn, xn)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_trailing_activation_folds_into_the_output_layer():
    m = CASES["trailing_activation"][0]()
    pn = PK.importKerasSequentialModelAndWeights(m.to_json(), _wmap(m),
                                                 device=CPU)
    assert len(pn.layers) == 2
    assert pn.layers[-1].activation == "softmax"
    assert pn.layers[-1].lossFunction == "mcxent"


def test_asymmetric_padding_headless_network():
    """ZeroPadding2D((0, 1), (0, 1)) then a strided conv, no head: the
    port returns NCHW (the reference its internal NHWC)."""
    keras.utils.set_random_seed(5)
    m = _seq(L.ZeroPadding2D(padding=((0, 1), (0, 1)), name="zp"),
             L.Conv2D(2, 3, strides=2, name="c"))
    m.build((2, 8, 8, 1))
    jn = JK.importKerasSequentialModelAndWeights(m.to_json(),
                                                 weights=_wmap(m))
    pn = PK.importKerasSequentialModelAndWeights(m.to_json(),
                                                 weights=_wmap(m), device=CPU)
    x = np.random.RandomState(5).rand(2, 8, 8, 1).astype(np.float32)
    want = np.asarray(m(x))
    got = _out(pn, _nchw(x)).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _out(jn, _nchw(x)), rtol=0, atol=1e-6)


def test_config_only_and_variable_length_lstm():
    m = CASES["mlp"][0]()
    conf = PK.importKerasModelConfiguration(m.to_json())
    assert len(conf.layers) == 2
    assert conf.layers[0].nIn == 20 and conf.layers[0].nOut == 32
    raw = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer",
         "config": {"batch_shape": [None, None, 5]}},
        {"class_name": "LSTM", "config": {"name": "l", "units": 4,
                                          "return_sequences": False,
                                          "activation": "tanh"}},
        {"class_name": "Dense", "config": {"name": "d", "units": 2,
                                           "activation": "softmax"}},
    ]}}
    net = PK.importKerasSequentialModelAndWeights(json.dumps(raw),
                                                  device=CPU)
    x = np.random.RandomState(0).rand(2, 5, 9).astype(np.float32)
    assert net.output(x).shape() == (2, 2)


def test_refusals_as_the_reference():
    """Unsupported layers, missing weights, MHA value_dim, PReLU over
    3-d shared axes, ReLU max_value, Normalization axis: each raises the
    reference's exception with its message."""
    raw = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 4]}},
        {"class_name": "Lambda", "config": {"name": "weird"}}]}}
    with pytest.raises(UnsupportedKerasConfigurationException):
        PK.importKerasSequentialModelAndWeights(json.dumps(raw), device=CPU)
    m = _seq(L.Input((4,)), L.Dense(2, activation="softmax"))
    with pytest.raises(InvalidKerasConfigurationException):
        PK.importKerasSequentialModelAndWeights(m.to_json(), {}, device=CPU)
    inp = L.Input((6, 8), name="seq")
    att = L.MultiHeadAttention(num_heads=2, key_dim=4, value_dim=5,
                               name="mha")(inp, inp)
    mm = keras.Model(inp, L.Dense(3, name="out")(
        L.GlobalAveragePooling1D(name="gp")(att)))
    with pytest.raises(UnsupportedKerasConfigurationException,
                       match="value_dim"):
        PK.importKerasModelAndWeights(mm.to_json(), _wmap(mm), device=CPU)
    raw = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer",
         "config": {"batch_shape": [None, 4, 4, 4, 2]}},
        {"class_name": "PReLU",
         "config": {"name": "p", "shared_axes": [1, 2, 3, 4]}}]}}
    with pytest.raises(UnsupportedKerasConfigurationException,
                       match="shared_axes"):
        PK.importKerasSequentialModelAndWeights(json.dumps(raw), {},
                                                device=CPU)
    spec = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer",
         "config": {"batch_input_shape": [None, 4]}},
        {"class_name": "ReLU", "config": {"name": "r", "max_value": 4.0}},
        {"class_name": "Dense", "config": {"name": "d", "units": 2}}]}}
    with pytest.raises(UnsupportedKerasConfigurationException,
                       match="max_value"):
        PK.importKerasSequentialModelAndWeights(spec, device=CPU)
    inp = keras.Input((4, 4, 3))
    x = L.Normalization(axis=1, mean=np.zeros((4, 1, 1)),
                        variance=np.ones((4, 1, 1)))(inp)
    km = keras.Model(inp, L.Flatten()(x))
    with pytest.raises(UnsupportedKerasConfigurationException,
                       match="axis"):
        PK.importKerasModelAndWeights(km.to_json(), device=CPU)


def test_trailing_noise_layer_keeps_the_output_head():
    m = _seq(L.Input((6,)), L.Dense(8, activation="relu"),
             L.Dense(2, activation="softmax"), L.GaussianNoise(0.1))
    with pytest.warns(UserWarning, match="dropping trailing"):
        net = PK.importKerasSequentialModelAndWeights(m.to_json(), _wmap(m),
                                                      device=CPU)
    assert any(isinstance(l, BaseOutputLayer) for l in net.layers)
    x = np.random.RandomState(5).rand(4, 6).astype(np.float32)
    net.fit(x, np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    assert np.isfinite(net.score())


def _write_legacy_h5(path, model):
    """The legacy tf.keras H5 layout (model_config attr and
    model_weights/<name> groups with weight_names), as the reference's
    test writes it."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = model.to_json()
        g = f.create_group("model_weights")
        for l in model.layers:
            ws = l.get_weights()
            if not ws:
                continue
            lg = g.create_group(l.name)
            names = []
            for i, w in enumerate(ws):
                dname = f"{l.name}/param_{i}:0"
                lg.create_dataset(dname, data=w)
                names.append(dname.encode())
            lg.attrs["weight_names"] = names


def test_legacy_h5_roundtrip(tmp_path):
    m = _seq(L.Input((10,)), L.Dense(16, activation="relu"),
             L.Dense(4, activation="softmax"))
    p = str(tmp_path / "model.h5")
    _write_legacy_h5(p, m)
    net = PK.importKerasSequentialModelAndWeights(p, p, device=CPU)
    x = np.random.RandomState(7).rand(5, 10).astype(np.float32)
    got = _out(net, x)
    np.testing.assert_allclose(got, m.predict(x, verbose=0),
                               rtol=2e-4, atol=2e-5)
    ref = _out(JK.importKerasSequentialModelAndWeights(p, p), x)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_mobilenet_v1_application(tmp_path):
    """keras.applications.MobileNet (standalone ReLU(6), DepthwiseConv2D,
    keepdims pooling, Reshape, asymmetric pads) through both importers."""
    keras.utils.set_random_seed(3)
    km = tf.keras.applications.MobileNet(weights=None,
                                         input_shape=(64, 64, 3), classes=5)
    jn, pn = _import_both(km)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    got = _out(pn, _nchw(x))
    np.testing.assert_allclose(got, km.predict(x, verbose=0), rtol=1e-3,
                               atol=1e-4)
    ref = _out(jn, _nchw(x))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _save(tmp_path, model, name):
    p = str(tmp_path / name)
    model.save(p)
    return p


@pytest.mark.parametrize("case", ["sequential", "functional_cnn",
                                  "eleven_plus", "dropout"])
def test_keras3_archives(case, tmp_path):
    """TestKeras3ArchiveImport: one .keras file (config and weights)
    through both importers, against Keras's call; the group names are
    recomputed from the config, so 12 same-class layers keep their
    order and var-less layers shift nothing."""
    keras.utils.set_random_seed(11 + len(case))
    if case == "sequential":
        m = _seq(L.Input((6,)), L.Dense(10, activation="relu", name="h1"),
                 L.Dense(4, activation="softmax", name="out"))
        x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    elif case == "functional_cnn":
        inp = L.Input((8, 8, 2))
        h = L.Conv2D(4, 3, padding="same", activation="relu", name="c1")(inp)
        h = L.Flatten(name="f")(L.MaxPooling2D(2, name="p1")(h))
        m = keras.Model(inp, L.Dense(3, activation="softmax", name="o")(h))
        x = np.random.RandomState(1).rand(2, 8, 8, 2).astype(np.float32)
    elif case == "eleven_plus":
        m = _seq(*([L.Input((4,))]
                   + [L.Dense(4, activation="tanh", name=f"L{i}")
                      for i in range(12)]
                   + [L.Dense(2, activation="softmax", name="out")]))
        x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    else:
        m = _seq(L.Input((6,)), L.Dense(8, activation="relu"),
                 L.Dropout(0.5), L.Dense(3, activation="softmax"))
        x = np.random.RandomState(4).randn(3, 6).astype(np.float32)
    p = _save(tmp_path, m, f"{case}.keras")
    if isinstance(m, keras.Sequential):
        jn = JK.importKerasSequentialModelAndWeights(p)
        pn = PK.importKerasSequentialModelAndWeights(p, device=CPU)
    else:
        jn = JK.importKerasModelAndWeights(p)
        pn = PK.importKerasModelAndWeights(p, device=CPU)
    xn = _nchw(x) if x.ndim == 4 else x
    got = _out(pn, xn)
    np.testing.assert_allclose(got, np.asarray(m(x, training=False)),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got, _out(jn, xn), rtol=0,
                               atol=1e-5 * np.abs(got).max())
    assert PK._parse_config(p)["class_name"] == m.__class__.__name__ \
        or PK._parse_config(p)["class_name"] in ("Functional", "Model")


def test_card_resnet50_config_is_keras_applications_resnet50():
    """tests/_torch_keras_models.py's ResNet-50 config (what the card
    imports with no tensorflow) at 64x64 and 5 classes: with its seeded
    weights set into keras.applications.ResNet50, Keras's predict, the
    import of Keras's own to_json and the import of the dict agree, and
    the zoo ResNet50 holding the same arrays through the pretrained
    mapping gives the same logits (within 1e-5 of their max-abs)."""
    import _torch_keras_models as km

    from deeplearning4j_tpu_torch.zoo import ResNet50
    from deeplearning4j_tpu_torch.zoo.pretrained import _map_keras_weights

    cfg = km.resnet50_config(64, 5)
    w = km.resnet50_weights(cfg, seed=3)
    keras.utils.set_random_seed(0)
    kmodel = tf.keras.applications.ResNet50(weights=None,
                                            input_shape=(64, 64, 3),
                                            classes=5)
    names = {l["name"] for l in cfg["config"]["layers"]}
    assert {l.name for l in kmodel.layers[1:]} == names - {"input_1"}
    for layer in kmodel.layers:
        if layer.name in w:
            layer.set_weights(w[layer.name])
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    golden = kmodel.predict(x, verbose=0)
    mine = PK.importKerasModelAndWeights(cfg, weights=w, device=CPU)
    theirs = PK.importKerasModelAndWeights(kmodel.to_json(), weights=w,
                                           device=CPU)
    got = _out(mine, _nchw(x))
    np.testing.assert_array_equal(got, _out(theirs, _nchw(x)))
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-4)
    model = ResNet50(numClasses=5, inputShape=(3, 64, 64), device=CPU)
    zoo = _map_keras_weights(model, model.init(), w)
    np.testing.assert_allclose(_out(zoo, _nchw(x)), got, rtol=0,
                               atol=1e-5 * np.abs(got).max())


def test_card_mha_encoder_config_is_a_keras_model():
    """tests/_torch_keras_models.py's MultiHeadAttention encoder at small
    widths: the reference's importer accepts the dict, and with its
    seeded weights both importers give Keras's predict."""
    import _torch_keras_models as km

    cfg = km.mha_encoder_config(seq=6, dim=8, heads=2, key_dim=4, blocks=2,
                                classes=3)
    w = km.mha_encoder_weights(cfg, seed=1)
    inp = L.Input((6, 8), name="tokens")
    x = inp
    for i in range(2):
        a = L.MultiHeadAttention(num_heads=2, key_dim=4, name=f"mha{i}")(x, x)
        x = L.Add(name=f"res{i}")([x, a])
    out = L.Dense(3, activation="softmax", name="out")(
        L.GlobalAveragePooling1D(name="pool")(x))
    kmodel = keras.Model(inp, out)
    for layer in kmodel.layers:
        if layer.name in w:
            layer.set_weights(w[layer.name])
    x = np.random.RandomState(2).randn(4, 6, 8).astype(np.float32)
    golden = kmodel.predict(x, verbose=0)
    jn = JK.importKerasModelAndWeights(cfg, weights=w)
    pn = PK.importKerasModelAndWeights(cfg, weights=w, device=CPU)
    got = _out(pn, _nchw(x))
    np.testing.assert_allclose(got, golden, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, _out(jn, _nchw(x)), rtol=0,
                               atol=1e-5 * np.abs(got).max())
