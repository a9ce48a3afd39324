"""Keras functional model configs written as dicts, with seeded weights in
Keras's layouts (no jax, no tensorflow, no h5py: ``chip_smoke.py``
imports this file on the card's machine; the CPU tests hold its configs
to Keras's own ``to_json``).

``resnet50_config(size, classes)`` is ``keras.applications.ResNet50``'s
functional config (its layer names and kinds: the 7x7 stem behind
ZeroPadding2D, BN at epsilon 1.001e-5, the bottlenecks with the stride
on the first 1x1, Add and the relu Activations, global average pooling,
a softmax Dense "predictions"), and ``resnet50_weights`` its seeded
weights by layer name: He-normal kernels, zero conv biases (Keras's
initializer; the zoo's convs have none), BN gamma/beta/mean/var drawn
near 1/0/0/1. ``mha_encoder_config`` is a MultiHeadAttention encoder of
layer kinds the reference's importer accepts (self-attention,
residual Add, GlobalAveragePooling1D, Dense) and ``mha_encoder_weights``
its seeded weights in Keras's [E, H, hs] / [H, hs, E] layout.
"""

import numpy as np

STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
          (3, 512, 2048, 2))


class _Builder:
    """Keras-2 functional JSON: each layer with its inbound nodes."""

    def __init__(self):
        self.layers = []

    def add(self, cls, name, inbound=(), **cfg):
        cfg["name"] = name
        nodes = [[[i, 0, 0, {}] for i in inbound]] if inbound else []
        self.layers.append({"class_name": cls, "config": cfg, "name": name,
                            "inbound_nodes": nodes})
        return name

    def config(self, inputs, outputs):
        return {"class_name": "Functional", "config": {
            "name": "model", "layers": self.layers,
            "input_layers": [[n, 0, 0] for n in inputs],
            "output_layers": [[n, 0, 0] for n in outputs]}}


def _conv(b, name, inp, filters, k, s=1, padding="valid"):
    return b.add("Conv2D", name, [inp], filters=filters, kernel_size=[k, k],
                 strides=[s, s], padding=padding, dilation_rate=[1, 1],
                 activation="linear", use_bias=True)


def _bn(b, name, inp):
    return b.add("BatchNormalization", name, [inp], axis=3, momentum=0.99,
                 epsilon=1.001e-5, center=True, scale=True)


def _act(b, name, inp):
    return b.add("Activation", name, [inp], activation="relu")


def resnet50_config(size=224, classes=1000):
    """keras.applications.ResNet50(weights=None, input_shape=(size, size,
    3), classes=classes)'s functional config, as a dict."""
    b = _Builder()
    x = b.add("InputLayer", "input_1",
              batch_input_shape=[None, size, size, 3], dtype="float32")
    x = b.add("ZeroPadding2D", "conv1_pad", [x], padding=[[3, 3], [3, 3]])
    x = _conv(b, "conv1_conv", x, 64, 7, 2)
    x = _act(b, "conv1_relu", _bn(b, "conv1_bn", x))
    x = b.add("ZeroPadding2D", "pool1_pad", [x], padding=[[1, 1], [1, 1]])
    x = b.add("MaxPooling2D", "pool1_pool", [x], pool_size=[3, 3],
              strides=[2, 2], padding="valid")
    for si, (blocks, mid, out, stride) in enumerate(STAGES):
        for bi in range(blocks):
            p = f"conv{si + 2}_block{bi + 1}"
            s = stride if bi == 0 else 1
            if bi == 0:
                sc = _bn(b, f"{p}_0_bn", _conv(b, f"{p}_0_conv", x, out, 1, s))
            else:
                sc = x
            y = _act(b, f"{p}_1_relu", _bn(b, f"{p}_1_bn", _conv(
                b, f"{p}_1_conv", x, mid, 1, s)))
            y = _act(b, f"{p}_2_relu", _bn(b, f"{p}_2_bn", _conv(
                b, f"{p}_2_conv", y, mid, 3, padding="same")))
            y = _bn(b, f"{p}_3_bn", _conv(b, f"{p}_3_conv", y, out, 1))
            x = _act(b, f"{p}_out", b.add("Add", f"{p}_add", [sc, y]))
    x = b.add("GlobalAveragePooling2D", "avg_pool", [x], keepdims=False)
    b.add("Dense", "predictions", [x], units=classes, activation="softmax",
          use_bias=True)
    return b.config(["input_1"], ["predictions"])


def resnet50_weights(config, seed=0):
    """{layer name: [arrays]} in Keras's layouts for `config`'s Conv2D,
    BatchNormalization and Dense layers, from `seed`."""
    rng = np.random.default_rng(seed)
    shapes = {"input_1": 3}
    out = {}
    for layer in config["config"]["layers"]:
        cls, cfg, name = layer["class_name"], layer["config"], layer["name"]
        ins = [n[0] for n in layer["inbound_nodes"][0]] \
            if layer["inbound_nodes"] else []
        c_in = shapes.get(ins[0]) if ins else None
        if cls == "Conv2D":
            k, f = cfg["kernel_size"][0], cfg["filters"]
            w = rng.standard_normal((k, k, c_in, f), dtype=np.float32)
            out[name] = [w * np.float32(np.sqrt(2.0 / (k * k * c_in))),
                         np.zeros(f, np.float32)]
            shapes[name] = f
        elif cls == "BatchNormalization":
            out[name] = [
                (1.0 + 0.1 * rng.standard_normal(c_in)).astype(np.float32),
                (0.1 * rng.standard_normal(c_in)).astype(np.float32),
                (0.1 * rng.standard_normal(c_in)).astype(np.float32),
                (0.5 + rng.random(c_in)).astype(np.float32)]
            shapes[name] = c_in
        elif cls == "Dense":
            u = cfg["units"]
            out[name] = [(rng.standard_normal((c_in, u), dtype=np.float32)
                          * np.float32(np.sqrt(1.0 / c_in))),
                         (0.01 * rng.standard_normal(u)).astype(np.float32)]
            shapes[name] = u
        elif ins:
            shapes[name] = shapes[ins[0]]
    return out


def mha_encoder_config(seq=512, dim=768, heads=12, key_dim=64, blocks=2,
                       classes=10):
    """Self-attention blocks with residual adds over [seq, dim], pooled
    over time into a softmax Dense: a MultiHeadAttention encoder of the
    reference importer's layer kinds."""
    b = _Builder()
    x = b.add("InputLayer", "tokens", batch_input_shape=[None, seq, dim],
              dtype="float32")
    for i in range(blocks):
        a = b.add("MultiHeadAttention", f"mha{i}", [x, x], num_heads=heads,
                  key_dim=key_dim, value_dim=key_dim, use_bias=True,
                  output_shape=None, dropout=0.0)
        x = b.add("Add", f"res{i}", [x, a])
    x = b.add("GlobalAveragePooling1D", "pool", [x])
    b.add("Dense", "out", [x], units=classes, activation="softmax",
          use_bias=True)
    return b.config(["tokens"], ["out"])


def mha_encoder_weights(config, seed=0):
    """{layer name: [arrays]} for `config`: each MultiHeadAttention's
    query/key/value kernels [E, H, hs] and biases [H, hs], its output
    kernel [H, hs, E] and bias [E] (Keras's order), the Dense's."""
    rng = np.random.default_rng(seed)
    dim = config["config"]["layers"][0]["config"]["batch_input_shape"][2]
    out = {}
    for layer in config["config"]["layers"]:
        cfg, name = layer["config"], layer["name"]
        if layer["class_name"] == "MultiHeadAttention":
            h, hs = cfg["num_heads"], cfg["key_dim"]
            scale = np.float32(np.sqrt(1.0 / dim))
            ws = []
            for _ in range(3):
                ws += [rng.standard_normal((dim, h, hs), dtype=np.float32)
                       * scale,
                       (0.02 * rng.standard_normal((h, hs))).astype(
                           np.float32)]
            ws += [rng.standard_normal((h, hs, dim), dtype=np.float32)
                   * np.float32(np.sqrt(1.0 / (h * hs))),
                   (0.02 * rng.standard_normal(dim)).astype(np.float32)]
            out[name] = ws
        elif layer["class_name"] == "Dense":
            u = cfg["units"]
            out[name] = [(rng.standard_normal((dim, u), dtype=np.float32)
                          * np.float32(np.sqrt(1.0 / dim))),
                         (0.01 * rng.standard_normal(u)).astype(np.float32)]
    return out
