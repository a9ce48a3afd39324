"""Local pretrained-weight loading for zoo models.

The counterpart of ``deeplearning4j_tpu/zoo/pretrained.py`` (reference:
deeplearning4j-zoo ZooModel.initPretrained): the user supplies a local
Keras-applications HDF5 or Keras 3 ``.keras`` file, and its per-layer
weights are mapped onto the zoo network by the Keras importer's
converter (``modelimport.keras._apply_weights``); ``convertPretrained``
banks the result as a ModelSerializer file. Reading the file
(``h5py``, imported inside the reading call) is split from mapping the
arrays (``_map_keras_weights``, over a ``{keras layer name: [arrays]}``
dict), so the mapping runs where ``h5py`` is absent.

Supported architectures and their Keras-applications layer namings:

- ResNet50   — "conv1_conv"/"conv1_bn"/"convS_blockB_{0,1,2,3}_{conv,bn}"/
               "predictions" (keras.applications.resnet; stride on the
               first 1x1 of each block, exactly our `_bottleneck`)
- VGG16/19   — "blockB_convI" / "fc1" / "fc2" / "predictions"
               (keras.applications.vgg16/vgg19)

Anything else raises with the list of supported classes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["loadKerasApplicationsWeights", "convertPretrained"]

# Intra-package reuse of the Keras weight converter internals: these are
# the single source of truth for Keras->native layout rules (LSTM gate
# order, BN gamma/beta/mean/var, flatten row permutation).
from deeplearning4j_tpu_torch.modelimport.keras import (
    _apply_weights,
    _flatten_reorder,
    _load_h5_weights,
    InvalidKerasConfigurationException,
)


def _resnet50_map(model):
    """[(our graph-layer name, keras layer name)] for zoo.ResNet50."""
    pairs = [("conv1", "conv1_conv"), ("bn1", "conv1_bn")]
    stages = [(3, 0), (4, 1), (6, 2), (3, 3)]  # (blocks, our stage idx)
    for blocks, si in stages:
        for bi in range(blocks):
            ours = f"s{si}b{bi}"
            keras = f"conv{si + 2}_block{bi + 1}"
            pairs += [(f"{ours}_c1", f"{keras}_1_conv"),
                      (f"{ours}_b1", f"{keras}_1_bn"),
                      (f"{ours}_c2", f"{keras}_2_conv"),
                      (f"{ours}_b2", f"{keras}_2_bn"),
                      (f"{ours}_c3", f"{keras}_3_conv"),
                      (f"{ours}_b3", f"{keras}_3_bn")]
            if bi == 0:
                pairs += [(f"{ours}_proj", f"{keras}_0_conv"),
                          (f"{ours}_projbn", f"{keras}_0_bn")]
    pairs.append(("fc", "predictions"))
    return pairs


def _vgg_map(model, net):
    """[(our MLN layer index, keras layer name)] for zoo.VGG16/VGG19."""
    pairs = []
    block, ci, li = 1, 1, 0
    for item in type(model)._CFG:
        if item == "M":
            block += 1
            ci = 1
            li += 1  # SubsamplingLayer, no params
        else:
            pairs.append((li, f"block{block}_conv{ci}"))
            ci += 1
            li += 1
    pairs += [(li, "fc1"), (li + 1, "fc2"), (li + 2, "predictions")]
    return pairs


def loadKerasApplicationsWeights(model, net, h5path):
    """Map a Keras-applications h5 (or a Keras 3 ``.keras`` archive) onto
    an initialised zoo network in place. `model` is the ZooModel
    (architecture metadata), `net` the network from ``model.init()``."""
    if str(h5path).endswith(".keras"):
        # the Keras 3 loader recomputes group names from the archived
        # config, so the map has the layer names a legacy h5 uses
        from deeplearning4j_tpu_torch.modelimport.keras import (
            _load_keras3_archive,
        )

        _, wmap = _load_keras3_archive(h5path)
    else:
        wmap = _load_h5_weights(h5path)
    if not wmap:
        raise InvalidKerasConfigurationException(
            f"{h5path} contains no layer weights (expected a legacy-format "
            "Keras HDF5 — model.save('x.h5') / save_weights('x.h5') — or a "
            "Keras-3 .keras archive)")
    return _map_keras_weights(model, net, wmap, source=h5path)


def _map_keras_weights(model, net, wmap, source="the weights"):
    """Map a {keras layer name: [arrays]} dict onto `net` in place (the
    body of ``loadKerasApplicationsWeights``, with no file)."""
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )
    from deeplearning4j_tpu_torch.zoo import models as _zoo

    def keras_weights(kname):
        if kname in wmap:
            return list(wmap[kname])
        # older keras-applications generations name the resnet head
        # fc1000; accept it for "predictions"
        if kname == "predictions" and "fc1000" in wmap:
            return list(wmap["fc1000"])
        raise InvalidKerasConfigurationException(
            f"{source} has no weights for expected layer '{kname}' — "
            f"file has: {sorted(wmap)[:12]}... Is this the right "
            f"architecture ({type(model).__name__})?")

    if isinstance(model, _zoo.ResNet50):
        if model.stemMode != "standard":
            raise InvalidKerasConfigurationException(
                "load Keras weights with stemMode='standard'; then convert "
                "the stem via ResNet50.stem_weights_to_s2d")
        for ours, kname in _resnet50_map(model):
            layer = net.conf.nodes[ours].payload
            net._params[ours], net._states[ours] = _apply_weights(
                layer, keras_weights(kname), net._params[ours],
                net._states[ours])
        return net
    if isinstance(model, _zoo.VGG16):  # covers VGG19 subclass
        for li, kname in _vgg_map(model, net):
            layer = net.layers[li]
            w = keras_weights(kname)
            pp = net.conf.preprocessors.get(li)
            if kname == "fc1" and isinstance(pp, CnnToFeedForwardPreProcessor):
                # Keras flattened (h,w,c); the preprocessor flattens (c,h,w)
                w[0] = _flatten_reorder(np.asarray(w[0]), pp.inputHeight,
                                        pp.inputWidth, pp.numChannels)
            net._params[li], net._states[li] = _apply_weights(
                layer, w, net._params[li], net._states[li])
        return net
    raise InvalidKerasConfigurationException(
        f"no Keras-applications weight mapping registered for "
        f"{type(model).__name__}; supported: ResNet50, VGG16, VGG19. "
        "For other architectures import the full Keras model via "
        "modelimport.KerasModelImport, or load a native checkpoint.")


def convertPretrained(model, h5path, outPath):
    """Keras-applications h5 -> native ModelSerializer checkpoint.
    Returns the loaded network. (Upstream analog: the one-time download+
    cache step of ZooModel.initPretrained.)"""
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

    net = loadKerasApplicationsWeights(model, model.init(), h5path)
    ModelSerializer.writeModel(net, outPath)
    return net
