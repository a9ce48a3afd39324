"""Keras model import: config JSON (+ optional weights) -> networks.

The counterpart of ``deeplearning4j_tpu/modelimport/keras.py``
(reference: org.deeplearning4j.nn.modelimport.keras.KerasModelImport):
Keras 2 (tf.keras legacy) and Keras 3 ``model.to_json()`` configs become
a MultiLayerNetwork (Sequential) or a ComputationGraph (Functional) with
the reference's layer mapping, and weights come from a legacy Keras
HDF5 file, a Keras 3 ``.keras`` archive, or a ``{layerName: [arrays]}``
dict (``layer.get_weights()``). ``h5py`` is imported only inside the
calls that read such a file, so a config with a weights dict needs
neither ``h5py`` nor ``tensorflow``.

Layouts: imported networks take the API's NCHW / NCW data, as the
reference's. ``_apply_weights`` builds each array in the reference's
parameter layout (Dense ``[in, out]``, Conv2D HWIO, the LSTM gates
reordered from Keras's [i, f, g, o] to [i, f, o, g], a depthwise kernel
as the grouped ``[kh, kw, 1, C·m]``) and hands it to the layer's
``param_from_reference``, so one map serves the importer, the
pretrained mapping and the reference's files. A Flatten after a conv
reorders the dense kernel's rows from Keras's (h, w, c) to the
networks' (c, h, w) (``_flatten_reorder``); after a 3-d conv the
networks flatten (d, h, w, c), Keras's own order.
"""

from __future__ import annotations

import json
import re

import numpy as np

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import recurrent as R
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["KerasModelImport", "KerasReshapeLayer",
           "InvalidKerasConfigurationException",
           "UnsupportedKerasConfigurationException"]


class InvalidKerasConfigurationException(ValueError):
    pass


class UnsupportedKerasConfigurationException(ValueError):
    pass


_ACTIVATIONS = {
    "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "linear": "identity", "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "swish": "swish", "silu": "swish", "gelu": "gelu",
    "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
    "mish": "mish",
}


def _act(name):
    if name is None:
        return "identity"
    try:
        return _ACTIVATIONS[str(name)]
    except KeyError:
        raise UnsupportedKerasConfigurationException(
            f"unsupported Keras activation '{name}'") from None


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _leaky(alpha):
    """Exact-alpha leaky-relu closure (activations.get accepts
    callables): Keras slopes are arbitrary and rarely match the
    registry's leakyrelu(0.01). Callable activations don't serialize —
    re-export such imports via Keras, not ModelSerializer."""
    return lambda x: torch.nn.functional.leaky_relu(x, alpha)


def _conv_mode(padding):
    p = str(padding).lower()
    if p == "valid":
        return "truncate"
    if p == "same":
        return "same"
    raise UnsupportedKerasConfigurationException(f"unsupported padding '{padding}'")


def _input_type_from_shape(shape):
    """Keras shape tuple (batch dim stripped) → InputType. channels_last:
    (H,W,C) → CNN; (T,F) → recurrent [F,T] (T may be None = variable);
    (N,) → feedForward. Rank is judged with None dims INCLUDED — (None, F)
    is a variable-length sequence, not flat features."""
    dims = list(shape)
    if len(dims) == 4:
        d, h, w, c = dims
        if None in (d, h, w, c):
            raise UnsupportedKerasConfigurationException(
                f"variable spatial dims not supported for 3D-CNN input "
                f"{shape} (the networks' shapes are static)")
        return InputType.convolutional3D(d, h, w, c)
    if len(dims) == 3:
        h, w, c = dims
        if h is None or w is None or c is None:
            raise UnsupportedKerasConfigurationException(
                f"variable spatial dims not supported for CNN input {shape} "
                "(the networks' shapes are static)")
        return InputType.convolutional(h, w, c)
    if len(dims) == 2:
        t, f = dims
        if f is None:
            raise UnsupportedKerasConfigurationException(
                f"variable feature dim in recurrent input {shape}")
        return InputType.recurrent(f, t)
    if len(dims) == 1:
        if dims[0] is None:
            raise UnsupportedKerasConfigurationException(
                f"variable feature dim in input {shape}")
        return InputType.feedForward(dims[0])
    raise UnsupportedKerasConfigurationException(f"unsupported input shape {shape}")


class KerasReshapeLayer(L.Layer):
    """Keras Reshape(target_shape), per example, in Keras's channels_last
    order: a CNN activation is reshaped through its NHWC view and an
    [h, w, c] target returns to the networks' NCHW-logical layout.
    Targets: [features] (flatten) or [h, w, c]."""

    def __init__(self, targetShape, **kw):
        super().__init__(**kw)
        self.targetShape = tuple(int(v) for v in targetShape)

    def hasParams(self):
        return False

    def _resolve(self, inputType):
        """Resolve one -1 wildcard (Keras allows it; Reshape((-1,)) is
        the common flatten idiom) against the input's element count."""
        t = list(self.targetShape)
        if t.count(-1) > 1 or any(v < 1 and v != -1 for v in t):
            raise InvalidKerasConfigurationException(
                f"Reshape target {tuple(t)} invalid: at most one -1 "
                "wildcard, all other dims positive")
        if -1 in t:
            total = inputType.arrayElementsPerExample()
            known = 1
            for v in t:
                if v != -1:
                    known *= v
            if total % known:
                raise InvalidKerasConfigurationException(
                    f"Reshape target {tuple(t)}: {total} elements per "
                    f"example not divisible by {known}")
            t[t.index(-1)] = total // known
        return tuple(t)

    def getOutputType(self, inputType):
        t = self._resolved = self._resolve(inputType)
        if len(t) == 1:
            return InputType.feedForward(t[0])
        h, w, c = t
        return InputType.convolutional(h, w, c)

    def forward(self, params, state, x, train, key, mask=None):
        # -1 resolution happened during shape inference (getOutputType
        # always runs at build); fall back to the raw target otherwise
        t = getattr(self, "_resolved", self.targetShape)
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        y = x.reshape((x.shape[0],) + t)
        return (y.permute(0, 3, 1, 2) if len(t) == 3 else y), state


class _KerasLayerSpec:
    """One parsed Keras layer: class name, config, inbound names."""

    def __init__(self, raw):
        self.className = raw.get("class_name")
        self.config = raw.get("config", {})
        self.name = self.config.get("name") or raw.get("name")
        self.inbound = []
        for node in raw.get("inbound_nodes", []):
            if isinstance(node, dict):  # Keras 3: {"args": [...]} history refs
                for a in _walk_keras3_history(node):
                    self.inbound.append(a)
            elif isinstance(node, list):  # Keras 2: [[name, idx, tensor_idx, {}]...]
                for ref in node:
                    self.inbound.append(ref[0])

    def inputShape(self):
        for k in ("batch_input_shape", "batch_shape"):
            if self.config.get(k):
                return self.config[k][1:]
        return None


def _walk_keras3_history(node):
    """Extract inbound layer names from a Keras-3 serialized call node."""
    out = []

    def rec(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                hist = obj.get("config", {}).get("keras_history")
                if hist:
                    out.append(hist[0])
            else:
                for v in obj.values():
                    rec(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                rec(v)

    rec(node.get("args", []))
    rec(node.get("kwargs", {}))
    return out


# ---------------------------------------------------------------------------
# layer conversion
# ---------------------------------------------------------------------------

def _normalization_guards(cfg, name):
    """Shared keras.layers.Normalization support checks (channels-last
    stats, no invert) for both the adapt-mode BN mapping and the
    constructor-mode vertex mapping."""
    axis = cfg.get("axis", -1)
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    if axis not in ((-1,), (3,)):
        raise UnsupportedKerasConfigurationException(
            f"Normalization over axis {axis} not supported "
            f"(channels-last only; layer '{name}')")
    if cfg.get("invert", False):
        raise UnsupportedKerasConfigurationException(
            f"Normalization(invert=True) not supported (layer '{name}')")


def _convert_layer(spec: _KerasLayerSpec, is_last: bool):
    """Keras layer spec → (native layer | None, activation carried)."""
    cn, cfg = spec.className, spec.config
    name = spec.name

    if cn == "InputLayer":
        return None
    if cn == "Dense":
        act = _act(cfg.get("activation"))
        units = int(cfg["units"])
        bias = bool(cfg.get("use_bias", True))
        if is_last:
            loss = {"softmax": "mcxent", "sigmoid": "xent"}.get(act, "mse")
            return L.OutputLayer(nOut=units, activation=act, hasBias=bias,
                                 lossFunction=loss, name=name)
        return L.DenseLayer(nOut=units, activation=act, hasBias=bias, name=name)
    if cn == "Conv2D":
        return L.ConvolutionLayer(
            nOut=int(cfg["filters"]), kernelSize=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            convolutionMode=_conv_mode(cfg.get("padding", "valid")),
            hasBias=bool(cfg.get("use_bias", True)),
            activation=_act(cfg.get("activation")), name=name)
    if cn == "DepthwiseConv2D":
        return L.DepthwiseConvolution2D(
            depthMultiplier=int(cfg.get("depth_multiplier", 1)),
            kernelSize=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            convolutionMode=_conv_mode(cfg.get("padding", "valid")),
            hasBias=bool(cfg.get("use_bias", True)),
            activation=_act(cfg.get("activation")), name=name)
    if cn in ("MaxPooling2D", "AveragePooling2D"):
        return L.SubsamplingLayer(
            poolingType="max" if cn.startswith("Max") else "avg",
            kernelSize=_pair(cfg.get("pool_size", 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
            convolutionMode=_conv_mode(cfg.get("padding", "valid")), name=name)
    if cn in ("MaxPooling1D", "AveragePooling1D"):
        if str(cfg.get("padding", "valid")).lower() == "same":
            raise UnsupportedKerasConfigurationException(
                f"{cn} padding='same' not supported (layer '{name}'); "
                "pad explicitly with ZeroPadding1D")
        return L.Subsampling1DLayer(
            poolingType="max" if cn.startswith("Max") else "avg",
            kernelSize=cfg.get("pool_size", 2),
            stride=cfg.get("strides") or cfg.get("pool_size", 2),
            name=name)
    if cn == "ZeroPadding1D":
        return L.ZeroPadding1DLayer(padding=cfg.get("padding", 1), name=name)
    if cn == "Cropping1D":
        return L.Cropping1D(cropping=cfg.get("cropping", 0), name=name)
    if cn in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
              "GlobalMaxPooling1D", "GlobalAveragePooling1D",
              "GlobalMaxPooling3D", "GlobalAveragePooling3D"):
        return L.GlobalPoolingLayer(
            poolingType="max" if "Max" in cn else "avg",
            # keepdims=True (MobileNet heads) = upstream's
            # collapseDimensions(false): pooled dims stay as size 1
            collapseDimensions=not cfg.get("keepdims", False), name=name)
    if cn == "Flatten":
        return None  # our shape inference auto-inserts CnnToFeedForward
    if cn == "Dropout":
        return L.DropoutLayer(dropOut=1.0 - float(cfg.get("rate", 0.5)), name=name)
    if cn in ("SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D"):
        from deeplearning4j_tpu_torch.nn.conf.dropout import SpatialDropout
        return L.DropoutLayer(
            dropOut=SpatialDropout(1.0 - float(cfg.get("rate", 0.5))), name=name)
    if cn == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.conf.dropout import GaussianDropout
        return L.DropoutLayer(dropOut=GaussianDropout(float(cfg.get("rate", 0.5))),
                              name=name)
    if cn == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.conf.dropout import GaussianNoise
        return L.DropoutLayer(dropOut=GaussianNoise(float(cfg.get("stddev", 0.1))),
                              name=name)
    if cn == "AlphaDropout":
        from deeplearning4j_tpu_torch.nn.conf.dropout import AlphaDropout
        return L.DropoutLayer(dropOut=AlphaDropout(1.0 - float(cfg.get("rate", 0.5))),
                              name=name)
    if cn == "PReLU":
        # Keras shared_axes are 1-based over the NHWC input's (H, W, C) =
        # (1, 2, 3); native sharedAxes use the reference's (C, H, W) order.
        # Only the 2D-CNN axis set is supported (a 3D-CNN PReLU would need
        # NDHWC axes 1-4).
        shared = cfg.get("shared_axes") or ()
        if any(int(a) not in (1, 2, 3) for a in shared):
            raise UnsupportedKerasConfigurationException(
                f"PReLU shared_axes {list(shared)} not supported "
                f"(only 2D-CNN axes 1-3; layer '{name}')")
        mapped = tuple({1: 2, 2: 3, 3: 1}[int(a)] for a in shared) or None
        return L.PReLULayer(sharedAxes=mapped, name=name)
    if cn == "Conv3D":
        t3 = lambda v: (v, v, v) if isinstance(v, int) else tuple(v)
        return L.Convolution3D(
            nOut=int(cfg["filters"]), kernelSize=t3(cfg["kernel_size"]),
            stride=t3(cfg.get("strides", 1)),
            dilation=t3(cfg.get("dilation_rate", 1)),
            convolutionMode=_conv_mode(cfg.get("padding", "valid")),
            hasBias=bool(cfg.get("use_bias", True)),
            activation=_act(cfg.get("activation")), name=name)
    if cn == "SeparableConv2D":
        return L.SeparableConvolution2D(
            nOut=int(cfg["filters"]),
            depthMultiplier=int(cfg.get("depth_multiplier", 1)),
            kernelSize=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            convolutionMode=_conv_mode(cfg.get("padding", "valid")),
            hasBias=bool(cfg.get("use_bias", True)),
            activation=_act(cfg.get("activation")), name=name)
    if cn == "Cropping2D":
        crop = cfg.get("cropping", 0)
        if isinstance(crop, int):
            crop = (crop, crop, crop, crop)
        elif crop and isinstance(crop[0], (list, tuple)):
            (t, b), (l, r) = crop
            crop = (t, b, l, r)
        return L.Cropping2D(cropping=tuple(int(v) for v in crop), name=name)
    if cn == "UpSampling1D":
        return L.Upsampling1D(size=int(cfg.get("size", 2)), name=name)
    if cn == "UpSampling3D":
        s = cfg.get("size", 2)
        return L.Upsampling3D(size=s if isinstance(s, int) else tuple(s),
                              name=name)
    if cn == "Activation":
        return L.ActivationLayer(activation=_act(cfg.get("activation")), name=name)
    if cn == "ReLU":
        # standalone ReLU layer (MobileNet-family configs): plain,
        # capped (relu6), or leaky — reject other parameterisations
        max_v = cfg.get("max_value")
        slope = float(cfg.get("negative_slope") or 0.0)
        thresh = float(cfg.get("threshold") or 0.0)
        if thresh != 0.0:
            raise UnsupportedKerasConfigurationException(
                f"ReLU threshold={thresh} not supported (layer '{name}')")
        if max_v is not None and slope != 0.0:
            raise UnsupportedKerasConfigurationException(
                f"ReLU with both max_value and negative_slope not "
                f"supported (layer '{name}')")
        if max_v is not None:
            if float(max_v) != 6.0:
                raise UnsupportedKerasConfigurationException(
                    f"ReLU max_value={max_v} not supported (only 6.0 — "
                    f"relu6; layer '{name}')")
            return L.ActivationLayer(activation="relu6", name=name)
        if slope != 0.0:
            return L.ActivationLayer(activation=_leaky(slope), name=name)
        return L.ActivationLayer(activation="relu", name=name)
    if cn == "LeakyReLU":
        # Keras 3 serializes "negative_slope"; Keras 2 used "alpha".
        # No `or` fallback: an explicit 0.0 means plain relu, not 0.3.
        alpha = cfg.get("negative_slope", cfg.get("alpha", 0.3))
        return L.ActivationLayer(activation=_leaky(float(alpha)), name=name)
    if cn == "BatchNormalization":
        bn = L.BatchNormalization(
            decay=float(cfg.get("momentum", 0.99)),
            eps=float(cfg.get("epsilon", 1e-3)),
            # per-param locking: a Keras BN with scale=False keeps a trainable
            # beta but NO gamma — creating a trainable identity gamma would
            # add degrees of freedom Keras omitted and diverge on fine-tune
            lockGamma=not cfg.get("scale", True),
            lockBeta=not cfg.get("center", True),
            name=name)
        return bn
    if cn == "Normalization":
        # keras.layers.Normalization (e.g. the EfficientNet stem):
        # (x - mean) / sqrt(var). ADAPT mode (mean/var stored as
        # weights) is exactly a frozen no-gamma/no-beta
        # BatchNormalization in inference mode (eps=0: Keras guards
        # sqrt(var) with epsilon(), ~1e-7, invisible at
        # image-statistics variance scales); the BN weight mapper reads
        # [mean, variance, (count ignored)] as-is. CONSTRUCTOR mode
        # (mean/var in the config, NO weights) is intercepted by the
        # functional importer as Shift/Scale vertices before reaching
        # here.
        _normalization_guards(cfg, name)
        if cfg.get("mean") is not None:
            raise UnsupportedKerasConfigurationException(
                f"Normalization with constructor mean/variance is only "
                f"supported in Functional models (layer '{name}')")
        # eps=1e-14 ~ Keras's maximum(sqrt(var), epsilon()) clamp: equal
        # at var=0, invisible at real-statistics variance scales
        bn = L.BatchNormalization(eps=1e-14, lockGammaBeta=True, name=name)
        bn.frozen = True  # stats are dataset constants, never updated
        return bn
    if cn == "ZeroPadding2D":
        pad = cfg.get("padding", 1)
        if isinstance(pad, (list, tuple)) and pad and isinstance(pad[0], (list, tuple)):
            # ((top, bottom), (left, right)) incl. asymmetric (MobileNet
            # stride-2 blocks pad (0,1)); ZeroPaddingLayer's native
            # 4-tuple order is (top, bottom, left, right)
            (t, b), (l, r) = pad
            return L.ZeroPaddingLayer(padding=(int(t), int(b), int(l),
                                               int(r)), name=name)
        return L.ZeroPaddingLayer(padding=_pair(pad), name=name)
    if cn == "Reshape":
        target = tuple(int(v) for v in cfg.get("target_shape", ()))
        if len(target) not in (1, 3):
            raise UnsupportedKerasConfigurationException(
                f"Reshape to {target} not supported (only [features] or "
                f"[h, w, c]; layer '{name}')")
        return KerasReshapeLayer(target, name=name)
    if cn == "UpSampling2D":
        size = _pair(cfg.get("size", 2))
        if size[0] != size[1]:
            raise UnsupportedKerasConfigurationException(
                f"non-square UpSampling2D {size} not supported (layer '{name}')")
        return L.Upsampling2D(size=size[0], name=name)
    if cn == "Embedding":
        return L.EmbeddingSequenceLayer(
            nIn=int(cfg["input_dim"]), nOut=int(cfg["output_dim"]), name=name)
    if cn in ("LSTM", "SimpleRNN", "GRU"):
        cls = {"LSTM": R.LSTM, "SimpleRNN": R.SimpleRnn, "GRU": R.GRU}[cn]
        inner = cls(nOut=int(cfg["units"]), activation=_act(cfg.get("activation")),
                    name=name)
        if cn == "LSTM":
            inner.gateActivationFn = _act(cfg.get("recurrent_activation", "sigmoid"))
        if not cfg.get("return_sequences", False):
            return R.LastTimeStep(inner)
        return inner
    if cn == "Bidirectional":
        inner_spec = _KerasLayerSpec(cfg["layer"])
        inner = _convert_layer(inner_spec, False)
        mode = {"concat": "concat", "sum": "add", "ave": "average", "mul": "mul"}[
            cfg.get("merge_mode", "concat")]
        return R.Bidirectional(layer=inner, mode=mode, name=name)
    raise UnsupportedKerasConfigurationException(
        f"unsupported Keras layer '{cn}' (layer '{name}')")


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------

def _flatten_reorder(kernel, h, w, c):
    """Dense kernel rows after a Keras Flatten are in (h,w,c) order; our
    CnnToFeedForward flattens (c,h,w). Permute rows accordingly."""
    out = kernel.shape[1]
    return kernel.reshape(h, w, c, out).transpose(2, 0, 1, 3).reshape(h * w * c, out)


def _lstm_reorder(k, H):
    """Keras gate columns [i, f, g, o] → native [i, f, o, g]."""
    i, f, g, o = k[..., :H], k[..., H:2 * H], k[..., 2 * H:3 * H], k[..., 3 * H:]
    return np.concatenate([i, f, o, g], axis=-1)


def _apply_weights(layer, weights, params, state):
    """Write Keras weight arrays into a layer's param/state dicts, in
    place: each array is built in the reference's layout and mapped by
    the layer's ``param_from_reference``. Returns (params, state)."""
    cn = type(layer).__name__
    p = dict(params)
    s = dict(state)

    def put(key, arr):
        tgt = p[key]
        arr = np.asarray(arr)
        want = tuple(layer.param_to_reference(key, tgt).shape)
        if want != tuple(arr.shape):
            raise InvalidKerasConfigurationException(
                f"weight shape mismatch for {cn}.{key}: "
                f"model {want} vs h5 {tuple(arr.shape)}")
        src = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
        with torch.no_grad():
            tgt.copy_(layer.param_from_reference(key, src))

    def put_state(key, arr):
        with torch.no_grad():
            s[key].copy_(torch.from_numpy(np.array(arr, np.float32)))

    if isinstance(layer, R.LastTimeStep):
        return _apply_weights(layer.layer, weights, params, state)
    if isinstance(layer, L.DepthwiseConvolution2D):
        # Keras (kh,kw,nIn,mult) -> the grouped (kh,kw,1,nIn*mult);
        # channel-major grouping is identical, so a reshape suffices
        k = np.asarray(weights[0])
        kh, kw, nin, mult = k.shape
        put("W", k.reshape(kh, kw, 1, nin * mult))
        if len(weights) > 1 and "b" in p:
            put("b", weights[1])
        return p, s
    if isinstance(layer, L.SeparableConvolution2D):
        # Keras: depthwise (kh,kw,nIn,mult) + pointwise (1,1,nIn*mult,out)
        k = np.asarray(weights[0])
        kh, kw, nin, mult = k.shape
        put("W", k.reshape(kh, kw, 1, nin * mult))
        put("pW", weights[1])
        if len(weights) > 2 and "b" in p:
            put("b", weights[2])
        return p, s
    if isinstance(layer, L.PReLULayer):
        put("alpha", weights[0])
        return p, s
    if isinstance(layer, (L.DenseLayer, L.BaseOutputLayer, L.ConvolutionLayer,
                          L.Convolution3D)) \
            and not isinstance(layer, L.Convolution1DLayer):
        put("W", weights[0])
        if len(weights) > 1 and "b" in p:
            put("b", weights[1])
        return p, s
    if isinstance(layer, (L.EmbeddingLayer, L.EmbeddingSequenceLayer)):
        put("W", weights[0])
        return p, s
    if isinstance(layer, L.BatchNormalization):
        # Keras omits gamma when scale=False and beta when center=False;
        # lockGamma/lockBeta mirror those flags (set at conversion)
        has_gamma = not (layer.lockGammaBeta or layer.lockGamma)
        has_beta = not (layer.lockGammaBeta or layer.lockBeta)
        idx = 0
        if has_gamma and "gamma" in p:
            put("gamma", weights[idx])
        idx += 1 if has_gamma else 0
        if has_beta and "beta" in p:
            put("beta", weights[idx])
        idx += 1 if has_beta else 0
        put_state("mean", weights[idx])
        put_state("var", weights[idx + 1])
        return p, s
    if isinstance(layer, R.LSTM):
        H = layer.nOut
        put("W", _lstm_reorder(np.asarray(weights[0]), H))
        put("RW", _lstm_reorder(np.asarray(weights[1]), H))
        if len(weights) > 2:
            b = np.asarray(weights[2])
            if b.ndim == 2:  # CuDNN-fused double bias
                b = b.sum(0)
            put("b", _lstm_reorder(b, H))
        return p, s
    if isinstance(layer, R.SimpleRnn):
        put("W", weights[0])
        put("RW", weights[1])
        if len(weights) > 2:
            put("b", weights[2])
        return p, s
    from deeplearning4j_tpu_torch.nn.conf.attention import AttentionVertex
    if isinstance(layer, AttentionVertex):
        # Keras MHA weight order: query/kernel [E,H,hs] (+bias [H,hs]),
        # key, value, attention_output/kernel [H,hs,E] (+bias [E]); the
        # vertex's projections are flat [E, H*hs] / [H*hs, E]
        step = 2 if layer.hasBias else 1
        qk, kk, vk, ok = (np.asarray(weights[i * step]) for i in range(4))
        put("Wq", qk.reshape(qk.shape[0], -1))
        put("Wk", kk.reshape(kk.shape[0], -1))
        put("Wv", vk.reshape(vk.shape[0], -1))
        put("Wo", ok.reshape(-1, ok.shape[-1]))
        if layer.hasBias:
            put("bq", np.asarray(weights[1]).reshape(-1))
            put("bk", np.asarray(weights[3]).reshape(-1))
            put("bv", np.asarray(weights[5]).reshape(-1))
            put("bo", np.asarray(weights[7]).reshape(-1))
        return p, s
    raise UnsupportedKerasConfigurationException(
        f"weight import not supported for layer type {cn}")


def _load_h5_weights(path):
    """Legacy Keras HDF5 → {layerName: [np.ndarray, ...]} in weight_names
    order. Works for both full-model files (model_weights group) and
    save_weights files (layers at the root)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in root:
            g = root[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in g.attrs.get("weight_names", [])]
            arrs = [np.asarray(g[w]) for w in wnames]
            if arrs:
                out[lname.split("/")[0]] = arrs
    return out


def _keras3_group_name(class_name, counters):
    """Keras-3 weight-group name: to_snake_case(class) + per-class
    counter in layer order (verified against keras 3.13 saving_lib)."""
    n = re.sub(r"\W+", "", class_name)
    n = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", n)
    n = re.sub("([a-z])([A-Z])", r"\1_\2", n).lower()
    c = counters.get(class_name, 0)
    counters[class_name] = c + 1
    return n if c == 0 else f"{n}_{c}"


def _keras3_subtree_has_data(grp):
    import h5py

    for k in grp:
        item = grp[k]
        if isinstance(item, h5py.Group):
            if _keras3_subtree_has_data(item):
                return True
        else:
            return True
    return False


def _load_keras3_archive(path, config_only=False):
    """Keras-3 `.keras` zip -> (config dict, {configLayerName: [arrays]}
    or None). model.weights.h5 stores variables under
    layers/<snake_case(class)[_k]>/vars/<i> with NO name mapping back to
    the config — group names are RECOMPUTED from the config's layer
    order here and looked up BY NAME: h5py iterates groups
    alphabetically (dense_10 sorts before dense_2), so order-based
    collection would silently permute weights on models with 11+
    same-class layers or non-alphabetical class order."""
    import io
    import zipfile

    import h5py

    with zipfile.ZipFile(str(path)) as z:
        cfg = json.loads(z.read("config.json"))
        if config_only or "model.weights.h5" not in z.namelist():
            return cfg, None
        blob = io.BytesIO(z.read("model.weights.h5"))
    layers_cfg = cfg.get("config", {})
    if isinstance(layers_cfg, dict):
        layers_cfg = layers_cfg.get("layers", [])
    counters, wmap = {}, {}
    with h5py.File(blob, "r") as f:
        root = f.get("layers")
        if root is None:
            return cfg, None
        for lc in layers_cfg:
            cls = lc.get("class_name", "")
            gname = _keras3_group_name(cls, counters)
            if gname not in root:
                continue  # var-less layers (Dropout, Flatten, Input)
            g = root[gname]
            if "vars" in g and len(g["vars"]):
                src = g["vars"]
            elif "cell" in g and "vars" in g["cell"] and len(g["cell"]["vars"]):
                src = g["cell"]["vars"]  # recurrent layers nest under cell
            elif _keras3_subtree_has_data(g):
                raise UnsupportedKerasConfigurationException(
                    f".keras archive layer "
                    f"'{lc.get('config', {}).get('name')}' stores variables "
                    "in nested containers (wrapper layers); re-save the "
                    "weights as a legacy h5 for import")
            else:
                continue  # var-less layers (empty vars groups included)
            lname = lc.get("config", {}).get("name")
            wmap[lname] = [np.asarray(src[str(i)]) for i in range(len(src))]
    return cfg, (wmap or None)


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------

class KerasModelImport:
    @staticmethod
    def _parse_config(source) -> dict:
        if isinstance(source, dict):
            return source
        text = str(source)
        if text.lstrip().startswith("{"):
            return json.loads(text)
        if text.endswith(".keras"):
            return _load_keras3_archive(text, config_only=True)[0]
        if text.endswith((".h5", ".hdf5")):
            import h5py

            with h5py.File(text, "r") as f:
                raw = f.attrs.get("model_config")
                if raw is None:
                    raise InvalidKerasConfigurationException(
                        f"{text} has no model_config attribute")
                if isinstance(raw, bytes):
                    raw = raw.decode()
                return json.loads(raw)
        with open(text) as fh:
            return json.loads(fh.read())

    # ----- Sequential ------------------------------------------------
    @staticmethod
    def importKerasSequentialModelAndWeights(configSource, weights=None,
                                             enforceTrainingConfig=False,
                                             device=None):
        """Sequential config (+ optional weights) → MultiLayerNetwork.
        `weights`: legacy-H5 path or {layerName: [arrays...]} dict.
        (reference: KerasModelImport.importKerasSequentialModelAndWeights)"""
        if (not isinstance(configSource, dict) and weights is None
                and str(configSource).endswith(".keras")):
            # one-file Keras-3 archive: config + weights together,
            # mirroring the upstream single-h5 convention
            configSource, weights = _load_keras3_archive(configSource)
        cfg = KerasModelImport._parse_config(configSource)
        if cfg.get("class_name") != "Sequential":
            raise InvalidKerasConfigurationException(
                f"expected a Sequential model, got {cfg.get('class_name')}")
        layer_cfgs = cfg.get("config", {})
        if isinstance(layer_cfgs, dict):
            layer_cfgs = layer_cfgs.get("layers", [])
        specs = [_KerasLayerSpec(rl) for rl in layer_cfgs]

        input_type = None
        for sp in specs:
            shape = sp.inputShape()
            if shape is not None:
                input_type = _input_type_from_shape(shape)
                break
        if input_type is None:
            raise InvalidKerasConfigurationException(
                "no input shape found (batch_input_shape/batch_shape)")

        lb = NeuralNetConfiguration.Builder().list()
        native_specs = []  # (spec, native_layer) for weight mapping
        _NOT_OUTPUT = ("InputLayer", "Flatten", "Dropout", "Activation",
                       "SpatialDropout1D", "SpatialDropout2D",
                       "SpatialDropout3D", "GaussianDropout", "GaussianNoise",
                       "AlphaDropout")
        last_real = max((i for i, sp in enumerate(specs)
                         if sp.className not in _NOT_OUTPUT),
                        default=len(specs) - 1)
        # fold a trailing Activation into the output layer: Dense(10) +
        # Activation('softmax') must train as softmax+mcxent, not as an
        # identity OutputLayer (mse) with a layer dangling after it
        folded = set()
        for j in range(last_real + 1, len(specs)):
            if specs[j].className == "Activation":
                specs[last_real].config["activation"] = \
                    specs[j].config.get("activation")
                folded.add(j)
            elif specs[j].className in _NOT_OUTPUT and \
                    specs[j].className != "InputLayer":
                # trailing train-time noise after the output head has no
                # DL4J representation (loss attaches to the output layer);
                # inference is unchanged, so drop it loudly
                import warnings

                warnings.warn(
                    f"dropping trailing {specs[j].className} layer "
                    f"'{specs[j].name}' (after the output head; "
                    "inference-equivalent)", stacklevel=2)
                folded.add(j)
        for i, sp in enumerate(specs):
            if i in folded:
                continue
            nl = _convert_layer(sp, is_last=(i == last_real))
            if nl is None:
                continue
            lb.layer(nl)
            native_specs.append((sp, nl))
        lb.setInputType(input_type)
        conf = lb.build()
        net = MultiLayerNetwork(conf, device).init()

        if weights is not None:
            from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
                CnnToFeedForwardPreProcessor,
            )

            wmap = weights if isinstance(weights, dict) \
                else _load_h5_weights(weights)
            for li, (sp, nl) in enumerate(native_specs):
                if sp.name in wmap:
                    w = list(wmap[sp.name])
                    pp = conf.preprocessors.get(li)
                    if (isinstance(pp, CnnToFeedForwardPreProcessor)
                            and isinstance(nl, (L.DenseLayer, L.BaseOutputLayer))):
                        # Keras flattened (h,w,c); our preprocessor flattens
                        # (c,h,w) — permute the kernel rows to match
                        w[0] = _flatten_reorder(np.asarray(w[0]), pp.inputHeight,
                                                pp.inputWidth, pp.numChannels)
                    net._params[li], net._states[li] = _apply_weights(
                        nl, w, net._params[li], net._states[li])
                elif nl.hasParams() and net._params[li]:
                    raise InvalidKerasConfigurationException(
                        f"no weights found for layer '{sp.name}'")
        return net

    @staticmethod
    def importKerasModelConfiguration(configSource):
        """Config-only Sequential import (reference:
        KerasModelImport.importKerasSequentialConfiguration): the
        configuration, built on the CPU."""
        return KerasModelImport.importKerasSequentialModelAndWeights(
            configSource, device="cpu").conf

    # ----- Functional ------------------------------------------------
    @staticmethod
    def importKerasModelAndWeights(configSource, weights=None,
                                   enforceTrainingConfig=False, device=None):
        """Functional-API config (+ optional weights) → ComputationGraph.
        Supports layer nodes plus Add/Concatenate merge vertices.
        (reference: KerasModelImport.importKerasModelAndWeights)"""
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            ElementWiseVertex, MergeVertex,
        )

        if (not isinstance(configSource, dict) and weights is None
                and str(configSource).endswith(".keras")):
            configSource, weights = _load_keras3_archive(configSource)
        cfg = KerasModelImport._parse_config(configSource)
        if cfg.get("class_name") not in ("Model", "Functional"):
            raise InvalidKerasConfigurationException(
                f"expected a Functional model, got {cfg.get('class_name')}")
        mc = cfg["config"]
        specs = [_KerasLayerSpec(rl) for rl in mc["layers"]]
        by_name = {sp.name: sp for sp in specs}

        def _refs(v):
            """input_layers/output_layers: ["name", 0, 0] for a single ref,
            or a list of such refs / of bare names."""
            if not v:
                return []
            if isinstance(v[0], str):
                return [v[0]]
            return [ref[0] if isinstance(ref, (list, tuple)) else ref for ref in v]

        input_names = _refs(mc.get("input_layers", []))
        output_names = _refs(mc.get("output_layers", []))

        gb = NeuralNetConfiguration.Builder().graphBuilder()
        gb.addInputs(*input_names)
        in_types = []
        for n in input_names:
            shape = by_name[n].inputShape()
            if shape is None:
                raise InvalidKerasConfigurationException(f"input '{n}' has no shape")
            in_types.append(_input_type_from_shape(shape))
        gb.setInputTypes(*in_types)

        native_by_name = {}
        for sp in specs:
            if sp.name in input_names:
                continue
            inputs = sp.inbound
            if sp.className in ("Add", "Concatenate", "Average", "Maximum",
                                "Subtract", "Multiply"):
                vtx = {"Add": ElementWiseVertex("add"),
                       "Subtract": ElementWiseVertex("subtract"),
                       "Multiply": ElementWiseVertex("product"),
                       "Average": ElementWiseVertex("average"),
                       "Maximum": ElementWiseVertex("max"),
                       "Concatenate": MergeVertex()}[sp.className]
                gb.addVertex(sp.name, vtx, *inputs)
                continue
            if (sp.className == "Normalization"
                    and sp.config.get("mean") is not None):
                # constructor-mode Normalization: mean/variance are
                # config constants (no weights) -> (x - mean)/sqrt(var)
                # as chained Shift/Scale vertices
                from deeplearning4j_tpu_torch.nn.conf.graph import (ScaleVertex,
                                                              ShiftVertex)

                _normalization_guards(sp.config, sp.name)
                mean = np.asarray(sp.config["mean"], np.float32).reshape(-1)
                # Keras clamps the denominator at epsilon() ~1e-7;
                # clamping variance at its square keeps a zero-variance
                # channel finite with the same result
                var = np.maximum(np.asarray(sp.config["variance"],
                                            np.float32).reshape(-1), 1e-14)
                gb.addVertex(sp.name + "_kshift",
                             ShiftVertex(-mean), *inputs)
                gb.addVertex(sp.name, ScaleVertex(1.0 / np.sqrt(var)),
                             sp.name + "_kshift")
                continue
            if sp.className == "Rescaling":
                # keras.layers.Rescaling: x*scale + offset with config
                # constants (no weights) -> chained Scale/Shift vertices
                # (the reference's ScaleVertex/ShiftVertex, extended to
                # per-channel factors)
                from deeplearning4j_tpu_torch.nn.conf.graph import (ScaleVertex,
                                                              ShiftVertex)

                c = sp.config
                gb.addVertex(sp.name + "_kscale",
                             ScaleVertex(c.get("scale", 1.0)), *inputs)
                gb.addVertex(sp.name, ShiftVertex(c.get("offset", 0.0)),
                             sp.name + "_kscale")
                continue
            if sp.className == "MultiHeadAttention":
                from deeplearning4j_tpu_torch.nn.conf.attention import AttentionVertex

                c = sp.config
                if c.get("value_dim") not in (None, c.get("key_dim")):
                    raise UnsupportedKerasConfigurationException(
                        f"MultiHeadAttention with value_dim != key_dim not "
                        f"supported (layer '{sp.name}')")
                if c.get("output_shape") is not None:
                    raise UnsupportedKerasConfigurationException(
                        f"MultiHeadAttention custom output_shape not supported "
                        f"(layer '{sp.name}')")
                av = AttentionVertex(
                    nHeads=int(c["num_heads"]), headSize=int(c["key_dim"]),
                    hasBias=bool(c.get("use_bias", True)), name=sp.name)
                # Keras call order is (query, value[, key]); the vertex wants
                # (query[, keys[, values]])
                if len(inputs) == 3:
                    inputs = [inputs[0], inputs[2], inputs[1]]
                gb.addVertex(sp.name, av, *inputs)
                native_by_name[sp.name] = av
                continue
            is_out = sp.name in output_names
            nl = _convert_layer(sp, is_last=is_out)
            if nl is None:  # Flatten/InputLayer: identity vertex via ActivationLayer
                nl = L.ActivationLayer(activation="identity", name=sp.name)
            gb.addLayer(sp.name, nl, *inputs)
            native_by_name[sp.name] = nl
        gb.setOutputs(*output_names)
        graph = ComputationGraph(gb.build(), device).init()

        if weights is not None:
            from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
                CnnToFeedForwardPreProcessor,
            )

            wmap = weights if isinstance(weights, dict) \
                else _load_h5_weights(weights)
            for lname, nl in native_by_name.items():
                if lname in wmap:
                    w = list(wmap[lname])
                    pp = graph.conf.nodes[lname].preprocessor
                    if (isinstance(pp, CnnToFeedForwardPreProcessor)
                            and isinstance(nl, (L.DenseLayer, L.BaseOutputLayer))):
                        # same flatten-order permutation as the Sequential path
                        w[0] = _flatten_reorder(np.asarray(w[0]), pp.inputHeight,
                                                pp.inputWidth, pp.numChannels)
                    graph._params[lname], graph._states[lname] = _apply_weights(
                        nl, w, graph._params[lname], graph._states[lname])
        return graph
