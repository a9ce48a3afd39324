"""Layer configurations with their init and forward.

The counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``: every layer
of the reference's catalogue. As in the reference a layer config IS its
implementation: ``initialize(gen, inputType, dtype, device)`` returns
``(params, state)`` dicts of tensors with the reference's names, and
``forward(params, state, x, train, key, mask)`` is a plain function of
them that autograd differentiates (BN through the ``ops.norm`` autograd
Functions). ``key`` is the step's ``dropout.StepKey`` for this layer
(None outside training): dropout applies to the layer's input when
training, as in the reference. A layer's ``constraints``,
``weightNoise`` and ``biasUpdater`` (``nn/conf/constraint.py``,
``nn/conf/weightnoise.py``) are applied by the networks.

Layouts: recurrent activations between layers are NCW ``[B, F, T]``;
convolutional ones NCHW-logical in ``channels_last`` memory, where the
reference keeps NHWC. Each layer owns the map between the reference's
parameter layout and its own (``param_from_reference`` and its inverse
``param_to_reference``) and names the axis of each parameter that
indexes output units (``output_axis``, what the constraints norm per):
dense ``W`` is ``[in, out]`` on both sides, a conv ``W`` is the
reference's HWIO ``[kh, kw, in, out]`` and the port's OIHW ``[out, in,
kh, kw]`` (channels_last memory; output axis 0); a 1-d conv's ``[k, in,
out]`` is torch's ``[out, in, k]``; a depthwise ``[kh, kw, 1, C·m]`` is a
grouped ``[C·m, 1, kh, kw]`` (output channel ``g·m + j`` reads input
channel g on both sides); a deconvolution's unflipped HWIO ``[kh, kw,
Cin, Cout]`` is ``conv_transpose2d``'s flipped ``[Cin, Cout, kh, kw]``
(output axis 1); PReLU's alpha over CNN input is ``[C, H, W]`` where the
reference's is ``[H, W, C]`` (``[C, D, H, W]`` for ``[D, H, W, C]`` over
3-d input). 3-d activations are NCDHW-logical where the reference keeps
NDHWC; a 3-d conv ``W`` is the reference's DHWIO ``[kd, kh, kw, in,
out]`` and the port's OIDHW, a 3-d deconvolution's unflipped DHWIO is
``conv_transpose3d``'s flipped ``[in, out, kd, kh, kw]``. The locally connected and capsule layers
keep the reference's layouts. The recurrent layers are in
``nn/conf/recurrent.py``, the variational autoencoder in
``nn/conf/variational.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf import dropout as _do
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import conv as _conv
from deeplearning4j_tpu_torch.ops import norm as _norm
from deeplearning4j_tpu_torch.ops import pooling as _pool
from deeplearning4j_tpu_torch.ops.conv import _pair

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "DenseLayer",
           "BaseOutputLayer", "OutputLayer", "RnnOutputLayer", "LossLayer",
           "CnnLossLayer", "RnnLossLayer", "ActivationLayer", "DropoutLayer",
           "ConvolutionLayer", "Deconvolution2D", "DepthwiseConvolution2D",
           "SeparableConvolution2D", "SubsamplingLayer", "Upsampling2D",
           "ZeroPaddingLayer", "Cropping2D", "GlobalPoolingLayer",
           "BatchNormalization", "LocalResponseNormalization",
           "SpaceToDepth", "EmbeddingLayer", "EmbeddingSequenceLayer",
           "Convolution1DLayer", "Subsampling1DLayer", "Upsampling1D",
           "Cropping1D", "ZeroPadding1DLayer", "RepeatVector", "MaskLayer",
           "MaskZeroLayer", "FrozenLayerWithBackprop", "SpaceToBatch",
           "LocallyConnected2D", "LocallyConnected1D", "PReLULayer",
           "ElementWiseMultiplicationLayer", "CenterLossOutputLayer",
           "OCNNOutputLayer", "AutoEncoder", "PrimaryCapsules",
           "CapsuleLayer", "CapsuleStrengthLayer", "SameDiffLambdaLayer",
           "SameDiffLayer", "Convolution3D", "Deconvolution3D",
           "Cropping3D", "Upsampling3D", "Subsampling3DLayer",
           "ZeroPadding3D"]


class Layer:
    """Base layer config. None-valued common fields inherit the network's
    global defaults."""

    _GLOBAL_FIELDS = ("activation", "weightInit", "biasInit", "updater",
                      "biasUpdater", "l1", "l2", "l1Bias", "l2Bias",
                      "weightDecay", "dropOut", "distribution", "constraints",
                      "weightNoise")

    def __init__(self, name=None, activation=None, weightInit=None,
                 biasInit=None, updater=None, biasUpdater=None, l1=None,
                 l2=None, l1Bias=None, l2Bias=None, weightDecay=None,
                 dropOut=None, distribution=None, constraints=None,
                 weightNoise=None):
        self.name = name
        self.activation = activation
        self.weightInit = weightInit
        self.biasInit = biasInit
        self.updater = updater
        self.biasUpdater = biasUpdater
        self.l1, self.l2 = l1, l2
        self.l1Bias, self.l2Bias = l1Bias, l2Bias
        self.weightDecay = weightDecay
        self.dropOut = dropOut
        self.distribution = distribution
        self.constraints = constraints
        self.weightNoise = weightNoise

    def mergeGlobals(self, defaults: dict) -> None:
        for f in self._GLOBAL_FIELDS:
            if getattr(self, f, None) is None and f in defaults:
                setattr(self, f, defaults[f])
        if self.activation is None:
            self.activation = "identity"
        if self.weightInit is None:
            self.weightInit = _winit.WeightInit.XAVIER
        if self.biasInit is None:
            self.biasInit = 0.0

    def getOutputType(self, inputType: InputType) -> InputType:
        return inputType

    def initialize(self, gen, inputType, dtype, device):
        return {}, {}

    def forward(self, params, state, x, train: bool, key, mask=None):
        raise NotImplementedError

    def hasParams(self) -> bool:
        return True

    def param_from_reference(self, name, t):
        """Parameter or state `name` in the reference's layout -> this
        layer's (the same, unless the layer says otherwise)."""
        return t

    def param_to_reference(self, name, t):
        """The inverse of ``param_from_reference``."""
        return t

    def output_axis(self, name, t):
        """The axis of parameter `name` that indexes output units (the
        constraints norm over the others): the last, as the reference
        lays every weight out, unless the layer's layout says
        otherwise."""
        return t.dim() - 1

    def _dropout_input(self, x, train, key):
        """Dropout on the layer's input, when training with a key
        (reference: ``Layer._dropout_input``)."""
        d = _do.resolve(self.dropOut)
        if not train or d is None or key is None:
            return x
        return d.apply(x, key)

    # neither weights nor biases: never regularized (as the reference)
    _NON_WEIGHT_PARAMS = ("b", "beta", "centers", "alpha", "vb")

    def _is_weight(self, name):
        return name.rsplit(".", 1)[-1] not in self._NON_WEIGHT_PARAMS

    def _is_bias(self, name):
        return name.rsplit(".", 1)[-1] == "b"

    def regularization(self, params):
        """Scalar l1/l2/weight-decay penalty for this layer's params (by
        leaf name: a nested ``"enc.0.b"`` is a bias)."""
        total = 0.0
        l1, l2, wd = self.l1 or 0.0, self.l2 or 0.0, self.weightDecay or 0.0
        for k, p in params.items():
            if not self._is_weight(k):
                continue
            if l1:
                total = total + l1 * p.abs().sum()
            if l2 or wd:
                total = total + 0.5 * (l2 + wd) * p.square().sum()
        l1b, l2b = self.l1Bias or 0.0, self.l2Bias or 0.0
        if l1b or l2b:
            for k, p in params.items():
                if self._is_bias(k):
                    total = total + l1b * p.abs().sum() \
                        + 0.5 * l2b * p.square().sum()
        return total


class BaseLayer(Layer):
    pass


class FeedForwardLayer(BaseLayer):
    def __init__(self, nIn=None, nOut=None, hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.hasBias = hasBias

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.feedForward(self.nOut)

    def inferNIn(self, inputType: InputType) -> None:
        if self.nIn is None:
            if inputType.kind in (InputType.FF, InputType.RNN):
                self.nIn = inputType.size
            else:
                self.nIn = inputType.arrayElementsPerExample()

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        params = {"W": _winit.init(gen, self.weightInit, (self.nIn, self.nOut),
                                   self.nIn, self.nOut, dtype, device,
                                   self.distribution)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}


class DenseLayer(FeedForwardLayer):
    """Fully connected layer (reference: conf.layers.DenseLayer)."""

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y), state


class BaseOutputLayer(FeedForwardLayer):
    def __init__(self, lossFunction="mcxent", **kw):
        super().__init__(**kw)
        self.lossFunction = lossFunction

    def preoutput(self, params, x):
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return y

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        return _act.get(self.activation)(self.preoutput(params, x)), state


class OutputLayer(BaseOutputLayer):
    """Dense + loss head (reference: conf.layers.OutputLayer)."""


class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep dense + loss over NCW data
    (reference: conf.layers.RnnOutputLayer)."""

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut,
                                   inputType.dims.get("timeSeriesLength"))

    def preoutput(self, params, x):
        # x: [B,F,T] -> y: [B,nOut,T]
        y = torch.einsum("bft,fo->bot", x, params["W"])
        if self.hasBias:
            y = y + params["b"][None, :, None]
        return y

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pre = self.preoutput(params, x)
        # activation over the class axis (softmax must not run over time)
        act = _act.get(self.activation)
        return act(pre.transpose(1, 2)).transpose(1, 2), state


class LossLayer(Layer):
    """A loss head without params (reference: conf.layers.LossLayer):
    the preoutput is the input itself."""

    def __init__(self, lossFunction="mcxent", **kw):
        super().__init__(**kw)
        self.lossFunction = lossFunction
        self.nOut = None

    def hasParams(self):
        return False

    def preoutput(self, params, x):
        return x

    def forward(self, params, state, x, train, key, mask=None):
        return _act.get(self.activation)(x), state


class CnnLossLayer(LossLayer):
    """A per-pixel loss head for dense prediction, e.g. segmentation
    (reference: conf.layers.CnnLossLayer). The loss takes the class axis
    last ([B,H,W,C]): summed over the pixels and classes, averaged over
    the batch, as the reference's. A 4-d label is NHWC exactly when the
    network's input type says ``format="NHWC"``, else NCHW."""


class RnnLossLayer(LossLayer):
    """A per-timestep loss head without params (reference:
    conf.layers.RnnLossLayer)."""


class ActivationLayer(Layer):
    def hasParams(self):
        return False

    def forward(self, params, state, x, train, key, mask=None):
        return _act.get(self.activation)(x), state


class DropoutLayer(Layer):
    """Dropout alone (reference: conf.layers.DropoutLayer)."""

    def __init__(self, dropOut=0.5, **kw):
        super().__init__(dropOut=dropOut, **kw)

    def hasParams(self):
        return False

    def forward(self, params, state, x, train, key, mask=None):
        return self._dropout_input(x, train, key), state


class ConvolutionLayer(FeedForwardLayer):
    """2D convolution (reference: conf.layers.ConvolutionLayer): W OIHW
    ``[nOut, nIn, kh, kw]`` in channels_last memory, bias ``[nOut]``."""

    def __init__(self, nOut=None, kernelSize=(3, 3), stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1), convolutionMode="truncate",
                 nIn=None, hasBias=True, **kw):
        super().__init__(nIn=nIn, nOut=nOut, hasBias=hasBias, **kw)
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.convolutionMode = convolutionMode

    def inferNIn(self, inputType):
        if self.nIn is None and inputType.kind == InputType.CNN:
            self.nIn = inputType.channels

    def _out_hw(self, inputType):
        return tuple(_conv.conv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i],
            self.dilation[i], self.convolutionMode)
            for i, n in enumerate((inputType.height, inputType.width)))

    def getOutputType(self, inputType):
        return InputType.convolutional(*self._out_hw(inputType), self.nOut)

    def _w_shape(self):
        return (self.nOut, self.nIn) + self.kernelSize

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.channels
        kh, kw = self.kernelSize
        W = _winit.init(gen, self.weightInit, self._w_shape(),
                        kh * kw * self.nIn, kh * kw * self.nOut, dtype,
                        device, self.distribution)
        params = {"W": W.contiguous(memory_format=torch.channels_last)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def param_from_reference(self, name, t):
        if name == "W":   # HWIO -> OIHW, laid out as initialize lays it
            # out: through a contiguous copy first, since with a size-1
            # dim (nIn 1) another stride set also counts as channels_last,
            # and the convolution's summation order follows the strides
            return _conv_layout(t)
        return t

    def param_to_reference(self, name, t):
        if name == "W":   # OIHW -> HWIO
            return t.permute(2, 3, 1, 0).contiguous()
        return t

    def output_axis(self, name, t):
        return 0

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = _conv.explicit_padding(self.convolutionMode, self.padding,
                                     self.kernelSize, self.stride,
                                     self.dilation)
        y = _conv.conv2d(x, params["W"], params.get("b"), self.stride, pad,
                         self.dilation)
        return _act.get(self.activation)(y), state


def _conv_layout(t):
    """HWIO [kh, kw, in, out] -> OIHW [out, in, kh, kw] in channels_last
    memory, through a contiguous copy first (see
    ``ConvolutionLayer.param_from_reference``)."""
    return t.permute(3, 2, 0, 1).contiguous().contiguous(
        memory_format=torch.channels_last)


class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (reference: conf.layers.Deconvolution2D).
    The reference's W is an unflipped HWIO ``[kh, kw, nIn, nOut]`` that
    ``lax.conv_transpose`` slides over the dilated input; the port holds
    it spatially flipped as ``conv_transpose2d``'s ``[nIn, nOut, kh,
    kw]``, which computes the same function."""

    def _w_shape(self):
        return (self.nIn, self.nOut) + self.kernelSize

    def getOutputType(self, inputType):
        h, w = (_conv.deconv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i],
            self.dilation[i], self.convolutionMode)
            for i, n in enumerate((inputType.height, inputType.width)))
        return InputType.convolutional(h, w, self.nOut)

    def param_from_reference(self, name, t):
        if name == "W":   # HWIO, unflipped -> [I, O, kh, kw], flipped
            return t.flip(0, 1).permute(2, 3, 0, 1).contiguous().contiguous(
                memory_format=torch.channels_last)
        return t

    def param_to_reference(self, name, t):
        if name == "W":
            return t.permute(2, 3, 0, 1).flip(0, 1).contiguous()
        return t

    def output_axis(self, name, t):
        return 1 if t.dim() > 1 else 0

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = _conv.deconv_explicit_padding(
            self.convolutionMode, self.padding, self.kernelSize,
            self.dilation)
        y = _conv.deconv2d(x, params["W"], params.get("b"), self.stride, pad,
                           self.dilation)
        return _act.get(self.activation)(y), state


class DepthwiseConvolution2D(ConvolutionLayer):
    """Depthwise convolution (reference:
    conf.layers.DepthwiseConvolution2D): depthMultiplier output channels
    per input channel, a convolution of nIn groups; W ``[C·m, 1, kh,
    kw]``."""

    def __init__(self, depthMultiplier=1, **kw):
        kw.setdefault("nOut", None)
        super().__init__(**kw)
        self.depthMultiplier = depthMultiplier

    def getOutputType(self, inputType):
        return InputType.convolutional(*self._out_hw(inputType),
                                       self.nIn * self.depthMultiplier)

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.channels
        self.nOut = self.nIn * self.depthMultiplier
        kh, kw = self.kernelSize
        W = _winit.init(gen, self.weightInit, (self.nOut, 1, kh, kw),
                        kh * kw, kh * kw * self.depthMultiplier, dtype,
                        device, self.distribution)
        params = {"W": W.contiguous(memory_format=torch.channels_last)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = _conv.explicit_padding(self.convolutionMode, self.padding,
                                     self.kernelSize, self.stride,
                                     self.dilation)
        y = _conv.conv2d(x, params["W"], params.get("b"), self.stride, pad,
                         self.dilation, groups=self.nIn)
        return _act.get(self.activation)(y), state


class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise then pointwise convolution (reference:
    conf.layers.SeparableConvolution2D): W the depthwise ``[C·m, 1, kh,
    kw]``, pW the pointwise ``[nOut, C·m, 1, 1]``, the bias after the
    pointwise."""

    def __init__(self, depthMultiplier=1, **kw):
        super().__init__(**kw)
        self.depthMultiplier = depthMultiplier

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.channels
        kh, kw = self.kernelSize
        depth_out = self.nIn * self.depthMultiplier
        Wd = _winit.init(gen, self.weightInit, (depth_out, 1, kh, kw),
                         kh * kw, kh * kw * self.depthMultiplier, dtype,
                         device, self.distribution)
        Wp = _winit.init(gen, self.weightInit, (self.nOut, depth_out, 1, 1),
                         depth_out, self.nOut, dtype, device,
                         self.distribution)
        params = {"W": Wd.contiguous(memory_format=torch.channels_last),
                  "pW": Wp.contiguous(memory_format=torch.channels_last)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def param_from_reference(self, name, t):
        return _conv_layout(t) if name == "pW" else \
            super().param_from_reference(name, t)

    def param_to_reference(self, name, t):
        return super().param_to_reference("W" if name == "pW" else name, t)

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = _conv.explicit_padding(self.convolutionMode, self.padding,
                                     self.kernelSize, self.stride,
                                     self.dilation)
        y = _conv.conv2d(x, params["W"], None, self.stride, pad,
                         self.dilation, groups=self.nIn)
        y = _conv.conv2d(y, params["pW"], params.get("b"))
        return _act.get(self.activation)(y), state


class SubsamplingLayer(Layer):
    """Max/avg/pnorm pooling (reference: conf.layers.SubsamplingLayer)."""

    def __init__(self, poolingType="max", kernelSize=(2, 2), stride=(2, 2),
                 padding=(0, 0), convolutionMode="truncate", pnorm=2, **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.convolutionMode = convolutionMode
        self.pnorm = pnorm

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        h, w = (_conv.conv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i], 1,
            self.convolutionMode)
            for i, n in enumerate((inputType.height, inputType.width)))
        return InputType.convolutional(h, w, inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        pad = _conv.explicit_padding(self.convolutionMode, self.padding,
                                     self.kernelSize, self.stride, (1, 1))
        t = str(self.poolingType).lower()
        if t == "max":
            y = _pool.max_pool2d(x, self.kernelSize, self.stride, pad)
        elif t == "avg":
            y = _pool.avg_pool2d(x, self.kernelSize, self.stride, pad)
        elif t == "pnorm":
            y = _pool.pnorm_pool2d(x, self.kernelSize, self.stride, pad,
                                   self.pnorm)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return y, state


def _quad(v):
    """An int, a (vertical, horizontal) pair or (top, bottom, left,
    right) -> the four."""
    if isinstance(v, int):
        v = (v, v, v, v)
    elif len(v) == 2:
        v = (v[0], v[0], v[1], v[1])
    return tuple(int(a) for a in v)


class Upsampling2D(Layer):
    """Nearest-neighbour upsampling (reference: conf.layers.Upsampling2D)."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.sizev = _pair(size)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        return InputType.convolutional(inputType.height * self.sizev[0],
                                       inputType.width * self.sizev[1],
                                       inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        return _pool.upsample2d(x, self.sizev), state


class ZeroPaddingLayer(Layer):
    """Zero padding (reference: conf.layers.ZeroPaddingLayer); ``pad`` is
    (top, bottom, left, right)."""

    def __init__(self, padding=(1, 1), **kw):
        super().__init__(**kw)
        self.pad = _quad(padding)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        t, b, l, r = self.pad
        return InputType.convolutional(inputType.height + t + b,
                                       inputType.width + l + r,
                                       inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        t, b, l, r = self.pad
        return F.pad(x, (l, r, t, b)), state


class Cropping2D(Layer):
    """Cropping (reference: conf.layers.Cropping2D); ``crop`` is (top,
    bottom, left, right)."""

    def __init__(self, cropping=(0, 0), **kw):
        super().__init__(**kw)
        self.crop = _quad(cropping)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        t, b, l, r = self.crop
        return InputType.convolutional(inputType.height - t - b,
                                       inputType.width - l - r,
                                       inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        t, b, l, r = self.crop
        H, W = x.shape[2], x.shape[3]
        return x[:, :, t:H - b, l:W - r], state


class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial dims (CNN input [B,C,H,W] ->
    [B,C]) or time (RNN input [B,F,T] -> [B,F]); FF input passes through
    (reference: conf.layers.GlobalPoolingLayer); 3-d CNN input
    [B,C,D,H,W] pools D, H and W."""

    def __init__(self, poolingType="max", pnorm=2, collapseDimensions=True,
                 **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.pnorm = pnorm
        self.collapseDimensions = collapseDimensions

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        if inputType.kind == InputType.CNN:
            if not self.collapseDimensions:
                return InputType.convolutional(1, 1, inputType.channels)
            return InputType.feedForward(inputType.channels)
        if inputType.kind == InputType.RNN:
            if not self.collapseDimensions:
                return InputType.recurrent(inputType.size, 1)
            return InputType.feedForward(inputType.size)
        if inputType.kind == InputType.CNN3D:
            if not self.collapseDimensions:
                return InputType.convolutional3D(1, 1, 1, inputType.channels)
            return InputType.feedForward(inputType.channels)
        return inputType

    def forward(self, params, state, x, train, key, mask=None):
        if x.dim() == 5:      # [B,C,D,H,W]
            y = _pool.global_pool(x, self.poolingType, (2, 3, 4), None,
                                  self.pnorm)
            if not self.collapseDimensions:
                y = y[:, :, None, None, None]
        elif x.dim() == 4:    # [B,C,H,W]
            y = _pool.global_pool(x, self.poolingType, (2, 3), None,
                                  self.pnorm)
            if not self.collapseDimensions:
                y = y[:, :, None, None]
        elif x.dim() == 3:    # [B,F,T]
            m = None if mask is None else mask[:, None, :].to(x.dtype)
            y = _pool.global_pool(x, self.poolingType, (2,), m, self.pnorm)
            if not self.collapseDimensions:
                y = y[:, :, None]
        else:
            y = x
        return y, state


class BatchNormalization(Layer):
    """Batch norm over the channel axis (axis 1 of [B,C,H,W], [B,C] or
    [B,F,T]; reference: conf.layers.BatchNormalization). Params
    ``gamma``/``beta`` unless locked; state ``mean``/``var`` (fp32), the
    running statistics, which the network replaces after each training
    step with the ones the layer returns. An activation that
    ``ops.norm.bn_act_supported`` takes runs in the fused epilogue
    (``batch_norm_act``), as in the reference."""

    def __init__(self, decay=0.9, eps=1e-5, gamma=1.0, beta=0.0,
                 lockGammaBeta=False, lockGamma=False, lockBeta=False,
                 nOut=None, nIn=None, **kw):
        super().__init__(**kw)
        self.decay, self.eps = decay, eps
        self.gammaInit, self.betaInit = gamma, beta
        self.lockGammaBeta = lockGammaBeta
        self.lockGamma = lockGamma
        self.lockBeta = lockBeta
        self.nIn, self.nOut = nIn, nOut

    def initialize(self, gen, inputType, dtype, device):
        n = self.nOut or (inputType.channels
                          if inputType.kind == InputType.CNN
                          else inputType.size)
        self.nOut = self.nIn = n
        params = {}
        if not (self.lockGammaBeta or self.lockGamma):
            params["gamma"] = torch.full((n,), float(self.gammaInit),
                                         dtype=dtype, device=device)
        if not (self.lockGammaBeta or self.lockBeta):
            params["beta"] = torch.full((n,), float(self.betaInit),
                                        dtype=dtype, device=device)
        state = {"mean": torch.zeros(n, dtype=torch.float32, device=device),
                 "var": torch.ones(n, dtype=torch.float32, device=device)}
        return params, state

    def forward(self, params, state, x, train, key, mask=None):
        kw = dict(train=train, decay=self.decay, eps=self.eps)
        if _norm.bn_act_supported(self.activation):
            y, rm, rv = _norm.batch_norm_act(
                x, params.get("gamma"), params.get("beta"), state["mean"],
                state["var"], activation=self.activation, **kw)
            return y, {"mean": rm, "var": rv}
        y, rm, rv = _norm.batch_norm(x, params.get("gamma"),
                                     params.get("beta"), state["mean"],
                                     state["var"], **kw)
        return _act.get(self.activation)(y), {"mean": rm, "var": rv}


class LocalResponseNormalization(Layer):
    """Local response normalization across channels (reference:
    conf.layers.LocalResponseNormalization; ``ops.norm.lrn``)."""

    def __init__(self, k=2.0, n=5, alpha=1e-4, beta=0.75, **kw):
        super().__init__(**kw)
        self.k, self.n, self.alpha, self.beta = k, n, alpha, beta

    def hasParams(self):
        return False

    def forward(self, params, state, x, train, key, mask=None):
        return _norm.lrn(x, self.k, self.n, self.alpha, self.beta), state


class SpaceToDepth(Layer):
    """[B,C,H,W] -> [B,C·b·b,H/b,W/b] (reference: conf.layers.SpaceToDepth)
    with the reference's channel order ``(s·b + t)·C + c``
    (``ops.conv.space_to_depth`` over the NHWC view). blocks must
    divide H and W."""

    def __init__(self, blocks=2, dataFormat="NCHW", **kw):
        super().__init__(**kw)
        self.blocks = int(blocks)
        if str(dataFormat).upper() != "NCHW":
            raise ValueError(
                "SpaceToDepth API data format is NCHW (the framework "
                "transposes to NHWC internally at the input boundary); "
                f"got dataFormat={dataFormat!r}")

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        b = self.blocks
        if inputType.height % b or inputType.width % b:
            raise ValueError(
                f"SpaceToDepth blocks={b} must divide H={inputType.height}, "
                f"W={inputType.width}")
        return InputType.convolutional(inputType.height // b,
                                       inputType.width // b,
                                       inputType.channels * b * b)

    def forward(self, params, state, x, train, key, mask=None):
        y = _conv.space_to_depth(x.permute(0, 2, 3, 1), self.blocks)
        return y.permute(0, 3, 1, 2), state


# ----------------------------------------------------------------------
# 3-d convolution and spatial reshaping
# ----------------------------------------------------------------------

_triple = _pool._triple


def _pads3(mode, padding):
    """A ConvolutionMode + configured pads -> "SAME" or ((p, p),) * 3 (the
    reference's 3-d layers)."""
    if str(mode).lower() == "same":
        return "SAME"
    return tuple((p, p) for p in padding)


class Convolution3D(FeedForwardLayer):
    """3-d convolution (reference: conf.layers.Convolution3D): NCDHW in,
    W OIDHW ``[nOut, nIn, kd, kh, kw]`` (the reference's DHWIO), bias
    ``[nOut]`` added after the product, as the reference's."""

    def __init__(self, kernelSize=(2, 2, 2), stride=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1),
                 convolutionMode="truncate", **kw):
        super().__init__(**kw)
        self.kernelSize = _triple(kernelSize)
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.dilation = _triple(dilation)
        self.convolutionMode = convolutionMode

    def inferNIn(self, inputType):
        if self.nIn is None:
            self.nIn = inputType.channels

    def _out_dims(self, inputType, size_fn):
        return tuple(size_fn(n, self.kernelSize[i], self.stride[i],
                             self.padding[i], self.dilation[i],
                             self.convolutionMode)
                     for i, n in enumerate((inputType.depth,
                                            inputType.height,
                                            inputType.width)))

    def getOutputType(self, inputType):
        return InputType.convolutional3D(
            *self._out_dims(inputType, _conv.conv_output_size), self.nOut)

    def _w_shape(self):
        return (self.nOut, self.nIn) + self.kernelSize

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        k = self.kernelSize[0] * self.kernelSize[1] * self.kernelSize[2]
        params = {"W": _winit.init(gen, self.weightInit, self._w_shape(),
                                   self.nIn * k, self.nOut * k, dtype,
                                   device, self.distribution)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def param_from_reference(self, name, t):
        if name == "W":   # DHWIO -> OIDHW
            return t.permute(4, 3, 0, 1, 2).contiguous()
        return t

    def param_to_reference(self, name, t):
        if name == "W":
            return t.permute(2, 3, 4, 1, 0).contiguous()
        return t

    def output_axis(self, name, t):
        return 0

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pads = _pads3(self.convolutionMode, self.padding)
        if pads == "SAME":
            pads = tuple(_conv.same_pads(n, k, s, d) for n, k, s, d in zip(
                x.shape[2:], self.kernelSize, self.stride, self.dilation))
        if all(lo == hi for lo, hi in pads):
            pad = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, tuple(v for lo_hi in reversed(pads)
                               for v in lo_hi))
            pad = 0
        y = F.conv3d(x, params["W"], None, self.stride, pad, self.dilation)
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1, 1)
        return _act.get(self.activation)(y), state


class Deconvolution3D(Convolution3D):
    """Transposed 3-d convolution (reference:
    conf.layers.Deconvolution3D). The reference's W is the forward
    layout DHWIO ``[kd, kh, kw, nIn, nOut]``, unflipped, which
    ``lax.conv_transpose`` slides over the dilated input; the port holds
    it flipped as ``conv_transpose3d``'s ``[nIn, nOut, kd, kh, kw]``."""

    def _w_shape(self):
        return (self.nIn, self.nOut) + self.kernelSize

    def getOutputType(self, inputType):
        return InputType.convolutional3D(
            *self._out_dims(inputType, _conv.deconv_output_size), self.nOut)

    def param_from_reference(self, name, t):
        if name == "W":
            return t.flip(0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
        return t

    def param_to_reference(self, name, t):
        if name == "W":
            return t.permute(2, 3, 4, 0, 1).flip(0, 1, 2).contiguous()
        return t

    def output_axis(self, name, t):
        return 1 if t.dim() > 1 else 0

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = _conv.deconv3d_explicit_padding(
            self.convolutionMode, self.padding, self.kernelSize,
            self.dilation)
        y = _conv.deconv3d(x, params["W"], params.get("b"), self.stride, pad,
                           self.dilation)
        return _act.get(self.activation)(y), state


class Cropping3D(Layer):
    """Crop D/H/W (reference: conf.layers.Cropping3D); ``crop`` is (d0,
    d1, h0, h1, w0, w1)."""

    def __init__(self, cropping=(0, 0, 0, 0, 0, 0), **kw):
        super().__init__(**kw)
        c = cropping
        if isinstance(c, int):
            c = (c,) * 6
        elif len(c) == 3:
            c = (c[0], c[0], c[1], c[1], c[2], c[2])
        self.crop = tuple(int(v) for v in c)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        d0, d1, h0, h1, w0, w1 = self.crop
        return InputType.convolutional3D(
            inputType.depth - d0 - d1, inputType.height - h0 - h1,
            inputType.width - w0 - w1, inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        d0, d1, h0, h1, w0, w1 = self.crop
        D, H, W = x.shape[2:]
        return x[:, :, d0:D - d1, h0:H - h1, w0:W - w1], state


class Upsampling3D(Layer):
    """Nearest-neighbour upsampling of D/H/W (reference:
    conf.layers.Upsampling3D)."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.sizev = _triple(size)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        return InputType.convolutional3D(
            inputType.depth * self.sizev[0], inputType.height * self.sizev[1],
            inputType.width * self.sizev[2], inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        return _pool.upsample3d(x, self.sizev), state


class Subsampling3DLayer(Layer):
    """3-d max/avg pooling (reference: conf.layers.Subsampling3DLayer;
    avg divides by the window's volume under explicit pads, by the real
    inputs under "same")."""

    def __init__(self, poolingType="max", kernelSize=(2, 2, 2),
                 stride=(2, 2, 2), padding=(0, 0, 0),
                 convolutionMode="truncate", **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.kernelSize = _triple(kernelSize)
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.convolutionMode = convolutionMode

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        d, h, w = (_conv.conv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i], 1,
            self.convolutionMode)
            for i, n in enumerate((inputType.depth, inputType.height,
                                   inputType.width)))
        return InputType.convolutional3D(d, h, w, inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        pad = _pads3(self.convolutionMode, self.padding)
        t = str(self.poolingType).lower()
        if t == "max":
            y = _pool.max_pool3d(x, self.kernelSize, self.stride, pad)
        elif t == "avg":
            y = _pool.avg_pool3d(x, self.kernelSize, self.stride, pad)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return y, state


class ZeroPadding3D(Layer):
    """Zero-pad D/H/W (reference: conf.layers.ZeroPadding3D); ``pad`` is
    ((d_lo, d_hi), (h_lo, h_hi), (w_lo, w_hi))."""

    def __init__(self, padding=(1, 1, 1), **kw):
        super().__init__(**kw)
        p = padding
        if isinstance(p, int):
            p = ((p, p),) * 3
        elif len(p) == 3 and not isinstance(p[0], (list, tuple)):
            p = tuple((int(v), int(v)) for v in p)
        else:
            p = tuple((int(a), int(b)) for a, b in p)
        self.pad = p

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        (dl, dh), (hl, hh), (wl, wh) = self.pad
        return InputType.convolutional3D(
            inputType.depth + dl + dh, inputType.height + hl + hh,
            inputType.width + wl + wh, inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        (dl, dh), (hl, hh), (wl, wh) = self.pad
        return F.pad(x, (wl, wh, hl, hh, dl, dh)), state


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

class EmbeddingLayer(FeedForwardLayer):
    """Index -> row lookup (reference: conf.layers.EmbeddingLayer). The
    input is [B] or [B, 1] indices; W ``[nIn, nOut]`` is the table. The
    lookup is an index (``W[idx]``), whose backward on the card sorts the
    indices and adds each row's gradients one after another, so the
    table's gradient is the same bit for bit from the same inputs.
    ``F.embedding``'s backward is not: with many repeats of a row it sums
    partial segments in an order that varies from run to run (measured
    on the H100, port PR 12)."""

    def __init__(self, nIn=None, nOut=None, hasBias=False, **kw):
        super().__init__(nIn=nIn, nOut=nOut, hasBias=hasBias, **kw)

    def inferNIn(self, inputType):
        if self.nIn is None:
            raise ValueError(
                f"{type(self).__name__} requires explicit nIn (vocabulary "
                "size); it cannot be inferred from the input shape")

    def forward(self, params, state, x, train, key, mask=None):
        idx = x.reshape(x.shape[0], -1)[:, 0].long()
        y = params["W"][idx]
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y), state


class EmbeddingSequenceLayer(EmbeddingLayer):
    """[B, T] (or [B, 1, T]) indices -> [B, nOut, T] NCW embeddings
    (reference: conf.layers.EmbeddingSequenceLayer). The output's length
    is the input's when known, else ``inputLength``."""

    def __init__(self, nIn=None, nOut=None, hasBias=False, inputLength=None,
                 **kw):
        super().__init__(nIn=nIn, nOut=nOut, hasBias=hasBias, **kw)
        self.inputLength = inputLength

    def getOutputType(self, inputType):
        t = inputType.dims.get("timeSeriesLength")
        return InputType.recurrent(self.nOut,
                                   self.inputLength if t is None else t)

    def forward(self, params, state, x, train, key, mask=None):
        idx = x[:, 0, :] if x.dim() == 3 else x
        y = params["W"][idx.long()]                      # [B, T, nOut]
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y).transpose(1, 2), state


# ----------------------------------------------------------------------
# the 1-d layers (NCW [B, C, T])
# ----------------------------------------------------------------------

def _one(v):
    return int(v[0] if isinstance(v, (tuple, list)) else v)


class Convolution1DLayer(ConvolutionLayer):
    """1-d convolution over NCW data (reference:
    conf.layers.Convolution1DLayer): W is torch's ``[nOut, nIn, k]``
    where the reference's is ``[k, nIn, nOut]``."""

    def __init__(self, nOut=None, kernelSize=3, stride=1, padding=0,
                 dilation=1, convolutionMode="truncate", nIn=None,
                 hasBias=True, **kw):
        FeedForwardLayer.__init__(self, nIn=nIn, nOut=nOut, hasBias=hasBias,
                                  **kw)
        self.kernelSize = _one(kernelSize)
        self.stride = _one(stride)
        self.padding = _one(padding)
        self.dilation = _one(dilation)
        self.convolutionMode = convolutionMode

    def inferNIn(self, inputType):
        if self.nIn is None and inputType.kind == InputType.RNN:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        t = inputType.dims.get("timeSeriesLength")
        t_out = None if t is None else _conv.conv_output_size(
            t, self.kernelSize, self.stride, self.padding, self.dilation,
            self.convolutionMode)
        return InputType.recurrent(self.nOut, t_out)

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.size
        k = self.kernelSize
        params = {"W": _winit.init(gen, self.weightInit,
                                   (self.nOut, self.nIn, k), k * self.nIn,
                                   k * self.nOut, dtype, device,
                                   self.distribution)}
        if self.hasBias:
            params["b"] = torch.full((self.nOut,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def param_from_reference(self, name, t):
        return t.permute(2, 1, 0).contiguous() if name == "W" else t

    def param_to_reference(self, name, t):
        return t.permute(2, 1, 0).contiguous() if name == "W" else t

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        pad = "SAME" if str(self.convolutionMode).lower() == "same" \
            else ((self.padding, self.padding),)
        y = _conv.conv1d(x, params["W"], params.get("b"), self.stride, pad,
                         self.dilation)
        return _act.get(self.activation)(y), state


class _TimeShapeLayer(Layer):
    """A parameterless reshaping of NCW data's time axis."""

    def hasParams(self):
        return False

    def _t(self, t):
        raise NotImplementedError

    def getOutputType(self, inputType):
        t = inputType.dims.get("timeSeriesLength")
        return InputType.recurrent(inputType.size,
                                   None if t is None else self._t(t))


class Subsampling1DLayer(_TimeShapeLayer):
    """Max/avg pooling over the time axis (reference:
    conf.layers.Subsampling1DLayer), a 2-d pool over a [B, C, T, 1]
    view."""

    def __init__(self, poolingType="max", kernelSize=2, stride=2, padding=0,
                 **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.kernelSize = _one(kernelSize)
        self.stride = _one(stride)
        self.padding = _one(padding)

    def _t(self, t):
        return _conv.conv_output_size(t, self.kernelSize, self.stride,
                                      self.padding, 1, "truncate")

    def forward(self, params, state, x, train, key, mask=None):
        pad = ((self.padding, self.padding), (0, 0))
        k, s = (self.kernelSize, 1), (self.stride, 1)
        t = str(self.poolingType).lower()
        if t == "max":
            y = _pool.max_pool2d(x[..., None], k, s, pad)
        elif t == "avg":
            y = _pool.avg_pool2d(x[..., None], k, s, pad)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return y[..., 0], state


class Upsampling1D(_TimeShapeLayer):
    """Each step repeated ``size`` times (reference: Upsampling1D)."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.sizev = _one(size)

    def _t(self, t):
        return t * self.sizev

    def forward(self, params, state, x, train, key, mask=None):
        return x.repeat_interleave(self.sizev, dim=2), state


class Cropping1D(_TimeShapeLayer):
    """Crop the time axis (reference: conf.layers.Cropping1D)."""

    def __init__(self, cropping=(0, 0), **kw):
        super().__init__(**kw)
        c = (cropping, cropping) if isinstance(cropping, int) \
            else tuple(cropping)
        self.crop = (int(c[0]), int(c[1]))

    def _t(self, t):
        return t - sum(self.crop)

    def forward(self, params, state, x, train, key, mask=None):
        a, b = self.crop
        return x[:, :, a:x.shape[2] - b], state


class ZeroPadding1DLayer(_TimeShapeLayer):
    """Zero-pad the time axis (reference: ZeroPadding1DLayer)."""

    def __init__(self, padding=1, **kw):
        super().__init__(**kw)
        p = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)
        self.pad1 = (int(p[0]), int(p[1]))

    def _t(self, t):
        return t + sum(self.pad1)

    def forward(self, params, state, x, train, key, mask=None):
        return F.pad(x, self.pad1), state


class RepeatVector(Layer):
    """[B, F] -> [B, F, n] (reference: conf.layers.RepeatVector)."""

    def __init__(self, repetitionFactor=2, n=None, **kw):
        super().__init__(**kw)
        self.n = int(n if n is not None else repetitionFactor)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        return InputType.recurrent(inputType.size, self.n)

    def forward(self, params, state, x, train, key, mask=None):
        return x[:, :, None].expand(-1, -1, self.n), state


# ----------------------------------------------------------------------
# mask layers and wrappers
# ----------------------------------------------------------------------

class MaskLayer(Layer):
    """Zero the masked time steps of NCW activations (reference:
    util.MaskLayer)."""

    def hasParams(self):
        return False

    def forward(self, params, state, x, train, key, mask=None):
        if mask is not None and x.dim() == 3:
            x = x * mask[:, None, :].to(x.dtype)
        return x, state


class _Wrapper(Layer):
    """Delegates the layer interface to the wrapped layer (``_inner``
    names the attribute that holds it, the reference's)."""

    _inner = "layer"

    def _wrapped(self):
        return self.__dict__[self._inner]

    def hasParams(self):
        return self._wrapped().hasParams()

    def mergeGlobals(self, defaults):
        super().mergeGlobals(defaults)
        self._wrapped().mergeGlobals(defaults)

    def inferNIn(self, inputType):
        if hasattr(self._wrapped(), "inferNIn"):
            self._wrapped().inferNIn(inputType)

    def getOutputType(self, inputType):
        return self._wrapped().getOutputType(inputType)

    def initialize(self, gen, inputType, dtype, device):
        return self._wrapped().initialize(gen, inputType, dtype, device)

    def regularization(self, params):
        return self._wrapped().regularization(params)

    def param_from_reference(self, name, t):
        return self._wrapped().param_from_reference(name, t)

    def param_to_reference(self, name, t):
        return self._wrapped().param_to_reference(name, t)

    def output_axis(self, name, t):
        return self._wrapped().output_axis(name, t)


class MaskZeroLayer(_Wrapper):
    """Wraps a recurrent layer and derives its time mask from the INPUT:
    a step whose every feature equals ``maskValue`` is masked (reference:
    recurrent.MaskZeroLayer). The wrapped layer's regularization and, if
    the wrapper sets none, its constraints hold."""

    _inner = "underlying"

    def __init__(self, underlying, maskValue=0.0, **kw):
        self.underlying = underlying
        super().__init__(**kw)
        self.maskValue = float(maskValue)

    @property
    def constraints(self):
        own = self.__dict__.get("_own_constraints")
        return own if own else getattr(self.underlying, "constraints", None)

    @constraints.setter
    def constraints(self, v):
        self._own_constraints = v

    def forward(self, params, state, x, train, key, mask=None):
        derived = (x != self.maskValue).any(dim=1).to(x.dtype)
        if mask is not None:
            derived = derived * mask.to(x.dtype)
        return self.underlying.forward(params, state, x, train, key,
                                       derived)


class FrozenLayerWithBackprop(_Wrapper):
    """Freezes the wrapped layer's parameters but KEEPS training mode
    (dropout stays on, BN uses batch statistics), unlike the plain
    ``frozen`` flag, which runs the layer in inference mode (reference:
    misc.FrozenLayerWithBackprop). Gradients flow through to the layers
    below; the wrapped parameters take no update."""

    def __init__(self, layer, **kw):
        super().__init__(**kw)
        self.layer = layer
        self.frozen = True
        self.frozenKeepTraining = True

    def forward(self, params, state, x, train, key, mask=None):
        return self.layer.forward(params, state, x, train, key, mask)

    def __getattr__(self, item):
        # the wrapped layer's attributes (nIn, nOut, activation, ...);
        # AttributeError while copy/pickle rebuild the instance
        if "layer" not in self.__dict__:
            raise AttributeError(item)
        return getattr(self.__dict__["layer"], item)


# ----------------------------------------------------------------------
# spatial and locally connected layers
# ----------------------------------------------------------------------

class SpaceToBatch(Layer):
    """[B,C,H,W] -> [B·b·b,C,H'/b,W'/b] after zero padding (reference:
    conf.layers.SpaceToBatchLayer; ``ops.conv.space_to_batch`` over the
    NHWC view). ``padding`` is [[top, bottom], [left, right]]."""

    def __init__(self, blocks=2, padding=((0, 0), (0, 0)), **kw):
        super().__init__(**kw)
        self.blocks = int(blocks)
        self.pad2 = tuple((int(p[0]), int(p[1])) for p in padding)

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        b = self.blocks
        h = inputType.height + sum(self.pad2[0])
        w = inputType.width + sum(self.pad2[1])
        if h % b or w % b:
            raise ValueError(f"SpaceToBatch blocks={b} must divide padded "
                             f"H={h}, W={w}")
        return InputType.convolutional(h // b, w // b, inputType.channels)

    def forward(self, params, state, x, train, key, mask=None):
        y = _conv.space_to_batch(x.permute(0, 2, 3, 1), self.blocks,
                                 self.pad2)
        return y.permute(0, 3, 1, 2), state


class LocallyConnected2D(FeedForwardLayer):
    """A convolution with UNSHARED weights at each output position
    (reference: conf.layers.LocallyConnected2D). W ``[oh, ow, kh·kw·C,
    nOut]`` and b ``[oh, ow, nOut]`` in the reference's layout, the patch
    features ordered (i, j, c); the patches are gathered from the NHWC
    view and contracted in one einsum."""

    def __init__(self, kernelSize=(2, 2), stride=(1, 1), padding=(0, 0),
                 convolutionMode="truncate", **kw):
        super().__init__(**kw)
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        if str(convolutionMode).lower() == "same":
            raise ValueError("LocallyConnected2D supports truncate/explicit "
                             "padding only (reference parity)")
        self.convolutionMode = convolutionMode

    def inferNIn(self, inputType):
        if self.nIn is None:
            self.nIn = inputType.channels

    def _out_hw(self, inputType):
        return tuple(_conv.conv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i], 1,
            self.convolutionMode)
            for i, n in enumerate((inputType.height, inputType.width)))

    def getOutputType(self, inputType):
        return InputType.convolutional(*self._out_hw(inputType), self.nOut)

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        self._oh, self._ow = self._out_hw(inputType)
        kh, kw = self.kernelSize
        fan_in = self.nIn * kh * kw
        params = {"W": _winit.init(gen, self.weightInit,
                                   (self._oh, self._ow, fan_in, self.nOut),
                                   fan_in, self.nOut, dtype, device,
                                   self.distribution)}
        if self.hasBias:
            params["b"] = torch.full((self._oh, self._ow, self.nOut),
                                     float(self.biasInit), dtype=dtype,
                                     device=device)
        return params, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key).permute(0, 2, 3, 1)
        kh, kw = self.kernelSize
        sh, sw = self.stride
        ph, pw = self.padding
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
        oh, ow = params["W"].shape[:2]
        p = torch.cat([x[:, i:i + (oh - 1) * sh + 1:sh,
                         j:j + (ow - 1) * sw + 1:sw, :]
                       for i in range(kh) for j in range(kw)], dim=-1)
        y = torch.einsum("bhwk,hwko->bhwo", p, params["W"])
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y).permute(0, 3, 1, 2), state


class LocallyConnected1D(FeedForwardLayer):
    """Unshared-weight 1-d convolution over NCW data (reference:
    conf.layers.LocallyConnected1D): W ``[ot, k·C, nOut]``, b ``[ot,
    nOut]``. The weights are per position, so the input's length must be
    fixed."""

    def __init__(self, kernelSize=2, stride=1, padding=0, **kw):
        super().__init__(**kw)
        self.kernelSize = _one(kernelSize)
        self.stride = _one(stride)
        self.padding = _one(padding)

    def inferNIn(self, inputType):
        if self.nIn is None:
            self.nIn = inputType.size

    def _out_t(self, inputType):
        t = inputType.dims.get("timeSeriesLength")
        if t is None:
            raise ValueError("LocallyConnected1D needs a fixed "
                             "timeSeriesLength (unshared weights are "
                             "per-position)")
        return _conv.conv_output_size(t, self.kernelSize, self.stride,
                                      self.padding, 1, "truncate")

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, self._out_t(inputType))

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        # kept on the config as the reference keeps it, so a model file
        # written here runs there
        self._ot = ot = self._out_t(inputType)
        k = self.kernelSize
        params = {"W": _winit.init(gen, self.weightInit,
                                   (ot, k * self.nIn, self.nOut),
                                   k * self.nIn, self.nOut, dtype, device,
                                   self.distribution)}
        if self.hasBias:
            params["b"] = torch.full((ot, self.nOut), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key).transpose(1, 2)  # [B,T,C]
        x = F.pad(x, (0, 0, self.padding, self.padding))
        k, s, ot = self.kernelSize, self.stride, params["W"].shape[0]
        p = torch.cat([x[:, i:i + (ot - 1) * s + 1:s, :] for i in range(k)],
                      dim=-1)
        y = torch.einsum("btk,tko->bto", p, params["W"])
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y).transpose(1, 2), state


# ----------------------------------------------------------------------
# small utility layers
# ----------------------------------------------------------------------

class PReLULayer(Layer):
    """y = max(x, 0) + alpha·min(x, 0) with a learned alpha (reference:
    conf.layers.PReLULayer): per element of [C, H, W] for CNN input (the
    reference's HWC ``[H, W, C]``), ``[F, 1]`` for a sequence, ``[F]``
    otherwise; ``sharedAxes`` (1-based over [C, H, W]) collapse alpha's
    axes to 1; over 3-d CNN input alpha is per element of [C, D, H, W]
    (the reference's ``[D, H, W, C]``), with no shared axes."""

    def __init__(self, sharedAxes=None, alphaInit=0.0, **kw):
        super().__init__(**kw)
        self.sharedAxes = sharedAxes
        self.alphaInit = float(alphaInit)

    def initialize(self, gen, inputType, dtype, device):
        if inputType.kind == InputType.CNN:
            shape = [inputType.channels, inputType.height, inputType.width]
            for a in self.sharedAxes or ():
                shape[int(a) - 1] = 1
        elif inputType.kind == InputType.RNN:
            shape = [inputType.size, 1]
        elif inputType.kind == InputType.CNN3D:
            if self.sharedAxes:
                raise ValueError(
                    "PReLULayer sharedAxes are defined for 2D CNN input "
                    "only; 3D input gets a full per-element alpha")
            shape = [inputType.channels, inputType.depth, inputType.height,
                     inputType.width]
        else:
            shape = [inputType.size]
        return {"alpha": torch.full(shape, self.alphaInit, dtype=dtype,
                                    device=device)}, {}

    def param_from_reference(self, name, t):
        if t.dim() == 4:                                    # DHWC -> CDHW
            return t.permute(3, 0, 1, 2).contiguous()
        return t.permute(2, 0, 1) if t.dim() == 3 else t   # HWC -> CHW

    def param_to_reference(self, name, t):
        if t.dim() == 4:
            return t.permute(1, 2, 3, 0).contiguous()
        return t.permute(1, 2, 0) if t.dim() == 3 else t

    def forward(self, params, state, x, train, key, mask=None):
        a = params["alpha"]
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0), state


class ElementWiseMultiplicationLayer(FeedForwardLayer):
    """activation(x·w + b) with a learned per-feature scale w (reference:
    conf.layers.ElementWiseMultiplicationLayer); nIn == nOut."""

    def getOutputType(self, inputType):
        if self.nOut is not None and self.nOut != inputType.size:
            raise ValueError(
                f"ElementWiseMultiplicationLayer requires nIn == nOut; got "
                f"nOut={self.nOut} on a {inputType.size}-feature input "
                "(reference parity: the layer cannot change width)")
        self.nOut = inputType.size
        return InputType.feedForward(self.nOut)

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        self.nOut = self.nIn
        params = {"W": torch.ones((self.nIn,), dtype=dtype, device=device)}
        if self.hasBias:
            params["b"] = torch.full((self.nIn,), float(self.biasInit),
                                     dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        y = x * params["W"]
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y), state


# ----------------------------------------------------------------------
# output layers with their own loss
# ----------------------------------------------------------------------

class CenterLossOutputLayer(BaseOutputLayer):
    """Softmax output plus the center loss (reference:
    conf.layers.CenterLossOutputLayer, Wen et al. 2016):
    ``L_softmax + lambda/2 · mean ||f - c_y||²``. The class centers
    ``[nClasses, nIn]`` are a parameter trained with the rest. The
    preoutput carries the features beside the logits for ``computeLoss``
    (which the network hands the layer's params); ``outputFromPreact``
    drops them."""

    def __init__(self, alpha=0.05, lambda_=2e-4, lambdaCoeff=None, **kw):
        super().__init__(**kw)
        self.alpha = float(alpha)
        self.lambda_ = float(lambdaCoeff if lambdaCoeff is not None
                             else lambda_)

    def initialize(self, gen, inputType, dtype, device):
        params, state = super().initialize(gen, inputType, dtype, device)
        params["centers"] = torch.zeros((self.nOut, self.nIn), dtype=dtype,
                                        device=device)
        return params, state

    def preoutput(self, params, x):
        return torch.cat([super().preoutput(params, x), x], dim=-1)

    def outputFromPreact(self, pre):
        return _act.get(self.activation)(pre[:, :self.nOut])

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        return _act.get(self.activation)(
            BaseOutputLayer.preoutput(self, params, x)), state

    def computeLoss(self, preact, labels, lmask, params):
        from deeplearning4j_tpu_torch.nn import losses as _losses

        logits, feats = preact[:, :self.nOut], preact[:, self.nOut:]
        base = _losses.compute(self.lossFunction, labels, logits,
                               self.activation, lmask)
        cy = labels @ params["centers"].to(feats.dtype)
        return base + 0.5 * self.lambda_ * (feats - cy).square().sum(
            -1).mean()


class OCNNOutputLayer(BaseOutputLayer):
    """One-class neural network output (reference:
    conf.ocnn.OCNNOutputLayer, Chalapathy et al. 2018): score
    ``yhat = g(x V) w`` and the objective ``mean(max(0, r - yhat)) / nu
    - r`` with r the nu-quantile of the batch's scores, held constant
    (the reference's window of one batch), plus ``0.5 (||V||² +
    ||w||²)`` in the regularization. Labels are ignored (pass zeros of
    [B, 1])."""

    def __init__(self, hiddenSize=40, nu=0.04, activation="sigmoid",
                 initialRValue=0.1, windowSize=10000, **kw):
        kw.setdefault("lossFunction", "mse")
        kw.setdefault("nOut", 1)
        super().__init__(**kw)
        if self.nOut != 1:
            raise ValueError("OCNNOutputLayer emits one score (nOut=1)")
        self.hiddenSize = int(hiddenSize)
        self.nu = float(nu)
        if not (0.0 < self.nu <= 1.0):
            raise ValueError(f"nu must be in (0, 1], got {nu}")
        self.activation = activation
        self.initialRValue = float(initialRValue)
        self.windowSize = int(windowSize)

    def getOutputType(self, inputType):
        return InputType.feedForward(1)

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        h = self.hiddenSize
        return {"V": _winit.init(gen, self.weightInit, (self.nIn, h),
                                 self.nIn, h, dtype, device,
                                 self.distribution),
                "w": _winit.init(gen, self.weightInit, (h, 1), h, 1, dtype,
                                 device, self.distribution)}, {}

    def preoutput(self, params, x):
        return _act.get(self.activation)(x @ params["V"]) @ params["w"]

    def outputFromPreact(self, pre):
        return pre

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        return self.preoutput(params, x), state

    def computeLoss(self, preact, labels, lmask, params):
        if lmask is not None:
            raise ValueError(
                "OCNNOutputLayer does not support label masks (one-class "
                "training has no per-example labels to mask)")
        scores = preact[:, 0]
        r = torch.quantile(scores.detach(), self.nu)
        return torch.clamp(r - scores, min=0.0).mean() / self.nu - r

    def regularization(self, params):
        return super().regularization(params) + 0.5 * (
            params["V"].square().sum() + params["w"].square().sum())


# ----------------------------------------------------------------------
# pretrainable autoencoder
# ----------------------------------------------------------------------

class AutoEncoder(FeedForwardLayer):
    """A (denoising) autoencoder, pretrained layerwise on the MSE of its
    tied-weight reconstruction (reference: conf.layers.AutoEncoder;
    ``corruptionLevel`` drops each input with that probability during
    pretraining). In a supervised stack its forward is the encoder. The
    decoder's visible bias is ``vb [nIn]``."""

    def __init__(self, corruptionLevel=0.0, **kw):
        super().__init__(**kw)
        self.corruptionLevel = float(corruptionLevel)
        self.pretrainable = True

    def initialize(self, gen, inputType, dtype, device):
        params, state = super().initialize(gen, inputType, dtype, device)
        params["vb"] = torch.zeros((self.nIn,), dtype=dtype, device=device)
        return params, state

    def _encode(self, params, x):
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return _act.get(self.activation)(y)

    def forward(self, params, state, x, train, key, mask=None):
        return self._encode(params, self._dropout_input(x, train, key)), \
            state

    def decode(self, params, h):
        return h @ params["W"].t() + params["vb"]

    def draw_keep(self, x, key):
        """The corruption's keep mask from the pretraining step's key."""
        gen = key.generator(x.device)
        return torch.rand(x.shape, generator=gen,
                          device=x.device) < 1.0 - self.corruptionLevel

    def pretrain_loss(self, params, x, key):
        xin = x
        if self.corruptionLevel > 0.0 and key is not None:
            xin = torch.where(self.draw_keep(x, key), x,
                              torch.zeros_like(x))
        rec = self.decode(params, self._encode(params, xin))
        return (rec - x).square().sum(-1).mean()


# ----------------------------------------------------------------------
# capsules (Sabour et al. 2017)
# ----------------------------------------------------------------------

def _squash(s, dim=-1):
    """|s|²/(1+|s|²) · s/|s|, zero vectors to zero with a zero gradient."""
    sq = s.square().sum(dim=dim, keepdim=True)
    pos = sq > 0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    unit = torch.where(pos, s / norm, torch.zeros_like(s))
    return sq / (1.0 + sq) * unit


class PrimaryCapsules(Layer):
    """Conv features regrouped into squashed capsule vectors (reference:
    conf.layers.PrimaryCapsules): a valid conv with
    capsules·capsuleDimensions maps, read as [B, H·W·capsules, dim] in
    the reference's (h, w, group) order, out as NCW [B, dim, nCaps]. W is
    OIHW where the reference's is HWIO."""

    def __init__(self, capsules=8, capsuleDimensions=8, kernelSize=(9, 9),
                 stride=(2, 2), **kw):
        super().__init__(**kw)
        self.channels = int(capsules)
        self.capsuleDimensions = int(capsuleDimensions)
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)

    def _conv_hw(self, inputType):
        return tuple((n - k) // s + 1 for n, k, s in zip(
            (inputType.height, inputType.width), self.kernelSize,
            self.stride))

    def getOutputType(self, inputType):
        if inputType.kind != InputType.CNN:
            raise ValueError("PrimaryCapsules needs convolutional input")
        h, w = self._conv_hw(inputType)
        return InputType.recurrent(self.capsuleDimensions,
                                   h * w * self.channels)

    def initialize(self, gen, inputType, dtype, device):
        kh, kw = self.kernelSize
        cin = inputType.channels
        cout = self.channels * self.capsuleDimensions
        W = _winit.init(gen, self.weightInit, (cout, cin, kh, kw),
                        kh * kw * cin, kh * kw * cout, dtype, device,
                        self.distribution)
        return {"W": W.contiguous(memory_format=torch.channels_last),
                "b": torch.full((cout,), float(self.biasInit), dtype=dtype,
                                device=device)}, {}

    def param_from_reference(self, name, t):
        return _conv_layout(t) if name == "W" else t

    def param_to_reference(self, name, t):
        return t.permute(2, 3, 1, 0).contiguous() if name == "W" else t

    def output_axis(self, name, t):
        return 0

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        y = _conv.conv2d(x, params["W"], params["b"], self.stride)
        B, _, H, W = y.shape
        caps = y.permute(0, 2, 3, 1).reshape(B, H * W * self.channels,
                                             self.capsuleDimensions)
        return _squash(caps).transpose(1, 2), state


class CapsuleLayer(Layer):
    """Fully connected capsules with dynamic routing (reference:
    conf.layers.CapsuleLayer): each input capsule votes for each output
    capsule through W ``[nIn, k, dOut, dIn]``; ``routings`` rounds of
    routing-by-agreement weight the votes."""

    def __init__(self, capsules=10, capsuleDimensions=16, routings=3, **kw):
        super().__init__(**kw)
        self.capsules = int(capsules)
        self.capsuleDimensions = int(capsuleDimensions)
        self.routings = int(routings)

    def getOutputType(self, inputType):
        if inputType.kind != InputType.RNN or \
                inputType.dims.get("timeSeriesLength") is None:
            raise ValueError(
                "CapsuleLayer consumes capsule input with a known capsule "
                "count (InputType.recurrent from PrimaryCapsules/"
                "CapsuleLayer)")
        return InputType.recurrent(self.capsuleDimensions, self.capsules)

    def initialize(self, gen, inputType, dtype, device):
        nIn, dIn = inputType.dims["timeSeriesLength"], inputType.size
        k, dOut = self.capsules, self.capsuleDimensions
        return {"W": _winit.init(gen, self.weightInit, (nIn, k, dOut, dIn),
                                 dIn, dOut, dtype, device,
                                 self.distribution)}, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        u_hat = torch.einsum("ikoj,bij->biko", params["W"],
                             x.transpose(1, 2))
        b = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype,
                        device=u_hat.device)
        for _ in range(max(self.routings - 1, 0)):
            c = torch.softmax(b, dim=2)
            v = _squash(torch.einsum("bik,biko->bko", c, u_hat))
            b = b + torch.einsum("biko,bko->bik", u_hat, v)
        c = torch.softmax(b, dim=2)
        v = _squash(torch.einsum("bik,biko->bko", c, u_hat))
        return v.transpose(1, 2), state


class CapsuleStrengthLayer(Layer):
    """Capsule lengths as class scores, [B, dim, k] -> [B, k] (reference:
    conf.layers.CapsuleStrengthLayer)."""

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        t = inputType.dims.get("timeSeriesLength")
        if inputType.kind != InputType.RNN or t is None:
            raise ValueError("CapsuleStrengthLayer consumes capsule input "
                             "with a known capsule count")
        return InputType.feedForward(t)

    def forward(self, params, state, x, train, key, mask=None):
        sq = x.square().sum(dim=1)
        pos = sq > 0
        return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) \
            * pos.to(sq.dtype), state


# ----------------------------------------------------------------------
# custom layers as SameDiff expressions
# ----------------------------------------------------------------------

def _samediff_call(build, x, extra, train, key, what):
    """``build(sd, x, *extra)`` as a SameDiff graph on x's device, run
    over the tensors, so autograd differentiates through it. A 4-d
    activation reaches the expression NHWC, the reference's layout, and a
    4-d result comes back NCHW-logical. Stochastic ops draw from the
    step's key when training (reference: ``SameDiff._subgraph_fn``)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    sd = SameDiff(device=x.device)
    args = [x.permute(0, 2, 3, 1) if x.dim() == 4 else x] + list(extra)
    phs = [sd.placeHolder(f"in{i}", a.dtype, *a.shape)
           for i, a in enumerate(args)]
    out = build(sd, *phs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(outs) != 1:
        raise ValueError(f"{what} returned {len(outs)} output(s) but 1 "
                         "were declared")
    env = sd._base_env()
    env.update({ph.name: a for ph, a in zip(phs, args)})
    on = train and key is not None
    y = sd._run_graph(env, [outs[0].name], train=on,
                      stream=key.seed() if on else None)[outs[0].name]
    return y.permute(0, 3, 1, 2) if y.dim() == 4 else y


def _dummy_input(inputType):
    """A zero batch of one in the port's layout for shape inference."""
    if inputType.kind == InputType.CNN:
        return torch.zeros(1, inputType.channels, inputType.height,
                           inputType.width)
    if inputType.kind == InputType.RNN:
        return torch.zeros(1, inputType.size,
                           inputType.dims.get("timeSeriesLength") or 1)
    if inputType.kind == InputType.FF:
        return torch.zeros(1, inputType.size)
    raise ValueError(
        f"SameDiff custom layers support FF/RNN/CNN input; got "
        f"{inputType.kind} (add a preprocessor to convert first)")


def _type_of(shape):
    if len(shape) == 2:
        return InputType.feedForward(shape[1])
    if len(shape) == 3:
        return InputType.recurrent(shape[1], shape[2])
    if len(shape) == 4:
        return InputType.convolutional(shape[2], shape[3], shape[1])
    raise ValueError(f"cannot map output shape {tuple(shape)} to an "
                     "InputType")


class SameDiffLambdaLayer(Layer):
    """A parameterless custom layer written as a SameDiff expression
    (reference: conf.layers.samediff.SameDiffLambdaLayer): subclass and
    override ``defineLayer(sd, x)``, or pass ``lambdaFn=``."""

    def __init__(self, lambdaFn=None, **kw):
        super().__init__(**kw)
        self._fn = lambdaFn

    def hasParams(self):
        return False

    def defineLayer(self, sd, x):
        if self._fn is None:
            raise NotImplementedError(
                "override defineLayer(sd, x) or pass lambdaFn=")
        return self._fn(sd, x)

    def getOutputType(self, inputType):
        with torch.no_grad():
            y = _samediff_call(self.defineLayer, _dummy_input(inputType), (),
                               False, None, type(self).__name__)
        return _type_of(y.shape)

    def forward(self, params, state, x, train, key, mask=None):
        return _samediff_call(self.defineLayer, x, (), train, key,
                              type(self).__name__), state


class SameDiffLayer(Layer):
    """A custom layer with parameters, written as a SameDiff expression
    (reference: conf.layers.samediff.SameDiffLayer). Subclasses provide
    ``defineParameters(inputType) -> {name: shape}`` and
    ``defineLayer(sd, x, params) -> SDVariable``; the parameters join the
    network's (updaters, regularization, files) and take the layer's
    init, a vector its bias init."""

    def defineParameters(self, inputType):
        raise NotImplementedError

    def defineLayer(self, sd, x, params):
        raise NotImplementedError

    def _param_shapes(self, inputType):
        shapes = self.defineParameters(inputType)
        if not isinstance(shapes, dict) or not shapes:
            raise ValueError("defineParameters must return a non-empty "
                             "{name: shape} dict")
        return {n: tuple(int(d) for d in shp) for n, shp in shapes.items()}

    def _call(self, x, params, train, key):
        names = sorted(params)
        return _samediff_call(
            lambda sd, a, *ps: self.defineLayer(sd, a, dict(zip(names, ps))),
            x, [params[n] for n in names], train, key, type(self).__name__)

    def getOutputType(self, inputType):
        shapes = self._param_shapes(inputType)
        with torch.no_grad():
            y = self._call(_dummy_input(inputType),
                           {n: torch.zeros(s) for n, s in shapes.items()},
                           False, None)
        return _type_of(y.shape)

    def initialize(self, gen, inputType, dtype, device):
        params = {}
        for n, shp in sorted(self._param_shapes(inputType).items()):
            if len(shp) >= 2:
                params[n] = _winit.init(gen, self.weightInit, shp, shp[0],
                                        shp[-1], dtype, device,
                                        self.distribution)
            else:
                params[n] = torch.full(shp, float(self.biasInit),
                                       dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, key, mask=None):
        x = self._dropout_input(x, train, key)
        return self._call(x, params, train, key), state
