"""Layer configurations with their init and forward.

The counterpart of ``deeplearning4j_tpu/nn/conf/layers.py`` for what the
ported slices need: ``Layer``, ``BaseLayer``, ``FeedForwardLayer``,
``DenseLayer``, ``BaseOutputLayer``, ``OutputLayer``, ``RnnOutputLayer``,
``LossLayer``, ``CnnLossLayer``, ``RnnLossLayer``, ``ActivationLayer``,
``DropoutLayer``, ``ConvolutionLayer``, ``Deconvolution2D``,
``DepthwiseConvolution2D``, ``SeparableConvolution2D``,
``SubsamplingLayer``, ``Upsampling2D``, ``ZeroPaddingLayer``,
``Cropping2D``, ``GlobalPoolingLayer``, ``BatchNormalization``,
``LocalResponseNormalization`` and ``SpaceToDepth``. As in the reference
a layer config IS its implementation: ``initialize(gen, inputType, dtype,
device)`` returns ``(params, state)`` dicts of tensors with the
reference's names, and ``forward(params, state, x, train, key, mask)``
is a plain function of them that autograd differentiates (BN through the
``ops.norm`` autograd Functions). ``key`` is the step's
``dropout.StepKey`` for this layer (None outside training): dropout
applies to the layer's input when training, as in the reference.

Layouts: recurrent activations between layers are NCW ``[B, F, T]``;
convolutional ones NCHW-logical in ``channels_last`` memory, where the
reference keeps NHWC. Each layer owns the map between the reference's
parameter layout and its own (``param_from_reference`` and its inverse
``param_to_reference``): dense ``W`` is ``[in, out]`` on both sides,
a conv ``W`` is the reference's HWIO ``[kh, kw, in, out]`` and the port's
OIHW ``[out, in, kh, kw]`` (channels_last memory); a depthwise
``[kh, kw, 1, C·m]`` is a grouped ``[C·m, 1, kh, kw]`` (output channel
``g·m + j`` reads input channel g on both sides); a deconvolution's
unflipped HWIO ``[kh, kw, Cin, Cout]`` is ``conv_transpose2d``'s flipped
``[Cin, Cout, kh, kw]``. The recurrent layers are in
``nn/conf/recurrent.py``; the 1-d, 3-d, locally connected, capsule and
other layers wait for their slices (ROADMAP.md Queue 1 items 4, 8
and 12).
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
           "SpaceToDepth"]


class Layer:
    """Base layer config. None-valued common fields inherit the network's
    global defaults."""

    _GLOBAL_FIELDS = ("activation", "weightInit", "biasInit", "updater",
                      "l1", "l2", "l1Bias", "l2Bias", "weightDecay",
                      "dropOut", "distribution")

    def __init__(self, name=None, activation=None, weightInit=None,
                 biasInit=None, updater=None, l1=None, l2=None, l1Bias=None,
                 l2Bias=None, weightDecay=None, dropOut=None,
                 distribution=None):
        self.name = name
        self.activation = activation
        self.weightInit = weightInit
        self.biasInit = biasInit
        self.updater = updater
        self.l1, self.l2 = l1, l2
        self.l1Bias, self.l2Bias = l1Bias, l2Bias
        self.weightDecay = weightDecay
        self.dropOut = dropOut
        self.distribution = distribution

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

    def _dropout_input(self, x, train, key):
        """Dropout on the layer's input, when training with a key
        (reference: ``Layer._dropout_input``)."""
        d = _do.resolve(self.dropOut)
        if not train or d is None or key is None:
            return x
        return d.apply(x, key)

    # neither weights nor biases: never regularized (as the reference)
    _NON_WEIGHT_PARAMS = ("b", "beta", "centers", "alpha", "vb")

    def regularization(self, params):
        """Scalar l1/l2/weight-decay penalty for this layer's params."""
        total = 0.0
        l1, l2, wd = self.l1 or 0.0, self.l2 or 0.0, self.weightDecay or 0.0
        for k, p in params.items():
            if k in self._NON_WEIGHT_PARAMS:
                continue
            if l1:
                total = total + l1 * p.abs().sum()
            if l2 or wd:
                total = total + 0.5 * (l2 + wd) * p.square().sum()
        l1b, l2b = self.l1Bias or 0.0, self.l2Bias or 0.0
        if "b" in params and (l1b or l2b):
            total = total + l1b * params["b"].abs().sum() \
                + 0.5 * l2b * params["b"].square().sum()
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
    (reference: conf.layers.GlobalPoolingLayer). 3D CNN input waits for
    its slice."""

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
        if inputType.kind == InputType.FF:
            return inputType
        raise NotImplementedError(
            f"GlobalPoolingLayer over {inputType.kind} input waits for the "
            "3D CNN layers (ROADMAP.md Queue 1 item 12)")

    def forward(self, params, state, x, train, key, mask=None):
        if x.dim() == 4:      # [B,C,H,W]
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
