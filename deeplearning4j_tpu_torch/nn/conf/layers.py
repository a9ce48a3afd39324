"""Layer configurations with their init and forward.

The counterpart of ``deeplearning4j_tpu/nn/conf/layers.py`` for what the
ported slices need: ``Layer``, ``BaseLayer``, ``FeedForwardLayer``,
``DenseLayer``, ``BaseOutputLayer``, ``OutputLayer``, ``RnnOutputLayer``,
``ActivationLayer``, ``ConvolutionLayer``, ``SubsamplingLayer``,
``GlobalPoolingLayer`` and ``BatchNormalization``. As in the reference a
layer config IS its implementation: ``initialize(gen, inputType, dtype,
device)`` returns ``(params, state)`` dicts of tensors with the
reference's names, and ``forward(params, state, x, train, gen, mask)``
is a plain function of them that autograd differentiates (BN through the
``ops.norm`` autograd Functions).

Layouts: recurrent activations between layers are NCW ``[B, F, T]``;
convolutional ones NCHW-logical in ``channels_last`` memory, where the
reference keeps NHWC. Each layer owns the map between the reference's
parameter layout and its own (``param_from_reference`` and its inverse
``param_to_reference``): dense ``W`` is ``[in, out]`` on both sides,
a conv ``W`` is the reference's HWIO ``[kh, kw, in, out]`` and the port's
OIHW ``[out, in, kh, kw]`` (channels_last memory). The recurrent layers
are in ``nn/conf/recurrent.py``; the other layers wait for their slices
(ROADMAP.md Queue 1 items 5 and 8); dropout waits for the nn-conf slice
(item 4) and raises when asked for.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import conv as _conv
from deeplearning4j_tpu_torch.ops import norm as _norm
from deeplearning4j_tpu_torch.ops import pooling as _pool
from deeplearning4j_tpu_torch.ops.conv import _pair

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "DenseLayer",
           "BaseOutputLayer", "OutputLayer", "RnnOutputLayer",
           "ActivationLayer", "ConvolutionLayer", "SubsamplingLayer",
           "GlobalPoolingLayer", "BatchNormalization"]


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

    def forward(self, params, state, x, train: bool, gen, mask=None):
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

    def _dropout_input(self, x, train, gen):
        if train and self.dropOut is not None:
            raise NotImplementedError(
                "dropout waits for the nn-conf slice (ROADMAP.md Queue 1 "
                "item 4)")
        return x

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

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
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

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
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

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        pre = self.preoutput(params, x)
        # activation over the class axis (softmax must not run over time)
        act = _act.get(self.activation)
        return act(pre.transpose(1, 2)).transpose(1, 2), state


class ActivationLayer(Layer):
    def hasParams(self):
        return False

    def forward(self, params, state, x, train, gen, mask=None):
        return _act.get(self.activation)(x), state


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

    def getOutputType(self, inputType):
        h, w = (_conv.conv_output_size(
            n, self.kernelSize[i], self.stride[i], self.padding[i],
            self.dilation[i], self.convolutionMode)
            for i, n in enumerate((inputType.height, inputType.width)))
        return InputType.convolutional(h, w, self.nOut)

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.channels
        kh, kw = self.kernelSize
        W = _winit.init(gen, self.weightInit, (self.nOut, self.nIn, kh, kw),
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
            return t.permute(3, 2, 0, 1).contiguous().contiguous(
                memory_format=torch.channels_last)
        return t

    def param_to_reference(self, name, t):
        if name == "W":   # OIHW -> HWIO
            return t.permute(2, 3, 1, 0).contiguous()
        return t

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        pad = _conv.explicit_padding(self.convolutionMode, self.padding,
                                     self.kernelSize, self.stride,
                                     self.dilation)
        y = _conv.conv2d(x, params["W"], params.get("b"), self.stride, pad,
                         self.dilation)
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

    def forward(self, params, state, x, train, gen, mask=None):
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

    def forward(self, params, state, x, train, gen, mask=None):
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

    def forward(self, params, state, x, train, gen, mask=None):
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
