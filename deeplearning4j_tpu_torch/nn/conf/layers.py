"""Layer configurations with their init and forward.

The counterpart of ``deeplearning4j_tpu/nn/conf/layers.py`` for what the
attention/encoder slice needs: ``Layer``, ``BaseLayer``,
``FeedForwardLayer``, ``DenseLayer``, ``BaseOutputLayer``,
``OutputLayer``, ``RnnOutputLayer``, ``ActivationLayer`` and
``GlobalPoolingLayer``. As in the reference a layer config IS its
implementation: ``initialize(gen, inputType, dtype, device)`` returns
``(params, state)`` dicts of tensors with the reference's names and
``[in, out]`` layout (``W``, ``b``), and ``forward(params, state, x,
train, gen, mask)`` is a plain function of them that autograd
differentiates. Recurrent activations between layers are NCW
``[B, F, T]``. The CNN, recurrent and other layers wait for their slices
(ROADMAP.md Queue 1 items 4, 5 and 8); dropout waits for the nn-conf
slice and raises when asked for.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "DenseLayer",
           "BaseOutputLayer", "OutputLayer", "RnnOutputLayer",
           "ActivationLayer", "GlobalPoolingLayer"]


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


def global_pool(x, pooling_type, dims, mask=None, pnorm=2):
    """Global pooling over `dims`, with an optional mask broadcastable to
    x (reference: ops/pooling.global_pool)."""
    t = str(pooling_type).lower()
    denom = None
    if mask is not None:
        m = mask.expand_as(x)
        x = torch.where(m > 0, x, -torch.inf) if t == "max" else x * m
        denom = torch.clamp(m.sum(dim=dims), min=1.0)
    if t == "max":
        return x.amax(dim=dims)
    if t == "sum":
        return x.sum(dim=dims)
    if t == "avg":
        return x.sum(dim=dims) / denom if denom is not None \
            else x.mean(dim=dims)
    if t == "pnorm":
        return x.abs().pow(pnorm).sum(dim=dims).pow(1.0 / pnorm)
    raise ValueError(f"Unknown pooling type '{pooling_type}'")


class GlobalPoolingLayer(Layer):
    """Global pooling over time (RNN input [B,F,T] -> [B,F]); FF input
    passes through (reference: conf.layers.GlobalPoolingLayer). The CNN
    modes wait for the CNN slice."""

    def __init__(self, poolingType="max", pnorm=2, collapseDimensions=True,
                 **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.pnorm = pnorm
        self.collapseDimensions = collapseDimensions

    def hasParams(self):
        return False

    def getOutputType(self, inputType):
        if inputType.kind == InputType.RNN:
            if not self.collapseDimensions:
                return InputType.recurrent(inputType.size, 1)
            return InputType.feedForward(inputType.size)
        if inputType.kind == InputType.FF:
            return inputType
        raise NotImplementedError(
            "GlobalPoolingLayer over CNN input waits for the CNN slice "
            "(ROADMAP.md Queue 1 item 4)")

    def forward(self, params, state, x, train, gen, mask=None):
        if x.dim() != 3:
            return x, state
        m = None if mask is None else mask[:, None, :].to(x.dtype)
        y = global_pool(x, self.poolingType, (2,), m, self.pnorm)
        if not self.collapseDimensions:
            y = y[:, :, None]
        return y, state
