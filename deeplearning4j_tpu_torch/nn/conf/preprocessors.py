"""Input preprocessors: format adapters between layer families.

The counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: the
recurrent <-> feed-forward, CNN <-> feed-forward and CNN <-> recurrent
pairs. Formats: FF ``[B, N]``, RNN NCW ``[B, F, T]``, CNN NCHW-logical
``[B, C, H, W]`` in ``channels_last`` memory (the reference's internal
NHWC). The flatten order is the reference's [C, H, W], so a dense or
recurrent layer's weights after a conv carry across unchanged; with the
channel axis already at dim 1 the port's flatten is a reshape where the
reference transposes from NHWC first. The preprocessors that un-flatten
a batch of B·T rows read B from their ``batch`` attribute, which the
networks set before every forward.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["InputPreProcessor", "CnnToFeedForwardPreProcessor",
           "FeedForwardToCnnPreProcessor", "RnnToFeedForwardPreProcessor",
           "FeedForwardToRnnPreProcessor", "RnnToCnnPreProcessor",
           "CnnToRnnPreProcessor"]


class InputPreProcessor:
    def preProcess(self, x, mask=None):
        raise NotImplementedError

    def getOutputType(self, inputType: InputType) -> InputType:
        raise NotImplementedError


class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,C,H,W] -> [B, C*H*W] in [C, H, W] order."""

    def __init__(self, inputHeight=None, inputWidth=None, numChannels=None):
        self.inputHeight, self.inputWidth, self.numChannels = \
            inputHeight, inputWidth, numChannels

    def preProcess(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def getOutputType(self, inputType):
        return InputType.feedForward(
            inputType.height * inputType.width * inputType.channels)


class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, C*H*W] ([C, H, W] order) -> [B,C,H,W] in channels_last."""

    def __init__(self, inputHeight, inputWidth, numChannels):
        self.inputHeight, self.inputWidth, self.numChannels = \
            inputHeight, inputWidth, numChannels

    def preProcess(self, x, mask=None):
        x = x.reshape(x.shape[0], self.numChannels, self.inputHeight,
                      self.inputWidth)
        return x.contiguous(memory_format=torch.channels_last)

    def getOutputType(self, inputType):
        return InputType.convolutional(self.inputHeight, self.inputWidth,
                                       self.numChannels)


class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,F,T] -> [B*T,F]: apply FF layers per timestep."""

    def preProcess(self, x, mask=None):
        b, f, t = x.shape
        return x.transpose(1, 2).reshape(b * t, f)

    def getOutputType(self, inputType):
        return InputType.feedForward(inputType.size)


class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T,N] -> [B,N,T]. Needs the original batch size at run time;
    the network sets the ``batch`` attribute before each forward."""

    def __init__(self):
        self.batch = None

    def preProcess(self, x, mask=None):
        bt, n = x.shape
        b = self.batch if self.batch is not None else bt
        return x.reshape(b, bt // b, n).transpose(1, 2)

    def getOutputType(self, inputType):
        return InputType.recurrent(inputType.size)


class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, C·H·W, T] -> [B·T, C, H, W] in channels_last: each time step an
    image."""

    def __init__(self, inputHeight, inputWidth, numChannels):
        self.inputHeight, self.inputWidth, self.numChannels = \
            inputHeight, inputWidth, numChannels

    def preProcess(self, x, mask=None):
        b, f, t = x.shape
        x = x.transpose(1, 2).reshape(b * t, self.numChannels,
                                      self.inputHeight, self.inputWidth)
        return x.contiguous(memory_format=torch.channels_last)

    def getOutputType(self, inputType):
        return InputType.convolutional(self.inputHeight, self.inputWidth,
                                       self.numChannels)


class CnnToRnnPreProcessor(InputPreProcessor):
    """[B·T, C, H, W] -> [B, C·H·W, T], features in [C, H, W] order. B is
    the ``batch`` attribute (left unset, every row is its own sequence of
    length 1)."""

    def __init__(self, inputHeight, inputWidth, numChannels):
        self.inputHeight, self.inputWidth, self.numChannels = \
            inputHeight, inputWidth, numChannels
        self.batch = None

    def preProcess(self, x, mask=None):
        bt = x.shape[0]
        b = self.batch if self.batch is not None else bt
        return x.reshape(b, bt // b, -1).transpose(1, 2)

    def getOutputType(self, inputType):
        return InputType.recurrent(
            inputType.height * inputType.width * inputType.channels)
