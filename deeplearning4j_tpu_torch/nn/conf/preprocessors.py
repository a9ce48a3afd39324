"""Input preprocessors: format adapters between layer families.

The counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` for
the recurrent <-> feed-forward pair the encoder uses. Formats: FF
``[B, N]``, RNN NCW ``[B, F, T]``. The CNN preprocessors wait for the
CNN slice (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["InputPreProcessor", "RnnToFeedForwardPreProcessor",
           "FeedForwardToRnnPreProcessor"]


class InputPreProcessor:
    def preProcess(self, x, mask=None):
        raise NotImplementedError

    def getOutputType(self, inputType: InputType) -> InputType:
        raise NotImplementedError


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
