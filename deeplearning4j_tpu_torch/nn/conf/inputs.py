"""Input type declarations and shape inference.

A copy of ``deeplearning4j_tpu/nn/conf/inputs.py`` (it holds no array
code): declare the network's input shape once and each layer's nIn is
inferred by propagating shapes through getOutputType. Recurrent data
is NCW ``[batch, features, time]``; convolutional data is NCHW, or NHWC
where ``InputType.convolutional(.., format="NHWC")`` declares the feed;
3-d convolutional data is NCDHW.
``format`` does not take part in the dims or in equality.
"""

from __future__ import annotations

__all__ = ["InputType"]


class InputType:
    FF = "feedforward"
    RNN = "recurrent"
    CNN = "convolutional"
    CNN_FLAT = "convolutionalFlat"
    CNN3D = "convolutional3d"

    def __init__(self, kind: str, **dims):
        self.kind = kind
        self.dims = dims

    @staticmethod
    def feedForward(size: int) -> "InputType":
        return InputType(InputType.FF, size=int(size))

    @staticmethod
    def recurrent(size: int, timeSeriesLength: int | None = None) -> "InputType":
        return InputType(InputType.RNN, size=int(size),
                         timeSeriesLength=None if timeSeriesLength is None
                         else int(timeSeriesLength))

    @staticmethod
    def convolutional(height: int, width: int, channels: int,
                      format: str = "NCHW") -> "InputType":
        fmt = str(format).upper()
        if fmt not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        it = InputType(InputType.CNN, height=int(height), width=int(width),
                       channels=int(channels))
        it.format = fmt
        return it

    @staticmethod
    def convolutionalFlat(height: int, width: int, depth: int) -> "InputType":
        return InputType(InputType.CNN_FLAT, height=int(height),
                         width=int(width), channels=int(depth))

    @staticmethod
    def convolutional3D(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """Reference: InputType.convolutional3D (NCDHW per example)."""
        return InputType(InputType.CNN3D, depth=int(depth),
                         height=int(height), width=int(width),
                         channels=int(channels))

    def arrayElementsPerExample(self) -> int:
        if self.kind == InputType.FF:
            return self.dims["size"]
        if self.kind == InputType.RNN:
            t = self.dims.get("timeSeriesLength") or 1
            return self.dims["size"] * t
        n = self.dims["height"] * self.dims["width"] * self.dims["channels"]
        if self.kind == InputType.CNN3D:
            n *= self.dims["depth"]
        return n

    def __getattr__(self, item):
        try:
            return self.__dict__["dims"][item]
        except KeyError:
            raise AttributeError(item)

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.dims.items())
        return f"InputType.{self.kind}({inner})"

    def __eq__(self, other):
        return isinstance(other, InputType) and self.kind == other.kind \
            and self.dims == other.dims
