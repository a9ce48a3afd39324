"""Weight initialization schemes.

The counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same
schemes with the same fan-in/fan-out formulas, drawn from a
``torch.Generator``. The draws are made on the CPU and then moved, so a
seed gives the same weights on every device. They do not match the
reference's threefry draws: parity tests carry the reference's weights
across instead.
"""

from __future__ import annotations

import math

import torch

__all__ = ["WeightInit", "init", "NormalDistribution", "UniformDistribution",
           "WeightInitEmbedding"]


class WeightInit:
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    UNIFORM = "uniform"
    NORMAL = "normal"
    ZERO = "zero"
    ONES = "ones"
    IDENTITY = "identity"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"


class NormalDistribution:
    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def sample(self, gen, shape):
        return self.mean + self.std * torch.randn(shape, generator=gen)


class UniformDistribution:
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, gen, shape):
        return self.lower + (self.upper - self.lower) * torch.rand(
            shape, generator=gen)


class WeightInitEmbedding:
    """An embedding table from pretrained vectors (reference:
    nn.weights.WeightInitEmbedding over an EmbeddingInitializer): a raw
    [nIn, nOut] array, or any word-vector model of the nlp package
    (Word2Vec, ParagraphVectors, Glove, FastText, StaticWordVectors:
    anything with ``vocab`` and ``getWordVector``), whose rows follow
    the model's vocabulary index order, the order EmbeddingSequenceLayer
    inputs use when tokenized against that vocabulary."""

    def __init__(self, source):
        self.source = source

    def table(self, shape, dtype, device):
        import numpy as np

        src = self.source
        if hasattr(src, "vocab") and hasattr(src, "getWordVector"):
            words = getattr(src, "_ivocab", None) \
                or sorted(src.vocab, key=src.vocab.get)
            t = torch.from_numpy(np.stack(
                [np.asarray(src.getWordVector(w), np.float32)
                 for w in words]))
        elif isinstance(src, torch.Tensor):
            t = src.detach().cpu()
        else:
            t = torch.from_numpy(np.array(src, copy=True))
        if t.dim() != 2 or tuple(t.shape) != tuple(shape):
            rows, cols = (t.shape if t.dim() == 2 else ("?", "?"))
            raise ValueError(
                f"pretrained embedding shape {tuple(t.shape)} does not "
                f"match the layer's (nIn, nOut) {tuple(shape)}: set "
                f"nIn={rows}, nOut={cols} on the embedding layer")
        return t.to(device=device, dtype=dtype)


def _normal(gen, shape, std):
    return std * torch.randn(shape, generator=gen)


def _uniform(gen, shape, a):
    return (2.0 * torch.rand(shape, generator=gen) - 1.0) * a


def init(gen, scheme, shape, fan_in, fan_out, dtype=torch.float32,
         device="cpu", distribution=None):
    """A weight tensor of `shape` under `scheme`, drawn from the CPU
    generator `gen`. fan_in/fan_out are the layer's logical fans. A
    ``WeightInitEmbedding`` scheme gives its table (only an embedding
    layer's [nIn, nOut] matches it)."""
    if isinstance(scheme, WeightInitEmbedding):
        return scheme.table(shape, dtype, device)
    s = (scheme if isinstance(scheme, str)
         else getattr(scheme, "value", str(scheme))).lower()
    shape = tuple(shape)
    if s == "zero":
        w = torch.zeros(shape)
    elif s == "ones":
        w = torch.ones(shape)
    elif s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2d shape")
        w = torch.eye(shape[0])
    elif s == "distribution":
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a distribution")
        w = distribution.sample(gen, shape)
    elif s == "xavier":
        w = _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)))
    elif s == "xavier_uniform":
        w = _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))
    elif s in ("xavier_fan_in", "lecun_normal", "normal",
               "var_scaling_normal_fan_in"):
        w = _normal(gen, shape, math.sqrt(1.0 / fan_in))
    elif s == "relu":
        w = _normal(gen, shape, math.sqrt(2.0 / fan_in))
    elif s == "relu_uniform":
        w = _uniform(gen, shape, math.sqrt(6.0 / fan_in))
    elif s == "lecun_uniform":
        w = _uniform(gen, shape, math.sqrt(3.0 / fan_in))
    elif s == "sigmoid_uniform":
        w = _uniform(gen, shape, 4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    elif s == "uniform":
        w = _uniform(gen, shape, 1.0 / math.sqrt(fan_in))
    elif s == "var_scaling_normal_fan_out":
        w = _normal(gen, shape, math.sqrt(1.0 / fan_out))
    elif s == "var_scaling_normal_fan_avg":
        w = _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)))
    else:
        raise ValueError(f"Unknown weight init scheme '{scheme}'")
    return w.to(device=device, dtype=dtype)
