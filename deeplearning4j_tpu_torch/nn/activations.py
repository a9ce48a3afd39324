"""Activation functions.

The counterpart of ``deeplearning4j_tpu/nn/activations.py``: each name
maps to a torch function, and autograd derives the backward. "gelu" is
the reference's ``jax.nn.gelu``, whose default is the tanh
approximation, so it maps to ``F.gelu(x, approximate="tanh")``, not to
torch's exact (erf) default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "Activation", "get"]


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _rationaltanh(x):
    # 1.7159 * tanh(2x/3) approximation used by the reference
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hardsigmoid,
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "softmax": _softmax,
    "softplus": F.softplus,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "cube": lambda x: x * x * x,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, 0.0),
}


class Activation:
    """Enum-style accessors: Activation.RELU etc. resolve to names."""

    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"
    MISH = "mish"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"


def get(name):
    """The activation function for a name (or the callable itself)."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
