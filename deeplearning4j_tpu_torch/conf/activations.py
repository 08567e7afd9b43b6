"""Activation functions.

Reference: ``org.nd4j.linalg.activations.Activation`` enum. The enum and its
values are the JAX package's, so configs round-trip between the packages;
each function is the torch form of the same formula.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde


@serde.register_enum
class Activation(enum.Enum):
    """Mirrors the reference's ``Activation`` enum values."""

    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    THRESHOLDEDRELU = "thresholdedrelu"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _FNS[self](x)


def _rationaltanh(x):
    # Reference ActivationRationalTanh: 1.7159 * tanh_approx(2x/3) where
    # tanh_approx(y) = sign(y) * (1 - 1/(1+|y|+y^2+1.41645*y^4))
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * (y ** 4)))
    return 1.7159 * approx


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) with no large-x cutoff
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


_FNS = {
    Activation.IDENTITY: lambda x: x,
    Activation.SIGMOID: torch.sigmoid,
    Activation.TANH: torch.tanh,
    Activation.RELU: torch.relu,
    Activation.RELU6: lambda x: torch.clamp(x, 0.0, 6.0),
    Activation.LEAKYRELU: lambda x: F.leaky_relu(x, 0.01),
    Activation.ELU: F.elu,
    Activation.SELU: F.selu,
    # jax.nn.gelu's default is the tanh approximation
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.SOFTPLUS: _softplus,
    Activation.SOFTSIGN: lambda x: x / (1.0 + torch.abs(x)),
    Activation.SWISH: F.silu,
    Activation.MISH: lambda x: x * torch.tanh(_softplus(x)),
    # Reference ActivationHardSigmoid: clip(0.2*x + 0.5, 0, 1)
    Activation.HARDSIGMOID: lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.CUBE: lambda x: x ** 3,
    Activation.RATIONALTANH: _rationaltanh,
    Activation.RECTIFIEDTANH: lambda x: torch.relu(torch.tanh(x)),
    Activation.THRESHOLDEDRELU: lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}
