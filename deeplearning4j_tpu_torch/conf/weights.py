"""Weight initialization schemes.

Reference: ``org.deeplearning4j.nn.weights.WeightInit`` enum +
``WeightInitUtil`` (fan-in/fan-out based scaling), plus ``Distribution``
configs. The enum, its values and the ``Distribution`` fields are the JAX
package's, so configs round-trip; sampling draws from an explicit
``torch.Generator`` (on the CPU, so a seed gives the same weights on every
device) instead of a jax PRNG key. The two packages therefore draw different
numbers from the same seed; parity tests copy weights across.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from deeplearning4j_tpu_torch import serde


@serde.register
@dataclasses.dataclass
class Distribution:
    """Reference: ``org.deeplearning4j.nn.conf.distribution.Distribution``.

    kind: "normal" (mean/std), "uniform" (lower/upper), "truncated_normal",
    "constant" (value), "orthogonal" (gain).
    """

    kind: str = "normal"
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    value: float = 0.0
    gain: float = 1.0

    def sample(self, gen: torch.Generator, shape, dtype=torch.float32):
        t = torch.empty(shape, dtype=torch.float32)
        if self.kind == "normal":
            t.normal_(self.mean, self.std, generator=gen)
        elif self.kind == "truncated_normal":
            # jax.random.truncated_normal(-2, 2) scaled by std
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t = self.mean + self.std * t
        elif self.kind == "uniform":
            t.uniform_(self.lower, self.upper, generator=gen)
        elif self.kind == "constant":
            t.fill_(self.value)
        elif self.kind == "orthogonal":
            torch.nn.init.orthogonal_(t, self.gain, generator=gen)
        else:
            raise ValueError(f"unknown distribution kind: {self.kind}")
        return t.to(dtype)


@serde.register_enum
class WeightInit(enum.Enum):
    """Mirrors the reference's ``WeightInit`` enum (WeightInitUtil scalings)."""

    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    NORMAL = "normal"               # N(0, 1/sqrt(fanIn))
    UNIFORM = "uniform"             # U(-a, a), a = 1/sqrt(fanIn)
    XAVIER = "xavier"               # N(0, 2/(fanIn+fanOut))
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"                   # He: N(0, 2/fanIn)
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    VAR_SCALING_NORMAL_FAN_IN = "vs_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "vs_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "vs_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "vs_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "vs_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "vs_uniform_fan_avg"
    IDENTITY = "identity"
    DISTRIBUTION = "distribution"

    def init(self, gen: torch.Generator, shape, fan_in, fan_out,
             dtype=torch.float32,
             distribution: Distribution | None = None) -> torch.Tensor:
        """Sample a weight tensor on the CPU. fan_in/fan_out follow
        WeightInitUtil; the scale of each scheme is the JAX package's."""
        w = self
        if w is WeightInit.ZERO:
            return torch.zeros(shape, dtype=dtype)
        if w is WeightInit.ONES:
            return torch.ones(shape, dtype=dtype)
        if w is WeightInit.CONSTANT:
            dist = distribution or Distribution(kind="constant", value=0.0)
            return dist.sample(gen, shape, dtype)
        if w is WeightInit.IDENTITY:
            if len(shape) != 2 or shape[0] != shape[1]:
                raise ValueError("IDENTITY init requires a square 2d shape")
            return torch.eye(shape[0], dtype=dtype)
        if w is WeightInit.DISTRIBUTION:
            if distribution is None:
                raise ValueError("WeightInit.DISTRIBUTION requires a Distribution")
            return distribution.sample(gen, shape, dtype)
        if w in _NORMAL_STD:
            std = _NORMAL_STD[w](fan_in, fan_out)
            t = torch.empty(shape, dtype=torch.float32).normal_(
                0.0, std, generator=gen)
            return t.to(dtype)
        if w in _UNIFORM_BOUND:
            a = _UNIFORM_BOUND[w](fan_in, fan_out)
            t = torch.empty(shape, dtype=torch.float32).uniform_(
                -a, a, generator=gen)
            return t.to(dtype)
        raise ValueError(f"unhandled WeightInit: {w}")


_NORMAL_STD = {
    WeightInit.NORMAL: lambda i, o: 1.0 / math.sqrt(i),
    WeightInit.XAVIER: lambda i, o: math.sqrt(2.0 / (i + o)),
    WeightInit.XAVIER_FAN_IN: lambda i, o: math.sqrt(1.0 / i),
    WeightInit.RELU: lambda i, o: math.sqrt(2.0 / i),
    WeightInit.LECUN_NORMAL: lambda i, o: math.sqrt(1.0 / i),
    WeightInit.VAR_SCALING_NORMAL_FAN_IN: lambda i, o: math.sqrt(1.0 / i),
    WeightInit.VAR_SCALING_NORMAL_FAN_OUT: lambda i, o: math.sqrt(1.0 / o),
    WeightInit.VAR_SCALING_NORMAL_FAN_AVG: lambda i, o: math.sqrt(2.0 / (i + o)),
}

_UNIFORM_BOUND = {
    WeightInit.UNIFORM: lambda i, o: 1.0 / math.sqrt(i),
    WeightInit.XAVIER_UNIFORM: lambda i, o: math.sqrt(6.0 / (i + o)),
    WeightInit.RELU_UNIFORM: lambda i, o: math.sqrt(6.0 / i),
    WeightInit.LECUN_UNIFORM: lambda i, o: math.sqrt(3.0 / i),
    WeightInit.SIGMOID_UNIFORM: lambda i, o: 4.0 * math.sqrt(6.0 / (i + o)),
    WeightInit.VAR_SCALING_UNIFORM_FAN_IN: lambda i, o: math.sqrt(3.0 / i),
    WeightInit.VAR_SCALING_UNIFORM_FAN_OUT: lambda i, o: math.sqrt(3.0 / o),
    WeightInit.VAR_SCALING_UNIFORM_FAN_AVG: lambda i, o: math.sqrt(6.0 / (i + o)),
}
