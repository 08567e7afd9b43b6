"""Layer normalization, learned position embeddings and the Graves
bidirectional LSTM.

Counterparts of the JAX package's ``conf/layers_extra.py``
``LayerNormalization`` and ``PositionEmbeddingLayer`` (the two layers the
Transformer zoo model uses besides attention) and
``GravesBidirectionalLSTM``; the same fields and ``@type`` tags, so
configurations round-trip between the packages.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import BaseLayer
from deeplearning4j_tpu_torch.conf.layers_rnn import (
    Bidirectional,
    BidirectionalMode,
    GravesLSTM,
)


@serde.register
@dataclasses.dataclass
class LayerNormalization(BaseLayer):
    """Layer normalization over the last (feature) axis with learnable
    ``gain`` / ``b``: ``(x - mean) * rsqrt(var + eps) * gain + b``, the
    biased variance, as the JAX package computes it."""

    eps: float = 1e-5

    def output_type(self, input_type):
        return input_type

    def _n(self, input_type):
        if isinstance(input_type, (it.Convolutional, it.Convolutional3D)):
            return input_type.channels
        return input_type.size

    def init(self, gen, input_type, dtype=torch.float32):
        n = self._n(input_type)
        return {"gain": torch.ones((n,), dtype=dtype),
                "b": torch.zeros((n,), dtype=dtype)}

    def param_order(self):
        return ["gain", "b"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * params["gain"] + params["b"], state


@serde.register
@dataclasses.dataclass
class PositionEmbeddingLayer(BaseLayer):
    """Learned absolute position embeddings added to a sequence
    ``[batch, time, size]``. Param ``P: [max_len, size]``; a sequence
    longer than ``max_len`` raises."""

    max_len: int = 512

    def output_type(self, input_type):
        return input_type

    def init(self, gen, input_type, dtype=torch.float32):
        n = input_type.size
        w = self.weight_init.init(gen, (self.max_len, n), self.max_len, n,
                                  dtype, self.distribution)
        return {"P": w * 0.02}

    def param_order(self):
        return ["P"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds "
                             f"max_len={self.max_len}")
        return x + params["P"][None, :t, :], state


@serde.register
@dataclasses.dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """Reference ``GravesBidirectionalLSTM``: a bidirectional Graves LSTM
    with CONCAT combining (its own conf class for parity; the modern
    reference deprecates it for ``Bidirectional(GravesLSTM)``)."""

    n_out: int = 0
    forget_gate_bias_init: float = 1.0

    def __post_init__(self):
        if self.layer is None:
            self.layer = GravesLSTM(
                n_out=self.n_out,
                forget_gate_bias_init=self.forget_gate_bias_init)
        self.mode = BidirectionalMode.CONCAT
