"""Loss functions.

Reference: ``org.nd4j.linalg.lossfunctions.impl.*``; counterpart of the
JAX package's ``conf/losses.py``. A loss scores PRE-activations with its
output layer's activation, so cross entropy under softmax takes the stable
fused log-softmax form; gradients come from autograd through that
expression.

Contract: ``score(labels, pre_output, activation, mask) -> scalar`` (mean
over examples; ``mask`` per example, or per time step where the labels
have one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.activations import Activation


def _apply_weights(per_out, weights):
    if weights is not None:
        per_out = per_out * torch.as_tensor(weights, dtype=per_out.dtype,
                                            device=per_out.device)
    return per_out


def _reduce(per_pos, mask):
    """Mean over (masked) positions. ``per_pos``: [batch] or [batch, time]."""
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=per_pos.dtype,
                               device=per_pos.device)
        if mask.ndim > per_pos.ndim:  # e.g. [batch, 1] column mask vs [batch]
            mask = mask.reshape(per_pos.shape)
        while mask.ndim < per_pos.ndim:
            mask = mask[..., None]
        mask = torch.broadcast_to(mask, per_pos.shape)
        denom = torch.clamp(mask.sum(), min=1.0)
        return (per_pos * mask).sum() / denom
    return per_pos.mean()


@dataclasses.dataclass
class ILossFunction:
    """Base loss contract. ``weights``: optional per-output weighting."""

    def score(self, labels, pre_output, activation: Activation, mask=None):
        raise NotImplementedError

    def _per_example(self, per_out):
        """Sum per-output losses over the feature axis only, keeping any
        time axis so per-timestep masks apply position-wise."""
        return per_out.sum(dim=-1) if per_out.ndim >= 2 else per_out


@serde.register
@dataclasses.dataclass
class LossMCXENT(ILossFunction):
    """Multi-class cross entropy (reference LossMCXENT). Under SOFTMAX it
    uses the fused log-softmax; otherwise the activation's output clipped
    to ``[clip_eps, 1]``."""

    weights: Optional[Sequence[float]] = None
    clip_eps: float = 1e-10

    def score(self, labels, pre_output, activation, mask=None):
        if activation is Activation.SOFTMAX:
            logp = F.log_softmax(pre_output, dim=-1)
        else:
            out = torch.clamp(activation.apply(pre_output), self.clip_eps, 1.0)
            logp = torch.log(out)
        per_out = _apply_weights(-labels * logp, self.weights)
        return _reduce(self._per_example(per_out), mask)
