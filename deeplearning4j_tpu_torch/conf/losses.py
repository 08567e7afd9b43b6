"""Loss functions.

Reference: ``org.nd4j.linalg.lossfunctions.impl.*``; counterpart of the
JAX package's ``conf/losses.py``, with all seventeen of its losses (MSE,
L2, MAE, L1, MAPE, MSLE, MCXENT, SparseMCXENT, BinaryXENT,
NegativeLogLikelihood, Hinge, SquaredHinge, CosineProximity, Poisson, KLD,
Wasserstein, FMeasure) and the same ``@type`` tags and fields. A loss
scores PRE-activations with its output layer's activation, so cross
entropy under softmax (binary cross entropy under sigmoid) takes the
stable fused form; gradients come from autograd through that expression.
FMeasure scores the whole batch, not each example.

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

    def output(self, pre_output, activation: Activation):
        return activation.apply(pre_output)

    def _per_example(self, per_out):
        """Sum per-output losses over the feature axis only, keeping any
        time axis so per-timestep masks apply position-wise."""
        return per_out.sum(dim=-1) if per_out.ndim >= 2 else per_out


@serde.register
@dataclasses.dataclass
class LossMSE(ILossFunction):
    """Mean squared error, averaged over the outputs (reference LossMSE =
    LossL2 / nOut)."""

    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = _apply_weights((out - labels) ** 2, self.weights)
        return _reduce(self._per_example(per_out) / labels.shape[-1], mask)


@serde.register
@dataclasses.dataclass
class LossL2(ILossFunction):
    """Sum of squared errors per example (no /nOut)."""

    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = _apply_weights((out - labels) ** 2, self.weights)
        return _reduce(self._per_example(per_out), mask)


@serde.register
@dataclasses.dataclass
class LossMAE(ILossFunction):
    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = _apply_weights(torch.abs(out - labels), self.weights)
        return _reduce(self._per_example(per_out) / labels.shape[-1], mask)


@serde.register
@dataclasses.dataclass
class LossL1(ILossFunction):
    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = _apply_weights(torch.abs(out - labels), self.weights)
        return _reduce(self._per_example(per_out), mask)


@serde.register
@dataclasses.dataclass
class LossMAPE(ILossFunction):
    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = 100.0 * torch.abs(out - labels) / (torch.abs(labels) + 1e-8)
        per_out = _apply_weights(per_out, self.weights)
        return _reduce(self._per_example(per_out) / labels.shape[-1], mask)


@serde.register
@dataclasses.dataclass
class LossMSLE(ILossFunction):
    weights: Optional[Sequence[float]] = None

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = (torch.log1p(labels) - torch.log1p(out)) ** 2
        per_out = _apply_weights(per_out, self.weights)
        return _reduce(self._per_example(per_out) / labels.shape[-1], mask)


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


@serde.register
@dataclasses.dataclass
class LossSparseMCXENT(LossMCXENT):
    """Labels are integer class indices, ``[batch]`` or ``[batch, 1]``,
    not one-hot (reference LossSparseMCXENT)."""

    def score(self, labels, pre_output, activation, mask=None):
        labels = torch.as_tensor(labels, device=pre_output.device)
        if labels.ndim == pre_output.ndim:  # [batch, 1] -> [batch]
            labels = labels.squeeze(-1)
        oh = F.one_hot(labels.long(), pre_output.shape[-1]).to(
            pre_output.dtype)
        return super().score(oh, pre_output, activation, mask)


@serde.register
@dataclasses.dataclass
class LossBinaryXENT(ILossFunction):
    """Binary cross entropy; the stable fused form under SIGMOID
    (reference LossBinaryXENT with its sigmoid special case)."""

    weights: Optional[Sequence[float]] = None
    clip_eps: float = 1e-7

    def score(self, labels, pre_output, activation, mask=None):
        if activation is Activation.SIGMOID:
            # log(sigmoid(z)) = -softplus(-z); log(1-sigmoid(z)) = -softplus(z)
            per_out = (labels * F.softplus(-pre_output)
                       + (1.0 - labels) * F.softplus(pre_output))
        else:
            out = torch.clamp(activation.apply(pre_output), self.clip_eps,
                              1.0 - self.clip_eps)
            per_out = -(labels * torch.log(out)
                        + (1.0 - labels) * torch.log1p(-out))
        per_out = _apply_weights(per_out, self.weights)
        return _reduce(self._per_example(per_out), mask)


@serde.register
@dataclasses.dataclass
class LossNegativeLogLikelihood(LossMCXENT):
    """Scores as MCXENT, as in the reference (one-hot probability
    labels)."""


def _hinge(labels, out):
    return torch.maximum(torch.zeros_like(out), 1.0 - labels * out)


@serde.register
@dataclasses.dataclass
class LossHinge(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        return _reduce(self._per_example(_hinge(labels, out)), mask)


@serde.register
@dataclasses.dataclass
class LossSquaredHinge(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        return _reduce(self._per_example(_hinge(labels, out) ** 2), mask)


@serde.register
@dataclasses.dataclass
class LossCosineProximity(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        dot = torch.sum(labels * out, dim=-1)
        norm = (torch.linalg.vector_norm(labels, dim=-1)
                * torch.linalg.vector_norm(out, dim=-1))
        return _reduce(-dot / (norm + 1e-8), mask)


@serde.register
@dataclasses.dataclass
class LossPoisson(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        per_out = out - labels * torch.log(out + 1e-8)
        return _reduce(self._per_example(per_out), mask)


@serde.register
@dataclasses.dataclass
class LossKLD(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        safe_labels = torch.clamp(labels, 1e-8, 1.0)
        per_out = labels * (torch.log(safe_labels) - torch.log(out + 1e-8))
        return _reduce(self._per_example(per_out), mask)


@serde.register
@dataclasses.dataclass
class LossWasserstein(ILossFunction):
    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        return _reduce(self._per_example(labels * out), mask)


@serde.register
@dataclasses.dataclass
class LossFMeasure(ILossFunction):
    """Differentiable (soft) F-beta of a binary problem over the whole
    batch (reference LossFMeasure): one probability column, or the second
    column of a two-column softmax."""

    beta: float = 1.0

    def score(self, labels, pre_output, activation, mask=None):
        out = activation.apply(pre_output)
        if out.shape[-1] == 2:  # two-column softmax: positive prob col 1
            out, labels = out[..., 1], labels[..., 1]
        else:
            if out.ndim > 1 and out.shape[-1] == 1:
                out = out.squeeze(-1)
            if labels.ndim > 1 and labels.shape[-1] == 1:
                labels = labels.squeeze(-1)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=out.dtype,
                                device=out.device).reshape(out.shape)
            out, labels = out * m, labels * m
        b2 = self.beta ** 2
        tp = torch.sum(labels * out)
        fp = torch.sum((1.0 - labels) * out)
        fn = torch.sum(labels * (1.0 - out))
        num = (1.0 + b2) * tp
        return 1.0 - num / (num + b2 * fn + fp + 1e-8)


# name -> class, as the reference's LossFunctions.LossFunction enum
LOSS_FUNCTIONS = {
    "MSE": LossMSE,
    "L2": LossL2,
    "MAE": LossMAE,
    "L1": LossL1,
    "MAPE": LossMAPE,
    "MSLE": LossMSLE,
    "MCXENT": LossMCXENT,
    "SPARSE_MCXENT": LossSparseMCXENT,
    "XENT": LossBinaryXENT,
    "NEGATIVELOGLIKELIHOOD": LossNegativeLogLikelihood,
    "HINGE": LossHinge,
    "SQUARED_HINGE": LossSquaredHinge,
    "COSINE_PROXIMITY": LossCosineProximity,
    "POISSON": LossPoisson,
    "KL_DIVERGENCE": LossKLD,
    "WASSERSTEIN": LossWasserstein,
    "FMEASURE": LossFMeasure,
}
