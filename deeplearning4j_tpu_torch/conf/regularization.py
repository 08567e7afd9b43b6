"""Regularization: L1 / L2 / WeightDecay.

Reference: ``org.nd4j.linalg.learning.regularization.{L1Regularization,
L2Regularization, WeightDecay}``; counterpart of the JAX package's
``conf/regularization.py`` (same ``@type`` tags and fields):

- L1/L2 act on the *gradient* before the updater: g += l2 * w
  (resp. l1 * sign(w));
- WeightDecay acts on the *update* after the updater:
  update += coeff * (lr if apply_lr else 1) * w.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch import serde


@dataclasses.dataclass
class Regularization:
    def apply_before_updater(self, g, w, lr):
        return g

    def apply_after_updater(self, update, w, lr):
        return update

    def score_term(self, w):
        """Contribution to the loss score (reference ``Regularization#score``)."""
        return 0.0


@serde.register
@dataclasses.dataclass
class L2Regularization(Regularization):
    l2: float = 0.0

    def apply_before_updater(self, g, w, lr):
        return g + self.l2 * w

    def score_term(self, w):
        return 0.5 * self.l2 * torch.sum(w * w)


@serde.register
@dataclasses.dataclass
class L1Regularization(Regularization):
    l1: float = 0.0

    def apply_before_updater(self, g, w, lr):
        return g + self.l1 * torch.sign(w)

    def score_term(self, w):
        return self.l1 * torch.sum(torch.abs(w))


@serde.register
@dataclasses.dataclass
class WeightDecay(Regularization):
    coeff: float = 0.0
    apply_lr: bool = True

    def apply_after_updater(self, update, w, lr):
        scale = lr if self.apply_lr else 1.0
        return update + self.coeff * scale * w
