"""Loss function configs.

Reference: ``org.nd4j.linalg.lossfunctions.impl.*``. The serving slice needs
the output layer's loss only as configuration, so this module carries the
JAX package's ``LossMCXENT`` dataclass and tag; scoring lands with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from deeplearning4j_tpu_torch import serde


@dataclasses.dataclass
class ILossFunction:
    """Base loss contract. ``weights``: optional per-output weighting."""


@serde.register
@dataclasses.dataclass
class LossMCXENT(ILossFunction):
    """Multi-class cross entropy (reference LossMCXENT)."""

    weights: Optional[Sequence[float]] = None
    clip_eps: float = 1e-10
