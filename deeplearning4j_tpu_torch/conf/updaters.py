"""Gradient updater configs (optimizers).

Reference: ``org.nd4j.linalg.learning.config.*``. The serving slice of the
port needs these only so that a model configuration deserializes: the
dataclasses and their ``@type`` tags are the JAX package's, and the update
math lands with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.schedules import ISchedule


@dataclasses.dataclass
class IUpdater:
    """Base updater contract (reference: ``IUpdater`` interface)."""


@serde.register
@dataclasses.dataclass
class Sgd(IUpdater):
    learning_rate: float = 0.1
    lr_schedule: Optional[ISchedule] = None


@serde.register
@dataclasses.dataclass
class Adam(IUpdater):
    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    lr_schedule: Optional[ISchedule] = None


@serde.register
@dataclasses.dataclass
class Nesterovs(IUpdater):
    learning_rate: float = 0.1
    momentum: float = 0.9
    lr_schedule: Optional[ISchedule] = None
    momentum_schedule: Optional[ISchedule] = None
