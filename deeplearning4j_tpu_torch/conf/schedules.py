"""Learning-rate / momentum schedule configs.

Reference: ``org.nd4j.linalg.schedule.ISchedule`` and its implementations.
The serving slice carries the dataclasses and ``@type`` tags of the JAX
package so that updater configs deserialize; ``value_at`` lands with the
training slice.
"""

from __future__ import annotations

import dataclasses
import enum

from deeplearning4j_tpu_torch import serde


@serde.register_enum
class ScheduleType(enum.Enum):
    """Reference: ``org.nd4j.linalg.schedule.ScheduleType``."""

    ITERATION = "iteration"
    EPOCH = "epoch"


@dataclasses.dataclass
class ISchedule:
    """Base schedule contract: ``value_at(iteration, epoch) -> scalar``."""


@serde.register
@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value: float = 0.001


@serde.register
@dataclasses.dataclass
class StepSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    decay_rate: float = 0.5
    step: float = 1000.0


@serde.register
@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = 0.99


@serde.register
@dataclasses.dataclass
class InverseSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = 0.01
    power: float = 1.0


@serde.register
@dataclasses.dataclass
class PolySchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    power: float = 2.0
    max_iter: int = 10000


@serde.register
@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = -0.1
    step_size: int = 1000


@serde.register
@dataclasses.dataclass
class MapSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    values: dict = dataclasses.field(default_factory=lambda: {"0": 0.001})

    def __post_init__(self):
        # int keys (the reference's Map<Integer,Double>) become strings so
        # the JSON round-trip is the identity, as in the JAX package
        self.values = {str(k): float(v) for k, v in self.values.items()}


@serde.register
@dataclasses.dataclass
class CycleSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    div_factor: float = 25.0
    cycle_length: int = 1000
    annealing_length: int = 100
    annealing_decay: float = 0.1


@serde.register
@dataclasses.dataclass
class WarmupSchedule(ISchedule):
    warmup_steps: int = 100
    inner: ISchedule = dataclasses.field(default_factory=FixedSchedule)
