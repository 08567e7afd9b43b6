"""Learning-rate / momentum schedule configs.

Reference: ``org.nd4j.linalg.schedule.ISchedule`` and its implementations;
counterpart of the JAX package's ``conf/schedules.py`` (same ``@type`` tags
and fields). ``value_at(iteration, epoch)`` is a plain function of the
host's step counters and returns a Python float.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from deeplearning4j_tpu_torch import serde


@serde.register_enum
class ScheduleType(enum.Enum):
    """Reference: ``org.nd4j.linalg.schedule.ScheduleType``."""

    ITERATION = "iteration"
    EPOCH = "epoch"


@dataclasses.dataclass
class ISchedule:
    """Base schedule contract: ``value_at(iteration, epoch) -> float``."""

    def value_at(self, iteration, epoch) -> float:
        raise NotImplementedError

    def _t(self, iteration, epoch) -> float:
        st = getattr(self, "schedule_type", ScheduleType.ITERATION)
        return float(epoch if st is ScheduleType.EPOCH else iteration)


@serde.register
@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value: float = 0.001

    def value_at(self, iteration, epoch):
        return float(self.value)


@serde.register
@dataclasses.dataclass
class StepSchedule(ISchedule):
    """value * decayRate^floor(t/step)."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    decay_rate: float = 0.5
    step: float = 1000.0

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value * self.decay_rate ** math.floor(t / self.step)


@serde.register
@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    """value * gamma^t."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = 0.99

    def value_at(self, iteration, epoch):
        return self.initial_value * self.gamma ** self._t(iteration, epoch)


@serde.register
@dataclasses.dataclass
class InverseSchedule(ISchedule):
    """value / (1 + gamma*t)^power."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = 0.01
    power: float = 1.0

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value / (1.0 + self.gamma * t) ** self.power


@serde.register
@dataclasses.dataclass
class PolySchedule(ISchedule):
    """value * (1 - t/maxIter)^power, clamped at 0 past maxIter."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    power: float = 2.0
    max_iter: int = 10000

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        frac = min(max(1.0 - t / float(self.max_iter), 0.0), 1.0)
        return self.initial_value * frac ** self.power


@serde.register
@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    """initialValue / (1 + exp(-gamma * (t - stepSize))): a smooth step
    down at stepSize for negative gamma."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    gamma: float = -0.1
    step_size: int = 1000

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value / (
            1.0 + math.exp(-self.gamma * (t - self.step_size)))


@serde.register
@dataclasses.dataclass
class MapSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    values: dict = dataclasses.field(default_factory=lambda: {"0": 0.001})

    def __post_init__(self):
        # int keys (the reference's Map<Integer,Double>) become strings so
        # the JSON round-trip is the identity, as in the JAX package
        self.values = {str(k): float(v) for k, v in self.values.items()}

    def value_at(self, iteration, epoch):
        """Piecewise constant: the value of the last key <= t."""
        t = self._t(iteration, epoch)
        pts = sorted((int(k), v) for k, v in self.values.items())
        out = pts[0][1]
        for start, val in pts[1:]:
            if t >= start:
                out = val
        return out


@serde.register
@dataclasses.dataclass
class CycleSchedule(ISchedule):
    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 0.001
    div_factor: float = 25.0
    cycle_length: int = 1000
    annealing_length: int = 100
    annealing_decay: float = 0.1

    def value_at(self, iteration, epoch):
        """1cycle: up from initial/div to initial over half the cycle, back
        down, then an annealing tail."""
        t = self._t(iteration, epoch)
        lo = self.initial_value / self.div_factor
        half = (self.cycle_length - self.annealing_length) / 2.0
        if t >= self.cycle_length - self.annealing_length:
            anneal_t = t - (self.cycle_length - self.annealing_length)
            v = lo * (self.annealing_decay + (1.0 - self.annealing_decay) * (
                1.0 - anneal_t / max(float(self.annealing_length), 1.0)))
        elif t < half:
            v = lo + (self.initial_value - lo) * (t / max(half, 1.0))
        else:
            v = self.initial_value - (self.initial_value - lo) * (
                (t - half) / max(half, 1.0))
        return max(v, 0.0)


@serde.register
@dataclasses.dataclass
class WarmupSchedule(ISchedule):
    """Linear warmup to the inner schedule's first value, then the inner
    schedule shifted by the warmup."""

    warmup_steps: int = 100
    inner: ISchedule = dataclasses.field(default_factory=FixedSchedule)

    def value_at(self, iteration, epoch):
        t = float(iteration)
        if t < self.warmup_steps:
            peak = self.inner.value_at(0, 0)
            return peak * (t + 1.0) / float(max(self.warmup_steps, 1))
        return self.inner.value_at(iteration - self.warmup_steps, epoch)
