"""Gradient updaters (optimizers).

Reference: ``org.nd4j.linalg.learning.config.*`` and the matching
``GradientUpdater#applyUpdater``; counterpart of the JAX package's
``conf/updaters.py`` (same ``@type`` tags and fields). An updater turns the
raw gradient into the *update* and the solver then does
``params -= update``: ``update_leaf(g, state, lr, t)`` is a per-tensor
transform with ``t`` the 0-based iteration, and ``init_state(param)`` the
per-tensor state (Adam's ``m``/``v``, Nesterovs' ``v``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.schedules import ISchedule


@dataclasses.dataclass
class IUpdater:
    """Base updater contract (reference: ``IUpdater`` interface)."""

    def init_state(self, param) -> dict:
        """This updater's state for one parameter tensor."""
        return {}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        """(gradient, state, lr, iteration) -> (update, new_state)."""
        raise NotImplementedError

    def current_lr(self, iteration, epoch) -> float:
        sched: Optional[ISchedule] = getattr(self, "lr_schedule", None)
        if sched is not None:
            return sched.value_at(iteration, epoch)
        return float(getattr(self, "learning_rate", 0.0))


@serde.register
@dataclasses.dataclass
class Sgd(IUpdater):
    learning_rate: float = 0.1
    lr_schedule: Optional[ISchedule] = None

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        return lr * g, state


@serde.register
@dataclasses.dataclass
class Adam(IUpdater):
    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    lr_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * g
        v = self.beta2 * state["v"] + (1.0 - self.beta2) * g * g
        tt = t + 1.0
        alpha = lr * math.sqrt(1.0 - self.beta2 ** tt) / (1.0 - self.beta1 ** tt)
        return alpha * m / (torch.sqrt(v) + self.epsilon), {"m": m, "v": v}


@serde.register
@dataclasses.dataclass
class Nesterovs(IUpdater):
    learning_rate: float = 0.1
    momentum: float = 0.9
    lr_schedule: Optional[ISchedule] = None
    momentum_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def current_momentum(self, iteration, epoch) -> float:
        if self.momentum_schedule is not None:
            return self.momentum_schedule.value_at(iteration, epoch)
        return float(self.momentum)

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        # Reference NesterovsUpdater: vPrev = v; v = mu*v - lr*g;
        # update = -(-mu*vPrev + (1+mu)*v); the solver does params -= update
        mu = self.current_momentum(t, epoch)
        v_prev = state["v"]
        v = mu * v_prev - lr * g
        return -(-mu * v_prev + (1.0 + mu) * v), {"v": v}
