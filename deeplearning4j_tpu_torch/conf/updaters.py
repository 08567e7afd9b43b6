"""Gradient updaters (optimizers).

Reference: ``org.nd4j.linalg.learning.config.*`` and the matching
``GradientUpdater#applyUpdater``; counterpart of the JAX package's
``conf/updaters.py`` (same ``@type`` tags and fields). An updater turns the
raw gradient into the *update* and the solver then does
``params -= update``: ``update_leaf(g, state, lr, t)`` is a per-tensor
transform with ``t`` the 0-based iteration, and ``init_state(param)`` the
per-tensor state (Adam's ``m``/``v``, Nesterovs' ``v``). All eleven of the
JAX package's updaters: Sgd, NoOp, Adam, AdamW, AMSGrad, AdaMax, Nadam,
Nesterovs, AdaGrad, AdaDelta and RmsProp, each body the JAX package's
(epsilon outside the square root, the bias corrections where it puts them;
NoOp and AdaDelta take no learning rate).
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
class NoOp(IUpdater):
    """The gradient passed through untouched (frozen layers, tests)."""

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        return g, state

    def current_lr(self, iteration, epoch) -> float:
        return 1.0


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
class AdamW(Adam):
    """Adam with decoupled weight decay (reference ``AdamW``): the Adam
    update plus ``weight_decay * lr * param``, not fed through the
    moments."""

    weight_decay: float = 0.01

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        upd, new_state = super().update_leaf(g, state, lr, t, epoch, param)
        if param is not None and self.weight_decay:
            upd = upd + self.weight_decay * lr * param
        return upd, new_state


@serde.register
@dataclasses.dataclass
class AMSGrad(IUpdater):
    """Adam on the running maximum ``vhat`` of the second moment."""

    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    lr_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "vhat": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * g
        v = self.beta2 * state["v"] + (1.0 - self.beta2) * g * g
        vhat = torch.maximum(state["vhat"], v)
        tt = t + 1.0
        alpha = (lr * math.sqrt(1.0 - self.beta2 ** tt)
                 / (1.0 - self.beta1 ** tt))
        return (alpha * m / (torch.sqrt(vhat) + self.epsilon),
                {"m": m, "v": v, "vhat": vhat})


@serde.register
@dataclasses.dataclass
class AdaMax(IUpdater):
    """Adam with the infinity norm ``u = max(beta2 * u, |g|)``."""

    learning_rate: float = 0.002
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    lr_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * g
        u = torch.maximum(self.beta2 * state["u"], torch.abs(g))
        alpha = lr / (1.0 - self.beta1 ** (t + 1.0))
        return alpha * m / (u + self.epsilon), {"m": m, "u": u}


@serde.register
@dataclasses.dataclass
class Nadam(IUpdater):
    """Adam with Nesterov momentum: ``m`` corrected by ``beta1^(t+2)``
    (one step ahead), the gradient by ``beta1^(t+1)``."""

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
        mhat = m / (1.0 - self.beta1 ** (tt + 1.0))
        ghat = g / (1.0 - self.beta1 ** tt)
        vhat = v / (1.0 - self.beta2 ** tt)
        mbar = self.beta1 * mhat + (1.0 - self.beta1) * ghat
        return lr * mbar / (torch.sqrt(vhat) + self.epsilon), {"m": m, "v": v}


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


@serde.register
@dataclasses.dataclass
class AdaGrad(IUpdater):
    learning_rate: float = 0.01
    epsilon: float = 1e-6
    lr_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"h": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        h = state["h"] + g * g
        return lr * g / (torch.sqrt(h) + self.epsilon), {"h": h}


@serde.register
@dataclasses.dataclass
class AdaDelta(IUpdater):
    """No learning rate: the step is ``sqrt(msdx + eps) / sqrt(msg + eps)``
    times the gradient."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, param):
        return {"msg": torch.zeros_like(param),
                "msdx": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        msg = self.rho * state["msg"] + (1.0 - self.rho) * g * g
        dx = (torch.sqrt(state["msdx"] + self.epsilon)
              / torch.sqrt(msg + self.epsilon)) * g
        msdx = self.rho * state["msdx"] + (1.0 - self.rho) * dx * dx
        return dx, {"msg": msg, "msdx": msdx}

    def current_lr(self, iteration, epoch) -> float:
        return 1.0


@serde.register
@dataclasses.dataclass
class RmsProp(IUpdater):
    learning_rate: float = 0.001
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    lr_schedule: Optional[ISchedule] = None

    def init_state(self, param):
        return {"g2": torch.zeros_like(param)}

    def update_leaf(self, g, state, lr, t, epoch=0.0, param=None):
        g2 = self.rms_decay * state["g2"] + (1.0 - self.rms_decay) * g * g
        return lr * g / (torch.sqrt(g2) + self.epsilon), {"g2": g2}
