"""Early stopping.

Reference: ``org.deeplearning4j.earlystopping``; counterpart of the JAX
package's ``earlystopping/__init__.py``: ``EarlyStoppingConfiguration``
(epoch and iteration termination conditions, a score calculator and a
model saver), ``EarlyStoppingTrainer.fit`` over a MultiLayerNetwork or a
ComputationGraph returning an ``EarlyStoppingResult`` with the best model,
the savers (``InMemoryModelSaver``, ``LocalFileModelSaver``) and
``DivergenceTerminationCondition`` on the health monitor
(``telemetry.health``).

The score conditions end a run on a non-finite score explicitly
(``last_reason`` says why) instead of counting it as an epoch without
improvement. The trainer steps with ``fit_batch``, which reads each
step's loss on the host, as the JAX trainer does. A saved best model is
rebuilt on the device of the network it was saved from.
"""

from __future__ import annotations

import copy
import enum
import os
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.util import serializer


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------

class EpochTerminationCondition:
    """Checked after each epoch (reference interface of the same name)."""

    def initialize(self) -> None:
        """Reset at the start of each fit."""

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``max_epochs_without_improvement`` epochs whose score
    did not drop by more than ``min_improvement``; a non-finite score
    stops at once, with its reason."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self._best = float("inf")
        self._bad = 0
        self.last_reason: Optional[str] = None

    def initialize(self):
        self._best = float("inf")
        self._bad = 0
        self.last_reason = None

    def terminate(self, epoch, score):
        if not np.isfinite(score):
            self.last_reason = f"non-finite score {score} at epoch {epoch}"
            return True
        if score < self._best - self.min_improvement:
            self._best = score
            self._bad = 0
            return False
        self._bad += 1
        if self._bad > self.patience:
            self.last_reason = (f"no improvement in {self._bad} epochs "
                                f"(best {self._best})")
            return True
        return False


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at or below a target; a non-finite score
    stops at once, with its reason."""

    def __init__(self, best_expected_score: float):
        self.target = float(best_expected_score)
        self.last_reason: Optional[str] = None

    def initialize(self):
        self.last_reason = None

    def terminate(self, epoch, score):
        if not np.isfinite(score):
            self.last_reason = f"non-finite score {score} at epoch {epoch}"
            return True
        if score <= self.target:
            self.last_reason = f"score {score} reached target {self.target}"
            return True
        return False


class IterationTerminationCondition:
    """Checked after each iteration (minibatch)."""

    def initialize(self) -> None:
        """Reset at the start of each fit."""

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = None

    def terminate(self, score):
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on an exploding loss."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return not np.isfinite(score)


class DivergenceTerminationCondition(IterationTerminationCondition):
    """Stop when the run diverges: a non-finite iteration score, or
    non-finite steps the health monitor (``telemetry.health``) counted
    since this fit started, so a guard that tripped while the score still
    looked finite ends the run too. Each check flushes the monitor's
    queue (one transfer)."""

    def __init__(self):
        self._baseline = 0
        self.last_reason: Optional[str] = None

    def initialize(self):
        from deeplearning4j_tpu_torch.telemetry import health

        m = health.monitor()
        m.flush()
        self._baseline = m.nonfinite_steps
        self.last_reason = None

    def terminate(self, score):
        if not np.isfinite(score):
            self.last_reason = f"non-finite score {score}"
            return True
        from deeplearning4j_tpu_torch.telemetry import health

        m = health.monitor()
        m.flush()
        if m.nonfinite_steps > self._baseline:
            self.last_reason = (
                f"{m.nonfinite_steps - self._baseline} non-finite step(s) "
                f"observed by the health monitor (policy {m.policy.value})")
            return True
        return False


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------

class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """The loss over a validation iterator, averaged over its examples
    (``average``) or summed (reference class)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model):
        total, n = 0.0, 0
        for ds in self.iterator:
            total += float(model.score(ds)) * ds.num_examples()
            n += ds.num_examples()
        self.iterator.reset()
        if n == 0:
            return float("nan")
        return total / n if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """The NEGATIVE accuracy (or another ``Evaluation`` metric), so lower
    is better, as the trainer minimizes (reference
    ``ClassificationScoreCalculator``)."""

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, model):
        ev = model.evaluate(self.iterator)
        self.iterator.reset()
        return -float(getattr(ev, self.metric)())


# ---------------------------------------------------------------------------
# model savers
# ---------------------------------------------------------------------------

class ModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    """The best model's configuration, params and state as host copies."""

    def __init__(self):
        self._best = None

    def save_best_model(self, model, score):
        from deeplearning4j_tpu_torch.optimize.checkpoint import _host_copy

        self._best = (copy.deepcopy(model.conf), _host_copy(model.params),
                      _host_copy(model.state), type(model), model.device)

    def get_best_model(self):
        if self._best is None:
            return None
        conf, params, state, cls, device = self._best
        return cls(conf, device).set_params(params, state)


class LocalFileModelSaver(ModelSaver):
    """``<directory>/bestModel.zip`` (the ModelSerializer zip, updater
    state included)."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._path = os.path.join(self.directory, "bestModel.zip")
        self._device = "cuda"

    def save_best_model(self, model, score):
        serializer.write_model(model, self._path, save_updater=True)
        self._device = model.device

    def get_best_model(self):
        if not os.path.exists(self._path):
            return None
        return serializer.restore_model(self._path, device=self._device)


# ---------------------------------------------------------------------------
# configuration, trainer, result
# ---------------------------------------------------------------------------

class EarlyStoppingConfiguration:
    """Reference ``EarlyStoppingConfiguration.Builder`` (keyword
    arguments for the builder chain)."""

    def __init__(self,
                 epoch_termination_conditions: Optional[List] = None,
                 iteration_termination_conditions: Optional[List] = None,
                 score_calculator: Optional[ScoreCalculator] = None,
                 model_saver: Optional[ModelSaver] = None,
                 evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False):
        self.epoch_conditions = list(epoch_termination_conditions or [])
        self.iteration_conditions = list(
            iteration_termination_conditions or [])
        self.score_calculator = score_calculator
        self.model_saver = model_saver or InMemoryModelSaver()
        self.evaluate_every_n_epochs = int(evaluate_every_n_epochs)
        self.save_last_model = save_last_model


class TerminationReason(enum.Enum):
    EPOCH = "EpochTerminationCondition"
    ITERATION = "IterationTerminationCondition"
    ERROR = "Error"


class EarlyStoppingResult:
    """Reference ``EarlyStoppingResult``."""

    def __init__(self, termination_reason, termination_details,
                 score_vs_epoch, best_model_epoch, best_model_score,
                 total_epochs, best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model


class EarlyStoppingTrainer:
    """Reference ``EarlyStoppingTrainer`` over a MultiLayerNetwork or a
    ComputationGraph."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iter):
        self.config = config
        self.net = net
        self.train_iter = train_iter

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        if not cfg.epoch_conditions and not cfg.iteration_conditions:
            raise ValueError(
                "EarlyStoppingConfiguration needs at least one termination "
                "condition (e.g. MaxEpochsTerminationCondition) or fit() "
                "would never return")
        for cond in cfg.epoch_conditions + cfg.iteration_conditions:
            cond.initialize()
        if self.net.params is None:
            self.net.init()
        best_score, best_epoch = float("inf"), -1
        scores = {}
        epoch = 0
        reason, details = TerminationReason.EPOCH, "max epochs"
        stop = False
        while not stop:
            for ds in self.train_iter:
                score = self.net.fit_batch(ds)
                for cond in cfg.iteration_conditions:
                    if cond.terminate(score):
                        details = f"{type(cond).__name__} at score {score}"
                        why = getattr(cond, "last_reason", None)
                        if why:
                            details += f" ({why})"
                        reason = TerminationReason.ITERATION
                        stop = True
                        break
                if stop:
                    break
            self.train_iter.reset()
            if stop:
                break

            if epoch % cfg.evaluate_every_n_epochs == 0:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(self.net)
                else:
                    score = self.net.score()
                scores[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)

            evaluated = epoch in scores
            for cond in cfg.epoch_conditions:
                # score conditions fire only on evaluated epochs;
                # MaxEpochs fires regardless (reference behavior)
                if not evaluated and not isinstance(
                        cond, MaxEpochsTerminationCondition):
                    continue
                if cond.terminate(epoch, scores.get(epoch, best_score)):
                    details = type(cond).__name__
                    why = getattr(cond, "last_reason", None)
                    if why:
                        details += f" ({why})"
                    reason = TerminationReason.EPOCH
                    stop = True
                    break
            epoch += 1

        best = cfg.model_saver.get_best_model()
        if best is None:
            best = self.net
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch,
            best_model=best)
