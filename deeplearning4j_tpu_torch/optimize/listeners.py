"""Training listeners.

Reference: ``org.deeplearning4j.optimize.api.TrainingListener`` and the
impls in ``org.deeplearning4j.optimize.listeners``; copied from the JAX
package's ``optimize/listeners.py``. ``score`` is the step's loss (a
0-dim tensor; ``float(score)`` reads it).
"""

from __future__ import annotations

import sys
from typing import List


class TrainingListener:
    """SPI (reference ``TrainingListener``)."""

    def iteration_done(self, model, iteration: int, epoch: int,
                       score) -> None:
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Print score every N iterations (reference ``ScoreIterationListener``)."""

    def __init__(self, print_iterations: int = 10, stream=None):
        self.print_iterations = max(1, print_iterations)
        self.stream = stream or sys.stdout

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            print(f"Score at iteration {iteration} is {float(score)}",
                  file=self.stream)


class CollectScoresListener(TrainingListener):
    """Accumulate (iteration, score) pairs (reference
    ``CollectScoresListener``)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.iterations: List[int] = []
        self.scores: List[float] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.iterations.append(iteration)
            self.scores.append(float(score))
