"""Training listeners.

Reference: ``org.deeplearning4j.optimize.api.TrainingListener`` and the
impls in ``org.deeplearning4j.optimize.listeners``; copied from the JAX
package's ``optimize/listeners.py``: score printing and collection, the
performance and ETA listeners, periodic evaluation and the health
monitor's reports. ``score`` is the
step's loss (a 0-dim tensor, on the device until a listener reads it with
``float(score)``).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional


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


class PerformanceListener(TrainingListener):
    """Batches/sec + examples/sec (reference ``PerformanceListener``). The
    timing window resets at every epoch start, so a listener kept across
    ``fit`` calls never averages the idle time between them into its
    rate. The rate is host wall clock between listener calls: the step it
    reports has been launched, not necessarily finished, on the card."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 stream=None):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self.stream = stream or sys.stdout
        self._last_time = None
        self._last_iter = None
        self.last_batches_per_sec: Optional[float] = None
        self.last_examples_per_sec: Optional[float] = None

    def on_epoch_start(self, model, epoch):
        self._last_time = None
        self._last_iter = None

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            iters = iteration - self._last_iter
            dt = now - self._last_time
            if dt > 0 and iters > 0:
                bps = iters / dt
                self.last_batches_per_sec = bps
                batch = getattr(model, "last_batch_size", None)
                msg = f"batches/sec: {bps:.2f}"
                if batch and self.report_batch:
                    self.last_examples_per_sec = bps * batch
                    msg += f", examples/sec: {self.last_examples_per_sec:.2f}"
                print(msg, file=self.stream)
            self._last_time = now
            self._last_iter = iteration
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration


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


class TimeIterationListener(TrainingListener):
    """ETA printout (reference ``TimeIterationListener``)."""

    def __init__(self, total_iterations: int, frequency: int = 50,
                 stream=None):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.stream = stream or sys.stdout
        self._start = None

    def iteration_done(self, model, iteration, epoch, score):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            remaining = (self.total - iteration) * elapsed / iteration
            print(f"Remaining time estimate: {remaining:.1f}s "
                  f"(iteration {iteration}/{self.total})", file=self.stream)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation during fit (reference ``EvaluativeListener``):
    every ``frequency`` epochs (``unit="epoch"``) or iterations
    (``unit="iteration"``), ``model.evaluate(iterator)``."""

    def __init__(self, iterator, frequency: int = 1,
                 unit: str = "epoch",
                 evaluation_factory: Optional[Callable] = None,
                 stream=None):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.unit = unit
        self.evaluation_factory = evaluation_factory
        self.stream = stream or sys.stdout
        self.last_evaluation = None

    def _run(self, model):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        factory = self.evaluation_factory or Evaluation
        self.last_evaluation = model.evaluate(self.iterator,
                                              evaluation=factory())
        acc = getattr(self.last_evaluation, "accuracy", None)
        if callable(acc):
            print(f"[EvaluativeListener] accuracy: {acc():.4f}",
                  file=self.stream)

    def iteration_done(self, model, iteration, epoch, score):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._run(model)

    def on_epoch_end(self, model, epoch):
        if self.unit == "epoch" and (epoch + 1) % self.frequency == 0:
            self._run(model)


class AotCacheStatsListener(TrainingListener):
    """Report the envelope cache (``optimize.aot_cache``) every N
    iterations: hits / misses / envelopes / the misses' cumulative
    seconds. PyTorch compiles nothing, so a miss is a first forward at a
    new envelope (shape, dtype, route); one after warmup means shape
    drift that would otherwise only show up as an unexplained step-time
    spike. ``history`` keeps the per-collection snapshots for
    programmatic checks (tests, dashboards). Counterpart of the JAX
    package's listener of the same name, whose cache holds compiled
    executables."""

    def __init__(self, frequency: int = 10, stream=None,
                 print_stats: bool = True):
        self.frequency = max(1, int(frequency))
        self.stream = stream or sys.stdout
        self.print_stats = bool(print_stats)
        self.history: List[dict] = []
        self._last = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        from deeplearning4j_tpu_torch.optimize import aot_cache

        snap = aot_cache.stats()
        snap["iteration"] = int(iteration)
        self.history.append(snap)
        if self.print_stats:
            delta_miss = (snap["misses"] - self._last["misses"]
                          if self._last else snap["misses"])
            msg = (f"[aot-cache] iter {iteration}: {snap['hits']} hits, "
                   f"{snap['misses']} misses ({snap['entries']} "
                   f"envelopes, {snap['compile_seconds']:.2f}s first "
                   f"forwards)")
            if self._last and delta_miss:
                msg += f" — {delta_miss} NEW envelope(s) since last report"
            print(msg, file=self.stream)
        self._last = snap


class HealthListener(TrainingListener):
    """The training-health monitor (``telemetry.health``) through the
    listener SPI: every N iterations, flush the monitor's queued guard
    vectors (one transfer) and report its counts and the latest gradient
    norm and update:param ratio. A line prints only when something changed
    (``print_all=True``: at every collection); ``history`` keeps the
    reports."""

    def __init__(self, frequency: int = 10, stream=None,
                 print_all: bool = False):
        self.frequency = max(1, int(frequency))
        self.stream = stream or sys.stdout
        self.print_all = bool(print_all)
        self.history: List[dict] = []
        self._last_nonfinite = 0

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        from deeplearning4j_tpu_torch.telemetry import health

        rep = health.report()
        rep["iteration"] = int(iteration)
        self.history.append(rep)
        new_bad = rep["nonfinite_steps"] - self._last_nonfinite
        self._last_nonfinite = rep["nonfinite_steps"]
        if new_bad or self.print_all:
            last = rep.get("last") or {}
            msg = (f"[health] iter {iteration}: status={rep['status']}, "
                   f"{rep['nonfinite_steps']} non-finite step(s)")
            if rep["skipped_steps"]:
                msg += f", {rep['skipped_steps']} skipped"
            if rep["rollbacks"]:
                msg += f", {rep['rollbacks']} rollback(s)"
            if last:
                msg += (f", grad_norm={last['grad_norm']:.4g}, "
                        f"update:param={last['update_param_ratio']:.3g}")
            print(msg, file=self.stream)
