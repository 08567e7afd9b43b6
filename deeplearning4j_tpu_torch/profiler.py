"""Profiling / numerics debugging.

Reference: ``org.nd4j.linalg.profiler.OpProfiler`` +
``ProfilerConfig.builder()`` enabled through
``Nd4j.getExecutioner().setProfilingConfig(...)``: per-op timing and
NAN_PANIC / INF_PANIC checks around every op.

Counterpart of the JAX package's ``profiler.py``:

1. ``check_for_nan`` / ``check_for_inf`` (the JAX package's
   ``jax_debug_nans`` / ``jax_debug_infs``) turn on
   ``torch.autograd.set_detect_anomaly`` — a backward function that
   returns NaN raises, naming it, with the forward's traceback — and a
   finite check of the loss after every training step of either network
   or of ``ParallelWrapper`` (:func:`check_step`), which raises
   ``FloatingPointError``. The check reads the loss on the host, so each
   step then waits for the card.
2. Step-level timing through :class:`ProfilerListener`.
3. Device traces through ``start_trace`` / ``stop_trace`` / ``trace``
   (``torch.profiler``, CPU and CUDA activities), written as a Chrome
   trace (``trace.json``) into the trace directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


@dataclasses.dataclass
class ProfilerConfig:
    """Reference ``ProfilerConfig`` surface (the flags that translate)."""

    check_for_nan: bool = False
    check_for_inf: bool = False
    collect_step_stats: bool = True


# the panic flags the training steps read (one attribute check a step)
_PANIC = {"nan": False, "inf": False}


def panic_enabled() -> bool:
    return _PANIC["nan"] or _PANIC["inf"]


def check_step(loss, path: str = "", iteration: Optional[int] = None):
    """NAN_PANIC / INF_PANIC after one training step: raises
    ``FloatingPointError`` when the step's loss is NaN (``check_for_nan``)
    or infinite (``check_for_inf``)."""
    if not panic_enabled():
        return
    v = float(loss)
    where = f" on path {path!r}" if path else ""
    at = f" at iteration {iteration}" if iteration is not None else ""
    if _PANIC["nan"] and math.isnan(v):
        raise FloatingPointError(f"NaN loss{where}{at} (NAN_PANIC)")
    if _PANIC["inf"] and math.isinf(v):
        raise FloatingPointError(f"infinite loss{where}{at} (INF_PANIC)")


class OpProfiler:
    """Process-wide profiler (reference singleton
    ``OpProfiler.getInstance()``)."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self):
        self.config = ProfilerConfig(False, False, False)
        self._trace_dir: Optional[str] = None
        self._prof = None

    @classmethod
    def get_instance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = OpProfiler()
        return cls._instance

    # -- reference: Nd4j.getExecutioner().setProfilingConfig(cfg) ------------
    def set_config(self, config: ProfilerConfig) -> "OpProfiler":
        self.config = config
        _PANIC["nan"] = bool(config.check_for_nan)
        _PANIC["inf"] = bool(config.check_for_inf)
        torch.autograd.set_detect_anomaly(bool(config.check_for_nan))
        return self

    def reset(self) -> "OpProfiler":
        return self.set_config(ProfilerConfig(False, False, False))

    # -- device traces ---------------------------------------------------------
    def start_trace(self, log_dir: str) -> "OpProfiler":
        """Begin a ``torch.profiler`` trace (CPU, and CUDA where there is a
        card) that :meth:`stop_trace` writes into ``log_dir`` (created if
        missing). Starting while a trace is active stops that one first."""
        from torch.profiler import ProfilerActivity, profile

        if self._trace_dir is not None:
            self.stop_trace()
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._trace_dir = log_dir
        return self

    def stop_trace(self) -> Optional[str]:
        """End the active trace, write ``trace.json`` (Chrome trace format)
        into its directory and return the directory. A second stop (or a
        stop with no trace running) is a no-op returning None."""
        if self._trace_dir is None:
            return None
        d, self._trace_dir = self._trace_dir, None
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        return d

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """Context-manager form: ``with OpProfiler.get_instance().trace(d):``
        brackets the traced region; the trace stops on exit even when the
        body raises."""
        self.start_trace(log_dir)
        try:
            yield log_dir
        finally:
            self.stop_trace()


class ProfilerListener(TrainingListener):
    """Step-level timing aggregation (the analogue of the reference's
    per-op-class totals printed by ``OpProfiler#printOutDashboard``). The
    host clock between listener calls: with the card's work queued
    asynchronously, a step's time shows once the queue is full."""

    def __init__(self, warmup_iterations: int = 1):
        self.warmup = int(warmup_iterations)
        self._last: Optional[float] = None
        self.step_times: List[float] = []
        self._seen = 0

    def iteration_done(self, model, iteration, epoch, score):
        now = time.monotonic()
        self._seen += 1
        if self._last is not None and self._seen > self.warmup:
            dt = now - self._last
            self.step_times.append(dt)
            # the registry's step histogram: /metrics serves the same
            from deeplearning4j_tpu_torch import telemetry

            telemetry.record_step_seconds(dt, path="profiler")
        self._last = now

    # -- reporting ------------------------------------------------------------
    def mean_step_seconds(self) -> float:
        return (sum(self.step_times) / len(self.step_times)
                if self.step_times else float("nan"))

    def total_seconds(self) -> float:
        return sum(self.step_times)

    def summary(self) -> str:
        if not self.step_times:
            return "ProfilerListener: no steps recorded"
        ts = sorted(self.step_times)
        p50 = ts[len(ts) // 2]
        p95 = ts[min(len(ts) - 1, int(len(ts) * 0.95))]
        return (f"steps={len(ts)} mean={self.mean_step_seconds()*1e3:.2f}ms "
                f"p50={p50*1e3:.2f}ms p95={p95*1e3:.2f}ms "
                f"total={self.total_seconds():.3f}s")
