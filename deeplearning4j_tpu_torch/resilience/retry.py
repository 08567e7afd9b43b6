"""Retry / timeout / backoff engine.

A copy of the JAX package's ``resilience/retry.py``: one policy object
(max attempts, exponential backoff with deterministic jitter,
retryable-exception classes, deadline awareness) applied at an edge that
can fail transiently: the serving dispatch and checkpoint writes.

Deterministic jitter: the k-th attempt's backoff is a pure function of
``(seed, name, k)`` — a chaos run replays with identical sleep points,
which is what lets the fault-plan suite assert exact recovery
sequences. Deadline awareness: ``call(..., deadline=t)`` never sleeps
past ``t`` (monotonic), so a retried operation composes with the
serving batcher's per-request deadlines instead of silently exceeding
them.

Every retry (not first attempts) counts into
``dl4j_retries_total{op=...}``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from deeplearning4j_tpu_torch.resilience.faults import InjectedFault

#: Default transient set: filesystem/network hiccups plus injected
#: faults (so a chaos plan's transient errors exercise the same path a
#: real ENOSPC/EINTR would).
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    OSError, ConnectionError, TimeoutError, InjectedFault)


class RetryPolicy:
    """``call(fn)`` with bounded, deterministic retries.

    Args:
        max_attempts: total tries (1 = no retry).
        base_delay_s / multiplier / max_delay_s: exponential backoff —
            attempt k sleeps ``min(base * multiplier**(k-1), max)``
            before jitter.
        jitter: +/- fraction of the backoff (0 disables; 0.5 means the
            sleep lands in [0.5d, 1.5d]), drawn deterministically from
            ``(seed, name, attempt)``.
        retryable: exception classes worth retrying; anything else
            propagates immediately.
        seed: jitter stream seed.
        name: default ``op`` label for the retry counter.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 retryable: Tuple[Type[BaseException], ...] =
                 DEFAULT_RETRYABLE,
                 seed: int = 0, name: str = "default"):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self.seed = int(seed)
        self.name = name

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt+1`` (``attempt`` is the 1-based
        try that just failed). Pure function of (seed, name, attempt)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if self.jitter:
            r = random.Random(f"{self.seed}:{self.name}:{attempt}").random()
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return max(d, 0.0)

    def call(self, fn: Callable, *args,
             deadline: Optional[float] = None,
             op: Optional[str] = None,
             on_retry: Optional[Callable] = None,
             sleep: Callable[[float], None] = time.sleep, **kw):
        """Run ``fn(*args, **kw)``; retry retryable failures up to
        ``max_attempts`` total tries. ``deadline`` is a
        ``time.monotonic()`` instant: when the next backoff would land
        past it, the last error propagates instead (the caller's
        deadline outranks the retry budget). ``on_retry(attempt, exc,
        delay)`` observes each scheduled retry."""
        op = op or self.name
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kw)
            except self.retryable as e:
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(attempt)
                if deadline is not None \
                        and time.monotonic() + delay > deadline:
                    raise
                from deeplearning4j_tpu_torch import telemetry

                telemetry.record_retry(op)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)


#: Checkpoint writes (``optimize.checkpoint.CheckpointListener``): a short
#: wait, since a transient local-disk failure clears in milliseconds or is
#: permanent.
CHECKPOINT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                               name="checkpoint.write")
#: One retry only: a serving launch is the latency-critical edge, and a
#: persistent failure should reach the circuit breaker (which sheds)
#: rather than burn the batch's deadline on backoff.
SERVING_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.02,
                            name="serving.launch")
#: Registry model loads (``parallel.platform.ModelRegistry.load``):
#: SERVING_RETRY-shaped — one retry over the transient class only, so a
#: filesystem hiccup doesn't fail a deploy or swap, while a digest
#: mismatch (``ModelIntegrityError``, not in the retryable set) propagates
#: at once and the incumbent version keeps serving.
MODEL_LOAD_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.02,
                               name="model.load")
