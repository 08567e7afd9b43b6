"""Circuit breaker for the serving path.

A model forward that starts failing (bad weights hot-swapped in, a
wedged device, an OOM loop) must not take the whole serving process
down with it: callers pile onto the queue, every launch burns device
time to fail, and latency for the requests that *would* succeed
explodes. The breaker converts that failure mode into fast, bounded
shedding:

- **closed** — normal operation. Consecutive launch failures (or a
  failure rate over the recent-outcome window) trip it open.
- **open** — ``allow()`` is False: submits shed immediately with
  :class:`CircuitOpenError` (HTTP 503 upstream) instead of queueing
  behind a dead model. After ``recovery_timeout_s`` the breaker goes
  half-open.
- **half_open** — a bounded number of probe requests are admitted;
  ``success_threshold`` consecutive probe successes close the breaker,
  any probe failure re-opens it (and restarts the recovery clock).

State transitions publish ``dl4j_circuit_state{breaker=...}``
(0=closed, 1=half_open, 2=open) and
``dl4j_circuit_transitions_total{breaker=...,to=...}``. Live breakers
are tracked in a WeakSet so ``resilience.status()`` / the ``/health``
surface can report every breaker in the process.

A copy of the JAX package's ``resilience/breaker.py``.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

_BREAKERS = weakref.WeakSet()


class CircuitOpenError(RuntimeError):
    """Fail-fast rejection while the breaker is open — maps to HTTP 503
    (the client should back off; the server is shedding on purpose)."""


class CircuitBreaker:
    """Thread-safe three-state breaker.

    Args:
        failure_threshold: consecutive launch failures that trip open.
        failure_rate: optional rate trip — open when
            ``failures/window >= failure_rate`` over the last
            ``window_size`` outcomes (needs at least ``window_size``
            recorded outcomes; catches the steady-trickle failure mode
            consecutive counting misses).
        recovery_timeout_s: open -> half_open delay.
        half_open_probes: requests admitted while half-open before the
            first outcome lands.
        success_threshold: consecutive half-open successes that close.
        clock: injectable monotonic clock (tests).
    """

    def __init__(self, failure_threshold: int = 5,
                 recovery_timeout_s: float = 30.0,
                 half_open_probes: int = 1,
                 success_threshold: int = 1,
                 failure_rate: Optional[float] = None,
                 window_size: int = 20,
                 name: str = "serving",
                 clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.recovery_timeout_s = float(recovery_timeout_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self.success_threshold = max(1, int(success_threshold))
        self.failure_rate = failure_rate
        self.window_size = int(window_size)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._probe_tickets = 0
        self._probe_successes = 0
        self._opened_at = 0.0
        self._probe_issued_at = 0.0
        self._window = collections.deque(maxlen=self.window_size)
        self.tripped_total = 0
        _BREAKERS.add(self)
        self._publish(CLOSED, transition=False)

    # --- admission ----------------------------------------------------------
    def allow(self) -> bool:
        """Whether a new request may enter. In half-open this consumes a
        probe ticket, so at most ``half_open_probes`` requests are in
        flight before an outcome decides the state."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at \
                        >= self.recovery_timeout_s:
                    self._to_half_open_locked()
                else:
                    return False
            # HALF_OPEN (possibly just entered)
            if self._probe_tickets > 0:
                self._probe_tickets -= 1
                self._probe_issued_at = self._clock()
                return True
            if self._clock() - self._probe_issued_at \
                    >= self.recovery_timeout_s:
                # the outstanding probe never reported an outcome (its
                # waiter expired or was dropped): re-issue instead of
                # wedging half-open shut forever
                self._probe_tickets = self.half_open_probes - 1
                self._probe_issued_at = self._clock()
                return True
            return False

    # --- outcomes -----------------------------------------------------------
    def on_success(self) -> None:
        with self._lock:
            self._window.append(True)
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.success_threshold:
                    self._to_closed_locked()
                else:
                    self._probe_tickets += 1  # next probe may proceed

    def on_failure(self) -> None:
        with self._lock:
            self._window.append(False)
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._to_open_locked()  # a failed probe re-opens immediately
                return
            if self._state != CLOSED:
                return
            if self._consecutive_failures >= self.failure_threshold:
                self._to_open_locked()
                return
            if (self.failure_rate is not None
                    and len(self._window) >= self.window_size
                    and (self._window.count(False) / len(self._window)
                         >= self.failure_rate)):
                self._to_open_locked()

    # --- state (locked callers only) ---------------------------------------
    def _to_open_locked(self):
        self._state = OPEN
        self._opened_at = self._clock()
        self.tripped_total += 1
        self._publish(OPEN)

    def _to_half_open_locked(self):
        self._state = HALF_OPEN
        self._probe_tickets = self.half_open_probes
        self._probe_successes = 0
        self._probe_issued_at = self._clock()
        self._publish(HALF_OPEN)

    def _to_closed_locked(self):
        self._state = CLOSED
        self._consecutive_failures = 0
        self._window.clear()
        self._publish(CLOSED)

    def _publish(self, to_state: str, transition: bool = True):
        from deeplearning4j_tpu_torch import telemetry

        telemetry.record_circuit_state(self.name, _STATE_CODE[to_state],
                                       transition=transition)

    # --- introspection ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            # surface the pending open->half_open flip without requiring
            # a probe submit first (scrapes read the truth)
            if self._state == OPEN and (self._clock() - self._opened_at
                                        >= self.recovery_timeout_s):
                self._to_half_open_locked()
            return self._state

    def status(self) -> dict:
        st = self.state
        with self._lock:
            return {
                "name": self.name,
                "state": st,
                "consecutive_failures": self._consecutive_failures,
                "tripped_total": self.tripped_total,
                "window": {
                    "size": len(self._window),
                    "failures": self._window.count(False),
                },
            }


def live_breakers():
    return list(_BREAKERS)
