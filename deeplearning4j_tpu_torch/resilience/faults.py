"""Deterministic fault injection.

A minimal copy of the JAX package's ``resilience/faults.py`` for the
serving slice. Product code carries permanent one-line ``fault_point(site)``
hooks (one module-global check when no plan is armed), and a test arms a
:class:`FaultPlan` that raises or delays on exactly the invocations it
chose.

Named sites (the permanent hooks in product code)::

    serving.launch       parallel.batcher dispatcher, before the shared
                         forward (delay mode simulates a stuck launch —
                         the watchdog's test vector)

Usage::

    plan = FaultPlan()
    plan.inject("serving.launch", on_calls=[2])
    with plan.armed():
        ...   # the run under test

Determinism: ``on_calls`` fires on exact 1-based invocation indices (or, when
not given, on every invocation). One plan is armed per process at a time.
Every fire counts into ``dl4j_faults_injected_total{site=...}``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterable, List, Optional

SITES = ("serving.launch",)


class InjectedFault(RuntimeError):
    """Default exception a raise-mode fault throws. Carries the site and
    the 1-based invocation index that fired."""

    def __init__(self, site: str, invocation: int, message: str = None):
        super().__init__(message or
                         f"injected fault at {site!r} "
                         f"(invocation {invocation})")
        self.site = site
        self.invocation = invocation


class _FaultSpec:
    __slots__ = ("site", "on_calls", "action", "exc", "delay_s", "fired")

    def __init__(self, site, on_calls, action, exc, delay_s):
        self.site = site
        self.on_calls = frozenset(int(c) for c in on_calls) \
            if on_calls is not None else None
        self.action = action
        self.exc = exc
        self.delay_s = float(delay_s)
        self.fired = 0

    def should_fire(self, invocation: int) -> bool:
        return self.on_calls is None or invocation in self.on_calls

    def make_exc(self, invocation: int) -> BaseException:
        if self.exc is None:
            return InjectedFault(self.site, invocation)
        if isinstance(self.exc, BaseException):
            return self.exc
        return self.exc()  # class or factory


class FaultPlan:
    """A set of armed injection sites. Build with chained :meth:`inject`
    calls, activate with :meth:`armed` (context manager) or :meth:`arm` /
    :meth:`disarm`."""

    def __init__(self):
        self._specs: List[_FaultSpec] = []
        self._invocations: dict = {}
        self._lock = threading.Lock()

    def inject(self, site: str,
               on_calls: Optional[Iterable[int]] = None,
               action: str = "raise",
               exc: Optional[Callable[[], BaseException]] = None,
               delay_s: float = 0.05) -> "FaultPlan":
        """Arm ``site`` on the 1-based invocation indices ``on_calls``
        (every invocation when None). ``action``: ``"raise"`` (throw
        ``exc`` — class, factory, or instance; default
        :class:`InjectedFault`) or ``"delay"`` (sleep ``delay_s`` then
        proceed)."""
        if action not in ("raise", "delay"):
            raise ValueError(f"unknown fault action {action!r}")
        self._specs.append(_FaultSpec(site, on_calls, action, exc, delay_s))
        return self

    def arm(self) -> "FaultPlan":
        global _ACTIVE
        with _ARM_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError(
                    "a FaultPlan is already armed in this process")
            _ACTIVE = self
        return self

    def disarm(self) -> "FaultPlan":
        global _ACTIVE
        with _ARM_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None
        return self

    @contextlib.contextmanager
    def armed(self):
        self.arm()
        try:
            yield self
        finally:
            self.disarm()

    def invocations(self, site: str) -> int:
        """How many times ``site``'s hook ran while this plan was armed."""
        return self._invocations.get(site, 0)

    def fired(self, site: str = None) -> int:
        """Total faults fired (optionally for one site)."""
        return sum(s.fired for s in self._specs
                   if site is None or s.site == site)

    def _hit(self, site: str):
        with self._lock:
            inv = self._invocations.get(site, 0) + 1
            self._invocations[site] = inv
            to_fire = [s for s in self._specs
                       if s.site == site and s.should_fire(inv)]
            for s in to_fire:
                s.fired += 1
        for s in to_fire:
            _record_injected(site, s.action)
            if s.action == "raise":
                raise s.make_exc(inv)
            time.sleep(s.delay_s)


_ARM_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None


def fault_point(site: str) -> None:
    """The permanent product-code hook: a no-op when no plan is armed, else
    routes through the armed plan (which may raise or sleep)."""
    plan = _ACTIVE
    if plan is not None:
        plan._hit(site)


def _record_injected(site: str, action: str) -> None:
    from deeplearning4j_tpu_torch import telemetry

    telemetry.record_fault_injected(site, action)
