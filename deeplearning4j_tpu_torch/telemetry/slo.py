"""Declarative per-tenant SLOs evaluated as multi-window burn rates.

An :class:`SLO` declares objectives (p95 latency, TTFT, error rate);
an :class:`SLOMonitor` turns a tenant's outcome stream into burn rates
over a SHORT and a LONG rolling window and drives a three-state alert
(``ok`` → ``warn`` → ``page``) with hysteresis.

Burn rate is the classic SRE ratio: observed violation fraction divided
by the objective's budget (for the error objective the budget is the
target error rate itself; for the latency/TTFT objectives the budget is
the 5% a p95 target tolerates by definition). An alert level fires only
when the burn clears its threshold in BOTH windows — the short window
makes the alert fast, the long window stops a handful of bad requests
from paging — and clears only after ``clear_after`` consecutive
evaluations below every threshold (hysteresis, so a boundary-hovering
tenant doesn't flap).

Determinism discipline (the :class:`~parallel.platform.CanaryGate`
contract): ``observe`` evaluates SYNCHRONOUSLY on the caller's thread
under the monitor lock, state is a pure function of the observation
stream, and nothing here reads wall clock or draws randomness — so a
seeded replay of the same traffic fires every transition at the SAME
observation index, which is pinned by test. Evaluation of an objective
is count-gated (``min_samples``) so cold windows can't page on the
first stray error.

Surfaces: ``resilience.status()["slo"]``, ``ModelPlatform.stats()``, and
``dl4j_slo_*`` gauges via a scrape-time collector over the live-monitor
WeakSet (the fleet router's input).

A copy of the JAX package's ``telemetry/slo.py`` (which imports no jax):
one seeded outcome stream gives the same transitions at the same indices
in both packages. The UI serves the monitors' states at ``/slo``
(``ui.server``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Deque, Dict, List, Optional, Tuple

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
STATE_CODE = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

# a p95 objective budgets 5% of requests over the target by definition
_TAIL_BUDGET = 0.05

# monitors register here; the telemetry collector walks the set at
# scrape time (same pattern as the serving/decode engine WeakSets)
_MONITORS: "weakref.WeakSet[SLOMonitor]" = weakref.WeakSet()


@dataclasses.dataclass(frozen=True)
class SLO:
    """One tenant's objectives + alerting knobs. ``None`` disables an
    objective."""

    latency_p95_ms: Optional[float] = None
    ttft_ms: Optional[float] = None
    error_rate: Optional[float] = 0.01
    short_window: int = 64
    long_window: int = 512
    warn_burn: float = 1.0
    page_burn: float = 4.0
    clear_after: int = 32
    min_samples: int = 16

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Windows:
    """Short + long rolling violation windows for one objective."""

    __slots__ = ("short", "long")

    def __init__(self, slo: SLO):
        self.short: Deque[bool] = collections.deque(
            maxlen=max(1, slo.short_window))
        self.long: Deque[bool] = collections.deque(
            maxlen=max(1, slo.long_window))

    def push(self, violated: bool) -> None:
        self.short.append(violated)
        self.long.append(violated)

    def burns(self, budget: float) -> Tuple[float, float]:
        b = max(budget, 1e-9)
        s = (sum(self.short) / len(self.short) / b) if self.short else 0.0
        lo = (sum(self.long) / len(self.long) / b) if self.long else 0.0
        return s, lo


class _TenantState:
    __slots__ = ("slo", "n", "state", "ok_streak", "since_index",
                 "transitions", "windows", "burns")

    def __init__(self, slo: SLO):
        self.slo = slo
        self.n = 0
        self.state = STATE_OK
        self.ok_streak = 0
        self.since_index = 0
        self.transitions: List[dict] = []
        self.windows: Dict[str, _Windows] = {}
        if slo.error_rate is not None:
            self.windows["error_rate"] = _Windows(slo)
        if slo.latency_p95_ms is not None:
            self.windows["latency_p95"] = _Windows(slo)
        if slo.ttft_ms is not None:
            self.windows["ttft"] = _Windows(slo)
        self.burns: Dict[str, Tuple[float, float]] = {}

    def _budget(self, objective: str) -> float:
        if objective == "error_rate":
            return self.slo.error_rate or 1e-9
        return _TAIL_BUDGET


class SLOMonitor:
    """Per-tenant burn-rate evaluation over an outcome stream.

    ``objectives`` is a default :class:`SLO` applied to every tenant, or
    a dict ``{tenant: SLO}`` (unlisted tenants get ``default`` when
    provided, else no objectives and no state)."""

    def __init__(self, objectives=None, default: Optional[SLO] = None,
                 seed: int = 0):
        self._lock = threading.Lock()
        self._states: Dict[str, _TenantState] = {}
        self.seed = seed
        if isinstance(objectives, SLO):
            self._default: Optional[SLO] = objectives
            self._per_tenant: Dict[str, SLO] = {}
        else:
            self._per_tenant = dict(objectives or {})
            self._default = default
        _MONITORS.add(self)

    def _slo_for(self, tenant: str) -> Optional[SLO]:
        return self._per_tenant.get(tenant, self._default)

    # -- write side -------------------------------------------------------

    def observe(self, tenant: str, ok: Optional[bool] = None,
                seconds: Optional[float] = None,
                ttft: Optional[float] = None) -> str:
        """Record one outcome and re-evaluate synchronously. Returns the
        tenant's (possibly new) alert state."""
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                slo = self._slo_for(tenant)
                if slo is None:
                    return STATE_OK
                st = self._states[tenant] = _TenantState(slo)
            st.n += 1
            if ok is not None and "error_rate" in st.windows:
                st.windows["error_rate"].push(not ok)
            if seconds is not None and "latency_p95" in st.windows:
                st.windows["latency_p95"].push(
                    seconds * 1000.0 > st.slo.latency_p95_ms)
            if ttft is not None and "ttft" in st.windows:
                st.windows["ttft"].push(ttft * 1000.0 > st.slo.ttft_ms)
            return self._evaluate_locked(tenant, st)

    def _evaluate_locked(self, tenant: str, st: _TenantState) -> str:
        desired = STATE_OK
        for objective, w in st.windows.items():
            if len(w.long) < st.slo.min_samples:
                st.burns[objective] = w.burns(st._budget(objective))
                continue
            s, lo = w.burns(st._budget(objective))
            st.burns[objective] = (s, lo)
            if s >= st.slo.page_burn and lo >= st.slo.page_burn:
                desired = STATE_PAGE
            elif s >= st.slo.warn_burn and lo >= st.slo.warn_burn \
                    and desired == STATE_OK:
                desired = STATE_WARN
        cur = st.state
        if STATE_CODE[desired] > STATE_CODE[cur]:
            self._transition_locked(tenant, st, desired)
            st.ok_streak = 0
        elif STATE_CODE[desired] < STATE_CODE[cur]:
            st.ok_streak += 1
            if st.ok_streak >= st.slo.clear_after:
                self._transition_locked(tenant, st, desired)
                st.ok_streak = 0
        else:
            st.ok_streak = 0
        return st.state

    def _transition_locked(self, tenant: str, st: _TenantState,
                           to: str) -> None:
        st.transitions.append({
            "index": st.n, "from": st.state, "to": to,
            "burns": {k: [round(s, 3), round(lo, 3)]
                      for k, (s, lo) in sorted(st.burns.items())},
        })
        st.state = to
        st.since_index = st.n
        from deeplearning4j_tpu_torch import telemetry

        telemetry.record_slo_transition(tenant, to)

    # -- read side --------------------------------------------------------

    def state(self, tenant: str) -> str:
        with self._lock:
            st = self._states.get(tenant)
            return st.state if st is not None else STATE_OK

    def transitions(self, tenant: str) -> List[dict]:
        with self._lock:
            st = self._states.get(tenant)
            return list(st.transitions) if st is not None else []

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for tenant, st in sorted(self._states.items()):
                out[tenant] = {
                    "state": st.state,
                    "since_index": st.since_index,
                    "observations": st.n,
                    "objectives": st.slo.as_dict(),
                    "burn_rates": {
                        k: {"short": round(s, 3), "long": round(lo, 3)}
                        for k, (s, lo) in sorted(st.burns.items())},
                    "transitions": list(st.transitions),
                }
            return out

    def worst_state(self) -> str:
        with self._lock:
            worst = STATE_OK
            for st in self._states.values():
                if STATE_CODE[st.state] > STATE_CODE[worst]:
                    worst = st.state
            return worst

    def reset(self) -> None:
        with self._lock:
            self._states.clear()


def status() -> dict:
    """Merged view over every live monitor (the ``resilience.status()``
    payload)."""
    tenants: dict = {}
    worst = STATE_OK
    for mon in list(_MONITORS):
        for tenant, snap in mon.snapshot().items():
            tenants[tenant] = snap
            if STATE_CODE[snap["state"]] > STATE_CODE[worst]:
                worst = snap["state"]
    return {"state": worst, "tenants": tenants}


def monitors() -> List["SLOMonitor"]:
    return list(_MONITORS)
