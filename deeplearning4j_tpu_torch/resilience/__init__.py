"""Resilience: circuit breaker, retry policy and deterministic fault
injection (copies of the JAX package's modules, which import no jax), the
preemption-safe ``TrainingSession`` (``session``) and pod snapshots
(``pod``), and the process-wide ``status()`` that ``/health`` reads.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.resilience import breaker as breaker  # noqa: F401
from deeplearning4j_tpu_torch.resilience import faults as faults  # noqa: F401
from deeplearning4j_tpu_torch.resilience import retry as retry  # noqa: F401
from deeplearning4j_tpu_torch.resilience.breaker import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
)
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    InjectedFault,
    fault_point,
)
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy  # noqa: F401
from deeplearning4j_tpu_torch.resilience import pod as pod  # noqa: F401
from deeplearning4j_tpu_torch.resilience import session as session  # noqa: F401
from deeplearning4j_tpu_torch.resilience.pod import (  # noqa: F401
    HostDeathError,
    PodConfig,
    PodSnapshotIncompleteError,
)
from deeplearning4j_tpu_torch.resilience.session import (  # noqa: F401
    PreemptionError,
    TrainingSession,
)

_STATE_RANK = {"closed": 0, "half_open": 1, "open": 2}


def _aggregate_breakers() -> dict:
    """Every live breaker's status, grouped per MODEL: a multi-tenant
    serving host names a model's breakers ``serving:<model>`` (primary)
    and ``serving:<model>#canary`` — distinct metric series, but ONE
    ``/health`` entry per model, keyed by the pre-``#`` prefix. The entry
    aggregates all of a model's live breakers — worst state wins (open >
    half_open > closed), counters sum — instead of the last-registered
    breaker silently shadowing the rest."""
    groups: dict = {}
    for b in breaker.live_breakers():
        groups.setdefault(b.name.split("#", 1)[0], []).append(b.status())
    out = {}
    for name, sts in sorted(groups.items()):
        agg = dict(max(sts, key=lambda s: _STATE_RANK.get(s["state"], 0)))
        agg["breakers"] = len(sts)
        if len(sts) > 1:
            agg["states"] = sorted(s["state"] for s in sts)
            agg["tripped_total"] = sum(s["tripped_total"] for s in sts)
            agg["consecutive_failures"] = max(
                s["consecutive_failures"] for s in sts)
            agg["window"] = {
                "size": sum(s["window"]["size"] for s in sts),
                "failures": sum(s["window"]["failures"] for s in sts),
            }
        out[name] = agg
    return out


def status() -> dict:
    """Process-wide resilience snapshot for ``/health`` and debugging:
    every live circuit breaker's state (aggregated per model, see
    :func:`_aggregate_breakers`), the retry, resume and fault counters,
    the SLO monitors' states (when any monitor has observed a tenant), the
    pod topology and snapshot / restore series (when a pod session has
    recorded any), and whether a fault plan is armed."""
    from deeplearning4j_tpu_torch.telemetry import REGISTRY, slo

    snap = REGISTRY.snapshot(run_collectors=False)
    counters = {k: v for k, v in snap.items()
                if k.startswith(("dl4j_retries_total",
                                 "dl4j_resumes_total",
                                 "dl4j_faults_injected_total"))}
    out = {
        "circuit_breakers": _aggregate_breakers(),
        "counters": counters,
        "fault_plan_armed": faults.active_plan() is not None,
    }
    slo_status = slo.status()
    if slo_status["tenants"]:
        out["slo"] = slo_status
    pod_series = {k: v for k, v in snap.items()
                  if k.startswith("dl4j_pod_")}
    if pod_series:
        out["pod"] = {
            "hosts": int(snap.get("dl4j_pod_hosts", 0)),
            "series": {
                k: (v if not isinstance(v, dict)
                    else {kk: v[kk] for kk in ("count", "mean", "p95")})
                for k, v in pod_series.items()},
        }
    return out
