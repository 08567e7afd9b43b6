"""Multi-tenant serving platform: many models, one host.

Production traffic is never one model. A serving host runs many models
and versions at once, and the operational contract is ISOLATION: one
tenant's bad deploy, queue flood, or warmup storm must degrade only that
tenant while its co-tenants' latency, outputs, and new-envelope counts
stay pinned (``optimize.aot_cache``: the port's counterpart of a compile
is the first forward at a new envelope). This module is the platform
object that turns three proven single-model subsystems into that
contract:

- :class:`ModelRegistry` — a versioned on-disk model store with the
  checkpoint discipline (``util.serializer``): every publish is an
  atomic temp+rename zip whose sha256 digest is recorded in an
  atomically-replaced manifest, and every load re-verifies the digest
  BEFORE restoring — a corrupt or tampered version is refused and the
  incumbent keeps serving. ``model.load`` is a permanent fault site
  (retried by ``MODEL_LOAD_RETRY``).
- :class:`ModelPlatform` — per-model
  :class:`~deeplearning4j_tpu_torch.parallel.batcher.InferenceEngine` /
  :class:`~deeplearning4j_tpu_torch.parallel.generation.GenerationEngine`
  tenants, each with its OWN circuit breaker (named
  ``serving:<model>`` so ``/health`` aggregates a model's breakers
  under one key), its own admission quota (the engine queue) under a
  host-wide pending cap (:class:`HostOverloadedError` names the host,
  not the model), and its own warmup budget
  (``optimize.aot_cache.WarmupBudget`` — a tenant whose warmup blows
  its budget of new envelopes comes up truncated instead of starving its
  co-tenants' warmups).
- **Versioned hot-swap** — :meth:`ModelPlatform.swap` loads the new
  version (digest-verified), crosses the ``model.swap`` fault site,
  and publishes it into the running engine via the zero-downtime
  ``InferenceEngine.publish`` path (atomic per batch; warmed envelopes
  stay valid when the conf is unchanged, so a same-arch swap adds no
  new envelope). A failure anywhere before the publish leaves the
  incumbent serving, untouched.
- **Canary routing** — :meth:`ModelPlatform.deploy_canary` routes a
  seeded, deterministic fraction of a model's traffic to a candidate
  version behind its own breaker, and a :class:`CanaryGate` watches
  the canary's error/latency deltas against the incumbent. When the
  gate trips (breaker open, consecutive failures, error-rate delta,
  p95 ratio) the platform ROLLS BACK automatically: the canary engine
  closes, the incumbent takes 100% again, and the registry still
  points at the incumbent version. The routing stream is seeded exactly
  like the ``FaultPlan`` machinery (a pure function of ``(seed,
  model)``), so a chaos run replays bit-identically: same seed, same
  fault plan → same requests hit the canary → same rollback point.

Determinism note: the gate's deterministic triggers (consecutive
failures, error-rate delta, p95 ratio) are evaluated synchronously on
the caller's thread from the platform's own outcome records, so a
sequential chaos run trips at an exact request index. The breaker-open
trigger reads a state the engine's dispatcher thread publishes, so
under concurrency it may lag the deterministic triggers by a request.

The port of the JAX package's ``parallel/platform.py``. The registry's
on-disk layout, its manifest keys and digests, and the canary's routing
and accuracy-sample streams are the JAX package's, so a registry directory
written by either package loads in the other and one seed sends the same
requests to the canary in both. Versions load onto the platform's
``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
import threading
import time
import weakref
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.parallel.batcher import (
    BatchingConfig,
    InferenceEngine,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.retry import MODEL_LOAD_RETRY
from deeplearning4j_tpu_torch.telemetry import slo as slo_mod
from deeplearning4j_tpu_torch.util import serializer

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


class UnknownModelError(LookupError):
    """The requested model (or version) is not in the registry /
    platform — maps to a NAMED HTTP 404, never a KeyError 500."""


class ModelIntegrityError(RuntimeError):
    """A version's zip no longer matches its manifest sha256 digest
    (truncation, bit rot, tampering). The load is REFUSED — deliberately
    not in the transient retryable set, so a swap/deploy fails fast and
    the incumbent version keeps serving."""


class HostOverloadedError(ServerOverloadedError):
    """The HOST-wide pending cap is exhausted (sum over every tenant's
    queue) — distinct from a single model's queue being full, so a
    client can tell "this model is shedding" from "host overloaded"."""


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"invalid model name {name!r}: need [A-Za-z0-9][A-Za-z0-9_.-]* "
            "(it becomes a directory name and an HTTP route segment)")
    return name


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

class ModelRegistry:
    """Versioned on-disk model store.

    Layout (everything under ``root``)::

        root/<model>/v0001.zip        # serializer.write_model archives
        root/<model>/v0002.zip
        root/<model>/versions.json    # manifest: version → file, sha256

    Both writes are atomic (zip via ``write_model``'s temp+``os.replace``,
    manifest via its own temp+replace), and the manifest is only updated
    AFTER the zip is durably published — a crash anywhere mid-publish
    leaves the manifest pointing at the previous, digest-verified
    version (at worst an orphan ``.zip``/temp file that the next publish
    of that version number overwrites).
    """

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()       # guards _model_locks only
        self._model_locks: Dict[str, threading.Lock] = {}

    def _model_lock(self, name: str) -> threading.Lock:
        """Per-model publish lock: serialization + digest of one
        model's zip (seconds of I/O for a big net) must not block an
        unrelated co-tenant's publish — the same isolation contract as
        the serving side."""
        with self._lock:
            return self._model_locks.setdefault(name, threading.Lock())

    # --- manifest I/O -------------------------------------------------------
    def _dir(self, name: str) -> Path:
        return self.root / _check_name(name)

    def _manifest_path(self, name: str) -> Path:
        return self._dir(name) / "versions.json"

    def _read_manifest(self, name: str) -> dict:
        path = self._manifest_path(name)
        if not path.exists():
            return {"model": name, "versions": []}
        with open(path) as f:
            return json.load(f)

    def _write_manifest_locked(self, name: str, manifest: dict) -> None:
        path = self._manifest_path(name)
        tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()

    # --- publish / load -----------------------------------------------------
    def publish(self, name: str, net, save_updater: bool = False) -> int:
        """Serialize ``net`` as the next version of ``name``; returns
        the new version number. The zip write is atomic and the digest
        is computed from the PUBLISHED file before the manifest commits,
        so a version the manifest names is always restorable-or-refused,
        never silently truncated."""
        with self._model_lock(name):
            d = self._dir(name)
            d.mkdir(parents=True, exist_ok=True)
            manifest = self._read_manifest(name)
            version = 1 + max((v["version"] for v in manifest["versions"]),
                              default=0)
            path = d / f"v{version:04d}.zip"
            serializer.write_model(net, path, save_updater=save_updater)
            entry = {
                "version": version,
                "file": path.name,
                "sha256": serializer.file_digest(path),
                "model_class": type(net).__name__,
            }
            spec = getattr(getattr(net, "conf", None), "quantization", None)
            if spec is not None:
                # quantized artifacts are ordinary VERSIONS: the manifest
                # records scheme + calibration digest so load() can
                # re-verify the restored conf against what was published
                entry["quantization"] = {
                    "scheme": spec.scheme,
                    "calibration_digest": spec.digest,
                }
            manifest["versions"].append(entry)
            self._write_manifest_locked(name, manifest)
        return version

    def _entry(self, name: str, version: Optional[int]) -> dict:
        manifest = self._read_manifest(name)
        if not manifest["versions"]:
            raise UnknownModelError(
                f"unknown model {name!r} (registry has: "
                f"{sorted(self.models()) or 'nothing'})")
        if version is None:
            return manifest["versions"][-1]
        for ent in manifest["versions"]:
            if ent["version"] == int(version):
                return ent
        raise UnknownModelError(
            f"model {name!r} has no version {version} (have: "
            f"{[v['version'] for v in manifest['versions']]})")

    def load(self, name: str, version: Optional[int] = None,
             retry=MODEL_LOAD_RETRY, device="cuda"):
        """Digest-verify and restore one version (latest by default) onto
        ``device``. Crosses the ``model.load`` fault site and retries the
        transient class per ``retry`` (``None`` disables); a digest
        mismatch raises :class:`ModelIntegrityError` without retrying —
        refusal, not flakiness."""
        ent = self._entry(name, version)
        path = self._dir(name) / ent["file"]

        def once():
            faults.fault_point("model.load")
            if not path.exists():
                raise UnknownModelError(
                    f"model {name!r} v{ent['version']}: file "
                    f"{ent['file']} is missing")
            if serializer.file_digest(path) != ent["sha256"]:
                raise ModelIntegrityError(
                    f"model {name!r} v{ent['version']}: sha256 mismatch "
                    f"({ent['file']} corrupted or tampered) — load refused")
            net = serializer.restore_model(path, device=device)
            self._verify_quantization(name, ent, net)
            return net

        net = retry.call(once, op="model.load") if retry is not None \
            else once()
        return net, ent["version"]

    @staticmethod
    def _verify_quantization(name: str, ent: dict, net) -> None:
        """Cross-check the restored conf's QuantizationSpec against the
        manifest entry (both directions — a quantized zip under an
        unquantized manifest row is as wrong as the reverse), then
        re-register the calibration digest as live."""
        qent = ent.get("quantization")
        spec = getattr(getattr(net, "conf", None), "quantization", None)
        if qent is None and spec is None:
            return
        if (qent is None or spec is None
                or spec.scheme != qent.get("scheme")
                or spec.digest != qent.get("calibration_digest")):
            raise ModelIntegrityError(
                f"model {name!r} v{ent['version']}: quantization metadata "
                f"mismatch between manifest ({qent}) and restored artifact "
                f"({spec and (spec.scheme, spec.digest[:12] + '…')}) — "
                f"load refused")
        from deeplearning4j_tpu_torch.nn import inference_opt as _iopt

        _iopt.register_restored(spec)

    # --- introspection ------------------------------------------------------
    def models(self) -> List[str]:
        if not self.root.exists():
            return []
        return sorted(p.name for p in self.root.iterdir()
                      if (p / "versions.json").exists())

    def versions(self, name: str) -> List[int]:
        return [v["version"]
                for v in self._read_manifest(name)["versions"]]

    def latest_version(self, name: str) -> int:
        return self._entry(name, None)["version"]

    def digest(self, name: str, version: Optional[int] = None) -> str:
        return self._entry(name, version)["sha256"]

    def verify(self, name: str, version: Optional[int] = None) -> bool:
        """Whether the stored zip still matches its manifest digest."""
        ent = self._entry(name, version)
        path = self._dir(name) / ent["file"]
        return path.exists() \
            and serializer.file_digest(path) == ent["sha256"]


def _output_delta(a, b) -> float:
    """Max-abs elementwise delta between two prediction outputs (arrays or
    lists of arrays) — the accuracy arm's scalar. Shape/arity drift is
    ``inf``: structurally different outputs are maximally regressed."""
    import numpy as np

    la = list(a) if isinstance(a, (list, tuple)) else [a]
    lb = list(b) if isinstance(b, (list, tuple)) else [b]
    if len(la) != len(lb):
        return float("inf")
    worst = 0.0
    for x, y in zip(la, lb):
        x = np.asarray(x)
        y = np.asarray(y)
        if x.shape != y.shape:
            return float("inf")
        if x.size:
            d = float(np.max(np.abs(x.astype(np.float64)
                                    - y.astype(np.float64))))
            worst = max(worst, d)
    return worst


# --------------------------------------------------------------------------
# tenant / canary configuration
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TenantConfig:
    """Per-model serving policy. ``batching`` is the tenant's private
    admission quota (its queue, its deadlines); the warmup caps bound
    the tenant's new envelopes (first forwards) and their seconds at
    deploy time (``aot_cache.WarmupBudget`` — exceeding them truncates
    THIS tenant's warmup and records a PLT301 finding, co-tenants
    unaffected; the field names are the JAX package's, so one config
    serves both); ``warmup_shapes`` forwards to
    ``InferenceEngine.warmup(shapes=...)`` for models whose conf cannot
    pin input shapes."""

    batching: BatchingConfig = dataclasses.field(
        default_factory=BatchingConfig)
    graph_opt: bool = True
    bf16: bool = False
    warmup: bool = True
    warmup_shapes: Optional[list] = None
    warmup_max_compiles: Optional[int] = None
    warmup_max_compile_seconds: Optional[float] = None


@dataclasses.dataclass
class CanaryGate:
    """When to give up on a canary and roll back. Any tripped condition
    rolls back; ``None`` disables a condition.

    The consecutive-failure and delta conditions are evaluated from the
    platform's own per-arm outcome records on the caller's thread —
    deterministic under sequential traffic (the chaos-suite invariant:
    same seed → same rollback request index). ``trip_on_breaker_open``
    additionally trips as soon as the canary's breaker reports open
    (its state is published by the engine's dispatcher thread, so this
    trigger alone is not request-exact under concurrency)."""

    min_requests: int = 20            # canary outcomes before deltas judge
    max_consecutive_failures: Optional[int] = 5
    max_error_rate_delta: Optional[float] = 0.25
    max_p95_ratio: Optional[float] = None   # canary p95 / incumbent p95
    trip_on_breaker_open: bool = True
    window: int = 50                  # per-arm outcome window size
    # accuracy arm (quantized rollouts): per-request max-abs output delta
    # vs the f32 incumbent, measured by replaying a deterministically
    # sampled subset of successful canary requests through the incumbent
    # ENGINE (off the routing stats, so the incumbent's gate arm is not
    # polluted). The sample draw comes from its own (seed, model) stream —
    # the routing stream is untouched, so enabling the arm never changes
    # which requests the canary serves. Trips IMMEDIATELY (no min_requests
    # wait): an accuracy regression is deterministic model badness, and
    # the synchronous compare makes the rollback request index replayable.
    max_accuracy_delta: Optional[float] = None
    accuracy_sample: float = 1.0      # fraction of canary hits compared


class _ArmStats:
    """Rolling outcome window for one arm (primary or canary) of one
    model: ok/failure flags + latencies, mutated only under the
    platform lock."""

    def __init__(self, window: int):
        self.outcomes = deque(maxlen=window)   # True = ok
        self.latencies = deque(maxlen=window)  # seconds, ok requests
        self.requests = 0
        self.failures = 0
        self.consecutive_failures = 0

    def record_locked(self, ok: bool, seconds: float) -> None:
        self.requests += 1
        self.outcomes.append(ok)
        if ok:
            self.latencies.append(seconds)
            self.consecutive_failures = 0
        else:
            self.failures += 1
            self.consecutive_failures += 1

    def error_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return self.outcomes.count(False) / len(self.outcomes)

    def p95(self) -> Optional[float]:
        if len(self.latencies) < 5:
            return None
        lat = sorted(self.latencies)
        return lat[min(int(0.95 * len(lat)), len(lat) - 1)]

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "failures": self.failures,
            "consecutive_failures": self.consecutive_failures,
            "window_error_rate": round(self.error_rate(), 4),
        }


class _Canary:
    __slots__ = ("version", "engine", "src_model", "fraction", "gate",
                 "rng", "stats", "rolled_back_at", "rollback_reason",
                 "acc_rng", "accuracy_samples", "accuracy_max_delta",
                 "accuracy_last_delta")

    def __init__(self, version, engine, src_model, fraction, gate, rng,
                 window, acc_rng=None):
        self.version = version
        self.engine = engine
        self.src_model = src_model
        self.fraction = float(fraction)
        self.gate = gate
        self.rng = rng
        self.stats = _ArmStats(window)
        self.rolled_back_at: Optional[int] = None
        self.rollback_reason: Optional[str] = None
        # accuracy arm state (gate.max_accuracy_delta), all under the
        # platform lock; acc_rng is a SEPARATE seeded stream from the
        # routing rng so sampling never perturbs arm selection
        self.acc_rng = acc_rng
        self.accuracy_samples = 0
        self.accuracy_max_delta = 0.0
        self.accuracy_last_delta: Optional[float] = None

    def accuracy_snapshot(self) -> dict:
        return {
            "accuracy_samples": self.accuracy_samples,
            "accuracy_max_delta": self.accuracy_max_delta,
            "accuracy_last_delta": self.accuracy_last_delta,
        }


class _Tenant:
    __slots__ = ("name", "version", "engine", "config", "src_model",
                 "canary", "budget", "warmup_truncated", "warmup_result",
                 "request_seq", "stats", "last_rollback")

    def __init__(self, name, version, engine, config, src_model, budget):
        self.name = name
        self.version = version
        self.engine = engine
        self.config = config
        self.src_model = src_model   # pre-graph-opt weights (promote/swap)
        self.canary: Optional[_Canary] = None
        self.budget = budget
        self.warmup_truncated = False
        self.warmup_result: Optional[dict] = None
        self.request_seq = 0         # routed requests (both arms)
        self.stats = _ArmStats(CanaryGate.window)
        self.last_rollback: Optional[dict] = None


# --------------------------------------------------------------------------
# platform
# --------------------------------------------------------------------------

_PLATFORMS = weakref.WeakSet()


class ModelPlatform:
    """One serving host, many isolated model tenants.

    Usage::

        reg = ModelRegistry("/models")
        reg.publish("ranker", net_v1)
        plat = ModelPlatform(reg, seed=7)
        plat.deploy("ranker")                      # latest version
        y = plat.predict("ranker", x)
        reg.publish("ranker", net_v2)
        plat.deploy_canary("ranker", fraction=0.2) # latest vs incumbent
        ...                                        # gate rolls back or
        plat.promote("ranker")                     # operator promotes
        plat.close()

    Every tenant gets a private engine (queue, dispatcher, buckets), a
    private breaker named ``serving:<model>``, a private warmup budget,
    and the scoped fault site ``serving.launch:<model>`` — the
    isolation surfaces the chaos suite pins. ``host_max_pending`` adds
    one host-wide admission cap over all tenant queues
    (:class:`HostOverloadedError`, a 503 clients can tell apart from a
    single model shedding).
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 seed: int = 0, host_max_pending: Optional[int] = None,
                 slo=None, device="cuda"):
        self.registry = registry
        self.seed = int(seed)
        # where registry versions (and a zoo LM config) are built; an
        # explicit model= keeps its own device
        self.device = device
        self.host_max_pending = host_max_pending
        self._tenants: Dict[str, _Tenant] = {}
        self._gen_tenants: Dict[str, tuple] = {}  # name -> (engine, ver)
        self._lock = threading.RLock()
        self._closed = False
        # declarative SLOs: an slo.SLO applied to every tenant or a
        # {tenant: SLO} dict. Outcomes are observed synchronously at the
        # same points the canary gate records them, so a seeded replay
        # fires every burn-rate transition at the same request index.
        self._slo = (slo_mod.SLOMonitor(slo, seed=self.seed)
                     if slo is not None else None)
        _PLATFORMS.add(self)

    @property
    def slo(self) -> Optional[slo_mod.SLOMonitor]:
        return self._slo

    # --- deploy -------------------------------------------------------------
    def _load(self, name, version, model):
        """(model, version) from the explicit object or the registry."""
        if model is not None:
            return model, version if version is not None else 0
        if self.registry is None:
            raise ValueError(
                "no registry attached: pass model= explicitly or "
                "construct ModelPlatform(ModelRegistry(...))")
        return self.registry.load(name, version, device=self.device)

    def _build_engine(self, name: str, model, cfg: TenantConfig,
                      engine_name: str, breaker=...):
        return InferenceEngine(
            model, cfg.batching, graph_opt=cfg.graph_opt, bf16=cfg.bf16,
            name=engine_name, breaker=breaker,
            admission=self._host_admission)

    def _warm_engine(self, tenant_name: str, engine: InferenceEngine,
                     cfg: TenantConfig, budget: aot_cache.WarmupBudget):
        """Warm every bucket under the tenant's budget; an exhausted
        budget truncates THIS tenant's warmup (recorded as a PLT301
        finding + returned in stats), never fails the deploy."""
        if not cfg.warmup:
            return None, False
        try:
            with aot_cache.warmup_budget(budget):
                return engine.warmup(shapes=cfg.warmup_shapes), False
        except aot_cache.WarmupBudgetExceeded as e:
            self._record_budget_finding(tenant_name, e)
            return budget.snapshot(), True

    def _record_budget_finding(self, name: str, exc) -> None:
        """Record a truncated warmup in the findings log
        (``analysis.findings.LOG``): PLT301, the platform family of the
        analysis rule catalog."""
        try:
            from deeplearning4j_tpu_torch.analysis.findings import (
                LOG,
                WARN,
                Finding,
            )

            LOG.record(Finding(
                rule="PLT301", severity=WARN,
                message=f"warmup budget exhausted: {exc}",
                location=f"model={name}"))
        except Exception:
            pass  # accounting must never fail a deploy

    def deploy(self, name: str, version: Optional[int] = None,
               config: Optional[TenantConfig] = None,
               model=None) -> dict:
        """Bring one model up as a tenant (replacing any existing tenant
        of that name wholesale). ``model=`` bypasses the registry (a
        live train→serve publish); otherwise ``version`` (default
        latest) is digest-verified out of the registry."""
        _check_name(name)
        cfg = config or TenantConfig()
        src, ver = self._load(name, version, model)
        budget = aot_cache.WarmupBudget(
            name, max_compiles=cfg.warmup_max_compiles,
            max_compile_seconds=cfg.warmup_max_compile_seconds)
        engine = self._build_engine(name, src, cfg, engine_name=name)
        warm, truncated = self._warm_engine(name, engine, cfg, budget)
        with self._lock:
            if self._closed:
                engine.close()
                raise RuntimeError("platform is closed")
            old = self._tenants.get(name)
            tenant = _Tenant(name, ver, engine, cfg, src, budget)
            tenant.warmup_result, tenant.warmup_truncated = warm, truncated
            self._tenants[name] = tenant
        if old is not None:
            self._close_tenant(old)
        return {"model": name, "version": ver, "warmup": warm,
                "warmup_truncated": truncated}

    def undeploy(self, name: str) -> None:
        with self._lock:
            tenant = self._tenants.pop(name, None)
        if tenant is not None:
            self._close_tenant(tenant)

    def _close_tenant(self, tenant: _Tenant) -> None:
        if tenant.canary is not None:
            tenant.canary.engine.close()
        tenant.engine.close()

    # --- hot swap -----------------------------------------------------------
    def swap(self, name: str, version: Optional[int] = None,
             model=None) -> dict:
        """Hot-swap the tenant's PRIMARY to another version with zero
        downtime: load (digest-verified), cross the ``model.swap``
        fault site, publish into the running engine (atomic per batch,
        warmed envelopes stay valid for a same-conf version). Any
        failure before the publish — a corrupt zip, an injected fault,
        a crash — leaves the incumbent serving and the tenant record
        untouched."""
        tenant = self._tenant(name)
        src, ver = self._load(name, version, model)
        # a raise here = partial swap (new version loaded, never
        # published); a delay here = wedged swap — the incumbent keeps
        # serving throughout because nothing has touched the engine yet
        faults.fault_point("model.swap")
        tenant.engine.publish(src)
        with self._lock:
            tenant.src_model = src
            tenant.version = ver
        telemetry.record_platform_event("swap", name)
        return {"model": name, "version": ver}

    # --- canary -------------------------------------------------------------
    def deploy_canary(self, name: str, version: Optional[int] = None,
                      fraction: float = 0.1,
                      gate: Optional[CanaryGate] = None,
                      config: Optional[TenantConfig] = None,
                      model=None) -> dict:
        """Stand a candidate version up beside the incumbent and route
        a seeded ``fraction`` of the model's traffic to it. The canary
        engine is named ``<name>#canary``: its own metrics series, its
        own fault site (``serving.launch:<name>#canary``) and its own
        breaker (``serving:<name>#canary`` — a distinct
        ``dl4j_circuit_state`` series, so the primary's gauge can never
        be shadowed by a dead canary's last state). ``/health`` still
        reports ONE entry per model: the aggregation groups breaker
        names by their pre-``#`` prefix, worst state first. Routing
        draws come from a pure ``(seed, name)`` stream, so a replay
        with the same seed routes the same request indices to the
        canary."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError("fraction must be in (0, 1]")
        tenant = self._tenant(name)
        if tenant.canary is not None:
            raise RuntimeError(
                f"model {name!r} already has a canary (v"
                f"{tenant.canary.version}); promote or roll back first")
        cfg = config or tenant.config
        src, ver = self._load(name, version, model)
        gate = gate or CanaryGate()
        engine = self._build_engine(name, src, cfg,
                                    engine_name=f"{name}#canary")
        budget = aot_cache.WarmupBudget(
            f"{name}#canary", max_compiles=cfg.warmup_max_compiles,
            max_compile_seconds=cfg.warmup_max_compile_seconds)
        warm, truncated = self._warm_engine(
            f"{name}#canary", engine, cfg, budget)
        if truncated:
            tenant.warmup_truncated = True
        # the FaultPlan seeding discipline: the k-th draw is a pure
        # function of (seed, model) — replays route identically
        rng = random.Random(f"{self.seed}:{name}:canary")
        # the accuracy arm samples from its OWN pure (seed, model) stream:
        # enabling/disabling it leaves the routing draws byte-identical
        acc_rng = random.Random(f"{self.seed}:{name}:accuracy")
        with self._lock:
            tenant.canary = _Canary(ver, engine, src, fraction, gate, rng,
                                    gate.window, acc_rng=acc_rng)
            # fresh comparison windows for both arms: the gate judges
            # the canary against the incumbent's CONCURRENT behavior,
            # not against stale pre-canary history
            tenant.stats = _ArmStats(gate.window)
        telemetry.record_platform_event("canary_deploy", name)
        return {"model": name, "canary_version": ver, "warmup": warm,
                "fraction": fraction}

    def promote(self, name: str) -> dict:
        """Make the canary the primary: its weights publish into the
        (warmed) primary engine, the canary engine closes, the tenant
        records the new version. The primary engine is then re-warmed
        under the tenant's budget: for a same-conf version every bucket
        is a hit (no new envelope — the same invariant as :meth:`swap`),
        while a DIFFERENT-conf version (a quantized artifact promoted
        over its f32 incumbent) runs its own envelopes here instead of
        on first post-promote traffic."""
        tenant = self._tenant(name)
        with self._lock:
            canary = tenant.canary
            if canary is None:
                raise RuntimeError(f"model {name!r} has no canary")
            tenant.canary = None
        tenant.engine.publish(canary.src_model)
        warm, truncated = self._warm_engine(name, tenant.engine,
                                            tenant.config, tenant.budget)
        with self._lock:
            tenant.src_model = canary.src_model
            tenant.version = canary.version
            if truncated:
                tenant.warmup_truncated = True
        self._retire_canary_engine(canary)
        telemetry.record_platform_event("promote", name)
        return {"model": name, "version": canary.version, "warmup": warm}

    @staticmethod
    def _retire_canary_engine(canary: "_Canary") -> None:
        """Close the canary engine and zero its breaker's state gauge:
        the breaker object dies with the engine, and a dead breaker's
        last published ``dl4j_circuit_state`` (often "open" — that's why
        we rolled back) must not keep firing alerts for a model that is
        no longer shedding."""
        canary.engine.close()
        breaker = canary.engine.breaker
        if breaker is not None:
            telemetry.record_circuit_state(breaker.name, 0,
                                           transition=False)

    def rollback(self, name: str, reason: str = "operator") -> dict:
        """Drop the canary and return 100% of traffic to the incumbent
        (also the automatic gate-trip path). The registry still points
        at the incumbent version — nothing to restore, the canary never
        owned the tenant record."""
        tenant = self._tenant(name)
        with self._lock:
            canary = tenant.canary
            if canary is None:
                raise RuntimeError(f"model {name!r} has no canary")
            tenant.canary = None
            canary.rolled_back_at = tenant.request_seq
            canary.rollback_reason = reason
            tenant.last_rollback = {
                "version": canary.version,
                "at_request": canary.rolled_back_at,
                "reason": reason,
                "canary": {**canary.stats.snapshot(),
                           **canary.accuracy_snapshot()},
                "incumbent": tenant.stats.snapshot(),
            }
        self._retire_canary_engine(canary)
        telemetry.record_platform_event("canary_rollback", name)
        return dict(tenant.last_rollback, model=name)

    # --- routing ------------------------------------------------------------
    def _tenant(self, name: str) -> _Tenant:
        with self._lock:
            tenant = self._tenants.get(name)
            deployed = sorted(self._tenants)
        if tenant is None:
            raise UnknownModelError(
                f"unknown model {name!r} (deployed: {deployed or 'none'})")
        return tenant

    def engine(self, name: str) -> InferenceEngine:
        """The tenant's PRIMARY engine (tests, direct wiring)."""
        return self._tenant(name).engine

    def predict(self, name: str, *inputs, timeout_ms=...,
                traceparent=None):
        out, _ = self.predict_traced(name, *inputs, timeout_ms=timeout_ms,
                                     traceparent=traceparent)
        return out

    def predict_traced(self, name: str, *inputs, timeout_ms=...,
                       traceparent=None):
        """Route one request: pick the arm (seeded canary draw), run it
        through that arm's engine, record the outcome for the gate AND
        the tenant's SLO monitor, and evaluate the gate. Returns
        ``(outputs, trace-or-None)`` so the HTTP layer can echo the
        server-side traceparent. Raises exactly what the engine raises —
        the HTTP layer maps the classes; a canary failure still
        propagates to ITS caller (that request was the canary's to
        lose)."""
        tenant = self._tenant(name)
        with self._lock:
            tenant.request_seq += 1
            canary = tenant.canary
            use_canary = (canary is not None
                          and canary.rng.random() < canary.fraction)
        arm = canary if use_canary else tenant
        engine = canary.engine if use_canary else tenant.engine
        t0 = time.monotonic()
        try:
            out, trace = engine.predict_traced(
                *inputs, timeout_ms=timeout_ms, traceparent=traceparent)
        except Exception as e:
            # client errors (BadRequest & co) are the sender's
            # fault, and queue/host overload is LOAD, not model
            # badness — neither judges an arm (a traffic burst must
            # not roll back a healthy canary or mask a bad one by
            # inflating the incumbent's error rate). Launch errors,
            # timeouts, and the arm's own breaker shedding do count.
            # The SLO monitor applies the same exclusions: its error
            # objective judges the MODEL, not the sender or the load.
            judged = not isinstance(e, (ServerOverloadedError, ValueError))
            with self._lock:
                if judged:
                    arm.stats.record_locked(False, 0.0)
            if judged and self._slo is not None:
                self._slo.observe(name, ok=False)
            self._check_gate(tenant)
            raise
        dt = time.monotonic() - t0
        with self._lock:
            arm.stats.record_locked(True, dt)
        if use_canary and canary.gate.max_accuracy_delta is not None:
            # synchronous on the caller's thread: the gate sees the delta
            # BEFORE this request returns, so a regression rolls back at
            # the same request index across seeded replays
            self._shadow_accuracy(tenant, canary, inputs, out)
        if self._slo is not None:
            self._slo.observe(name, ok=True, seconds=dt)
        self._check_gate(tenant)
        return out, trace

    def _shadow_accuracy(self, tenant: _Tenant, canary: "_Canary",
                         inputs, out) -> None:
        """Accuracy arm: replay a sampled canary request through the
        incumbent ENGINE (not the platform router — the incumbent's gate
        arm must not see synthetic traffic) and fold the max-abs output
        delta into the canary record."""
        with self._lock:
            if canary.acc_rng is not None \
                    and canary.acc_rng.random() >= canary.gate.accuracy_sample:
                return
        try:
            ref = tenant.engine.predict(*inputs)
        except Exception:
            return  # incumbent hiccup: no accuracy verdict this request
        delta = _output_delta(out, ref)
        with self._lock:
            canary.accuracy_samples += 1
            canary.accuracy_last_delta = delta
            if delta > canary.accuracy_max_delta:
                canary.accuracy_max_delta = delta
        telemetry.record_canary_accuracy(tenant.name, delta)

    def _check_gate(self, tenant: _Tenant) -> None:
        with self._lock:
            canary = tenant.canary
            if canary is None:
                return
            reason = self._gate_reason_locked(tenant, canary)
        if reason is not None:
            try:
                self.rollback(tenant.name, reason=reason)
            except RuntimeError:
                pass  # a concurrent gate check rolled back first

    def _gate_reason_locked(self, tenant: _Tenant,
                            canary: _Canary) -> Optional[str]:
        gate = canary.gate
        st = canary.stats
        if gate.max_consecutive_failures is not None \
                and st.consecutive_failures >= gate.max_consecutive_failures:
            return (f"{st.consecutive_failures} consecutive canary "
                    "failures")
        if gate.trip_on_breaker_open and canary.engine.breaker is not None \
                and canary.engine.breaker.state == "open":
            return "canary circuit breaker open"
        if gate.max_accuracy_delta is not None \
                and canary.accuracy_max_delta > gate.max_accuracy_delta:
            # no min_requests wait: output divergence is deterministic
            # model badness, one confirmed sample is enough
            return (f"canary output delta {canary.accuracy_max_delta:.6g} "
                    f"> {gate.max_accuracy_delta:g} vs incumbent "
                    f"(accuracy arm, {canary.accuracy_samples} samples)")
        if st.requests < gate.min_requests:
            return None
        if gate.max_error_rate_delta is not None:
            delta = st.error_rate() - tenant.stats.error_rate()
            if delta > gate.max_error_rate_delta:
                return (f"canary error rate delta {delta:.3f} > "
                        f"{gate.max_error_rate_delta}")
        if gate.max_p95_ratio is not None:
            cp, ip = st.p95(), tenant.stats.p95()
            if cp is not None and ip is not None and ip > 0 \
                    and cp / ip > gate.max_p95_ratio:
                return (f"canary p95 {cp * 1e3:.1f}ms > "
                        f"{gate.max_p95_ratio}x incumbent "
                        f"{ip * 1e3:.1f}ms")
        return None

    # --- generation tenants -------------------------------------------------
    def deploy_generation(self, name: str, version: Optional[int] = None,
                          config=None, model=None) -> dict:
        """Bring one causal LM up as a GENERATION tenant (continuous-
        batching token loop instead of a request batcher): its own
        named :class:`~deeplearning4j_tpu_torch.parallel.generation.
        GenerationEngine` with a ``serving:<name>`` breaker, the scoped
        ``decode.launch:<name>`` fault site, and ``model=<name>``
        labels on the ``dl4j_decode_*`` series. Generation tenants
        share the platform's registry/versioning but not the canary
        router (a token loop has no per-request A/B to gate on — swap
        versions with :meth:`deploy_generation` again)."""
        from deeplearning4j_tpu_torch.parallel.generation import (
            GenerationEngine,
        )

        _check_name(name)
        src, ver = self._load(name, version, model)
        if not hasattr(src, "params") and hasattr(src, "decoder"):
            src = src.init(device=self.device)  # a zoo LM config
        engine = GenerationEngine(src, config, name=name)
        # generation tenants report TTFT + completion outcomes into the
        # platform's SLO monitor (the ttft_ms objective's only source)
        engine._slo = self._slo
        warm = engine.warmup()
        with self._lock:
            if self._closed:
                engine.close()
                raise RuntimeError("platform is closed")
            old = self._gen_tenants.get(name)
            self._gen_tenants[name] = (engine, ver)
        if old is not None:
            old[0].close()
        return {"model": name, "version": ver, "warmup": warm}

    def generate(self, name: str, tokens, **kw) -> list:
        with self._lock:
            ent = self._gen_tenants.get(name)
            deployed = sorted(self._gen_tenants)
        if ent is None:
            raise UnknownModelError(
                f"unknown generation model {name!r} "
                f"(deployed: {deployed or 'none'})")
        return ent[0].generate(tokens, **kw)

    # --- host-wide admission ------------------------------------------------
    def _host_admission(self, engine, rows: int) -> None:
        """Engine submit hook: one cap over the SUM of every tenant's
        pending queue. Raising :class:`HostOverloadedError` (a
        ServerOverloadedError) sheds with a host-scoped message."""
        cap = self.host_max_pending
        if cap is None:
            return
        with self._lock:
            tenants = list(self._tenants.values())
        total = 0
        for t in tenants:
            total += t.engine.queue_depth()
            if t.canary is not None:
                total += t.canary.engine.queue_depth()
        if total >= cap:
            telemetry.record_platform_event("host_rejected")
            raise HostOverloadedError(
                f"host overloaded: {total} requests pending across "
                f"{len(tenants)} models (cap {cap}); request shed")

    # --- introspection / lifecycle ------------------------------------------
    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def stats(self) -> dict:
        """Per-tenant operational snapshot: version, queue, breaker(s),
        canary + gate records, warmup budget spend — the ``/models``
        payload of ``InferenceServer(platform)``."""
        with self._lock:
            tenants = dict(self._tenants)
        out = {}
        for name, t in sorted(tenants.items()):
            breaker = t.engine.breaker
            row = {
                "version": t.version,
                "queue_depth": t.engine.queue_depth(),
                "breaker": breaker.state if breaker is not None else None,
                "requests": t.stats.requests,
                "warmup_budget": t.budget.snapshot(),
                "warmup_truncated": t.warmup_truncated,
            }
            if t.canary is not None:
                c = t.canary
                cb = c.engine.breaker
                row["canary"] = {
                    "version": c.version,
                    "fraction": c.fraction,
                    "queue_depth": c.engine.queue_depth(),
                    "breaker": cb.state if cb is not None else None,
                    **c.stats.snapshot(),
                    **(c.accuracy_snapshot()
                       if c.gate.max_accuracy_delta is not None else {}),
                }
            if t.last_rollback is not None:
                row["last_rollback"] = t.last_rollback
            out[name] = row
        with self._lock:
            gens = dict(self._gen_tenants)
        for name, (engine, ver) in sorted(gens.items()):
            breaker = engine.breaker
            out.setdefault(name, {})["generation"] = {
                "version": ver,
                "queue_depth": engine.queue_depth(),
                "breaker": breaker.state if breaker is not None else None,
            }
        if self._slo is not None:
            snap = self._slo.snapshot()
            for name, s in snap.items():
                out.setdefault(name, {})["slo"] = {
                    "state": s["state"],
                    "burn_rates": s["burn_rates"],
                    "since_index": s["since_index"],
                }
        return out

    def close(self) -> None:
        """Close every tenant engine. Idempotent."""
        with self._lock:
            self._closed = True
            tenants = list(self._tenants.values())
            self._tenants.clear()
            gens = list(self._gen_tenants.values())
            self._gen_tenants.clear()
        for t in tenants:
            self._close_tenant(t)
        for engine, _ in gens:
            engine.close()
        _PLATFORMS.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def live_platforms() -> List[ModelPlatform]:
    return list(_PLATFORMS)


def platforms_summary() -> List[dict]:
    """Stats for every live platform (the JAX package's UI ``/platform``
    payload; the port's UI is not ported)."""
    return [p.stats() for p in live_platforms()]


@telemetry.REGISTRY.register_collector
def _collect_platform_metrics(reg) -> None:
    """Scrape-time per-tenant gauges (same discipline as the serving
    queue-depth collector: live-object walk at scrape, no per-request
    cost): queue depth, canary flag, warmup envelopes and seconds."""
    for p in live_platforms():
        for name, row in p.stats().items():
            if "queue_depth" not in row:
                continue  # generation-only tenant: its own series cover it
            reg.gauge("dl4j_platform_queue_depth",
                      help="pending requests per tenant",
                      model=name).set(row["queue_depth"])
            reg.gauge("dl4j_platform_canary_active",
                      help="1 while a canary version takes traffic",
                      model=name).set(1 if "canary" in row else 0)
            wb = row["warmup_budget"]
            reg.gauge("dl4j_platform_warmup_compiles",
                      help="new envelopes charged to the tenant's "
                           "warmup budget", model=name).set(wb["compiles"])
            reg.gauge("dl4j_platform_warmup_compile_seconds",
                      model=name).set(wb["compile_seconds"])
