"""Deterministic fault injection.

A copy of the JAX package's ``resilience/faults.py`` (which imports no
jax), with every site and the same seeded streams, so one ``FaultPlan``
fires at the same invocation indices in both packages. The corrupt action
NaN-poisons numpy arrays and torch tensors alike.

Production traffic is defined by partial failure — a preempted
worker, a full disk mid-checkpoint, a wedged serving launch — and none
of those can be regression-tested if they only ever happen by accident.
This module makes failure a first-class, *seedable* input: product code
carries permanent one-line ``fault_point(site)`` hooks (a no-op module
check when no plan is armed, the same discipline as telemetry spans),
and a test arms a :class:`FaultPlan` that raises, delays, or
NaN-poisons on exactly the invocations it chose.

Named sites (the permanent hooks in product code)::

    checkpoint.write     util.serializer.write_model, mid-zip-assembly
                         (a raise here IS a partial write: the temp file
                         holds some entries, the publish never happens)
    ingest.device_put    datasets.prefetch.DeviceRingIterator staging
    train.step           nn.multilayer / nn.graph / parallel.wrapper,
                         once per optimization step, before the compiled
                         step launches (corrupt mode poisons the batch)
    serving.launch       parallel.batcher dispatcher, before the shared
                         forward (delay mode simulates a stuck launch —
                         the watchdog's test vector)
    decode.launch        parallel.generation decode loop, before each
                         prefill/decode dispatch (the generation
                         breaker's test vector)
    stats.flush          ui.stats remote-router delivery attempt
    model.load           parallel.platform.ModelRegistry.load, after
                         the version resolves and before the zip is
                         digest-verified + restored (raise = a failed
                         load that must leave the incumbent serving;
                         retried by MODEL_LOAD_RETRY)
    model.swap           parallel.platform.ModelPlatform.swap, after
                         the new version loaded and before it is
                         published into the serving engine (raise =
                         partial swap, incumbent keeps serving; delay =
                         wedged swap, traffic must flow throughout)
    snapshot.shard_write resilience.pod.write_pod_snapshot, inside one
                         host's shard file assembly, before the atomic
                         publish (a raise IS a partial shard on that
                         host: temp bytes exist, no host manifest
                         references them, the coordinator manifest is
                         never committed — the prior complete snapshot
                         stays authoritative)
    pod.heartbeat        resilience.session pod-mode fit loop, once per
                         batch (raise HostDeathError(host=k) here = a
                         FaultPlan-seeded host death; the session
                         treats it as resumable and the whole job
                         resumes from the last distributed snapshot)

The port's product code carries every one of these hooks, at the same
places as the JAX package's.

Per-model scoping: an engine constructed with ``name=`` fires
``serving.launch:<name>`` / ``decode.launch:<name>`` instead of the
bare site, so a chaos plan can degrade exactly one tenant of a
multi-model host (``ModelPlatform``) while its co-tenants stay clean.

Usage::

    plan = FaultPlan(seed=7)
    plan.inject("checkpoint.write", on_calls=[2],
                exc=lambda: OSError(errno.ENOSPC, "No space left"))
    plan.inject("train.step", probability=0.1, action="corrupt")
    with plan.armed():
        ...   # the run under test

Determinism: ``on_calls`` fires on exact 1-based invocation indices;
``probability`` draws from a per-(seed, site) ``random.Random`` stream,
so two plans with the same seed arm the same invocation sequence. One
plan is armed per process at a time (nesting raises — a chaos run whose
faults silently shadow each other proves nothing). Every fire counts
into ``dl4j_faults_injected_total{site=...}``.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Callable, Iterable, List, Optional

#: The permanent hooks product code carries (documentation + typo guard;
#: ``inject`` warns on unknown sites but does not reject them, so a plan
#: can target sites added by downstream code).
SITES = (
    "checkpoint.write",
    "ingest.device_put",
    "train.step",
    "serving.launch",
    "decode.launch",
    "stats.flush",
    "model.load",
    "model.swap",
    "snapshot.shard_write",
    "pod.heartbeat",
)


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
    __slots__ = ("site", "on_calls", "probability", "action", "exc",
                 "delay_s", "max_fires", "fired", "_rng")

    def __init__(self, site, on_calls, probability, action, exc, delay_s,
                 max_fires, seed):
        self.site = site
        self.on_calls = frozenset(int(c) for c in on_calls) \
            if on_calls is not None else None
        self.probability = probability
        self.action = action
        self.exc = exc
        self.delay_s = float(delay_s)
        self.max_fires = max_fires
        self.fired = 0
        # per-(seed, site) stream: the k-th invocation's draw is the same
        # number in every run with this seed
        self._rng = random.Random(f"{seed}:{site}:{action}")

    def should_fire(self, invocation: int) -> bool:
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.on_calls is not None:
            return invocation in self.on_calls
        if self.probability is not None:
            return self._rng.random() < self.probability
        return True  # no selector: every invocation

    def make_exc(self, invocation: int) -> BaseException:
        if self.exc is None:
            return InjectedFault(self.site, invocation)
        if isinstance(self.exc, BaseException):
            return self.exc
        return self.exc()  # class or factory


def _poison(value):
    """NaN-poison an array-ish value (corrupt mode): a float numpy array or
    torch tensor gets a NaN in element 0 of a copy, everything else passes
    through unchanged (uint8 image batches cannot hold a NaN — poisoning
    them is a different fault class the caller can model with
    ``action="raise"``)."""
    import numpy as np

    if value is None:
        return None
    if type(value).__module__.startswith("torch"):
        if not value.is_floating_point() or value.numel() == 0:
            return value
        out = value.clone()
        # the logical first element (a channels-last image batch has no
        # flat view): the element the JAX package's NHWC batch poisons
        out[(0,) * out.ndim] = float("nan")
        return out
    try:
        arr = np.array(value, copy=True)
    except Exception:
        return value
    if arr.size == 0 or not np.issubdtype(arr.dtype, np.floating):
        return value
    arr.reshape(-1)[0] = np.nan
    return arr


class FaultPlan:
    """A seedable set of armed injection sites. Build with chained
    :meth:`inject` calls, activate with :meth:`armed` (context manager)
    or :meth:`arm` / :meth:`disarm`."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._specs: List[_FaultSpec] = []
        self._invocations: dict = {}
        self._lock = threading.Lock()

    def inject(self, site: str,
               on_calls: Optional[Iterable[int]] = None,
               probability: Optional[float] = None,
               action: str = "raise",
               exc: Optional[Callable[[], BaseException]] = None,
               delay_s: float = 0.05,
               max_fires: Optional[int] = None) -> "FaultPlan":
        """Arm ``site``. Selector: ``on_calls`` (1-based invocation
        indices) or ``probability`` (seeded per-site stream) or neither
        (every invocation). ``action``: ``"raise"`` (throw ``exc`` —
        class, factory, or instance; default :class:`InjectedFault`),
        ``"delay"`` (sleep ``delay_s`` then proceed), ``"corrupt"``
        (NaN-poison the hook's value). ``max_fires`` caps total fires."""
        if action not in ("raise", "delay", "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        if on_calls is not None and probability is not None:
            raise ValueError("choose on_calls OR probability, not both")
        self._specs.append(_FaultSpec(
            site, on_calls, probability, action, exc, delay_s, max_fires,
            self.seed))
        return self

    # --- arming -------------------------------------------------------------
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

    # --- introspection ------------------------------------------------------
    def invocations(self, site: str) -> int:
        """How many times ``site``'s hook ran while this plan was armed."""
        return self._invocations.get(site, 0)

    def fired(self, site: str = None) -> int:
        """Total faults fired (optionally for one site)."""
        return sum(s.fired for s in self._specs
                   if site is None or s.site == site)

    # --- the hook's slow path ----------------------------------------------
    def _hit(self, site: str, value):
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
            if s.action == "delay":
                time.sleep(s.delay_s)
            elif s.action == "corrupt":
                value = _poison(value)
        return value


_ARM_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def fault_point(site: str, value=None):
    """The permanent product-code hook: returns ``value`` untouched when
    no plan is armed (one module-global check — the disarmed cost), else
    routes through the armed plan (which may raise, sleep, or return a
    poisoned copy of ``value``)."""
    plan = _ACTIVE
    if plan is None:
        return value
    return plan._hit(site, value)


def _record_injected(site: str, action: str) -> None:
    # lazy import: the disarmed hot path never touches telemetry, and
    # faults.py stays import-cycle-free for the modules that hook it
    from deeplearning4j_tpu_torch import telemetry

    telemetry.record_fault_injected(site, action)
