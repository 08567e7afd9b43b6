"""Content keys for model configurations, the serving envelope cache, and
per-tenant warmup budgets.

The JAX package's ``optimize/aot_cache.py`` compiles one XLA executable per
``(graph signature, step kind, input avals, donation set)`` and counts each
dispatch as a hit or a miss. PyTorch compiles nothing, so the port's
counterpart of "a compile" is the first forward of a model at a new
**envelope**: ``(graph signature, input shapes, input dtypes, device)`` —
the input shapes carry the padding bucket's rows. That first forward is
where the kernel library loads, cuDNN picks its algorithms for the shapes
and the kernel tuner's registry is looked up for them; later forwards at
the same envelope find all of that done. So:

- a **miss** is the first forward at an envelope this process has not run,
  a **hit** is any later one (:func:`stats` counts both; ``compile_seconds``
  sums the misses' wall time);
- a :class:`WarmupBudget` scoped over a thread (:func:`warmup_budget`)
  charges each miss on that thread, and a miss that would start with the
  budget exhausted raises :class:`WarmupBudgetExceeded` BEFORE the forward
  runs, as the JAX package raises before the compile; hits are free;
- the zero-recompile invariants of the reference read "zero new
  envelopes": ``stats()["misses"]`` stays flat across traffic whose
  envelopes warmup already ran.

The serving engine (``parallel.batcher.InferenceEngine``) and
``parallel.inference.ParallelInference`` run every forward through
:func:`run_envelope`. :func:`graph_signature` is also what
``nn.inference_opt`` uses to tie a calibration record to its graph.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Callable, Optional

_LOCK = threading.Lock()
# objects keyed by identity stay alive here, so a recycled address can never
# give a later object the same key
_ID_PINNED: list = []


def graph_signature(obj) -> str:
    """Stable content key for a model configuration: the sha1 of its repr
    when that repr is deterministic, else an identity key (two instances
    then never share). A repr holds every hyperparameter of the nested
    config dataclasses; ``...`` (numpy's elision of a large array) means
    the repr no longer identifies the config."""
    try:
        r = repr(obj)
    except Exception:  # an exotic repr: fall back to identity
        r = None
    if r and "..." not in r:
        return hashlib.sha1(r.encode()).hexdigest()
    with _LOCK:
        _ID_PINNED.append(obj)
    return f"id:{id(obj)}"


# --------------------------------------------------------------------------
# envelopes
# --------------------------------------------------------------------------

_ENVELOPES: set = set()
_STATS = {"hits": 0, "misses": 0, "compile_seconds": 0.0}


def envelope_key(signature: str, arrays, device) -> tuple:
    """The envelope of one forward: the model's graph signature, each
    input's shape and dtype, and the device it runs on."""
    return (signature,
            tuple(tuple(a.shape) for a in arrays),
            tuple(str(a.dtype) for a in arrays),
            str(device))


def run_envelope(key: tuple, fn: Callable):
    """Run ``fn()`` (one forward) under envelope ``key``: a hit when the
    key ran before, else a miss — charged to this thread's active
    :class:`WarmupBudget`, which refuses it before ``fn`` runs when
    exhausted. A miss whose forward raises is forgotten, so the next try
    is a miss again."""
    budget = active_budget()
    with _LOCK:
        miss = key not in _ENVELOPES
        if not miss:
            _STATS["hits"] += 1
        else:
            if budget is not None and not budget.allow():
                raise WarmupBudgetExceeded(
                    f"warmup budget {budget.name!r} exhausted "
                    f"({budget.compiles} new envelopes, "
                    f"{budget.compile_seconds:.3f} s): refused {key[1:]}")
            _ENVELOPES.add(key)
    if not miss:
        return fn()
    t0 = time.monotonic()
    try:
        out = fn()
    except BaseException:
        with _LOCK:
            _ENVELOPES.discard(key)
        raise
    dt = time.monotonic() - t0
    with _LOCK:
        _STATS["misses"] += 1
        _STATS["compile_seconds"] += dt
    if budget is not None:
        budget.charge(dt)
    return out


def stats() -> dict:
    """Envelope counters: ``hits``, ``misses`` (first forwards), the
    envelopes known (``entries``) and the misses' wall seconds."""
    with _LOCK:
        return {"hits": _STATS["hits"], "misses": _STATS["misses"],
                "entries": len(_ENVELOPES),
                "compile_seconds": round(_STATS["compile_seconds"], 3)}


def clear() -> None:
    """Forget every envelope and zero the counters (tests). Identity pins
    are released with them."""
    with _LOCK:
        _ENVELOPES.clear()
        _ID_PINNED.clear()
        _STATS.update(hits=0, misses=0, compile_seconds=0.0)


# --------------------------------------------------------------------------
# warmup budgets
# --------------------------------------------------------------------------

class WarmupBudgetExceeded(RuntimeError):
    """A new envelope requested under an exhausted :class:`WarmupBudget`
    scope was refused. Raised BEFORE the forward starts, so the budget
    bounds work, not just accounting."""


class WarmupBudget:
    """Per-tenant cap on warmup work (multi-tenant serving: one model's
    warmup storm — a huge bucket ladder, a conf churning graph keys — must
    not monopolize the host while its co-tenants wait to come up).

    Activate with :func:`warmup_budget`; while the scope is active on the
    current thread, every NEW envelope (a first forward) is charged to the
    budget, and one that would start with the budget exhausted raises
    :class:`WarmupBudgetExceeded` instead. Hits are free — a tenant whose
    envelopes already ran (same conf as a live version) warms at zero
    cost. Thread-local: live traffic on other threads never sees another
    tenant's budget. The field names (``compiles``, ``compile_seconds``)
    are the JAX package's, so one ``TenantConfig`` serves both.
    """

    def __init__(self, name: str, max_compiles: Optional[int] = None,
                 max_compile_seconds: Optional[float] = None):
        self.name = name
        self.max_compiles = max_compiles
        self.max_compile_seconds = max_compile_seconds
        self.compiles = 0
        self.compile_seconds = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """Whether another new envelope may start under this budget."""
        with self._lock:
            if self.max_compiles is not None \
                    and self.compiles >= self.max_compiles:
                return False
            if self.max_compile_seconds is not None \
                    and self.compile_seconds >= self.max_compile_seconds:
                return False
            return True

    def charge(self, seconds: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_seconds += float(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 3),
                "max_compiles": self.max_compiles,
                "max_compile_seconds": self.max_compile_seconds,
            }


_BUDGET_SCOPE = threading.local()


def active_budget() -> Optional[WarmupBudget]:
    """The :class:`WarmupBudget` active on this thread (or None)."""
    return getattr(_BUDGET_SCOPE, "active", None)


@contextlib.contextmanager
def warmup_budget(budget: WarmupBudget):
    """Scope ``budget`` over this thread's new envelopes (nesting restores
    the outer scope on exit)."""
    prev = active_budget()
    _BUDGET_SCOPE.active = budget
    try:
        yield budget
    finally:
        _BUDGET_SCOPE.active = prev
