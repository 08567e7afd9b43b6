"""Per-shape kernel autotuner + the persistent digest-verified tuning cache.

Counterpart of the JAX package's ``kernels/tuner.py``. The autotuner times
every legal tiling a registry kernel declares for one concrete ``(shape,
dtype, backend)`` envelope and records the winner into a process-global
:class:`TuningCache`. The cache persists to disk with the checkpoint
discipline (canonical JSON, a sha256 content digest recorded inside the
file, temp + ``os.replace`` publish), in the JAX package's file layout
``{"version", "winners", "digest"}``, so winners tuned in one process select
identically in the next, and a hand-edited or corrupt file is REFUSED with
a named error (:class:`TuningCacheCorruptError`) while the routes run each
kernel at its default tiling.

Every mutation bumps ``TuningCache.epoch``; the registry memoizes its
selections and per-kernel tuning digests against the epoch, so a routed
call's "has the winner set changed?" check is one dict lookup.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

CACHE_VERSION = 1

# default trial protocol: candidates are compared by min-of-`trials` time
# after `warmup` discarded runs (min is the standard autotuner statistic:
# noise only ever ADDS time)
DEFAULT_WARMUP = 1
DEFAULT_TRIALS = 3
DEFAULT_MAX_CANDIDATES = 16

# on the card a trial is the mean of _REPS back-to-back calls, queued while
# the stream is held by a _HOLD_CYCLES spin, so the events read the kernels'
# own time rather than the host's calls between them
_REPS = 10
_HOLD_CYCLES = 4_000_000  # ~2 ms at an H100's clock


class TuningCacheCorruptError(RuntimeError):
    """A persisted tuning cache failed its digest/format verification.
    The cache refuses the file's winners (the routes run each kernel at
    its default tiling); the error names the path and the reason."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"kernel tuning cache {path!r} refused: {reason}")
        self.path = path
        self.reason = reason


def _canonical(winners: dict) -> str:
    return json.dumps(winners, sort_keys=True, separators=(",", ":"))


def _digest(winners: dict) -> str:
    return hashlib.sha256(_canonical(winners).encode()).hexdigest()


class TuningCache:
    """``kernel_id -> {envelope_key -> {"tiling": [...], "ms": float,
    "backend": str}}`` with optional disk persistence.

    Thread-safe; ``epoch`` increments on every mutation (record / load /
    clear) so digest and selection consumers can memoize against it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._winners: Dict[str, Dict[str, dict]] = {}
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.path: Optional[str] = None

    # --- selection --------------------------------------------------------
    def winner(self, kernel_id: str, env_key: str) -> Optional[dict]:
        """The recorded winner for one envelope (None = untuned: the route
        runs the kernel at its default tiling)."""
        with self._lock:
            rec = self._winners.get(kernel_id, {}).get(env_key)
            if rec is None:
                self.misses += 1
            else:
                self.hits += 1
            return dict(rec) if rec is not None else None

    def winners(self, kernel_id: str) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v)
                    for k, v in self._winners.get(kernel_id, {}).items()}

    def entries(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._winners.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": sum(len(v) for v in self._winners.values()),
                "hits": self.hits,
                "misses": self.misses,
                "epoch": self.epoch,
                "path": self.path,
            }

    # --- mutation ---------------------------------------------------------
    def record(self, kernel_id: str, env_key: str, tiling: Tuple[int, ...],
               ms: float, backend: str = "") -> None:
        """Record one envelope's winning tiling (and persist when a path
        is bound)."""
        with self._lock:
            self._winners.setdefault(kernel_id, {})[env_key] = {
                "tiling": [int(t) for t in tiling],
                "ms": float(ms),
                "backend": backend,
            }
            self.epoch += 1
            if self.path is not None:
                self._save_locked()

    def clear(self) -> None:
        with self._lock:
            self._winners.clear()
            self.hits = self.misses = 0
            self.epoch += 1
            self.path = None

    # --- persistence ------------------------------------------------------
    def bind(self, path: str, load: bool = True) -> "TuningCache":
        """Attach a persistence path; an existing file is loaded (digest
        verified) and future records publish through it. A corrupt file
        raises :class:`TuningCacheCorruptError` AFTER resetting the
        in-memory winners: the process keeps running every kernel at its
        default tiling."""
        if load and os.path.exists(path):
            try:
                with open(path, "r") as f:
                    blob = json.load(f)
            except (OSError, ValueError) as e:
                self._refuse(path, f"unreadable JSON ({e})")
            if not isinstance(blob, dict) or "winners" not in blob \
                    or "digest" not in blob:
                self._refuse(path, "missing winners/digest fields")
            if int(blob.get("version", -1)) != CACHE_VERSION:
                self._refuse(path,
                             f"version {blob.get('version')!r} != "
                             f"{CACHE_VERSION}")
            if _digest(blob["winners"]) != blob["digest"]:
                self._refuse(path, "content digest mismatch")
            with self._lock:
                self._winners = {
                    str(k): {str(ek): dict(rec) for ek, rec in v.items()}
                    for k, v in blob["winners"].items()}
                self.epoch += 1
                self.path = path
        else:
            with self._lock:
                self.path = path
        return self

    def _refuse(self, path: str, reason: str) -> None:
        """Corruption: drop any half-loaded state, detach the path, and
        raise the NAMED error."""
        with self._lock:
            self._winners = {}
            self.epoch += 1
            self.path = None
        raise TuningCacheCorruptError(path, reason)

    def save(self) -> None:
        with self._lock:
            if self.path is None:
                raise ValueError("tuning cache has no bound path "
                                 "(call bind(path) first)")
            self._save_locked()

    def _save_locked(self) -> None:
        # the content digest recorded inside the file, a pid-suffixed temp
        # + os.replace publish: a crash mid-write leaves the prior complete
        # file authoritative, and two processes sharing one path never
        # interleave writes into one temp file
        blob = {
            "version": CACHE_VERSION,
            "winners": self._winners,
            "digest": _digest(self._winners),
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(blob, f, sort_keys=True, indent=1)
        os.replace(tmp, self.path)


# the process-global cache every selection reads
TUNING = TuningCache()


def set_tuning_cache(path: str, load: bool = True) -> TuningCache:
    """Bind the process-global tuning cache to ``path`` (loading an
    existing file, digest-verified). Raises
    :class:`TuningCacheCorruptError` on a refused file; the in-memory
    cache is then left EMPTY, so every route runs its kernel at the
    default tiling."""
    return TUNING.bind(path, load=load)


# --------------------------------------------------------------------------
# the autotune loop
# --------------------------------------------------------------------------

class AutotuneResult:
    """One envelope's sweep: the winning tiling and its time, the kernel's
    default tiling, and every candidate's ``{"tiling", "ms"}`` (or
    ``{"tiling", "error"}``)."""

    def __init__(self, kernel_id: str, env_key: str,
                 tiling: Tuple[int, ...], ms: float, trials: List[dict],
                 default: Optional[Tuple[int, ...]] = None):
        self.kernel_id = kernel_id
        self.env_key = env_key
        self.tiling = tiling
        self.ms = ms
        self.trials = trials
        self.default = default

    @property
    def default_ms(self) -> Optional[float]:
        for t in self.trials:
            if tuple(t["tiling"]) == tuple(self.default or ()):
                return t.get("ms")
        return None

    def __repr__(self):
        return (f"AutotuneResult({self.kernel_id}, {self.env_key}, "
                f"tiling={self.tiling}, ms={self.ms:.4f}, "
                f"{len(self.trials)} candidates)")


def _time_cpu(fn, args, warmup: int, trials: int) -> float:
    for _ in range(max(1, warmup)):
        fn(*args)
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _time_cuda(fn, args, warmup: int, trials: int) -> float:
    import torch

    for _ in range(max(1, warmup)):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(1, trials)):
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        for _ in range(_REPS):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / _REPS)
    return best


def autotune(kernel, env, cache: Optional[TuningCache] = None,
             warmup: int = DEFAULT_WARMUP, trials: int = DEFAULT_TRIALS,
             max_candidates: int = DEFAULT_MAX_CANDIDATES,
             record: bool = True) -> AutotuneResult:
    """Time ``kernel``'s legal tilings for one envelope and record the
    winner.

    ``kernel`` is a ``registry.Kernel``; ``env`` its envelope. Every
    candidate runs on the same seeded inputs (``make_inputs``): ``warmup``
    settle calls, then the minimum over ``trials``. On the card
    (``env.backend == "cuda"``) a trial is CUDA events on the current
    stream around ``_REPS`` back-to-back calls, queued behind a short spin
    so the events time the kernels, not the host. On the CPU the wrappers
    run their plain versions, timed with ``perf_counter``: those timings
    rank the plain version, not the kernel, so the CPU validates the
    machinery (sweep, winner record, persistence, digests) and real
    rankings need the card, as the JAX tuner's interpreter timings do.

    A candidate whose launch raises (a cluster the card cannot place, a
    tiling the launcher refuses) is recorded as a non-winner with its
    error; if every candidate fails, ``RuntimeError``.
    """
    from deeplearning4j_tpu_torch import telemetry

    cache = TUNING if cache is None else cache
    if not kernel.supports(env):
        raise ValueError(f"kernel {kernel.kernel_id!r} does not support "
                         f"envelope {env.key!r}")
    cands = kernel.candidates(env, limit=max_candidates)
    if not cands:
        raise ValueError(f"no legal tilings for envelope {env.key!r}")
    args = kernel.make_inputs(env, seed=0)
    timer = _time_cuda if env.backend == "cuda" else _time_cpu
    results = []
    for tiling in cands:
        fn = kernel.build(env, tiling)
        try:
            ms = timer(fn, args, warmup, trials)
        except Exception as e:
            results.append({"tiling": list(tiling), "error": repr(e)})
            telemetry.record_autotune_trial(kernel.kernel_id)
            continue
        results.append({"tiling": list(tiling), "ms": ms})
        telemetry.record_autotune_trial(kernel.kernel_id)
    timed = [r for r in results if "ms" in r]
    if not timed:
        raise RuntimeError(
            f"autotune: every candidate failed for {env.key!r}: {results}")
    win = min(timed, key=lambda r: r["ms"])
    if record:
        cache.record(kernel.kernel_id, env.key, tuple(win["tiling"]),
                     win["ms"], backend=env.backend)
        telemetry.record_autotune_winner(kernel.kernel_id)
        telemetry.record_tuning_cache(cache.hits, cache.entries())
    return AutotuneResult(kernel.kernel_id, env.key, tuple(win["tiling"]),
                          win["ms"], results,
                          default=tuple(kernel.default_tiling(env)))
