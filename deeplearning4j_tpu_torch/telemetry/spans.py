"""Step-trace spans, as far as the data-parallel trainer calls them.

A part of the JAX package's ``telemetry/spans.py``: the canonical phase
names, the master switch, ``span`` (a bracket of one host-observable
phase of a step, recorded into a bounded ring) and the host-gap clock
(the time the host spends between step dispatches). PyTorch launches are
asynchronous like jax dispatch, and a span never waits for the card: its
duration is the host's time in the phase.

Disabled (the default), ``span(name)`` is one flag check returning a
shared no-op span.
"""

from __future__ import annotations

import collections
import threading
import time

PHASE_INGEST = "ingest"
PHASE_COMPUTE = "compute"
PHASE_GRAD_SYNC = "grad_sync"
PHASE_HOST_GAP = "host_gap"

_enabled = False
_ring: "collections.deque" = collections.deque(maxlen=4096)
_tls = threading.local()


class _NullSpan:
    """Shared disabled-mode span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _ring.append((self.name, self.t0, t1 - self.t0,
                      threading.get_ident()))
        return False


def span(name: str):
    """Bracket one phase of a step (``with span(PHASE_COMPUTE):``)."""
    return Span(name) if _enabled else _NULL


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _ring.clear()


def phase_stats() -> dict:
    """{phase: {"count", "total_ms", "mean_ms"}} over the recorded
    spans."""
    out = {}
    for name, _, dur, _ in list(_ring):
        s = out.setdefault(name, {"count": 0, "total_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += dur / 1e6
    for s in out.values():
        s["mean_ms"] = s["total_ms"] / s["count"]
    return out


# --------------------------------------------------------------------------
# host-gap tracking (PHASE_HOST_GAP): the fit loop brackets each dispatch
# with host_gap_close (the gap since the previous dispatch returned) and
# host_gap_open; host_gap_reset arms the clock at fit entry and
# host_gap_stop disarms it at fit exit
# --------------------------------------------------------------------------

def host_gap_reset() -> None:
    _tls.gap_open_ns = time.perf_counter_ns() if _enabled else None


def host_gap_open() -> None:
    if _enabled:
        _tls.gap_open_ns = time.perf_counter_ns()


def host_gap_close() -> None:
    if not _enabled:
        return
    t0 = getattr(_tls, "gap_open_ns", None)
    if t0 is None:
        return
    _tls.gap_open_ns = None
    _ring.append((PHASE_HOST_GAP, t0, time.perf_counter_ns() - t0,
                  threading.get_ident()))


def host_gap_stop() -> None:
    _tls.gap_open_ns = None
