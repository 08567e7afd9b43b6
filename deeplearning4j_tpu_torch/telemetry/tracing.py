"""End-to-end request tracing: where did this REQUEST's time go.

A copy of the JAX package's ``telemetry/tracing.py``: one record per
request covering submit → terminal, with lifecycle events at every
scheduler stage (batcher: queued → admitted → grouped → launched →
demuxed → done/shed/expired).

Discipline:

- DISABLED (default) costs ONE module-flag check at submit: callers hold
  ``None`` and every helper here no-ops on ``None``. Nothing on the
  tracing path touches device values — events are ``monotonic_ns`` reads
  plus list appends, recorded by whichever host thread owns the request
  at that stage — so outputs are identical with tracing on or off.
- Trace ids are W3C ``traceparent``-shaped (32-hex trace id, 16-hex span
  id). Inbound headers are adopted; otherwise ids are minted as a pure
  function of ``(seed, submit counter)`` so two seeded replays mint
  IDENTICAL ids — which makes the tail sampler replay-deterministic too.
- Finished traces land in BOUNDED rings with deterministic tail
  sampling: abnormal terminals (anything but ok/done) are ALWAYS kept,
  the slowest-percentile traces are kept (nearest-rank threshold over a
  rolling duration window; count-gated so the rule is reproducible), and
  normal traces are head-sampled by trace-id hash (``1/sample_every``).
- ``finish_trace`` is idempotent: the FIRST terminal edge wins, so the
  dispatcher/watchdog/close races that :mod:`parallel.batcher` already
  resolves for result delivery cannot double-report a trace.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.telemetry.registry import nearest_rank

_enabled = False
_lock = threading.Lock()
_seed = 0
_counter = 0
_sample_every = 16
_slow_quantile = 0.95
_min_slow_samples = 16
_started = 0
_finished = 0
_dropped = 0
_kept: collections.deque = collections.deque(maxlen=256)   # abnormal
_slow: collections.deque = collections.deque(maxlen=256)   # slow tail
_ring: collections.deque = collections.deque(maxlen=256)   # head sample
_durations: collections.deque = collections.deque(maxlen=512)


class Trace:
    """One request's timeline: identity + ordered lifecycle events.

    Created by :func:`start_trace` (``None`` when tracing is disabled),
    carried on the request object across threads (submit thread →
    dispatcher/decode thread), finished exactly once by
    :func:`finish_trace`.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "index",
                 "t0_ns", "t1_ns", "status", "events", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, index: int,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.index = index
        self.t0_ns = time.monotonic_ns()
        self.t1_ns: Optional[int] = None
        self.status: Optional[str] = None
        self.events: List[Tuple[str, int, Optional[dict]]] = []
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}

    def event(self, name: str, attrs: Optional[dict] = None) -> None:
        self.events.append((name, time.monotonic_ns(), attrs))

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def duration_ms(self) -> Optional[float]:
        if self.t1_ns is None:
            return None
        return (self.t1_ns - self.t0_ns) / 1e6


# --------------------------------------------------------------------------
# W3C traceparent
# --------------------------------------------------------------------------

def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """``00-<32hex>-<16hex>-<2hex>`` → ``(trace_id, parent_span_id)``;
    malformed / all-zero / version ``ff`` headers are rejected (the
    request then mints a fresh root trace)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if ver == "ff" or set(tid) == {"0"} or set(sid) == {"0"}:
        return None
    return tid, sid


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------

def enable(seed: int = 0, ring_size: int = 256, sample_every: int = 16,
           slow_quantile: float = 0.95, duration_window: int = 512,
           min_slow_samples: int = 16) -> None:
    """Arm request tracing. Clears the rings and resets the id counter,
    so ``enable(seed=S)`` at the top of two replays yields identical
    trace ids AND identical sampling decisions."""
    global _enabled, _seed, _counter, _sample_every, _slow_quantile
    global _min_slow_samples, _kept, _slow, _ring, _durations
    global _started, _finished, _dropped
    with _lock:
        _seed = seed
        _counter = 0
        _sample_every = max(1, int(sample_every))
        _slow_quantile = slow_quantile
        _min_slow_samples = max(1, int(min_slow_samples))
        _kept = collections.deque(maxlen=ring_size)
        _slow = collections.deque(maxlen=ring_size)
        _ring = collections.deque(maxlen=ring_size)
        _durations = collections.deque(maxlen=duration_window)
        _started = _finished = _dropped = 0
    _enabled = True


def disable() -> None:
    """Disarm tracing. The rings survive so a bench can run, disable,
    then export."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear rings + counters; the enabled flag is untouched."""
    global _counter, _started, _finished, _dropped
    with _lock:
        _counter = 0
        _started = _finished = _dropped = 0
        _kept.clear()
        _slow.clear()
        _ring.clear()
        _durations.clear()


def start_trace(name: str, traceparent: Optional[str] = None,
                attrs: Optional[dict] = None) -> Optional[Trace]:
    """Mint (or adopt, when ``traceparent`` parses) a request trace.
    Returns ``None`` when tracing is disabled — the one flag check the
    disabled path pays."""
    if not _enabled:
        return None
    global _counter, _started
    parent_id = None
    tid = None
    parsed = parse_traceparent(traceparent) if traceparent else None
    if parsed is not None:
        tid, parent_id = parsed
    with _lock:
        n = _counter
        _counter += 1
        _started += 1
    h = hashlib.sha256(f"{_seed}:{n}".encode()).hexdigest()
    if tid is None:
        tid = h[:32]
    return Trace(tid, h[32:48], parent_id, name, n, attrs)


def trace_event(trace: Optional[Trace], name: str,
                attrs: Optional[dict] = None) -> None:
    if trace is None:
        return
    trace.event(name, attrs)


def finish_trace(trace: Optional[Trace], status: str,
                 attrs: Optional[dict] = None) -> None:
    """Terminal edge: stamp status + end time and run the tail sampler.
    Idempotent — the first terminal edge wins, later calls no-op."""
    if trace is None:
        return
    global _finished, _dropped
    with _lock:
        if trace.status is not None:
            return
        trace.status = status
        trace.t1_ns = time.monotonic_ns()
        if attrs:
            trace.attrs.update(attrs)
        _finished += 1
        dur = trace.t1_ns - trace.t0_ns
        _durations.append(dur)
        if status not in ("ok", "done"):
            _kept.append(trace)
        elif len(_durations) >= _min_slow_samples \
                and dur >= nearest_rank(sorted(_durations),
                                        _slow_quantile):
            _slow.append(trace)
        elif int(trace.trace_id[:8], 16) % _sample_every == 0:
            _ring.append(trace)
        else:
            _dropped += 1


# --------------------------------------------------------------------------
# read side
# --------------------------------------------------------------------------

def traces() -> List[Trace]:
    """Every retained trace (abnormal + slow tail + head sample), in
    submit order."""
    with _lock:
        out = list(_kept) + list(_slow) + list(_ring)
    return sorted(out, key=lambda t: t.t0_ns)


def stats() -> dict:
    with _lock:
        return {
            "enabled": _enabled, "started": _started,
            "finished": _finished, "dropped": _dropped,
            "kept_abnormal": len(_kept), "kept_slow": len(_slow),
            "kept_sampled": len(_ring), "seed": _seed,
            "sample_every": _sample_every,
        }
