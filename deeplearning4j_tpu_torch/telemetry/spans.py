"""Step-trace spans: where a step's time goes.

Counterpart of the JAX package's ``telemetry/spans.py``. A span brackets
one host-observable phase of a training step::

    with telemetry.span("ingest"):
        features, labels = stage(batch)
    with telemetry.span("compute") as sp:
        loss = sp.set_result(train_step(...))

Finished spans land in a bounded ring (``enable(ring_size=)``), exported
as Chrome-trace JSON (:func:`export_chrome_trace`), listed by
:func:`events` or aggregated into per-phase percentiles
(:func:`phase_stats`). PyTorch launches are asynchronous, like jax
dispatch: a span around a launch records the host's time in the phase.
``enable(sync=True)`` makes a span wait for the CUDA tensor registered with
``set_result`` before it closes, so its duration covers the device work
(one synchronization a span; keep it off for throughput runs).

The host-gap clock (``host_gap_*``) records the time the host spends
between step launches; ``host_gap_pause`` / ``host_gap_resume`` exclude an
intentional wait from it.

Disabled (the default), ``span(name)`` is one flag check returning a
shared no-op span.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry.registry import nearest_rank

PHASE_INGEST = "ingest"
PHASE_COMPUTE = "compute"
PHASE_GRAD_SYNC = "grad_sync"
PHASE_HOST_GAP = "host_gap"

_enabled = False
_sync = False
# (name, start ns, duration ns, depth, parent, thread, attrs)
_ring: "collections.deque" = collections.deque(maxlen=4096)
_tls = threading.local()


class _NullSpan:
    """Shared disabled-mode span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_result(self, x):
        return x

    def annotate(self, **kw):
        return self


NULL_SPAN = _NullSpan()


def _wait_for(x) -> None:
    """Wait for the device work that produces ``x`` (a tensor, or a
    nested dict / list / tuple of them); anything else times as it is."""
    import torch

    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            _wait_for(v)
        return
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class Span:
    __slots__ = ("name", "t0", "t1", "depth", "parent", "_result", "attrs")

    def __init__(self, name: str):
        self.name = name
        self.t0 = self.t1 = 0
        self.depth = 0
        self.parent: Optional[str] = None
        self._result = None
        self.attrs: Optional[dict] = None

    def set_result(self, x):
        """Register the phase's device output; returned unchanged. In sync
        mode the span waits for it before closing."""
        self._result = x
        return x

    def annotate(self, **kw):
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(kw)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if _sync and self._result is not None:
            _wait_for(self._result)
        self.t1 = time.perf_counter_ns()
        self._result = None  # never pin device tensors in the ring
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        _ring.append((self.name, self.t0, self.t1 - self.t0, self.depth,
                      self.parent, threading.get_ident(), self.attrs))
        return False


def span(name: str):
    """Bracket one phase of a step (``with span(PHASE_COMPUTE):``)."""
    return Span(name) if _enabled else NULL_SPAN


# --------------------------------------------------------------------------
# host-gap tracking (PHASE_HOST_GAP): the fit loop brackets each launch
# with host_gap_close (the gap since the previous launch returned,
# annotated with the steps the next launch covers) and host_gap_open;
# host_gap_reset arms the clock at fit entry and host_gap_stop disarms it
# at fit exit
# --------------------------------------------------------------------------

def host_gap_reset() -> None:
    _tls.gap_open_ns = time.perf_counter_ns() if _enabled else None


def host_gap_open() -> None:
    if _enabled:
        _tls.gap_open_ns = time.perf_counter_ns()


def host_gap_close(steps: int = 1) -> None:
    if not _enabled:
        return
    t0 = getattr(_tls, "gap_open_ns", None)
    if t0 is None:
        return
    _tls.gap_open_ns = None
    _ring.append((PHASE_HOST_GAP, t0, time.perf_counter_ns() - t0, 0, None,
                  threading.get_ident(), {"steps": int(steps)}))


def host_gap_stop() -> None:
    _tls.gap_open_ns = None


def host_gap_pause() -> None:
    """An intentional host wait starts (a drain on queued device
    results): stop the gap clock so the wait is not billed as gap."""
    if _enabled and getattr(_tls, "gap_open_ns", None) is not None:
        _tls.gap_pause_ns = time.perf_counter_ns()


def host_gap_resume() -> None:
    """The intentional wait ended: move the gap's origin forward by it."""
    t0 = getattr(_tls, "gap_pause_ns", None)
    if t0 is not None:
        _tls.gap_pause_ns = None
        if _enabled and getattr(_tls, "gap_open_ns", None) is not None:
            _tls.gap_open_ns += time.perf_counter_ns() - t0


def enable(sync: bool = False, ring_size: int = 4096) -> None:
    """Turn span recording on; ``sync`` makes spans wait for their
    registered result (one synchronization a span)."""
    global _enabled, _sync, _ring
    if ring_size != _ring.maxlen:
        _ring = collections.deque(_ring, maxlen=int(ring_size))
    _sync = bool(sync)
    _enabled = True


def disable() -> None:
    """Turn recording off (the ring is kept, so traces stay exportable)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def sync_mode() -> bool:
    return _enabled and _sync


def reset() -> None:
    _ring.clear()


def events() -> List[dict]:
    """Finished spans, oldest first, as dicts (ns timestamps)."""
    return [{"name": n, "start_ns": t0, "duration_ns": dur, "depth": depth,
             "parent": parent, "thread": tid,
             **({"attrs": attrs} if attrs else {})}
            for (n, t0, dur, depth, parent, tid, attrs) in list(_ring)]


def phase_stats() -> Dict[str, dict]:
    """``{phase: {count, total_ms, mean_ms, p50_ms, p95_ms, p99_ms,
    max_ms}}`` over the recorded spans, sorted by name."""
    per: Dict[str, List[int]] = {}
    for (name, _t0, dur, _d, _p, _tid, _a) in list(_ring):
        per.setdefault(name, []).append(dur)
    out = {}
    for name in sorted(per):
        ds = sorted(per[name])
        total = sum(ds)
        out[name] = {
            "count": len(ds),
            "total_ms": total / 1e6,
            "mean_ms": total / len(ds) / 1e6,
            "p50_ms": nearest_rank(ds, 0.50) / 1e6,
            "p95_ms": nearest_rank(ds, 0.95) / 1e6,
            "p99_ms": nearest_rank(ds, 0.99) / 1e6,
            "max_ms": ds[-1] / 1e6,
        }
    return out


def export_chrome_trace(path: str) -> str:
    """Write the ring as Chrome-trace JSON (complete "X" events in µs),
    loadable in chrome://tracing or Perfetto. Returns ``path``."""
    pid = os.getpid()
    evts = []
    for (name, t0, dur, depth, parent, tid, attrs) in list(_ring):
        args = {"depth": depth}
        if parent:
            args["parent"] = parent
        if attrs:
            args.update(attrs)
        evts.append({"name": name, "ph": "X", "ts": t0 / 1e3,
                     "dur": dur / 1e3, "pid": pid, "tid": tid,
                     "args": args})
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": evts, "displayTimeUnit": "ms"}, f)
    return path
