"""Dynamic cross-request micro-batching for serving.

Counterpart of the JAX package's ``parallel/batcher.py`` with the same
queue, dispatcher and demux. Reference: ``org.deeplearning4j.parallelism
.inference`` — caller threads hand ``ParallelInference`` observations, an
``ObservablesProvider`` coalesces them, a worker runs one batched forward,
and each caller's observable is signalled with its slice. Concurrent
requests share one padded forward on the device; the padding is quantized
to power-of-two buckets, and ``warmup()`` runs every bucket once so the
first real request of each size finds the kernel library built and cuDNN's
algorithms chosen (eager PyTorch has no compile cache to fill).

Policies (the same knobs as the JAX package):

- ``max_batch``: rows per launch; the queue drains until the next request
  would overflow it (a single larger request still launches alone).
- ``settle_ms`` / ``max_delay_ms``: continuous batching — once the queue
  goes one settle window without growing, the batch launches immediately;
  ``max_delay_ms`` is the hard linger ceiling for the oldest request.
- ``max_queue`` / per-request deadlines: a full queue rejects at submit
  (HTTP 503 upstream) and a request whose deadline passes while queued is
  expired without ever joining a shared launch.
- a circuit breaker sheds while launches keep failing, one transient-class
  retry precedes a failure, and an optional watchdog fails a stuck launch's
  waiters and hands the queue to a fresh dispatcher.

Requests are grouped by (trailing shape, dtype) signature — ragged batch
SIZES share launches, heterogeneous shapes/dtypes each get their own, and a
malformed request fails at ``submit`` with :class:`BadRequestError` for its
sender only.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from deeplearning4j_tpu_torch.resilience.retry import SERVING_RETRY
from deeplearning4j_tpu_torch.telemetry import tracing

_FAULT_SITE = "serving.launch"


class BadRequestError(ValueError):
    """Client-side problem (shape/dtype/arity mismatch) — maps to HTTP
    400. Raised at submit, BEFORE the request joins a shared batch."""


class ServerOverloadedError(RuntimeError):
    """Admission control: the pending queue is at ``max_queue`` — maps to
    HTTP 503."""


class DeadlineExpiredError(RuntimeError):
    """The request's deadline passed while it waited in the queue — maps
    to HTTP 503."""


class LaunchTimeoutError(RuntimeError):
    """The launch watchdog fired: a shared forward exceeded
    ``launch_timeout_ms``. The stuck launch's waiters get this (HTTP 503)
    and a replacement dispatcher keeps draining the queue."""


@dataclasses.dataclass
class BatchingConfig:
    """Dispatcher policy knobs (reference ``ParallelInference.Builder``
    ``batchLimit``/``queueLimit``, plus deadline admission control)."""

    max_batch: int = 64        # rows per shared launch (bucket ceiling)
    max_delay_ms: float = 2.0  # linger for batch fill before ragged launch
    max_queue: int = 256       # pending requests before 503 rejection
    timeout_ms: Optional[float] = None  # default per-request deadline
    # continuous batching: launch once no new rows arrived within one
    # settle window; 0 disables early launch
    settle_ms: float = 0.2
    # launch watchdog: a shared forward running longer than this fails its
    # waiters with LaunchTimeoutError (503); None disables
    launch_timeout_ms: Optional[float] = None


_ENGINE_SEQ = itertools.count(1)  # default breaker names: serving-1, -2, ...


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def bucket_rows(n: int) -> int:
    """Padding bucket for an ``n``-row launch: the smallest ``2**k >= n``."""
    return next_pow2(int(n))


def bucket_ladder(max_batch: int) -> List[int]:
    """Every bucket a <=``max_batch``-row request can land in (what
    ``warmup()`` runs)."""
    out = []
    b = 1
    while True:
        out.append(b)
        if b >= max_batch:
            return out
        b *= 2


class _Request:
    __slots__ = ("xs", "n", "group", "event", "result", "error", "deadline",
                 "t0", "trace")

    def __init__(self, xs, n, group, deadline, t0, trace=None):
        self.xs = xs
        self.n = n
        self.group = group
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.deadline = deadline
        self.t0 = t0
        # request trace (telemetry.tracing) or None when tracing is off;
        # finished exactly once on the first terminal edge
        self.trace = trace


def _input_types(model):
    """The model conf's per-input InputTypes (a ComputationGraph's
    ``input_types``, a MultiLayerNetwork's one ``input_type``), or None
    when unreadable."""
    conf = getattr(model, "conf", None)
    if conf is None:
        return None
    if hasattr(conf, "network_inputs"):
        types = list(getattr(conf, "input_types", ()) or ())
        if len(types) != len(conf.network_inputs):
            return [None] * len(conf.network_inputs)
        return types
    if getattr(conf, "input_type", None) is not None:
        return [conf.input_type]
    return None


def _input_templates(model):
    """Per-input trailing shapes (the JAX package's NHWC for images) from
    the model's conf, None per input the conf cannot pin, or None when the
    model has no readable conf at all."""
    from deeplearning4j_tpu_torch.conf import inputs as it

    types = _input_types(model)
    if types is None:
        return None

    def shape_of(t):
        if isinstance(t, it.FeedForward):
            return (t.size,)
        if isinstance(t, it.Convolutional):
            return (t.height, t.width, t.channels)
        if isinstance(t, it.ConvolutionalFlat):
            return (t.height * t.width * t.channels,)
        if isinstance(t, it.Convolutional3D):
            return (t.depth, t.height, t.width, t.channels)
        if isinstance(t, it.Recurrent) and t.timesteps > 0:
            return (t.timesteps, t.size)
        return None

    return [shape_of(t) for t in types]


class InferenceEngine:
    """Dynamic micro-batching front of one model's forward.

    Usage::

        engine = InferenceEngine(net, BatchingConfig(max_batch=32))
        engine.warmup()                      # run every bucket once
        y = engine.predict(x)                # thread-safe, shares launches
        engine.close()

    ``model`` is anything exposing ``output(*arrays)`` and ``conf`` — a
    ``ComputationGraph`` or a ``MultiLayerNetwork`` (a quantized artifact
    included). ``graph_opt=True`` (default) serves the
    ``nn.inference_opt.optimize_for_inference`` copy, whose params a
    training original never touches (a MultiLayerNetwork's BNs folded and
    dropout pruned; a quantized artifact copied untouched); ``bf16=True``
    additionally serves the forward in bfloat16 with float32 outputs.
    """

    def __init__(self, model, config: Optional[BatchingConfig] = None,
                 graph_opt: bool = True, bf16: bool = False,
                 breaker: Optional[CircuitBreaker] = ...,
                 retry=...):
        self.config = config or BatchingConfig()
        # circuit breaker on the launch path: consecutive failures trip it
        # open and submits shed with CircuitOpenError (503); None disables
        self._breaker = (CircuitBreaker(name=f"serving-{next(_ENGINE_SEQ)}")
                         if breaker is ... else breaker)
        # one transient-class retry before a launch failure reaches the
        # breaker; model bugs (ValueError & co) are never retried
        self._retry = SERVING_RETRY if retry is ... else retry
        if graph_opt:
            from deeplearning4j_tpu_torch.nn.inference_opt import (
                optimize_for_inference,
            )

            model = optimize_for_inference(model, bf16=bf16)
        self.model = model
        conf = getattr(model, "conf", None)
        self._np_dtype = np.dtype(getattr(conf, "dtype", "float32"))
        self._templates = _input_templates(model)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._batch_seq = itertools.count(1)  # trace launch ids
        telemetry.register_serving_engine(self)

    # --- submit / wait ------------------------------------------------------
    def _validate(self, inputs: Sequence) -> Tuple[tuple, int, tuple]:
        if not inputs:
            raise BadRequestError("at least one input array required")
        if self._templates is not None and \
                len(inputs) != len(self._templates):
            raise BadRequestError(
                f"model takes {len(self._templates)} input array(s), "
                f"got {len(inputs)}")
        xs = []
        for i, a in enumerate(inputs):
            try:
                a = np.asarray(a)
            except (ValueError, TypeError) as e:
                raise BadRequestError(f"malformed input array: {e}")
            if a.dtype == object:
                raise BadRequestError("malformed input array: ragged")
            # uint8 rides to the device as-is (dequantized there);
            # floats/ints take the network dtype
            if a.dtype != np.uint8 and a.dtype != self._np_dtype:
                try:
                    a = np.asarray(a, self._np_dtype)
                except (ValueError, TypeError) as e:
                    raise BadRequestError(f"malformed input array: {e}")
            if a.ndim < 1 or a.shape[0] < 1:
                raise BadRequestError("input needs a non-empty batch dim")
            tmpl = (self._templates[i]
                    if self._templates is not None else None)
            if tmpl is not None and tuple(a.shape[1:]) != tuple(tmpl):
                raise BadRequestError(
                    f"input {i} shape {tuple(a.shape[1:])} does not match "
                    f"model input shape {tuple(tmpl)}")
            xs.append(a)
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs):
            raise BadRequestError("inputs disagree on batch size")
        group = tuple((a.shape[1:], a.dtype.str) for a in xs)
        return tuple(xs), n, group

    def submit(self, inputs: Sequence, timeout_ms=...,
               traceparent: Optional[str] = None) -> _Request:
        """Validate and enqueue one request; returns a handle whose
        ``event`` fires when the result (or error) is in. Raises
        :class:`BadRequestError` / :class:`ServerOverloadedError` /
        :class:`CircuitOpenError` synchronously — a bad request never
        enters the shared queue."""
        if timeout_ms is ...:
            timeout_ms = self.config.timeout_ms
        trace = tracing.start_trace("predict", traceparent=traceparent)
        try:
            xs, n, group = self._validate(inputs)
        except BadRequestError:
            telemetry.record_serving_request("bad_request")
            tracing.finish_trace(trace, "bad_request")
            raise
        t0 = time.monotonic()
        deadline = t0 + timeout_ms / 1000.0 if timeout_ms else None
        req = _Request(xs, n, group, deadline, t0, trace)
        tracing.trace_event(trace, "queued", {"rows": n} if trace else None)
        with self._cond:
            if self._stop:
                tracing.finish_trace(trace, "shutdown")
                raise RuntimeError("engine is closed")
            if len(self._queue) >= self.config.max_queue:
                telemetry.record_serving_request("rejected")
                tracing.finish_trace(trace, "rejected")
                raise ServerOverloadedError(
                    f"serving queue full ({self.config.max_queue} pending)")
            # breaker check LAST: a request rejected for being malformed
            # or for overload must not consume a half-open probe ticket
            if self._breaker is not None and not self._breaker.allow():
                telemetry.record_serving_request("shed")
                tracing.finish_trace(trace, "shed")
                raise CircuitOpenError(
                    f"circuit breaker {self._breaker.name!r} is "
                    f"{self._breaker.state}; request shed")
            self._queue.append(req)
            tracing.trace_event(trace, "admitted")
            self._cond.notify_all()
        self._ensure_thread()
        return req

    def result(self, req: _Request):
        """Block until ``req`` completes; returns the model output slice
        for this request (same single-array/list convention as
        ``model.output``) or raises the request's error."""
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def predict(self, *inputs, timeout_ms=..., traceparent=None):
        """Synchronous request: enqueue, share a launch, demux."""
        return self.result(self.submit(inputs, timeout_ms=timeout_ms,
                                       traceparent=traceparent))

    def predict_traced(self, *inputs, timeout_ms=..., traceparent=None):
        """``predict`` that also returns the request's trace (or None when
        tracing is disabled) — the HTTP server echoes its traceparent."""
        req = self.submit(inputs, timeout_ms=timeout_ms,
                          traceparent=traceparent)
        return self.result(req), req.trace

    # --- warmup -------------------------------------------------------------
    def buckets(self) -> List[int]:
        return bucket_ladder(self.config.max_batch)

    def warmup(self, shapes=None) -> dict:
        """Run one zeros forward per padding bucket and per client-visible
        input dtype (float and, for image inputs, uint8), so the first real
        request of every size meets a built kernel library and chosen cuDNN
        algorithms. ``shapes``: per-input trailing shapes (default: from
        the model conf). Returns ``{"buckets", "forwards", "seconds"}``."""
        from deeplearning4j_tpu_torch.nn import io as nn_io

        if shapes is None:
            shapes = self._templates
        if shapes is None or any(s is None for s in shapes):
            raise ValueError(
                "cannot derive input shapes from the model conf; pass "
                "warmup(shapes=[(...), ...]) explicitly")
        types = _input_types(self.model) or [None] * len(shapes)
        dtype_sets = nn_io.warm_dtype_variants(types, self._np_dtype)
        t0 = time.monotonic()
        forwards = 0
        for b in self.buckets():
            for dts in dtype_sets:
                self.model.output(*[np.zeros((b,) + tuple(s), dt)
                                    for s, dt in zip(shapes, dts)])
                forwards += 1
        return {"buckets": self.buckets(), "forwards": forwards,
                "seconds": time.monotonic() - t0}

    # --- dispatcher ---------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="dl4j-serving-dispatch",
                    daemon=True)
                self._thread.start()

    def _loop(self):
        me = threading.current_thread()
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if batch:
                self._launch(batch)
            with self._cond:
                if self._thread is not me:
                    # the watchdog declared our launch stuck and started a
                    # replacement dispatcher; it owns the queue now
                    return

    def _expire_locked(self, now: float):
        if not self._queue:
            return
        live = deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                req.error = DeadlineExpiredError(
                    "request deadline expired after "
                    f"{(now - req.t0) * 1000:.1f} ms in queue")
                telemetry.record_serving_request("expired", now - req.t0)
                tracing.finish_trace(req.trace, "expired")
                req.event.set()
            else:
                live.append(req)
        if len(live) != len(self._queue):
            self._queue = live

    def _rows_for(self, head: _Request) -> int:
        return sum(r.n for r in self._queue if r.group == head.group)

    def _take_batch(self) -> Optional[List[_Request]]:
        cfg = self.config
        settled = None  # (head, rows) snapshot being timed for settle
        settle_t = 0.0  # monotonic time the snapshot was taken
        with self._cond:
            while True:
                now = time.monotonic()
                self._expire_locked(now)
                if self._stop:
                    return None
                if not self._queue:
                    settled = None
                    self._cond.wait(0.1)
                    continue
                head = self._queue[0]
                rows = self._rows_for(head)
                limit = head.t0 + cfg.max_delay_ms / 1000.0
                # the settle test needs an unchanged snapshot AND a full
                # elapsed window: other-group submits also wake the condvar
                settle_ok = (settled == (head, rows)
                             and now - settle_t >= cfg.settle_ms / 1000.0)
                if rows >= cfg.max_batch or now >= limit or settle_ok:
                    return self._drain_locked(head)
                if cfg.settle_ms > 0:
                    if settled != (head, rows):
                        settled, settle_t = (head, rows), now
                    tick = settle_t + cfg.settle_ms / 1000.0 - now
                else:
                    settled = None
                    tick = limit - now
                self._cond.wait(min(max(tick, 5e-5), limit - now + 5e-5))

    def _drain_locked(self, head: _Request) -> List[_Request]:
        cfg = self.config
        batch, rows, rest = [], 0, deque()
        for req in self._queue:
            take = (req.group == head.group and rows < cfg.max_batch
                    and (rows + req.n <= cfg.max_batch or not batch))
            if take:
                batch.append(req)
                rows += req.n
                if req.trace is not None:
                    req.trace.event("grouped", {"batch_rows": rows})
            else:
                rest.append(req)
        self._queue = rest
        return batch

    def _finish(self, req: _Request, result=None, error=None,
                status: str = "ok") -> bool:
        """Race-safe request completion: the first of {dispatcher,
        watchdog, close} to set the event delivers the outcome."""
        with self._cond:
            if req.event.is_set():
                return False
            req.result = result
            req.error = error
            req.event.set()
        telemetry.record_serving_request(status, time.monotonic() - req.t0)
        tracing.finish_trace(req.trace, status)
        return True

    def _claim_batch(self, claim, owner: str) -> bool:
        """Exactly ONE of {dispatcher, watchdog} owns a launch's outcome
        and reports the single breaker outcome."""
        with self._cond:
            if claim[0] is not None:
                return False
            claim[0] = owner
            return True

    def _forward(self, cat, batch: List[_Request]):
        """The shared launch, behind the ``serving.launch`` fault site and
        (when configured) one transient-class retry bounded by the batch's
        tightest request deadline."""
        def once():
            faults.fault_point(_FAULT_SITE)
            return self.model.output(*cat)

        if self._retry is None:
            return once()
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        return self._retry.call(
            once, deadline=min(deadlines) if deadlines else None,
            op=_FAULT_SITE)

    def _arm_watchdog(self, batch: List[_Request], claim):
        tmo = self.config.launch_timeout_ms
        if not tmo:
            return None
        t = threading.Timer(tmo / 1000.0, self._watchdog_fire,
                            args=(batch, threading.current_thread(), claim))
        t.daemon = True
        t.start()
        return t

    def _watchdog_fire(self, batch: List[_Request], stuck_thread, claim):
        """Launch-timeout path: claim the batch (atomically with the
        dispatcher swap), fail the stuck launch's waiters with 503 and hand
        the queue to a fresh dispatcher."""
        with self._cond:
            if claim[0] is not None:
                return  # lost the race: the launch completed in time
            claim[0] = "watchdog"
            if not self._stop and self._thread is stuck_thread:
                self._thread = threading.Thread(
                    target=self._loop, name="dl4j-serving-dispatch",
                    daemon=True)
                self._thread.start()
        err = LaunchTimeoutError(
            f"shared launch exceeded {self.config.launch_timeout_ms} ms; "
            "waiters failed by watchdog")
        for r in batch:
            self._finish(r, error=err, status="timeout")
        if self._breaker is not None:
            self._breaker.on_failure()

    def _launch(self, batch: List[_Request]):
        t0 = time.monotonic()
        rows = sum(r.n for r in batch)
        k = len(batch[0].xs)
        claim = [None]  # mutated under self._cond only (_claim_batch)
        watchdog = self._arm_watchdog(batch, claim)
        traced = [r for r in batch if r.trace is not None]
        try:
            cat = [np.concatenate([r.xs[i] for r in batch], axis=0)
                   if len(batch) > 1 else batch[0].xs[i] for i in range(k)]
            target = bucket_rows(rows)
            if traced:
                attrs = {"batch": next(self._batch_seq), "bucket": target,
                         "rows": rows, "requests": len(batch),
                         "occupancy": round(rows / max(target, 1), 3)}
                for r in traced:
                    r.trace.event("launched", attrs)
            if target != rows:
                cat = [np.concatenate(
                    [a, np.zeros((target - rows,) + a.shape[1:], a.dtype)])
                    for a in cat]
            out = self._forward(cat, batch)
            multi = isinstance(out, (list, tuple))
            host = [np.asarray(o) for o in (out if multi else [out])]
        except Exception as e:
            if watchdog is not None:
                watchdog.cancel()
            # deliver only if we win the batch claim — a launch the
            # watchdog already abandoned must not report a second outcome
            if not self._claim_batch(claim, "dispatcher"):
                return
            for r in batch:
                self._finish(r, error=e, status="error")
            if self._breaker is not None:
                self._breaker.on_failure()
            return
        if watchdog is not None:
            watchdog.cancel()
        if not self._claim_batch(claim, "dispatcher"):
            return  # watchdog fired mid-demux-window: it owns the batch
        now = time.monotonic()
        for r in traced:
            r.trace.event("demuxed")
        off = 0
        try:
            for r in batch:
                sl = [h[off:off + r.n] for h in host]
                off += r.n
                self._finish(r, result=sl if multi else sl[0])
        except Exception as e:
            # demux failure (e.g. a model returning fewer rows than fed):
            # fail the remaining waiters, the dispatcher survives
            for r in batch:
                self._finish(r, error=e, status="error")
            if self._breaker is not None:
                self._breaker.on_failure()
            return
        telemetry.record_serving_batch(rows, target, len(batch), now - t0)
        if self._breaker is not None:
            self._breaker.on_success()

    # --- stats / lifecycle --------------------------------------------------
    def queue_depth(self) -> int:
        """Pending-request count (a point-in-time gauge)."""
        return len(self._queue)

    def stats(self) -> dict:
        with self._cond:
            depth = len(self._queue)
        out = {"queue_depth": depth, "buckets": self.buckets()}
        if self._breaker is not None:
            out["circuit_breaker"] = self._breaker.status()
        return out

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        return self._breaker

    @property
    def retry(self):
        """The launch retry policy (None = disabled)."""
        return self._retry

    def close(self):
        """Stop the dispatcher; pending requests fail with a shutdown
        error. Idempotent."""
        with self._cond:
            self._stop = True
            for req in self._queue:
                req.error = RuntimeError("serving engine closed")
                tracing.finish_trace(req.trace, "shutdown")
                req.event.set()
            self._queue.clear()
            self._cond.notify_all()
        telemetry.unregister_serving_engine(self)
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
