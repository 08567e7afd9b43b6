"""Dynamic cross-request micro-batching for serving.

Counterpart of the JAX package's ``parallel/batcher.py`` with the same
queue, dispatcher and demux. Reference: ``org.deeplearning4j.parallelism
.inference`` — caller threads hand ``ParallelInference`` observations, an
``ObservablesProvider`` coalesces them, a worker runs one batched forward,
and each caller's observable is signalled with its slice. Concurrent
requests share one padded forward on the device; the padding is quantized
to power-of-two buckets, and ``warmup()`` runs every bucket once so the
first real request of each size finds the kernel library built and cuDNN's
algorithms chosen. Every forward runs through the envelope cache
(``optimize.aot_cache``): the first forward at a new (graph signature,
input shapes, dtypes, device) is a miss — the port's counterpart of a
compile — and ``aot_cache.stats()["misses"]`` stays flat across traffic
whose buckets warmup already ran.

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

Multi-tenant hooks (``parallel.platform``): a named engine labels its
series ``model=<name>``, names its breaker ``serving:<name>`` and fires the
fault site ``serving.launch:<name>``; ``admission=`` adds a host-wide
quota at submit; ``publish`` swaps the serving weights atomically per
batch.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from deeplearning4j_tpu_torch.resilience.retry import SERVING_RETRY
from deeplearning4j_tpu_torch.telemetry import tracing


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


def bucket_rows(n: int, align: int = 1) -> int:
    """Padding bucket for an ``n``-row launch: the smallest
    ``align * 2**k >= n``. ``align`` is the replica count of a split
    backend (``ParallelInference`` needs row counts divisible by its
    workers), so the ladder is align, 2*align, 4*align, ..."""
    per = -(-int(n) // int(align))
    return next_pow2(per) * int(align)


def bucket_ladder(max_batch: int, align: int = 1) -> List[int]:
    """Every bucket a <=``max_batch``-row request can land in (what
    ``warmup()`` runs)."""
    out = []
    b = int(align)
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
                 retry=..., name: Optional[str] = None,
                 admission: Optional[Callable] = None):
        self.config = config or BatchingConfig()
        # multi-tenant identity (parallel.platform): a NAMED engine labels
        # its dl4j_serving_* series with model=<name>, defaults its breaker
        # to "serving:<name>" (so /health aggregates every breaker of one
        # model under one key) and fires "serving.launch:<name>", so a
        # chaos plan can degrade exactly this tenant
        self.name = name
        self._fault_site = (f"serving.launch:{name}" if name
                            else "serving.launch")
        # host-level admission hook (platform quota): called at submit
        # with (engine, rows) after this engine's own queue-full check and
        # before the breaker; it may raise ServerOverloadedError
        self._admission = admission
        # circuit breaker on the launch path: consecutive failures trip it
        # open and submits shed with CircuitOpenError (503); None disables
        self._breaker = (CircuitBreaker(
            name=(f"serving:{name}" if name
                  else f"serving-{next(_ENGINE_SEQ)}"))
            if breaker is ... else breaker)
        # one transient-class retry before a launch failure reaches the
        # breaker; model bugs (ValueError & co) are never retried
        self._retry = SERVING_RETRY if retry is ... else retry
        self._graph_opt = bool(graph_opt)
        self._bf16 = bool(bf16)
        self._cond = threading.Condition()
        self._adopt_model(self._optimized(model))
        self._queue: deque = deque()
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
        trace = tracing.start_trace(
            "predict", traceparent=traceparent,
            attrs={"model": self.name} if self.name else None)
        try:
            xs, n, group = self._validate(inputs)
        except BadRequestError:
            telemetry.record_serving_request("bad_request", model=self.name)
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
                telemetry.record_serving_request("rejected", model=self.name)
                tracing.finish_trace(trace, "rejected")
                raise ServerOverloadedError(
                    f"model {self.name!r} serving queue full "
                    f"({self.config.max_queue} pending)" if self.name else
                    f"serving queue full ({self.config.max_queue} pending)")
            if self._admission is not None:
                # platform-level quota, still before the breaker so a
                # host-level rejection never burns a half-open probe ticket
                try:
                    self._admission(self, n)
                except ServerOverloadedError:
                    telemetry.record_serving_request("rejected",
                                                     model=self.name)
                    tracing.finish_trace(trace, "rejected")
                    raise
            # breaker check LAST: a request rejected for being malformed
            # or for overload must not consume a half-open probe ticket
            if self._breaker is not None and not self._breaker.allow():
                telemetry.record_serving_request("shed", model=self.name)
                tracing.finish_trace(trace, "shed")
                raise CircuitOpenError(
                    (f"model {self.name!r}: " if self.name else "")
                    + f"circuit breaker {self._breaker.name!r} is "
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

    # --- model adoption / hot publish ---------------------------------------
    def _optimized(self, model):
        """The serving copy of ``model``: the inference-graph pass under
        the engine's ``graph_opt`` / ``bf16`` flags."""
        if not self._graph_opt:
            return model
        from deeplearning4j_tpu_torch.nn.inference_opt import (
            optimize_for_inference,
        )

        return optimize_for_inference(model, bf16=self._bf16)

    def _adopt_model(self, model):
        """Derive the engine's serving surface from ``model`` (already
        through the inference-graph pass): numpy dtype, input templates and
        the envelope key's signature and device. The ONE place these are
        computed — construction and ``publish`` share it — and set together
        under the engine lock, so a launch reads a consistent set."""
        conf = getattr(model, "conf", None)
        with self._cond:
            self.model = model
            self._np_dtype = np.dtype(getattr(conf, "dtype", "float32"))
            self._templates = _input_templates(model)
            self._signature = aot_cache.graph_signature(conf)
            self._device = getattr(model, "device", "cpu")
        return model

    def publish(self, model, params=None, state=None):
        """Swap the serving weights WITHOUT restarting the engine.
        ``model`` is the source network (configuration authority);
        ``params`` / ``state`` override its trees. The construction-time
        inference-graph pass re-runs with the same ``graph_opt`` / ``bf16``
        flags, so a BN-folding engine keeps folding. The swap is atomic per
        batch: a launch reads the serving model once, so every batch runs
        wholly on the old version or wholly on the new one. A version with
        the source's configuration keeps every warmed envelope (the same
        graph signature: zero new envelopes). Returns the model now
        serving."""
        import copy

        src = model
        if params is not None or state is not None:
            src = copy.copy(model)
            if params is not None:
                src.params = params
            if state is not None:
                src.state = state
        return self._adopt_model(self._optimized(src))

    # --- warmup -------------------------------------------------------------
    def buckets(self) -> List[int]:
        return bucket_ladder(self.config.max_batch)

    def warmup(self, shapes=None, dtype=None) -> dict:
        """Run one zeros forward per padding bucket and per client-visible
        input dtype (float and, for image inputs, uint8; only ``dtype``
        when given), each through the envelope cache, so the first real
        request of every size meets a built kernel library and chosen cuDNN
        algorithms. ``shapes``: per-input trailing shapes (default: from
        the model conf). Returns ``{"buckets", "forwards", "seconds",
        "compiled", "compile_seconds"}`` (``compiled``: new envelopes)."""
        from deeplearning4j_tpu_torch.nn import io as nn_io

        with self._cond:
            model, sig, device = self.model, self._signature, self._device
            templates, np_dtype = self._templates, self._np_dtype
        if shapes is None:
            shapes = templates
        if shapes is None or any(s is None for s in shapes):
            raise ValueError(
                "cannot derive input shapes from the model conf; pass "
                "warmup(shapes=[(...), ...]) explicitly")
        if dtype is not None:
            dtype_sets = [tuple(np.dtype(dtype) for _ in shapes)]
        else:
            types = _input_types(model) or [None] * len(shapes)
            dtype_sets = nn_io.warm_dtype_variants(types, np_dtype)
        before = aot_cache.stats()
        t0 = time.monotonic()
        forwards = 0
        for b in self.buckets():
            for dts in dtype_sets:
                args = [np.zeros((b,) + tuple(s), dt)
                        for s, dt in zip(shapes, dts)]
                aot_cache.run_envelope(
                    aot_cache.envelope_key(sig, args, device),
                    lambda: model.output(*args))
                forwards += 1
        after = aot_cache.stats()
        return {"buckets": self.buckets(), "forwards": forwards,
                "seconds": time.monotonic() - t0,
                "compiled": after["misses"] - before["misses"],
                "compile_seconds": round(
                    after["compile_seconds"] - before["compile_seconds"], 3)}

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
                telemetry.record_serving_request("expired", now - req.t0,
                                                 model=self.name)
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
        telemetry.record_serving_request(status, time.monotonic() - req.t0,
                                         model=self.name)
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

    def _forward(self, cat, batch: List[_Request], model, key):
        """The shared launch of ``model`` (read once per batch: a publish
        never splits one), behind the ``serving.launch[:<name>]`` fault
        site and the envelope cache, with (when configured) one
        transient-class retry bounded by the batch's tightest request
        deadline."""
        def once():
            faults.fault_point(self._fault_site)
            return aot_cache.run_envelope(key, lambda: model.output(*cat))

        if self._retry is None:
            return once()
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        return self._retry.call(
            once, deadline=min(deadlines) if deadlines else None,
            op=self._fault_site)

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
        with self._cond:
            model, sig, device = self.model, self._signature, self._device
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
            out = self._forward(cat, batch, model,
                                aot_cache.envelope_key(sig, cat, device))
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
        telemetry.record_serving_batch(rows, target, len(batch), now - t0,
                                       model=self.name)
        if self._breaker is not None:
            self._breaker.on_success()

    # --- stats / lifecycle --------------------------------------------------
    def queue_depth(self) -> int:
        """Pending-request count (a point-in-time gauge)."""
        return len(self._queue)

    def stats(self) -> dict:
        with self._cond:
            depth = len(self._queue)
        out = {"queue_depth": depth, "buckets": self.buckets(),
               "aot_cache": aot_cache.stats()}
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
