"""Iteration-level continuous batching for autoregressive generation.

Counterpart of the JAX package's ``deeplearning4j_tpu/parallel/generation
.py`` on top of ``nn.decoding.TransformerDecoder``: the engine schedules at
TOKEN granularity. One decode loop owns a device-resident state of
``max_batch`` KV-cache rows; every iteration runs ONE window of
``fused_steps=K`` decode steps for the whole running batch (finished rows
masked to no-ops), and between windows finished sequences (EOS /
max-tokens / expired deadline) retire and free their rows, and waiting
prompts prefill into the freed rows in one pass — no sequence waits for the
batch to drain.

Admission control is the batcher's: ``max_queue`` →
:class:`ServerOverloadedError` (503), per-request deadlines →
:class:`DeadlineExpiredError`, malformed prompts → :class:`BadRequestError`
at submit, and a :class:`~deeplearning4j_tpu_torch.resilience.breaker
.CircuitBreaker` shedding at submit while the decode path is failing. A
prefill is retried once on a transient failure; a decode window is not
(it updates the state in place), so a failed window fails the running
requests and resets the state.

Greedy decode through this engine gives the tokens of
``TransformerDecoder.generate`` (the sequential reference): decode
arithmetic is row-independent, and continuous scheduling changes WHEN a
sequence's tokens are computed, never WHAT they are. (On the card a
prefill at another join-bucket size runs cuBLAS at another row count,
which may round differently; a greedy stream can then take the other side
of a near tie.)

The JAX package's prefix cache and draft-model speculation are not ported
yet; configuring either raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import Counter, deque
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.nn.decoding import (
    TransformerDecoder,
    bucket_for,
    request_generator,
)
from deeplearning4j_tpu_torch.parallel.batcher import (
    BadRequestError,
    DeadlineExpiredError,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from deeplearning4j_tpu_torch.resilience.retry import SERVING_RETRY
from deeplearning4j_tpu_torch.telemetry import tracing

_ENGINE_SEQ = itertools.count(1)
_LATER = "the prefix-cache and speculative-decoding slice"


@dataclasses.dataclass
class GenerationConfig:
    """Scheduler policy knobs (the generation twin of ``BatchingConfig``).
    ``draft_conf`` / ``spec_tokens`` and ``prefix_cache`` keep the JAX
    package's fields; setting them raises until their slice lands."""

    max_batch: int = 8          # KV-cache rows (running-batch capacity)
    fused_steps: int = 4        # K decode steps per window
    max_queue: int = 256        # waiting requests before 503 rejection
    timeout_ms: Optional[float] = None  # default per-request deadline
    kv_bucket_min: int = 32     # smallest KV length bucket
    prompt_bucket_min: int = 8  # smallest prompt padding bucket
    max_new_default: int = 64   # max_new_tokens when the caller omits it
    draft_conf: object = None
    spec_tokens: Optional[int] = None
    prefix_cache: bool = False


class _GenRequest:
    __slots__ = ("tokens", "n", "max_new", "eos", "temp", "rng", "deadline",
                 "event", "out", "error", "t0", "t_first", "t_done", "row",
                 "trace")

    def __init__(self, tokens, max_new, eos, temp, rng, deadline, t0,
                 trace=None):
        self.tokens = tokens
        self.n = len(tokens)
        self.max_new = max_new
        self.eos = eos
        self.temp = temp
        self.rng = rng              # per-request torch.Generator (None: greedy)
        self.deadline = deadline
        self.event = threading.Event()
        self.out: List[int] = []
        self.error: Optional[BaseException] = None
        self.t0 = t0
        self.t_first: Optional[float] = None  # first-token wall clock
        self.t_done: Optional[float] = None   # last-token wall clock
        self.row: Optional[int] = None
        self.trace = trace           # request trace (None when disabled)


class GenerationEngine:
    """Continuous-batching generation front of one causal LM.

    Usage::

        engine = GenerationEngine(net, GenerationConfig(max_batch=8))
        engine.warmup()
        toks = engine.generate([1, 2, 3], max_new_tokens=32)
        engine.close()

    ``model`` is a ``TransformerDecoder``, an initialized causal-LM
    ``ComputationGraph``, or a ``zoo.TransformerEncoder(lm_head=True)``
    config (initialized fresh on the card). Scheduling state (row
    ownership, queue, outputs) lives behind one condition variable; the
    device state is touched only by the decode-loop thread.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 breaker: Optional[CircuitBreaker] = ...,
                 retry=..., name: Optional[str] = None):
        self.config = config or GenerationConfig()
        cfg = self.config
        if cfg.draft_conf is not None or cfg.spec_tokens is not None:
            raise NotImplementedError(
                f"draft-model speculative decoding lands with {_LATER}")
        if cfg.prefix_cache:
            raise NotImplementedError(f"the prefix cache lands with {_LATER}")
        self.name = name
        self._fault_site = (f"decode.launch:{name}" if name
                            else "decode.launch")
        if isinstance(model, TransformerDecoder):
            self._dec = model
        elif hasattr(model, "params"):  # an initialized ComputationGraph
            self._dec = TransformerDecoder(
                model, max_batch=cfg.max_batch,
                kv_bucket_min=cfg.kv_bucket_min,
                prompt_bucket_min=cfg.prompt_bucket_min)
        elif hasattr(model, "decoder"):  # a zoo TransformerEncoder config
            self._dec = model.decoder(
                max_batch=cfg.max_batch,
                kv_bucket_min=cfg.kv_bucket_min,
                prompt_bucket_min=cfg.prompt_bucket_min)
        else:
            raise TypeError(
                "model must be a TransformerDecoder, a causal-LM "
                "ComputationGraph, or a zoo config with .decoder()")
        if self._dec.max_batch != cfg.max_batch:
            cfg.max_batch = self._dec.max_batch
        self._breaker = (CircuitBreaker(
            name=(f"serving:{name}" if name
                  else f"decode-{next(_ENGINE_SEQ)}"))
            if breaker is ... else breaker)
        self._retry = SERVING_RETRY if retry is ... else retry
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # device decode state + host mirrors, owned by the decode loop;
        # _rows / _n_active are read under _cond by submit / stats
        self._state = None
        self._S = self._dec.kv_ladder[0]
        self._rows: List[Optional[_GenRequest]] = [None] * cfg.max_batch
        self._positions = [0] * cfg.max_batch  # host mirror of slot counts
        self._n_active = 0
        self._joined_total = 0
        self._retired_total = 0
        self._tokens_total = 0
        self._prefill_seconds = 0.0
        self._decode_seconds = 0.0
        self._prefills: Counter = Counter()  # (prompt bucket, join bucket)
        self._windows: Counter = Counter()   # KV bucket -> decode windows
        telemetry.register_generation_engine(self)

    # --- submit / wait ------------------------------------------------------
    def submit(self, tokens: Sequence[int], max_new_tokens: int = None,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               seed: int = 0, timeout_ms=..., traceparent=None
               ) -> _GenRequest:
        """Validate and enqueue one generation request; returns a handle
        whose ``event`` fires when the tokens (or the error) are in.
        Admission order is the batcher's: malformed → 400, queue full →
        503, breaker open → shed; the breaker last, so a rejected request
        never takes a half-open probe ticket."""
        trace = tracing.start_trace(
            "generate", traceparent=traceparent,
            attrs={"model": self.name} if self.name else None)
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_default
        try:
            toks = self._dec.validate_request(tokens, int(max_new_tokens))
            if temperature < 0:
                raise ValueError("temperature must be >= 0")
            if eos_id is not None and not (
                    0 <= int(eos_id) < self._dec.vocab_size):
                raise ValueError("eos_id outside the vocabulary")
        except ValueError as e:
            telemetry.record_decode_request("bad_request", model=self.name)
            tracing.finish_trace(trace, "bad_request")
            raise BadRequestError(str(e)) from None
        if timeout_ms is ...:
            timeout_ms = self.config.timeout_ms
        t0 = time.monotonic()
        deadline = t0 + timeout_ms / 1000.0 if timeout_ms else None
        rng = (request_generator(seed, self._dec.device)
               if temperature > 0 else None)
        req = _GenRequest(toks, int(max_new_tokens),
                          -1 if eos_id is None else int(eos_id),
                          float(temperature), rng, deadline, t0, trace=trace)
        with self._cond:
            if self._stop:
                tracing.finish_trace(trace, "shutdown")
                raise RuntimeError("generation engine is closed")
            if len(self._queue) >= self.config.max_queue:
                telemetry.record_decode_request("rejected", model=self.name)
                tracing.finish_trace(trace, "rejected")
                raise ServerOverloadedError(
                    f"generation queue full "
                    f"({self.config.max_queue} waiting)")
            if self._breaker is not None and not self._breaker.allow():
                telemetry.record_decode_request("shed", model=self.name)
                tracing.finish_trace(trace, "shed")
                raise CircuitOpenError(
                    f"circuit breaker {self._breaker.name!r} is "
                    f"{self._breaker.state}; request shed")
            self._queue.append(req)
            tracing.trace_event(trace, "queued")
            self._cond.notify_all()
        self._ensure_thread()
        return req

    def result(self, req: _GenRequest) -> List[int]:
        """Block until ``req`` completes; returns its generated token ids
        (EOS included when hit) or raises its error."""
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.out

    def generate(self, tokens, **kw) -> List[int]:
        """Synchronous request: enqueue, join the running batch at the next
        iteration, collect tokens until EOS / max-tokens."""
        return self.result(self.submit(tokens, **kw))

    # --- warmup / stats -----------------------------------------------------
    def warmup(self, **kw) -> dict:
        """Run one prefill per (prompt bucket, join bucket) and one window
        per KV bucket at K = 1 and K = ``fused_steps`` (see
        ``TransformerDecoder.warmup``; ``kw`` narrows the buckets to those
        the traffic will use)."""
        kw.setdefault("fused_steps", (1, self.config.fused_steps))
        out = self._dec.warmup(**kw)
        out["kernels"] = {"enabled": self._dec.use_kernels}
        return out

    def queue_depth(self) -> int:
        return len(self._queue)

    def stats(self) -> dict:
        """Scheduler counters: running-batch occupancy, rows in use,
        join / retire / token totals, the current KV bucket, the time
        spent in prefill and decode, and the breaker's state."""
        with self._cond:
            in_use = sum(r is not None for r in self._rows)
            out = {
                "rows": self.config.max_batch,
                "rows_in_use": in_use,
                "occupancy": in_use / max(self.config.max_batch, 1),
                "queued": len(self._queue),
                "kv_bucket": self._S,
                "fused_steps": self.config.fused_steps,
                "joined_total": self._joined_total,
                "retired_total": self._retired_total,
                "tokens_total": self._tokens_total,
                "prefill_seconds": round(self._prefill_seconds, 4),
                "decode_seconds": round(self._decode_seconds, 4),
                # launches by geometry: "<prompt bucket>x<join bucket>"
                # prefills and "<kv bucket>" windows of fused_steps steps
                "prefills": {f"{tp}x{bp}": n for (tp, bp), n
                             in sorted(self._prefills.items())},
                "windows": {str(s): n for s, n
                            in sorted(self._windows.items())},
            }
        out["buckets"] = {"kv": list(self._dec.kv_ladder),
                          "prompt": list(self._dec.prompt_ladder),
                          "join": list(self._dec.join_ladder)}
        out["kernels"] = {"enabled": self._dec.use_kernels}
        if self._breaker is not None:
            out["circuit_breaker"] = self._breaker.status()
        return out

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        return self._breaker

    @property
    def decoder(self) -> TransformerDecoder:
        return self._dec

    # --- decode loop --------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="dl4j-decode-loop", daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            with self._cond:
                while (not self._stop and not self._queue
                       and self._n_active == 0):
                    self._cond.wait(0.1)
                if self._stop:
                    return
                self._expire_queued_locked(time.monotonic())
                joins = self._pick_joins_locked()
            try:
                if joins:
                    self._prefill_cold(joins)
                if self._n_active:
                    self._do_decode()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._on_dispatch_failure(e)

    def _expire_queued_locked(self, now: float):
        if not self._queue:
            return
        live = deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                req.error = DeadlineExpiredError(
                    "request deadline expired after "
                    f"{(now - req.t0) * 1000:.1f} ms in queue")
                telemetry.record_decode_request("expired", now - req.t0,
                                                model=self.name)
                tracing.finish_trace(req.trace, "expired")
                req.event.set()
            else:
                live.append(req)
        if len(live) != len(self._queue):
            self._queue = live

    def _pick_joins_locked(self) -> List[_GenRequest]:
        """Token-granularity admission: every iteration, as many waiting
        prompts as there are free cache rows join the running batch,
        FIFO."""
        free = [i for i, r in enumerate(self._rows) if r is None]
        joins = []
        for row in free[:len(self._queue)]:
            req = self._queue.popleft()
            req.row = row
            self._rows[row] = req
            tracing.trace_event(req.trace, "join", {"row": row})
            joins.append(req)
        return joins

    def _grow_to(self, target: int):
        s2 = bucket_for(target, self._dec.kv_ladder)
        if self._state is None:
            self._S = max(self._S, s2)
            self._state = self._dec.new_state(self._S)
            return
        if s2 > self._S:
            self._state = self._dec.grow_fn(self._S, s2)(self._state)
            self._S = s2

    def _prefill_cold(self, joins: List[_GenRequest]):
        """Prompt ingestion for this iteration's joins, in one pass padded
        to the (prompt bucket, join bucket); padding rows have length 0
        and target row ``max_batch`` (dropped by the join)."""
        cfg = self.config
        t0 = time.monotonic()
        tp = bucket_for(max(r.n for r in joins), self._dec.prompt_ladder)
        bp = bucket_for(len(joins), self._dec.join_ladder)
        self._grow_to(max(tp, self._S))
        prompts = np.full((bp, tp), self._dec.pad_id, np.int64)
        lengths = np.zeros((bp,), np.int64)
        rows = np.full((bp,), cfg.max_batch, np.int64)  # padding: dropped
        max_new = np.ones((bp,), np.int64)
        eos = np.full((bp,), -1, np.int64)
        temps = np.zeros((bp,), np.float64)
        rng = [None] * bp
        for i, r in enumerate(joins):
            prompts[i, :r.n] = r.tokens
            lengths[i] = r.n
            rows[i] = r.row
            max_new[i] = r.max_new
            eos[i] = r.eos
            temps[i] = r.temp
            rng[i] = r.rng

        def once():
            faults.fault_point(self._fault_site)
            return self._dec.prompt_fn(tp, bp)(
                self._dec.params, prompts, lengths, max_new, eos, temps, rng)

        if self._retry is None:
            kv, tok, active, rng2 = once()
        else:
            deadlines = [r.deadline for r in joins if r.deadline is not None]
            kv, tok, active, rng2 = self._retry.call(
                once, deadline=min(deadlines) if deadlines else None,
                op=self._fault_site)
        self._state = self._dec.join_fn(self._S, tp, bp)(
            self._state, kv, rows, tok, lengths, max_new, eos, temps, rng2,
            active)
        for r in joins:
            tracing.trace_event(r.trace, "prefill",
                                {"prompt_bucket": tp, "rows": bp})
        self._account_prefill(joins, tok.cpu().numpy(),
                              active.cpu().numpy(), tp, bp, t0)

    def _account_prefill(self, joins, tok, active, tp, bp, t0):
        now = time.monotonic()
        n_live = 0
        with self._cond:
            for i, r in enumerate(joins):
                r.out.append(int(tok[i]))
                self._positions[r.row] = r.n
                r.t_first = now
                telemetry.record_decode_first_token(now - r.t0)
                tracing.trace_event(r.trace, "first_token")
                if active[i]:
                    n_live += 1
                else:
                    self._finish_locked(r, now)
            self._n_active += n_live
            self._joined_total += len(joins)
            self._tokens_total += len(joins)
            self._prefill_seconds += now - t0
            self._prefills[(tp, bp)] += 1
        telemetry.record_decode_prefill(len(joins), bp, now - t0)
        if self._breaker is not None:
            self._breaker.on_success()

    def _do_decode(self):
        cfg = self.config
        k = cfg.fused_steps
        t0 = time.monotonic()
        with self._cond:
            max_pos = max((self._positions[r.row] for r in self._rows
                           if r is not None), default=0)
        self._grow_to(min(max_pos + k, self._dec.max_len))
        # no retry on decode windows: the state is updated in place, so a
        # failure mid-window may have consumed it — _on_dispatch_failure
        # resets instead
        faults.fault_point(self._fault_site)
        self._state, toks, emitted = self._dec.decode_fn(self._S, k)(
            self._dec.params, self._state)
        toks = toks.cpu().numpy()
        emitted = emitted.cpu().numpy()
        now = time.monotonic()
        n_emitted = int(emitted.sum())
        released = []
        with self._cond:
            occupancy = sum(r is not None for r in self._rows)
            for b, req in enumerate(self._rows):
                if req is None:
                    continue
                tracing.trace_event(req.trace, "decode_window", {
                    "k": k, "kv_bucket": self._S,
                    "tokens": int(emitted[:, b].sum()),
                    "ms": round((now - t0) * 1000.0, 3)})
                done = False
                for i in range(toks.shape[0]):
                    if not emitted[i, b]:
                        break
                    t = int(toks[i, b])
                    req.out.append(t)
                    self._positions[b] += 1
                    if t == req.eos or len(req.out) >= req.max_new:
                        done = True
                        break
                if done:
                    self._finish_locked(req, now)
                    self._n_active -= 1
                elif req.deadline is not None and now > req.deadline:
                    req.error = DeadlineExpiredError(
                        "deadline expired mid-generation after "
                        f"{len(req.out)} tokens")
                    telemetry.record_decode_request("expired", now - req.t0,
                                                    model=self.name)
                    tracing.finish_trace(req.trace, "expired",
                                         {"tokens": len(req.out)})
                    req.event.set()
                    self._rows[b] = None
                    self._n_active -= 1
                    released.append(b)
            self._tokens_total += n_emitted
            self._decode_seconds += now - t0
            self._windows[self._S] += 1
            rows_in_use = sum(r is not None for r in self._rows)
        if released:
            keep = np.ones((cfg.max_batch,), bool)
            keep[released] = False
            self._state = self._dec.release_fn(self._S)(self._state, keep)
        telemetry.record_decode_iteration(
            n_emitted, occupancy, cfg.max_batch, rows_in_use, k, now - t0)
        if self._breaker is not None:
            self._breaker.on_success()

    def _finish_locked(self, req: _GenRequest, now: float):
        req.t_done = now
        self._rows[req.row] = None
        self._retired_total += 1
        telemetry.record_decode_request("ok", now - req.t0, model=self.name)
        tracing.finish_trace(req.trace, "done", {"tokens": len(req.out)})
        req.event.set()

    def _on_dispatch_failure(self, e: BaseException):
        """A prefill or decode raised. The state may be half-updated, so
        every in-flight request fails (the batcher fails its batch the same
        way), the state is reset to zeros, and the breaker counts the
        failure — persistent failure trips it open and submits shed."""
        with self._cond:
            for b, req in enumerate(self._rows):
                if req is None:
                    continue
                req.error = e if req.error is None else req.error
                telemetry.record_decode_request("error", model=self.name)
                tracing.finish_trace(req.trace, "rollback",
                                     {"error": type(e).__name__})
                req.event.set()
                self._rows[b] = None
            self._n_active = 0
            self._positions = [0] * self.config.max_batch
        self._state = self._dec.new_state(self._S)
        if self._breaker is not None:
            self._breaker.on_failure()

    # --- lifecycle ----------------------------------------------------------
    def close(self):
        """Stop the decode loop; queued and in-flight requests fail with a
        shutdown error. Idempotent."""
        with self._cond:
            self._stop = True
            err = RuntimeError("generation engine closed")
            for req in self._queue:
                req.error = err
                tracing.finish_trace(req.trace, "shutdown")
                req.event.set()
            self._queue.clear()
            for b, req in enumerate(self._rows):
                if req is not None:
                    req.error = err
                    tracing.finish_trace(req.trace, "shutdown")
                    req.event.set()
                    self._rows[b] = None
            self._n_active = 0
            self._cond.notify_all()
        telemetry.unregister_generation_engine(self)
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30)
        self._thread = None
        self._state = None
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
