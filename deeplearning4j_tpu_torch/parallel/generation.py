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

Two features ride on top, both off by default and composable:

- **Radix-tree prefix caching** (``prefix_cache=True``): finished prefills
  donate page-aligned KV blocks to a refcounted
  :class:`~deeplearning4j_tpu_torch.parallel.prefix_cache.PrefixCache`
  (pages stay on the card); a request pins the longest cached prefix at
  submit, the engine copies the pinned pages into its row and prefills
  only the suffix. Pins are released on every terminal edge (finish,
  queue expiry, mid-generation deadline, dispatch failure, close).
- **Draft-model speculative decoding** (``draft_conf=...``): a smaller
  same-vocabulary draft decoder proposes ``spec_tokens`` tokens per
  iteration with its own window; the target scores all K+1 positions in
  one wide step and emits the accepted prefix plus one token of its own.
  Emission replays the target's own sampling rule, so the output is the
  non-speculative stream at any acceptance rate (greedy, and seeded
  sampling through the row's generator). Near the context limit
  (``pos + K + 1 > max_len``) the iteration falls back to the plain
  window.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import Counter, deque
from typing import List, Optional, Sequence

import numpy as np
import torch

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
from deeplearning4j_tpu_torch.parallel.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from deeplearning4j_tpu_torch.resilience.retry import SERVING_RETRY
from deeplearning4j_tpu_torch.telemetry import tracing

_ENGINE_SEQ = itertools.count(1)


@dataclasses.dataclass
class GenerationConfig:
    """Scheduler policy knobs (the generation twin of
    ``BatchingConfig``)."""

    max_batch: int = 8          # KV-cache rows (running-batch capacity)
    fused_steps: int = 4        # K decode steps per window
    max_queue: int = 256        # waiting requests before 503 rejection
    timeout_ms: Optional[float] = None  # default per-request deadline
    kv_bucket_min: int = 32     # smallest KV length bucket
    prompt_bucket_min: int = 8  # smallest prompt padding bucket
    max_new_default: int = 64   # max_new_tokens when the caller omits it
    # speculative decoding: a smaller same-vocabulary causal LM (decoder /
    # initialized graph / zoo config) that drafts spec_tokens tokens per
    # iteration for the target to verify in one step. None = off.
    draft_conf: object = None
    spec_tokens: Optional[int] = None  # draft window K (default fused_steps)
    # radix-tree prompt-prefix KV cache: page size in tokens (the trie's
    # granularity) and the LRU eviction budget in pages
    prefix_cache: bool = False
    prefix_page: int = 16
    prefix_cache_pages: int = 256


class _GenRequest:
    __slots__ = ("tokens", "n", "max_new", "eos", "temp", "rng", "deadline",
                 "event", "out", "error", "t0", "t_first", "t_done", "row",
                 "prefix_len", "prefix_nodes", "trace")

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
        self.prefix_len = 0          # tokens served from the prefix cache
        self.prefix_nodes: list = []  # pinned trie nodes (one pin each)
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
        self._draft_dec: Optional[TransformerDecoder] = None
        self._draft_state = None
        self._spec_k = int(cfg.spec_tokens or cfg.fused_steps)
        if cfg.draft_conf is not None:
            self._draft_dec = self._coerce_draft(cfg.draft_conf)
        self._prefix = (PrefixCache(cfg.prefix_page, cfg.prefix_cache_pages)
                        if cfg.prefix_cache else None)
        self._spec_windows = 0   # per-row verify windows
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._verify_windows: Counter = Counter()  # KV bucket -> verify steps
        self._draft_prefills = 0
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
        self._suffix_prefills: Counter = Counter()  # (suffix, prefix bucket)
        self._windows: Counter = Counter()   # KV bucket -> decode windows
        # optional SLOMonitor (parallel.platform wires it): TTFT and outcomes
        # observed synchronously where telemetry records them
        self._slo = None
        telemetry.register_generation_engine(self)

    def _coerce_draft(self, model) -> TransformerDecoder:
        """Build the draft decoder with the TARGET's bucket geometry, on the
        target's device, and reject mismatches up front: the verifier
        feeds the draft's proposals straight into the target's window, so
        the two must agree on vocabulary, row count, context length and
        every ladder."""
        cfg = self.config
        if isinstance(model, TransformerDecoder):
            draft = model
        elif hasattr(model, "params"):
            draft = TransformerDecoder(
                model, max_batch=cfg.max_batch, max_len=self._dec.max_len,
                kv_bucket_min=cfg.kv_bucket_min,
                prompt_bucket_min=cfg.prompt_bucket_min)
        elif hasattr(model, "decoder"):
            draft = model.decoder(
                device=self._dec.device, max_batch=cfg.max_batch,
                kv_bucket_min=cfg.kv_bucket_min,
                prompt_bucket_min=cfg.prompt_bucket_min)
        else:
            raise TypeError(
                "draft_conf must be a TransformerDecoder, a causal-LM "
                "ComputationGraph, or a zoo config with .decoder()")
        if draft.vocab_size != self._dec.vocab_size:
            raise ValueError(
                f"draft vocab {draft.vocab_size} != target "
                f"{self._dec.vocab_size}: speculative tokens would be "
                "meaningless to the verifier")
        if (draft.max_batch != self._dec.max_batch
                or draft.max_len != self._dec.max_len
                or list(draft.kv_ladder) != list(self._dec.kv_ladder)
                or list(draft.prompt_ladder) != list(
                    self._dec.prompt_ladder)):
            raise ValueError(
                "draft/target bucket geometry must match (max_batch, "
                "max_len, kv and prompt ladders)")
        if draft.device != self._dec.device:
            raise ValueError(f"draft on {draft.device}, target on "
                             f"{self._dec.device}")
        return draft

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
        if self._prefix is not None:
            # pin the longest cached prefix now (refcounts on the whole
            # path), so eviction cannot free its pages before the join;
            # fits() rejects matches whose padded suffix bucket would push
            # the row past max_len (the suffix join writes a ts-wide block
            # at offset m, so m + bucket(n - m) must fit)
            ladder = self._dec.prompt_ladder
            m, nodes = self._prefix.match(
                req.tokens, limit=req.n - 1,
                fits=lambda mm: mm + bucket_for(
                    req.n - mm, ladder) <= self._dec.max_len)
            req.prefix_len = m
            req.prefix_nodes = list(nodes)
        try:
            with self._cond:
                if self._stop:
                    tracing.finish_trace(trace, "shutdown")
                    raise RuntimeError("generation engine is closed")
                if len(self._queue) >= self.config.max_queue:
                    telemetry.record_decode_request("rejected",
                                                    model=self.name)
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
                tracing.trace_event(
                    trace, "queued",
                    {"prefix_len": req.prefix_len} if req.prefix_len
                    else None)
                self._cond.notify_all()
        except BaseException:
            self._release_prefix(req)
            raise
        self._ensure_thread()
        return req

    def _release_prefix(self, req: _GenRequest):
        """Drop the request's pins on its prefix-cache path. Called on
        every terminal edge exactly once (the list is cleared), so the
        tree's refcounts always return to steady state."""
        nodes, req.prefix_nodes = req.prefix_nodes, []
        if nodes and self._prefix is not None:
            self._prefix.release(nodes)

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
    def warmup(self, autotune_kernels: bool = False, retune: bool = False,
               warmup: Optional[int] = None, trials: Optional[int] = None,
               max_candidates: Optional[int] = None, **kw) -> dict:
        """Run one prefill per (prompt bucket, join bucket) and one window
        per KV bucket at K = 1 and K = ``fused_steps`` (see
        ``TransformerDecoder.warmup``; ``kw`` narrows the buckets to those
        the traffic will use). With a draft model every KV bucket's verify
        window runs too and the draft warms its prefills and draft windows;
        with the prefix cache every feasible suffix-prefill geometry
        runs.

        ``autotune_kernels`` (with ``conf.use_kernels``) first tunes every
        bucket-ladder attention envelope of the target decoder, and the
        draft's where there is one (``kernels.autotune_decoder``; the
        tuner's ``warmup`` / ``trials`` / ``max_candidates`` and ``retune``
        pass through), so the warm runs and the traffic after them run the
        paged-decode and flash-prefill winners. ``out["kernels"]`` reports
        whether the kernels are on and the registry's tag."""
        if autotune_kernels and self._dec.use_kernels:
            from deeplearning4j_tpu_torch import kernels

            tune_kw = {key: val for key, val in (
                ("warmup", warmup), ("trials", trials),
                ("max_candidates", max_candidates)) if val is not None}
            kernels.autotune_decoder(self._dec, retune=retune, **tune_kw)
            if self._draft_dec is not None:
                kernels.autotune_decoder(self._draft_dec, retune=retune,
                                         **tune_kw)
        kw.setdefault("fused_steps", (1, self.config.fused_steps))
        narrow = {key: kw[key] for key in ("prompt_buckets", "join_buckets",
                                           "kv_buckets") if key in kw}
        if self._draft_dec is not None:
            kw.setdefault("spec_steps", (self._spec_k,))
        if self._prefix is not None:
            kw.setdefault("prefix", True)
        out = self._dec.warmup(**kw)
        if self._draft_dec is not None:
            out["draft"] = self._draft_dec.warmup(
                fused_steps=(1, self.config.fused_steps),
                spec_draft=(self._spec_k,), **narrow)
        out["kernels"] = {"enabled": self._dec.use_kernels,
                          "tag": self._dec._ktag()}
        return out

    def queue_depth(self) -> int:
        return len(self._queue)

    def stats(self) -> dict:
        """Scheduler counters: running-batch occupancy, rows in use,
        join / retire / token totals, the current KV bucket, the time
        spent in prefill and decode, launches by geometry, the prefix
        cache's and the speculation's counters where on, and the breaker's
        state."""
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
                # prefills, "<suffix bucket>x<prefix bucket>" suffix
                # prefills (max_batch rows each) and "<kv bucket>" plain
                # windows of fused_steps steps
                "prefills": {f"{tp}x{bp}": n for (tp, bp), n
                             in sorted(self._prefills.items())},
                "suffix_prefills": {f"{ts}x{tpre}": n for (ts, tpre), n
                                    in sorted(self._suffix_prefills.items())},
                "windows": {str(s): n for s, n
                            in sorted(self._windows.items())},
            }
            if self._draft_dec is not None:
                drafted = self._spec_drafted
                out["speculative"] = {
                    "windows": self._spec_windows,
                    "drafted": drafted,
                    "accepted": self._spec_accepted,
                    "acceptance": (self._spec_accepted / drafted
                                   if drafted else 0.0),
                    # verify steps (the whole batch's) by KV bucket
                    "verify_windows": {str(s): n for s, n in sorted(
                        self._verify_windows.items())},
                    "draft_prefills": self._draft_prefills,
                    "k": self._spec_k,
                }
        out["buckets"] = {"kv": list(self._dec.kv_ladder),
                          "prompt": list(self._dec.prompt_ladder),
                          "join": list(self._dec.join_ladder)}
        out["kernels"] = {"enabled": self._dec.use_kernels}
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
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
                    self._do_prefill(joins)
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
                self._release_prefix(req)
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
            if self._draft_dec is not None:
                self._draft_state = self._draft_dec.new_state(self._S)
            return
        if s2 > self._S:
            self._state = self._dec.grow_fn(self._S, s2)(self._state)
            if self._draft_dec is not None:
                self._draft_state = self._draft_dec.grow_fn(
                    self._S, s2)(self._draft_state)
            self._S = s2

    def _dispatch(self, fn, joins):
        """Run a prefill launch, retried once on a transient failure (a
        prefill writes no state)."""
        def once():
            faults.fault_point(self._fault_site)
            return fn()

        if self._retry is None:
            return once()
        deadlines = [r.deadline for r in joins if r.deadline is not None]
        return self._retry.call(
            once, deadline=min(deadlines) if deadlines else None,
            op=self._fault_site)

    @torch.inference_mode()
    def _do_prefill(self, joins: List[_GenRequest]):
        """Prompt ingestion for this iteration's joins: cold prompts
        prefill in one pass (and donate their KV pages to the prefix
        cache); prefix-cache hits prefill only their suffix, grouped by
        suffix bucket; with a draft model every join also prefills the
        draft's cache (the whole prompt: the draft does not ride the
        prefix cache), so speculation starts on the next window."""
        cold = [r for r in joins if not r.prefix_len]
        hits = [r for r in joins if r.prefix_len]
        if cold:
            self._prefill_cold(cold)
        if hits:
            groups = {}
            for r in hits:
                ts = bucket_for(r.n - r.prefix_len, self._dec.prompt_ladder)
                groups.setdefault(ts, []).append(r)
            for ts in sorted(groups):
                self._prefill_suffix_group(groups[ts], ts)
        if self._draft_dec is not None:
            self._draft_prefill(joins)

    def _prefill_cold(self, joins: List[_GenRequest]):
        """One pass over the joins padded to the (prompt bucket, join
        bucket); padding rows have length 0 and target row ``max_batch``
        (dropped by the join)."""
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
        kv, tok, active, rng2 = self._dispatch(
            lambda: self._dec.prompt_fn(tp, bp)(
                self._dec.params, prompts, lengths, max_new, eos, temps,
                rng), joins)
        self._state = self._dec.join_fn(self._S, tp, bp)(
            self._state, kv, rows, tok, lengths, max_new, eos, temps, rng2,
            active)
        if self._prefix is not None:
            self._insert_pages(joins, kv, offset=0)
        for r in joins:
            tracing.trace_event(r.trace, "prefill",
                                {"prompt_bucket": tp, "rows": bp})
        self._prefills[(tp, bp)] += 1
        self._account_prefill(joins, tok.cpu().numpy(),
                              active.cpu().numpy(), bp, t0)

    def _prefill_suffix_group(self, joins: List[_GenRequest], ts: int):
        """One prefix-hit join group (shared suffix bucket ``ts``): the
        pinned pages are assembled on the card into one padded ``[bp,
        tpre, width]`` block (one copy per row), the suffix prefills
        against per-layer views of it in one pass, then the pages are
        copied into the rows (``prefix_attach``) and the
        suffix kv lands at each row's own offset (``suffix_join``). Every
        member passed the submit-time ``fits`` check for this ``ts``, so
        ``prefix_len + ts <= max_len`` holds row by row. The group pads to
        ``max_batch`` rows (one width per (ts, tpre) geometry); padding rows
        have no valid key and are dropped by the joins."""
        cfg = self.config
        t0 = time.monotonic()
        max_m = max(r.prefix_len for r in joins)
        tpre = bucket_for(max_m, self._dec.prompt_ladder)
        bp = cfg.max_batch
        self._grow_to(max(max_m + ts, self._S))
        suffix = np.full((bp, ts), self._dec.pad_id, np.int64)
        suf_lens = np.zeros((bp,), np.int64)
        plens = np.zeros((bp,), np.int64)
        lengths = np.zeros((bp,), np.int64)
        rows = np.full((bp,), cfg.max_batch, np.int64)  # padding: dropped
        max_new = np.ones((bp,), np.int64)
        eos = np.full((bp,), -1, np.int64)
        temps = np.zeros((bp,), np.float64)
        rng = [None] * bp
        page = joins[0].prefix_nodes[0].kv
        block = page.new_zeros((bp, tpre, page.shape[1]))
        for i, r in enumerate(joins):
            self._prefix.assemble(r.prefix_nodes, block[i])
            suffix[i, :r.n - r.prefix_len] = r.tokens[r.prefix_len:]
            suf_lens[i] = r.n - r.prefix_len
            plens[i] = r.prefix_len
            lengths[i] = r.n
            rows[i] = r.row
            max_new[i] = r.max_new
            eos[i] = r.eos
            temps[i] = r.temp
            rng[i] = r.rng
        # the decoder's per-layer views of the block: [bp, tpre, heads, hd]
        pkv, col = {}, 0
        for name, c in self._state["caches"].items():
            shape = tuple(c["k"].shape[2:])  # (heads, hd)
            w = shape[0] * shape[1]
            pkv[name] = {key: block[:, :, col + j * w:col + (j + 1) * w]
                         .unflatten(-1, shape)
                         for j, key in enumerate(("k", "v"))}
            col += 2 * w
        kv, tok, active, rng2 = self._dispatch(
            lambda: self._dec.suffix_prompt_fn(ts, tpre, bp)(
                self._dec.params, suffix, suf_lens, pkv, plens, max_new,
                eos, temps, rng), joins)
        self._state = self._dec.prefix_attach_fn(self._S, tpre, bp)(
            self._state, pkv, rows, plens)
        self._state = self._dec.suffix_join_fn(self._S, ts, bp)(
            self._state, kv, rows, tok, plens, lengths, max_new, eos, temps,
            rng2, active)
        # extend the trie with the hit requests' own suffix pages, so a
        # longer shared prefix hits next time
        self._insert_pages(joins, kv, offset="prefix")
        for r in joins:
            tracing.trace_event(r.trace, "prefix_attach",
                                {"prefix_len": r.prefix_len,
                                 "suffix_bucket": ts})
        self._suffix_prefills[(ts, tpre)] += 1
        self._account_prefill(joins, tok.cpu().numpy(),
                              active.cpu().numpy(), bp, t0)

    def _insert_pages(self, joins, kv, offset):
        """Donate a prefill's kv to the prefix cache: the full pages of
        each request's prompt that the trie lacks, each cut on the card out
        of ``kv`` (the ``[bp, t, heads, hd]`` block per layer) into one new
        ``[page, width]`` tensor in one copy (columns: each layer's k then
        v, flattened, in the caches' order). ``offset`` is 0 for a cold
        prefill, or ``"prefix"`` when ``kv`` holds only the
        suffix (page starts shift down by the row's prefix length; the
        prefix's pages are in the tree already and pinned, so the slicer is
        never asked for them). The inserted path's pins join the request's
        node list, so its own pages cannot be evicted before it retires and
        every pin releases on the usual terminal edges."""
        names = list(self._state["caches"])

        def make_slicer(i, off):
            def slicer(start, stop):
                return torch.cat(
                    [kv[name][key][i, start - off:stop - off].flatten(1)
                     for name in names for key in ("k", "v")], dim=1)
            return slicer

        for i, r in enumerate(joins):
            off = r.prefix_len if offset == "prefix" else 0
            nodes = self._prefix.insert(r.tokens, r.n, make_slicer(i, off))
            r.prefix_nodes = list(r.prefix_nodes) + list(nodes)

    def _draft_prefill(self, joins: List[_GenRequest]):
        """Prefill the DRAFT's cache for every join (the whole prompt, one
        pass) and seed its rows with the TARGET's first token: the draft
        row greedily extends the target's stream, never its own (eos -1,
        max_new max_len, greedy: the draft never stops a row; the verifier
        decides all emission)."""
        d = self._draft_dec
        cfg = self.config
        tp = bucket_for(max(r.n for r in joins), d.prompt_ladder)
        bp = bucket_for(len(joins), d.join_ladder)
        prompts = np.full((bp, tp), d.pad_id, np.int64)
        lengths = np.zeros((bp,), np.int64)
        rows = np.full((bp,), cfg.max_batch, np.int64)
        max_new = np.full((bp,), d.max_len, np.int64)
        eos = np.full((bp,), -1, np.int64)
        temps = np.zeros((bp,), np.float64)
        tok = np.zeros((bp,), np.int64)
        active = np.zeros((bp,), bool)
        with self._cond:
            for i, r in enumerate(joins):
                prompts[i, :r.n] = r.tokens
                lengths[i] = r.n
                rows[i] = r.row
                tok[i] = r.out[0]
                active[i] = self._rows[r.row] is r
        kv, _tok, _act, rng2 = self._dispatch(
            lambda: d.prompt_fn(tp, bp)(d.params, prompts, lengths, max_new,
                                        eos, temps, [None] * bp), joins)
        self._draft_state = d.join_fn(self._S, tp, bp)(
            self._draft_state, kv, rows, tok, lengths, max_new, eos, temps,
            rng2, active)
        self._draft_prefills += 1

    def _account_prefill(self, joins, tok, active, bp, t0):
        now = time.monotonic()
        n_live = 0
        with self._cond:
            for i, r in enumerate(joins):
                r.out.append(int(tok[i]))
                self._positions[r.row] = r.n
                r.t_first = now
                telemetry.record_decode_first_token(now - r.t0)
                tracing.trace_event(r.trace, "first_token")
                if self._slo is not None:
                    self._slo.observe(self.name or "default",
                                      ttft=now - r.t0)
                if active[i]:
                    n_live += 1
                else:
                    self._finish_locked(r, now)
            self._n_active += n_live
            self._joined_total += len(joins)
            self._tokens_total += len(joins)
            self._prefill_seconds += now - t0
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
        # a speculative window needs K+1 cache slots past the deepest row
        # (K drafts and the bonus position); past that the iteration falls
        # back to the plain window (the clamped cache write would otherwise
        # overwrite valid slots). The fallback can leave the draft's cache
        # with unwritten slots, which lowers the draft's agreement but
        # never changes the output (the verifier replays the target's own
        # sampling rule)
        ks = self._spec_k
        spec = (self._draft_dec is not None
                and max_pos + ks + 1 <= self._dec.max_len)
        self._grow_to(min(max_pos + (ks + 1 if spec else k),
                          self._dec.max_len))
        # no retry on decode windows: the state is updated in place, so a
        # failure mid-window may have consumed it — _on_dispatch_failure
        # resets instead
        faults.fault_point(self._fault_site)
        accepted = None
        if spec:
            k = ks
            d = self._draft_dec
            self._draft_state, drafts, _ = d.spec_draft_fn(self._S, k)(
                d.params, self._draft_state, self._state["tokens"],
                self._state["positions"], self._state["active"])
            self._state, toks, emitted, accepted = self._dec.spec_verify_fn(
                self._S, k)(self._dec.params, self._state, drafts)
            accepted = accepted.cpu().numpy()
        else:
            self._state, toks, emitted = self._dec.decode_fn(self._S, k)(
                self._dec.params, self._state)
        toks = toks.cpu().numpy()
        emitted = emitted.cpu().numpy()
        now = time.monotonic()
        n_emitted = int(emitted.sum())
        released = []
        with self._cond:
            occupancy = sum(r is not None for r in self._rows)
            if spec:
                self._verify_windows[self._S] += 1
            for b, req in enumerate(self._rows):
                if req is None:
                    continue
                if accepted is not None and emitted[0, b]:
                    telemetry.record_spec_window(
                        int(accepted[b]), k, int(emitted[:, b].sum()))
                    self._spec_windows += 1
                    self._spec_drafted += k
                    self._spec_accepted += int(accepted[b])
                tracing.trace_event(req.trace, "decode_window", {
                    "k": k, "kv_bucket": self._S, "speculative": spec,
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
                    self._release_prefix(req)
                    req.event.set()
                    self._rows[b] = None
                    self._n_active -= 1
                    released.append(b)
            self._tokens_total += n_emitted
            self._decode_seconds += now - t0
            if not spec:
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
        if self._slo is not None:
            self._slo.observe(self.name or "default", ok=True,
                              seconds=now - req.t0)
        self._release_prefix(req)
        req.event.set()

    def _on_dispatch_failure(self, e: BaseException):
        """A prefill or decode raised. The state may be half-updated, so
        every in-flight request fails (the batcher fails its batch the same
        way), the states are reset to zeros, and the breaker counts the
        failure — persistent failure trips it open and submits shed."""
        with self._cond:
            for b, req in enumerate(self._rows):
                if req is None:
                    continue
                req.error = e if req.error is None else req.error
                telemetry.record_decode_request("error", model=self.name)
                tracing.finish_trace(req.trace, "rollback",
                                     {"error": type(e).__name__})
                if self._slo is not None:
                    self._slo.observe(self.name or "default", ok=False)
                self._release_prefix(req)
                req.event.set()
                self._rows[b] = None
            self._n_active = 0
            self._positions = [0] * self.config.max_batch
        self._state = self._dec.new_state(self._S)
        if self._draft_dec is not None:
            self._draft_state = self._draft_dec.new_state(self._S)
        if self._breaker is not None:
            self._breaker.on_failure()

    # --- lifecycle ----------------------------------------------------------
    def close(self):
        """Stop the decode loop; queued and in-flight requests fail with a
        shutdown error and drop their prefix pins. Idempotent."""
        with self._cond:
            self._stop = True
            err = RuntimeError("generation engine closed")
            for req in self._queue:
                req.error = err
                tracing.finish_trace(req.trace, "shutdown")
                self._release_prefix(req)
                req.event.set()
            self._queue.clear()
            for b, req in enumerate(self._rows):
                if req is not None:
                    req.error = err
                    tracing.finish_trace(req.trace, "shutdown")
                    self._release_prefix(req)
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
        self._draft_state = None
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
