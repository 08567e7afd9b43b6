"""Serving and generation telemetry: the metrics registry, request
tracing, and the recording helpers the serving and generation engines
call.

A minimal counterpart of the JAX package's ``telemetry/__init__.py``: the
same metric names and labels for what the serving slice records. Serving
and resilience metrics record unconditionally (one registry update per
request or control-plane event); ``prometheus_text`` is the ``/metrics``
payload.
"""

from __future__ import annotations

import weakref

from deeplearning4j_tpu_torch.telemetry import registry as registry  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import tracing as tracing  # noqa: F401
from deeplearning4j_tpu_torch.telemetry.registry import REGISTRY


def reset() -> None:
    """Clear request traces and metrics (collectors stay registered)."""
    tracing.reset()
    REGISTRY.reset()


def record_serving_request(status: str, seconds: float = None) -> None:
    """Count one inference request terminal state: ``ok`` / ``error`` /
    ``bad_request`` / ``rejected`` (queue full) / ``expired`` (deadline) /
    ``shed`` / ``timeout``; ``seconds`` = submit-to-completion latency when
    the request made it into the queue."""
    REGISTRY.counter("dl4j_serving_requests_total",
                     help="inference requests by terminal status",
                     status=status).inc()
    if seconds is not None:
        REGISTRY.histogram("dl4j_serving_request_seconds",
                           help="submit-to-result request latency"
                           ).observe(seconds)


def record_serving_batch(rows: int, padded_rows: int, requests: int,
                         seconds: float) -> None:
    """Record one shared device launch: fill ratio (real rows / padded
    bucket rows), rows and coalesced-request histograms, launch time."""
    REGISTRY.counter("dl4j_serving_batches_total",
                     help="shared inference launches").inc()
    REGISTRY.histogram("dl4j_serving_batch_fill_ratio",
                       help="real rows / padded bucket rows"
                       ).observe(rows / max(padded_rows, 1))
    REGISTRY.histogram("dl4j_serving_batch_rows",
                       help="real rows per shared launch").observe(rows)
    REGISTRY.histogram("dl4j_serving_batch_requests",
                       help="requests coalesced per launch").observe(requests)
    REGISTRY.histogram("dl4j_serving_batch_seconds",
                       help="shared launch wall time").observe(seconds)


def record_retry(op: str) -> None:
    """Count one scheduled retry (first attempts are not retries)."""
    REGISTRY.counter("dl4j_retries_total",
                     help="retries scheduled by RetryPolicy", op=op).inc()


def record_fault_injected(site: str, action: str) -> None:
    REGISTRY.counter("dl4j_faults_injected_total",
                     help="faults fired by an armed FaultPlan",
                     site=site, action=action).inc()


def record_circuit_state(name: str, state_code: int,
                         transition: bool = True) -> None:
    """Publish a breaker's state (0=closed, 1=half_open, 2=open); counts
    the transition too unless this is the initial publish."""
    REGISTRY.gauge("dl4j_circuit_state",
                   help="0=closed 1=half_open 2=open",
                   breaker=name).set(state_code)
    if transition:
        REGISTRY.counter("dl4j_circuit_transitions_total",
                         help="breaker state transitions",
                         breaker=name, to=str(state_code)).inc()


def record_decode_request(status: str, seconds: float = None,
                          model: str = None) -> None:
    """Count one generation-request terminal state (``ok`` / ``error`` /
    ``bad_request`` / ``rejected`` / ``expired`` / ``shed``); ``seconds`` =
    submit-to-last-token latency when it ran. ``model`` labels the series
    for named engines."""
    labels = {"model": model} if model else {}
    REGISTRY.counter("dl4j_decode_requests_total",
                     help="generation requests by terminal status",
                     status=status, **labels).inc()
    if seconds is not None:
        REGISTRY.histogram("dl4j_decode_request_seconds",
                           help="submit-to-completion generation latency",
                           **labels).observe(seconds)


def record_decode_iteration(tokens: int, active_rows: int, capacity: int,
                            rows_in_use: int, k: int,
                            seconds: float) -> None:
    """One decode window: tokens emitted, running-batch occupancy, KV-cache
    rows in use, per-token latency (window wall time / K)."""
    REGISTRY.counter("dl4j_decode_tokens_total",
                     help="tokens generated (all sequences)").inc(tokens)
    REGISTRY.gauge("dl4j_decode_batch_occupancy",
                   help="active rows / max_batch in the running "
                        "decode batch").set(active_rows / max(capacity, 1))
    REGISTRY.gauge("dl4j_decode_kv_rows_in_use",
                   help="KV-cache rows currently owned by sequences").set(
        rows_in_use)
    if k > 0:
        REGISTRY.histogram("dl4j_decode_token_seconds",
                           help="per-token decode latency "
                                "(window time / K)").observe(seconds / k)


def record_decode_prefill(rows: int, bucket_rows: int,
                          seconds: float) -> None:
    """One prefill launch: joining sequences, padded join-bucket fill and
    prompt-ingestion wall time. Each joining row samples its first token
    in the prefill, so those count as generated tokens."""
    REGISTRY.counter("dl4j_decode_prefills_total",
                     help="prompt prefill launches").inc()
    REGISTRY.counter("dl4j_decode_tokens_total",
                     help="tokens generated (all sequences)").inc(rows)
    REGISTRY.histogram("dl4j_decode_prefill_fill_ratio",
                       help="joining rows / padded join bucket").observe(
        rows / max(bucket_rows, 1))
    REGISTRY.histogram("dl4j_decode_prefill_seconds",
                       help="prefill launch wall time").observe(seconds)


def record_decode_first_token(seconds: float) -> None:
    """Time-to-first-token for one request (submit → prefill sample)."""
    REGISTRY.histogram("dl4j_decode_first_token_seconds",
                       help="submit-to-first-token latency").observe(seconds)


def record_prefix_cache(hits: int = 0, misses: int = 0, evictions: int = 0,
                        pages: int = None, hit_tokens: int = 0) -> None:
    """Radix prefix-cache accounting: lookups that matched at least one
    page vs cold misses, refcount-0 pages LRU-evicted, live page count
    after the operation, and prompt tokens whose prefill was skipped."""
    if hits:
        REGISTRY.counter("dl4j_prefix_cache_hits_total",
                         help="prompt lookups matching >=1 cached "
                              "page").inc(hits)
    if misses:
        REGISTRY.counter("dl4j_prefix_cache_misses_total",
                         help="prompt lookups with no cached "
                              "prefix").inc(misses)
    if evictions:
        REGISTRY.counter("dl4j_prefix_cache_evictions_total",
                         help="refcount-0 KV pages LRU-evicted").inc(
            evictions)
    if pages is not None:
        REGISTRY.gauge("dl4j_prefix_cache_pages",
                       help="live KV pages in the radix tree").set(pages)
    if hit_tokens:
        REGISTRY.counter("dl4j_prefix_cache_hit_tokens_total",
                         help="prompt tokens served from cached KV "
                              "(prefill skipped)").inc(hit_tokens)


def record_spec_window(accepted: int, k: int, emitted: int) -> None:
    """One speculative verify window of one row: drafted tokens accepted
    out of the K proposed, plus the tokens emitted (accepted drafts and
    the verifier's own bonus token)."""
    REGISTRY.histogram("dl4j_spec_accepted_tokens",
                       help="draft tokens accepted per verify "
                            "window").observe(accepted)
    REGISTRY.counter("dl4j_spec_draft_tokens_total",
                     help="draft tokens proposed to the "
                          "verifier").inc(k)
    REGISTRY.counter("dl4j_spec_accepted_tokens_total",
                     help="draft tokens accepted by the "
                          "verifier").inc(accepted)
    REGISTRY.counter("dl4j_spec_emitted_tokens_total",
                     help="tokens emitted from verify windows "
                          "(accepted + bonus)").inc(emitted)


_SERVING_ENGINES = weakref.WeakSet()
_GENERATION_ENGINES = weakref.WeakSet()


def record_kernel_selected(kernel: str, shape_bucket: str) -> None:
    """Count one kernel-registry routing decision (``kernels.registry``):
    a tuned winner was resolved for a concrete shape class. Counted once
    per envelope per tuning-cache epoch (the eager counterpart of the JAX
    package's once per trace), never per call."""
    REGISTRY.counter("dl4j_kernel_selected_total",
                     help="tuned kernel selections at trace time",
                     kernel=kernel, shape_bucket=shape_bucket).inc()


def record_autotune_trial(kernel: str) -> None:
    """Count one autotuner candidate benchmark (``kernels.tuner``)."""
    REGISTRY.counter("dl4j_kernel_autotune_trials_total",
                     help="autotune candidate tilings benchmarked",
                     kernel=kernel).inc()


def record_autotune_winner(kernel: str) -> None:
    """Count one autotuner winner recorded into the tuning cache."""
    REGISTRY.counter("dl4j_kernel_autotune_winners_total",
                     help="autotune winners recorded", kernel=kernel).inc()


def record_tuning_cache(hits: int, entries: int) -> None:
    """Publish the kernel tuning cache's cumulative hit count and entry
    count (control-plane cadence: selection and autotune events)."""
    REGISTRY.gauge("dl4j_kernel_tuning_cache_hits",
                   help="tuning-cache winner lookups that hit").set(hits)
    REGISTRY.gauge("dl4j_kernel_tuning_cache_entries",
                   help="tuned envelopes in the cache").set(entries)


def register_serving_engine(engine) -> None:
    """Track a live ``InferenceEngine``; ``dl4j_serving_queue_depth`` is
    collected at scrape time as the SUM over live engines."""
    _SERVING_ENGINES.add(engine)


def unregister_serving_engine(engine) -> None:
    _SERVING_ENGINES.discard(engine)


def register_generation_engine(engine) -> None:
    """Track a live ``GenerationEngine``; ``dl4j_decode_queue_depth`` is
    collected at scrape time as the SUM over live engines."""
    _GENERATION_ENGINES.add(engine)


def unregister_generation_engine(engine) -> None:
    _GENERATION_ENGINES.discard(engine)


@REGISTRY.register_collector
def _collect_decode_queue_depth(reg) -> None:
    engines = list(_GENERATION_ENGINES)
    if engines:
        reg.gauge("dl4j_decode_queue_depth",
                  help="generation requests waiting for a cache row").set(
            sum(e.queue_depth() for e in engines))


@REGISTRY.register_collector
def _collect_serving_queue_depth(reg) -> None:
    engines = list(_SERVING_ENGINES)
    if engines:
        reg.gauge("dl4j_serving_queue_depth",
                  help="pending serving requests").set(
            sum(e.queue_depth() for e in engines))


def prometheus_text() -> str:
    """The full ``/metrics`` payload."""
    return REGISTRY.render_prometheus()
