"""Telemetry: the metrics registry, request tracing, step-trace spans, the
training health layer and its flight recorder, the export surfaces, and
the recording helpers the serving and generation engines, the networks'
train steps and the data-parallel trainer call.

A minimal counterpart of the JAX package's ``telemetry/__init__.py``: the
same metric names and labels for what the port records. Serving,
resilience and control-plane metrics (collective plans, shard bytes)
record unconditionally; the per-step training and collective series, like
the spans, are one flag check until ``enable()``. ``prometheus_text`` is
the ``/metrics`` payload.
"""

from __future__ import annotations

import weakref

from deeplearning4j_tpu_torch.telemetry import flightrec as flightrec  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import health as health  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import registry as registry  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import slo as slo  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import spans as spans  # noqa: F401
from deeplearning4j_tpu_torch.telemetry import tracing as tracing  # noqa: F401
from deeplearning4j_tpu_torch.telemetry.export import (  # noqa: F401
    TelemetryListener,
    dump_jsonl,
    telemetry_record,
)
from deeplearning4j_tpu_torch.telemetry.flightrec import (  # noqa: F401
    FlightRecorder,
    flight_recorder,
)
from deeplearning4j_tpu_torch.telemetry.health import (  # noqa: F401
    AnomalyPolicy,
    DivergenceError,
    HealthMonitor,
)
from deeplearning4j_tpu_torch.telemetry.registry import REGISTRY
from deeplearning4j_tpu_torch.telemetry.spans import (  # noqa: F401
    PHASE_COMPUTE,
    PHASE_GRAD_SYNC,
    PHASE_HOST_GAP,
    PHASE_INGEST,
    disable,
    enable,
    enabled,
    events,
    export_chrome_trace,
    host_gap_close,
    host_gap_open,
    host_gap_pause,
    host_gap_reset,
    host_gap_resume,
    host_gap_stop,
    phase_stats,
    span,
    sync_mode,
)


def reset() -> None:
    """Clear spans, request traces and metrics (flags and collectors
    stay)."""
    spans.reset()
    tracing.reset()
    REGISTRY.reset()


# --------------------------------------------------------------------------
# training and collective series (the JAX package's names and labels);
# the per-step ones are one flag check while spans are disabled
# --------------------------------------------------------------------------

def record_step(path: str, examples: int = 0, steps: int = 1) -> None:
    """Count one dispatch's optimization steps (and examples) for a
    training path: ``multilayer``, ``graph`` or ``parallel``."""
    if not spans._enabled:
        return
    REGISTRY.counter("dl4j_training_steps_total",
                     help="optimization steps", path=path).inc(steps)
    if examples:
        REGISTRY.counter("dl4j_training_examples_total",
                         help="examples consumed", path=path).inc(examples)


def record_collective(op: str, nbytes: float, buckets: int = 1) -> None:
    """Count one cross-rank exchange: ``nbytes`` = per-rank payload,
    ``buckets`` = collectives issued for it."""
    if not spans._enabled:
        return
    REGISTRY.counter("dl4j_collective_bytes_total",
                     help="per-shard bytes exchanged", op=op).inc(nbytes)
    REGISTRY.counter("dl4j_collective_ops_total",
                     help="collectives issued", op=op).inc(buckets)


def record_bucket_layout(op: str, bucket_bytes_list) -> None:
    """Record a bucketed collective's layout (once per schedule): bucket
    count gauge + per-bucket byte sizes histogram."""
    if not spans._enabled:
        return
    REGISTRY.gauge("dl4j_collective_buckets",
                   help="buckets in the collective schedule", op=op).set(
        len(bucket_bytes_list))
    h = REGISTRY.histogram("dl4j_collective_bucket_bytes",
                           help="per-bucket payload bytes", op=op)
    for b in bucket_bytes_list:
        h.observe(b)


def record_collective_plan(intent: str, choice: str, nbytes: float,
                           launches: int) -> None:
    """Record one freshly planned collective schedule
    (``comms.scheduler``), unconditionally: plans are built once per
    layout per process, never per step."""
    REGISTRY.counter("dl4j_collective_plan_total",
                     help="collective plans built by the scheduler",
                     intent=intent, choice=choice).inc()
    REGISTRY.gauge("dl4j_collective_plan_bytes",
                   help="logical per-shard payload of the newest plan",
                   intent=intent).set(nbytes)
    REGISTRY.gauge("dl4j_collective_plan_launches",
                   help="collectives issued per exchange by the newest "
                        "plan", intent=intent).set(launches)


def record_shard_bytes(param_bytes: float, opt_bytes: float,
                       device=None) -> None:
    """Publish this rank's parameter / optimizer-state footprint
    (``dl4j_shard_param_bytes`` / ``dl4j_shard_opt_bytes``, labelled by
    the rank's device), unconditionally: placement happens once per
    ``fit``."""
    labels = {"device": str(device)} if device is not None else {}
    REGISTRY.gauge("dl4j_shard_param_bytes",
                   help="per-device parameter bytes under the active "
                        "sharding plan", **labels).set(param_bytes)
    REGISTRY.gauge("dl4j_shard_opt_bytes",
                   help="per-device optimizer-state bytes under the "
                        "active sharding plan", **labels).set(opt_bytes)


def record_serving_request(status: str, seconds: float = None,
                           model: str = None) -> None:
    """Count one inference request terminal state: ``ok`` / ``error`` /
    ``bad_request`` / ``rejected`` (queue full) / ``expired`` (deadline) /
    ``shed`` / ``timeout``; ``seconds`` = submit-to-completion latency when
    the request made it into the queue. ``model`` labels the series for
    named (multi-tenant platform) engines; unnamed engines keep the
    unlabeled series."""
    labels = {"model": model} if model else {}
    REGISTRY.counter("dl4j_serving_requests_total",
                     help="inference requests by terminal status",
                     status=status, **labels).inc()
    if seconds is not None:
        REGISTRY.histogram("dl4j_serving_request_seconds",
                           help="submit-to-result request latency",
                           **labels).observe(seconds)


def record_serving_batch(rows: int, padded_rows: int, requests: int,
                         seconds: float, model: str = None) -> None:
    """Record one shared device launch: fill ratio (real rows / padded
    bucket rows), rows and coalesced-request histograms, launch time.
    ``model`` labels the series for named engines (per-tenant views)."""
    labels = {"model": model} if model else {}
    REGISTRY.counter("dl4j_serving_batches_total",
                     help="shared inference launches", **labels).inc()
    REGISTRY.histogram("dl4j_serving_batch_fill_ratio",
                       help="real rows / padded bucket rows",
                       **labels).observe(rows / max(padded_rows, 1))
    REGISTRY.histogram("dl4j_serving_batch_rows",
                       help="real rows per shared launch",
                       **labels).observe(rows)
    REGISTRY.histogram("dl4j_serving_batch_requests",
                       help="requests coalesced per launch",
                       **labels).observe(requests)
    REGISTRY.histogram("dl4j_serving_batch_seconds",
                       help="shared launch wall time",
                       **labels).observe(seconds)


def record_platform_event(event: str, model: str = None) -> None:
    """Count one platform control-plane event (``parallel.platform``):
    ``swap`` / ``canary_deploy`` / ``canary_rollback`` / ``promote`` /
    ``host_rejected`` — unconditional, these are rare lifecycle events,
    never per-request work."""
    labels = {"model": model} if model else {}
    REGISTRY.counter(f"dl4j_platform_{event}_total",
                     help="multi-tenant platform lifecycle events",
                     **labels).inc()


def record_canary_accuracy(model: str, delta: float) -> None:
    """Record one canary accuracy-arm shadow compare
    (``parallel.platform``): the max-abs output delta between the canary
    (e.g. an int8 quantized version) and its f32 incumbent on one sampled
    request. Gauge = last observed delta; the counter tracks sample
    volume."""
    REGISTRY.gauge("dl4j_canary_accuracy_delta",
                   help="last canary-vs-incumbent output delta",
                   model=model).set(float(delta))
    REGISTRY.counter("dl4j_canary_accuracy_samples_total",
                     help="canary accuracy-arm shadow compares",
                     model=model).inc()


def record_slo_transition(tenant: str, to_state: str) -> None:
    """Count one SLO alert-state transition (``telemetry.slo``): rare by
    construction (hysteresis), never per-request work. The current
    state and burn gauges are scrape-time collectors."""
    REGISTRY.counter("dl4j_slo_transitions_total",
                     help="SLO alert-state transitions",
                     tenant=tenant, to=to_state).inc()


def record_analysis_finding(rule: str, severity: str) -> None:
    """Count one unwaived finding recorded in ``analysis.findings.LOG``
    (the platform's PLT301 warmup truncations)."""
    REGISTRY.counter("dl4j_analysis_findings_total",
                     help="static-analysis findings (analysis/ linters)",
                     rule=rule, severity=severity).inc()


def record_retry(op: str) -> None:
    """Count one scheduled retry (first attempts are not retries)."""
    REGISTRY.counter("dl4j_retries_total",
                     help="retries scheduled by RetryPolicy", op=op).inc()


def record_step_seconds(seconds: float, path: str = "listener") -> None:
    """Observe one step duration into the registry histogram (the
    ProfilerListener routing); a no-op while telemetry is off."""
    if not spans._enabled:
        return
    REGISTRY.histogram("dl4j_step_seconds", help="host-observed step time",
                       path=path).observe(seconds)


def record_resume(scope: str = "job") -> None:
    """Count one TrainingSession resume from a snapshot.
    ``scope="job"`` = whole-process failure (preemption, injected step
    fault, crash restart); ``scope="host"`` = one pod host died
    (``HostDeathError`` at the ``pod.heartbeat`` site) and the whole job
    resumed from the last distributed snapshot."""
    REGISTRY.counter("dl4j_resumes_total",
                     help="training resumes from snapshot",
                     scope=scope).inc()


def record_pod_hosts(n_hosts: int) -> None:
    """Publish the pod shape (``dl4j_pod_hosts``): how many hosts the
    snapshot / training topology spans (an emulated pod reports its
    emulated width)."""
    REGISTRY.gauge("dl4j_pod_hosts",
                   help="hosts in the active pod topology").set(n_hosts)


def record_pod_shard(host: int, nbytes: int, seconds: float) -> None:
    """One host's pod-snapshot shard written: per-host shard bytes gauge
    + shard write-time histogram."""
    REGISTRY.gauge("dl4j_pod_snapshot_shard_bytes",
                   help="bytes in this host's newest snapshot shard",
                   host=str(host)).set(nbytes)
    REGISTRY.histogram("dl4j_pod_shard_write_seconds",
                       help="per-host shard write time").observe(seconds)


def record_pod_snapshot_seconds(seconds: float) -> None:
    """One full distributed snapshot (all shards + manifests + the
    coordinator commit)."""
    REGISTRY.histogram("dl4j_pod_snapshot_seconds",
                       help="distributed snapshot wall time").observe(
        seconds)


def record_pod_restore_seconds(seconds: float) -> None:
    """One pod-snapshot restore (verify + aggregate + rebuild)."""
    REGISTRY.histogram("dl4j_pod_restore_seconds",
                       help="distributed restore wall time").observe(
        seconds)


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


@REGISTRY.register_collector
def _collect_slo_metrics(reg) -> None:
    for mon in slo.monitors():
        for tenant, snap in mon.snapshot().items():
            reg.gauge("dl4j_slo_state",
                      help="0=ok 1=warn 2=page",
                      tenant=tenant).set(slo.STATE_CODE[snap["state"]])
            for objective, b in snap["burn_rates"].items():
                for window in ("short", "long"):
                    reg.gauge("dl4j_slo_burn_rate",
                              help="violation fraction / objective "
                                   "budget per rolling window",
                              tenant=tenant, objective=objective,
                              window=window).set(b[window])


def prometheus_text() -> str:
    """The full ``/metrics`` payload."""
    return REGISTRY.render_prometheus()
