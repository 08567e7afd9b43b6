"""The port's SLO monitor (``telemetry/slo.py``, a copy of the JAX
package's) and the request-trace exports (``telemetry/tracing.py``), held
against the JAX package: one seeded outcome sequence gives the same state
at every observation and the same transitions at the same indices in both
packages' ``SLOMonitor``; the serving platform observes every judged
outcome (and a generation tenant its TTFT) into its monitor and surfaces it
through ``stats()``, ``resilience.status()`` and the ``dl4j_slo_*`` gauges;
``stage_breakdown`` has the JAX package's keys and fills the batcher's
stages; the Chrome trace has one ``X`` slice per request and an ``i``
instant per event.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.telemetry import slo as jslo
from deeplearning4j_tpu.telemetry import tracing as jtracing
from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.batcher import (
    BatchingConfig,
    InferenceEngine,
)
from deeplearning4j_tpu_torch.parallel.platform import (
    ModelPlatform,
    ModelRegistry,
    TenantConfig,
)
from deeplearning4j_tpu_torch.telemetry import REGISTRY, tracing
from deeplearning4j_tpu_torch.telemetry.slo import SLO, SLOMonitor

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()
    tracing.reset()


def _mlp(seed=1):
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, "cpu").init()


def _x(rows=2, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, 4)).astype(
        np.float32)


@pytest.mark.parametrize("seed,p_bad", [(3, 0.0), (5, 0.15), (9, 0.4)])
def test_slo_transitions_equal_the_jax_packages(seed, p_bad):
    """A seeded stream (an error burst, then noise at ``p_bad``, latency
    and TTFT samples) through both monitors: the same state after every
    observation, the same transitions and snapshots."""
    cfg = dict(error_rate=0.1, latency_p95_ms=50.0, ttft_ms=200.0,
               short_window=8, long_window=16, min_samples=8,
               warn_burn=1.0, page_burn=4.0, clear_after=4)
    rng = np.random.default_rng(seed)
    stream = []
    for i in range(160):
        bad = (8 <= i < 20) or rng.random() < p_bad
        stream.append((not bad, float(rng.exponential(0.03)),
                       float(rng.exponential(0.15))))

    def drive(mon):
        return [mon.observe("t", ok=ok, seconds=s, ttft=t)
                for ok, s, t in stream]

    m, jm = SLOMonitor(SLO(**cfg), seed=seed), jslo.SLOMonitor(
        jslo.SLO(**cfg), seed=seed)
    assert drive(m) == drive(jm)
    assert m.transitions("t") == jm.transitions("t")
    assert "page" in [t["to"] for t in m.transitions("t")]
    assert m.snapshot() == jm.snapshot()
    assert m.worst_state() == jm.worst_state()


def test_slo_hysteresis_replay_deterministic():
    """``tests/test_tracing.py``'s replay: warn → page → recovery at the
    same observation indices in two monitors, cleared only after
    ``clear_after`` clean evaluations."""
    cfg = SLO(error_rate=0.1, short_window=8, long_window=16,
              min_samples=8, warn_burn=1.0, page_burn=4.0, clear_after=4)

    def drive(mon):
        states = [mon.observe("t", ok=not (8 <= i < 20)) for i in range(40)]
        return states + [mon.observe("t", ok=True) for _ in range(40)]

    m1, m2 = SLOMonitor(cfg, seed=3), SLOMonitor(cfg, seed=3)
    s1, s2 = drive(m1), drive(m2)
    assert s1 == s2 and "page" in s1
    assert m1.transitions("t") == m2.transitions("t")
    assert m1.state("t") == "ok"
    snap = m1.snapshot()["t"]
    assert snap["observations"] == 80
    assert snap["burn_rates"]["error_rate"]["short"] == 0.0
    assert REGISTRY.snapshot(run_collectors=False)[
        'dl4j_slo_transitions_total{tenant="t",to="page"}'] >= 2


def test_platform_slo_surface(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp())
    cfg = SLO(error_rate=0.5, latency_p95_ms=60_000.0,
              short_window=4, long_window=8, min_samples=4)
    with ModelPlatform(reg, slo=cfg, device="cpu") as plat:
        plat.deploy("m", config=TenantConfig(
            batching=BatchingConfig(max_batch=4)))
        for _ in range(6):
            plat.predict("m", _x())
        st = plat.stats()["m"]["slo"]
        assert st["state"] == "ok"
        assert "latency_p95" in st["burn_rates"]
        assert plat.slo.snapshot()["m"]["observations"] == 6
        res = resilience.status()
        assert res["slo"]["tenants"]["m"]["state"] == "ok"
        snap = REGISTRY.snapshot()
        assert snap.get('dl4j_slo_state{tenant="m"}') == 0
        assert ('dl4j_slo_burn_rate{objective="latency_p95",'
                'tenant="m",window="short"}') in snap


def test_generation_tenant_reports_ttft_to_the_platform_slo():
    from deeplearning4j_tpu_torch.parallel.generation import GenerationConfig
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    lm = TransformerEncoder(vocab_size=16, embed_dim=8, n_heads=2,
                            n_layers=1, max_len=16, causal=True,
                            lm_head=True, seed=5)
    cfg = SLO(ttft_ms=60_000.0, error_rate=0.5, short_window=4,
              long_window=8, min_samples=2)
    with ModelPlatform(slo=cfg, device="cpu") as plat:
        plat.deploy_generation("lm", model=lm, config=GenerationConfig(
            max_batch=2, fused_steps=2, kv_bucket_min=8,
            prompt_bucket_min=4))
        for p in ([1, 2, 3], [4, 5]):
            plat.generate("lm", p, max_new_tokens=3)
        snap = plat.slo.snapshot()["lm"]
        # one TTFT and one completion a request
        assert snap["observations"] == 4
        assert set(snap["burn_rates"]) == {"error_rate", "ttft"}
        assert plat.stats()["lm"]["slo"]["state"] == "ok"


def _traced_engine_run(n=6):
    tracing.enable(seed=2, sample_every=1)
    with InferenceEngine(_mlp(), BatchingConfig(max_batch=4),
                         name="st") as eng:
        for i in range(n):
            eng.predict(_x(rows=1 + i % 3, seed=i))


def test_stage_breakdown_keys_and_batcher_stages():
    _traced_engine_run()
    got = tracing.stage_breakdown()
    assert sorted(got) == sorted(jtracing.stage_breakdown())
    assert got["traces"] == 6
    for stage in ("queue_wait", "batch_wait", "launch", "total"):
        assert got[stage]["count"] == 6
        assert set(got[stage]) == {"mean_ms", "p50_ms", "p95_ms", "count"}
        assert 0 <= got[stage]["p50_ms"] <= got[stage]["p95_ms"]
    assert got["decode_window"] is None
    snap = tracing.snapshot()
    assert snap["stats"]["started"] == 6
    tr = snap["traces"][0]
    assert tr["attrs"]["model"] == "st" and tr["status"] == "ok"
    assert [e["name"] for e in tr["events"]][:2] == ["queued", "admitted"]


def test_chrome_trace_export_shape(tmp_path):
    tracing.enable(seed=6, sample_every=1)
    t = tracing.start_trace("req")
    tracing.trace_event(t, "queued")
    tracing.finish_trace(t, "ok")
    doc = tracing.export_chrome_trace(str(tmp_path / "trace.json"))
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert slices and slices[0]["args"]["trace_id"] == t.trace_id
    assert instants and instants[0]["name"] == "queued"
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    # the same ids as the JAX package mints for the same seed
    jtracing.enable(seed=6, sample_every=1)
    try:
        jt = jtracing.start_trace("req")
        jtracing.finish_trace(jt, "ok")
        assert jt.trace_id == t.trace_id
    finally:
        jtracing.disable()
        jtracing.reset()
