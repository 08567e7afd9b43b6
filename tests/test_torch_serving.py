"""The port's InferenceEngine / InferenceServer on the CPU, held against the
JAX package's ``net.output`` on the same graph and parameters, and to the
batching semantics ``deeplearning4j_tpu/parallel/batcher.py`` defines.

Outputs are compared with a tolerance, not bit for bit: a coalesced launch
pads to a power-of-two bucket, and float32 sums may take another order at
another batch size (float32, rtol 1e-4, atol 1e-6 on softmax outputs).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import inputs as jit_
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel.batcher import (
    BadRequestError,
    BatchingConfig,
    CircuitOpenError,
    DeadlineExpiredError,
    InferenceEngine,
    LaunchTimeoutError,
    ServerOverloadedError,
    bucket_ladder,
    bucket_rows,
)
from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
from deeplearning4j_tpu_torch.resilience.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-4, atol=1e-6)
IMG = (6, 6, 3)


@pytest.fixture(scope="module")
def nets():
    """A small image graph (a routed 1x1 conv, a 3x3 conv, softmax head) in
    both packages with the same parameters."""
    g = (JNNC.builder().seed(21).use_kernels().graph_builder()
         .add_inputs("input").set_input_types(jit_.Convolutional(*IMG)))
    g.add_layer("c1", JConv(n_out=8, kernel_size=(1, 1), stride=(2, 2),
                            convolution_mode=JMode.SAME, has_bias=False,
                            activation=JAct.RELU), "input")
    g.add_layer("c3", JConv(n_out=6, kernel_size=(3, 3),
                            convolution_mode=JMode.SAME,
                            activation=JAct.TANH), "c1")
    g.add_layer("pool", JGP(pooling_type=JPT.AVG), "c3")
    g.add_layer("out", JOut(n_out=4), "pool")
    g.set_outputs("out")
    jconf = g.build()
    jnet = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, jax.tree_util.tree_map(np.asarray, jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, ComputationGraph(conf, device="cpu").set_params(p, s)


def _images(n, seed, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (n,) + IMG, np.uint8)
    return rng.random((n,) + IMG, dtype=np.float32)


def _http(port, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_bucket_ladder_and_rows():
    assert bucket_ladder(32) == [1, 2, 4, 8, 16, 32]
    assert [bucket_rows(n) for n in (1, 3, 5, 17)] == [1, 4, 8, 32]


def test_server_concurrent_requests_match_jax(nets):
    jnet, net = nets
    server = InferenceServer(net, batching=BatchingConfig(
        max_batch=16, max_delay_ms=30.0, settle_ms=3.0))
    sizes = [1, 3, 2, 4, 1, 2]
    inputs = [_images(n, seed=i, uint8=(i == 2)) for i, n in enumerate(sizes)]
    results = [None] * len(inputs)
    try:
        warm = server.warmup()
        assert warm["buckets"] == [1, 2, 4, 8, 16]
        assert warm["forwards"] == 10  # float32 and uint8 per bucket
        server.start(port=0)

        def client(i):
            results[i] = _http(server.port, "/predict",
                               {"inputs": [inputs[i].tolist()]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, (code, raw) in enumerate(results):
            assert code == 200, raw
            got = np.asarray(json.loads(raw)["outputs"][0], np.float32)
            np.testing.assert_allclose(got, np.asarray(jnet.output(inputs[i])),
                                       **TOL, err_msg=f"request {i}")
        code, raw = _http(server.port, "/model")
        info = json.loads(raw)
        assert code == 200 and info["type"] == "ComputationGraph"
        assert info["inputs"] == ["input"] and info["outputs"] == ["out"]
        assert info["num_params"] == net.num_params()
        assert info["buckets"] == [1, 2, 4, 8, 16]
        code, raw = _http(server.port, "/healthz")
        health = json.loads(raw)
        assert code == 200 and health["status"] == "ok"
        assert health["circuit"] == "closed" and health["queue_depth"] == 0
        code, raw = _http(server.port, "/metrics")
        text = raw.decode()
        assert code == 200
        assert 'dl4j_serving_requests_total{status="ok"}' in text
        assert "dl4j_serving_batches_total" in text
    finally:
        server.stop()


@pytest.mark.parametrize("body,code", [
    (b"{not json", 400),
    (json.dumps({"inputs": []}).encode(), 400),
    (json.dumps({"no_inputs": 1}).encode(), 400),
    (json.dumps({"inputs": [[[1.0, 2.0], [3.0]]]}).encode(), 400),
    (json.dumps({"inputs": [np.zeros((2, 5, 6, 3)).tolist()]}).encode(), 400),
    (json.dumps({"inputs": [[1.0], [2.0]]}).encode(), 400),
], ids=["not-json", "empty-inputs", "no-inputs-key", "ragged", "wrong-shape",
        "wrong-arity"])
def test_server_rejects_malformed_requests_with_400(nets, body, code):
    _, net = nets
    server = InferenceServer(net).start(port=0)
    try:
        got, raw = _http(server.port, "/predict", raw=body)
        assert got == code and "error" in json.loads(raw)
        got, _ = _http(server.port, "/nowhere")
        assert got == 404
        got, _ = _http(server.port, "/predict/other", body={"inputs": [[1]]})
        assert got == 404
        # the server keeps serving after a bad request
        got, raw = _http(server.port, "/predict",
                         {"inputs": [_images(1, 0).tolist()]})
        assert got == 200
    finally:
        server.stop()


def test_unbatched_server_matches_jax(nets):
    jnet, net = nets
    server = InferenceServer(net, batching=None).start(port=0)
    try:
        x = _images(3, seed=7, uint8=True)
        code, raw = _http(server.port, "/predict", {"inputs": [x.tolist()]})
        assert code == 200
        np.testing.assert_allclose(
            np.asarray(json.loads(raw)["outputs"][0], np.float32),
            np.asarray(jnet.output(x)), **TOL)
        assert server.warmup() == {"buckets": [], "forwards": 0}
    finally:
        server.stop()


def test_coalesced_launch_demuxes_each_callers_rows(nets):
    jnet, net = nets
    with InferenceEngine(net, BatchingConfig(max_batch=16,
                                             max_delay_ms=0.0)) as eng:
        eng._ensure_thread = lambda: None  # this test is the dispatcher
        xs = [_images(n, seed=10 + n) for n in (1, 3, 2)]
        reqs = [eng.submit((x,)) for x in xs]
        batch = eng._take_batch()
        assert len(batch) == 3  # one shared launch for all three callers
        eng._launch(batch)
        for req, x in zip(reqs, xs):
            got = eng.result(req)
            assert got.shape == (x.shape[0], 4)
            np.testing.assert_allclose(got, np.asarray(jnet.output(x)), **TOL)


def test_request_validation_happens_at_submit(nets):
    _, net = nets
    with InferenceEngine(net) as eng:
        with pytest.raises(BadRequestError):
            eng.submit((_images(2, 0), _images(2, 1)))  # arity
        with pytest.raises(BadRequestError):
            eng.submit((np.zeros((2, 5, 6, 3), np.float32),))  # shape
        with pytest.raises(BadRequestError):
            eng.submit((np.zeros((0,) + IMG, np.float32),))  # empty batch
        with pytest.raises(BadRequestError):
            eng.submit(())
        assert eng.queue_depth() == 0


def test_full_queue_rejects_and_deadline_expires(nets):
    _, net = nets
    eng = InferenceEngine(net, BatchingConfig(max_queue=2))
    try:
        eng._ensure_thread = lambda: None  # keep requests queued
        r1 = eng.submit((_images(1, 0),), timeout_ms=1.0)
        eng.submit((_images(1, 1),))
        with pytest.raises(ServerOverloadedError):
            eng.submit((_images(1, 2),))
        time.sleep(0.01)
        with eng._cond:
            eng._expire_locked(time.monotonic())
        with pytest.raises(DeadlineExpiredError):
            eng.result(r1)
        assert eng.queue_depth() == 1
    finally:
        eng.close()


def test_breaker_opens_after_failed_launches_and_sheds(nets):
    _, net = nets
    breaker = CircuitBreaker(failure_threshold=2, recovery_timeout_s=60.0,
                             name="torch-serving-test")
    plan = FaultPlan().inject("serving.launch")
    with InferenceEngine(net, breaker=breaker, retry=None) as eng, \
            plan.armed():
        for _ in range(2):
            with pytest.raises(RuntimeError, match="injected fault"):
                eng.predict(_images(1, 0))
        assert breaker.state == "open"
        with pytest.raises(CircuitOpenError):
            eng.submit((_images(1, 0),))
    assert plan.fired("serving.launch") == 2


def test_retry_absorbs_one_transient_launch_failure(nets):
    jnet, net = nets
    plan = FaultPlan().inject("serving.launch", on_calls=[1])
    x = _images(2, seed=3)
    with InferenceEngine(net) as eng, plan.armed():
        np.testing.assert_allclose(eng.predict(x), np.asarray(jnet.output(x)),
                                   **TOL)
    assert plan.invocations("serving.launch") == 2
    snap = telemetry.REGISTRY.snapshot()
    assert snap.get('dl4j_retries_total{op="serving.launch"}', 0) >= 1


def test_watchdog_fails_a_stuck_launch_and_keeps_serving(nets):
    """A launch stuck for 3 s fails under a 1 s watchdog; the healthy
    launch after it runs under the same watchdog and finishes in
    milliseconds, so a loaded machine cannot trip it."""
    jnet, net = nets
    plan = FaultPlan().inject("serving.launch", on_calls=[1],
                              action="delay", delay_s=3.0)
    cfg = BatchingConfig(launch_timeout_ms=1000.0)
    with InferenceEngine(net, cfg, retry=None) as eng, plan.armed():
        with pytest.raises(LaunchTimeoutError):
            eng.predict(_images(1, 0))
        x = _images(2, seed=4)
        np.testing.assert_allclose(eng.predict(x), np.asarray(jnet.output(x)),
                                   **TOL)


def test_close_fails_pending_requests(nets):
    _, net = nets
    eng = InferenceEngine(net)
    eng._ensure_thread = lambda: None
    req = eng.submit((_images(1, 0),))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.result(req)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit((_images(1, 0),))


def test_http_traceparent_round_trip_and_trace_chain(nets):
    """Tracing on: an inbound W3C traceparent's trace id is adopted with a
    fresh span id, the request's trace records the batcher's lifecycle, and
    an error response echoes the caller's header verbatim."""
    _, net = nets
    from deeplearning4j_tpu_torch.telemetry import tracing

    tracing.enable(seed=2, sample_every=1)
    server = InferenceServer(net).start(port=0)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    hdr = f"00-{'ab' * 16}-{'cd' * 8}-01"

    def post(body):
        return urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=body,
            headers={"Content-Type": "application/json", "traceparent": hdr})

    try:
        body = json.dumps({"inputs": [_images(2, 5).tolist()]}).encode()
        with opener.open(post(body), timeout=60) as resp:
            echoed = tracing.parse_traceparent(resp.headers["traceparent"])
            assert json.loads(resp.read())["outputs"]
        assert echoed is not None and echoed[0] == "ab" * 16
        assert echoed[1] != "cd" * 8
        with pytest.raises(urllib.error.HTTPError) as err:
            opener.open(post(b'{"nope": 1}'), timeout=60)
        assert err.value.code == 400 and err.value.headers["traceparent"] == hdr
    finally:
        server.stop()
        tracing.disable()
    (trace,) = [t for t in tracing.traces() if t.status == "ok"]
    assert trace.trace_id == "ab" * 16 and trace.parent_id == "cd" * 8
    assert [e[0] for e in trace.events] == [
        "queued", "admitted", "grouped", "launched", "demuxed"]
    assert trace.duration_ms() > 0
    assert tracing.stats()["finished"] == 1
    tracing.reset()


# --------------------------------------------------------------------------
# hot publish, typed warmup, and the multi-tenant HTTP surfaces
# --------------------------------------------------------------------------

def _other_version(net, seed):
    """The same graph with other seeded weights (a newly trained version:
    the same configuration, so the same envelopes)."""
    other = ComputationGraph(net.conf, device="cpu").init()
    rng = np.random.default_rng(seed)
    flat = net.params_flat()
    return other.set_params_flat(
        flat + rng.normal(0, 0.5, flat.shape).astype(flat.dtype))


def test_publish_is_atomic_per_batch(nets):
    """Concurrent clients across repeated publishes: every answer is one
    version's output for its rows, every coalesced launch (a trace's batch
    id) served one version only, and no publish adds an envelope."""
    from deeplearning4j_tpu_torch.optimize import aot_cache
    from deeplearning4j_tpu_torch.telemetry import tracing

    _, net = nets
    v2 = _other_version(net, seed=3)
    versions = (net, v2)
    tracing.enable(seed=3, sample_every=1)
    eng = InferenceEngine(net, BatchingConfig(
        max_batch=8, max_delay_ms=20.0, settle_ms=3.0))
    answers, errors = [], []
    try:
        eng.warmup()
        miss0 = aot_cache.stats()["misses"]
        stop = threading.Event()

        def client(c):
            try:
                for i in range(8):
                    x = _images(1 + (c + i) % 3, seed=100 * c + i)
                    y, tr = eng.predict_traced(x)
                    answers.append((x, y, tr))
            except Exception as e:  # reported below, never swallowed
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        def publisher():
            k = 0
            while not stop.is_set():
                k += 1
                eng.publish(versions[k % 2])
                time.sleep(0.004)

        pub = threading.Thread(target=publisher)
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        pub.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        stop.set()
        pub.join(timeout=60)
        assert not pub.is_alive()
        assert not any(t.is_alive() for t in clients)
        assert not errors, errors
        assert aot_cache.stats()["misses"] == miss0
    finally:
        eng.close()
        tracing.disable()
        tracing.reset()
    by_batch, served = {}, set()
    for x, y, tr in answers:
        near = [v for v, m in enumerate(versions)
                if np.allclose(y, m.output(x), **TOL)]
        assert len(near) == 1, "an answer matches neither version"
        served.add(near[0])
        (launch,) = [a for name, _, a in tr.events if name == "launched"]
        by_batch.setdefault(launch["batch"], set()).add(near[0])
    assert all(len(vs) == 1 for vs in by_batch.values()), by_batch
    assert len(answers) == 48 and len(by_batch) < 48
    assert served == {0, 1}


def test_warmup_dtype_runs_one_variant(nets):
    """``warmup(dtype=...)`` runs that input dtype only: uint8 requests
    then find their envelopes, float32 requests meet new ones."""
    from deeplearning4j_tpu_torch.optimize import aot_cache

    aot_cache.clear()
    _, net = nets
    with InferenceEngine(net, BatchingConfig(max_batch=4)) as eng:
        warm = eng.warmup(dtype=np.uint8)
        assert warm["buckets"] == [1, 2, 4]
        assert warm["forwards"] == warm["compiled"] == 3
        miss0 = aot_cache.stats()["misses"]
        eng.predict(_images(3, seed=1, uint8=True))
        assert aot_cache.stats()["misses"] == miss0
        eng.predict(_images(3, seed=1))
        assert aot_cache.stats()["misses"] == miss0 + 1
        full = eng.warmup()
        assert full["forwards"] == 6 and full["compiled"] == 2


@pytest.fixture
def platform(nets, tmp_path):
    """Two image tenants (the fixture graph, and another version of it) on
    the port's platform, on the CPU."""
    from deeplearning4j_tpu_torch.parallel.platform import (
        ModelPlatform,
        ModelRegistry,
        TenantConfig,
    )

    _, net = nets
    reg = ModelRegistry(tmp_path)
    reg.publish("img", net)
    reg.publish("other", _other_version(net, seed=5))
    plat = ModelPlatform(reg, seed=3, host_max_pending=2, device="cpu")
    cfg = TenantConfig(batching=BatchingConfig(max_batch=4))
    plat.deploy("img", config=cfg)
    plat.deploy("other", config=cfg)
    server = InferenceServer(plat).start(port=0)
    yield plat, server
    server.stop()
    plat.close()


def test_platform_http_routes_models_and_health(nets, platform):
    """``/predict/<model>`` answers as the tenant's network (uint8 pixels
    ride as uint8, as in single-model mode); an unknown model is a named
    404; ``/models`` and ``/healthz`` carry one entry per tenant."""
    jnet, _ = nets
    plat, server = platform
    x = _images(2, seed=7, uint8=True)
    code, raw = _http(server.port, "/predict/img", {"inputs": [x.tolist()]})
    assert code == 200, raw
    np.testing.assert_allclose(json.loads(raw)["outputs"][0],
                               np.asarray(jnet.output(x)), **TOL)
    assert plat.engine("img").model is not None
    code, raw = _http(server.port, "/predict/ghost",
                      {"inputs": [x.tolist()]})
    body = json.loads(raw)
    assert code == 404 and "ghost" in body["error"]
    assert body["models"] == ["img", "other"]
    code, raw = _http(server.port, "/model")
    assert code == 404 and json.loads(raw)["models"] == ["img", "other"]
    code, raw = _http(server.port, "/models")
    models = json.loads(raw)["models"]
    assert code == 200 and sorted(models) == ["img", "other"]
    assert models["img"]["version"] == 1
    code, raw = _http(server.port, "/healthz")
    health = json.loads(raw)
    assert health["status"] == "ok"
    assert health["models"]["other"] == {"version": 1, "queue_depth": 0,
                                         "breaker": "closed"}


def test_platform_http_model_and_host_503s(platform):
    """A tenant whose breaker opened sheds with ``scope="model"`` and its
    breaker state, and ``/healthz`` names it; the host cap sheds every
    tenant with ``scope="host"``, a class and body a client can tell
    apart."""
    from deeplearning4j_tpu_torch.resilience.faults import FaultPlan

    plat, server = platform
    body = {"inputs": [_images(1, seed=8).tolist()]}
    with FaultPlan(seed=8).inject("serving.launch:other").armed():
        for _ in range(6):
            _http(server.port, "/predict/other", body)
        code, raw = _http(server.port, "/predict/other", body)
    shed = json.loads(raw)
    assert code == 503
    assert (shed["model"], shed["scope"], shed["breaker"]) == (
        "other", "model", "open")
    health = json.loads(_http(server.port, "/healthz")[1])
    assert health["status"] == "shedding"
    assert health["shedding_models"] == ["other"]
    # the host cap (2 pending over every tenant): park img's dispatcher
    eng = plat.engine("img")
    eng._ensure_thread = lambda: None
    held = [eng.submit((_images(1, seed=9),)) for _ in range(2)]
    try:
        code, raw = _http(server.port, "/predict/img", body)
        host = json.loads(raw)
        assert code == 503 and host["scope"] == "host"
        assert "breaker" not in host and "host overloaded" in host["error"]
    finally:
        del eng.__dict__["_ensure_thread"]
        eng._ensure_thread()
        for h in held:
            assert h.event.wait(60)
