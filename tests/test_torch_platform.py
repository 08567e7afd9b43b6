"""The port's multi-tenant serving platform (``parallel/platform.py``) on the
CPU, held against the JAX package's: the versioned registry with
digest-refused corruption, the atomic hot swap behind the ``model.swap``
fault site, seeded canary routing with deterministic rollback, per-tenant
isolation (quotas, the host cap, warmup budgets, breakers), the named HTTP
404 / 503 surfaces, the platform's metrics, and a generation tenant. Each
test of ``tests/test_platform.py`` has its counterpart here (the UI half of
``test_platform_metrics_and_ui_surfaces`` is not ported).

Across the packages: a registry directory written by either loads in the
other (same manifest digests; outputs at rtol 1e-5, atol 1e-6, float32:
the two packages' CPU matmuls sum in other orders), a tampered zip is
refused by both, and one ``(seed, model, fraction)`` sends the same request
indices to the canary, and the same canary hits to the accuracy arm, in
both. The chaos run rolls back at the JAX package's request index.

"Zero recompiles" reads "zero new envelopes" here (``optimize.aot_cache``:
the first forward at a new (graph signature, input shapes, dtypes, device)
is a miss). The envelope set is process-global, so each test starts from a
cleared cache and reads deltas.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import platform as jplat
from deeplearning4j_tpu.parallel.batcher import BatchingConfig as JBatching
from deeplearning4j_tpu.resilience import FaultPlan as JFaultPlan
from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.parallel.batcher import (
    BatchingConfig,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.parallel.platform import (
    CanaryGate,
    HostOverloadedError,
    ModelIntegrityError,
    ModelPlatform,
    ModelRegistry,
    TenantConfig,
    UnknownModelError,
)
from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
from deeplearning4j_tpu_torch.resilience import FaultPlan
from deeplearning4j_tpu_torch.resilience.faults import InjectedFault
from deeplearning4j_tpu_torch.telemetry import REGISTRY

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-6)
TIMEOUT = 30  # seconds any thread or HTTP call of a test may wait


@pytest.fixture(autouse=True)
def fresh_envelopes():
    aot_cache.clear()
    yield


def _jmlp(seed=0, hidden=8, n_in=4, n_out=3):
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=hidden, activation=JAct.TANH))
            .layer(JOut(n_out=n_out, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(n_in)).build())
    return JMLN(conf).init()


def _mlp(seed=0, hidden=8, n_in=4, n_out=3):
    """The JAX ``_mlp``'s configuration in the port (seeded weights of the
    port's own initializer)."""
    conf = MultiLayerConfiguration.from_json(
        _jmlp(seed, hidden, n_in, n_out).conf.to_json())
    return MultiLayerNetwork(conf, "cpu").init()


def _x(rows=2, n_in=4, seed=0):
    return np.random.default_rng(seed).normal(
        size=(rows, n_in)).astype(np.float32)


def _bump(net, delta=0.1):
    """A "newly trained" version: the same configuration, other weights."""
    net2 = MultiLayerNetwork(net.conf, "cpu").init()
    net2.set_params_flat(np.asarray(net.params_flat()) + delta)
    return net2


def _cfg(**over):
    over.setdefault("max_batch", 4)
    return TenantConfig(batching=BatchingConfig(**over))


def _plat(reg=None, **kw):
    return ModelPlatform(reg, device="cpu", **kw)


# --- registry ---------------------------------------------------------------

def test_registry_publish_load_roundtrip(tmp_path):
    reg = ModelRegistry(tmp_path)
    v1 = reg.publish("m", _mlp(seed=1))
    v2 = reg.publish("m", _mlp(seed=2))
    assert (v1, v2) == (1, 2)
    assert reg.models() == ["m"]
    assert reg.versions("m") == [1, 2]
    assert reg.latest_version("m") == 2
    assert reg.verify("m", 1) and reg.verify("m", 2)
    x = _x()
    net1, ver1 = reg.load("m", 1, device="cpu")
    latest, ver = reg.load("m", device="cpu")
    assert (ver1, ver) == (1, 2)
    assert str(latest.device) == "cpu"
    assert not np.array_equal(net1.output(x), latest.output(x))
    assert np.array_equal(latest.output(x),
                          reg.load("m", 2, device="cpu")[0].output(x))


def test_registry_unknown_model_and_version(tmp_path):
    reg = ModelRegistry(tmp_path)
    with pytest.raises(UnknownModelError, match="unknown model 'ghost'"):
        reg.load("ghost", device="cpu")
    reg.publish("m", _mlp())
    with pytest.raises(UnknownModelError, match="no version 9"):
        reg.load("m", 9, device="cpu")
    with pytest.raises(ValueError, match="invalid model name"):
        reg.publish("../escape", _mlp())


def test_registry_digest_mismatch_refused(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp(seed=1))
    reg.publish("m", _mlp(seed=2))
    with open(tmp_path / "m" / "v0002.zip", "ab") as f:
        f.write(b"bitrot")
    assert reg.verify("m", 1) and not reg.verify("m", 2)
    with pytest.raises(ModelIntegrityError, match="sha256 mismatch"):
        reg.load("m", 2, device="cpu")
    assert reg.load("m", 1, device="cpu")[1] == 1


def test_registry_load_fault_retried(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp())
    key = 'dl4j_retries_total{op="model.load"}'
    r0 = REGISTRY.snapshot(run_collectors=False).get(key, 0)
    with FaultPlan(seed=1).inject("model.load", on_calls=[1]).armed():
        net, ver = reg.load("m", device="cpu")
    assert ver == 1 and net is not None
    assert REGISTRY.snapshot(run_collectors=False).get(key, 0) == r0 + 1
    with FaultPlan(seed=1).inject("model.load", on_calls=[1, 2]).armed():
        with pytest.raises(InjectedFault):
            reg.load("m", device="cpu")


def test_kill_mid_publish_leaves_prior_verified(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp(seed=1))
    with FaultPlan(seed=2).inject("checkpoint.write", on_calls=[1]).armed():
        with pytest.raises(InjectedFault):
            reg.publish("m", _mlp(seed=2))
    assert reg.versions("m") == [1]
    assert reg.verify("m")
    assert not list((tmp_path / "m").glob("*.tmp.*"))
    assert reg.load("m", device="cpu")[1] == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_directory_crosses_packages(tmp_path, writer):
    """A registry written by one package loads in the other: the same
    manifest keys and digests, outputs equal to the writer's network, and
    the reader's own digest check refuses a tampered zip."""
    jnet = _jmlp(seed=4, hidden=9)
    x = _x(rows=3, seed=4)
    if writer == "jax":
        jplat.ModelRegistry(tmp_path).publish("m", jnet)
        ref = np.asarray(jnet.output(x))
    else:
        net = _mlp(seed=4, hidden=9)
        ModelRegistry(tmp_path).publish("m", net)
        ref = net.output(x)
    jreg, preg = jplat.ModelRegistry(tmp_path), ModelRegistry(tmp_path)
    ent = json.loads((tmp_path / "m" / "versions.json").read_text())
    assert sorted(ent["versions"][0]) == ["file", "model_class", "sha256",
                                          "version"]
    assert ent["versions"][0]["file"] == "v0001.zip"
    assert preg.digest("m") == jreg.digest("m") == ent["versions"][0][
        "sha256"]
    assert preg.verify("m") and jreg.verify("m")
    pnet, pver = preg.load("m", device="cpu")
    jnet2, jver = jreg.load("m")
    assert pver == jver == 1
    np.testing.assert_allclose(pnet.output(x), ref, **TOL)
    np.testing.assert_allclose(np.asarray(jnet2.output(x)), ref, **TOL)
    with open(tmp_path / "m" / "v0001.zip", "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ModelIntegrityError, match="sha256 mismatch"):
        preg.load("m", device="cpu")
    with pytest.raises(jplat.ModelIntegrityError, match="sha256 mismatch"):
        jreg.load("m")


# --- deploy / swap ----------------------------------------------------------

def test_deploy_predict_and_stats(tmp_path):
    """A deployed tenant answers as the JAX package's network does on the
    same params (the registry carries the JAX package's zip)."""
    jnet = _jmlp(seed=1)
    jplat.ModelRegistry(tmp_path).publish("m", jnet)
    with _plat(ModelRegistry(tmp_path)) as plat:
        out = plat.deploy("m", config=_cfg())
        assert out["version"] == 1 and not out["warmup_truncated"]
        x = _x()
        y = np.asarray(plat.predict("m", x))
        assert y.shape == (2, 3)
        np.testing.assert_allclose(y, np.asarray(jnet.output(x)), **TOL)
        st = plat.stats()["m"]
        assert st["version"] == 1
        assert st["breaker"] == "closed"
        assert st["warmup_budget"]["compiles"] >= 0
        with pytest.raises(UnknownModelError, match="unknown model"):
            plat.predict("ghost", x)


def test_swap_atomic_and_fault_mid_swap(tmp_path):
    reg = ModelRegistry(tmp_path)
    v1 = _mlp(seed=1, hidden=27)
    reg.publish("m", v1)
    reg.publish("m", _bump(v1))
    x = _x()
    with _plat(reg) as plat:
        plat.deploy("m", version=1, config=_cfg())
        y1 = np.asarray(plat.predict("m", x)).tobytes()
        with FaultPlan(seed=3).inject("model.swap", on_calls=[1]).armed():
            with pytest.raises(InjectedFault):
                plat.swap("m", 2)
        assert plat.stats()["m"]["version"] == 1
        assert np.asarray(plat.predict("m", x)).tobytes() == y1
        miss0 = aot_cache.stats()["misses"]
        assert plat.swap("m", 2)["version"] == 2
        y2 = np.asarray(plat.predict("m", x)).tobytes()
        assert y2 != y1
        assert aot_cache.stats()["misses"] == miss0
        assert plat.stats()["m"]["version"] == 2


def test_swap_to_corrupt_version_refused(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp(seed=1))
    reg.publish("m", _mlp(seed=2))
    with open(tmp_path / "m" / "v0002.zip", "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    x = _x()
    with _plat(reg) as plat:
        plat.deploy("m", version=1, config=_cfg())
        y1 = np.asarray(plat.predict("m", x)).tobytes()
        with pytest.raises(ModelIntegrityError):
            plat.swap("m", 2)
        assert plat.stats()["m"]["version"] == 1
        assert np.asarray(plat.predict("m", x)).tobytes() == y1


def test_wedged_swap_keeps_incumbent_serving(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("m", _mlp(seed=1))
    reg.publish("m", _mlp(seed=2))
    x = _x()
    with _plat(reg) as plat:
        plat.deploy("m", version=1, config=_cfg())
        y1 = np.asarray(plat.predict("m", x)).tobytes()
        done = threading.Event()

        def slow_swap():
            with FaultPlan(seed=4).inject(
                    "model.swap", action="delay", delay_s=0.4).armed():
                plat.swap("m", 2)
            done.set()

        t = threading.Thread(target=slow_swap, daemon=True)
        t.start()
        served = 0
        while not done.is_set() and served < 50:
            assert np.asarray(plat.predict("m", x)).tobytes() == y1
            served += 1
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert done.is_set() and served > 0
        assert plat.stats()["m"]["version"] == 2


# --- isolation: quotas, host cap, warmup budgets ----------------------------

def _park(engine):
    """Hold the engine's dispatcher (the serving suite's inert idiom), so
    submitted requests stay queued."""
    engine._ensure_thread = lambda: None


def _unpark(engine, held):
    del engine.__dict__["_ensure_thread"]
    engine._ensure_thread()
    for h in held:
        assert h.event.wait(TIMEOUT)
        engine.result(h)


def test_quota_flood_isolated_to_one_tenant(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("a", _mlp(seed=1, hidden=8))
    reg.publish("b", _mlp(seed=2, hidden=10))
    x = _x()
    with _plat(reg, seed=5) as plat:
        plat.deploy("a", config=_cfg())
        plat.deploy("b", config=_cfg(max_queue=2))
        ya = np.asarray(plat.predict("a", x)).tobytes()
        miss0 = aot_cache.stats()["misses"]
        eng_b = plat.engine("b")
        _park(eng_b)
        held = [eng_b.submit([x]) for _ in range(2)]
        with pytest.raises(ServerOverloadedError, match="model 'b'"):
            eng_b.submit([x])
        for _ in range(3):
            assert np.asarray(plat.predict("a", x)).tobytes() == ya
        _unpark(eng_b, held)
        assert aot_cache.stats()["misses"] == miss0


def test_host_overload_distinct_from_model_shed(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("a", _mlp(seed=1, hidden=8))
    reg.publish("b", _mlp(seed=2, hidden=10))
    x = _x()
    with _plat(reg, host_max_pending=2) as plat:
        plat.deploy("a", config=_cfg())
        plat.deploy("b", config=_cfg(max_queue=64))
        eng_b = plat.engine("b")
        _park(eng_b)
        held = [eng_b.submit([x]) for _ in range(2)]
        with pytest.raises(HostOverloadedError, match="host overloaded"):
            plat.predict("a", x)
        assert issubclass(HostOverloadedError, ServerOverloadedError)
        _unpark(eng_b, held)
        assert np.asarray(plat.predict("a", x)).shape == (2, 3)


def test_warmup_budget_truncates_only_that_tenant(tmp_path):
    from deeplearning4j_tpu_torch.analysis.findings import LOG

    reg = ModelRegistry(tmp_path)
    reg.publish("cheap", _mlp(seed=1, hidden=29))
    reg.publish("storm", _mlp(seed=2, hidden=31))
    with _plat(reg) as plat:
        out = plat.deploy("cheap", config=_cfg(max_batch=4))
        assert not out["warmup_truncated"]
        assert out["warmup"]["compiled"] == 3  # buckets 1, 2, 4
        cfg = _cfg(max_batch=8)
        cfg.warmup_max_compiles = 2
        storm = plat.deploy("storm", config=cfg)
        assert storm["warmup_truncated"]
        assert storm["warmup"]["compiles"] == 2  # charged, then refused
        assert any(f.rule == "PLT301" and "storm" in f.location
                   for f in LOG.items())
        # the tenant still serves: its unwarmed buckets run cold
        assert np.asarray(plat.predict("storm", _x())).shape == (2, 3)
        miss0 = aot_cache.stats()["misses"]
        plat.predict("cheap", _x())
        assert aot_cache.stats()["misses"] == miss0


# --- canary -----------------------------------------------------------------

def _chaos_run(reg, x, seed, package):
    """One canary-chaos pass in ``package``; returns (rollback record,
    healthy co-tenant and post-rollback bytes pinned, new envelopes (the
    port's), sheds)."""
    fault_plan = JFaultPlan if package == "jax" else FaultPlan
    if package == "jax":
        plat = jplat.ModelPlatform(reg, seed=seed)
        cfg = jplat.TenantConfig(batching=JBatching(max_batch=4))
        gate = jplat.CanaryGate(max_consecutive_failures=3)
    else:
        plat = _plat(reg, seed=seed)
        cfg = _cfg()
        gate = CanaryGate(max_consecutive_failures=3)
    try:
        plat.deploy("good", version=1, config=cfg)
        plat.deploy("bad", version=1, config=cfg)
        y_good = np.asarray(plat.predict("good", x)).tobytes()
        y_bad_v1 = np.asarray(plat.predict("bad", x)).tobytes()
        plat.deploy_canary("bad", 2, fraction=0.5, gate=gate)
        miss0 = aot_cache.stats()["misses"]
        plan = fault_plan(seed=11).inject("serving.launch:bad#canary")
        pinned, sheds = True, 0
        with plan.armed():
            for _ in range(30):
                try:
                    plat.predict("bad", x)
                except Exception:
                    sheds += 1
                pinned = pinned and (np.asarray(
                    plat.predict("good", x)).tobytes() == y_good)
        rollback = plat.stats()["bad"].get("last_rollback")
        post = np.asarray(plat.predict("bad", x)).tobytes()
        recompiles = aot_cache.stats()["misses"] - miss0
    finally:
        plat.close()
    return rollback, pinned and post == y_bad_v1, recompiles, sheds


def test_canary_rollback_chaos_deterministic(tmp_path):
    """A seeded fault plan degrades the canary mid-traffic, the gate trips,
    rollback restores the incumbent, and the run replays: the same seed
    rolls back at the same request index, in both runs of the port and in
    the JAX package's run, with the co-tenant's bytes pinned and no new
    envelope."""
    reg = ModelRegistry(tmp_path)
    reg.publish("good", _mlp(seed=1, hidden=8))
    bad_v1 = _mlp(seed=2, hidden=12)
    reg.publish("bad", bad_v1)
    reg.publish("bad", _bump(bad_v1))
    x = _x()
    r1 = _chaos_run(reg, x, 9, "port")
    r2 = _chaos_run(reg, x, 9, "port")
    for rollback, restored, recompiles, sheds in (r1, r2):
        assert rollback is not None, "gate never tripped"
        assert rollback["version"] == 2
        assert "consecutive canary failures" in rollback["reason"]
        assert restored, "co-tenant or post-rollback bytes diverged"
        assert recompiles == 0
        assert sheds >= 3
    assert r1[0]["at_request"] == r2[0]["at_request"]
    assert r1[0]["canary"]["requests"] == r2[0]["canary"]["requests"]
    rj = _chaos_run(jplat.ModelRegistry(tmp_path), x, 9, "jax")
    assert rj[0]["at_request"] == r1[0]["at_request"]
    assert rj[0]["canary"] == r1[0]["canary"]
    assert rj[3] == r1[3]
    snap = REGISTRY.snapshot(run_collectors=False)
    assert snap['dl4j_circuit_state{breaker="serving:bad#canary"}'] == 0


def test_canary_promote_zero_recompiles(tmp_path):
    reg = ModelRegistry(tmp_path)
    v1 = _mlp(seed=1, hidden=14)
    reg.publish("m", v1)
    reg.publish("m", _bump(v1))
    x = _x()
    with _plat(reg, seed=2) as plat:
        plat.deploy("m", version=1, config=_cfg())
        y1 = np.asarray(plat.predict("m", x)).tobytes()
        plat.deploy_canary("m", 2, fraction=0.5)
        miss0 = aot_cache.stats()["misses"]
        for _ in range(10):
            plat.predict("m", x)
        st = plat.stats()["m"]["canary"]
        assert st["requests"] > 0 and st["failures"] == 0
        out = plat.promote("m")
        assert out["version"] == 2
        y2 = np.asarray(plat.predict("m", x)).tobytes()
        assert y2 != y1
        assert "canary" not in plat.stats()["m"]
        assert aot_cache.stats()["misses"] == miss0
        with pytest.raises(RuntimeError, match="no canary"):
            plat.promote("m")


def test_canary_fraction_routing_is_seeded(tmp_path):
    reg = ModelRegistry(tmp_path)
    v1 = _mlp(seed=1, hidden=16)
    reg.publish("m", v1)
    reg.publish("m", _bump(v1))
    x = _x()

    def arm_counts(seed):
        with _plat(reg, seed=seed) as plat:
            plat.deploy("m", version=1, config=_cfg())
            plat.deploy_canary("m", 2, fraction=0.3,
                               gate=CanaryGate(min_requests=10 ** 6))
            for _ in range(40):
                plat.predict("m", x)
            st = plat.stats()["m"]
            return st["canary"]["requests"], st["requests"]

    a, b, c = arm_counts(1), arm_counts(1), arm_counts(2)
    assert a == b
    assert a[0] > 0 and a[1] > 0
    assert a != c


def _canary_trace(plat, n, x, key):
    """The request indices (1-based) at which ``stats()["m"]["canary"]
    [key]`` grew."""
    hits, last = [], 0
    for i in range(1, n + 1):
        plat.predict("m", x)
        now = plat.stats()["m"]["canary"][key]
        if now != last:
            hits.append(i)
            last = now
    return hits


@pytest.mark.parametrize("arm", ["routing", "accuracy"])
def test_canary_streams_equal_across_packages(tmp_path, arm):
    """One (seed, model, fraction) routes the same request indices to the
    canary in both packages over 200 requests; with the accuracy arm on,
    the same canary hits are sampled for the shadow compare."""
    jnet = _jmlp(seed=6, hidden=7)
    jreg = jplat.ModelRegistry(tmp_path)
    jreg.publish("m", jnet)
    jreg.publish("m", jnet)
    x = _x(rows=1, seed=6)
    if arm == "routing":
        fraction, n, key, kw = 0.3, 200, "requests", {}
    else:
        fraction, n, key, kw = 1.0, 60, "accuracy_samples", dict(
            max_accuracy_delta=1e9, accuracy_sample=0.4)
    jp = jplat.ModelPlatform(jreg, seed=17)
    try:
        jp.deploy("m", version=1, config=jplat.TenantConfig(
            batching=JBatching(max_batch=1)))
        jp.deploy_canary("m", 2, fraction=fraction, gate=jplat.CanaryGate(
            min_requests=10 ** 6, **kw))
        want = _canary_trace(jp, n, x, key)
    finally:
        jp.close()
    with _plat(ModelRegistry(tmp_path), seed=17) as pp:
        pp.deploy("m", version=1, config=_cfg(max_batch=1))
        pp.deploy_canary("m", 2, fraction=fraction, gate=CanaryGate(
            min_requests=10 ** 6, **kw))
        got = _canary_trace(pp, n, x, key)
    assert got == want
    assert 0 < len(got) < n


# --- breaker aggregation (/health) ------------------------------------------

def test_health_aggregates_breakers_per_model_name():
    from deeplearning4j_tpu_torch.resilience.breaker import CircuitBreaker

    primary = CircuitBreaker(name="serving:agg-test", failure_threshold=1)
    canary = CircuitBreaker(name="serving:agg-test#canary",
                            failure_threshold=1)
    primary.on_success()
    canary.on_failure()
    st = resilience.status()["circuit_breakers"]["serving:agg-test"]
    assert st["state"] == "open"
    assert st["breakers"] == 2
    assert sorted(st["states"]) == ["closed", "open"]
    assert st["tripped_total"] == 1


# --- HTTP surfaces ----------------------------------------------------------

def _post(base, path, payload):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with opener.open(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(base + path, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_http_named_404_and_503(tmp_path):
    reg = ModelRegistry(tmp_path)
    reg.publish("alpha", _mlp(seed=1, hidden=8))
    reg.publish("beta", _mlp(seed=2, hidden=10))
    x = [[0.1, 0.2, 0.3, 0.4]]
    with _plat(reg, seed=1) as plat:
        plat.deploy("alpha", config=_cfg())
        plat.deploy("beta", config=_cfg())
        srv = InferenceServer(plat).start(port=0)
        try:
            base = f"http://127.0.0.1:{srv.port}"
            code, body = _post(base, "/predict/alpha", {"inputs": [x]})
            assert code == 200 and len(body["outputs"][0]) == 1
            np.testing.assert_allclose(
                body["outputs"][0],
                plat.engine("alpha").model.output(np.asarray(x, np.float32)),
                **TOL)
            code, body = _post(base, "/models/beta/predict",
                               {"inputs": [x]})
            assert code == 200
            code, body = _post(base, "/predict/ghost", {"inputs": [x]})
            assert code == 404
            assert "ghost" in body["error"]
            assert body["models"] == ["alpha", "beta"]
            code, body = _post(base, "/predict", {"inputs": [x]})
            assert code == 404 and body["models"] == ["alpha", "beta"]
            code, body = _post(base, "/predict/alpha",
                               {"inputs": [[[0.1, 0.2]]]})
            assert code == 400
            code, body = _post(base, "/predict/alpha",
                               {"inputs": [[[0.1, 0.2], [0.3]]]})
            assert code == 400 and "malformed" in body["error"]
            with FaultPlan(seed=8).inject("serving.launch:beta").armed():
                for _ in range(6):
                    _post(base, "/predict/beta", {"inputs": [x]})
                code, body = _post(base, "/predict/beta", {"inputs": [x]})
            assert code == 503
            assert body["model"] == "beta"
            assert body["scope"] == "model"
            assert body["breaker"] == "open"
            health = _get(base, "/healthz")
            assert health["status"] == "shedding"
            assert health["shedding_models"] == ["beta"]
            assert health["models"]["alpha"]["breaker"] == "closed"
            models = _get(base, "/models")["models"]
            assert models["beta"]["breaker"] == "open"
            code, _ = _post(base, "/predict/alpha", {"inputs": [x]})
            assert code == 200
        finally:
            srv.stop()


# --- metrics ----------------------------------------------------------------

def test_platform_metrics_and_ui_surfaces(tmp_path):
    """The metrics half of the JAX test (the UI panel is not ported)."""
    reg = ModelRegistry(tmp_path)
    v1 = _mlp(seed=1, hidden=18)
    reg.publish("mtr", v1)
    reg.publish("mtr", _bump(v1))
    x = _x()
    with _plat(reg, seed=1) as plat:
        plat.deploy("mtr", version=1, config=_cfg())
        plat.predict("mtr", x)
        snap = REGISTRY.snapshot()
        assert snap[
            'dl4j_serving_requests_total{model="mtr",status="ok"}'] >= 1
        assert 'dl4j_platform_queue_depth{model="mtr"}' in snap
        assert 'dl4j_platform_warmup_compiles{model="mtr"}' in snap
        plat.swap("mtr", 2)
        snap = REGISTRY.snapshot(run_collectors=False)
        assert snap['dl4j_platform_swap_total{model="mtr"}'] >= 1


# --- generation tenants -----------------------------------------------------

def test_generation_tenant_deploy_and_generate():
    """A zoo LM config deployed as a generation tenant on the platform's
    device: its stream equals sequential ``generate`` on the same weights,
    and its named series and breaker are visible."""
    from deeplearning4j_tpu_torch.parallel.generation import GenerationConfig
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    lm = TransformerEncoder(vocab_size=16, embed_dim=8, n_heads=2,
                            n_layers=1, max_len=16, causal=True,
                            lm_head=True, seed=5)
    with _plat(seed=1) as plat:
        out = plat.deploy_generation(
            "lm", model=lm,
            config=GenerationConfig(max_batch=2, fused_steps=2,
                                    kv_bucket_min=8, prompt_bucket_min=4))
        assert out["model"] == "lm"
        toks = plat.generate("lm", [1, 2, 3], max_new_tokens=4)
        assert len(toks) >= 1
        dec = lm.decoder(device="cpu", max_batch=2, kv_bucket_min=8,
                         prompt_bucket_min=4)
        assert toks == dec.generate([1, 2, 3], 4, fused_steps=2)
        snap = REGISTRY.snapshot(run_collectors=False)
        assert snap[
            'dl4j_decode_requests_total{model="lm",status="ok"}'] >= 1
        assert "serving:lm" in resilience.status()["circuit_breakers"]
        assert plat.stats()["lm"]["generation"]["queue_depth"] == 0
        with pytest.raises(UnknownModelError, match="generation model"):
            plat.generate("nope", [1, 2])
