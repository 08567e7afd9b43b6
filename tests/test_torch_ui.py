"""The training UI (``ui/stats.py``, ``ui/server.py``) and
``AotCacheStatsListener`` in the port against the JAX package.

Networks: a dense MLP (4 -> 8 tanh -> 3 softmax) and a two-layer graph of
the same widths, each the JAX configuration's JSON on the JAX network's
params, trained 3 SGD(0.1) steps on the same numpy batch in both
packages. ``StatsListener`` records are held to the JAX ones: the scores
and per-layer mean magnitudes at rtol 1e-5 (float32 sums in other orders
than XLA's), the update magnitudes and log ratios at rtol 1e-4 (an update
is the difference of two nearby float32 params, whose rounding the
subtraction magnifies), the histograms' ranges at rtol 1e-5 and their
counts exactly unless a value lies within rounding of a bin edge (then
one element may sit one bin over). The files of ``FileStatsStorage`` are
shared by the packages. The HTTP surface runs on 127.0.0.1 with port 0.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ui import FileStatsStorage as JFileStatsStorage
from deeplearning4j_tpu.ui import InMemoryStatsStorage as JInMemory
from deeplearning4j_tpu.ui import StatsListener as JStatsListener
from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.optimize.listeners import AotCacheStatsListener
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
from deeplearning4j_tpu_torch.telemetry import REGISTRY, flightrec, health
from deeplearning4j_tpu_torch.ui import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsListener,
    UIServer,
    collect_system_metrics,
)
from deeplearning4j_tpu_torch.ui import server as ui_server
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-5
UPDATE_RTOL = 1e-4
BINS = 16
_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _clean():
    health.disable()
    health.MONITOR.reset()
    flightrec.RECORDER.disable().reset()
    REGISTRY.reset()
    yield
    health.disable()
    health.MONITOR.reset()
    flightrec.RECORDER.disable().reset()
    REGISTRY.reset()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jconf(kind):
    b = JNNC.builder().seed(5).updater(JSgd(0.1))
    if kind == "mln":
        return (b.list()
                .layer(JDense(n_out=8, activation=JAct.TANH))
                .layer(JOut(n_out=3, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
                .set_input_type(JIT.feed_forward(4)).build())
    return (b.graph_builder().add_inputs("in")
            .add_layer("d", JDense(n_out=8, activation=JAct.TANH), "in")
            .add_layer("out", JOut(n_out=3, activation=JAct.SOFTMAX,
                                   loss_fn=JMCXENT()), "d")
            .set_outputs("out").set_input_types(JIT.feed_forward(4))
            .build())


def _pair(kind="mln"):
    jconf = _jconf(kind)
    if kind == "mln":
        jnet = JMLN(jconf).init()
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        cls = MultiLayerNetwork
    else:
        jnet = JGraph(jconf).init()
        conf = ComputationGraphConfiguration.from_json(jconf.to_json())
        cls = ComputationGraph
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return cls(conf, "cpu").set_params(p, s), jnet


def _xy(seed=0, n=16, bad=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    if bad:
        x[0, 0] = np.nan
    return x, y


def _get(port, path):
    with _NO_PROXY.open(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(port, path, data):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with _NO_PROXY.open(req, timeout=10) as r:
        return r.status


def _strict(body: bytes):
    return json.loads(body.decode(), parse_constant=lambda c: pytest.fail(
        f"bare {c} literal in strict JSON"))


# --------------------------------------------------------------------------
# StatsListener against the JAX listener
# --------------------------------------------------------------------------

def _records(kind, histograms=True):
    net, jnet = _pair(kind)
    x, y = _xy()
    probe = (x[:8], y[:8])
    storage, jstorage = InMemoryStatsStorage(), JInMemory()
    net.set_listeners(StatsListener(
        storage, frequency=1, histograms=histograms, histogram_bins=BINS,
        sample_ds=DataSet(*probe) if histograms else None,
        system_metrics=False, session_id="s"))
    jnet.set_listeners(JStatsListener(
        jstorage, frequency=1, histograms=histograms, histogram_bins=BINS,
        sample_ds=JDataSet(*probe) if histograms else None,
        system_metrics=False, session_id="s"))
    for _ in range(3):
        net.fit_batch(DataSet(x, y))
        jnet.fit_batch(JDataSet(x, y))
    return storage.records(), jstorage.records(), net


def _same_hist(h, jh):
    assert h["min"] == pytest.approx(jh["min"], rel=RTOL, abs=1e-7)
    assert h["max"] == pytest.approx(jh["max"], rel=RTOL, abs=1e-7)
    c, jc = np.asarray(h["counts"]), np.asarray(jh["counts"])
    assert c.sum() == jc.sum() and len(c) == len(jc) == BINS
    # an element within rounding of a bin edge may sit one bin over
    assert np.abs(c - jc).sum() <= 2


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_stats_records_match_the_jax_listener(kind):
    recs, jrecs, _ = _records(kind)
    assert len(recs) == len(jrecs) == 3
    for r, jr in zip(recs, jrecs):
        assert r["iteration"] == jr["iteration"]
        assert r["epoch"] == jr["epoch"]
        assert r["score"] == pytest.approx(jr["score"], rel=RTOL)
        assert r["param_mean_mag"].keys() == jr["param_mean_mag"].keys()
        for k, v in jr["param_mean_mag"].items():
            assert r["param_mean_mag"][k] == pytest.approx(v, rel=RTOL)
        for key in ("update_mean_mag", "update_param_ratio_log10"):
            assert (key in r) == (key in jr)
            for k, v in jr.get(key, {}).items():
                assert r[key][k] == pytest.approx(v, rel=UPDATE_RTOL)
        for key in ("param_histograms", "update_histograms",
                    "activation_histograms", "gradient_histograms"):
            assert (key in r) == (key in jr), key
            if key not in jr:
                continue
            assert r[key].keys() == jr[key].keys(), key
            for layer in jr[key]:
                _same_hist(r[key][layer], jr[key][layer])


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_records_without_histograms_match(kind):
    recs, jrecs, _ = _records(kind, histograms=False)
    for r, jr in zip(recs, jrecs):
        assert set(r) - {"timestamp", "iter_seconds"} == \
            set(jr) - {"timestamp", "iter_seconds"}
        assert r["score"] == pytest.approx(jr["score"], rel=RTOL)


def test_listener_frequency_collects_every_nth():
    net, _ = _pair()
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, frequency=2,
                                    system_metrics=False))
    x, y = _xy()
    for _ in range(5):
        net.fit_batch(DataSet(x, y))
    assert [r["iteration"] for r in storage.records()] == [0, 2, 4]


def test_host_params_is_one_copy_of_every_float_param():
    net, _ = _pair()
    host = StatsListener(InMemoryStatsStorage())._host_params(net)
    for k, vp in net.params.items():
        for pk, v in vp.items():
            np.testing.assert_array_equal(host[k][pk], v.numpy())


def test_system_metrics_block():
    aot_cache.clear()
    sysm = collect_system_metrics()
    assert sysm["host_rss_mb"] > 0
    assert set(sysm["aot_cache"]) >= {"hits", "misses", "entries"}
    assert sysm["devices"] == {"cpu": {}}


# --------------------------------------------------------------------------
# FileStatsStorage: one file format for both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_stats_storage_is_shared(tmp_path, writer):
    recs, _, _ = _records("mln", histograms=False)
    path = str(tmp_path / "stats.jsonl")
    w = FileStatsStorage(path) if writer == "port" else \
        JFileStatsStorage(path)
    for r in recs:
        w.put(r)
    r_cls = JFileStatsStorage if writer == "port" else FileStatsStorage
    back = r_cls(path).records()
    assert back == json.loads(json.dumps(recs))


def test_file_stats_storage_skips_corrupt_lines(tmp_path):
    path = tmp_path / "stats.jsonl"
    path.write_text('{"iteration": 0}\n{"iterat\n[1, 2]\n{"iteration": 1}\n')
    st = FileStatsStorage(str(path))
    assert [r["iteration"] for r in st.records()] == [0, 1]
    assert st.corrupt_lines == 2


# --------------------------------------------------------------------------
# the live server
# --------------------------------------------------------------------------

@pytest.fixture
def live():
    recs, _, _ = _records("mln")
    storage = InMemoryStatsStorage()
    for r in recs:
        storage.put(r)
    ui = UIServer().attach(storage)
    port = ui.start(port=0)
    try:
        yield ui, port
    finally:
        ui.stop()


@pytest.mark.parametrize("path,ctype", [
    ("/", "text/html"), ("/train", "text/html"),
    ("/train/overview", "text/html"),
    ("/train/stats.json", "application/json"),
    ("/metrics", "text/plain"), ("/metrics.json", "application/json"),
    ("/platform", "application/json"), ("/analysis", "application/json"),
    ("/traces", "application/json"), ("/slo", "application/json"),
    ("/health", "application/json"),
])
def test_get_endpoints_answer(live, path, ctype):
    _, port = live
    status, got_type, body = _get(port, path)
    assert status == 200 and got_type.startswith(ctype)
    if ctype == "application/json":
        _strict(body)
    if ctype == "text/html":
        text = body.decode()
        assert "Model score" in text and "<svg" in text
        assert "http-equiv='refresh'" in text


def test_stats_json_holds_the_records(live):
    _, port = live
    stats = _strict(_get(port, "/train/stats.json")[2])
    assert [r["iteration"] for r in stats] == [0, 1, 2]


def test_sharding_answers_501_naming_what_it_waits_for(live):
    """``/sharding`` no longer waits: ``sharding/plan.py`` is ported, and
    the endpoint answers 200 with ``plans_summary()``, as the JAX
    package's does (the name is kept from when it answered 501)."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.sharding import ShardingPlan
    from deeplearning4j_tpu_torch.sharding.rules import P

    _, port = live
    plan = ShardingPlan([(r"W$", P(None, "model")), (".*", P())],
                        mesh=Mesh(data=2, data_rank=0, model=2),
                        demote_indivisible=True)
    plan.param_specs({"0": {"W": np.zeros((4, 16), np.float32)}})
    status, ctype, body = _get(port, "/sharding")
    assert status == 200 and ctype.startswith("application/json")
    plans = json.loads(body)
    assert any(p["mesh"] == {"data": 2, "model": 2} for p in plans)
    assert not hasattr(ui_server, "SHARDING_WAITS_FOR")


def test_unknown_path_is_404(live):
    _, port = live
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nope")
    assert ei.value.code == 404


@pytest.mark.parametrize("path,data,code", [
    ("/train/post", b"42", 400),
    ("/train/post", b"{not json", 400),
    ("/train/elsewhere", b"{}", 404),
])
def test_post_rules(live, path, data, code):
    _, port = live
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, path, data)
    assert ei.value.code == code


def test_post_over_the_limit_is_413():
    ui = UIServer()
    port = ui.start(port=0, max_body_bytes=64)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/train/post", json.dumps({"x": "y" * 100}).encode())
        assert ei.value.code == 413
        assert _post(port, "/train/post", b'{"iteration": 0}') == 200
        assert ui.remote_storage().records() == [{"iteration": 0}]
    finally:
        ui.stop()


def test_get_instance_is_one_server():
    assert UIServer.get_instance() is UIServer.get_instance()


def test_render_writes_the_dashboard(tmp_path):
    recs, _, _ = _records("mln")
    storage = InMemoryStatsStorage()
    for r in recs:
        storage.put(r)
    ui = UIServer().attach(storage)
    text = open(ui.render(str(tmp_path / "dash.html"))).read()
    for title in ("Model score", "Parameter histograms", "Update histograms",
                  "Activation histograms", "Gradient histograms"):
        assert title in text
    ui.detach(storage)
    assert "No stats collected yet" in ui.render_html()


# --------------------------------------------------------------------------
# the remote router: async delivery, retries, the stats.flush site
# --------------------------------------------------------------------------

def test_remote_router_delivers_to_the_server():
    ui = UIServer()
    port = ui.start(port=0)
    try:
        router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}")
        net, _ = _pair()
        net.set_listeners(StatsListener(router, frequency=1,
                                        system_metrics=False))
        x, y = _xy()
        for _ in range(3):
            net.fit_batch(DataSet(x, y))
        assert router.flush(timeout=30)
        assert len(ui.remote_storage().records()) == 3
        assert router.dropped == 0
        assert "Model score" in ui.render_html()
    finally:
        ui.stop()


@pytest.mark.parametrize("fail_calls,delivered,dropped", [
    ([1], 1, 0),          # the first attempt fails, the retry delivers
    ([1, 2, 3], 0, 1),    # every attempt fails: the record is dropped
])
def test_router_retries_then_drops_under_the_flush_site(fail_calls,
                                                        delivered, dropped):
    ui = UIServer()
    port = ui.start(port=0)
    try:
        router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}",
                                            retries=3)
        router._retry.base_delay_s = 0.01
        plan = FaultPlan(seed=3).inject("stats.flush", on_calls=fail_calls)
        with plan.armed():
            router.put({"iteration": 0})
            assert router.flush(timeout=30)
        assert len(ui.remote_storage().records()) == delivered
        assert router.dropped == dropped
        assert router.records() == [{"iteration": 0}]
    finally:
        ui.stop()


def test_router_survives_a_dashboard_outage():
    ui = UIServer()
    port = ui.start(port=0)
    ui.stop()
    router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}",
                                        retries=1, timeout=0.5)
    net, _ = _pair()
    net.set_listeners(StatsListener(router, frequency=1,
                                    system_metrics=False))
    x, y = _xy()
    net.fit_batch(DataSet(x, y))  # the server is down: no exception
    assert router.flush(timeout=10.0)
    assert router.dropped == 1


# --------------------------------------------------------------------------
# /health: the monitor's report and the resilience block, strict JSON
# --------------------------------------------------------------------------

def test_health_is_strict_json_with_a_nan_in_the_report():
    health.configure(policy="warn", record_flights=False)
    net, _ = _pair()
    net.fit_batch(DataSet(*_xy(bad=True)))
    ui = UIServer()
    port = ui.start(port=0)
    try:
        rep = _strict(_get(port, "/health")[2])
    finally:
        ui.stop()
    assert rep["status"] == "anomalous"
    assert rep["nonfinite_steps"] == 1
    assert rep["last"]["grad_norm"] == "NaN"
    assert rep["resilience"]["fault_plan_armed"] is False


def test_health_carries_the_resume_counter_and_the_pod_block():
    from deeplearning4j_tpu_torch import telemetry

    telemetry.record_resume(scope="host")
    telemetry.record_pod_hosts(2)
    telemetry.record_pod_snapshot_seconds(0.5)
    ui = UIServer()
    port = ui.start(port=0)
    try:
        rep = _strict(_get(port, "/health")[2])
    finally:
        ui.stop()
    res = rep["resilience"]
    assert res["counters"]['dl4j_resumes_total{scope="host"}'] == 1
    assert res["pod"]["hosts"] == 2
    assert res["pod"]["series"]["dl4j_pod_snapshot_seconds"]["count"] == 1
    assert resilience.status()["pod"] == res["pod"]


# --------------------------------------------------------------------------
# AotCacheStatsListener
# --------------------------------------------------------------------------

def test_aot_cache_listener_reports_every_nth(capsys):
    aot_cache.clear()
    net, _ = _pair()
    lst = AotCacheStatsListener(frequency=2)
    net.set_listeners(lst)
    x, y = _xy()
    for _ in range(4):
        net.fit_batch(DataSet(x, y))
    assert [h["iteration"] for h in lst.history] == [0, 2]
    assert set(lst.history[0]) >= {"hits", "misses", "entries",
                                   "compile_seconds"}
    assert capsys.readouterr().out.count("[aot-cache]") == 2
