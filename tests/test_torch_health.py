"""The training health layer in the port against the JAX package:
``telemetry.health`` (guard vectors, the four policies on both networks'
standard, tBPTT and fused paths), ``telemetry.flightrec`` (bundles), the
rest of ``telemetry.spans``, ``telemetry.export``, ``HealthListener`` and
``earlystopping.DivergenceTerminationCondition``.

Networks: a dense MLP (4 -> 8 relu -> 3 softmax) and a two-layer graph of
the same widths, an LSTM(6) + RnnOutputLayer MultiLayerNetwork and graph
under tBPTT (two segments of 3), each the JAX configuration's JSON on the
JAX network's params; SGD(0.05) so an update is the gradient times the
rate. A batch is poisoned with one NaN feature.

Tolerances: the guard vector's flags exactly; the loss, the gradient,
update and param norms, their ratio and every bucket's norm rtol 1e-5
(float32 sums in other orders than XLA's); SKIP_STEP and ROLLBACK leave
params, updater state and layer state bit-identical (``torch.equal``).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBP
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.telemetry import REGISTRY as JREGISTRY
from deeplearning4j_tpu.telemetry import flightrec as jflightrec
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu.telemetry import spans as jspans
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import HealthListener
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
from deeplearning4j_tpu_torch.telemetry import REGISTRY, flightrec, health
from deeplearning4j_tpu_torch.telemetry import spans
from deeplearning4j_tpu_torch.telemetry.health import (
    GUARD_GRAD_NONFINITE,
    GUARD_GRAD_NORM,
    GUARD_HEAD,
    GUARD_LOSS,
    GUARD_LOSS_NONFINITE,
    GUARD_RATIO,
    DivergenceError,
)
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.health]

RTOL = 1e-5
SEG, T = 3, 6  # tBPTT: two segments


def _clean():
    for h, rec, reg in ((health, flightrec.RECORDER, REGISTRY),
                        (jhealth, jflightrec.RECORDER, JREGISTRY)):
        h.disable()
        h.MONITOR.reset()
        rec.disable().reset()
        rec._conf_digest = None
        reg.reset()


@pytest.fixture(autouse=True)
def _clean_health():
    """Both packages' health switches are process-global: every test
    starts and ends with them off and the recorders and metrics empty."""
    _clean()
    yield
    _clean()


# --------------------------------------------------------------------------
# networks
# --------------------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jconf(kind):
    b = JNNC.builder().seed(7).updater(JSgd(0.05))
    if kind == "mln":
        return (b.list()
                .layer(JDense(n_out=8, activation=JAct.RELU))
                .layer(JOut(n_out=3, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
                .set_input_type(JIT.feed_forward(4)).build())
    if kind == "mln_tbptt":
        return (b.list()
                .layer(jrnn.LSTM(n_out=6))
                .layer(jrnn.RnnOutputLayer(n_out=3,
                                           activation=JAct.SOFTMAX))
                .backprop_type(JBP.TRUNCATED_BPTT, fwd=SEG, back=SEG)
                .set_input_type(JIT.recurrent(4, T)).build())
    g = b.graph_builder().add_inputs("in")
    if kind == "graph":
        return (g.set_input_types(JIT.feed_forward(4))
                .add_layer("d", JDense(n_out=8, activation=JAct.RELU), "in")
                .add_layer("out", JOut(n_out=3, activation=JAct.SOFTMAX,
                                       loss_fn=JMCXENT()), "d")
                .set_outputs("out").build())
    return (g.set_input_types(JIT.recurrent(4, T))
            .add_layer("l", jrnn.LSTM(n_out=6), "in")
            .add_layer("out", jrnn.RnnOutputLayer(
                n_out=3, activation=JAct.SOFTMAX), "l")
            .set_outputs("out")
            .backprop_type(JBP.TRUNCATED_BPTT, fwd=SEG, back=SEG).build())


def _pair(kind):
    """(port network, JAX network) on the same params."""
    jconf = _jconf(kind)
    if kind.startswith("mln"):
        jnet = JMLN(jconf).init()
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        cls = MultiLayerNetwork
    else:
        jnet = JGraph(jconf).init()
        conf = ComputationGraphConfiguration.from_json(jconf.to_json())
        cls = ComputationGraph
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return cls(conf, "cpu").set_params(p, s), jnet


def _net(kind="mln"):
    return _pair(kind)[0]


def _xy(kind, seed, bad=False):
    rng = np.random.default_rng(seed)
    if kind.endswith("tbptt"):
        x = rng.normal(size=(8, T, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, T))]
        if bad:
            x[0, T - 1, 0] = np.nan  # the last segment only
    else:
        x = rng.normal(size=(16, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        if bad:
            x[0, 0] = np.nan
    return x, y


def _ds(kind, seed, bad=False):
    return DataSet(*_xy(kind, seed, bad))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _training_state(net):
    return _copy({"params": net.params, "opt": net.opt_state,
                  "state": net.state})


def _finite(net) -> bool:
    return all(bool(torch.isfinite(v).all()) for vp in net.params.values()
               for v in vp.values())


def _path(kind):
    return "multilayer" if kind.startswith("mln") else "graph"


# --------------------------------------------------------------------------
# guard-vector math, against the JAX functions
# --------------------------------------------------------------------------

def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


def test_guard_vector_math_matches_jax():
    grads = {"0": {"w": jnp.asarray([[3.0, 4.0]])},
             "1": {"w": jnp.asarray([0.0, 0.0])}}
    params = {"0": {"w": jnp.asarray([[1.0, 0.0]])},
              "1": {"w": jnp.asarray([2.0, 0.0])}}
    new = {"0": {"w": jnp.asarray([[1.0, 1.0]])},
           "1": {"w": jnp.asarray([2.0, 0.0])}}
    v = health.guard_vector(torch.tensor(1.5), _t(grads), params=_t(params),
                            new_params=_t(new)).numpy()
    assert v[GUARD_LOSS] == pytest.approx(1.5)
    assert v[GUARD_LOSS_NONFINITE] == 0.0 and v[GUARD_GRAD_NONFINITE] == 0.0
    assert v[GUARD_GRAD_NORM] == pytest.approx(5.0)
    assert v[GUARD_RATIO] == pytest.approx(1.0 / np.sqrt(5.0), rel=1e-5)
    assert health.bucket_keys(grads) == ("0", "1")
    assert v[GUARD_HEAD] == pytest.approx(5.0)
    assert v[GUARD_HEAD + 1] == pytest.approx(0.0)
    jv = np.asarray(jhealth.guard_vector(jnp.float32(1.5), grads,
                                         params=params, new_params=new))
    np.testing.assert_allclose(v, jv, rtol=RTOL)


def test_guard_vector_flags_nonfinite_like_jax():
    grads = {"a": jnp.asarray([1.0, np.nan, 2.0]),
             "b": jnp.asarray([0.5, np.inf])}
    for loss in (np.nan, 1.0):
        v = health.guard_vector(torch.tensor(loss, dtype=torch.float32),
                                _t(grads)).numpy()
        jv = np.asarray(jhealth.guard_vector(jnp.float32(loss), grads))
        assert v[GUARD_LOSS_NONFINITE] == jv[GUARD_LOSS_NONFINITE] \
            == float(np.isnan(loss))
        assert v[GUARD_GRAD_NONFINITE] == jv[GUARD_GRAD_NONFINITE] == 1.0
    # pre-reduced squared sums finish the same vector
    sq = [torch.tensor(9.0), torch.tensor(16.0)]
    np.testing.assert_allclose(
        health.guard_vector_from_sq(torch.tensor(1.0), sq).numpy(),
        np.asarray(jhealth.guard_vector_from_sq(jnp.float32(1.0),
                                                [9.0, 16.0])), rtol=RTOL)


def test_combine_is_elementwise_max_and_keeps_nan():
    vecs = torch.tensor([[1.0, 0.0, 0.0], [0.5, 1.0, 3.0]])
    np.testing.assert_array_equal(health.combine(vecs).numpy(),
                                  [1.0, 1.0, 3.0])
    with_nan = torch.tensor([[1.0, np.nan], [2.0, 0.0]])
    assert np.isnan(health.combine(with_nan).numpy()[1])
    assert np.isnan(np.asarray(jhealth.combine(with_nan.numpy()))[1])


def test_apply_skip_selects_old_on_anomaly():
    old, new = {"w": torch.zeros(3)}, {"w": torch.ones(3)}
    bad = torch.zeros(GUARD_HEAD + 1)
    bad[GUARD_GRAD_NONFINITE] = 1.0
    (kept,) = health.apply_skip(bad, (new,), (old,))
    assert torch.equal(kept["w"], torch.zeros(3))
    (taken,) = health.apply_skip(torch.zeros(GUARD_HEAD + 1), (new,), (old,))
    assert torch.equal(taken["w"], torch.ones(3))


def test_loss_guard_vector():
    v = health.loss_guard_vector(torch.tensor(float("inf"))).numpy()
    jv = np.asarray(jhealth.loss_guard_vector(jnp.float32(np.inf)))
    np.testing.assert_array_equal(v, jv)
    assert v.shape == (GUARD_HEAD + 1,) and v[GUARD_LOSS_NONFINITE] == 1.0


@pytest.mark.parametrize("kind", ["mln", "graph", "mln_tbptt",
                                  "graph_tbptt"])
@pytest.mark.parametrize("bad", [False, True], ids=["healthy", "poisoned"])
def test_step_guard_vectors_match_jax(kind, bad):
    """One step (a tBPTT batch: the max over its segments) under WARN in
    both packages: the monitor's last vector and bucket keys."""
    net, jnet = _pair(kind)
    health.configure("warn", record_flights=False)
    jhealth.configure("warn", record_flights=False)
    x, y = _xy(kind, 1, bad)
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    rep, jrep = health.report(), jhealth.report()
    assert rep["nonfinite_steps"] == jrep["nonfinite_steps"] == int(bad)
    v = np.asarray(health.MONITOR.last_vec)
    jv = np.asarray(jhealth.MONITOR.last_vec)
    assert health.MONITOR.last_keys == tuple(jhealth.MONITOR.last_keys)
    assert v.shape == jv.shape
    np.testing.assert_array_equal(v[[GUARD_LOSS_NONFINITE,
                                     GUARD_GRAD_NONFINITE]],
                                  jv[[GUARD_LOSS_NONFINITE,
                                      GUARD_GRAD_NONFINITE]])
    np.testing.assert_allclose(v, jv, rtol=RTOL, equal_nan=True)


# --------------------------------------------------------------------------
# the policies on both networks' standard, tBPTT and fused paths
# --------------------------------------------------------------------------

KINDS = {"standard": ("mln", "graph"), "tbptt": ("mln_tbptt", "graph_tbptt"),
         "fused": ("mln", "graph")}
CASES = [(k, path) for path, kinds in KINDS.items() for k in kinds]


def _fit(net, kind, path, batches):
    if path == "fused":
        net.fit(ListDataSetIterator(batches), fused_steps=2)
    else:
        for ds in batches:
            net.fit(ds)


def _reference(kind, path, good_fits):
    """A twin network trained on ``good_fits`` (lists of batches, each a
    fit) with the health layer off: the state a discarded or rolled-back
    step must leave."""
    ref = _net(kind)
    mode, health._MODE = health._MODE, ""
    try:
        for batches in good_fits:
            _fit(ref, kind, path, batches)
    finally:
        health._MODE = mode
    return ref


def _poisoned_batches(kind, path):
    """(first fit, poisoned fit, the reference's fits for SKIP_STEP):
    fused groups pair a healthy batch with the poisoned one; a tBPTT
    batch is poisoned in its last segment only, so its first segment
    trains."""
    good, bad = _ds(kind, 1), _ds(kind, 2, bad=True)
    if path == "fused":
        g2 = _ds(kind, 3)
        return [good], [g2, bad], [[good], [g2]]
    if path == "tbptt":
        x, y = _xy(kind, 2)
        head = DataSet(x[:, :SEG], y[:, :SEG])
        return [good], [bad], [[good], [head]]
    return [good], [bad], [[good]]


@pytest.mark.parametrize("kind,path", CASES)
def test_warn_counts_and_trains_on(kind, path):
    health.configure("warn", record_flights=False)
    net = _net(kind)
    first, poisoned, _ = _poisoned_batches(kind, path)
    _fit(net, kind, path, first)
    _fit(net, kind, path, poisoned)
    rep = health.report()
    assert rep["nonfinite_steps"] == 1 and rep["status"] == "anomalous"
    assert rep["skipped_steps"] == 0
    assert REGISTRY.snapshot()[
        f'dl4j_nonfinite_steps_total{{path="{_path(kind)}"}}'] == 1
    assert not _finite(net)  # WARN applied the poisoned update


@pytest.mark.parametrize("kind,path", CASES)
def test_skip_step_leaves_training_state_bit_identical(kind, path):
    health.configure("skip_step", record_flights=False)
    net = _net(kind)
    first, poisoned, ref_fits = _poisoned_batches(kind, path)
    _fit(net, kind, path, first)
    _fit(net, kind, path, poisoned)
    ref = _reference(kind, path, ref_fits)
    assert _equal(_training_state(net), _training_state(ref))
    assert health.report()["skipped_steps"] == 1
    before = _copy(net.params)
    _fit(net, kind, path, first)  # a healthy step trains again
    assert not _equal(before, net.params) and _finite(net)


@pytest.mark.parametrize("kind,path", CASES)
def test_rollback_restores_the_last_good_snapshot(kind, path):
    health.configure("rollback", snapshot_every=1, record_flights=False)
    net = _net(kind)
    first, poisoned, _ = _poisoned_batches(kind, path)
    _fit(net, kind, path, first)
    good, good_iter = _training_state(net), net.iteration
    _fit(net, kind, path, poisoned)
    assert _equal(_training_state(net), good)
    assert net.iteration == good_iter
    assert health.MONITOR.rollbacks == 1
    assert REGISTRY.snapshot()[
        f'dl4j_rollbacks_total{{path="{_path(kind)}"}}'] == 1
    _fit(net, kind, path, first)
    assert _finite(net)


@pytest.mark.parametrize("kind,path", CASES)
def test_halt_raises_divergence_error(kind, path):
    health.configure("halt", record_flights=False)
    net = _net(kind)
    first, poisoned, _ = _poisoned_batches(kind, path)
    _fit(net, kind, path, first)
    with pytest.raises(DivergenceError) as ei:
        _fit(net, kind, path, poisoned)
    assert ei.value.path == _path(kind)
    assert health.MONITOR.halted and health.report()["status"] == "halted"
    if path == "fused":
        assert ei.value.step == 3
        assert "step 3 (step 2/2 of the fused super-step)" in str(ei.value)


def test_fused_halt_names_the_step_like_jax():
    net, jnet = _pair("mln")
    health.configure("halt", record_flights=False)
    jhealth.configure("halt", record_flights=False)
    batches = [_xy("mln", 1), _xy("mln", 2), _xy("mln", 3, bad=True),
               _xy("mln", 4)]
    with pytest.raises(DivergenceError) as ei:
        net.fit(ListDataSetIterator([DataSet(*b) for b in batches]),
                fused_steps=2)
    with pytest.raises(jhealth.DivergenceError) as jei:
        jnet.fit(JListIt([JDataSet(*b) for b in batches]), fused_steps=2)
    assert ei.value.step == jei.value.step == 3
    assert str(ei.value).split(" (guard=")[0] == \
        str(jei.value).split(" (guard=")[0]


def test_detection_on_the_step_it_occurs():
    """HALT fires on the first anomalous step, not at the epoch's end."""
    health.configure("halt", record_flights=False)
    net = _net()
    batches = [_ds("mln", 1), _ds("mln", 2, bad=True), _ds("mln", 3)]
    with pytest.raises(DivergenceError) as ei:
        net.fit(ListDataSetIterator(batches))
    assert ei.value.step == 2 and net.iteration == 2


def test_rollback_without_a_snapshot_halts():
    health.configure("rollback", record_flights=False)
    with pytest.raises(DivergenceError, match="no last-good snapshot"):
        _net().fit(_ds("mln", 2, bad=True))


def test_fault_plan_corrupts_an_image_batch_under_skip_step():
    """``train.step``'s corrupt action on a channels-last image batch
    (the element the JAX package's NHWC batch poisons) trips the guard."""
    from deeplearning4j_tpu_torch.zoo import LeNet

    health.configure("skip_step", record_flights=False)
    net = LeNet(num_classes=3, height=8, width=8).init("cpu")
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(4, 8, 8, 1)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)])
    net.fit(ds)
    before = _training_state(net)
    with FaultPlan().inject("train.step", on_calls=[1],
                            action="corrupt").armed():
        net.fit(ds)
    assert _equal(_training_state(net), before)
    assert health.report()["skipped_steps"] == 1


def test_warn_and_skip_read_nothing_on_the_host_until_a_flush(monkeypatch):
    reads = []
    real = health._host
    monkeypatch.setattr(health, "_host", lambda v: reads.append(1) or real(v))
    # WARN applies the poisoned update, so every later step is NaN too
    for policy, bad_steps in (("warn", 3), ("skip_step", 1)):
        health.configure(policy, flush_every=100, record_flights=False)
        net = _net()
        for s in range(5):
            net.fit(_ds("mln", s, bad=(s == 2)))
        assert reads == [] and health.MONITOR.steps == 5
        assert health.report()["nonfinite_steps"] == bad_steps
        assert len(reads) == 1  # the five vectors in one transfer
        reads.clear()
    health.configure("warn", flush_every=2, record_flights=False)
    net = _net()
    for s in range(4):
        net.fit(_ds("mln", s))
    assert len(reads) == 2


def test_mode_change_between_fits():
    net = _net()
    net.fit(_ds("mln", 1))
    health.configure("warn", record_flights=False)
    net.fit(_ds("mln", 2))
    assert health.report()["steps"] == 1
    health.disable()
    net.fit(_ds("mln", 3))
    assert health.report()["steps"] == 1 and net.iteration == 3


def test_skipped_flag_false_never_counts_discards():
    health.configure("skip_step", record_flights=False)
    bad = torch.zeros(GUARD_HEAD + 1)
    bad[GUARD_LOSS_NONFINITE] = 1.0
    health.MONITOR.on_step(bad, keys=("all",), path="pipeline", skipped=False)
    rep = health.report()
    assert rep["nonfinite_steps"] == 1 and rep["skipped_steps"] == 0


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------

def _strict(text, name):
    return json.loads(text, parse_constant=lambda c: pytest.fail(
        f"bare {c} literal in {name}"))


def test_bundle_schema_roundtrip(tmp_path):
    rec = flightrec.FlightRecorder(capacity=8)
    rec.enable()
    for i in range(12):  # overflows the ring: the last 8 stay
        rec.record_step("multilayer", i, 0, score=torch.tensor(float(i)),
                        guard=torch.zeros(GUARD_HEAD + 2),
                        guard_keys=("0", "1"), lr=0.05, rng_seed=7,
                        batch_fp=[[[16, 4], "float32"]])
    out = rec.dump_bundle(str(tmp_path / "bundle"), reason="test")
    assert sorted(os.listdir(out)) == ["manifest.json", "metrics.json",
                                       "records.jsonl", "trace.json",
                                       "traces.json"]
    manifest = json.loads((tmp_path / "bundle" / "manifest.json")
                          .read_text())
    assert manifest["reason"] == "test" and manifest["n_records"] == 8
    assert manifest["format_version"] == 1
    recs = [json.loads(line) for line in
            (tmp_path / "bundle" / "records.jsonl").read_text().splitlines()]
    assert recs[0]["step"] == 4 and recs[-1]["step"] == 11
    assert recs[0]["score"] == pytest.approx(4.0)
    assert len(recs[0]["guard"]) == GUARD_HEAD + 2
    assert recs[0]["guard_keys"] == ["0", "1"]
    assert recs[0]["batch"] == [[[16, 4], "float32"]]
    json.loads((tmp_path / "bundle" / "metrics.json").read_text())
    json.loads((tmp_path / "bundle" / "trace.json").read_text())


def test_halt_bundle_matches_the_jax_bundle(tmp_path, monkeypatch):
    """The same HALT in both packages: each bundle's five files parse
    strictly, and the records agree (step, path, keys, batch shapes and
    dtypes, the guard within tolerance, NaN as the string "NaN")."""
    net, jnet = _pair("mln")
    bundles = []
    for h, fr, n, ds in ((health, flightrec, net, DataSet),
                         (jhealth, jflightrec, jnet, JDataSet)):
        monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(tmp_path / h.__name__))
        h.configure("halt")  # enables the recorder too
        n.fit(ds(*_xy("mln", 1)))
        with pytest.raises(h.DivergenceError):
            n.fit(ds(*_xy("mln", 2, bad=True)))
        bundles.append(fr.RECORDER.last_bundle)
    docs = []
    for bundle in bundles:
        assert bundle and os.path.isdir(bundle)
        for name in ("manifest.json", "records.jsonl", "metrics.json",
                     "trace.json", "traces.json"):
            text = open(os.path.join(bundle, name)).read()
            for doc in (filter(None, text.splitlines())
                        if name.endswith(".jsonl") else [text]):
                _strict(doc, name)
        manifest = json.loads(open(os.path.join(bundle,
                                                "manifest.json")).read())
        assert "DivergenceError" in manifest["reason"]
        assert manifest["health"]["status"] == "halted"
        assert manifest["config_digest"]
        docs.append((manifest, [json.loads(line) for line in open(
            os.path.join(bundle, "records.jsonl"))]))
    (m, recs), (jm, jrecs) = docs
    assert sorted(m) == sorted(jm)
    assert len(recs) == len(jrecs) == 2
    for r, jr in zip(recs, jrecs):
        for k in ("path", "step", "epoch", "guard_keys", "batch", "rng_seed"):
            assert r[k] == jr[k], k
        g, jg = (np.asarray([np.nan if v == "NaN" else v for v in x],
                            np.float64) for x in (r["guard"], jr["guard"]))
        np.testing.assert_allclose(g, jg, rtol=RTOL, equal_nan=True)
    assert recs[-1]["score"] == jrecs[-1]["score"] == "NaN"
    assert recs[-1]["guard"][GUARD_LOSS_NONFINITE] == 1.0


def test_bundle_dumped_on_a_generic_uncaught_exception(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(tmp_path))
    health.configure("warn")

    class Boom(RuntimeError):
        pass

    class ExplodingIterator(ListDataSetIterator):
        def __iter__(self):
            yield from super().__iter__()
            raise Boom("data pipeline died")

    with pytest.raises(Boom):
        _net().fit(ExplodingIterator([_ds("mln", 1)]))
    manifest = json.loads(open(os.path.join(flightrec.RECORDER.last_bundle,
                                            "manifest.json")).read())
    assert "Boom" in manifest["reason"]
    assert manifest["n_records"] == 1


def test_bundles_keep_the_newest_n(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHTREC_KEEP", "2")
    rec = flightrec.FlightRecorder().enable()
    for i in range(4):
        rec.dump_bundle(str(tmp_path / f"bundle_{i}"), reason=str(i))
        os.utime(tmp_path / f"bundle_{i}", (1000 + i, 1000 + i))
    assert sorted(os.listdir(tmp_path)) == ["bundle_2", "bundle_3"]


def test_config_digest_tracks_the_current_model(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(tmp_path))
    health.configure("warn")
    _net("mln").fit(_ds("mln", 1))
    digest = flightrec.RECORDER._conf_digest
    _net("graph").fit(_ds("graph", 1))
    assert flightrec.RECORDER._conf_digest not in (None, digest)


def test_recorder_disabled_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(tmp_path))
    _net().fit(_ds("mln", 1))
    assert flightrec.RECORDER.last_bundle is None
    assert not os.listdir(str(tmp_path))
    assert flightrec.batch_fingerprint(torch.zeros(2, 3), None) == \
        jflightrec.batch_fingerprint(np.zeros((2, 3), np.float32), None)
    assert flightrec.sanitize_json([float("nan"), {"a": float("-inf")}]) \
        == ["NaN", {"a": "-Infinity"}]


# --------------------------------------------------------------------------
# surfaces: the listener, the termination condition, export, spans
# --------------------------------------------------------------------------

def test_health_listener_reports_and_registry_gauges():
    health.configure("warn", record_flights=False)
    stream = io.StringIO()
    net = _net()
    net.set_listeners(HealthListener(frequency=1, stream=stream))
    net.fit(_ds("mln", 1))
    net.fit(_ds("mln", 2, bad=True))
    out = stream.getvalue()
    assert "[health]" in out and "non-finite" in out
    assert net.listeners[0].history[-1]["nonfinite_steps"] == 1
    snap = REGISTRY.snapshot()
    assert "dl4j_grad_global_norm" in snap
    assert "dl4j_update_param_ratio" in snap


def test_divergence_termination_condition_matches_jax():
    net, jnet = _pair("mln")
    results = []
    for h, m, n, ds, lit in ((health, es, net, DataSet, ListDataSetIterator),
                             (jhealth, jes, jnet, JDataSet, JListIt)):
        h.configure("skip_step", record_flights=False)
        cfg = m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(50)],
            iteration_termination_conditions=[
                m.DivergenceTerminationCondition()])
        it = lit([ds(*_xy("mln", 1)), ds(*_xy("mln", 2, bad=True)),
                  ds(*_xy("mln", 3))])
        results.append(m.EarlyStoppingTrainer(cfg, n, it).fit())
    r, jr = results
    assert r.termination_reason is es.TerminationReason.ITERATION
    assert r.termination_reason.value == jr.termination_reason.value
    assert r.termination_details == jr.termination_details
    assert "DivergenceTerminationCondition" in r.termination_details
    assert "non-finite" in r.termination_details


def test_divergence_condition_reads_the_monitor():
    """A guard that tripped while the score looked finite ends the run."""
    health.configure("skip_step", record_flights=False)
    cond = es.DivergenceTerminationCondition()
    cond.initialize()
    assert not cond.terminate(1.0)
    bad = torch.zeros(GUARD_HEAD + 1)
    bad[GUARD_GRAD_NONFINITE] = 1.0
    health.MONITOR.on_step(bad, keys=("all",), path="multilayer")
    assert cond.terminate(1.0)
    assert "observed by the health monitor (policy skip_step)" in \
        cond.last_reason


def test_export_record_jsonl_and_listener(tmp_path):
    telemetry.enable()
    try:
        _net().fit(ListDataSetIterator([_ds("mln", s) for s in range(3)]))
        rec = telemetry.telemetry_record(session_id="s", iteration=3)
        assert rec["session"] == "s" and rec["iteration"] == 3
        assert rec["telemetry"][
            'dl4j_training_steps_total{path="multilayer"}'] == 3
        path = str(tmp_path / "t.jsonl")
        telemetry.dump_jsonl(path, extra={"run": "r01"})
        telemetry.dump_jsonl(path)
        lines = open(path).read().splitlines()
        assert len(lines) == 2 and json.loads(lines[0])["run"] == "r01"

        class Storage:
            def __init__(self):
                self.records = []

            def put(self, r):
                self.records.append(r)

        store = Storage()
        net = _net()
        net.set_listeners(telemetry.TelemetryListener(store, frequency=2))
        net.fit(ListDataSetIterator([_ds("mln", s) for s in range(4)]))
        assert [r["iteration"] for r in store.records] == [0, 2]
    finally:
        telemetry.disable()
        spans.reset()


def test_span_statistics_and_trace_match_jax(tmp_path):
    """The same ring in both packages gives the same phase statistics;
    the Chrome trace, events, annotations and the host-gap pause."""
    durs = [3_000_000, 1_000_000, 7_000_000, 2_000_000, 5_000_000]
    for mod in (spans, jspans):
        mod.reset()
        for i, d in enumerate(durs):
            mod._ring.append(("compute", 1000 * i, d, 0, None, 1, None))
    assert spans.phase_stats() == jspans.phase_stats()
    spans.reset()
    jspans.reset()
    spans.enable(ring_size=16)
    try:
        assert spans.enabled() and not spans.sync_mode()
        with spans.span("outer"):
            with spans.span("inner") as sp:
                sp.annotate(steps=2).set_result(torch.ones(2))
        spans.host_gap_reset()
        spans.host_gap_pause()
        spans.host_gap_resume()
        spans.host_gap_close(steps=4)
        ev = spans.events()
        assert [e["name"] for e in ev] == ["inner", "outer", "host_gap"]
        assert ev[0]["parent"] == "outer" and ev[0]["attrs"] == {"steps": 2}
        assert ev[2]["attrs"] == {"steps": 4}
        path = spans.export_chrome_trace(str(tmp_path / "t" / "trace.json"))
        trace = json.loads(open(path).read())
        assert [e["name"] for e in trace["traceEvents"]] == \
            ["inner", "outer", "host_gap"]
        assert trace["traceEvents"][0]["args"]["parent"] == "outer"
        spans.enable(sync=True, ring_size=16)
        assert spans.sync_mode()
        with spans.span("synced") as sp:
            sp.set_result({"a": torch.zeros(1)})
        assert spans.phase_stats()["synced"]["count"] == 1
    finally:
        spans.disable()
        spans.enable(ring_size=4096)
        spans.disable()
        spans.reset()


# --------------------------------------------------------------------------
# a NaN survives the GEMM epilogues, as in torch and XLA
# --------------------------------------------------------------------------

CLAMPING = ("relu", "relu6", "hardsigmoid", "hardtanh", "rectifiedtanh")


@pytest.mark.parametrize("name", CLAMPING)
def test_clamping_activations_keep_a_nan_like_jax(name):
    """The guards see a poisoned batch through its loss only if the
    clamping activations keep a NaN: the port's plain versions do, as the
    JAX package's do, and the CUDA epilogue (``csrc/activations.cuh``,
    rows 1 and 4) takes each through ``max0_f`` / ``clamp_f``, which keep
    one (``fmaxf`` / ``fminf`` returned the other operand)."""
    from deeplearning4j_tpu.conf import Activation as JA
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import build

    z = np.asarray([np.nan, -2.0, 0.25, 7.0], np.float32)
    port = Activation(name).apply(torch.from_numpy(z)).numpy()
    ref = np.asarray(JA(name).apply(jnp.asarray(z)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, equal_nan=True)
    assert np.isnan(port[0])
    src = (build.CSRC / "activations.cuh").read_text()
    body = src[src.index("apply_act(int act, float z)"):]
    case = body[body.index(f"// {name}\n"):]
    line = case.splitlines()[1]
    assert "return" in line and ("max0_f" in line or "clamp_f" in line), line
    assert "fmaxf" not in line and "fminf" not in line
