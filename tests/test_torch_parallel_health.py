"""The wrapper's guard modes (``ParallelWrapper.fit`` under the health
layer) in the port against the JAX package.

At two gloo ranks (``parallel.launch.spawn``; the rank side is
``tests/torch_session_ranks.py``), in exact, bucketed, threshold, ZeRO
and averaging mode, one WARN step of an MLP (4 -> 8 tanh -> 3 softmax,
SGD 0.1, a global batch of 16 rows, 8 a rank) reports the guard vector
the JAX package computes for the same step: ``health.guard_vector`` on
the global (summed) gradients for exact, bucketed and ZeRO (no batch
norm, so every mode's global gradient is the global batch's), on the
summed threshold messages for threshold mode, and each replica's own
guard max-combined for averaging. Flags exactly; the loss, norms, ratio
and bucket norms at rtol 1e-5 (float32 sums in other orders than XLA's).
SKIP_STEP with a NaN in one rank's rows leaves every rank's params,
layer state and updater state bit-identical, and the next step moves.
In one process, every policy runs in every mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.compression import encode_tree as jencode
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel import spawn
from deeplearning4j_tpu_torch.telemetry import flightrec, health
from deeplearning4j_tpu_torch.telemetry.health import (
    GUARD_GRAD_NONFINITE,
    GUARD_LOSS_NONFINITE,
    DivergenceError,
)

from tests import torch_session_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-5
SPAWN_TIMEOUT = 240.0
MODES = ("exact", "bucketed", "threshold", "zero", "averaging")
TAU = 1e-3


def _jconf():
    return (JNNC.builder().seed(21).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n=4, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _spec(mode, name=None, n=1):
    jconf = _jconf()
    jnet = JMLN(jconf).init()
    return {"name": name or mode, "mode": mode,
            "conf_json": jconf.to_json(), "params": _np(jnet.params),
            "state": _np(jnet.state), "batches": _batches(n)}


@pytest.fixture(autouse=True)
def _clean():
    health.disable()
    health.MONITOR.reset()
    flightrec.RECORDER.disable().reset()
    yield
    health.disable()
    health.MONITOR.reset()
    flightrec.RECORDER.disable().reset()


@pytest.fixture(scope="module")
def vectors():
    """Per rank {mode: {"vec", "keys"}}: one WARN step at two ranks."""
    return spawn(ranks.guard_vectors, 2, ([_spec(m) for m in MODES],),
                 backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def skipped():
    """Per rank {mode: result}: SKIP_STEP with a NaN in rank 1's rows of
    step 3."""
    return spawn(ranks.skip_step, 2, ([_spec(m, n=4) for m in MODES],),
                 backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


# --------------------------------------------------------------------------
# the JAX side: the guard vectors of the same step
# --------------------------------------------------------------------------

def _jax_reference(mode):
    jnet = JMLN(_jconf()).init()
    x, y = _batches(1)[0]
    gfn, afn = jnet.grad_fn(), jnet.apply_updates_fn()
    params, opt = jnet.params, jnet.opt_state
    it, ep = jnp.float32(0), jnp.float32(0)
    key = jax.random.PRNGKey(0)

    def shard_grads(r):
        f, lab, fm, lm = jnet._batch_arrays(JDataSet(x[8 * r:8 * r + 8],
                                                     y[8 * r:8 * r + 8]))
        loss, _, g = gfn(params, jnet.state, f, lab, fm, lm, key)
        return loss, g

    if mode in ("exact", "bucketed", "zero"):
        f, lab, fm, lm = jnet._batch_arrays(JDataSet(x, y))
        loss, _, g = gfn(params, jnet.state, f, lab, fm, lm, key)
        new_params, _ = afn(params, opt, g, it, ep)
        return np.asarray(jhealth.guard_vector(loss, g, params=params,
                                               new_params=new_params))
    if mode == "threshold":
        # w = c * n / ctot = 1 at two equal shards; residuals start at 0
        parts = [shard_grads(r) for r in (0, 1)]
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        enc = [jencode(g, zeros, TAU)[0] for _, g in parts]
        shared = jax.tree_util.tree_map(lambda a, b: a + b, *enc)
        loss = (parts[0][0] * 8 + parts[1][0] * 8) / 16
        new_params, _ = afn(params, opt, shared, it, ep)
        return np.asarray(jhealth.guard_vector(loss, shared, params=params,
                                               new_params=new_params))
    vecs = []
    for r in (0, 1):
        loss, g = shard_grads(r)
        new_params, _ = afn(params, opt, g, it, ep)
        vecs.append(np.asarray(jhealth.guard_vector(
            loss, g, params=params, new_params=new_params)))
    return np.max(np.stack(vecs), axis=0)


@pytest.mark.parametrize("mode", MODES)
def test_combined_guard_vector_matches_the_jax_one(vectors, mode):
    ref = _jax_reference(mode)
    for rank in (0, 1):
        got = np.asarray(vectors[rank][mode]["vec"])
        assert vectors[rank][mode]["keys"] == ["0", "1"]
        assert got.shape == ref.shape
        assert got[GUARD_LOSS_NONFINITE] == ref[GUARD_LOSS_NONFINITE] == 0
        assert got[GUARD_GRAD_NONFINITE] == ref[GUARD_GRAD_NONFINITE] == 0
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_every_rank_reports_the_same_vector(vectors, mode):
    assert vectors[0][mode]["vec"] == vectors[1][mode]["vec"]


@pytest.mark.parametrize("mode", ["exact", "bucketed", "threshold", "zero"])
def test_skip_step_skips_on_every_rank_bitwise(skipped, mode):
    for rank in (0, 1):
        r = skipped[rank][mode]
        assert r["same"], f"rank {rank}: the poisoned step moved a tree"
        assert r["moved"], f"rank {rank}: step 4 did not move"
        assert r["nonfinite"] == 1 and r["skipped"] == 1


def test_averaging_skips_the_poisoned_replica_and_counts_it(skipped):
    """Averaging guards each replica's own step (the JAX package's rule):
    the anomaly is every rank's step anomaly in the monitor."""
    for rank in (0, 1):
        r = skipped[rank]["averaging"]
        assert r["nonfinite"] == 1 and r["skipped"] == 1
        assert r["moved"]


def test_combine_across_is_the_elementwise_max():
    out = spawn(ranks.combine, 2, (), backend="gloo", device="cpu",
                timeout=SPAWN_TIMEOUT)
    assert out[0] == out[1] == [1.0, 1.0, 0.5, 2.0]


def test_combine_across_without_a_group_is_the_vector():
    v = torch.tensor([1.0, float("nan"), 3.0])
    got = health.combine_across(v)
    assert torch.equal(torch.isnan(got), torch.isnan(v))
    assert got[0] == 1 and got[2] == 3 and got is not v


# --------------------------------------------------------------------------
# one process: every policy in every mode
# --------------------------------------------------------------------------

def _one_rank(mode):
    net = ranks.build(_spec(mode))
    return net, ranks.wrapper(net, mode)


def _data(bad_at=None, n=3):
    out = []
    for i, (x, y) in enumerate(_batches(n, rows=8, seed=4)):
        x = x.copy()
        if i == bad_at:
            x[0, 0] = np.nan
        out.append(DataSet(x, y))
    return ListDataSetIterator(out)


def _state(net):
    return ([v.clone() for vp in net.params.values() for v in vp.values()],
            ranks.flats(net)[1].copy())


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and \
        np.array_equal(a[1], b[1])


@pytest.mark.parametrize("mode", MODES)
def test_warn_counts_and_trains_on(mode):
    health.configure("warn", record_flights=False)
    net, pw = _one_rank(mode)
    pw.fit(_data(bad_at=1))
    rep = health.report()
    # WARN applies the poisoned update: the NaN reaches the params and the
    # next step is anomalous too, except under threshold compression,
    # whose encoding sends no NaN message (the loss flags the step)
    assert rep["steps"] == 3
    assert rep["nonfinite_steps"] == (1 if mode == "threshold" else 2)
    assert rep["skipped_steps"] == 0 and rep["status"] == "anomalous"


@pytest.mark.parametrize("mode", MODES)
def test_skip_step_leaves_the_step_bitwise(mode):
    health.configure("skip_step", record_flights=False)
    net, pw = _one_rank(mode)
    data = list(_data(bad_at=1))
    pw.fit(ListDataSetIterator(data[:1]))
    before = _state(net)
    pw.fit(ListDataSetIterator(data[1:2]))
    assert _equal(before, _state(net))
    pw.fit(ListDataSetIterator(data[2:]))
    assert not _equal(before, _state(net))
    assert health.report()["skipped_steps"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_rollback_restores_the_last_good_snapshot(mode):
    health.configure("rollback", snapshot_every=1, record_flights=False)
    net, pw = _one_rank(mode)
    data = list(_data(bad_at=1))
    pw.fit(ListDataSetIterator(data[:1]))
    good = _state(net)
    pw.fit(ListDataSetIterator(data[1:2]))
    assert _equal(good, _state(net))
    assert net.iteration == 1  # the counters rewound with the trees
    assert health.report()["rollbacks"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_halt_raises_on_the_poisoned_step(mode):
    health.configure("halt", record_flights=False)
    net, pw = _one_rank(mode)
    with pytest.raises(DivergenceError) as ei:
        pw.fit(_data(bad_at=1))
    assert ei.value.step == 2 and ei.value.path == "parallel"


def test_a_mode_change_sets_the_step_up_anew():
    net, pw = _one_rank("exact")
    pw.fit(_data())
    hooks = pw._hooks
    assert pw._health_mode == ""
    health.configure("warn", record_flights=False)
    pw.fit(_data())
    assert pw._health_mode == "observe" and pw._hooks is not hooks
    assert health.report()["steps"] == 3
    health.disable()
    hooks = pw._hooks
    pw.fit(_data())
    assert pw._health_mode == "" and pw._hooks is not hooks
    assert health.report()["steps"] == 3  # the unguarded fit fed nothing


def test_fused_steps_reach_the_monitor_as_one_stack():
    health.configure("skip_step", record_flights=False)
    net, _ = _one_rank("exact")
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(net, prefetch_buffer=0, fused_steps=2)
    pw.fit(_data(bad_at=2, n=4))
    rep = health.report()
    assert rep["steps"] == 4 and rep["nonfinite_steps"] == 1
    assert rep["skipped_steps"] == 1 and rep["last_anomaly_step"] == 3


def test_the_guard_needs_no_host_read_under_skip_step(monkeypatch):
    """Under SKIP_STEP the exact step selects on the device flag: no
    tensor's ``item`` / ``__bool__`` runs inside the step."""
    health.configure("skip_step", flush_every=1000, record_flights=False)
    net, pw = _one_rank("exact")
    pw.fit(_data(n=1))  # the first step sets the wrapper up
    calls = []
    real_item, real_bool = torch.Tensor.item, torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: calls.append("item") or real_item(t))
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: calls.append("bool") or real_bool(t))
    pw._fit_batch(list(_data(bad_at=0, n=1))[0])
    monkeypatch.undo()
    assert calls == []
    assert health.report()["skipped_steps"] == 1
