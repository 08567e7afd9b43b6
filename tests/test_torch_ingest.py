"""The device ring (``datasets/prefetch.py::DeviceRingIterator``), the
worker thread's staging (``AsyncDataSetIterator(device_put=True)``),
``fit(fused_steps=K)`` over the ring and a session's resume through
``skip_staging`` in the port against the JAX package, on the CPU.

Data: seeded numpy batches. The rings stage on the CPU in the port
(``device="cpu"``: a copy) and on the JAX CPU device. Held against the
JAX ring: every yielded array and its ``fused_stack`` tag, ``staged_count``
and ``retired_count`` at depths 1-3 and K 0-3, ``skip_staging``'s
positions and counts, the ``ingest.device_put`` fault site's invocation
indices and retries, and the ingest counters. Within the port, ``fit``
through the ring gives the same bits as ``fit`` without it; across the
packages ``fit(fused_steps=K)`` agrees at rtol 1e-5 (float32 sums in other
orders than XLA's) with an absolute floor of 1e-2 of Adam's rate. The
JAX tests mirrored: ``tests/test_fused.py``'s
stacking cases, ``test_resilience.py::test_device_ring_retries_transient_
device_put``, ``test_telemetry.py::test_device_ring_iterator_records_
ingest`` and ``test_overlap_sync.py``'s ring cases.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import telemetry as jtel
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.graph import MergeVertex as JMerge
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBP
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets.prefetch import (
    AsyncDataSetIterator as JAsync,
)
from deeplearning4j_tpu.datasets.prefetch import DeviceRingIterator as JRing
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.resilience.faults import FaultPlan as JFaultPlan
from deeplearning4j_tpu.resilience.session import (
    TrainingSession as JTrainingSession,
)
from deeplearning4j_tpu_torch import telemetry as tel
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import (
    AsyncDataSetIterator,
    DeviceRingIterator,
    StackBatchIterator,
    stack_batch_group,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import (
    FaultPlan,
    InjectedFault,
    TrainingSession,
)
from deeplearning4j_tpu_torch.resilience import retry as retry_mod
from deeplearning4j_tpu_torch.telemetry import REGISTRY
from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

N_IN, N_OUT, ROWS = 6, 3, 8
RTOL = 1e-5
LR = 1e-2
# Adam moves a weight whose gradient rounds to the other sign by 2 lr:
# test_torch_mln_training.py's absolute floor of 1e-2 of the rate
PARAMS = dict(rtol=RTOL, atol=1e-2 * LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _arrays(n=6, seed=0, rows=ROWS, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, N_IN)).astype(np.float32)
        y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, rows)]
        m = ((rng.random(rows) > 0.25).astype(np.float32) if mask
             else None)
        out.append((x, y, m))
    return out


def _port(arrays):
    return [DataSet(x, y, labels_mask=m) for x, y, m in arrays]


def _jax(arrays):
    return [JDataSet(x, y, labels_mask=m) for x, y, m in arrays]


def _host(a):
    if a is None:
        return None
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fields(ds):
    if isinstance(ds, (MultiDataSet, JMDS)):
        return [_host(a) for grp in (ds.features, ds.labels,
                                     ds.features_masks or [],
                                     ds.labels_masks or []) for a in grp]
    return [_host(getattr(ds, f)) for f in ("features", "labels",
                                            "features_mask", "labels_mask")]


def _take(it):
    """Every item as ``(fused_stack, host arrays)``, read while it is
    live (the JAX ring deletes a consumed batch's buffers)."""
    return [(getattr(ds, "fused_stack", 0), _fields(ds)) for ds in it]


def _assert_same_items(port_items, jax_items):
    port_items = [p if isinstance(p, tuple) else _take([p])[0]
                  for p in port_items]
    assert len(port_items) == len(jax_items)
    for (pk, pf), (jk, jf) in zip(port_items, jax_items):
        assert pk == jk
        for a, b in zip(pf, jf):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _counter(name, registry=REGISTRY, **labels):
    key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in
                                 sorted(labels.items())) + "}"
                  if labels else "")
    return registry.snapshot(run_collectors=False).get(key, 0.0)


# ---------------------------------------------------------------------------
# the ring's mechanics against the JAX ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,k,n,mask", [
    (1, 0, 5, False), (2, 0, 6, True), (3, 0, 4, False),
    (2, 2, 7, False), (2, 3, 7, True), (3, 3, 9, False), (1, 2, 6, True)])
def test_ring_yields_and_counts_as_the_jax_ring(depth, k, n, mask):
    arrays = _arrays(n=n, mask=mask)
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)),
                              depth=depth, device="cpu", stack_batches=k)
    jring = JRing(JList(_jax(arrays)), depth=depth, stack_batches=k)
    items, jitems = list(ring), _take(jring)
    _assert_same_items(items, jitems)
    for ds in items:
        assert isinstance(ds.features, torch.Tensor)
        assert ds.features.device.type == "cpu"
    assert ring.staged_count == jring.staged_count
    assert ring.retired_count == jring.retired_count


def test_stack_group_uniform_ragged_and_tail():
    ring = DeviceRingIterator(ListDataSetIterator(_port(_arrays(n=7))),
                              stack_batches=3, device="cpu")
    items = list(ring)
    assert [int(getattr(d, "fused_stack", 0)) for d in items] == [3, 3, 0]
    assert tuple(items[0].features.shape) == (3, ROWS, N_IN)
    assert tuple(items[2].features.shape) == (ROWS, N_IN)


def test_stack_group_nonuniform_falls_back():
    dss = _port(_arrays(n=2)) + [DataSet(np.ones((4, N_IN), np.float32),
                                         np.ones((4, N_OUT), np.float32))]
    assert stack_batch_group(dss) is None
    items = list(StackBatchIterator(ListDataSetIterator(dss), 3))
    assert [int(getattr(d, "fused_stack", 0)) for d in items] == [0, 0, 0]


def test_multidataset_stages_array_by_array_as_in_jax():
    arrays = _arrays(n=4)
    mds = [MultiDataSet(features=[x], labels=[y]) for x, y, _ in arrays]
    jmds = [JMDS(features=[x], labels=[y]) for x, y, _ in arrays]
    ring = DeviceRingIterator(ListDataSetIterator(mds), stack_batches=2,
                              device="cpu")
    jring = JRing(JList(jmds), stack_batches=2)
    _assert_same_items(list(ring), _take(jring))
    assert ring.staged_count == jring.staged_count == 2


@pytest.mark.parametrize("mds", [False, True])
def test_a_stacking_ring_makes_no_host_stack(monkeypatch, mds):
    """K = 2: each batch of a group is copied into its slice of the staged
    super-batch; the host stacking (``_stack_col``) never runs, and the
    items are the JAX ring's, which stacks on the host."""
    from deeplearning4j_tpu_torch.datasets import prefetch

    calls = []
    real = prefetch._stack_col
    monkeypatch.setattr(prefetch, "_stack_col",
                        lambda arrs: calls.append(1) or real(arrs))
    arrays = _arrays(n=5, seed=6, mask=not mds)
    if mds:
        src = [MultiDataSet(features=[x], labels=[y]) for x, y, _ in arrays]
        jsrc = [JMDS(features=[x], labels=[y]) for x, y, _ in arrays]
    else:
        src, jsrc = _port(arrays), _jax(arrays)
    ring = DeviceRingIterator(ListDataSetIterator(src), stack_batches=2,
                              device="cpu")
    items = list(ring)
    assert calls == []
    _assert_same_items(items, _take(JRing(JList(jsrc), stack_batches=2)))
    assert [getattr(d, "fused_stack", 0) for d in items] == [2, 2, 0]


@pytest.mark.parametrize("k,skip", [(2, 2), (0, 3), (3, 1)])
def test_skip_staging_fast_forward_pays_no_transfers(k, skip):
    """A resuming session's fast-forward: the skipped items are yielded
    unstaged (and unstacked: the first batch's arrays by identity), the
    counts agree with the JAX ring's, and the hint is one-shot."""
    arrays = _arrays(n=8)
    dss = _port(arrays)
    ring = DeviceRingIterator(ListDataSetIterator(dss), stack_batches=k,
                              device="cpu")
    jring = JRing(JList(_jax(arrays)), stack_batches=k)
    ring.skip_staging(skip)
    jring.skip_staging(skip)
    items, jitems = list(ring), _take(jring)
    assert len(items) == len(jitems)
    assert ring.staged_count == jring.staged_count
    assert items[0].features is dss[0].features
    assert getattr(items[0], "fused_stack", 0) == (k if k > 1 else 0)
    _assert_same_items(items[skip:], jitems[skip:])
    ring.reset()
    jring.reset()
    list(ring), list(jring)
    assert ring.staged_count == jring.staged_count


def test_ring_preserves_order_and_never_touches_source_arrays():
    arrays = [(np.full((4, N_IN), i, np.float32),
               np.eye(N_OUT, dtype=np.float32)[np.full(4, i % N_OUT)], None)
              for i in range(6)]
    batches = _port(arrays)
    hosts = [b.features for b in batches]
    ring = DeviceRingIterator(ListDataSetIterator(batches), depth=2,
                              donate=False, device="cpu")
    seen = [float(b.features[0, 0]) for b in ring]
    assert seen == [float(i) for i in range(6)]
    assert ring.staged_count == 6 and ring.retired_count == 0
    for b, h in zip(batches, hosts):
        assert b.features is h


def test_ring_lets_go_of_consumed_batches():
    """The ring holds at most ``depth + 1`` staged batches: once the
    consumer is back for the next batch, the one before the batch it holds
    is no longer referenced by the ring (the JAX ring deletes its
    buffers)."""
    ring = DeviceRingIterator(ListDataSetIterator(_port(_arrays(n=8))),
                              depth=2, device="cpu")
    refs = []
    for ds in ring:
        refs.append(weakref.ref(ds.features))
        del ds
        gc.collect()
        assert sum(r() is not None for r in refs) <= 3
    assert ring.retired_count == 7


def test_ring_stages_a_copy_and_passes_resident_tensors():
    x = torch.ones((4, N_IN))
    y = torch.eye(N_OUT)[[0, 1, 2, 0]]
    src = [DataSet(x, y), DataSet(np.ones((4, N_IN), np.float32),
                                  np.eye(N_OUT, dtype=np.float32)[[0] * 4])]
    items = list(DeviceRingIterator(ListDataSetIterator(src), device="cpu"))
    assert items[0].features is x  # already on the device: passed through
    assert isinstance(items[1].features, torch.Tensor)
    assert items[1].features.data_ptr() != torch.from_numpy(
        src[1].features).data_ptr()


def test_a_cuda_ring_never_falls_back_to_the_host():
    """Without a card the default (CUDA) ring raises instead of staging on
    the host; with one it stages on the card."""
    ring = DeviceRingIterator(ListDataSetIterator(_port(_arrays(n=2))))
    if torch.cuda.is_available():
        assert next(iter(ring)).features.is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        next(iter(ring))


# ---------------------------------------------------------------------------
# the fault site, the retry and the counters
# ---------------------------------------------------------------------------

def test_device_ring_retries_transient_device_put():
    arrays = _arrays(n=3, seed=9)
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)), depth=2,
                              device="cpu")
    before = _counter("dl4j_retries_total", op="ingest.device_put")
    plan = FaultPlan().inject("ingest.device_put", on_calls=[1])
    with plan.armed():
        staged = list(ring)
    assert plan.fired("ingest.device_put") == 1
    assert _counter("dl4j_retries_total", op="ingest.device_put") \
        - before == 1
    jplan = JFaultPlan().inject("ingest.device_put", on_calls=[1])
    with jplan.armed():
        jstaged = _take(JRing(JList(_jax(arrays)), depth=2))
    assert jplan.fired("ingest.device_put") == 1
    _assert_same_items(staged, jstaged)


@pytest.mark.parametrize("calls", [[3, 4, 5], [1, 2, 3], [7, 8, 9]])
def test_a_fault_past_the_retry_raises_with_nothing_half_staged(calls):
    """Three faults on one array outlast ``INGEST_RETRY``'s three
    attempts: the epoch raises at the same invocation as the JAX ring's,
    and the ring has staged whole batches only."""
    assert retry_mod.INGEST_RETRY.max_attempts == 3
    arrays = _arrays(n=5, seed=4)
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)), depth=2,
                              device="cpu")
    jring = JRing(JList(_jax(arrays)), depth=2)
    got, jgot = [], []
    with FaultPlan().inject("ingest.device_put", on_calls=calls).armed():
        with pytest.raises(InjectedFault):
            for ds in ring:
                got.append(ds)
    with JFaultPlan().inject("ingest.device_put", on_calls=calls).armed():
        with pytest.raises(Exception, match="injected"):
            for ds in jring:
                jgot.append(_take([ds])[0])
    assert ring.staged_count == jring.staged_count
    _assert_same_items(got, jgot)


def test_fit_raises_past_the_retry_and_leaves_no_partial_step():
    """The fit's feed raises past the retry: the network stopped after
    the steps its whole batches trained, exactly where a plain fit over
    those batches stops."""
    arrays = _arrays(n=6, seed=2)
    net, _ = _mln_pair()
    with FaultPlan().inject("ingest.device_put",
                            on_calls=[9, 10, 11]).armed():
        with pytest.raises(InjectedFault):
            net.fit(DeviceRingIterator(ListDataSetIterator(_port(arrays)),
                                       device="cpu"))
    ref, _ = _mln_pair()
    ref.fit(ListDataSetIterator(_port(arrays[:net.iteration])))
    assert net.iteration == 3  # batch 5's labels fail; batch 4 is staged
    np.testing.assert_array_equal(net.params_flat(), ref.params_flat())


def test_device_ring_records_ingest_as_the_jax_ring():
    arrays = _arrays(n=4, mask=True)
    tel.enable()
    jtel.enable()
    try:
        b0 = _counter("dl4j_ingest_batches_total")
        n0 = _counter("dl4j_ingest_bytes_total")
        jb0 = _counter("dl4j_ingest_batches_total", jtel.REGISTRY)
        jn0 = _counter("dl4j_ingest_bytes_total", jtel.REGISTRY)
        assert len(list(DeviceRingIterator(
            ListDataSetIterator(_port(arrays)), device="cpu"))) == 4
        assert len(list(JRing(JList(_jax(arrays))))) == 4
        batches = _counter("dl4j_ingest_batches_total") - b0
        nbytes = _counter("dl4j_ingest_bytes_total") - n0
        assert batches == 4.0
        assert batches == _counter("dl4j_ingest_batches_total",
                                   jtel.REGISTRY) - jb0
        assert nbytes == _counter("dl4j_ingest_bytes_total",
                                  jtel.REGISTRY) - jn0 > 0
    finally:
        tel.disable()
        jtel.disable()


def test_async_iterator_device_put_matches_the_jax_iterator():
    arrays = _arrays(n=5, mask=True)
    it = AsyncDataSetIterator(ListDataSetIterator(_port(arrays)),
                              queue_size=2, device_put=True, device="cpu")
    items = list(it)
    for ds in items:
        assert isinstance(ds.features, torch.Tensor)
    jitems = _take(JAsync(JList(_jax(arrays)), queue_size=2,
                          device_put=True))
    _assert_same_items(items, jitems)


# ---------------------------------------------------------------------------
# fit through the ring
# ---------------------------------------------------------------------------

def _mln_jconf(seed=17):
    return (JNNC.builder().seed(seed).updater(JAdam(LR)).list()
            .layer(JDense(n_out=12, activation=JAct.TANH))
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=N_OUT, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(N_IN)).build())


def _mln_pair():
    jnet = JMLN(_mln_jconf()).init()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s), jnet


def _opt_flat(net):
    return params_util.flatten_state_like(net.conf, net.opt_state)


def _bits(net):
    return np.concatenate([net.params_flat(), _opt_flat(net)])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_mln_fit_fused_steps_over_the_ring(k):
    """``fit(fused_steps=K)`` stages one stacked super-batch a group: the
    same bits as K = 1 on the port, the JAX ``fit(fused_steps=K)`` within
    rtol 1e-5, and the iteration counters equal (ragged tails included)."""
    arrays = _arrays(n=7, mask=True)
    plain, _ = _mln_pair()
    plain.fit(ListDataSetIterator(_port(arrays)), epochs=2)
    fused, jnet = _mln_pair()
    fused.fit(ListDataSetIterator(_port(arrays)), epochs=2, fused_steps=k)
    np.testing.assert_array_equal(_bits(fused), _bits(plain))
    jnet.fit(JList(_jax(arrays)), epochs=2, fused_steps=k)
    assert fused.iteration == jnet.iteration == 14
    np.testing.assert_allclose(fused.params_flat(),
                               np.asarray(jnet.params_flat()), **PARAMS)
    assert fused.score() == pytest.approx(float(jnet.score_value), rel=RTOL)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_mln_fit_through_a_ring_is_bit_identical(depth):
    arrays = _arrays(n=6)
    plain, _ = _mln_pair()
    plain.fit(ListDataSetIterator(_port(arrays)), epochs=2)
    ringed, _ = _mln_pair()
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)),
                              depth=depth, device="cpu")
    ringed.fit(ring, epochs=2)
    np.testing.assert_array_equal(_bits(ringed), _bits(plain))
    assert ring.staged_count == 12


def test_fit_does_not_wrap_a_ring_that_already_stacks_k():
    arrays = _arrays(n=6)
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)),
                              stack_batches=3, device="cpu")
    net, _ = _mln_pair()
    net.fit(ring, fused_steps=3)
    assert ring.staged_count == 2 and net.iteration == 6


def _cg_jconf():
    return (JNNC.builder().seed(5).updater(JAdam(LR)).graph_builder()
            .add_inputs("a", "b")
            .set_input_types(JIT.feed_forward(N_IN), JIT.feed_forward(2))
            .add_layer("da", JDense(n_out=8, activation=JAct.TANH), "a")
            .add_layer("db", JDense(n_out=4, activation=JAct.TANH), "b")
            .add_vertex("m", JMerge(), "da", "db")
            .add_layer("out", JOut(n_out=N_OUT, activation=JAct.SOFTMAX,
                                   loss_fn=JMCXENT()), "m")
            .set_outputs("out").build())


def _cg_pair():
    jnet = JGraph(_cg_jconf()).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return ComputationGraph(conf, "cpu").set_params(p, s), jnet


def _cg_batches(n=5):
    rng = np.random.default_rng(3)
    out = []
    for x, y, _ in _arrays(n=n, seed=8):
        b = rng.normal(size=(ROWS, 2)).astype(np.float32)
        out.append(([x, b], [y]))
    return out


def test_graph_fit_fused_steps_over_the_ring():
    data = _cg_batches()
    plain, _ = _cg_pair()
    plain.fit(ListDataSetIterator([MultiDataSet(features=f, labels=l)
                                   for f, l in data]))
    fused, jnet = _cg_pair()
    fused.fit(ListDataSetIterator([MultiDataSet(features=f, labels=l)
                                   for f, l in data]), fused_steps=2)
    np.testing.assert_array_equal(fused.params_flat(), plain.params_flat())
    jnet.fit(JList([JMDS(features=f, labels=l) for f, l in data]),
             fused_steps=2)
    assert fused.iteration == jnet.iteration == 5
    np.testing.assert_allclose(fused.params_flat(),
                               np.asarray(jnet.params_flat()), **PARAMS)


def test_graph_fit_one_multidataset_with_fused_steps():
    (f, l), = _cg_batches(n=1)
    net, jnet = _cg_pair()
    net.fit(MultiDataSet(features=f, labels=l), fused_steps=2)
    jnet.fit(JMDS(features=f, labels=l), fused_steps=2)
    assert net.iteration == jnet.iteration == 1
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), **PARAMS)


def test_tbptt_refuses_fused_steps_as_jax_does():
    jconf = (JNNC.builder().seed(1).list()
             .layer(jrnn.LSTM(n_out=4))
             .layer(jrnn.RnnOutputLayer(n_out=2, activation=JAct.SOFTMAX))
             .backprop_type(JBP.TRUNCATED_BPTT, fwd=3, back=3)
             .set_input_type(JIT.recurrent(3, 6)).build())
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), "cpu")
    x = np.zeros((2, 6, 3), np.float32)
    y = np.zeros((2, 6, 2), np.float32)
    with pytest.raises(ValueError, match="STANDARD backprop only"):
        net.fit(DataSet(x, y), fused_steps=2)
    with pytest.raises(ValueError, match="STANDARD backprop only"):
        JMLN(jconf).init().fit(JDataSet(x, y), fused_steps=2)


# ---------------------------------------------------------------------------
# a session's resume through skip_staging
# ---------------------------------------------------------------------------

_BASE = {}


def _baseline(k):
    if k not in _BASE:
        net, _ = _mln_pair()
        net.fit(ListDataSetIterator(_port(_arrays(n=6))), epochs=2)
        _BASE[k] = _bits(net)
    return _BASE[k]


@pytest.mark.parametrize("kill_at", [3, 4, 8])
def test_session_resume_over_the_ring_stages_no_skipped_batch(tmp_path,
                                                              kill_at):
    """A session over a depth-2 ring killed at ``train.step`` call
    ``kill_at`` resumes bit for bit, and the fast-forward stages none of
    the batches it skips: the ring's staged count equals the JAX ring's
    in the same session."""
    arrays = _arrays(n=6)
    ring = DeviceRingIterator(ListDataSetIterator(_port(arrays)),
                              device="cpu")
    net, jnet = _mln_pair()
    sess = TrainingSession(net, str(tmp_path / "port"),
                           snapshot_every_n_iterations=2)
    with FaultPlan(seed=1).inject("train.step", on_calls=[kill_at]).armed():
        sess.fit(ring, epochs=2)
    assert sess.restarts == 1 and sess.model.iteration == 12
    np.testing.assert_array_equal(_bits(sess.model), _baseline(1))
    jring = JRing(JList(_jax(arrays)))
    jsess = JTrainingSession(jnet, str(tmp_path / "jax"),
                             snapshot_every_n_iterations=2)
    with JFaultPlan(seed=1).inject("train.step",
                                   on_calls=[kill_at]).armed():
        jsess.fit(jring, epochs=2)
    assert ring.staged_count == jring.staged_count
    # every batch of the two epochs once, plus what the killed epoch
    # staged after its last snapshot and before the kill
    assert ring.staged_count < 12 + kill_at + 2
    np.testing.assert_allclose(sess.model.params_flat(),
                               np.asarray(jsess.model.params_flat()),
                               **PARAMS)


@pytest.mark.parametrize("kill_at", [3, 6])
def test_session_fused_steps_resumes_bit_identical(tmp_path, kill_at):
    """``TrainingSession.fit(fused_steps=2)``: the session's own K-stacking
    ring; one item is a super-step, the snapshot fires at its crossing and
    the resumed run ends on the uninterrupted bits."""
    net, _ = _mln_pair()
    sess = TrainingSession(net, str(tmp_path),
                           snapshot_every_n_iterations=2)
    with FaultPlan(seed=1).inject("train.step", on_calls=[kill_at]).armed():
        sess.fit(ListDataSetIterator(_port(_arrays(n=6))), epochs=2,
                 fused_steps=2)
    assert sess.restarts == 1 and sess.model.iteration == 12
    np.testing.assert_array_equal(_bits(sess.model), _baseline(1))
