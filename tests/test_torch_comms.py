"""The port's collective scheduler, compression codecs, ZeRO layout and
exchange telemetry against the JAX package's.

- ``bucket_partition`` / ``bucket_layout`` and every plan's digest and
  ``key_token`` equal the JAX package's for the same trees (leaf sizes in
  the same flatten order); the all-gather's choice is the native gather in
  the port, so the JAX side is compared with its native branch selected
  (``NATIVE_ALL_GATHER``, the seam its own tests use).
- ``threshold_encode`` / ``threshold_decode`` / ``bitmap_encode``,
  ``encode_tree`` (encoded tree, residuals and sparsity) and both
  threshold algorithms bit for bit.
- ``ZeroSpec``: flat padding, slices, the round trip and the byte counts;
  ``ZeroExchange``'s blocks on the JAX layout's buckets, each rank's row
  its slices of every leaf.
- The wrapper's telemetry series at one rank (no process group) against
  the JAX wrapper at ``workers=1``: names, labels and byte counts.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.comms import scheduler as jsched
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import compression as jcomp
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import TrainingMode as JMode
from deeplearning4j_tpu.parallel import single_host_mesh as jmesh
from deeplearning4j_tpu.sharding.zero import ZeroSpec as JZeroSpec
from deeplearning4j_tpu_torch import comms, telemetry
from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    AdaptiveThresholdAlgorithm,
    ParallelWrapper,
    ThresholdAlgorithm,
    TrainingMode,
    bitmap_encode,
    encode_tree,
    threshold_decode,
    threshold_encode,
)
from deeplearning4j_tpu_torch.sharding import ZeroSpec
from deeplearning4j_tpu_torch.sharding.zero import ZeroExchange
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_conf():
    return (JNNC.builder().seed(3).updater(JAdam(learning_rate=0.01))
            .weight_init(JWI.XAVIER).list()
            .layer(JConv(n_out=8, kernel_size=(3, 3), activation=JAct.RELU))
            .layer(JBN())
            .layer(JDense(n_out=12, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(6, 6, 2))
            .build())


@pytest.fixture(scope="module")
def nets():
    """The same network in both packages (the port's params in its own
    layouts, so leaf shapes differ where the layouts do, sizes do not)."""
    jnet = JMLN(_jax_conf()).init()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return jnet, MultiLayerNetwork(conf, "cpu").set_params(p, s)


@pytest.fixture(autouse=True)
def fresh_plans():
    scheduler.reset()
    jsched.reset()
    yield
    scheduler.reset()
    jsched.reset()


# --------------------------------------------------------------------------
# layout and plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("bucket", [1, 100, 4096, 1 << 20])
def test_bucket_partition_matches_jax(seed, bucket):
    sizes = list(np.random.default_rng(seed).integers(1, 5000, 17) * 4)
    sizes = [int(s) for s in sizes]
    assert scheduler.bucket_partition(sizes, bucket) == \
        jsched.bucket_partition(sizes, bucket)


@pytest.mark.parametrize("bucket", [None, 64, 1024, 1 << 20])
def test_bucket_layout_of_the_params_matches_jax(nets, bucket):
    jnet, net = nets
    assert comms.bucket_layout(net.params, bucket) == \
        jsched.bucket_layout(jnet.params, bucket)
    assert comms.bucket_layout(net.opt_state, bucket) == \
        jsched.bucket_layout(jnet.opt_state, bucket)


@pytest.mark.parametrize("bucket", [None, 0, 64, 1024, 1 << 20])
@pytest.mark.parametrize("intent", ["all_reduce", "reduce_scatter",
                                    "all_gather"])
def test_plan_digests_match_jax(nets, monkeypatch, intent, bucket):
    """The same tree (flat padded vectors for the ZeRO intents) gives the
    same buckets, choices, digest and key token in both packages."""
    jnet, net = nets
    monkeypatch.setattr(jsched, "NATIVE_ALL_GATHER", True)
    bucket = bucket or None
    if intent == "all_reduce":
        tree, jtree, full = net.params, jnet.params, None
    else:
        spec, jspec = ZeroSpec(net.params, 2), JZeroSpec(jnet.params, 2)
        full = spec.padded_sizes
        assert full == jspec.padded_sizes
        m = (spec.padded_sizes if intent == "reduce_scatter"
             else spec.slice_sizes)
        tree = [torch.zeros(n) for n in m]
        jtree = [jax.ShapeDtypeStruct((n,), jnp.float32) for n in m]
    got = comms.plan_for(tree, intent, "data", bucket, full_sizes=full)
    ref = jsched.plan_for(jtree, intent, "data", bucket, full_sizes=full)
    assert got.summary() == ref.summary()
    assert got.key_token() == ref.key_token()
    assert got.buckets == ref.buckets and got.choices == ref.choices
    assert comms.lookup_plan(got.digest) is got


def test_densify_choice_and_plan_cache():
    tree = [torch.zeros(4) for _ in range(9)]
    jtree = [np.zeros(4, np.float32) for _ in range(9)]
    got = comms.plan_for(tree, "all_reduce", "data", 1 << 20)
    assert got.choices == ("densify",)
    assert got.digest == jsched.plan_for(jtree, "all_reduce", "data",
                                         1 << 20).digest
    assert comms.plan_for(tree, "all_reduce", "data", 1 << 20) is got
    st = comms.stats()
    assert (st["plans_built"], st["plan_cache_hits"]) == (1, 1)


def test_plans_record_the_jax_series():
    telemetry.reset()
    comms.plan_for([torch.zeros(3)], "reduce_scatter", "data", None)
    snap = telemetry.REGISTRY.snapshot(run_collectors=False)
    assert snap['dl4j_collective_plan_total{choice="variadic",'
                'intent="reduce_scatter"}'] == 1
    assert snap['dl4j_collective_plan_bytes{intent="reduce_scatter"}'] == 12
    assert snap['dl4j_collective_plan_launches{intent="reduce_scatter"}'] == 1


@pytest.mark.parametrize("intent", ["all_reduce", "reduce_scatter",
                                    "all_gather"])
def test_one_rank_exchange_is_the_identity(intent):
    """Without a process group the mesh is one rank: a sum, a scatter and
    a gather of one rank's values return them."""
    tree = {"a": torch.arange(6.0), "b": {"c": torch.ones(3)}}
    full = [3, 6] if intent == "all_gather" else None
    out = comms.exchange(tree, intent, "data", 8, full_sizes=full)
    assert out["a"].equal(tree["a"]) and out["b"]["c"].equal(tree["b"]["c"])


def test_tree_flatten_is_jax_order():
    tree = {"10": {"b": 1, "W": 2}, "2": [3, None, (4, 5)], "1": 6}
    leaves, spec = scheduler.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert scheduler.tree_unflatten(spec, leaves) == tree


# --------------------------------------------------------------------------
# compression codecs and algorithms, bit for bit
# --------------------------------------------------------------------------

def _grads(seed, tau):
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=2 * tau, size=(5, 7)).astype(np.float32)
    g.flat[:4] = [tau, -tau, np.nextafter(np.float32(tau), 1),
                  -np.nextafter(np.float32(tau), 1)]
    return g


@pytest.mark.parametrize("seed", range(3))
def test_threshold_codecs_match_jax_bitwise(seed):
    tau = 1e-3
    g = _grads(seed, tau)
    enc, res = threshold_encode(torch.from_numpy(g), tau)
    jenc, jres = jcomp.threshold_encode(jnp.asarray(g), tau)
    assert np.array_equal(enc.numpy(), np.asarray(jenc))
    assert np.array_equal(res.numpy(), np.asarray(jres))
    assert threshold_decode(enc) is enc
    b, _ = bitmap_encode(torch.from_numpy(g), tau)
    assert np.array_equal(b.numpy(), np.asarray(jcomp.bitmap_encode(
        jnp.asarray(g), tau)[0]))


@pytest.mark.parametrize("seed", range(3))
def test_encode_tree_matches_jax_bitwise(seed):
    tau = 1e-3
    rng = np.random.default_rng(seed)
    tree = {"0": {"W": _grads(seed, tau), "b": _grads(seed + 9, tau)[0]},
            "1": {"W": rng.normal(scale=tau, size=(3, 3)).astype(np.float32)}}
    res = jax.tree_util.tree_map(
        lambda a: (a * 0.3).astype(np.float32), tree)
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa: E731
    enc, nres, sp = encode_tree(to_t(tree), to_t(res), tau)
    jenc, jnres, jsp = jcomp.encode_tree(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, res), tau)
    for a, b in zip(scheduler.tree_leaves(enc),
                    jax.tree_util.tree_leaves(jenc)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(scheduler.tree_leaves(nres),
                    jax.tree_util.tree_leaves(jnres)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert sp.dtype == torch.float32
    assert np.float32(sp) == np.float32(jsp)


@pytest.mark.parametrize("tau0", [1e-3, 3e-5, 0.2])
def test_threshold_algorithms_match_jax_bitwise(tau0):
    """A tau trajectory over sparsities inside, above and below the
    target band, in float32 like the JAX package's jnp update."""
    rng = np.random.default_rng(5)
    sparsities = np.concatenate([rng.uniform(0, 3e-2, 40),
                                 [1e-4, 1e-2, 0.0, 1.0]]).astype(np.float32)
    for port, ref in ((AdaptiveThresholdAlgorithm(tau0),
                       jcomp.AdaptiveThresholdAlgorithm(tau0)),
                      (ThresholdAlgorithm(tau0),
                       jcomp.ThresholdAlgorithm(tau0))):
        t, jt = port.initial(), ref.initial()
        for s in sparsities:
            t = float(port.update(t, float(s)))
            jt = float(ref.update(jt, float(s)))
            assert np.float32(t) == np.float32(jt)


# --------------------------------------------------------------------------
# ZeRO layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zero_spec_matches_jax(nets, n):
    jnet, net = nets
    for tree, jtree in ((net.params, jnet.params),
                        (net.opt_state, jnet.opt_state)):
        spec, jspec = ZeroSpec(tree, n), JZeroSpec(jtree, n)
        assert spec.sizes == jspec.sizes
        assert spec.slice_sizes == jspec.slice_sizes
        assert spec.padded_sizes == jspec.padded_sizes
        assert spec.bytes_per_device() == jspec.bytes_per_device()
        assert spec.total_bytes() == jspec.total_bytes()
        for bucket in (None, 256, 4096):
            assert spec.layout_bytes(bucket) == jspec.layout_bytes(bucket)


@pytest.mark.parametrize("n", [2, 3])
def test_zero_slices_round_trip(nets, n):
    """Every rank's slices, concatenated, are the flat padded leaves; the
    gathered vectors unflatten to the tree bit for bit, the padding is
    zeros, and JAX's slices of the same flat vectors hold the same
    values."""
    jnet, net = nets
    tree = {"0": {"W": torch.arange(7.0).reshape(7), "b": torch.ones(2, 3)}}
    spec = ZeroSpec(tree, n)
    slices = [spec.local_slices(tree, r) for r in range(n)]
    flat = spec.flat_padded(tree)
    for (k, pk) in (("0", "W"), ("0", "b")):
        cat = torch.cat([s[k][pk] for s in slices])
        assert cat.equal(flat[k][pk])
        size = tree[k][pk].numel()
        assert not cat[size:].any()
    back = spec.unflatten_full(flat)
    assert back["0"]["W"].equal(tree["0"]["W"])
    assert back["0"]["b"].equal(tree["0"]["b"])
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    jspec = JZeroSpec(jtree, n)
    for r in range(n):
        js = jspec.local_slices(jtree, r)
        assert np.array_equal(np.asarray(js["0"]["W"]),
                              slices[r]["0"]["W"].numpy())


@pytest.mark.parametrize("tree", ["dict", "nested"])
def test_tree_utilities_hold_no_leaf_past_their_call(tree):
    """With the cyclic garbage collector off, a leaf that flatten,
    unflatten and map saw is freed as soon as the caller drops it: no
    reference cycle keeps a tree of tensors on the card until a
    collection."""
    t = torch.zeros(4)
    ref = weakref.ref(t)
    data = ({"a": t, "b": None} if tree == "dict"
            else {"a": [t, (torch.ones(2), None)], "b": {"c": t}})
    gc.disable()
    try:
        leaves, spec = scheduler.tree_flatten(data)
        back = scheduler.tree_unflatten(spec, leaves)
        mapped = scheduler.tree_map(lambda x: x, back)
        assert scheduler.tree_leaves(mapped)[0] is t
        del t, data, leaves, back, mapped
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("bucket", [None, 256, 4096])
def test_zero_exchange_blocks_are_the_jax_buckets(nets, n, bucket):
    """One ``[n, M_b]`` block a bucket of the JAX ZeroSpec's schedule, and
    every leaf's slice at its own place of one flat vector."""
    jnet, net = nets
    spec = ZeroSpec(net.params, n)
    x = ZeroExchange(spec, bucket)
    assert [w * n * 4 for w in x.width] == \
        JZeroSpec(jnet.params, n).layout_bytes(bucket)
    assert x.total == sum(spec.slice_sizes)
    ends = sorted((x.offset[i], x.offset[i] + m)
                  for i, m in enumerate(spec.slice_sizes))
    assert [a for a, _ in ends] == [0] + [b for _, b in ends[:-1]]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("bucket", [None, 16])
def test_zero_exchange_rows_are_each_ranks_slices(monkeypatch, n, bucket):
    """The collectives replaced by recorders: row ``r`` of every block
    sent to the reduce-scatter is slice ``r`` of each leaf times the
    weight (the padding zeros), each gradient is released once packed, and
    the all-gather of every rank's flat vector rebuilds the full leaves."""
    tree = {"0": {"W": torch.arange(1.0, 8.0), "b": torch.ones(2, 3)},
            "1": {"W": torch.arange(10.0).reshape(2, 5)}}
    spec = ZeroSpec(tree, n)
    x = ZeroExchange(spec, bucket)
    blocks = []

    def reduce_scatter(out, inp, group=None):
        blocks.append(inp.clone())
        out.copy_(inp[0])

    monkeypatch.setattr(scheduler, "reduce_scatter", reduce_scatter)
    grads = scheduler.tree_leaves(tree)
    grads = [g.clone() for g in grads]
    flat = x.scatter(grads, 0.5)
    assert grads == [None] * len(grads)
    assert len(blocks) == len(x.buckets)
    slices = [scheduler.tree_leaves(spec.local_slices(tree, r))
              for r in range(n)]
    for b, bucket_leaves in enumerate(x.buckets):
        for i in bucket_leaves:
            c, m = x.col[i], spec.slice_sizes[i]
            for r in range(n):
                assert blocks[b][r, c:c + m].equal(slices[r][i] * 0.5)
            assert x.slice_of(flat, i).equal(slices[0][i] * 0.5)
    rows = [torch.cat([blocks[b][r] for b in range(len(x.buckets))])
            for r in range(n)]

    def all_gather(out, inp, group=None):
        b = x.start.index(int(inp.data_ptr() - flat.data_ptr())
                          // flat.element_size())
        out.copy_(torch.stack([row[x.start[b]:x.start[b] + x.width[b]]
                               for row in rows]))

    monkeypatch.setattr(scheduler, "all_gather", all_gather)
    out = [torch.full_like(t, -1.0) for t in scheduler.tree_leaves(tree)]
    x.gather_into(flat, out)
    for got, want in zip(out, scheduler.tree_leaves(tree)):
        assert got.equal(want * 0.5)


# --------------------------------------------------------------------------
# the wrapper's telemetry at one rank against the JAX wrapper at workers=1
# --------------------------------------------------------------------------

def _mlp():
    return (JNNC.builder().seed(12345).updater(JAdam(learning_rate=0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=16, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())


def _series(snap):
    keep = ("dl4j_collective_bytes_total", "dl4j_collective_ops_total",
            "dl4j_collective_buckets", "dl4j_collective_bucket_bytes",
            "dl4j_training_steps_total", "dl4j_training_examples_total")
    return {k: v for k, v in snap.items() if k.startswith(keep)}


MODES = {
    "exact": ({}, {}),
    "bucketed": ({"gradient_bucket_mb": 1e-4}, {"gradient_bucket_mb": 1e-4}),
    "threshold": ({"threshold_algorithm": ThresholdAlgorithm(1e-3)},
                  {"threshold_algorithm": jcomp.ThresholdAlgorithm(1e-3)}),
    "averaging": ({"training_mode": TrainingMode.AVERAGING,
                   "averaging_frequency": 2},
                  {"training_mode": JMode.AVERAGING,
                   "averaging_frequency": 2}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_exchange_series_match_the_jax_wrapper(mode):
    from deeplearning4j_tpu import telemetry as jtel

    kw, jkw = MODES[mode]
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(16, 4)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
               for _ in range(3)]
    jnet = JMLN(_mlp()).init()
    jtel.reset()
    jtel.enable()
    jpw = JPW(jnet, workers=1, mesh=jmesh(n_devices=1), prefetch_buffer=0,
              **jkw)
    for x, y in batches:
        jpw.fit(JDataSet(x, y))
    ref = _series(jtel.REGISTRY.snapshot(run_collectors=False))
    jtel.disable()

    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, "cpu").init()
    telemetry.reset()
    telemetry.enable()
    try:
        pw = ParallelWrapper(net, prefetch_buffer=0, **kw)
        for x, y in batches:
            pw.fit(DataSet(x, y))
        got = _series(telemetry.REGISTRY.snapshot(run_collectors=False))
        phases = telemetry.phase_stats()
    finally:
        telemetry.disable()
    assert got == ref
    assert phases["compute"]["count"] == phases["grad_sync"]["count"] == 3


def test_zero_series_at_one_rank():
    """ZeRO's two series (the JAX ZeroSpec's layout at one rank; the JAX
    ZeRO step itself does not build under this sandbox's jax) and the
    footprint gauges."""
    jnet = JMLN(_mlp()).init()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), "cpu").init()
    telemetry.reset()
    telemetry.enable()
    try:
        pw = ParallelWrapper(net, prefetch_buffer=0, zero_optimizer=True,
                             gradient_bucket_mb=1e-4)
        x = np.ones((8, 4), np.float32)
        y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
        pw.fit(DataSet(x, y), epochs=2)
        snap = telemetry.REGISTRY.snapshot(run_collectors=False)
    finally:
        telemetry.disable()
    layout = JZeroSpec(jnet.params, 1).layout_bytes(int(1e-4 * 2 ** 20))
    for op in ("grad_reduce_scatter", "param_all_gather"):
        assert snap[f'dl4j_collective_bytes_total{{op="{op}"}}'] == \
            2 * sum(layout)
        assert snap[f'dl4j_collective_buckets{{op="{op}"}}'] == len(layout)
    assert snap['dl4j_shard_opt_bytes{device="cpu"}'] == \
        JZeroSpec(jnet.opt_state, 1).bytes_per_device()
    assert net.opt_state and comms.stats()["host_staged"] == {}
