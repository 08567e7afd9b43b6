"""Data-parallel training in the port against the JAX package's
``ParallelWrapper``.

The reference side is the JAX wrapper on ``single_host_mesh(n_devices=N)``
over the conftest's fake CPU devices, fed each GLOBAL batch in one
process. The port side is N gloo ranks (``parallel.launch.spawn``, one
process group per module fixture running every scenario of
``tests/torch_parallel_ranks.py``), each fed its partition. Both start
from the same params (the JAX network's, through ``params_from_jax``) and
the same seeded numpy batches; dropout is off (the RNG streams cannot
match).

Tolerances, as the JAX package's parallel tests state them: params
``atol 2e-5``; updater and BN state ``rtol 2e-5, atol 1e-6``; scores
``rtol 2e-5``. Where the port runs the same sums in the same order on both
sides (two ranks: a sum of two terms does not depend on order), bits.

The JAX package's ZeRO step does not build under this sandbox's jax
(``shard_map`` cannot infer its out_specs' replication); the JAX package
pins its ZeRO step as bitwise equal to its bucketed all-reduce step
(``tests/test_sharding.py``), so the port's ZeRO is held to the JAX
bucketed step, and to the port's bucketed step bit for bit.

A ragged partition pads to the per-rank size the fit's first batch fixed
(the JAX package's multi-process contract); the JAX wrapper in one process
pads the global batch to ``ceil(B / N) * N`` instead. The padding differs
only for a ragged batch after a full one, which the scenarios run on nets
without batch norm (padding rows enter BN statistics, not losses).
"""

import dataclasses

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.graph import (
    ComputationGraphConfiguration as JCGConf,
)
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import GradientNormalization as JGN
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JCM
from deeplearning4j_tpu.conf.layers_cnn import FusedConvBN1x1 as JFused
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JList,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import TrainingListener as JListener
from deeplearning4j_tpu.parallel import (
    AdaptiveThresholdAlgorithm as JAdaptive,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import (
    ParameterAveragingTrainingMaster as JPATM,
)
from deeplearning4j_tpu.parallel import SharedTrainingMaster as JSTM
from deeplearning4j_tpu.parallel import SparkDl4jMultiLayer as JSpark
from deeplearning4j_tpu.parallel import ThresholdAlgorithm as JThreshold
from deeplearning4j_tpu.parallel import TrainingMode as JMode
from deeplearning4j_tpu.parallel import single_host_mesh as jmesh
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    RankFailure,
    ThresholdAlgorithm,
    TrainingMode,
    spawn,
)
from deeplearning4j_tpu_torch.parallel import mesh as port_mesh
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.util import serializer

from tests import torch_parallel_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

PARAM_ATOL = 2e-5
STATE_TOL = dict(rtol=2e-5, atol=1e-6)
SCORE_RTOL = 2e-5
SPAWN_TIMEOUT = 240.0


# --------------------------------------------------------------------------
# networks and data (JAX side builds them; the port loads the JSON)
# --------------------------------------------------------------------------

def _mlp_conf(updater=None, l2=0.0):
    b = JNNC.builder().seed(12345).updater(
        updater or JAdam(learning_rate=0.05)).weight_init(JWI.XAVIER)
    if l2:
        b = b.l2(l2)
    return (b.list()
            .layer(JDense(n_out=16, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4))
            .build())


def _mlp_gn_conf():
    """Gradient normalization, which ZeRO takes on slices with full-tensor
    norms: the hidden layer clipped to an L2 norm of 0.05 (it binds), the
    output layer renormalized per param."""
    return (JNNC.builder().seed(12345).updater(JAdam(learning_rate=0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=16, activation=JAct.TANH,
                          gradient_normalization=JGN.CLIP_L2_PER_LAYER,
                          gradient_normalization_threshold=0.05))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT(),
                        gradient_normalization=(
                            JGN.RENORMALIZE_L2_PER_PARAM_TYPE)))
            .set_input_type(JIT.feed_forward(4))
            .build())


def _cnn_conf():
    """A conv, a stock BatchNormalization and a FusedConvBN1x1 (the port
    runs its ``matmul_stats`` plain version: ``force_kernel``). The conv
    has no bias: BN removes a bias's effect, so its gradient is rounding
    noise that Adam would turn into lr-sized steps in either package."""
    return (JNNC.builder().seed(7).updater(JAdam(learning_rate=0.01))
            .weight_init(JWI.XAVIER).list()
            .layer(JConv(n_out=8, kernel_size=(3, 3),
                         convolution_mode=JCM.SAME, has_bias=False,
                         activation=JAct.IDENTITY))
            .layer(JBN(activation=JAct.RELU))
            .layer(JFused(n_out=16, activation=JAct.RELU))
            .layer(JGP(pooling_type=JPT.AVG))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(8, 8, 3))
            .build())


def _graph_conf():
    return (JNNC.builder().seed(12345).updater(JAdam(learning_rate=0.05))
            .weight_init(JWI.XAVIER).graph_builder()
            .add_inputs("in")
            .add_layer("d", JDense(n_out=16, activation=JAct.TANH), "in")
            .add_layer("out", JOut(n_out=3, activation=JAct.SOFTMAX,
                                   loss_fn=JMCXENT()), "d")
            .set_outputs("out")
            .set_input_types(JIT.feed_forward(4))
            .build())


def _xy(n, seed, shape=(4,)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


MLP_BATCHES = [_xy(64, s) for s in (0, 1, 2)]
RAGGED = [_xy(64, 3), _xy(61, 4)]
CNN_BATCHES = [_xy(16, s, (8, 8, 3)) for s in (5, 6)]
FOUR = [_xy(64, s) for s in (10, 11, 12, 13)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# the scenarios: name -> (JAX conf builder, kind, batches, wrapper kwargs
# (port names), epochs, extra spec fields)
SCENARIOS = {
    "exact_mlp": (lambda: _mlp_conf(l2=1e-3), "mln", MLP_BATCHES, {}, 1,
                  {"telemetry": True}),
    "exact_ragged": (_mlp_conf, "mln", RAGGED, {}, 1, {}),
    "exact_ragged_first": (_mlp_conf, "mln", [RAGGED[1]], {}, 2, {}),
    "exact_cnn_bn": (_cnn_conf, "mln", CNN_BATCHES, {}, 1,
                     {"force_kernel": True}),
    "exact_cnn_bn_per_rank": (_cnn_conf, "mln", CNN_BATCHES, {}, 1,
                              {"force_kernel": True, "per_rank_bn": True}),
    "bucketed_cnn_bn": (_cnn_conf, "mln", CNN_BATCHES,
                        {"gradient_bucket_mb": 0}, 1, {"force_kernel": True}),
    "bucketed0": (_mlp_conf, "mln", RAGGED, {"gradient_bucket_mb": 0}, 1,
                  {}),
    "bucketed_small": (_mlp_conf, "mln", RAGGED,
                       {"gradient_bucket_mb": 1e-4}, 1, {"telemetry": True}),
    "threshold_fixed": (lambda: _mlp_conf(JSgd(learning_rate=0.1)), "mln",
                        MLP_BATCHES, {"threshold": ("fixed", 1e-3)}, 2,
                        {"telemetry": True}),
    "threshold_adaptive": (lambda: _mlp_conf(JSgd(learning_rate=0.1)),
                           "mln", MLP_BATCHES,
                           {"threshold": ("adaptive", 1e-3)}, 2, {}),
    "averaging_sgd_f1": (lambda: _mlp_conf(JSgd(learning_rate=0.1)), "mln",
                         MLP_BATCHES, {"averaging": True,
                                       "averaging_frequency": 1}, 1, {}),
    "averaging_periodic": (_mlp_conf, "mln", FOUR,
                           {"averaging": True, "averaging_frequency": 2}, 1,
                           {"telemetry": True}),
    "averaging_bucketed": (_mlp_conf, "mln", FOUR,
                           {"averaging": True, "averaging_frequency": 2,
                            "gradient_bucket_mb": 1e-4}, 1, {}),
    "zero": (_mlp_conf, "mln", RAGGED, {"zero_optimizer": True,
                                        "gradient_bucket_mb": 0}, 1,
             {"telemetry": True}),
    "zero_buckets": (_mlp_conf, "mln", RAGGED,
                     {"zero_optimizer": True, "gradient_bucket_mb": 1e-4}, 1,
                     {}),
    "zero_gn": (_mlp_gn_conf, "mln", RAGGED,
                {"zero_optimizer": True, "gradient_bucket_mb": 1e-4}, 1, {}),
    "fused": (_mlp_conf, "mln", FOUR, {"fused_steps": 2}, 1, {}),
    "exact_four": (_mlp_conf, "mln", FOUR, {}, 1, {}),
    "graph_exact": (_graph_conf, "graph", MLP_BATCHES, {}, 1, {}),
    "zero_write": (_mlp_conf, "mln", MLP_BATCHES[:2],
                   {"zero_optimizer": True}, 1, {"write_at": 0}),
    "averaging_write": (_mlp_conf, "mln", MLP_BATCHES[:2],
                        {"averaging": True, "averaging_frequency": 2}, 1,
                        {"write_at": 0}),
}

# the JAX side of the ZeRO scenarios: its bucketed all-reduce step
JAX_WRAPPER = {"zero": {"gradient_bucket_mb": 0},
               "zero_buckets": {"gradient_bucket_mb": 1e-4},
               "zero_write": {"gradient_bucket_mb": 0}}

MASTERS = {
    "master_averaging": (("averaging", {"averaging_frequency": 2,
                                        "batch_size_per_worker": 16}),
                         lambda: JPATM(averaging_frequency=2,
                                       batch_size_per_worker=16)),
    "master_shared": (("shared", {"batch_size_per_worker": 16}),
                      lambda: JSTM(batch_size_per_worker=16)),
}

FOUR_RANKS = ("exact_mlp", "zero_buckets", "averaging_periodic")


def _jax_net(name):
    conf = (SCENARIOS[name][0] if name in SCENARIOS else _mlp_conf)()
    net = (JCG if isinstance(conf, JCGConf) else JMLN)(conf).init()
    return conf, net


def _master_rows(rank, world=2, per_worker=16, n=64):
    """Rank r's rows of the master scenarios: the JAX facade in one
    process batches ``per_worker * world`` consecutive rows and splits
    each batch over the ranks, so rank r holds block r of every batch."""
    return np.concatenate([
        np.arange(b + rank * per_worker, b + (rank + 1) * per_worker)
        for b in range(0, n, per_worker * world)])


def _spec(name):
    conf, net = _jax_net(name)
    if name in MASTERS:
        x, y = _xy(64, 20)
        return {"name": name, "kind": "mln", "conf_json": conf.to_json(),
                "params": _np(net.params), "state": _np(net.state),
                "master": MASTERS[name][0], "epochs": 1,
                "arrays_by_rank": [(x[_master_rows(r)], y[_master_rows(r)])
                                   for r in (0, 1)]}
    _, kind, batches, wrapper, epochs, extra = SCENARIOS[name]
    return {"name": name, "kind": kind, "conf_json": conf.to_json(),
            "params": _np(net.params), "state": _np(net.state),
            "batches": batches, "wrapper": wrapper, "epochs": epochs,
            **extra}


def _run_port(world, names, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(f"pw{world}"))
    specs = [_spec(n) for n in names]
    return spawn(ranks.run_scenarios, world, (specs, tmp), backend="gloo",
                 device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def port2(tmp_path_factory):
    """Every 2-rank scenario, in one process group: per rank {name:
    result}."""
    names = list(SCENARIOS) + list(MASTERS)
    return _run_port(2, names, tmp_path_factory)


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    return _run_port(4, FOUR_RANKS, tmp_path_factory)


class _JRecord(JListener):
    def __init__(self, pw=None):
        self.pw, self.scores, self.taus = pw, [], []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))
        if self.pw is not None and self.pw._tau is not None:
            self.taus.append(float(self.pw._tau))


def _jax_wrapper_kwargs(name):
    kw = dict(JAX_WRAPPER.get(name, SCENARIOS[name][3]))
    if kw.pop("averaging", False):
        kw["training_mode"] = JMode.AVERAGING
    thr = kw.pop("threshold", None)
    if thr is not None:
        kw["threshold_algorithm"] = (JThreshold(thr[1]) if thr[0] == "fixed"
                                     else JAdaptive(thr[1]))
    kw.pop("zero_optimizer", None)
    return kw


_JAX_CACHE = {}


def _jax_run(name, workers=2, steps=None):
    """The JAX wrapper's trained trees, scores and taus for a scenario
    (``steps``: only the first ones, for the mid-fit zips)."""
    key = (name, workers, steps)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    from deeplearning4j_tpu.telemetry import REGISTRY
    from deeplearning4j_tpu.telemetry import disable, enable, reset

    conf, net = _jax_net(name)
    mesh = jmesh(n_devices=workers)
    reset()
    enable()
    if name in MASTERS:
        facade = JSpark(None, net, MASTERS[name][1](), mesh=mesh)
        pw = facade._wrapper
        rec = _JRecord(pw)
        net.set_listeners(rec)
        x, y = _xy(64, 20)
        facade.fit(x, y, epochs=1)
    else:
        _, _, batches, _, epochs, _ = SCENARIOS[name]
        if steps is not None:
            batches, epochs = batches[:steps], 1
        pw = JPW(net, workers=workers, mesh=mesh, prefetch_buffer=0,
                 **_jax_wrapper_kwargs(name))
        rec = _JRecord(pw)
        net.set_listeners(rec)
        pw.fit(JList([JDataSet(x, y) for x, y in batches]), epochs=epochs)
    metrics = REGISTRY.snapshot(run_collectors=False)
    disable()
    out = {"params": _np(net.params), "state": _np(net.state),
           "opt": _np(net.opt_state), "scores": rec.scores,
           "taus": rec.taus, "metrics": metrics,
           "iteration": net.iteration, "epoch": net.epoch}
    _JAX_CACHE[key] = out
    return out


# the JAX wrapper's shard_map modes, composed from the JAX package's own
# step functions (see the module docstring)
SHARD_MAP_MODES = ("bucketed_cnn_bn", "bucketed0", "bucketed_small",
                   "threshold_fixed", "threshold_adaptive", "zero",
                   "zero_buckets", "zero_gn", "zero_write")


def _jax_shard_reference(name, workers=2, steps=None):
    """Per shard: ``grad_fn`` on the shard's rows (the global batch padded
    to ``ceil(B / N) * N``, the padding masked), then the wrapper's
    combination: bucketed / ZeRO ``sum_r g_r * c_r / ctot``; threshold
    ``encode_tree(g_r * c_r * N / ctot + residual_r, tau)`` summed, tau
    retuned from the mean sparsity; then ``apply_updates_fn``, the state
    ``sum_r s_r * c_r / ctot`` and the score ``sum_r loss_r * c_r /
    ctot``."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import compression as jcomp
    from deeplearning4j_tpu.parallel import mesh as jmesh_mod

    key = ("shard", name, workers, steps)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    _, net = _jax_net(name)
    _, _, batches, kw, epochs, _ = SCENARIOS[name]
    if steps is not None:
        batches, epochs = batches[:steps], 1
    thr = kw.get("threshold")
    algo = None if thr is None else (JThreshold(thr[1]) if thr[0] == "fixed"
                                     else JAdaptive(thr[1]))
    gfn, afn = jax.jit(net.grad_fn()), jax.jit(net.apply_updates_fn())
    rng = jax.random.PRNGKey(0)
    tau = None if algo is None else float(algo.threshold)
    params, state, opt = net.params, net.state, net.opt_state
    scores, taus = [], []
    res = [jax.tree_util.tree_map(jnp.zeros_like, params)] * workers
    it = 0
    for _ in range(epochs):
        for x, y in batches:
            rows = x.shape[0]
            target = -(-rows // workers) * workers
            f, lab, fm, lm = net._batch_arrays(JDataSet(x, y))
            f, lab, lm = jmesh_mod.pad_leading((f, lab, lm), target)
            c = jmesh_mod.shard_valid_counts(rows, workers)
            ctot = np.float32(max(c.sum(), 1.0))
            s = target // workers
            outs = [gfn(params, state, f[r * s:(r + 1) * s],
                        lab[r * s:(r + 1) * s], None,
                        lm[r * s:(r + 1) * s], rng) for r in range(workers)]
            if algo is None:
                w = [np.float32(c[r] / ctot) for r in range(workers)]
                parts = [jax.tree_util.tree_map(lambda g, w=w[r]: g * w,
                                                outs[r][2])
                         for r in range(workers)]
            else:
                parts, sps = [], []
                for r in range(workers):
                    wr = np.float32(c[r] * np.float32(workers) / ctot)
                    g = jax.tree_util.tree_map(lambda g: g * wr, outs[r][2])
                    enc, res[r], sp = jcomp.encode_tree(g, res[r], tau)
                    parts.append(enc)
                    sps.append(sp)
                sparsity = sum(sps[1:], sps[0]) / workers
            shared = parts[0]
            for p in parts[1:]:
                shared = jax.tree_util.tree_map(jnp.add, shared, p)
            params, opt = afn(params, opt, shared, jnp.float32(it),
                              jnp.float32(0))
            ws = [np.float32(c[r] / ctot) for r in range(workers)]
            state = jax.tree_util.tree_map(
                lambda *ss: sum(si * wi for si, wi in zip(ss, ws)),
                *[o[1] for o in outs]) if state else state
            scores.append(float(sum(float(o[0]) * float(c[r])
                                    for r, o in enumerate(outs)) / ctot))
            if algo is not None:
                tau = float(algo.update(tau, float(sparsity)))
                taus.append(tau)
            it += 1
    out = {"params": _np(params), "state": _np(state), "opt": _np(opt),
           "scores": scores, "taus": taus, "iteration": it,
           "epoch": epochs}
    _JAX_CACHE[key] = out
    return out


def _reference(name, workers=2, steps=None):
    if name in SHARD_MAP_MODES:
        return _jax_shard_reference(name, workers, steps)
    return _jax_run(name, workers, steps)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _max_diff(a, b) -> float:
    da = dict(_leaves(a))
    return max(float(np.abs(da[p] - v).max()) for p, v in _leaves(b))


def _assert_trees(got, ref, what):
    for p, v in _leaves(ref["params"]):
        np.testing.assert_allclose(dict(_leaves(got["params"]))[p], v,
                                   atol=PARAM_ATOL, err_msg=f"{what} {p}")
    for part in ("state", "opt"):
        g = dict(_leaves(got[part]))
        for p, v in _leaves(ref[part]):
            np.testing.assert_allclose(g[p], v, **STATE_TOL,
                                       err_msg=f"{what} {part} {p}")


def _assert_same_bits(a, b, what):
    for part in ("params", "state", "opt"):
        db = dict(_leaves(b[part]))
        for p, v in _leaves(a[part]):
            assert np.array_equal(v, db[p]), f"{what}: {part} {p}"


# --------------------------------------------------------------------------
# the scenarios against the JAX wrapper
# --------------------------------------------------------------------------

PARITY = [n for n in SCENARIOS
          if n not in ("exact_cnn_bn_per_rank", "zero_write",
                       "averaging_write")] + list(MASTERS)


@pytest.mark.parametrize("name", PARITY)
def test_matches_the_jax_wrapper(port2, name):
    got, ref = port2[0][name], _reference(name)
    _assert_trees(got["trees"], ref, name)
    np.testing.assert_allclose(got["scores"], ref["scores"],
                               rtol=SCORE_RTOL, err_msg=name)
    assert (got["iteration"], got["epoch"]) == (ref["iteration"],
                                                ref["epoch"])


@pytest.mark.parametrize("name", PARITY)
def test_every_rank_ends_with_the_same_bits(port2, name):
    _assert_same_bits(port2[0][name]["trees"], port2[1][name]["trees"],
                      name)


@pytest.mark.parametrize("name", FOUR_RANKS)
def test_four_ranks_match_the_jax_wrapper(port4, name):
    got, ref = port4[0][name], _reference(name, workers=4)
    _assert_trees(got["trees"], ref, name)
    np.testing.assert_allclose(got["scores"], ref["scores"],
                               rtol=SCORE_RTOL, err_msg=name)
    for r in (1, 2, 3):
        _assert_same_bits(got["trees"], port4[r][name]["trees"], name)


def test_per_rank_batch_norm_fails_the_exact_comparison(port2):
    """The planted control: the same run with per-rank BN statistics is
    far outside the tolerance the global statistics meet, so the
    comparison sees the BN semantics."""
    ref = _jax_run("exact_cnn_bn")
    good = port2[0]["exact_cnn_bn"]["trees"]
    bad = port2[0]["exact_cnn_bn_per_rank"]["trees"]
    assert _max_diff(good["state"], ref["state"]) <= 1e-5
    assert _max_diff(bad["state"], ref["state"]) > 100 * STATE_TOL["atol"]
    with pytest.raises(AssertionError):
        _assert_trees(bad, ref, "per-rank BN")


def test_bucket_sizes_give_the_same_bits(port2):
    _assert_same_bits(port2[0]["bucketed0"]["trees"],
                      port2[0]["bucketed_small"]["trees"], "bucketed")


def test_zero_gives_the_bucketed_bits(port2):
    """ZeRO's reduce-scatter + slice update + all-gather is the bucketed
    all-reduce step bit for bit: params and the gathered updater state."""
    _assert_same_bits(port2[0]["zero"]["trees"],
                      port2[0]["bucketed0"]["trees"], "zero")
    _assert_same_bits(port2[0]["zero_buckets"]["trees"],
                      port2[0]["bucketed_small"]["trees"], "zero buckets")


def test_fused_steps_train_as_single_steps(port2):
    _assert_same_bits(port2[0]["fused"]["trees"],
                      port2[0]["exact_four"]["trees"], "fused")


def test_adaptive_tau_follows_the_jax_trajectory(port2):
    got = port2[0]["threshold_adaptive"]["taus"]
    ref = _reference("threshold_adaptive")["taus"]
    assert len(got) == len(ref) == 6
    np.testing.assert_array_equal(np.float32(got), np.float32(ref))
    assert len(set(got)) > 1  # the sparsity moved tau
    np.testing.assert_array_equal(
        np.float32(port2[0]["threshold_fixed"]["taus"]),
        np.float32(_reference("threshold_fixed")["taus"]))


@pytest.mark.parametrize("name", ["zero_write", "averaging_write"])
def test_write_model_mid_fit_holds_the_gathered_state(port2, name):
    """A listener's ``write_model`` after step 1 of 2 (on every rank):
    the zip holds the full, current trees (ZeRO's updater state gathered,
    the averaging replicas' mean), equal to the JAX wrapper after one
    step, and every rank wrote the same trees."""
    ref = _reference(name, steps=1)
    zips = [port2[r][name]["zip"] for r in (0, 1)]
    nets = [serializer.restore_multi_layer_network(z, device="cpu")
            for z in zips]
    trees = [ranks.trees(n) for n in nets]
    _assert_trees(trees[0], ref, name)
    _assert_same_bits(trees[0], trees[1], name)
    assert nets[0].iteration == 1


@pytest.mark.parametrize("name", ["averaging_periodic",
                                  "averaging_bucketed"])
def test_averaging_replicas_agree_after_each_average(port2, name):
    """After each averaging step (iterations 1 and 3 at frequency 2) both
    replicas hold the same bits; between them they differ."""
    a, b = (port2[r][name]["replicas"] for r in (0, 1))
    assert [x == y for x, y in zip(a, b)] == [False, True, False, True]


# --------------------------------------------------------------------------
# telemetry against the JAX wrapper's series
# --------------------------------------------------------------------------

def _collective_series(metrics):
    return {k: v for k, v in metrics.items()
            if k.startswith(("dl4j_collective_bytes_total",
                             "dl4j_collective_ops_total",
                             "dl4j_collective_buckets",
                             "dl4j_training_steps_total",
                             "dl4j_training_examples_total"))}


@pytest.mark.parametrize("name", ["exact_mlp", "bucketed_small",
                                  "threshold_fixed", "averaging_periodic"])
def test_collective_counters_match_the_jax_wrapper(port2, name):
    """Names, labels and logical byte counts of the exchange series. The
    examples counter counts this rank's rows (the JAX wrapper's, the
    global batch's): the sum over ranks equals it."""
    got = _collective_series(port2[0][name]["metrics"])
    ref = _collective_series(_jax_run(name)["metrics"])
    assert set(got) == set(ref)
    ex = 'dl4j_training_examples_total{path="parallel"}'
    assert got.pop(ex) + _collective_series(
        port2[1][name]["metrics"])[ex] == ref.pop(ex)
    assert got == ref


def test_zero_counters_and_shard_bytes(port2):
    """ZeRO's two series per step on the flat padded layout (the JAX
    ZeroSpec's ``layout_bytes``), and the per-rank footprint gauges."""
    from deeplearning4j_tpu.sharding.zero import ZeroSpec as JZeroSpec

    got = port2[0]["zero"]["metrics"]
    _, net = _jax_net("zero")
    layout = JZeroSpec(net.params, 2).layout_bytes(None)
    steps = 2
    for op in ("grad_reduce_scatter", "param_all_gather"):
        assert got[f'dl4j_collective_bytes_total{{op="{op}"}}'] == \
            sum(layout) * steps
        assert got[f'dl4j_collective_ops_total{{op="{op}"}}'] == \
            len(layout) * steps
    pbytes = sum(np.asarray(v).nbytes for _, v in _leaves(_np(net.params)))
    assert got['dl4j_shard_param_bytes{device="cpu"}'] == pbytes
    ospec = JZeroSpec(net.opt_state, 2)
    assert got['dl4j_shard_opt_bytes{device="cpu"}'] == \
        ospec.bytes_per_device()


# --------------------------------------------------------------------------
# refusals and the launcher
# --------------------------------------------------------------------------

def _port_mlp(**conf_kw):
    conf = MultiLayerConfiguration.from_json(_mlp_conf().to_json())
    conf = dataclasses.replace(conf, **conf_kw)
    return MultiLayerNetwork(conf, "cpu").init()


def _port_moe():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    return ComputationGraph(TransformerEncoder(
        embed_dim=8, n_heads=2, n_layers=1, max_len=4,
        moe_experts=2).conf(), device="cpu").init()


@pytest.mark.parametrize("kw,exc,match", [
    # a per-rank mode trains an MoE net only with its experts sharded
    ({"model": _port_moe, "mesh": port_mesh.Mesh(data=2, data_rank=0),
      "training_mode": TrainingMode.AVERAGING}, NotImplementedError,
     "expert_parallel=True"),
    # the pipeline axis is ported: its stages train under
    # PipelineParallelWrapper, and ParallelWrapper refuses such a mesh
    ({"mesh": port_mesh.Mesh(data=1, data_rank=0, pipeline=2)}, ValueError,
     "PipelineParallelWrapper"),
], ids=["kw0-item 5", "kw1-item 5"])
def test_unported_options_are_refused(kw, exc, match):
    kw = dict(kw)
    model = kw.pop("model", _port_mlp)()
    with pytest.raises(exc, match=match):
        ParallelWrapper(model, **kw)


@pytest.mark.parametrize("kw", [
    {"zero_optimizer": True, "training_mode": TrainingMode.AVERAGING},
    {"zero_optimizer": True, "threshold_algorithm": ThresholdAlgorithm()},
    {"fused_steps": 2, "gradient_bucket_mb": 1},
    {"fused_steps": 2, "zero_optimizer": True},
    {"fused_steps": 2, "training_mode": TrainingMode.AVERAGING},
    {"fused_steps": 2, "threshold_algorithm": ThresholdAlgorithm()},
    {"gradient_bucket_mb": -1},
    {"workers": 3},
])
def test_illegal_combinations_raise_value_error(kw):
    """The JAX package's ValueError refusals, with the same meaning."""
    with pytest.raises(ValueError):
        ParallelWrapper(_port_mlp(), **kw)
    jkw = dict(kw)
    if "training_mode" in jkw:
        jkw["training_mode"] = JMode.AVERAGING
    if "threshold_algorithm" in jkw:
        jkw["threshold_algorithm"] = JThreshold()
    if "workers" not in jkw:
        jkw["workers"] = 1
    with pytest.raises(ValueError):
        JPW(JMLN(_mlp_conf()).init(), mesh=jmesh(n_devices=1), **jkw)


def test_one_rank_takes_any_batch_size():
    """One rank: no size lock (the JAX package's single-process rule); the
    lock's refusal needs ranks (``test_a_failing_rank_fails_the_spawn``)."""
    net = _port_mlp()
    pw = ParallelWrapper(net, prefetch_buffer=0)
    for n in (8, 16):
        x, y = _xy(n, n)
        pw.fit(x, y)
    assert net.iteration == 2


def test_health_hooks_snapshot_and_restore():
    """The thin health hooks: a snapshot taken mid-training (the threshold
    mode's residual and tau with it) restores the model, and the next
    steps repeat the bits they took after the snapshot."""
    net = _port_mlp()
    pw = ParallelWrapper(net, prefetch_buffer=0,
                         threshold_algorithm=ThresholdAlgorithm(1e-3))
    pw.fit(*MLP_BATCHES[0])
    snap = pw._health_snapshot()
    pw.fit(*MLP_BATCHES[1])
    after = {k: {pk: v.clone() for pk, v in vp.items()}
             for k, vp in net.params.items()}
    pw._health_restore(snap)
    assert net.iteration == 1 and pw._tau == snap["tau"]
    pw.fit(*MLP_BATCHES[1])
    for k in after:
        for pk in after[k]:
            assert net.params[k][pk].equal(after[k][pk])


def test_one_rank_without_a_process_group_is_fit():
    """With no process group the mesh is one rank and the exact step is
    ``fit`` bit for bit."""
    a, b = _port_mlp(), _port_mlp()
    pw = ParallelWrapper(a, prefetch_buffer=0)
    for x, y in MLP_BATCHES:
        pw.fit(x, y)
        b.fit(x, y)
    for k in a.params:
        for pk in a.params[k]:
            assert a.params[k][pk].equal(b.params[k][pk])
    assert port_mesh.single_host_mesh().shape["data"] == 1


def test_a_failing_rank_fails_the_spawn():
    """Rank 1 feeds a partition larger than the size the fit fixed: it
    raises the JAX package's ValueError, rank 0 waits in its next
    collective, and the spawn fails within its timeout with both ranks'
    stories instead of hanging."""
    with pytest.raises(RankFailure) as e:
        spawn(ranks.oversized, 2, (), backend="gloo", device="cpu",
              timeout=60.0)
    assert 1 in e.value.failures
    assert "exceeds the established per-host batch" in e.value.failures[1]


def test_the_partition_contract():
    assert port_mesh.partition_rows(61, 0, 2) == (0, 31, 31)
    assert port_mesh.partition_rows(61, 1, 2) == (31, 61, 31)
    assert port_mesh.partition_rows(3, 3, 4) == (3, 3, 1)
    np.testing.assert_array_equal(port_mesh.shard_valid_counts(61, 4),
                                  [16, 16, 16, 13])
    padded = port_mesh.pad_leading((np.ones((3, 2)), None), 5)
    assert padded[0].shape == (5, 2) and padded[1] is None
    assert padded[0][3:].sum() == 0


def test_rank_results_come_back_in_rank_order():
    assert spawn(ranks.echo, 3, ("x",), backend="gloo", device="cpu",
                 timeout=60.0) == [
        (0, 3, "x"), (1, 3, "x"), (2, 3, "x")]
