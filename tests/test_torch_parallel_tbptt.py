"""Truncated BPTT through ``ParallelWrapper`` in the port against the JAX
package, on the CPU.

The port side is two gloo ranks (``parallel.launch.spawn``, one process
group per module fixture running every scenario of
``tests/torch_tbptt_ranks.py``), each fed its partition of every global
batch. The reference side is the JAX package on the same params and the
same seeded numpy batches (features, labels and, where a scenario says so,
masks):

- the exact mode against the JAX wrapper's exact mode (its whole-batch
  segment scan, SPMD-partitioned over two fake CPU devices): params,
  updater state, the iteration counter and every batch's score; and every
  segment's loss against the same scan composed from the JAX network's
  ``tbptt_scan_parts`` / ``grad_fn`` / ``apply_updates_fn`` on the global
  batch, which the JAX wrapper's scan is;
- the threshold mode against the JAX step composed shard by shard (the
  JAX wrapper's ``shard_map`` threshold step sums a replicated param's
  cotangent twice under jax 0.9, ROADMAP C): per segment each
  shard's gradient, ``encode(g * c * N / ctot + residual)``, the messages
  summed, the update, the adaptive tau retuned from the mean sparsity;
- the averaging mode against the JAX wrapper's averaging mode.

Tolerances: params, updater state and every segment's loss and batch
score rtol 1e-5, atol 1e-6 (float32 sums in other orders than XLA's);
the two Adam scenarios' params with the absolute floor of 1e-2 of the
rate that ``test_torch_tbptt.py`` states (Adam moves a weight whose
gradient rounds to the other sign by up to 2 lr). The others run SGD.
Ragged partitions (13 rows over 2 ranks), back < fwd with a padded tail,
masks and a ComputationGraph are among the scenarios. One rank without a
process group gives ``fit_batch``'s bits, and the JAX wrapper's refusals
stand with its words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBP
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import TrainingListener as JListener
from deeplearning4j_tpu.parallel import (
    AdaptiveThresholdAlgorithm as JAdaptive,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import ThresholdAlgorithm as JThreshold
from deeplearning4j_tpu.parallel import TrainingMode as JMode
from deeplearning4j_tpu.parallel import single_host_mesh as jmesh
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    ThresholdAlgorithm,
    TrainingMode,
    spawn,
)
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests import torch_tbptt_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.02
# Adam's scenarios: its sign-like steps move a weight whose gradient rounds
# to the other sign by up to 2 lr (test_torch_tbptt.py's floor)
ADAM_PARAMS = dict(rtol=1e-5, atol=1e-2 * LR)
ADAM = ("exact_ragged_masked", "averaging")
SPAWN_TIMEOUT = 240.0
N_IN, N_OUT = 4, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conf(fwd, back, t, updater=None, graph=False):
    b = (JNNC.builder().seed(5)
         .updater(updater or JAdam(learning_rate=LR))
         .weight_init(JWI.XAVIER))
    out = jrnn.RnnOutputLayer(n_out=N_OUT, activation=JAct.SOFTMAX,
                              loss_fn=JMCXENT())
    if graph:
        return (b.graph_builder().add_inputs("in")
                .set_input_types(JIT.recurrent(N_IN, t))
                .add_layer("lstm", jrnn.LSTM(n_out=8), "in")
                .add_layer("gru", jrnn.GRU(n_out=6), "lstm")
                .add_layer("out", out, "gru").set_outputs("out")
                .backprop_type(JBP.TRUNCATED_BPTT, fwd=fwd, back=back)
                .build())
    return (b.list().layer(jrnn.LSTM(n_out=8)).layer(jrnn.GRU(n_out=6))
            .layer(out)
            .backprop_type(JBP.TRUNCATED_BPTT, fwd=fwd, back=back)
            .set_input_type(JIT.recurrent(N_IN, t)).build())


def _batch(n, t, seed, mask=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, (n, t))]
    m = None
    if mask:
        lens = rng.integers(t // 3, t + 1, n)
        m = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return x, y, m, m


# name -> (conf kwargs, batches, port wrapper kwargs, epochs)
SGD = dict(updater=JSgd(learning_rate=0.1))
SCENARIOS = {
    "exact": (dict(fwd=5, back=5, t=20, **SGD),
              [_batch(16, 20, s) for s in (0, 1)], {}, 1),
    "exact_ragged_masked": (dict(fwd=5, back=5, t=20),
                            [_batch(13, 20, 2, mask=True),
                             _batch(13, 20, 3, mask=True)], {}, 1),
    "exact_back_lt_fwd": (dict(fwd=5, back=3, t=23, **SGD),
                          [_batch(16, 23, s) for s in (4, 5)], {}, 1),
    "exact_graph": (dict(fwd=4, back=4, t=12, graph=True, **SGD),
                    [_batch(16, 12, s) for s in (6, 7)], {}, 1),
    "threshold_fixed": (dict(fwd=5, back=5, t=20,
                             updater=JSgd(learning_rate=0.1)),
                        [_batch(16, 20, s) for s in (8, 9)],
                        {"threshold": ("fixed", 1e-3)}, 2),
    "threshold_adaptive": (dict(fwd=4, back=2, t=14,
                                updater=JSgd(learning_rate=0.1)),
                           [_batch(13, 14, 10, mask=True),
                            _batch(13, 14, 11, mask=True)],
                           {"threshold": ("adaptive", 1e-3)}, 2),
    "averaging": (dict(fwd=5, back=5, t=20),
                  [_batch(16, 20, s) for s in (12, 13, 14)],
                  {"averaging": True, "averaging_frequency": 6}, 1),
}

EXACT = [n for n in SCENARIOS if n.startswith("exact")]


def _jax_net(name):
    conf = _conf(**SCENARIOS[name][0])
    return conf, (JCG if SCENARIOS[name][0].get("graph") else JMLN)(
        conf).init()


def _spec(name):
    conf, net = _jax_net(name)
    _, batches, wrapper, epochs = SCENARIOS[name]
    return {"name": name, "kind": ("graph" if SCENARIOS[name][0].get(
        "graph") else "mln"), "conf_json": conf.to_json(),
            "params": _np(net.params), "state": _np(net.state),
            "batches": batches, "wrapper": wrapper, "epochs": epochs}


@pytest.fixture(scope="module")
def port2():
    """Every scenario at two gloo ranks, in one process group."""
    return spawn(ranks.run_scenarios, 2, ([_spec(n) for n in SCENARIOS],),
                 backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


class _JRecord(JListener):
    def __init__(self):
        self.scores, self.iterations = [], []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))
        self.iterations.append(int(iteration))


def _jds(name, x, y, fm, lm):
    if SCENARIOS[name][0].get("graph"):
        return JMDS(features=[x], labels=[y],
                    features_masks=None if fm is None else [fm],
                    labels_masks=None if lm is None else [lm])
    return JDataSet(x, y, fm, lm)


_CACHE = {}


def _jax_wrapper(name):
    """The JAX wrapper at two fake devices: trees, batch scores and the
    iterations the listeners saw."""
    if ("pw", name) in _CACHE:
        return _CACHE["pw", name]
    _, net = _jax_net(name)
    _, batches, kw, epochs = SCENARIOS[name]
    kw = dict(kw)
    if kw.pop("averaging", False):
        kw["training_mode"] = JMode.AVERAGING
    rec = _JRecord()
    net.set_listeners(rec)
    JPW(net, workers=2, mesh=jmesh(n_devices=2), prefetch_buffer=0,
        **kw).fit(JList([_jds(name, *b) for b in batches]), epochs=epochs)
    out = {"params": _np(net.params), "opt": _np(net.opt_state),
           "scores": rec.scores, "iterations": rec.iterations,
           "iteration": net.iteration}
    _CACHE["pw", name] = out
    return out


def _composed(name, workers=2):
    """The JAX network's own segment scan composed step by step: every
    segment's gradients over the global batch (exact, ``shards=1``), or
    per shard with the threshold exchange. Returns the trees, every
    segment's loss, each batch's score and the taus."""
    if ("composed", name) in _CACHE:
        return _CACHE["composed", name]
    from deeplearning4j_tpu.parallel import compression as jcomp
    from deeplearning4j_tpu.parallel import mesh as jmesh_mod

    conf_kw, batches, kw, epochs = SCENARIOS[name]
    _, net = _jax_net(name)
    graph = bool(conf_kw.get("graph"))
    seg, back = conf_kw["fwd"], conf_kw["back"]
    segments, zero_carries, advance, _ = net.tbptt_scan_parts(seg, back)
    gfn, afn = jax.jit(net.grad_fn()), jax.jit(net.apply_updates_fn())
    advance, encode = jax.jit(advance), jax.jit(jcomp.encode_tree)
    thr = kw.get("threshold")
    algo = None if thr is None else (JThreshold(thr[1]) if thr[0] == "fixed"
                                     else JAdaptive(thr[1]))
    shards = 1 if algo is None else workers
    tau = None if algo is None else float(algo.threshold)
    rng = jax.random.PRNGKey(0)
    params, state, opt = net.params, net.state, net.opt_state
    res = [jax.tree_util.tree_map(jnp.zeros_like, params)] * shards
    seg_losses, scores, taus = [], [], []
    it = 0
    for _ in range(epochs):
        for b in batches:
            rows = b[0].shape[0]
            target = -(-rows // workers) * workers
            arrays = net.tbptt_batch_arrays(_jds(name, *b))
            arrays = jmesh_mod.pad_leading(tuple(arrays), target)
            c = (jmesh_mod.shard_valid_counts(rows, shards) if shards > 1
                 else np.asarray([rows], np.float32))
            ctot = np.float32(max(c.sum(), 1.0))
            s = target // shards

            def shard(a, r):
                if a is None:
                    return None
                if isinstance(a, (list, tuple)):
                    return type(a)(shard(v, r) for v in a)
                return a[r * s:(r + 1) * s]

            parts = [tuple(shard(a, r) for a in arrays)
                     for r in range(shards)]
            if graph:
                segd = [[list(zip(*segments(g))) for g in p] for p in parts]
                segd = [list(zip(*p)) for p in segd]
            else:
                segd = [list(zip(*(segments(a) for a in p))) for p in parts]
            carries = [zero_carries(p[0]) for p in parts]
            losses = []
            for j in range(len(segd[0])):
                outs = []
                for r in range(shards):
                    f_s, l_s, fm_s, lm_s = segd[r][j]
                    if graph:
                        f_s, l_s, fm_s, lm_s = (list(v) for v in (
                            f_s, l_s, fm_s, lm_s))
                    f_s, l_s, fm_s, lm_s, carries[r] = advance(
                        params, state, carries[r], f_s, l_s, fm_s, lm_s)
                    loss, ns, g, carries[r] = gfn(params, state, f_s, l_s,
                                                  fm_s, lm_s, rng,
                                                  carries=carries[r])
                    outs.append((loss, ns, g))
                if algo is None:
                    shared = outs[0][2]
                    state = outs[0][1]
                    loss = float(outs[0][0])
                else:
                    enc, sps = [], []
                    for r in range(shards):
                        wr = np.float32(c[r] * np.float32(shards) / ctot)
                        g = jax.tree_util.tree_map(lambda v: v * wr,
                                                   outs[r][2])
                        e, res[r], sp = encode(g, res[r], np.float32(tau))
                        enc.append(e)
                        sps.append(sp)
                    shared = enc[0]
                    for e in enc[1:]:
                        shared = jax.tree_util.tree_map(jnp.add, shared, e)
                    ws = [np.float32(c[r] / ctot) for r in range(shards)]
                    state = jax.tree_util.tree_map(
                        lambda *ss: sum(si * wi for si, wi in zip(ss, ws)),
                        *[o[1] for o in outs]) if state else state
                    loss = float(sum(float(o[0]) * float(c[r])
                                     for r, o in enumerate(outs)) / ctot)
                    tau = float(algo.update(np.float32(tau),
                                            np.float32(sum(sps) / shards)))
                params, opt = afn(params, opt, shared, jnp.float32(it),
                                  jnp.float32(0))
                losses.append(loss)
                it += 1
            seg_losses.append(losses)
            scores.append(float(np.mean(np.asarray(losses, np.float32))))
            taus.append(tau)
    out = {"params": _np(params), "opt": _np(opt), "segments": seg_losses,
           "scores": scores, "taus": taus, "iteration": it}
    _CACHE["composed", name] = out
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_trees(got, ref, what):
    for part in ("params", "opt"):
        tol = ADAM_PARAMS if what in ADAM and part == "params" else TOL
        g = dict(_leaves(got[part]))
        for p, v in _leaves(ref[part]):
            np.testing.assert_allclose(g[p], v, **tol,
                                       err_msg=f"{what} {part} {p}")


# --------------------------------------------------------------------------
# the modes against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", EXACT)
def test_exact_tbptt_matches_the_jax_wrapper(port2, name):
    got, ref = port2[0][name], _jax_wrapper(name)
    _assert_trees(got["trees"], ref, name)
    np.testing.assert_allclose(got["scores"], ref["scores"], **TOL)
    assert got["iteration"] == ref["iteration"]
    assert got["iterations"] == ref["iterations"]


@pytest.mark.parametrize("name", EXACT)
def test_exact_tbptt_every_segment_loss_matches_jax(port2, name):
    got, ref = port2[0][name], _composed(name)
    np.testing.assert_allclose(np.concatenate(got["segments"]),
                               np.concatenate(ref["segments"]), **TOL)
    _assert_trees(got["trees"], ref, name)


@pytest.mark.parametrize("name", ["threshold_fixed", "threshold_adaptive"])
def test_threshold_tbptt_matches_the_composed_jax_step(port2, name):
    got, ref = port2[0][name], _composed(name)
    np.testing.assert_allclose(np.concatenate(got["segments"]),
                               np.concatenate(ref["segments"]), **TOL)
    np.testing.assert_allclose(got["scores"], ref["scores"], **TOL)
    np.testing.assert_allclose(got["taus"], ref["taus"], rtol=1e-5)
    _assert_trees(got["trees"], ref, name)
    assert got["iteration"] == ref["iteration"]


def test_adaptive_tau_is_retuned_every_segment(port2):
    """Four segments a batch: tau after each batch has moved four times
    from the last (not once), as the JAX scan retunes it."""
    got = port2[0]["threshold_adaptive"]
    algo = JAdaptive(1e-3)
    tau = np.float32(algo.threshold)
    once = float(algo.update(tau, np.float32(1.0)))
    assert got["taus"][0] != pytest.approx(once, rel=1e-6)


def test_averaging_tbptt_matches_the_jax_wrapper(port2):
    got, ref = port2[0]["averaging"], _jax_wrapper("averaging")
    _assert_trees(got["trees"], ref, "averaging")
    np.testing.assert_allclose(got["scores"], ref["scores"], **TOL)
    assert got["iteration"] == ref["iteration"] == 12


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_ends_with_the_same_params(port2, name):
    np.testing.assert_array_equal(port2[0][name]["params_flat"],
                                  port2[1][name]["params_flat"])


# --------------------------------------------------------------------------
# in one process
# --------------------------------------------------------------------------

def _port_pair(fwd=5, back=5, t=20):
    jconf = _conf(fwd, back, t)
    jnet = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return (MultiLayerNetwork(conf, "cpu").set_params(p, s),
            MultiLayerNetwork(conf, "cpu").set_params(p, s))


@pytest.mark.parametrize("fwd,back,t", [(5, 5, 20), (5, 3, 23)])
def test_one_rank_is_fit_batch_bit_for_bit(fwd, back, t):
    """The exact mode at one rank (no process group): every collective is
    the identity, so the wrapper trains ``fit_batch``'s bits."""
    a, b = _port_pair(fwd, back, t)
    batches = [_batch(8, t, s, mask=True) for s in (0, 1)]
    for x, y, fm, lm in batches:
        a.fit_batch(DataSet(x, y, fm, lm))
    ParallelWrapper(b, prefetch_buffer=0).fit(
        ListDataSetIterator([DataSet(*bt) for bt in batches]))
    assert a.iteration == b.iteration
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    torch.testing.assert_close(a.last_segment_losses, b.last_segment_losses,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw,jax_kw", [
    ({"gradient_bucket_mb": 1}, {"gradient_bucket_mb": 1}),
    ({"zero_optimizer": True}, {"zero_optimizer": True}),
    ({"fused_steps": 2}, {"fused_steps": 2}),
    ({"expert_parallel": True}, {"expert_parallel": True}),
], ids=["buckets", "zero", "fused_steps", "expert_parallel"])
def test_the_jax_refusals_stand(kw, jax_kw):
    """tBPTT with explicit buckets, ZeRO, ``fused_steps`` or
    ``expert_parallel``: a ValueError in both packages, naming tBPTT."""
    net, _ = _port_pair()
    with pytest.raises(ValueError, match="tBPTT"):
        ParallelWrapper(net, **kw)
    with pytest.raises(ValueError, match="tBPTT"):
        JPW(JMLN(_conf(5, 5, 20)).init(), workers=1,
            mesh=jmesh(n_devices=1), **jax_kw)


def test_threshold_and_averaging_take_a_tbptt_net():
    net, _ = _port_pair()
    ParallelWrapper(net, threshold_algorithm=ThresholdAlgorithm(1e-3))
    ParallelWrapper(net, training_mode=TrainingMode.AVERAGING)
