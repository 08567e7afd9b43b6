"""Expert parallelism in the port against the JAX package, on the CPU.

The reference side is the JAX package in one process: its
``ParallelWrapper(expert_parallel=True)`` on the conftest's 8-device CPU
mesh, its ``moe_spmd_fn`` / ``moe_train_step`` on 1- and 4-device expert
meshes, and its one-device ``fit_batch``. The port side is 2 or 4 gloo
ranks (``parallel.launch.spawn``; one process group a module fixture runs
every scenario of ``tests/torch_expert_ranks.py``), each holding its
partition of the tokens and ``E / world`` experts, exchanging tokens by
all-to-all.

With ``aux_weight`` 0 and a capacity that drops no token, expert
parallelism at any rank count computes the one-device step (the JAX
package's own test condition; the aux loss takes per-rank statistics by
design, GShard's): so the port's step at 2 and 4 ranks is held against the
JAX wrapper at 8 devices and against the JAX ``fit_batch``, with and
without L2 (a penalty on the expert shards counts in full). Every rank
ends with the same gathered params.

Tolerances, the JAX package's EP tests': scores rtol 1e-4, params rtol
1e-3, atol 1e-5; ``moe_spmd_fn`` outputs rtol 1e-4, atol 1e-5; train-step
losses rtol 1e-5, params rtol 1e-4, atol 1e-5. Each comparison checks the
smallest top-k router-probability margin first.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_moe import MoELayer as JMoE
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel.expert import (
    EXPERT_AXIS,
    moe_init,
    moe_spmd_fn,
    moe_train_step,
    shard_moe_params,
)
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JPW
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    ThresholdAlgorithm,
    TrainingMode,
    spawn,
)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh as PMesh

from tests import torch_expert_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

D, CLASSES = 16, 4
SPAWN_TIMEOUT = 240.0
SCORE = dict(rtol=1e-4)
PARAMS = dict(rtol=1e-3, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), tree)


def _margin(probs, k):
    s = -np.sort(-np.asarray(probs), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


def _graph_jconf(n_experts=8, l2=0.0, aux_weight=0.0, seed=7):
    b = (JNNC.builder().seed(seed).updater(JSgd(learning_rate=0.1))
         .weight_init(JWI.XAVIER))
    if l2:
        b = b.l2(l2)
    g = b.graph_builder().add_inputs("input").set_input_types(
        JIT.feed_forward(D))
    g.add_layer("embed", JDense(n_out=D, activation=JAct.TANH), "input")
    g.add_layer("moe", JMoE(n_experts=n_experts, d_hidden=2 * D, top_k=2,
                            aux_weight=aux_weight, capacity_factor=8.0),
                "embed")
    g.add_layer("out", JOut(n_out=CLASSES, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()), "moe")
    g.set_outputs("out")
    return g.build()


def _batch(n=32, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return x, y


def _graph_case(l2, aux_weight=0.0, steps=1, n=32, seed=3):
    jconf = _graph_jconf(l2=l2, aux_weight=aux_weight)
    jnet = JGraph(jconf).init()
    return jconf, jnet, {"kind": "wrapper", "conf_json": jconf.to_json(),
                         "params": _np(dict(jnet.params)),
                         "state": _np(dict(jnet.state)),
                         "batch": _batch(n, seed), "steps": steps}


def _exact_jconf(adam=False):
    """Capacity 1.25 (tokens drop: the queue decides which) and the aux
    loss on, as the zoo's MoE blocks have them."""
    b = (JNNC.builder().seed(9).updater(JAdam(learning_rate=1e-2) if adam
                                        else JSgd(learning_rate=0.1))
         .weight_init(JWI.XAVIER))
    g = b.graph_builder().add_inputs("input").set_input_types(
        JIT.feed_forward(D))
    g.add_layer("embed", JDense(n_out=D, activation=JAct.TANH), "input")
    g.add_layer("moe", JMoE(n_experts=4, d_hidden=2 * D, top_k=2,
                            aux_weight=1e-2, capacity_factor=1.25), "embed")
    g.add_layer("out", JOut(n_out=CLASSES, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()), "moe")
    g.set_outputs("out")
    return g.build()


def _exact_case(adam=False, steps=3):
    jconf = _exact_jconf(adam)
    jnet = JGraph(jconf).init()
    return jconf, jnet, {"kind": "exact", "conf_json": jconf.to_json(),
                         "params": _np(dict(jnet.params)),
                         "state": _np(dict(jnet.state)),
                         "batch": _batch(32, 5), "steps": steps}


def _expert_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (EXPERT_AXIS,))


E, DH, T = 4, 32, 32


def _raw_case(seed, top_k, capacity):
    params = _np(moe_init(jax.random.PRNGKey(seed), D, DH, E))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    target = np.tanh(rng.normal(size=(T, D))).astype(np.float32)
    return {"params": params, "x": x, "target": target, "n_experts": E,
            "capacity": capacity, "top_k": top_k}


CASES = {
    "ep": lambda: _graph_case(0.0)[2],
    "ep_l2": lambda: _graph_case(1e-2)[2],
    "ep_train": lambda: _graph_case(0.0, aux_weight=1e-2, steps=12, n=64,
                                    seed=4)[2],
    "spmd_top1": lambda: {"kind": "spmd", **_raw_case(0, 1, 32)},
    "spmd_top2": lambda: {"kind": "spmd", **_raw_case(3, 2, 64)},
    "step_top1": lambda: {"kind": "train_step", **_raw_case(3, 1, 32)},
    "step_top2": lambda: {"kind": "train_step", **_raw_case(7, 2, 64)},
    "zoo": lambda: {"kind": "zoo", "steps": 15, "model": dict(
        num_classes=3, embed_dim=16, n_heads=2, n_layers=2, max_len=8,
        moe_experts=8, moe_top_k=2, moe_capacity_factor=4.0),
        "batch": (np.random.default_rng(11).normal(size=(16, 8, 16)).astype(
            np.float32), np.eye(3, dtype=np.float32)[
                np.random.default_rng(11).integers(0, 3, 16)])},
    "refuse_split": lambda: {"kind": "refusal", "expert_parallel": True,
                             "conf_json": _graph_jconf(n_experts=3).to_json()},
    "refuse_plain_dp": lambda: {
        "kind": "refusal", "expert_parallel": False,
        "conf_json": _graph_jconf().to_json(),
        "kw": {"training_mode": TrainingMode.AVERAGING}},
    "refuse_threshold_dp": lambda: {
        "kind": "refusal", "expert_parallel": False,
        "conf_json": _graph_jconf().to_json(),
        "kw": {"threshold_algorithm": ThresholdAlgorithm(1e-3)}},
    "refuse_bucketed_dp": lambda: {
        "kind": "refusal", "expert_parallel": False,
        "conf_json": _graph_jconf().to_json(),
        "kw": {"gradient_bucket_mb": 0}},
    "exact": lambda: _exact_case()[2],
    "exact_control": lambda: {**_exact_case()[2],
                              "per_rank_capacity": True},
    "exact_adam": lambda: _exact_case(adam=True)[2],
}
FOUR = ("ep", "ep_l2", "spmd_top1", "spmd_top2", "step_top1", "step_top2")


def _run(world, names):
    return spawn(ranks.run_scenarios, world,
                 ({n: CASES[n]() for n in names},), backend="gloo",
                 device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def port2():
    return _run(2, list(CASES))


@pytest.fixture(scope="module")
def port4():
    return _run(4, FOUR)


def _needs_8_devices():
    if jmesh.single_host_mesh().shape[jmesh.DATA_AXIS] != 8:
        pytest.skip("needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def jax_ep():
    """The JAX side of the wrapper cases: the 8-device EP step and the
    one-device ``fit_batch`` from the same params."""
    _needs_8_devices()
    out = {}
    for name, l2 in (("ep", 0.0), ("ep_l2", 1e-2)):
        jconf, ref, spec = _graph_case(l2)
        x, y = spec["batch"]
        probs = jax.nn.softmax(np.tanh(x @ spec["params"]["embed"]["W"]
                                       + spec["params"]["embed"]["b"])
                               @ spec["params"]["moe"]["router"])
        assert _margin(probs, 2) > 1e-4
        ref_loss = float(ref.fit_batch(JDataSet(x, y)))
        ep = JGraph(jconf).init()
        ep.params = jax.tree_util.tree_map(jnp.asarray, spec["params"])
        ep.state = jax.tree_util.tree_map(jnp.asarray, spec["state"])
        pw = JPW(ep, mesh=jmesh.single_host_mesh(), expert_parallel=True)
        pw.fit(JDataSet(x, y))
        out[name] = {"ref": (ref_loss, _np(dict(ref.params))),
                     "jax_ep": (float(pw.score_value), _np(dict(ep.params)))}
    return out


def _assert_params(got, want):
    for k in want:
        for pk in want[k]:
            np.testing.assert_allclose(got[k][pk], want[k][pk], **PARAMS,
                                       err_msg=f"{k}/{pk}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["ep", "ep_l2"])
@pytest.mark.parametrize("against", ["jax_ep", "ref"])
def test_expert_parallel_step_matches_jax(port2, port4, jax_ep, world, name,
                                          against):
    res = (port2 if world == 2 else port4)[0][name]
    loss, params = jax_ep[name][against]
    np.testing.assert_allclose(res["scores"][0], loss, **SCORE)
    _assert_params(res["params"], params)
    assert res["exchanged"]["all_to_all"] == 2 * 2  # forward and backward


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_ends_with_the_same_params(port2, port4, world):
    results = port2 if world == 2 else port4
    for name in ("ep", "ep_l2"):
        first = results[0][name]["params"]
        for r in results[1:]:
            for k in first:
                for pk in first[k]:
                    np.testing.assert_array_equal(r[name]["params"][k][pk],
                                                  first[k][pk])


def test_expert_parallel_trains(port2):
    losses = port2[0]["ep_train"]["scores"]
    assert losses[-1] < losses[0] * 0.8


def test_zoo_moe_transformer_trains_expert_parallel(port2):
    res = port2[0]["zoo"]
    assert res["losses"][-1] < res["losses"][0] * 0.8
    assert tuple(res["out_shape"]) == (16, 3)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["spmd_top1", "spmd_top2"])
def test_moe_spmd_fn_matches_the_jax_meshes(port2, port4, world, name):
    """The port's sharded layer at 2 and 4 ranks == the JAX layer on a
    1-device expert mesh (ample capacity); the aux, per-rank statistics
    by design, in the same ballpark as the JAX 4-device mesh's."""
    spec = CASES[name]()
    results = port2 if world == 2 else port4
    p, x, k = spec["params"], spec["x"], spec["top_k"]
    assert _margin(jax.nn.softmax(x @ p["router"]), k) > 1e-4
    m1 = _expert_mesh(1)
    y1, aux1 = moe_spmd_fn(E, spec["capacity"], m1, top_k=k)(
        shard_moe_params(p, m1), x)
    y = np.concatenate([r[name]["y"] for r in results])
    np.testing.assert_allclose(y, np.asarray(y1), rtol=1e-4, atol=1e-5)
    m4 = _expert_mesh(4)
    _, aux4 = moe_spmd_fn(E, spec["capacity"], m4, top_k=k)(
        shard_moe_params(p, m4), x)
    if world == 4:
        assert results[0][name]["aux"] == pytest.approx(float(aux4),
                                                        rel=1e-5)
    assert abs(results[0][name]["aux"] - float(aux1)) < 0.3 * max(
        float(aux1), 1.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["step_top1", "step_top2"])
def test_moe_train_step_matches_the_jax_meshes(port2, port4, world, name):
    spec = CASES[name]()
    results = port2 if world == 2 else port4
    k = spec["top_k"]
    outs = {}
    for n in (1, 4):
        mesh = _expert_mesh(n)
        step = moe_train_step(E, spec["capacity"], mesh, lr=0.1, top_k=k,
                              aux_weight=0.0)
        fresh = jax.tree_util.tree_map(jnp.array, spec["params"])
        new, loss = step(shard_moe_params(fresh, mesh), spec["x"],
                         spec["target"])
        outs[n] = (jax.device_get(new), float(loss))
    got_loss = results[0][name]["loss"]
    np.testing.assert_allclose(got_loss, outs[1][1], rtol=1e-5)
    np.testing.assert_allclose(got_loss, outs[4][1], rtol=1e-5)
    for key in ("router", "w1", "w2"):
        got = (results[0][name]["params"][key] if key == "router" else
               np.concatenate([r[name]["params"][key] for r in results]))
        for n in (1, 4):
            np.testing.assert_allclose(got, outs[n][0][key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{key} vs {n}")


def test_expert_count_must_divide_the_ranks(port2):
    msg = port2[0]["refuse_split"]
    assert msg.startswith("ValueError") and \
        "multiple of the data-axis" in msg


def test_an_moe_net_is_refused_by_the_per_rank_modes(port2):
    """Averaging, threshold and bucketed steps route each rank's tokens
    alone: above one rank they refuse an unsharded MoE net, naming both
    ways out (the exact mode takes it)."""
    for name in ("refuse_plain_dp", "refuse_threshold_dp",
                 "refuse_bucketed_dp"):
        msg = port2[0][name]
        assert msg.startswith("NotImplementedError"), name
        assert "expert_parallel=True" in msg and "exact mode" in msg


@pytest.fixture(scope="module")
def jax_exact():
    """The JAX network's ``fit_batch`` on the global batch, step by step:
    what the JAX wrapper's exact mode (one SPMD step over the global
    batch) computes."""
    out = {}
    for name, adam in (("exact", False), ("exact_adam", True)):
        jconf, jnet, spec = _exact_case(adam)
        x, y = spec["batch"]
        probs = jax.nn.softmax(np.tanh(x @ spec["params"]["embed"]["W"]
                                       + spec["params"]["embed"]["b"])
                               @ spec["params"]["moe"]["router"])
        assert _margin(probs, 2) > 1e-4
        scores = [float(jnet.fit_batch(JDataSet(x, y)))
                  for _ in range(spec["steps"])]
        out[name] = (scores, _np(dict(jnet.params)))
    return out


@pytest.mark.parametrize("name", ["exact", "exact_adam"])
def test_moe_exact_mode_matches_jax_on_the_global_batch(port2, jax_exact,
                                                        name):
    """Two ranks, experts unsharded, capacity 1.25 (the global queue drops
    tokens) and the aux loss on: every step's score and the params against
    the JAX network's fit on the global batch, at ``test_torch_moe.py``'s
    tolerances (scores rtol 1e-5, params after SGD atol 2e-6; Adam's
    params with its floor of 1e-2 of the rate)."""
    scores, params = jax_exact[name]
    for r in (0, 1):
        res = port2[r][name]
        np.testing.assert_allclose(res["scores"], scores, rtol=1e-5)
        tol = dict(rtol=0, atol=1e-4 if name == "exact_adam" else 2e-6)
        for k in params:
            for pk in params[k]:
                np.testing.assert_allclose(res["params"][k][pk],
                                           params[k][pk], **tol,
                                           err_msg=f"{name} {k}/{pk}")


def test_moe_per_rank_capacity_misses_the_exact_comparison(port2, jax_exact):
    """The planted control: each rank routing its own tokens alone (its own
    capacity, queue and aux) moves the step outside the tolerance."""
    scores, params = jax_exact["exact"]
    res = port2[0]["exact_control"]
    diff = max(float(np.abs(res["params"][k][pk] - params[k][pk]).max())
               for k in params for pk in params[k])
    assert diff > 100 * 2e-6


def test_global_routing_runs_only_this_ranks_tokens():
    """``moe_apply_global`` at two simulated ranks (the gather hands each
    the other rank's router probabilities): each rank's outputs, the aux
    and the ranks' summed gradients are one rank's ``moe_apply`` over the
    global batch (atol 1e-6), while each rank's experts run only its own
    kept choices: fewer rows than the global queue's ``E x C``."""
    import torch

    from deeplearning4j_tpu_torch.parallel import expert

    t, d, h, e, k, cf = 16, 8, 12, 4, 2, 1.25
    rng = np.random.default_rng(21)
    leaves = [torch.tensor(rng.normal(size=s, scale=0.5).astype(np.float32),
                           requires_grad=True)
              for s in ((d, e), (e, d, h), (e, h, d))]
    router, w1, w2 = leaves
    x = torch.tensor(rng.normal(size=(2 * t, d)).astype(np.float32))
    c = torch.tensor(rng.normal(size=(2 * t, d)).astype(np.float32))
    cap = math.ceil(k * 2 * t / e * cf)
    expert.reset_stats()
    y, aux = expert.moe_apply(router, w1, w2, x, e, cap, top_k=k,
                              axis_name=None)
    whole = expert.stats()["expert_rows"]
    ref = torch.autograd.grad((y * c).sum() + aux, leaves)
    xs, cs_ = x.split(t), c.split(t)
    total = 0.0
    for r in (0, 1):
        other = torch.softmax(xs[1 - r] @ router, dim=-1)

        def gather(p, r=r, other=other):
            return (torch.cat([p, other] if r == 0 else [other, p]), r * t)

        expert.reset_stats()
        yr, auxr = expert.moe_apply_global(router, w1, w2, xs[r], e, cf, k,
                                           gather)
        assert expert.stats()["expert_rows"] < whole
        np.testing.assert_allclose(yr.detach(), y[r * t:(r + 1) * t].detach(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(auxr.item(), aux.item(), rtol=1e-6)
        total = total + (yr * cs_[r]).sum() + auxr / 2
    for g, gr in zip(torch.autograd.grad(total, leaves), ref):
        np.testing.assert_allclose(g, gr, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(training_mode=TrainingMode.AVERAGING), "exact SHARED_GRADIENTS"),
    (dict(threshold_algorithm=ThresholdAlgorithm(1e-3)),
     "exact SHARED_GRADIENTS"),
    (dict(gradient_bucket_mb=25), "no expert_parallel"),
    (dict(zero_optimizer=True), "no expert_parallel"),
    (dict(fused_steps=2), "no expert_parallel"),
])
def test_expert_parallel_refuses_the_jax_wrappers_refusals(kw, match):
    conf = ComputationGraphConfiguration.from_json(_graph_jconf().to_json())
    net = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match=match):
        ParallelWrapper(net, expert_parallel=True, **kw)


def test_expert_parallel_refuses_tbptt():
    conf = ComputationGraphConfiguration.from_json(_graph_jconf().to_json())
    conf.backprop_type = BackpropType.TRUNCATED_BPTT
    net = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="no tBPTT"):
        ParallelWrapper(net, expert_parallel=True)


def test_the_divisibility_check_counts_the_mesh():
    """Without ranks: a mesh of 4 over 6 experts is refused as the JAX
    wrapper refuses it."""
    conf = ComputationGraphConfiguration.from_json(
        _graph_jconf(n_experts=6).to_json())
    net = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="n_experts=6 must be a multiple "
                                         "of the data-axis size 4"):
        ParallelWrapper(net, mesh=PMesh(data=4, data_rank=0),
                        expert_parallel=True)
