"""DP x TP training in the port against the JAX package.

The port side is one spawn of 4 gloo ranks (data 2 x model 2, the
``tests/torch_sharding_ranks.py`` scenarios), each rank fed its data
index's rows of every global batch and holding its model index's slice of
every sharded leaf. The reference side is the JAX network's ``fit`` on the
global batches in one process and the JAX package's own
DP x TP wrapper (``ParallelWrapper(partition_rules=...)`` on a 2 x 2 mesh
of the conftest's CPU devices). Both start from the JAX network's params;
dropout is off.

Tolerances: params and updater state ``rtol 5e-5, atol 5e-6`` after 3 Adam
steps (``test_partition_rules_dp_tp_matches_dp``'s, the JAX package's DP x
TP limit: the split products and the row-parallel sums add in other
orders); the residual CNN's convs feed batch norms and carry no bias (a
bias there has a gradient of rounding noise, which Adam turns into
lr-sized steps in either package). The transformer is held by the rule of
``tests/test_torch_transformer_training.py``, which the port's unsharded
``fit`` meets against the JAX package too: each param's update within a
relative L2 error of 1e-3 and every element within Adam's largest move, 2
lr a step (a gradient element within rounding of 0, or of Adam's epsilon,
takes another normalized step in the other package), the key bias ``bk``
(its gradient is 0 in exact arithmetic) by the elementwise bound alone;
its Adam state, every ``m`` and ``v``, within 1e-5 relative L2 error of
the JAX package's (the unsharded port's ``fit`` reads 2.9e-06), ``bk``'s
elementwise within 2e-7 of its layer's largest moment (3.6e-08 unsharded:
its moments are rounding noise).
"""

import threading

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.graph import ElementWiseOp as JEOp
from deeplearning4j_tpu.conf.graph import ElementWiseVertex as JEW
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers import ActivationLayer as JActL
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JCM
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import TrainingListener as JListener
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import single_host_mesh as jmesh
from deeplearning4j_tpu.parallel import tensor as jtensor
from deeplearning4j_tpu.sharding import ShardingPlan as JPlan
from deeplearning4j_tpu.zoo import rules as jzr
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
from deeplearning4j_tpu_torch.conf.multilayer import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    ThresholdAlgorithm,
    TrainingMode,
    spawn,
)
from deeplearning4j_tpu_torch.parallel import mesh as port_mesh
from deeplearning4j_tpu_torch.sharding import ShardingPlan
from deeplearning4j_tpu_torch.sharding.rules import P
from deeplearning4j_tpu_torch.util.convert import layout_perm

from tests import torch_sharding_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL, ATOL = 5e-5, 5e-6
SPAWN_TIMEOUT = 240.0
MESH = (2, 2)  # data x model


@pytest.fixture(scope="module", autouse=True)
def _no_jax_executables_left():
    """This module leaves nothing in the JAX package's executable cache
    (bounded at 256 entries): the JAX tests that count its entries
    (``tests/test_fused.py``) may run after it in the same worker."""
    yield
    from deeplearning4j_tpu.optimize import aot_cache as jax_aot_cache

    jax_aot_cache.clear()


def _mlp_conf():
    return (JNNC.builder().seed(12345).updater(JAdam(learning_rate=0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=16, activation=JAct.TANH))
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=4, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(6))
            .build())


def _lenet_conf():
    return JLeNet(num_classes=10, height=12, width=12).conf()


def _lm_conf():
    return JTransformer(vocab_size=50, embed_dim=64, n_heads=4, n_layers=2,
                        max_len=8, causal=True, lm_head=True).conf()


def _resnet_conf():
    """A 2-block residual CNN with the zoo ResNets' vertex names (convs,
    BN, an add, a dense head named ``output``)."""
    def conv(n):
        return JConv(n_out=n, kernel_size=(3, 3), convolution_mode=JCM.SAME,
                     has_bias=False, activation=JAct.IDENTITY)

    g = (JNNC.builder().seed(7).updater(JAdam(learning_rate=0.01))
         .weight_init(JWI.XAVIER).graph_builder()
         .add_inputs("in")
         .set_input_types(JIT.convolutional(8, 8, 3))
         .add_layer("stem", conv(8), "in")
         .add_layer("stem_bn", JBN(), "stem")
         .add_layer("stem_relu", JActL(activation=JAct.RELU), "stem_bn"))
    prev = "stem_relu"
    for i in range(2):
        g.add_layer(f"b{i}_conv", conv(8), prev)
        g.add_layer(f"b{i}_bn", JBN(), f"b{i}_conv")
        g.add_vertex(f"b{i}_add", JEW(op=JEOp.ADD), prev, f"b{i}_bn")
        g.add_layer(f"b{i}_relu", JActL(activation=JAct.TANH), f"b{i}_add")
        prev = f"b{i}_relu"
    g.add_layer("pool", JGP(pooling_type=JPT.AVG), prev)
    g.add_layer("output", JOut(n_out=4, activation=JAct.SOFTMAX,
                               loss_fn=JMCXENT()), "pool")
    return g.set_outputs("output").build()


def _xy(n, seed, shape, classes):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _lm_batch(seed, b=8, t=8, vocab=50):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, t)).astype(np.float32)
    y = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (b, t))]
    return x, y


W_RULES = [(r"W$", (None, "model")), (r".*", ())]
SCENARIOS = {
    # name: (conf, kind, batches, rules)
    "mlp": (_mlp_conf, "mln", [_xy(16, s, (6,), 4) for s in (0, 1, 2)],
            W_RULES),
    # the first kernel cut over the data axis: its gathers sum the
    # gradient over the data ranks, and it stays out of their exchange
    "mlp_data_axis": (_mlp_conf, "mln",
                      [_xy(16, s, (6,), 4) for s in (0, 1, 2)],
                      [(r"^0/W$", ("data", None))] + W_RULES),
    "lenet": (_lenet_conf, "mln",
              [(np.random.default_rng(s).random((8, 12, 12, 1),
                                                np.float32),
                np.eye(10, dtype=np.float32)[
                    np.random.default_rng(s + 9).integers(0, 10, 8)])
               for s in (3, 4, 5)], "lenet_rules"),
    "transformer": (_lm_conf, "graph", [_lm_batch(s) for s in (6, 7, 8)],
                    "transformer_rules"),
    "resnet": (_resnet_conf, "graph",
               [_xy(8, s, (8, 8, 3), 4) for s in (9, 10, 11)],
               "resnet_rules"),
}


def _rules(name):
    rules = SCENARIOS[name][3]
    if isinstance(rules, str):
        return [(pat, tuple(spec)) for pat, spec in getattr(jzr, rules)()]
    return rules


def _jrules(name):
    return [(pat, JP(*spec)) for pat, spec in _rules(name)]


_JNETS = {}


def _jnet(name):
    """The scenario's JAX network (fresh from its seeded params each
    call)."""
    conf = SCENARIOS[name][0]()
    if name not in _JNETS:
        net = (JCG if SCENARIOS[name][1] == "graph" else JMLN)(conf).init()
        _JNETS[name] = (jax.tree_util.tree_map(np.asarray, net.params),
                        jax.tree_util.tree_map(np.asarray, net.state))
    params, state = _JNETS[name]
    net = (JCG if SCENARIOS[name][1] == "graph" else JMLN)(conf).init()
    net.params = jax.tree_util.tree_map(np.copy, params)
    net.state = jax.tree_util.tree_map(np.copy, state)
    return conf, net


def _spec(scenario, **extra):
    conf, net = _jnet(scenario)
    kind, batches = SCENARIOS[scenario][1], SCENARIOS[scenario][2]
    return {"name": scenario, "fn": "train", "kind": kind,
            "conf_json": conf.to_json(), "params": _JNETS[scenario][0],
            "state": _JNETS[scenario][1], "batches": batches,
            "rules": _rules(scenario), "mesh": MESH, **extra}


TP_BLOCK = dict(d=16, heads=4, ff=32, b=4, t=6, steps=10, lr=0.05)


def _tp_block_spec():
    c = TP_BLOCK
    params = jtensor.tp_block_init(jax.random.PRNGKey(0), c["d"], c["heads"],
                                   c["ff"])
    params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(1)
    return {"name": "tp_block", "fn": "tp_block", "params": params,
            "x": rng.normal(size=(c["b"], c["t"], c["d"])).astype(np.float32),
            "targets": rng.normal(size=(c["b"], c["t"], c["d"])).astype(
                np.float32),
            "n_heads": c["heads"], "steps": c["steps"], "lr": c["lr"],
            "mesh": MESH}


def _specs():
    specs = [_spec(n) for n in SCENARIOS]
    skip = dict(plant=(1, 1), health="skip_step")
    specs.append(_spec("mlp", name="mlp_skip", **skip))
    specs.append(_spec("mlp", name="mlp_skip_dp", plan=False, **skip))
    specs.append(_tp_block_spec())
    return specs


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    """Every 4-rank scenario in one process group, started in a thread so
    the JAX references compute meanwhile: per rank {name: result}."""
    tmp = str(tmp_path_factory.mktemp("tp4"))
    box = {}

    def run():
        try:
            box["out"] = spawn(ranks.run_scenarios, 4, (_specs(), tmp),
                               backend="gloo", device="cpu",
                               timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # re-raised in the fixture
            box["out"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for name in SCENARIOS:  # the JAX references, while the ranks train
        _jax_fit(name)
        _jax_dp_tp(name)
    t.join()
    if isinstance(box["out"], BaseException):
        raise box["out"]
    return box["out"]


class _JRecord(JListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))


_JAX = {}


def _trees(net):
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": host(net.params), "state": host(net.state),
            "opt": host(net.opt_state)}


def _jax_fit(name):
    """The JAX network's ``fit`` on the global batches."""
    if ("fit", name) not in _JAX:
        _, net = _jnet(name)
        rec = _JRecord()
        net.set_listeners(rec)
        for x, y in SCENARIOS[name][2]:
            net.fit(JDataSet(x, y))
        _JAX[("fit", name)] = {"trees": _trees(net), "scores": rec.scores}
    return _JAX[("fit", name)]


def _jax_plan(name, net=None):
    mesh = jmesh(data=MESH[0], model=MESH[1])
    plan = JPlan(_jrules(name), mesh=mesh, demote_indivisible=True)
    if net is not None:
        plan.param_specs(net.params)
        plan.opt_specs(net.params, net.opt_state)
    return plan


def _jax_dp_tp(name):
    """The JAX package's DP x TP wrapper on the global batches."""
    if ("pw", name) not in _JAX:
        _, net = _jnet(name)
        plan = _jax_plan(name)
        rec = _JRecord()
        net.set_listeners(rec)
        pw = JPW(net, workers=MESH[0], mesh=plan.mesh, partition_rules=plan,
                 prefetch_buffer=0)
        for x, y in SCENARIOS[name][2]:
            pw.fit(JDataSet(x, y))
        _JAX[("pw", name)] = {"trees": _trees(net), "scores": rec.scores}
    return _JAX[("pw", name)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    ga, wa = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


LM_LR, LM_STEPS = 1e-3, 3  # the zoo transformer's Adam, the steps
UPDATE_L2 = 1e-3


def _adam_rule(got, want, start):
    """The transformer's rule (module docstring): each param's update
    within UPDATE_L2 relative L2 error (``bk`` aside), every element
    within 2 lr a step."""
    bound = 2 * LM_LR * LM_STEPS
    for k, vp in want.items():
        for pk, w in vp.items():
            a, b = np.asarray(got[k][pk]), np.asarray(w)
            assert np.abs(a - b).max() <= bound, (k, pk)
            if pk == "bk":
                continue
            ua, ub = a - start[k][pk], b - start[k][pk]
            err = np.linalg.norm(ua - ub) / max(np.linalg.norm(ub), 1e-30)
            assert err <= UPDATE_L2, (k, pk, err)


# set from the port's unsharded ``fit`` against the JAX package's on this
# scenario: moments within 2.9e-06 relative L2, ``bk``'s within 3.6e-08
# of its layer's largest moment
MOMENT_L2 = 1e-5
BK_MOMENT_SHARE = 2e-7


def _moment_rule(got, want):
    """The transformer's Adam state (module docstring): every ``m`` and
    ``v`` within MOMENT_L2 relative L2 error of the JAX package's, ``bk``'s
    elementwise within BK_MOMENT_SHARE of its layer's largest moment of
    the same kind. Returns {(layer, param, moment): error}."""
    errs = {}
    for k, vp in want.items():
        for pk, slots in vp.items():
            for mk, w in slots.items():
                a, b = np.asarray(got[k][pk][mk]), np.asarray(w)
                if pk == "bk":
                    top = max(np.abs(np.asarray(s_[mk])).max()
                              for s_ in vp.values())
                    err = np.abs(a - b).max() / top
                    assert err <= BK_MOMENT_SHARE, (k, pk, mk, err)
                else:
                    err = (np.linalg.norm(a - b)
                           / max(np.linalg.norm(b), 1e-30))
                    assert err <= MOMENT_L2, (k, pk, mk, err)
                errs[(k, pk, mk)] = float(err)
    return errs


def _held(name, got, want):
    if name == "transformer":
        _adam_rule(got["trees"]["params"], want["trees"]["params"],
                   _JNETS[name][0])
        _moment_rule(got["trees"]["opt"], want["trees"]["opt"])
        return
    _close(got["trees"]["params"], want["trees"]["params"])
    _close(got["trees"]["opt"], want["trees"]["opt"])
    _close(got["trees"]["state"], want["trees"]["state"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dp_tp_matches_jax_fit_on_the_global_batch(port4, name):
    want = _jax_fit(name)
    for rank in range(4):
        got = port4[rank][name]
        _held(name, got, want)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-5)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dp_tp_matches_the_jax_dp_tp_wrapper(port4, name):
    want = _jax_dp_tp(name)
    got = port4[0][name]
    _held(name, got, want)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=2e-5)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_ends_with_the_same_bits(port4, name):
    assert len({port4[r][name]["digest"] for r in range(4)}) == 1


def _expected_local(name):
    """Each leaf's shape on a rank, from the JAX plan's specs: the JAX
    package's shard shape, in the port's layout."""
    conf, net = _jnet(name)
    plan = _jax_plan(name, net)
    specs = plan.param_specs(net.params)
    pconf = _port_conf(name)
    layers = _port_layers(pconf)
    out = {}
    for k, vp in net.params.items():
        for pk, v in vp.items():
            shape = list(np.shape(v))
            sizes = {"data": MESH[0], "model": MESH[1]}
            for d, e in enumerate(specs[k][pk]):
                if e is not None:
                    shape[d] //= sizes[e]
            perm = layout_perm(layers[k], pk, len(shape))
            if perm is not None:
                port = [0] * len(shape)
                for i, p in enumerate(perm):
                    port[p] = shape[i]
                shape = port
            out.setdefault(k, {})[pk] = tuple(shape)
    return out


def _port_conf(name):
    from deeplearning4j_tpu_torch.conf.graph import (
        ComputationGraphConfiguration,
    )

    js = SCENARIOS[name][0]().to_json()
    return (ComputationGraphConfiguration.from_json(js)
            if SCENARIOS[name][1] == "graph"
            else MultiLayerConfiguration.from_json(js))


def _port_layers(conf):
    from deeplearning4j_tpu_torch.sharding.rules import layer_confs

    return layer_confs(conf)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_rank_holds_only_its_shard(port4, name):
    want = _expected_local(name)
    for rank in range(4):
        assert port4[rank][name]["local"] == want
    # the split is real: some leaf is cut in two
    full = {k: {pk: tuple(np.shape(v)) for pk, v in vp.items()}
            for k, vp in _JNETS[name][0].items()}
    cut = [(k, pk) for k in want for pk in want[k]
           if np.prod(want[k][pk]) * 2 == np.prod(full[k][pk])]
    assert cut


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_shard_byte_gauges_hold_the_plan_accounting(port4, name):
    _, net = _jnet(name)
    plan = _jax_plan(name, net)
    want = (plan.param_bytes_per_device(net.params),
            plan.opt_bytes_per_device(net.params, net.opt_state))
    for rank in range(4):
        got = port4[rank][name]
        assert tuple(got["gauges"]) == want
        assert tuple(got["plan_bytes"]) == want
        assert tuple(got["local_bytes"]) == want


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_explain_rows_equal_the_jax_plan(port4, name):
    _, net = _jnet(name)
    want = _jax_plan(name, net).explain(fmt="json")
    got = port4[0][name]["explain"]
    assert got["mesh"] == want["mesh"] == {"data": 2, "model": 2}
    assert got["params"] == want["params"]

    def rows(t):
        return {(r["path"], tuple(r["shape"]), r["spec"])
                for r in t["opt_state"]}

    assert rows(got) == rows(want)


def test_the_zoo_tables_compute_their_layers_shards(port4):
    """The layers the zoo tables split run their own sharded forward (the
    Megatron pairs keep the FFN's hidden features split)."""
    tr = port4[0]["transformer"]["splits"]
    assert tr["b0_attn"] == ("attention", False, False)
    assert tr["b0_ff1"] == ("column", False, True)
    assert tr["b0_ff2"] == ("row", True, False)
    assert tr["embed"][0] == "embed_cols"
    assert tr["output"][0] == "column"
    ln = port4[0]["lenet"]["splits"]
    assert ln["0"][0] == ln["2"][0] == "conv"
    assert ln["5"] == ("column", False, False)
    assert port4[0]["resnet"]["splits"]["b0_conv"][0] == "conv"
    # a data-axis cut takes the general route (gathered before use)
    assert port4[0]["mlp_data_axis"]["splits"]["0"][0] == "general"


def test_skip_step_under_a_plan_matches_the_dp_wrapper(port4):
    """A NaN planted in data index 1's rows of step 2: the plan's step is
    skipped on every rank, bit for bit, as the DP wrapper skips it, and the
    two runs end within the DP x TP tolerance."""
    for rank in range(4):
        tp, dp = port4[rank]["mlp_skip"], port4[rank]["mlp_skip_dp"]
        assert tp["same"] and dp["same"]
        assert tp["skipped"] == dp["skipped"] == 1
        assert tp["nonfinite"] == dp["nonfinite"] == 1
        _close(tp["trees"]["params"], dp["trees"]["params"])
        _close(tp["trees"]["opt"], dp["trees"]["opt"])


def _jax_tp_block():
    """The JAX block on one device: the output, and ``tp_train_step``'s
    losses and params."""
    spec = _tp_block_spec()
    params = {k: jax.numpy.asarray(v) for k, v in spec["params"].items()}
    y = jtensor.tp_block_apply(params, spec["x"], spec["n_heads"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    step = jtensor.tp_train_step(mesh, spec["n_heads"], lr=spec["lr"])
    losses = []
    p = params
    for _ in range(spec["steps"]):
        p, loss = step(p, spec["x"], spec["targets"])
        losses.append(float(loss))
    return np.asarray(y), losses, {k: np.asarray(v) for k, v in p.items()}


def test_tp_block_apply_matches_the_single_device_block(port4):
    want, _, _ = _jax_tp_block()
    for rank in range(4):
        got = port4[rank]["tp_block"]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["y"], want[lo:hi], rtol=2e-5,
                                   atol=2e-5)
        c = TP_BLOCK
        assert got["local_shapes"]["w_qkv"] == (c["d"], 3 * c["d"] // 2)
        assert got["local_shapes"]["w_ff2"] == (c["ff"] // 2, c["d"])


def test_tp_train_step_matches_the_single_device_step(port4):
    _, losses, params = _jax_tp_block()
    for rank in range(4):
        got = port4[rank]["tp_block"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        assert got["losses"][-1] < got["losses"][0]
        for k, v in params.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=2e-5,
                                       atol=2e-5)


# --------------------------------------------------------------------------
# the JAX package's refusals (no ranks: a one-rank mesh)
# --------------------------------------------------------------------------

def _port_mlp(tbptt=False):
    conf = MultiLayerConfiguration.from_json(_mlp_conf().to_json())
    if tbptt:
        conf.backprop_type = BackpropType.TRUNCATED_BPTT
        conf.tbptt_fwd_length = 4
    return MultiLayerNetwork(conf, "cpu").init()


REFUSED = {
    "averaging": {"training_mode": TrainingMode.AVERAGING},
    "threshold": {"threshold_algorithm": ThresholdAlgorithm()},
    "expert_parallel": {"expert_parallel": True},
    "zero": {"zero_optimizer": True},
    "buckets": {"gradient_bucket_mb": 1},
    "fused_steps": {"fused_steps": 2},
}


@pytest.mark.parametrize("kind", list(REFUSED) + ["tbptt", "other_mesh"])
def test_the_jax_refusals_of_partition_rules(kind):
    rules = [(r"W$", P(None, "model")), (".*", P())]
    if kind == "tbptt":
        with pytest.raises(ValueError, match="partition_rules"):
            ParallelWrapper(_port_mlp(tbptt=True), partition_rules=rules)
        return
    if kind == "other_mesh":
        plan = ShardingPlan(rules, mesh=port_mesh.Mesh(data=1, data_rank=0))
        with pytest.raises(ValueError, match="wrapper's mesh"):
            ParallelWrapper(_port_mlp(),
                            mesh=port_mesh.Mesh(data=1, data_rank=0),
                            partition_rules=plan)
        # the JAX package interns meshes of one shape: another shape
        jplan = JPlan([(r"W$", JP(None, "model")), (".*", JP())],
                      mesh=jmesh(n_devices=2))
        with pytest.raises(ValueError, match="wrapper's mesh"):
            JPW(JMLN(_mlp_conf()).init(), mesh=jmesh(n_devices=1),
                partition_rules=jplan)
        return
    with pytest.raises(ValueError, match="partition_rules|fused_steps"):
        ParallelWrapper(_port_mlp(), partition_rules=rules, **REFUSED[kind])
    jkw = dict(REFUSED[kind])
    if "training_mode" in jkw:
        from deeplearning4j_tpu.parallel import TrainingMode as JMode

        jkw["training_mode"] = JMode.AVERAGING
    if "threshold_algorithm" in jkw:
        from deeplearning4j_tpu.parallel import ThresholdAlgorithm as JThr

        jkw["threshold_algorithm"] = JThr()
    with pytest.raises(ValueError):
        JPW(JMLN(_mlp_conf()).init(), mesh=jmesh(n_devices=1), workers=1,
            partition_rules=[(r"W$", JP(None, "model")), (".*", JP())],
            **jkw)


def test_a_one_rank_plan_is_the_plain_step():
    """At one rank every mesh axis is 1: nothing is cut and the plan's step
    gives ``fit``'s bits."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    x, y = SCENARIOS["mlp"][2][0]
    ref = _port_mlp()
    net = ref.clone()
    ref.fit(DataSet(x, y))
    pw = ParallelWrapper(net, partition_rules=[
        (r"W$", P(None, "model")), (".*", P())], prefetch_buffer=0)
    pw.fit(DataSet(x, y))
    assert ranks.digest((net.params, net.opt_state)) == ranks.digest(
        (ref.params, ref.opt_state))
