"""Pipeline parallelism in the port against the JAX package's
``parallel/pipeline.py``.

The reference side is the JAX package on ``_stage_mesh(n)`` (the
conftest's fake CPU devices on the stage axis; ``(stage, data)`` for the
grid), fed each global batch in one process. The port side is gloo ranks
(``parallel.launch.spawn``: one 2-rank and one 4-rank process group a
module, running every scenario of ``tests/torch_pipeline_ranks.py``), each
fed the same global batches. Both start from the JAX network's params and
the same seeded numpy batches.

Tolerances: the functional API rtol 1e-5 / atol 1e-6 (forward) and 1e-4
/ 1e-5 (one SGD step); the wrappers' params and BN state rtol 1e-4 / atol
1e-5 and losses rtol 1e-5 against JAX GPipe (the transformer graph's
params rtol 2e-4 / atol 2e-5, as the JAX package's own test holds them);
1F1B against the port's GPipe rtol 1e-5 / atol 1e-6. Dropout cannot match
``jax.random``'s masks, so the runs against the JAX package have it off;
with it on, GPipe and 1F1B are held against the port's own serial
microbatched step at rtol 1e-5. The JAX package's 1F1B does not run under
jax 0.9 (its own 1F1B tests are red there), so the port's 1F1B is held
against JAX GPipe and against the port's GPipe.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu import telemetry as jtelemetry
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import GradientNormalization as JGN
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JCM
from deeplearning4j_tpu.conf.layers_moe import MoELayer as JMoE
from deeplearning4j_tpu.conf.layers_rnn import LSTM as JLSTM
from deeplearning4j_tpu.conf.layers_rnn import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBPT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.regularization import L1Regularization as JL1
from deeplearning4j_tpu.conf.regularization import L2Regularization as JL2
from deeplearning4j_tpu.conf.regularization import WeightDecay as JWD
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import mesh as jmesh_mod
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu.util import serializer as jserializer
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, spawn
from deeplearning4j_tpu_torch.parallel import pipeline as ppipe
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, _axis_slices
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.util import serializer

from tests import torch_pipeline_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SPAWN_TIMEOUT = 240.0
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
GRAPH_TOL = dict(rtol=2e-4, atol=2e-5)
SCHED_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
STAGE = jpipe.STAGE_AXIS
D = 16


# --------------------------------------------------------------------------
# networks and data (the JAX side builds them; the port loads the JSON)
# --------------------------------------------------------------------------

def _bn_net(seed=7, dropout=0.0):
    """A conv net with BN running statistics and (optionally) dropout:
    ``tests/test_pipeline_v2.py``'s ``_bn_dropout_conv_net``."""
    return (JNNC.builder().seed(seed).updater(JSgd(learning_rate=0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JConv(n_out=8, kernel_size=(3, 3), stride=(1, 1),
                         convolution_mode=JCM.SAME,
                         activation=JAct.IDENTITY))
            .layer(JBN())
            .layer(JDense(n_out=16, activation=JAct.TANH, dropout=dropout))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(8, 8, 3))
            .build())


def _reg_net(seed=13):
    """L1 + L2, weight decay, a per-layer Nesterovs, CLIP_L2_PER_LAYER
    and an L2 head: ``_reg_mixed_updater_net``."""
    return (JNNC.builder().seed(seed).updater(JAdam(learning_rate=0.01))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=14, activation=JAct.TANH,
                          regularization=(JL2(l2=1e-2), JL1(l1=1e-3))))
            .layer(JDense(n_out=10, activation=JAct.TANH,
                          regularization=(JWD(coeff=1e-2),),
                          updater=JNesterovs(learning_rate=0.05,
                                             momentum=0.9)))
            .layer(JDense(n_out=12, activation=JAct.TANH,
                          gradient_normalization=JGN.CLIP_L2_PER_LAYER,
                          gradient_normalization_threshold=0.5))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT(),
                        regularization=(JL2(l2=1e-2),)))
            .set_input_type(JIT.feed_forward(16))
            .build())


def _mlp(seed=5, updater=None, widths=(24, 10, 18, 12)):
    b = (JNNC.builder().seed(seed)
         .updater(updater or JSgd(learning_rate=0.1))
         .weight_init(JWI.XAVIER).list())
    for w in widths:
        b = b.layer(JDense(n_out=w, activation=JAct.TANH))
    return (b.layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(16)).build())


def _transformer(seed=21, n_layers=2):
    return JTransformer(num_classes=3, embed_dim=16, n_heads=2,
                        n_layers=n_layers, max_len=12, seed=seed,
                        updater=JSgd(learning_rate=0.05)).conf()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _onehot(rng, n, classes=3):
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def _images(seed, n=12, steps=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
             _onehot(rng, n)) for _ in range(steps)]


def _rows(seed, n, steps=2, shape=(16,)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n,) + shape).astype(np.float32),
             _onehot(rng, n)) for _ in range(steps)]


# name -> (conf builder, kind, batches, n_micro, (data, pipeline), extra)
NETS = {
    "bn_gpipe": (_bn_net, "mln", _images(0), 3, (1, 2), {}),
    "bn_1f1b": (_bn_net, "mln", _images(0), 3, (1, 2),
                {"schedule": "1f1b"}),
    "bn_drop_gpipe": (functools.partial(_bn_net, dropout=0.5), "mln",
                      _images(3), 3, (1, 2), {"oracle": True}),
    "bn_drop_1f1b": (functools.partial(_bn_net, dropout=0.5), "mln",
                     _images(3), 3, (1, 2),
                     {"oracle": True, "schedule": "1f1b"}),
    "reg_gpipe": (_reg_net, "mln", _rows(5, 8), 4, (1, 2), {}),
    "reg_1f1b": (_reg_net, "mln", _rows(5, 8), 4, (1, 2),
                 {"schedule": "1f1b"}),
    "tf_gpipe": (_transformer, "graph", _rows(8, 8, 1, (12, 16)), 2, (1, 2),
                 {}),
    "tf_1f1b": (_transformer, "graph", _rows(8, 8, 1, (12, 16)), 2, (1, 2),
                {"schedule": "1f1b"}),
    "deep_gpipe": (functools.partial(_mlp, seed=19,
                                     widths=(24, 20, 18, 12)), "mln",
                   _rows(2, 16, 1), 4, (1, 2), {}),
    "deep_1f1b": (functools.partial(_mlp, seed=19,
                                    widths=(24, 20, 18, 12)), "mln",
                  _rows(2, 16, 1), 4, (1, 2), {"schedule": "1f1b"}),
    "mlp_zip": (_mlp, "mln", _rows(6, 8), 2, (1, 2), {"zip": True}),
    "mlp_health": (_mlp, "mln", _rows(7, 8, 3), 2, (1, 2), {"plant": 1}),
    "mlp_telemetry": (_mlp, "mln", _rows(9, 8, 1), 2, (1, 2),
                      {"telemetry": True}),
    # four ranks
    "dp_mlp": (functools.partial(_mlp, updater=JAdam(learning_rate=0.01)),
               "mln", _rows(4, 16), 2, (2, 2), {}),
    "dp_bn": (_bn_net, "mln", _images(11), 3, (2, 2), {}),
    "tf4_gpipe": (_transformer, "graph", _rows(10, 8, 1, (12, 16)), 2,
                  (1, 4), {}),
    "deep4_gpipe": (functools.partial(_mlp, seed=19,
                                      widths=(24, 20, 18, 12)), "mln",
                    _rows(12, 32, 1), 8, (1, 4), {}),
    "deep4_1f1b": (functools.partial(_mlp, seed=19,
                                     widths=(24, 20, 18, 12)), "mln",
                   _rows(12, 32, 1), 8, (1, 4), {"schedule": "1f1b"}),
}
TWO = [n for n, v in NETS.items() if v[4] == (1, 2)]
FOUR = [n for n, v in NETS.items() if v[4] != (1, 2)]


@functools.lru_cache(maxsize=None)
def _jax_init(builder, kind):
    conf = builder()
    return conf, (JCG(conf) if kind == "graph" else JMLN(conf)).init()


def _jax_net(name):
    """The scenario's JAX configuration and initialized network (one
    init a configuration: scenarios share them)."""
    builder, kind = NETS[name][:2]
    return _jax_init(builder, kind)


def _spec(name):
    conf, net = _jax_net(name)
    _, kind, batches, n_micro, grid, extra = NETS[name]
    return {"name": name, "fn": "train", "kind": kind,
            "conf_json": conf.to_json(), "params": _np(net.params),
            "state": _np(net.state), "batches": batches, "n_micro": n_micro,
            "grid": grid, **extra}


def _stage_mesh(n):
    return JMesh(np.array(jax.devices()[:n]), (STAGE,))


def _jax_mesh(grid):
    data, pipe = grid
    if data == 1:
        return _stage_mesh(pipe)
    devs = np.array(jax.devices()[:data * pipe]).reshape(pipe, data)
    return JMesh(devs, (STAGE, jmesh_mod.DATA_AXIS))


@functools.lru_cache(maxsize=None)
def _jax_gpipe(name):
    """The JAX wrapper (GPipe) on the scenario's batches: losses, trees
    after ``write_back``, its plan."""
    _, kind, batches, n_micro, grid, _ = NETS[name]
    conf, init = _jax_net(name)
    net = JCG(conf) if kind == "graph" else JMLN(conf)
    net.params = jax.tree_util.tree_map(lambda a: np.asarray(a).copy(),
                                        dict(init.params))
    net.state = jax.tree_util.tree_map(lambda a: np.asarray(a).copy(),
                                       dict(init.state))
    pw = jpipe.PipelineParallelWrapper(net, n_micro=n_micro,
                                       mesh=_jax_mesh(grid))
    losses = [pw.fit_batch(JDataSet(x, y)) for x, y in batches]
    pw.write_back()
    return {"losses": losses, "params": _np(net.params),
            "state": _np(net.state),
            "stage_keys": [list(k) for k in pw.stage_keys],
            "crossings": [list(c) for c in getattr(pw, "_crossings", [])]}


def _functional_spec(world):
    rng = np.random.default_rng(world)
    stages = [{"w": (0.5 * rng.normal(size=(D, D))).astype(np.float32),
               "b": (0.1 * rng.normal(size=(D,))).astype(np.float32)}
              for _ in range(world)]
    xs = {m: rng.normal(size=(m, 4, D)).astype(np.float32)
          for m in (1, 3, 4)}
    train = (rng.normal(size=(4, 4, D)).astype(np.float32),
             np.tanh(rng.normal(size=(4, 4, D))).astype(np.float32))
    dims = [8, 12, 6, 10, 7][:world + 1]
    hetero = [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(
        np.float32), "b": (0.1 * rng.normal(size=(b,))).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])]
    hx = rng.normal(size=(3, 5, dims[0])).astype(np.float32)
    ht = np.tanh(rng.normal(size=(3, 5, dims[-1]))).astype(np.float32)
    return {"name": f"func{world}", "fn": "functional", "stages": stages,
            "xs": xs, "train": train, "hetero": hetero,
            "hetero_xy": (hx, ht)}


@pytest.fixture(scope="module")
def _spawned(tmp_path_factory):
    """Both process groups, started together in the background; while
    their ranks train, this process runs the JAX references (the cache
    the tests read)."""
    tmp = str(tmp_path_factory.mktemp("pipe"))
    jobs = {2: [_spec(n) for n in TWO] + [
                _functional_spec(2),
                {"name": "grid12", "fn": "grid", "grid": (1, 2)}],
            4: [_spec(n) for n in FOUR] + [
                _functional_spec(4),
                {"name": "grid22", "fn": "grid", "grid": (2, 2)}]}
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {w: pool.submit(spawn, ranks.run_scenarios, w, (specs, tmp),
                              backend="gloo", device="cpu",
                              timeout=SPAWN_TIMEOUT)
               for w, specs in jobs.items()}
    try:
        for name in dict.fromkeys(_jax_name(n) for n in PARITY + ["mlp_zip"]):
            _jax_gpipe(name)
        yield futures
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port2(_spawned):
    """Every 2-rank scenario in one process group: per rank {name:
    result}."""
    return _spawned[2].result()


@pytest.fixture(scope="module")
def port4(_spawned):
    return _spawned[4].result()


def _results(port2, port4, name):
    return port2 if name in TWO else port4


def _assert_tree(got, want, tol, msg=""):
    for k in want:
        for p in want[k]:
            np.testing.assert_allclose(np.asarray(got[k][p]),
                                       np.asarray(want[k][p]), **tol,
                                       err_msg=f"{msg}{k}/{p}")


# --------------------------------------------------------------------------
# the functional API
# --------------------------------------------------------------------------

def _jax_stage_fn(params, x):
    return jax.numpy.tanh(x @ params["w"] + params["b"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n_micro", [1, 3, 4])
def test_pipeline_spmd_fn_matches_jax(port2, port4, world, n_micro):
    """Every rank gets the last stage's outputs, equal to the JAX GPipe
    forward's and to the serial stages'."""
    res = port2 if world == 2 else port4
    spec = _functional_spec(world)
    mesh = _stage_mesh(world)
    stacked = jpipe.stack_stage_params(spec["stages"], mesh)
    x = spec["xs"][n_micro]
    want = np.asarray(jpipe.pipeline_spmd_fn(_jax_stage_fn, world, n_micro,
                                             mesh)(stacked, x))
    serial = np.stack([np.asarray(jpipe.serial_reference(
        _jax_stage_fn, spec["stages"], x[m])) for m in range(n_micro)])
    for r in range(world):
        got = res[r][f"func{world}"]["fwd"][n_micro]
        np.testing.assert_allclose(got, want, **FWD_TOL)
        np.testing.assert_allclose(got, serial, **FWD_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_train_step_matches_jax(port2, port4, world):
    """One stage-local SGD step: each rank's new stage params and the loss
    (on every rank) equal the JAX step's."""
    res = port2 if world == 2 else port4
    spec = _functional_spec(world)
    mesh = _stage_mesh(world)
    x, y = spec["train"]
    step = jpipe.pipeline_train_step(
        _jax_stage_fn, lambda o, t: jax.numpy.mean((o - t) ** 2), world,
        x.shape[0], mesh, lr=0.1)
    new, loss = step(jpipe.stack_stage_params(spec["stages"], mesh), x, y)
    for r in range(world):
        got, got_loss = res[r][f"func{world}"]["train"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_RTOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(new[k][r]),
                                       **STEP_TOL, err_msg=f"stage {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_hetero_pipeline_matches_jax_and_serial(port2, port4, world):
    """Heterogeneous widths: shapes inferred as the JAX pipeline infers
    them, the forward and one SGD step against the JAX HeteroPipeline and
    the serial reference; every rank ends with every stage's params."""
    res = port2 if world == 2 else port4
    spec = _functional_spec(world)
    mesh = _stage_mesh(world)
    hp = spec["hetero"]
    hx, ht = spec["hetero_xy"]
    fns = [_jax_stage_fn] * world
    pipe = jpipe.HeteroPipeline(
        fns, hp, jax.ShapeDtypeStruct(hx.shape[1:], np.float32), mesh,
        hx.shape[0])
    stacked = pipe.stack_params(hp)
    want = np.asarray(pipe.spmd_fn()(stacked, hx))
    serial = np.stack([np.asarray(jpipe.hetero_serial_reference(
        fns, hp, hx[m])) for m in range(hx.shape[0])])
    st1, loss = pipe.train_step(
        lambda o, t: jax.numpy.mean((o - t) ** 2), lr=0.1)(stacked, hx, ht)
    want_ps = pipe.unstack_params(np.asarray(st1))
    for r in range(world):
        got = res[r][f"func{world}"]
        assert [tuple(s) for s in got["hetero_shapes"][0]] == \
            [tuple(s) for s in pipe.in_shapes]
        assert tuple(got["hetero_shapes"][1]) == tuple(pipe.out_shape)
        np.testing.assert_allclose(got["hetero_fwd"], want, **FWD_TOL)
        np.testing.assert_allclose(got["hetero_fwd"], serial, **FWD_TOL)
        ps, got_loss = got["hetero_train"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_RTOL)
        for s in range(world):
            for k in ("w", "b"):
                np.testing.assert_allclose(ps[s][k], np.asarray(
                    want_ps[s][k]), **STEP_TOL, err_msg=f"stage {s} {k}")


# --------------------------------------------------------------------------
# the wrapper against JAX GPipe
# --------------------------------------------------------------------------

PARITY = ["bn_gpipe", "bn_1f1b", "reg_gpipe", "reg_1f1b", "tf_gpipe",
          "tf_1f1b", "deep_gpipe", "deep_1f1b", "dp_mlp", "dp_bn",
          "tf4_gpipe", "deep4_gpipe", "deep4_1f1b"]


def _jax_name(name):
    """The JAX GPipe run a port scenario is held against (the JAX
    package's 1F1B does not run here)."""
    return name.replace("_1f1b", "_gpipe")


@pytest.mark.parametrize("name", PARITY)
def test_wrapper_matches_jax_gpipe(port2, port4, name):
    """Losses, params and BN state after every step against the JAX
    wrapper's GPipe run (dropout off), on every rank after
    ``write_back``."""
    res = _results(port2, port4, name)
    want = _jax_gpipe(_jax_name(name))
    tol = GRAPH_TOL if NETS[name][1] == "graph" else STEP_TOL
    for r in range(len(res)):
        got = res[r][name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        _assert_tree(got["trees"]["params"], want["params"], tol,
                     f"{name} rank {r}: ")
        _assert_tree(got["trees"]["state"], want["state"], tol,
                     f"{name} rank {r} state: ")
        assert got["iteration"] == len(NETS[name][2])


@pytest.mark.parametrize("name", ["bn_gpipe", "reg_gpipe", "tf_gpipe",
                                  "tf4_gpipe", "deep4_gpipe", "dp_bn"])
def test_the_plan_equals_the_jax_wrappers(port2, port4, name):
    """``stage_keys`` (balanced by parameter count, none empty) and each
    boundary's crossing names equal the JAX wrapper's."""
    res = _results(port2, port4, name)
    want = _jax_gpipe(name)
    for r in range(len(res)):
        assert res[r][name]["stage_keys"] == want["stage_keys"]
        if NETS[name][1] == "graph":
            assert res[r][name]["crossings"] == want["crossings"]
    if name == "tf_gpipe":  # a residual widens the boundary
        assert len(want["crossings"][1]) == 2


@pytest.mark.parametrize("name", ["bn_1f1b", "reg_1f1b", "tf_1f1b",
                                  "deep_1f1b", "deep4_1f1b"])
def test_1f1b_matches_the_ports_gpipe(port2, port4, name):
    res = _results(port2, port4, name)
    gp = name.replace("_1f1b", "_gpipe")
    for r in range(len(res)):
        a, b = res[r][name], res[r][gp]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=LOSS_RTOL)
        _assert_tree(a["trees"]["params"], b["trees"]["params"], SCHED_TOL,
                     f"{name} rank {r}: ")
        _assert_tree(a["trees"]["state"], b["trees"]["state"], SCHED_TOL,
                     f"{name} rank {r} state: ")


@pytest.mark.parametrize("name", ["deep_1f1b", "deep4_1f1b", "reg_1f1b"])
def test_1f1b_in_flight_stays_within_s_minus_s(port2, port4, name):
    """1F1B keeps at most ``S - s`` microbatches' graphs alive on stage
    ``s``; GPipe keeps all ``M``."""
    res = _results(port2, port4, name)
    S = NETS[name][4][1]
    M = NETS[name][3]
    for r in range(len(res)):
        got = res[r][name]
        for step in got["steps"]:
            assert 1 <= step["max_in_flight"] <= S - got["stage"], \
                (r, step)
        gp = res[r][name.replace("_1f1b", "_gpipe")]
        assert all(st["max_in_flight"] == M for st in gp["steps"])


@pytest.mark.parametrize("name", ["bn_drop_gpipe", "bn_drop_1f1b"])
def test_dropout_on_matches_the_serial_microbatched_step(port2, name):
    """With dropout on, each layer's masks come from (seed, iteration,
    microbatch, layer): the pipelined step equals the port's serial
    microbatched step, params, BN state and losses, over two steps."""
    for r in range(2):
        got = port2[r][name]
        np.testing.assert_allclose(got["losses"], got["oracle_losses"],
                                   rtol=LOSS_RTOL)
        _assert_tree(got["trees"]["params"], got["oracle_trees"]["params"],
                     dict(rtol=1e-5, atol=1e-6), f"rank {r}: ")
        _assert_tree(got["trees"]["state"], got["oracle_trees"]["state"],
                     dict(rtol=1e-5, atol=1e-6), f"rank {r} state: ")
    # the masks are drawn: dropout moved the result off the dropout-free
    # run of the same net and batches
    assert not np.allclose(port2[0][name]["losses"],
                           port2[0]["bn_gpipe"]["losses"])


def test_hand_offs_are_counted(port2):
    """Stage 0 sends its M activations (and, once, their header), stage 1
    its M input gradients; bytes as the tensors' and the step's wall time
    in them recorded."""
    M = NETS["bn_gpipe"][3]
    s0 = port2[0]["bn_gpipe"]["steps"]
    s1 = port2[1]["bn_gpipe"]["steps"]
    assert [st["sends"] for st in s0] == [M + 1, M]
    assert [st["sends"] for st in s1] == [M, M]
    assert [st["recvs"] for st in s1] == [M + 1, M]
    # stage 0 -> 1 carries the conv+BN output [4, 8, 8, 8] float32 back
    act = 4 * 8 * 8 * 8 * 4
    assert s0[1]["bytes_sent"] == M * act
    assert s1[1]["bytes_sent"] == M * act
    assert all(st["handoff_ms"] >= 0.0 for st in s0 + s1)


# --------------------------------------------------------------------------
# the grid, telemetry, health, the zip
# --------------------------------------------------------------------------

def test_the_grid_orders_ranks_as_the_jax_device_mesh():
    jm = jmesh_mod.MeshConfig(data=1, model=2, pipeline=2,
                              sequence=2).build()
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    mesh = Mesh(data=1, data_rank=0, model=2, sequence=2, pipeline=2)
    for m in range(2):
        for p in range(2):
            for s in range(2):
                r = mesh.rank_at(0, m, s, p)
                assert r == ids[0, m, p, s, 0]
                assert mesh.coords(r) == {"data": 0, "model": m,
                                          "pipeline": p, "sequence": s}
    jm = jmesh_mod.MeshConfig(data=2, pipeline=4).build()
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    mesh = Mesh(data=2, data_rank=0, pipeline=4)
    assert [[mesh.rank_at(d, pipeline=p) for p in range(4)]
            for d in range(2)] == ids[:, 0, :, 0, 0].tolist()
    assert mesh.shape == {"data": 2, "model": 1, "pipeline": 4,
                          "sequence": 1, "expert": 1}
    slices = _axis_slices(2, 1, 1, 4)
    assert slices["pipeline"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert slices["data"] == [[0, 4], [1, 5], [2, 6], [3, 7]]


@pytest.mark.parametrize("grid", ["grid12", "grid22"])
def test_the_grid_builds_a_pipeline_subgroup_a_slice(port2, port4, grid):
    res = port2 if grid == "grid12" else port4
    P = 2
    for rank in range(len(res)):
        g = res[rank][grid]
        d, p = divmod(rank, P)
        assert g["stage"] == p and g["data_rank"] == d
        assert g["prev"] == (rank - 1 if p > 0 else None)
        assert g["next"] == (rank + 1 if p < P - 1 else None)
        assert g["pipeline_members"] == [d * P + i for i in range(P)]


def test_pipeline_gauges_match_the_jax_package(port2):
    jtelemetry.reset()
    jtelemetry.enable()
    try:
        jtelemetry.record_pipeline_schedule(2, 2, "gpipe")
        want = {k: v for k, v in jtelemetry.REGISTRY.snapshot().items()
                if k.startswith("dl4j_pipeline_")}
    finally:
        jtelemetry.disable()
        jtelemetry.reset()
    for r in range(2):
        got = port2[r]["mlp_telemetry"]["gauges"]
        assert {k: v for k, v in got.items()
                if k.startswith("dl4j_pipeline_")} == want
        assert got['dl4j_training_steps_total{path="pipeline"}'] == 1.0
    assert want['dl4j_pipeline_bubble_fraction{schedule="gpipe"}'] == \
        pytest.approx(1 / 3)


def test_the_loss_only_guard_counts_a_planted_nan(port2):
    """A NaN in the second of three batches' features: every rank's
    monitor sees it (the loss reaches every rank); nothing is skipped, so
    WARN applies the poisoned update and the third step is non-finite
    too: two non-finite steps, none skipped."""
    for r in range(2):
        got = port2[r]["mlp_health"]
        assert got["health"] == {"nonfinite": 2, "skipped": 0}
        assert np.isfinite(got["losses"][0])
        assert np.isnan(got["losses"][1]) and np.isnan(got["losses"][2])


def test_a_zip_after_a_pipeline_fit_restores_in_both_packages(port2):
    got = port2[0]["mlp_zip"]
    path = got["zip"]
    jnet = jserializer.restore_multi_layer_network(path)
    _assert_tree(_np(jnet.params), got["trees"]["params"],
                 dict(rtol=0, atol=0), "jax restore: ")
    pnet = serializer.restore_multi_layer_network(path, device="cpu")
    _assert_tree(ranks.trees(pnet)["params"], got["trees"]["params"],
                 dict(rtol=0, atol=0), "port restore: ")
    # both ranks hold the same trees after write_back, and the JAX GPipe
    # run's
    _assert_tree(port2[1]["mlp_zip"]["trees"]["params"],
                 got["trees"]["params"], dict(rtol=0, atol=0))
    _assert_tree(got["trees"]["params"], _jax_gpipe("mlp_zip")["params"],
                 STEP_TOL)
    assert pnet.iteration == 2 and jnet.iteration == 2


# --------------------------------------------------------------------------
# 1F1B's tables, the refusals (one process: plan-only meshes)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_1f1b_tables_equal_the_jax_packages(S):
    for M in range(1, 9):
        got = ppipe._one_f1b_tables(S, M)
        want = jpipe._one_f1b_tables(S, M)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def _port(conf, kind="mln"):
    if kind == "graph":
        return ComputationGraph(ComputationGraphConfiguration.from_json(
            conf.to_json()), device="cpu").init()
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def _plan_mesh(pipeline, **kw):
    return Mesh(data=kw.pop("data", 1), data_rank=0, pipeline=pipeline, **kw)


def _rnn_conf(**kw):
    return (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.1))
            .weight_init(JWI.XAVIER).list())


def _refusal_cases():
    tbptt = (_rnn_conf().layer(JLSTM(n_out=8))
             .layer(JRnnOut(n_out=2, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
             .backprop_type(JBPT.TRUNCATED_BPTT, fwd=4, back=4)
             .set_input_type(JIT.recurrent(4, timesteps=8)).build())
    moe = (_rnn_conf().layer(JMoE(n_experts=2, d_hidden=8))
           .layer(JRnnOut(n_out=2, activation=JAct.SOFTMAX,
                          loss_fn=JMCXENT()))
           .set_input_type(JIT.recurrent(8, timesteps=4)).build())

    def graph(outputs, head_inputs=("h",), head=JOut):
        g = (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.1))
             .weight_init(JWI.XAVIER).graph_builder().add_inputs("in")
             .set_input_types(JIT.feed_forward(8)))
        g.add_layer("h", JDense(n_out=8, activation=JAct.TANH), "in")
        g.add_layer("h2", JDense(n_out=8, activation=JAct.TANH), "in")
        for o in outputs:
            g.add_layer(o, head(n_out=2, activation=JAct.SOFTMAX,
                                loss_fn=JMCXENT())
                        if head is JOut else head(n_out=2), *head_inputs)
        g.set_outputs(*outputs)
        return g.build()

    return {
        "tbptt": (lambda: _port(tbptt), {}, ValueError, "tBPTT"),
        "compute_dtype": (lambda: _port(dataclasses.replace(
            _mlp(), compute_dtype="bfloat16")), {}, ValueError,
            "compute_dtype"),
        "moe_aux": (lambda: _port(moe), {}, ValueError, "auxiliary losses"),
        "multi_output": (lambda: _port(graph(("o1", "o2")), "graph"), {},
                         ValueError, "single-output"),
        "not_an_output_layer": (lambda: _port(graph(
            ("o",), head=JDense), "graph"), {}, ValueError,
            "not an output layer"),
        "multi_input_head": (lambda: _port(graph(("o",), ("h", "h2")),
                                           "graph"), {},
                             ValueError, "single-input output vertex"),
        "no_loss_head": (lambda: _port(
            _mlp_no_head()), {}, ValueError, "loss head"),
        "schedule": (lambda: _port(_mlp()), {"schedule": "zb"},
                     ValueError, "unknown schedule"),
        "stage_count": (lambda: _port(_mlp()),
                        {"mesh": _plan_mesh(2), "n_stages": 4},
                        ValueError, "mesh stage axis = 2 but n_stages = 4"),
        "too_many_stages": (lambda: _port(_mlp()), {"mesh": _plan_mesh(6)},
                            ValueError, "stage-able layers < 6 stages"),
        "missing_axis": (lambda: _port(_mlp()),
                         {"mesh": _NoPipelineAxis()}, ValueError,
                         "mesh needs a 'pipeline' axis"),
        "model_axis": (lambda: _port(_mlp()),
                       {"mesh": _plan_mesh(2, model=2)},
                       NotImplementedError, "data axis only"),
        "sequence_axis": (lambda: _port(_mlp()),
                          {"mesh": _plan_mesh(2, sequence=2)},
                          NotImplementedError, "data axis only"),
        "not_a_network": (lambda: object(), {}, TypeError,
                          "MultiLayerNetwork or ComputationGraph"),
    }


class _NoPipelineAxis:
    shape = {"data": 1}


def _mlp_no_head():
    return (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.1))
            .list().layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JDense(n_out=3, activation=JAct.TANH))
            .set_input_type(JIT.feed_forward(16)).build())


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_every_jax_refusal_is_reproduced(case):
    make, kw, exc, match = _refusal_cases()[case]
    kw = dict(kw)
    kw.setdefault("mesh", _plan_mesh(2))
    with pytest.raises(exc, match=match):
        ppipe.PipelineParallelWrapper(make(), n_micro=2, **kw)


def test_the_jax_refusal_messages_hold_in_the_jax_package_too():
    """The refusals the port reproduces are the JAX wrapper's: the same
    cases raise the same messages there."""
    tbptt = (_rnn_conf().layer(JLSTM(n_out=8))
             .layer(JRnnOut(n_out=2, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
             .backprop_type(JBPT.TRUNCATED_BPTT, fwd=4, back=4)
             .set_input_type(JIT.recurrent(4, timesteps=8)).build())
    with pytest.raises(ValueError, match="tBPTT"):
        jpipe.PipelineParallelWrapper(JMLN(tbptt).init(), n_micro=2,
                                      mesh=_stage_mesh(2))
    with pytest.raises(ValueError, match="stage-able layers < 6 stages"):
        jpipe.PipelineParallelWrapper(JMLN(_mlp()).init(), n_micro=2,
                                      mesh=_stage_mesh(6))
    with pytest.raises(ValueError,
                       match="mesh stage axis = 2 but n_stages = 4"):
        jpipe.PipelineParallelWrapper(JMLN(_mlp()).init(), n_micro=2,
                                      mesh=_stage_mesh(2), n_stages=4)


def _mlp_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, 16)).astype(np.float32),
                   _onehot(rng, n))


@pytest.mark.parametrize("mask", ["labels_mask", "features_mask"])
def test_masked_datasets_are_refused(mask):
    pw = ppipe.PipelineParallelWrapper(_port(_mlp()), n_micro=2,
                                       mesh=_plan_mesh(2))
    ds = _mlp_batch(8)
    setattr(ds, mask, np.ones((8,), np.float32))
    with pytest.raises(ValueError, match="masked DataSets"):
        pw.fit_batch(ds)


def test_a_batch_that_does_not_split_is_refused():
    pw = ppipe.PipelineParallelWrapper(_port(_mlp()), n_micro=3,
                                       mesh=_plan_mesh(2, data=2))
    with pytest.raises(ValueError, match="must divide into n_micro x "
                                         "data_axis = 3 x 2"):
        pw.fit_batch(_mlp_batch(8))


def test_a_shrunk_batch_is_refused():
    """One process, one stage: the first batch builds the stages, a later
    one of another microbatch shape is refused."""
    pw = ppipe.PipelineParallelWrapper(_port(_mlp()), n_micro=2)
    assert pw.n_stages == 1
    pw.fit_batch(_mlp_batch(8))
    with pytest.raises(ValueError, match="compiled for microbatch"):
        pw.fit_batch(_mlp_batch(2))


def test_the_partition_is_never_empty():
    conf = (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=4, activation=JAct.TANH))
            .layer(JDense(n_out=4, activation=JAct.TANH))
            .layer(JDense(n_out=256, activation=JAct.TANH))
            .layer(JOut(n_out=2, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())
    pw = ppipe.PipelineParallelWrapper(_port(conf), n_micro=2,
                                       mesh=_plan_mesh(3))
    jw = jpipe.PipelineParallelWrapper(JMLN(conf).init(), n_micro=2,
                                       mesh=_stage_mesh(3))
    assert all(pw.stage_layers), pw.stage_layers
    assert pw.stage_layers == [list(s) for s in jw.stage_layers] \
        == [[0], [1], [2]]


def test_one_stage_trains_as_fit_batch():
    """A one-stage pipeline of one microbatch is ``fit_batch``: the same
    loss and params (Adam, two steps)."""
    conf = _mlp(updater=JAdam(learning_rate=0.01))
    ref = _port(conf)
    net = _port(conf)
    net.set_params(ref.params, ref.state)
    pw = ppipe.PipelineParallelWrapper(net, n_micro=1)
    for seed in (0, 1):
        ds = _mlp_batch(8, seed)
        np.testing.assert_allclose(pw.fit_batch(ds), ref.fit_batch(ds),
                                   rtol=1e-6)
    pw.write_back()
    for k in ref.params:
        for p in ref.params[k]:
            np.testing.assert_allclose(net.params[k][p].numpy(),
                                       ref.params[k][p].numpy(),
                                       rtol=1e-6, atol=1e-7)
            for s in ref.opt_state[k][p]:
                np.testing.assert_allclose(
                    net.opt_state[k][p][s].numpy(),
                    ref.opt_state[k][p][s].numpy(), rtol=1e-6, atol=1e-8)


def test_health_rollback_hooks_restore_the_stage():
    pw = ppipe.PipelineParallelWrapper(_port(_mlp()), n_micro=2)
    pw.fit_batch(_mlp_batch(8))
    snap = pw._health_snapshot()
    before = {k: {p: v.clone() for p, v in vp.items()}
              for k, vp in pw.model.params.items()}
    pw.fit_batch(_mlp_batch(8, 1))
    pw._health_restore(snap)
    for k, vp in before.items():
        for p, v in vp.items():
            assert bool((pw.model.params[k][p] == v).all())
    assert pw.model.iteration == 1


def test_parallel_wrapper_refuses_a_pipeline_mesh():
    with pytest.raises(ValueError, match="PipelineParallelWrapper"):
        ParallelWrapper(_port(_mlp()), mesh=_plan_mesh(2))


def test_the_port_exports_the_jax_packages_names():
    from deeplearning4j_tpu_torch import parallel

    for name in ("pipeline_spmd_fn", "pipeline_train_step",
                 "stack_stage_params", "PipelineParallelWrapper"):
        assert callable(getattr(parallel, name))
    assert health.loss_guard is not None
