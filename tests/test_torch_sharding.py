"""The sharding subsystem in the port against the JAX package.

One process: the rule tables (``sharding/rules.py``), ``ShardingPlan``
(``sharding/plan.py``) and the zoo's tables (``zoo/rules.py``) resolve the
same specs, raise the same errors, explain the same rows, count the same
bytes and key the same ``cache_tag`` as the JAX package's on the same
trees and mesh shape (a port mesh built as ``Mesh(data=2, data_rank=0,
model=2)`` plans without ranks); a port network's params are matched in
the reference's layouts and placed on the port's; ``/sharding`` and the
System tab list the plans; the process grid orders its ranks as the JAX
package's device mesh orders its devices.

Two gloo ranks (one spawn, ``tests/torch_sharding_ranks.py``): the grid's
subgroups, ``reshard_training_state`` between a 1 x 2 plan and a 2 x 1
wrapper both ways bit for bit against the host route,
``publish_to_engine`` from a plan's live slices, a ``TrainingSession``
over a plan wrapper killed and resumed onto the other mesh shape, a pod
snapshot restored on the real pod to the bits one process restores, and
``recut_flat`` leaving each rank its slice of the re-cut vector.
"""

import json
import re
import urllib.request

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import mesh as jmesh_mod
from deeplearning4j_tpu.sharding import ShardingPlan as JPlan
from deeplearning4j_tpu.sharding import create_opt_spec as jcreate_opt_spec
from deeplearning4j_tpu.sharding import (
    match_partition_rules as jmatch_partition_rules,
)
from deeplearning4j_tpu.sharding.rules import (
    bytes_per_device as jbytes_per_device,
)
from deeplearning4j_tpu.zoo import rules as jzr
from deeplearning4j_tpu_torch.comms.reshard import (
    Placement,
    recut_flat,
    reshard,
    reshard_flat,
    reshard_training_state,
)
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    TrainingMode,
    spawn,
)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MeshConfig
from deeplearning4j_tpu_torch.sharding import (
    ShardingPlan,
    create_opt_spec,
    match_partition_rules,
    plans_summary,
)
from deeplearning4j_tpu_torch.sharding.rules import P, bytes_per_device
from deeplearning4j_tpu_torch.ui import UIServer, collect_system_metrics
from deeplearning4j_tpu_torch.util.convert import params_to_jax
from deeplearning4j_tpu_torch.zoo import rules as zr
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50, TransformerEncoder
from deeplearning4j_tpu_torch.zoo.models import LeNet

from tests import torch_sharding_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SPAWN_TIMEOUT = 240.0
_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(scope="module", autouse=True)
def _no_jax_executables_left():
    """This module leaves nothing in the JAX package's executable cache
    (bounded at 256 entries): the JAX tests that count its entries
    (``tests/test_fused.py``) may run after it in the same worker."""
    yield
    from deeplearning4j_tpu.optimize import aot_cache as jax_aot_cache

    jax_aot_cache.clear()


def _toy_params():
    return {"0": {"W": np.zeros((4, 16), np.float32),
                  "b": np.zeros((16,), np.float32)},
            "1": {"W": np.zeros((16, 3), np.float32),
                  "s": np.zeros((), np.float32)}}


def _strs(tree):
    """A spec tree's specs as strings (the packages print them alike)."""
    if isinstance(tree, dict):
        return {k: _strs(v) for k, v in tree.items()}
    return str(tree)


def _both(rules):
    return ([(pat, P(*spec)) for pat, spec in rules],
            [(pat, JP(*spec)) for pat, spec in rules])


# --------------------------------------------------------------------------
# rule tables
# --------------------------------------------------------------------------

def test_match_partition_rules_first_match_wins_and_scalars_skip():
    port, jx = _both([(r"0/W$", ("model",)), (r"W$", (None, "model")),
                      (r".*", ())])
    specs = match_partition_rules(port, _toy_params())
    assert _strs(specs) == _strs(jmatch_partition_rules(jx, _toy_params()))
    assert specs["0"]["W"] == P("model")          # first match wins
    assert specs["1"]["W"] == P(None, "model")
    assert specs["1"]["s"] == P()                 # the scalar replicates


def test_match_partition_rules_scalar_skips_without_catchall():
    port, jx = _both([(r"W$", (None, "model")), (r"b$", ())])
    specs = match_partition_rules(port, _toy_params())
    assert _strs(specs) == _strs(jmatch_partition_rules(jx, _toy_params()))
    assert specs["1"]["s"] == P()


def _error(fn, *args):
    with pytest.raises(ValueError) as exc:
        fn(*args)
    return str(exc.value)


def test_unmatched_param_raises_with_nearest_rule():
    port, jx = _both([(r"0/Wq$", ("model",))])
    tree = {"0": {"W": np.zeros((4, 4), np.float32)}}
    msg = _error(match_partition_rules, port, tree)
    assert msg == _error(jmatch_partition_rules, jx, tree)
    assert "no partition rule matches param '0/W'" in msg and "0/Wq" in msg


def test_rule_wider_than_rank_raises():
    port, jx = _both([(r"b$", (None, None, "model")), (r".*", ())])
    msg = _error(match_partition_rules, port, _toy_params())
    assert msg == _error(jmatch_partition_rules, jx, _toy_params())
    assert "rank" in msg


def test_create_opt_spec_clones_moments_replicates_scalars():
    port, jx = _both([(r"W$", (None, "model")), (r".*", ())])
    params = _toy_params()
    opt = {k: {pk: {"m": np.zeros_like(v), "v": np.zeros_like(v),
                    "t": np.zeros((), np.float32)}
               for pk, v in d.items()} for k, d in params.items()}
    got = create_opt_spec(match_partition_rules(port, params), opt)
    want = jcreate_opt_spec(jmatch_partition_rules(jx, params), opt)
    assert _strs(got) == _strs(want)
    assert got["0"]["W"]["m"] == P(None, "model")
    assert got["0"]["W"]["t"] == P()
    empty = {k: {pk: {} for pk in d} for k, d in params.items()}
    assert create_opt_spec(match_partition_rules(port, params),
                           empty)["0"]["W"] == {}


def _port_mesh(data, model):
    return Mesh(data=data, data_rank=0, model=model)


def test_plan_strict_raises_on_indivisible_and_demote_replicates():
    port, jx = _both([(r"W$", (None, "model")), (r".*", ())])
    jm = jmesh_mod.single_host_mesh(data=4, model=2)
    strict = ShardingPlan(port, mesh=_port_mesh(4, 2))
    msg = _error(strict.param_specs, _toy_params())
    assert msg == _error(JPlan(jx, mesh=jm).param_specs, _toy_params())
    assert "not divisible" in msg
    lax = ShardingPlan(port, mesh=_port_mesh(4, 2), demote_indivisible=True)
    jlax = JPlan(jx, mesh=jm, demote_indivisible=True)
    specs = lax.param_specs(_toy_params())
    assert _strs(specs) == _strs(jlax.param_specs(_toy_params()))
    assert specs["1"]["W"] == P(None, None)
    rows = {r["path"]: r for r in lax.explain(fmt="json")["params"]}
    assert rows["1/W"].get("demoted") is True


def test_plan_explain_and_cache_tag_equal_the_jax_plan():
    port, jx = _both([(r"W$", (None, "model")), (r".*", ())])
    params = _toy_params()
    opt = {k: {pk: {"m": np.zeros_like(v), "v": np.zeros_like(v)}
               for pk, v in d.items()} for k, d in params.items()}
    plan = ShardingPlan(port, mesh=_port_mesh(4, 2), demote_indivisible=True)
    jplan = JPlan(jx, mesh=jmesh_mod.single_host_mesh(data=4, model=2),
                  demote_indivisible=True)
    with pytest.raises(ValueError):
        plan.cache_tag()                          # unresolved
    plan.param_specs(params)
    jplan.param_specs(params)
    assert plan.cache_tag() == jplan.cache_tag()
    assert plan.explain() == jplan.explain()
    plan.opt_specs(params, opt)
    jplan.opt_specs(params, opt)
    got, want = plan.explain(fmt="json"), jplan.explain(fmt="json")
    assert got["params"] == want["params"]
    assert got["mesh"] == want["mesh"] == {"data": 4, "model": 2}

    def rows(t):
        return {(r["path"], tuple(r["shape"]), r["spec"])
                for r in t["opt_state"]}

    assert rows(got) == rows(want)
    assert plan.cache_tag() == jplan.cache_tag()
    other = ShardingPlan(port, mesh=_port_mesh(8, 1), demote_indivisible=True)
    other.param_specs(params)
    assert other.cache_tag() != plan.cache_tag()


def test_bytes_per_device_equal_the_jax_accounting():
    port, jx = _both([(r"W$", (None, "model")), (r".*", ())])
    params = {"0": {"W": np.zeros((4, 16), np.float32),
                    "b": np.zeros((15,), np.float32)}}
    got = bytes_per_device(params, match_partition_rules(port, params),
                           _port_mesh(4, 2))
    want = jbytes_per_device(params, jmatch_partition_rules(jx, params),
                             jmesh_mod.single_host_mesh(data=4, model=2))
    assert got == want == 4 * 16 * 4 // 2 + 15 * 4


# --------------------------------------------------------------------------
# the zoo's tables on port networks, in the reference's layouts
# --------------------------------------------------------------------------

def _zoo_net(name):
    if name == "resnet50":
        return ComputationGraph(ResNet50(num_classes=10, height=32,
                                         width=32).conf(), "cpu").init()
    if name == "lm":
        return ComputationGraph(TransformerEncoder(
            vocab_size=50, embed_dim=16, n_heads=2, n_layers=2, max_len=8,
            causal=True, lm_head=True).conf(), "cpu").init()
    if name == "lenet":
        return MultiLayerNetwork(LeNet(num_classes=10).conf(), "cpu").init()
    conf = MultiLayerConfiguration.from_json(
        (JNNC.builder().seed(1).updater(JAdam(learning_rate=0.1))
         .weight_init(JWI.XAVIER).list()
         .layer(JDense(n_out=16, activation=JAct.TANH))
         .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
         .set_input_type(JIT.feed_forward(4)).build()).to_json())
    return MultiLayerNetwork(conf, "cpu").init()


ZOO_TABLES = {"resnet50": "resnet_rules", "lm": "transformer_rules",
              "lenet": "lenet_rules", "mlp": "mlp_rules"}


@pytest.mark.parametrize("name", list(ZOO_TABLES))
def test_zoo_rule_tables_resolve_on_real_nets(name):
    """The port network's params, matched in the reference's layouts,
    resolve to the JAX package's specs for the same table and shapes (the
    JAX side resolves the port's params carried to its layouts)."""
    net = _zoo_net(name)
    table = ZOO_TABLES[name]
    plan = zr.plan_for(getattr(zr, table)(), mesh=_port_mesh(4, 2))
    jplan = jzr.plan_for(getattr(jzr, table)(),
                         mesh=jmesh_mod.single_host_mesh(data=4, model=2))
    jparams = params_to_jax(net.conf, net.params, net.state)[0]
    assert _strs(plan.param_specs(net)) == _strs(jplan.param_specs(jparams))
    assert plan.explain(fmt="json")["params"] == \
        jplan.explain(fmt="json")["params"]
    assert plan.cache_tag() == jplan.cache_tag()


def test_the_specs_land_on_the_port_layouts():
    """``P(None, "model")`` on a dense ``W`` (``[nIn, nOut]`` in the
    reference, ``[nOut, nIn]`` here) shards the port's dim 0; the output
    channels of a conv (HWIO there, OIHW here) its dim 0; a row-parallel
    ``Wo`` its dim 1; an embedding table keeps its layout."""
    lm = _zoo_net("lm")
    plan = zr.plan_for(zr.transformer_rules(), mesh=_port_mesh(1, 2))
    st = plan.storage_specs(lm)
    assert st["b0_attn"]["Wq"] == P("model")
    assert st["b0_attn"]["Wo"] == P(None, "model")
    assert st["b0_ff1"]["W"] == P("model")
    assert st["b0_ff2"]["W"] == P(None, "model")
    assert st["embed"]["W"] == P(None, "model")
    assert plan.opt_storage_specs(lm)["b0_ff2"]["W"]["m"] == P(None, "model")
    lenet = _zoo_net("lenet")
    st = zr.plan_for(zr.lenet_rules(), mesh=_port_mesh(1, 2)).storage_specs(
        lenet)
    assert st["0"]["W"] == P("model") and st["5"]["W"] == P("model")
    assert st["0"]["b"] == P()


def test_place_keeps_only_this_ranks_slice():
    lm = _zoo_net("lm")
    full = lm.params["b0_ff2"]["W"]
    for index in (0, 1):
        mesh = Mesh(data=1, data_rank=0, model=2, model_rank=index)
        plan = zr.plan_for(zr.transformer_rules(), mesh=mesh)
        local = plan.place(lm.params, plan.storage_specs(lm))
        n = full.shape[1] // 2
        assert local["b0_ff2"]["W"].shape == (full.shape[0], n)
        assert (local["b0_ff2"]["W"] == full[:, index * n:(index + 1) * n]
                ).all()
        assert local["b0_ln1"]["gain"] is lm.params["b0_ln1"]["gain"]


# --------------------------------------------------------------------------
# the process grid
# --------------------------------------------------------------------------

def test_the_grid_orders_ranks_as_the_jax_device_mesh():
    jm = jmesh_mod.MeshConfig(data=2, model=2, sequence=2).build()
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    mesh = Mesh(data=2, data_rank=0, model=2, sequence=2)
    for d in range(2):
        for m in range(2):
            for s in range(2):
                r = mesh.rank_at(d, m, s)
                assert r == ids[d, m, 0, s, 0]
                assert mesh.coords(r) == {"data": d, "model": m,
                                          "sequence": s}
    assert mesh.shape == {"data": 2, "model": 2, "pipeline": 1,
                          "sequence": 2, "expert": 1}


def test_only_the_pipeline_and_expert_axes_are_refused():
    # the pipeline axis is ported (parallel/pipeline.py): it builds as the
    # model and sequence axes do, and like them needs its ranks; only the
    # expert axis stays refused (experts ride the data axis)
    with pytest.raises(ValueError, match="1 ranks not divisible by "
                                         "model\\*pipeline\\*sequence=2"):
        MeshConfig(pipeline=2).build()
    assert Mesh(data=1, data_rank=0, pipeline=2).shape["pipeline"] == 2
    with pytest.raises(NotImplementedError, match="expert_parallel"):
        MeshConfig(expert=2).build()
    # a model axis needs its ranks: one process has one
    with pytest.raises(ValueError, match="1 ranks not divisible"):
        MeshConfig(model=2).build()
    with pytest.raises(ValueError, match="1 ranks not divisible"):
        MeshConfig(sequence=2).build()
    assert MeshConfig().build().shape["model"] == 1
    assert MeshConfig(pipeline=1).build().shape["pipeline"] == 1


# --------------------------------------------------------------------------
# the UI and the system metrics
# --------------------------------------------------------------------------

def test_sharding_endpoint_and_system_panel():
    plan = ShardingPlan([(r"W$", P(None, "model")), (".*", P())],
                        mesh=_port_mesh(4, 2), demote_indivisible=True)
    plan.param_specs(_toy_params())
    sysm = collect_system_metrics()
    assert any(p["mesh"] == {"data": 4, "model": 2}
               for p in sysm.get("sharding_plans", []))
    ui = UIServer()
    port = ui.start(port=0)
    try:
        with _NO_PROXY.open(f"http://127.0.0.1:{port}/sharding",
                            timeout=10) as r:
            assert r.status == 200
            plans = json.loads(r.read())
        assert any(p["mesh"] == {"data": 4, "model": 2} for p in plans)
        assert any(r_["path"] == "0/W" for p in plans
                   for r_ in p["params"])
        page = ui.render_html()
        assert "Sharding plans" in page
        assert re.search(r"0/W</td><td>4x16</td><td>PartitionSpec\(None, "
                         r"&#x27;model&#x27;\)", page)
    finally:
        ui.stop()
    assert plans_summary()


# --------------------------------------------------------------------------
# cross-mesh moves without ranks, and the refusals
# --------------------------------------------------------------------------

def test_reshard_and_recut_without_ranks_are_local_copies():
    import torch

    t = torch.arange(12.0).reshape(3, 4)
    out = reshard({"a": t}, Placement(_port_mesh(1, 2), P(None, "model")))
    assert torch.equal(out["a"], t) and out["a"] is not t
    flat = torch.arange(5.0)
    got = recut_flat(flat, 5, 8)
    assert torch.equal(got, torch.tensor([0., 1, 2, 3, 4, 0, 0, 0]))
    padded = torch.tensor([0., 1, 2, 3, 4, 0])      # 5 of 6, re-cut to 8
    assert torch.equal(reshard_flat(padded, 5, 8), got)


def test_reshard_training_state_refuses_non_exact_modes():
    src = ParallelWrapper(_zoo_net("mlp"), prefetch_buffer=0)
    with pytest.raises(ValueError, match="no staged"):
        reshard_training_state(
            src, ParallelWrapper(_zoo_net("mlp"), prefetch_buffer=0))
    src._setup()
    avg = ParallelWrapper(_zoo_net("mlp"), prefetch_buffer=0,
                          training_mode=TrainingMode.AVERAGING)
    with pytest.raises(ValueError, match="SHARED_GRADIENTS"):
        reshard_training_state(src, avg)


# --------------------------------------------------------------------------
# two ranks
# --------------------------------------------------------------------------

def _mlp_spec():
    conf = (JNNC.builder().seed(12345).updater(JAdam(learning_rate=0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=16, activation=JAct.TANH))
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=4, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(6)).build())
    net = JMLN(conf).init()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        x = rng.normal(size=(8, 6)).astype(np.float32)
        batches.append((x, np.eye(4, dtype=np.float32)[
            rng.integers(0, 4, 8)]))
    return {"kind": "mln", "conf_json": conf.to_json(),
            "params": jax.tree_util.tree_map(np.asarray, net.params),
            "state": jax.tree_util.tree_map(np.asarray, net.state),
            "batches": batches, "rules": [(r"W$", (None, "model")),
                                          (r".*", ())]}


def _specs():
    base = _mlp_spec()
    rng = np.random.default_rng(5)
    return [
        dict(base, name="grid12", fn="grid", mesh=(1, 2)),
        dict(base, name="grid21", fn="grid", mesh=(2, 1)),
        dict(base, name="reshard", fn="reshard"),
        dict(base, name="publish", fn="publish",
             requests=rng.normal(size=(5, 6)).astype(np.float32)),
        dict(base, name="session", fn="session", kill_at=3),
        dict(base, name="checkpoint", fn="checkpoint"),
        dict(base, name="pod", fn="pod"),
        dict(base, name="recut", fn="recut", flat=_RECUT_FLAT,
             cuts=_RECUT_CUTS),
    ]


_RECUT_FLAT = np.random.default_rng(9).normal(size=11).astype(np.float32)
# (source slices, target padded length): 2 -> 2 ranks, 3 -> 2, 1 -> 2
# with a longer pad, 4 -> 2 exactly divisible
_RECUT_CUTS = [(2, 12), (3, 12), (1, 16), (4, 12)]


@pytest.fixture(scope="module")
def port2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("shard2"))
    return spawn(ranks.run_scenarios, 2, (_specs(), tmp), backend="gloo",
                 device="cpu", timeout=SPAWN_TIMEOUT)


def test_the_grid_builds_one_subgroup_a_slice(port2):
    for rank in range(2):
        g = port2[rank]["grid12"]
        assert g["shape"]["data"] == 1 and g["shape"]["model"] == 2
        assert g["index"] == {"data": 0, "model": rank, "sequence": 0}
        assert g["members"] == {"data": [rank], "model": [0, 1]}
        # ranks that share a data index read the same rows
        assert g["rows"] == (0, 8)
        g = port2[rank]["grid21"]
        assert g["members"]["data"] == [0, 1]
        assert g["rows"] == (rank * 4, rank * 4 + 4)


@pytest.mark.parametrize("direction", ["1x2->2x1", "2x1->1x2"])
def test_reshard_training_state_is_the_host_route_bit_for_bit(port2,
                                                              direction):
    for rank in range(2):
        r = port2[rank]["reshard"][direction]
        assert r["device"] == r["host"]
    full = (16, 6)
    shapes = [port2[rank]["reshard"][direction]["shapes"]["W"]
              for rank in range(2)]
    if direction == "1x2->2x1":
        assert shapes == [full, full]
    else:
        assert shapes == [(8, 6), (8, 6)]


@pytest.mark.parametrize("direction", ["1x2->2x1", "2x1->1x2"])
def test_the_handed_over_state_trains_on(port2, direction):
    a, b = (port2[rank]["reshard"][direction]["trained"]
            for rank in range(2))
    for u, v in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert np.isfinite(u).all()
        np.testing.assert_array_equal(u, v)


def test_publish_to_engine_serves_the_gathered_weights(port2):
    for rank in range(2):
        r = port2[rank]["publish"]
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-5,
                                   atol=1e-7)
        assert r["live_unchanged"]


def test_a_session_over_a_plan_resumes_onto_the_other_mesh_shape(port2):
    for rank in range(2):
        r = port2[rank]["session"]
        assert r["killed"] and r["restored_bits"]
        assert r["snapshot_iteration"] == 2
        assert r["iteration"] == 4 and np.isfinite(r["score"])


def test_one_rank_of_a_plan_writes_its_checkpoints(port2):
    for rank in range(2):
        r = port2[rank]["checkpoint"]
        # 4 steps, a save every 2 (iterations 1 and 3): rows 0 and 1,
        # each written once
        assert r["rows"] == [(0, 1), (1, 3)]
        assert r["last"] == r["gathered"]


def test_a_pod_snapshot_restores_on_real_ranks_bitwise(port2):
    for rank in range(2):
        r = port2[rank]["pod"]
        assert r["real"]
        assert r["pod"] == r["one_process"] == r["trained"]


@pytest.mark.parametrize("cut", _RECUT_CUTS)
def test_recut_flat_leaves_each_rank_its_slice(port2, cut):
    n_src, target = cut
    want = np.zeros(target, np.float32)
    want[:_RECUT_FLAT.size] = _RECUT_FLAT
    m = target // 2
    for rank in range(2):
        np.testing.assert_array_equal(port2[rank]["recut"][cut],
                                      want[rank * m:(rank + 1) * m])
