"""The rank side of ``tests/test_torch_expert_parallel.py``: what each gloo
rank runs. It imports no jax (the ranks start from a fresh interpreter and
load this module by name); each scenario builds its network from the JAX
package's configuration JSON and params, or takes raw MoE params, runs on
this rank's partition of the tokens, and returns numpy results in the JAX
package's layouts."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, expert, mesh
from deeplearning4j_tpu_torch.util.convert import (
    params_from_jax,
    params_to_jax,
)


def _rows(n, rank, world):
    lo, hi, _ = mesh.partition_rows(n, rank, world)
    return slice(lo, hi)


def wrapper(rank, world, spec):
    """``ParallelWrapper(expert_parallel=True).fit`` for ``steps`` steps on
    this rank's rows: the scores, the gathered params and the state."""
    conf = ComputationGraphConfiguration.from_json(spec["conf_json"])
    p, s = params_from_jax(conf, spec["params"], spec["state"])
    net = ComputationGraph(conf, device="cpu").set_params(p, s)
    x, y = spec["batch"]
    rows = _rows(x.shape[0], rank, world)
    pw = ParallelWrapper(net, expert_parallel=True, prefetch_buffer=0)
    expert.reset_stats()
    scores = []
    for _ in range(spec.get("steps", 1)):
        pw.fit(DataSet(x[rows], y[rows]))
        scores.append(pw.score_value)
    params, state = params_to_jax(conf, net.params, net.state)
    return {"scores": scores, "params": params, "state": state,
            "exchanged": expert.stats()}


def exact(rank, world, spec):
    """``ParallelWrapper`` in the exact mode, experts unsharded, for
    ``steps`` steps on this rank's rows: the router, the capacity queue and
    the aux loss over the global batch. ``per_rank_capacity`` is the
    planted control: each rank routes its own tokens alone."""
    from deeplearning4j_tpu_torch.comms import global_batch

    conf = ComputationGraphConfiguration.from_json(spec["conf_json"])
    p, s = params_from_jax(conf, spec["params"], spec["state"])
    net = ComputationGraph(conf, device="cpu").set_params(p, s)
    x, y = spec["batch"]
    rows = _rows(x.shape[0], rank, world)
    pw = ParallelWrapper(net, prefetch_buffer=0)
    real = global_batch.gather_rows
    if spec.get("per_rank_capacity"):
        global_batch.gather_rows = lambda t: (t, 0)
    try:
        scores = []
        for _ in range(spec.get("steps", 1)):
            pw.fit(DataSet(x[rows], y[rows]))
            scores.append(pw.score_value)
    finally:
        global_batch.gather_rows = real
    params, state = params_to_jax(conf, net.params, net.state)
    return {"scores": scores, "params": params, "state": state}


def spmd(rank, world, spec):
    """``moe_spmd_fn`` on this rank's tokens and expert shard."""
    m = mesh.single_host_mesh()
    params = {k: torch.tensor(v) for k, v in spec["params"].items()}
    x = torch.tensor(spec["x"][_rows(spec["x"].shape[0], rank, world)])
    fn = expert.moe_spmd_fn(spec["n_experts"], spec["capacity"], m,
                            top_k=spec["top_k"])
    y, aux = fn(expert.shard_moe_params(params, m), x)
    return {"y": y.detach().numpy(), "aux": float(aux)}


def train_step(rank, world, spec):
    """One ``moe_train_step`` on this rank's tokens and expert shard."""
    m = mesh.single_host_mesh()
    params = {k: torch.tensor(v) for k, v in spec["params"].items()}
    rows = _rows(spec["x"].shape[0], rank, world)
    step = expert.moe_train_step(spec["n_experts"], spec["capacity"], m,
                                 lr=0.1, aux_weight=0.0,
                                 top_k=spec["top_k"])
    new, loss = step(expert.shard_moe_params(params, m),
                     torch.tensor(spec["x"][rows]),
                     torch.tensor(spec["target"][rows]))
    return {"params": {k: v.numpy() for k, v in new.items()},
            "loss": float(loss)}


def zoo(rank, world, spec):
    """The zoo's MoE transformer trained expert-parallel: its losses."""
    from deeplearning4j_tpu_torch.conf.updaters import Adam
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    model = TransformerEncoder(updater=Adam(learning_rate=3e-3),
                               **spec["model"])
    net = ComputationGraph(model.conf(), device="cpu").init()
    pw = ParallelWrapper(net, expert_parallel=True, prefetch_buffer=0)
    x, y = spec["batch"]
    rows = _rows(x.shape[0], rank, world)
    losses = []
    for _ in range(spec["steps"]):
        pw.fit(DataSet(x[rows], y[rows]))
        losses.append(pw.score_value)
    return {"losses": losses, "out_shape": net.output(x).shape}


def refusal(rank, world, spec):
    """The message a wrapper over a layer of ``n_experts`` gives (with
    the spec's other wrapper arguments)."""
    conf = ComputationGraphConfiguration.from_json(spec["conf_json"])
    net = ComputationGraph(conf, device="cpu").init()
    try:
        ParallelWrapper(net, expert_parallel=spec["expert_parallel"],
                        **spec.get("kw", {}))
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_scenarios(rank, world, specs):
    """Every scenario in one process group; {name: result}."""
    torch.set_num_threads(1)
    return {name: globals()[spec["kind"]](rank, world, spec)
            for name, spec in specs.items()}


