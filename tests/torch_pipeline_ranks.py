"""The rank side of ``tests/test_torch_pipeline.py``: what each gloo rank
runs. It imports no jax (the ranks start from a fresh interpreter and load
this module by name): each scenario builds its network from the JAX
package's configuration JSON and params, trains it through
``PipelineParallelWrapper`` on every global batch, and returns the trained
trees in the JAX package's layouts, with what the stages did."""

from __future__ import annotations

import os

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph import _vertex_seed
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.parallel import mesh
from deeplearning4j_tpu_torch.parallel.pipeline import (
    HeteroPipeline,
    PipelineParallelWrapper,
    pipeline_spmd_fn,
    pipeline_train_step,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.util import serializer

from tests.torch_parallel_ranks import build, trees


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def mse(outs, target):
    return ((outs - target) ** 2).mean()


def _t(tree):
    return scheduler.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _np(tree):
    return scheduler.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def functional(rank, world, spec, tmpdir):
    """``pipeline_spmd_fn`` at every ``M`` of the spec, one
    ``pipeline_train_step``, and ``HeteroPipeline``'s forward and step."""
    m = mesh.single_host_mesh(pipeline=world)
    per_stage = _t(spec["stages"])
    mine = stack_stage_params(per_stage, m, device="cpu")
    out = {"fwd": {}}
    for n_micro, x in spec["xs"].items():
        fn = pipeline_spmd_fn(stage_fn, world, n_micro, m)
        out["fwd"][n_micro] = fn(mine, torch.as_tensor(x)).numpy()
    x, y = (torch.as_tensor(a) for a in spec["train"])
    step = pipeline_train_step(stage_fn, mse, world, x.shape[0], m, lr=0.1)
    new, loss = step(mine, x, y)
    out["train"] = (_np(new), float(loss))
    hp = _t(spec["hetero"])
    hx, ht = (torch.as_tensor(a) for a in spec["hetero_xy"])
    pipe = HeteroPipeline([stage_fn] * world, hp, hx[0], m, hx.shape[0],
                          device="cpu")
    stacked = pipe.stack_params(hp)
    out["hetero_fwd"] = pipe.spmd_fn()(stacked, hx).numpy()
    new, loss = pipe.train_step(mse, lr=0.1)(stacked, hx, ht)
    out["hetero_train"] = ([_np(p) for p in pipe.unstack_params(new)],
                           float(loss))
    out["hetero_shapes"] = (pipe.in_shapes, pipe.out_shape)
    return out


def serial_step(net, x, y, n_micro: int, it: int):
    """The port's own serial microbatched step (the oracle with the
    pipeline dimension collapsed): each microbatch through every layer
    with the BN state threaded on and the pipeline's dropout seeds, the
    mean of the head's scores plus the regularization score, one
    backward, the solver chain on a fresh updater state."""
    layers = net.conf.layers
    last = len(layers) - 1
    leaves = {k: {p: v.detach().clone().requires_grad_()
                  for p, v in vp.items()} for k, vp in net.params.items()}
    state = dict(net.state)
    feats = net._prepare(x)
    labels = net._on_device(y)
    mb = feats.shape[0] // n_micro
    total = 0.0
    for mi in range(n_micro):
        seed = _vertex_seed(net._train_seed(it), mi)
        h, new = net._run(leaves, state, feats[mi * mb:(mi + 1) * mb],
                          train=True, seed=seed, upto=last)
        state.update(new)
        total = total + layers[last].score(
            leaves.get(str(last), {}), h, labels[mi * mb:(mi + 1) * mb],
            None)
    loss = total / n_micro + solver.regularization_score(
        leaves, lambda key: layers[int(key)])
    loss.backward()
    with torch.no_grad():
        for k, vp in leaves.items():
            layer, upd = net._layer_updater(k)
            g = solver.normalize_layer_gradients(
                layer, {p: v.grad for p, v in vp.items()})
            opt = {p: upd.init_state(v) for p, v in vp.items()}
            new_p, _ = solver.apply_updater_to_layer(
                layer, upd, {p: v.detach().clone() for p, v in vp.items()},
                g, opt, upd.current_lr(it, 0), it, 0)
            net.params[k] = new_p
    net.state = state
    net.iteration = it + 1
    return float(loss.detach())


def train(rank, world, spec, tmpdir):
    """One wrapper scenario at ``spec["grid"]`` = (data, pipeline): the
    losses, the trained trees after ``write_back``, the plan, each step's
    hand-offs; ``"oracle"``: the serial microbatched step too;
    ``"zip"``: a zip written after ``fit``; ``"plant"``: a NaN in one
    batch under the health layer's WARN policy; ``"telemetry"``: the
    pipeline gauges."""
    data, pipe = spec.get("grid", (1, world))
    m = mesh.single_host_mesh(data=data, pipeline=pipe)
    net = build(spec)
    pw = PipelineParallelWrapper(net, n_micro=spec["n_micro"], mesh=m,
                                 schedule=spec.get("schedule", "gpipe"))
    batches = [(np.array(x), np.array(y)) for x, y in spec["batches"]]
    if spec.get("plant") is not None:
        batches[spec["plant"]][0].reshape(-1)[0] = np.nan
    out = {"stage": m.stage, "data_rank": m.data_rank}
    if spec.get("telemetry"):
        telemetry.reset()
        telemetry.enable()
    if spec.get("plant") is not None:
        health.configure("warn", record_flights=False)
    try:
        steps = []
        losses = []
        if spec.get("zip"):
            pw.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
            losses.append(pw.score_value)
        else:
            for x, y in batches:
                losses.append(pw.fit_batch(DataSet(x, y)))
                steps.append(dict(pw.last_step))
            pw.write_back()
        if spec.get("plant") is not None:
            rep = health.report()
            out["health"] = {"nonfinite": rep["nonfinite_steps"],
                             "skipped": rep["skipped_steps"]}
        if spec.get("telemetry"):
            out["gauges"] = {
                k: v for k, v in telemetry.REGISTRY.snapshot().items()
                if k.startswith(("dl4j_pipeline_",
                                 "dl4j_training_steps_total"))}
    finally:
        if spec.get("plant") is not None:
            health.disable()
            health.MONITOR.reset()
        if spec.get("telemetry"):
            telemetry.disable()
            telemetry.reset()
    out.update(losses=losses, steps=steps, trees=trees(net),
               stage_keys=[list(k) for k in pw.stage_keys],
               crossings=[list(c) for c in pw._crossings],
               iteration=net.iteration)
    if spec.get("zip") and rank == 0:
        path = os.path.join(tmpdir, f"{spec['name']}.zip")
        serializer.write_model(net, path)
        out["zip"] = path
    if spec.get("oracle"):
        ref = build(spec)
        out["oracle_losses"] = [
            serial_step(ref, x, y, spec["n_micro"], it)
            for it, (x, y) in enumerate(batches)]
        out["oracle_trees"] = trees(ref)
    return out


def grid(rank, world, spec, tmpdir):
    """The grid at ``spec["grid"]``: this rank's coordinates, its
    neighbours and its pipeline subgroup's members."""
    import torch.distributed as dist

    data, pipe = spec["grid"]
    m = mesh.single_host_mesh(data=data, pipeline=pipe)
    members = torch.zeros(world, dtype=torch.int64)
    members[rank] = 1
    dist.all_reduce(members, group=m.pipeline_group)
    return {"coords": m.coords(rank), "stage": m.stage,
            "prev": m.prev_stage, "next": m.next_stage,
            "pipeline_members": [i for i in range(world) if members[i]],
            "data": m.data, "data_rank": m.data_rank}


SCENARIOS = {"functional": functional, "train": train, "grid": grid}


def run_scenarios(rank, world, specs, tmpdir):
    """Every scenario in one process group; {name: result}."""
    torch.set_num_threads(1)
    return {spec["name"]: SCENARIOS[spec["fn"]](rank, world, spec, tmpdir)
            for spec in specs}

