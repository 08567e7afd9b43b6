"""The rank side of the sharding tests (``tests/test_torch_sharding.py``,
``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_ring.py``):
what each gloo rank runs. It imports no jax (the ranks start from a fresh
interpreter and load this module by name): each scenario builds its
network from the JAX package's configuration JSON and params, trains it
through ``ParallelWrapper(partition_rules=...)`` on this rank's partition
of every global batch, and returns the trained trees in the JAX package's
layouts, with what the rank held while it trained."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.comms.reshard import (
    publish_to_engine,
    reshard_training_state,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, mesh, tensor
from deeplearning4j_tpu_torch.sharding import ShardingPlan
from deeplearning4j_tpu_torch.sharding.rules import P
from deeplearning4j_tpu_torch.telemetry import health

from tests.torch_parallel_ranks import build, trees


MODEL = mesh.MODEL_AXIS


def unshard_tp_params(params: dict, m) -> dict:
    """The whole Megatron-block params from every rank's slices (a
    collective; the inverse of ``tensor.shard_tp_params``)."""
    size = int(m.shape[MODEL])
    group = m.axis_group(MODEL)
    out = {}
    for k, v in params.items():
        if k == "w_qkv":
            full = tensor._gather_dim(v, group, size, 1)
            d = full.shape[1] // 3
            order = torch.cat([tensor._qkv_columns(d, size, r)
                               for r in range(size)])
            whole = torch.empty_like(full)
            whole[:, order] = full
            v = whole
        elif k == "w_ff1":
            v = tensor._gather_dim(v, group, size, 1)
        elif k in ("w_out", "w_ff2", "b_ff1"):
            v = tensor._gather_dim(v, group, size, 0)
        out[k] = v
    return out


def rules_of(spec):
    """The scenario's rule table: ``[(regex, entries)]`` -> specs."""
    return [(pat, P(*entries)) for pat, entries in spec["rules"]]


def partition(batches, m, plant=None):
    """This rank's rows of every global batch (by its data index);
    ``plant``: ``(batch index, data index)`` whose first feature becomes
    NaN."""
    out = []
    for i, (x, y) in enumerate(batches):
        lo, hi, _ = mesh.partition_rows(x.shape[0], m.data_rank, m.data)
        xs = x[lo:hi].copy()
        if plant is not None and tuple(plant) == (i, m.data_rank):
            xs.reshape(-1)[0] = np.nan
        out.append(DataSet(xs, y[lo:hi]))
    return out


def digest(tree) -> str:
    """sha1 of a tensor tree's bits (leaves in sorted-key order)."""
    h = hashlib.sha1()
    for t in scheduler.tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _Record(TrainingListener):
    """Scores; after step 1 this rank's shapes and bytes."""

    def __init__(self):
        self.scores, self.local, self.local_bytes = [], None, None

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))
        if self.local is None:
            self.local = {k: {p: tuple(v.shape) for p, v in vp.items()}
                          for k, vp in model.params.items()}
            self.local_bytes = (
                sum(v.numel() * v.element_size()
                    for vp in model.params.values() for v in vp.values()),
                sum(v.numel() * v.element_size()
                    for vp in model.opt_state.values()
                    for st in vp.values() for v in st.values()))


def _gauge(name, device):
    return telemetry.REGISTRY.gauge(name, device=str(device)).value


def train(rank, world, spec, tmpdir):
    """One DP x TP (or DP, ``"plan": False``) training scenario; under
    ``"health"`` the SKIP_STEP run of ``tests/torch_session_ranks.py``."""
    data, model = spec.get("mesh", (world, 1))
    m = mesh.single_host_mesh(data=data, model=model)
    net = build(spec)
    plan = None
    if spec.get("plan", True):
        plan = ShardingPlan(rules_of(spec), mesh=m, demote_indivisible=True)
    pw = ParallelWrapper(net, mesh=m, partition_rules=plan,
                         prefetch_buffer=0)
    rec = _Record()
    net.set_listeners(rec)
    batches = partition(spec["batches"], m, spec.get("plant"))
    out = {}
    if spec.get("health"):
        health.configure(spec["health"], record_flights=False)
        try:
            poisoned = spec["plant"][0]
            pw.fit(ListDataSetIterator(batches[:poisoned]))
            before = digest((net.params, net.state, net.opt_state))
            pw.fit(ListDataSetIterator(batches[poisoned:poisoned + 1]))
            after = digest((net.params, net.state, net.opt_state))
            pw.fit(ListDataSetIterator(batches[poisoned + 1:]))
            rep = health.report()
            out.update(same=before == after, skipped=rep["skipped_steps"],
                       nonfinite=rep["nonfinite_steps"])
        finally:
            health.disable()
            health.MONITOR.reset()
    else:
        pw.fit(ListDataSetIterator(batches))
    out.update(trees=trees(net), scores=rec.scores, local=rec.local,
               local_bytes=rec.local_bytes,
               digest=digest((net.params, net.opt_state)))
    if plan is not None:
        out.update(
            explain=plan.explain(fmt="json"), tag=plan.cache_tag(),
            gauges=(_gauge("dl4j_shard_param_bytes", net.device),
                    _gauge("dl4j_shard_opt_bytes", net.device)),
            plan_bytes=(plan.param_bytes_per_device(net),
                        plan.opt_bytes_per_device(net)),
            splits={k: (s.kind, s.split_in, s.keep_out)
                    for k, s in pw._axis.splits.items()})
    return out


def tp_block(rank, world, spec, tmpdir):
    """``tp_block_apply`` and ``tp_train_step`` on this rank's slices at
    ``spec["mesh"]``: this rank's output rows, the losses, and the params
    made whole after the steps."""
    data, model = spec["mesh"]
    m = mesh.single_host_mesh(data=data, model=model)
    params = {k: torch.tensor(v) for k, v in spec["params"].items()}
    local = tensor.shard_tp_params(params, m)
    x, t = (torch.tensor(a) for a in (spec["x"], spec["targets"]))
    lo, hi, _ = mesh.partition_rows(x.shape[0], m.data_rank, m.data)
    h = spec["n_heads"]
    with torch.no_grad():
        y = tensor.tp_block_apply(local, x[lo:hi], h, m)
    step = tensor.tp_train_step(m, h, lr=spec["lr"])
    losses = []
    for _ in range(spec["steps"]):
        local, loss = step(local, x[lo:hi], t[lo:hi])
        losses.append(float(loss))
    whole = unshard_tp_params(local, m)
    return {"y": y.numpy(), "rows": (lo, hi), "losses": losses,
            "params": {k: v.numpy() for k, v in whole.items()},
            "local_shapes": {k: tuple(v.shape) for k, v in local.items()}}


def _fitted(spec, m, plan):
    """A net trained one step on this rank's rows; its wrapper staged
    again, the live slices on the model as mid-fit."""
    net = build(spec)
    pw = ParallelWrapper(net, mesh=m, partition_rules=plan,
                         prefetch_buffer=0)
    pw.fit(ListDataSetIterator(partition(spec["batches"], m)))
    pw._setup()
    return net, pw


def reshard_pair(rank, world, spec, tmpdir):
    """``reshard_training_state`` from a 1 x 2 plan wrapper onto a 2 x 1
    one and back the other way, each against the host route (the source's
    ``sync_model``, then the destination's set-up): digests of the trees
    each rank holds, and what it holds."""
    rules = rules_of(spec)
    m12 = mesh.single_host_mesh(data=1, model=2)
    m21 = mesh.single_host_mesh(data=2)
    out = {}
    for name, src_m, dst_m in (("1x2->2x1", m12, m21),
                               ("2x1->1x2", m21, m12)):
        def plan_on(mm):
            return (ShardingPlan(rules, mesh=mm) if mm is m12 else None)

        net, pw = _fitted(spec, src_m, plan_on(src_m))
        dst = ParallelWrapper(net, mesh=dst_m, partition_rules=plan_on(dst_m),
                              prefetch_buffer=0)
        reshard_training_state(pw, dst)
        dst._setup()
        device = (digest((net.params, net.opt_state)),
                  {k: tuple(v.shape) for k, v in net.params["0"].items()})
        net2, pw2 = _fitted(spec, src_m, plan_on(src_m))
        pw2.sync_model()
        dst2 = ParallelWrapper(net2, mesh=dst_m,
                               partition_rules=plan_on(dst_m),
                               prefetch_buffer=0)
        dst2._setup()
        host = digest((net2.params, net2.opt_state))
        # the destination trains on from the handed-over state
        dst.fit(ListDataSetIterator(partition(spec["batches"], dst_m)))
        out[name] = {"device": device[0], "host": host,
                     "shapes": device[1], "trained": trees(net)}
    return out


def publish(rank, world, spec, tmpdir):
    """``publish_to_engine`` from a 1 x 2 plan wrapper's live slices: the
    engine's answers and the gathered network's ``output``."""
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
    )

    m12 = mesh.single_host_mesh(data=1, model=2)
    net, pw = _fitted(spec, m12, ShardingPlan(rules_of(spec), mesh=m12))
    engine = InferenceEngine(build(spec), BatchingConfig(max_batch=4),
                             graph_opt=spec.get("graph_opt", True))
    x = spec["requests"]
    try:
        live = digest(net.params)
        publish_to_engine(pw, engine)
        kept = digest(net.params) == live  # the live slices untouched
        got = np.stack([np.asarray(engine.predict(x[i:i + 1]))[0]
                        for i in range(x.shape[0])])
    finally:
        engine.close()
    pw.sync_model()
    return {"got": got, "want": net.output(x), "live_unchanged": kept}


def session_across(rank, world, spec, tmpdir):
    """A ``TrainingSession`` over a 1 x 2 plan wrapper killed at
    ``train.step`` call ``kill_at``, resumed onto a 2 x 1 wrapper: the
    snapshot's trees against the resumed ones (bits), and the run on."""
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.session import TrainingSession
    from deeplearning4j_tpu_torch.util import serializer

    d = os.path.join(tmpdir, "session")
    m12 = mesh.single_host_mesh(data=1, model=2)
    m21 = mesh.single_host_mesh(data=2)
    net = build(spec)
    pw = ParallelWrapper(net, mesh=m12, partition_rules=ShardingPlan(
        rules_of(spec), mesh=m12), prefetch_buffer=0)
    sess = TrainingSession(pw, d, snapshot_every_n_iterations=2,
                           max_restarts=0, device="cpu")
    it = ListDataSetIterator(partition(spec["batches"], m12))
    plan_f = faults.FaultPlan().inject("train.step",
                                       on_calls=[spec["kill_at"]])
    killed = False
    with plan_f.armed():
        try:
            sess.fit(it, epochs=1)
        except faults.InjectedFault:
            killed = True
    snap = sess.snapshots()[-1]
    saved = serializer.restore_model(os.path.join(d, snap["file"]),
                                     device="cpu")
    net_b = build(spec)
    pw_b = ParallelWrapper(net_b, mesh=m21, prefetch_buffer=0)
    sess_b = TrainingSession(pw_b, d, device="cpu")
    restored = sess_b.resume()
    same = (digest((restored.params, restored.opt_state))
            == digest((saved.params, saved.opt_state)))
    it_b = ListDataSetIterator(partition(spec["batches"], m21))
    sess_b.fit(it_b, to_epoch=1)
    return {"killed": killed, "restored_bits": same,
            "iteration": int(pw_b.model.iteration),
            "snapshot_iteration": int(snap["iteration"]),
            "score": pw_b.score_value}


def checkpoint_writer(rank, world, spec, tmpdir):
    """A ``CheckpointListener`` on a 1 x 2 plan wrapper, both ranks naming
    one directory: the rows ``checkpoint.csv`` lists (one writer) and the
    last checkpoint's trees against the gathered network's."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.optimize.checkpoint import (
        CheckpointListener,
    )

    d = os.path.join(tmpdir, "ckpt")
    m12 = mesh.single_host_mesh(data=1, model=2)
    net = build(spec)
    lst = CheckpointListener(d, save_every_n_iterations=2)
    net.set_listeners(lst)
    pw = ParallelWrapper(net, mesh=m12, partition_rules=ShardingPlan(
        rules_of(spec), mesh=m12), prefetch_buffer=0)
    pw.fit(ListDataSetIterator(partition(spec["batches"], m12)))
    pw.sync_model()
    dist.barrier()
    rows = CheckpointListener(d, save_every_n_iterations=2)._read_rows()
    last = lst.load_checkpoint(device="cpu")
    return {"rows": [(r.number, r.iteration) for r in rows],
            "last": digest(last.params), "gathered": digest(net.params)}


def pod_restore(rank, world, spec, tmpdir):
    """A pod snapshot written by the two ranks, restored on the real pod
    and by one process playing both hosts: the same bits as what was
    trained."""
    from deeplearning4j_tpu_torch.resilience import pod as pod_mod

    d = os.path.join(tmpdir, "pod")
    net = build(spec)
    pw = ParallelWrapper(net, prefetch_buffer=0)
    pw.fit(ListDataSetIterator(partition(spec["batches"], pw.mesh)))
    real = pod_mod.PodConfig(group=pw.group)
    pod_mod.write_pod_snapshot(net, d, real)
    a, _ = pod_mod.restore_pod_snapshot(d, real, device="cpu")
    b, _ = pod_mod.restore_pod_snapshot(d, None, device="cpu")
    return {"pod": digest((a.params, a.opt_state)),
            "one_process": digest((b.params, b.opt_state)),
            "trained": digest((net.params, net.opt_state)),
            "real": real.real}


def recut(rank, world, spec, tmpdir):
    """``recut_flat`` over the ranks: ``spec["flat"]`` cut into
    ``n_src`` slices (slice ``h`` held by rank ``h % world``), re-cut to
    ``target`` elements; this rank's slice of each target layout."""
    from deeplearning4j_tpu_torch.comms.reshard import recut_flat

    flat = torch.tensor(spec["flat"])
    n = flat.shape[0]
    out = {}
    for n_src, target in spec["cuts"]:
        m = -(-n // n_src)
        padded = torch.cat([flat, flat.new_zeros(m * n_src - n)])
        held = {h: padded[h * m:(h + 1) * m].clone()
                for h in range(n_src) if h % world == rank}
        out[(n_src, target)] = recut_flat(
            held, n, target, None, n_src=n_src, like=flat).numpy()
    return out


def grid(rank, world, spec, tmpdir):
    """The process grid at data x model: this rank's coordinates, the
    subgroups' members (each rank's default-group rank, gathered over
    the subgroup) and the rows a wrapper fit hands it."""
    data, model = spec["mesh"]
    m = mesh.single_host_mesh(data=data, model=model)
    members = {}
    for axis in (mesh.DATA_AXIS, mesh.MODEL_AXIS):
        g = m.axis_group(axis)
        n = int(m.shape[axis])
        if n == 1:  # an axis of size 1 runs no collective
            members[axis] = [rank]
            continue
        t = torch.tensor([float(rank)])
        out = torch.zeros(n)
        scheduler.all_gather(out, t, g)
        members[axis] = [int(v) for v in out]
    x, _ = spec["batches"][0]
    lo, hi, _ = mesh.partition_rows(x.shape[0], m.data_rank, m.data)
    return {"shape": {k: int(v) for k, v in m.shape.items()},
            "index": {a: m.index(a) for a in (mesh.DATA_AXIS,
                                               mesh.MODEL_AXIS,
                                               mesh.SEQUENCE_AXIS)},
            "members": members, "rows": (lo, hi),
            "coords": m.coords(rank)}


def ring(rank, world, spec, tmpdir):
    """``ring_attention`` over the ``sequence`` ranks: the output and the
    gradients of ``sum(o * do)``, whole, on every rank."""
    from deeplearning4j_tpu_torch.ops.ring import ring_attention

    m = mesh.single_host_mesh(sequence=world)
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in (spec["q"], spec["k"], spec["v"]))
    km = None if spec.get("mask") is None else torch.tensor(spec["mask"])
    o = ring_attention(q, k, v, m, km, causal=spec["causal"])
    (o * torch.tensor(spec["do"])).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


SCENARIOS = {"train": train, "tp_block": tp_block,
             "reshard": reshard_pair, "publish": publish,
             "session": session_across, "checkpoint": checkpoint_writer,
             "pod": pod_restore, "recut": recut,
             "grid": grid,
             "ring": ring}


def run_scenarios(rank, world, specs, tmpdir):
    """Every scenario in one process group; {name: result}."""
    torch.set_num_threads(1)
    return {spec["name"]: SCENARIOS[spec["fn"]](rank, world, spec, tmpdir)
            for spec in specs}
