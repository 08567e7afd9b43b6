"""The rank side of ``tests/test_torch_pod.py`` and
``tests/test_torch_parallel_health.py``: what each gloo rank runs. It
imports no jax (the ranks start from a fresh interpreter and load this
module by name); each scenario builds its network from the JAX package's
configuration JSON and params and trains this rank's partition of every
global batch."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper,
    ThresholdAlgorithm,
    TrainingMode,
    mesh,
)
from deeplearning4j_tpu_torch.resilience import (
    FaultPlan,
    HostDeathError,
    TrainingSession,
)
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util.convert import params_from_jax


def build(spec):
    conf = MultiLayerConfiguration.from_json(spec["conf_json"])
    p, s = params_from_jax(conf, spec["params"], spec["state"])
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def partition(batches, rank, world, plant=None):
    """This rank's rows of every global batch; ``plant``: ``(batch index,
    rank)`` whose first feature becomes NaN."""
    out = []
    for i, (x, y) in enumerate(batches):
        lo, hi, _ = mesh.partition_rows(x.shape[0], rank, world)
        xs = x[lo:hi].copy()
        if plant is not None and plant == (i, rank):
            xs[0, 0] = np.nan
        out.append(DataSet(xs, y[lo:hi]))
    return out


def flats(net):
    return (net.params_flat(),
            params_util.flatten_state_like(net.conf, net.opt_state))


WRAPPERS = {
    "exact": {},
    "bucketed": {"gradient_bucket_mb": 0},
    "threshold": {"threshold_algorithm": "fixed"},
    "zero": {"zero_optimizer": True, "gradient_bucket_mb": 0},
    "averaging": {"training_mode": "averaging", "averaging_frequency": 1},
}


def wrapper(net, mode):
    kw = dict(WRAPPERS[mode])
    if kw.get("threshold_algorithm"):
        kw["threshold_algorithm"] = ThresholdAlgorithm(1e-3)
    if kw.get("training_mode"):
        kw["training_mode"] = TrainingMode.AVERAGING
    return ParallelWrapper(net, prefetch_buffer=0, **kw)


# --------------------------------------------------------------------------
# pod snapshots on real ranks
# --------------------------------------------------------------------------

def pod_session(rank, world, spec, directory):
    """A ZeRO wrapper: the uninterrupted run, then a pod session whose
    rank 1 dies at its 4th heartbeat; returns both runs' flats and the
    session's restarts."""
    torch.set_num_threads(1)
    batches = spec["batches"]
    ref = wrapper(build(spec), "zero")
    ref.fit(ListDataSetIterator(partition(batches, rank, world)), epochs=2)
    sess = TrainingSession(wrapper(build(spec), "zero"), directory,
                           snapshot_every_n_iterations=2, pod=world)
    plan = FaultPlan(seed=5)
    if rank == 1:
        plan.inject("pod.heartbeat", on_calls=[4],
                    exc=lambda: HostDeathError(host=1))
    with plan.armed():
        sess.fit(ListDataSetIterator(partition(batches, rank, world)),
                 epochs=2)
    return {"ref": flats(ref.model), "got": flats(sess._net),
            "restarts": sess.restarts,
            "iteration": sess._net.iteration,
            "snapshots": [s["file"] for s in sess.snapshots()]}


# --------------------------------------------------------------------------
# the guard modes
# --------------------------------------------------------------------------

def guard_vectors(rank, world, specs):
    """Every guard-mode scenario in one process group: each trains ONE
    step under WARN and returns the monitor's last (combined) vector."""
    torch.set_num_threads(1)
    out = {}
    for spec in specs:
        health.configure("warn", record_flights=False)
        try:
            net = build(spec)
            pw = wrapper(net, spec["mode"])
            pw.fit(ListDataSetIterator(partition(spec["batches"], rank,
                                                 world)))
            health.MONITOR.flush()
            out[spec["name"]] = {"vec": health.MONITOR.last_vec,
                                 "keys": list(health.MONITOR.last_keys)}
        finally:
            health.disable()
            health.MONITOR.reset()
    return out


def _trees(net):
    def host(t):
        return {k: {pk: v.detach().clone() for pk, v in vp.items()}
                for k, vp in t.items()}

    return host(net.params), host(net.state)


def skip_step(rank, world, specs):
    """SKIP_STEP with a NaN planted in rank 1's shard of step 3 (index 2):
    per scenario, whether every tree after step 3 equals the trees after
    step 2 bit for bit on this rank, whether step 4 moved, and the
    monitor's counts."""
    torch.set_num_threads(1)
    out = {}
    for spec in specs:
        health.configure("skip_step", record_flights=False)
        try:
            net = build(spec)
            pw = wrapper(net, spec["mode"])
            data = partition(spec["batches"], rank, world, plant=(2, 1))
            pw.fit(ListDataSetIterator(data[:2]))
            p2, s2 = _trees(net)
            o2 = flats(net)[1]
            pw.fit(ListDataSetIterator(data[2:3]))
            p3, s3 = _trees(net)
            o3 = flats(net)[1]
            pw.fit(ListDataSetIterator(data[3:4]))
            p4, _ = _trees(net)
            same = (all(torch.equal(p2[k][pk], p3[k][pk])
                        for k in p2 for pk in p2[k])
                    and all(torch.equal(s2[k][pk], s3[k][pk])
                            for k in s2 for pk in s2[k])
                    and np.array_equal(o2, o3))
            moved = any(not torch.equal(p3[k][pk], p4[k][pk])
                        for k in p3 for pk in p3[k])
            rep = health.report()
            out[spec["name"]] = {"same": same, "moved": moved,
                                 "skipped": rep["skipped_steps"],
                                 "nonfinite": rep["nonfinite_steps"]}
        finally:
            health.disable()
            health.MONITOR.reset()
    return out


def combine(rank, world):
    """``health.combine_across`` of a vector each rank fills its own way."""
    vec = torch.tensor([float(rank), 1.0 - rank, 0.5, 2.0 * rank])
    return health.combine_across(vec).tolist()
