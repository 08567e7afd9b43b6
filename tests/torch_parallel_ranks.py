"""The rank side of ``tests/test_torch_parallel.py``: what each gloo rank
runs. It imports no jax (the ranks start from a fresh interpreter and load
this module by name), builds each scenario's network from the JAX
package's configuration JSON and params, trains it through
``ParallelWrapper`` on this rank's partition of every global batch, and
returns the trained trees in the JAX package's layouts."""

from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.comms import global_batch
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import (
    AdaptiveThresholdAlgorithm,
    ParameterAveragingTrainingMaster,
    ParallelWrapper,
    SharedTrainingMaster,
    SparkComputationGraph,
    SparkDl4jMultiLayer,
    ThresholdAlgorithm,
    TrainingMode,
    mesh,
)
from deeplearning4j_tpu_torch.util import serializer
from deeplearning4j_tpu_torch.util.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)


def build(spec):
    """The scenario's port network on the CPU, with the JAX params."""
    if spec["kind"] == "graph":
        conf = ComputationGraphConfiguration.from_json(spec["conf_json"])
        net_cls = ComputationGraph
    else:
        conf = MultiLayerConfiguration.from_json(spec["conf_json"])
        net_cls = MultiLayerNetwork
    for layer in getattr(conf, "layers", []):
        if spec.get("force_kernel") and hasattr(layer, "force_kernel"):
            layer.force_kernel = True
    p, s = params_from_jax(conf, spec["params"], spec["state"])
    return net_cls(conf, "cpu").set_params(p, s)


def trees(net):
    p, s = params_to_jax(net.conf, net.params, net.state)
    o = opt_state_to_jax(net.conf, net.opt_state)
    host = lambda t: mesh.host_gather(t)  # noqa: E731
    return {"params": host(p), "state": host(s), "opt": host(o)}


class _Record(TrainingListener):
    """Scores (and the threshold) after every step; a zip written at one
    iteration mid-fit."""

    def __init__(self, pw, write_at, path):
        self.pw, self.write_at, self.path = pw, write_at, path
        self.scores, self.taus, self.replicas = [], [], []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))
        if self.pw._tau is not None:
            self.taus.append(float(self.pw._tau))
        if self.pw.training_mode is TrainingMode.AVERAGING:
            self.replicas.append(digest(self.pw._params))
        if iteration == self.write_at:
            serializer.write_model(model, self.path)


def _wrapper(net, spec):
    kw = dict(spec.get("wrapper", {}))
    if kw.pop("averaging", False):
        kw["training_mode"] = TrainingMode.AVERAGING
    thr = kw.pop("threshold", None)
    if thr is not None:
        kind, tau = thr
        kw["threshold_algorithm"] = (ThresholdAlgorithm(tau) if kind == "fixed"
                                     else AdaptiveThresholdAlgorithm(tau))
    return ParallelWrapper(net, prefetch_buffer=0, **kw)


@contextlib.contextmanager
def per_rank_bn(on: bool = True):
    """The planted control: batch-norm statistics over this rank's rows
    only (the per-shard modes' semantics) while the loss stays global."""
    real = global_batch.batch_moments, global_batch.global_sums
    if on:
        global_batch.batch_moments = lambda x32, axes: (
            x32.mean(dim=axes), (x32 * x32).mean(dim=axes))
        global_batch.global_sums = lambda s, q, m: (s, q, m)
    try:
        yield
    finally:
        global_batch.batch_moments, global_batch.global_sums = real


def run_scenario(rank, world, spec, tmpdir):
    torch.manual_seed(0)
    net = build(spec)
    batches = []
    for x, y in spec.get("batches", ()):
        lo, hi, _ = mesh.partition_rows(x.shape[0], rank, world)
        batches.append(DataSet(x[lo:hi], y[lo:hi]))
    path = os.path.join(tmpdir, f"{spec['name']}_rank{rank}.zip")
    telemetry.reset()
    if spec.get("telemetry"):
        telemetry.enable()
    master = spec.get("master")
    if master is not None:
        tm = (ParameterAveragingTrainingMaster(**master[1])
              if master[0] == "averaging"
              else SharedTrainingMaster(**master[1]))
        facade = (SparkComputationGraph if spec["kind"] == "graph"
                  else SparkDl4jMultiLayer)(None, net, tm)
        pw = facade._wrapper
        rec = _Record(pw, spec.get("write_at"), path)
        net.set_listeners(rec)
        x, y = spec["arrays_by_rank"][rank]
        facade.fit(x, y, epochs=spec.get("epochs", 1))
    else:
        pw = _wrapper(net, spec)
        rec = _Record(pw, spec.get("write_at"), path)
        net.set_listeners(rec)
        with per_rank_bn(spec.get("per_rank_bn", False)):
            pw.fit(ListDataSetIterator(batches),
                   epochs=spec.get("epochs", 1))
    telemetry.disable()
    out = {"trees": trees(net), "scores": rec.scores, "taus": rec.taus,
           "replicas": rec.replicas,
           "score": pw.score_value, "iteration": net.iteration,
           "epoch": net.epoch}
    if spec.get("write_at") is not None:
        out["zip"] = path
    if spec.get("telemetry"):
        out["metrics"] = telemetry.REGISTRY.snapshot(run_collectors=False)
    return out


def digest(tree) -> str:
    """sha1 of a tensor tree's bits."""
    h = hashlib.sha1()
    for k in sorted(tree):
        for pk in sorted(tree[k]):
            h.update(tree[k][pk].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def echo(rank, world, x):
    return rank, world, x


def oversized(rank, world):
    """Rank 1's second partition is larger than the size the fit's first
    batch fixed: it raises while rank 0 waits in a collective."""
    from deeplearning4j_tpu_torch.conf import Activation, InputType
    from deeplearning4j_tpu_torch.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )

    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, "cpu").init()
    rng = np.random.default_rng(rank)
    sizes = (8, 16 if rank == 1 else 8)
    batches = [DataSet(rng.normal(size=(n, 4)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])
               for n in sizes]
    ParallelWrapper(net, prefetch_buffer=0).fit(ListDataSetIterator(batches))


def run_scenarios(rank, world, specs, tmpdir):
    """Every scenario in one process group; {name: result}."""
    torch.set_num_threads(1)
    return {spec["name"]: run_scenario(rank, world, spec, tmpdir)
            for spec in specs}
