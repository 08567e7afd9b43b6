"""The rank side of ``tests/test_torch_parallel_tbptt.py``: each gloo rank
builds the scenario's network from the JAX configuration JSON and params
(no jax is imported), trains it through ``ParallelWrapper`` on its
partition of every global tBPTT batch (features, labels and masks), and
returns the trained trees, each batch's score and segment losses, and the
threshold after each batch."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import mesh

from tests.torch_parallel_ranks import _wrapper, build, trees


class _Segments(TrainingListener):
    def __init__(self, pw):
        self.pw = pw
        self.scores, self.segments, self.taus, self.iterations = \
            [], [], [], []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))
        self.segments.append(model.last_segment_losses.numpy().tolist())
        self.iterations.append(int(iteration))
        if self.pw._tau is not None:
            self.taus.append(float(self.pw._tau))


def _part(a, lo, hi):
    return None if a is None else a[lo:hi]


def run_scenario(rank, world, spec):
    torch.manual_seed(0)
    net = build(spec)
    batches = []
    for x, y, fm, lm in spec["batches"]:
        lo, hi, _ = mesh.partition_rows(x.shape[0], rank, world)
        if spec["kind"] == "graph":
            batches.append(MultiDataSet(
                features=[x[lo:hi]], labels=[y[lo:hi]],
                features_masks=None if fm is None else [fm[lo:hi]],
                labels_masks=None if lm is None else [lm[lo:hi]]))
        else:
            batches.append(DataSet(x[lo:hi], y[lo:hi], _part(fm, lo, hi),
                                   _part(lm, lo, hi)))
    pw = _wrapper(net, spec)
    rec = _Segments(pw)
    net.set_listeners(rec)
    pw.fit(ListDataSetIterator(batches), epochs=spec.get("epochs", 1))
    return {"trees": trees(net), "scores": rec.scores,
            "segments": rec.segments, "taus": rec.taus,
            "iterations": rec.iterations, "iteration": net.iteration,
            "params_flat": np.asarray(net.params_flat())}


def run_scenarios(rank, world, specs):
    torch.set_num_threads(1)
    return {spec["name"]: run_scenario(rank, world, spec) for spec in specs}
