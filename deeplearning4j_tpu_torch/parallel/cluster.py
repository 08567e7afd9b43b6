"""Cluster training — the Spark / parameter-server facades.

Counterpart of the JAX package's ``parallel/cluster.py`` (reference
``dl4j-spark``'s ``ParameterAveragingTrainingMaster`` and
``SharedTrainingMaster`` and the ``SparkDl4jMultiLayer`` /
``SparkComputationGraph`` facades). There is no Spark and no parameter
server: the processes of one job join a ``torch.distributed`` process
group (:func:`parallel.mesh.initialize_distributed`, or ``torchrun``), and
the masters only carry the reference's configuration surface (averaging
frequency, threshold algorithm, worker batch sizes) into a
:class:`~deeplearning4j_tpu_torch.parallel.wrapper.ParallelWrapper`; each
process feeds its own partition, as a Spark executor does.

Contract (the reference repartitions to equal-size partitions before
training): every rank runs the same number of equally-shaped batches per
epoch; a rank with an extra batch leaves the others waiting until the
process group's timeout raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm,
    ThresholdAlgorithm,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (
    ParallelWrapper,
    TrainingMode,
)


class TrainingMaster:
    """Configuration strategy for cluster fitting (reference
    ``org.deeplearning4j.spark.api.TrainingMaster``)."""

    def build_wrapper(self, model, mesh) -> ParallelWrapper:
        raise NotImplementedError


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Sync parameter averaging every ``averaging_frequency`` iterations
    (reference ``ParameterAveragingTrainingMaster.Builder``)."""

    def __init__(self, averaging_frequency: int = 5,
                 batch_size_per_worker: int = 32,
                 average_updaters: bool = True,
                 prefetch_num_batches: int = 2):
        self.averaging_frequency = int(averaging_frequency)
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.average_updaters = bool(average_updaters)
        self.prefetch_num_batches = int(prefetch_num_batches)

    def build_wrapper(self, model, mesh):
        return ParallelWrapper(
            model, training_mode=TrainingMode.AVERAGING,
            averaging_frequency=self.averaging_frequency,
            average_updaters=self.average_updaters,
            prefetch_buffer=self.prefetch_num_batches, mesh=mesh)


class SharedTrainingMaster(TrainingMaster):
    """Per-iteration gradient sharing (reference ``SharedTrainingMaster``).
    ``threshold=0`` selects the exact dense all-reduce; a nonzero
    threshold the reference's compressed semantics (±tau flips + local
    residuals, adaptive tau)."""

    def __init__(self, threshold: float = 0.0,
                 threshold_algorithm: Optional[ThresholdAlgorithm] = None,
                 batch_size_per_worker: int = 32,
                 prefetch_num_batches: int = 2):
        if threshold and threshold_algorithm is None:
            threshold_algorithm = AdaptiveThresholdAlgorithm(threshold)
        self.threshold_algorithm = threshold_algorithm
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.prefetch_num_batches = int(prefetch_num_batches)

    def build_wrapper(self, model, mesh):
        return ParallelWrapper(
            model, training_mode=TrainingMode.SHARED_GRADIENTS,
            threshold_algorithm=self.threshold_algorithm,
            prefetch_buffer=self.prefetch_num_batches, mesh=mesh)


class SparkDl4jMultiLayer:
    """Cluster facade (reference ``SparkDl4jMultiLayer``). ``sc`` exists
    for API parity and is unused: membership comes from the process
    group."""

    def __init__(self, sc, network, training_master: TrainingMaster,
                 mesh=None):
        del sc  # parity only: no Spark context
        self.network = network
        self.training_master = training_master
        self.mesh = mesh if mesh is not None else mesh_mod.MeshConfig().build()
        self._wrapper = training_master.build_wrapper(network, self.mesh)

    def fit(self, data, labels=None, epochs: int = 1):
        """``data``: a DataSetIterator over THIS rank's partition, or raw
        feature / label arrays of this rank's partition, batched to
        ``batch_size_per_worker`` rows (one worker a process)."""
        if labels is not None or not hasattr(data, "reset"):
            from deeplearning4j_tpu_torch.datasets.iterators import (
                ArrayDataSetIterator,
            )

            bs = getattr(self.training_master, "batch_size_per_worker", 32)
            if labels is None:
                features, labels_arr = data
            else:
                features, labels_arr = data, labels
            data = ArrayDataSetIterator(np.asarray(features),
                                        np.asarray(labels_arr), batch=bs)
        return self._wrapper.fit(data, epochs=epochs)

    def evaluate(self, iterator):
        return self.network.evaluate(iterator)

    def get_network(self):
        return self.network

    @property
    def score(self):
        return self._wrapper.score_value


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference ``SparkComputationGraph``: the same machinery over a
    ComputationGraph."""


def global_batch(mesh, batch):
    """This rank's padded partition of a global batch (alias of
    :func:`parallel.mesh.shard_batch`, under the cluster-API name)."""
    return mesh_mod.shard_batch(mesh, batch)
