"""Collective communication layer of the parallel trainer.

- :mod:`deeplearning4j_tpu_torch.comms.scheduler` — the
  :class:`CollectiveScheduler`: one planner owning bucket layout, issue
  order and per-bucket collective choice for every explicit exchange
  (``parallel.compression``'s ``bucketed_psum`` / ``bucketed_psum_scatter``
  / ``bucketed_all_gather`` are thin wrappers over its plans), on
  ``torch.distributed``. Plan digests equal the JAX package's for the
  same trees.
- :mod:`deeplearning4j_tpu_torch.comms.global_batch` — the global batch
  of exact data-parallel training: batch-norm statistics and loss
  denominators over every rank's rows.

- :mod:`deeplearning4j_tpu_torch.comms.reshard` — cross-mesh hand-offs by
  slice intersection: a live wrapper's training state onto another mesh
  shape, flat vectors re-cut between slice counts (the pod restore), and
  a live wrapper's params published into a serving engine.
"""

from deeplearning4j_tpu_torch.comms.reshard import (  # noqa: F401
    Placement,
    publish_to_engine,
    recut_flat,
    reshard,
    reshard_flat,
    reshard_training_state,
)
from deeplearning4j_tpu_torch.comms.scheduler import (  # noqa: F401
    CollectivePlan,
    CollectiveScheduler,
    bucket_layout,
    bucket_partition,
    exchange,
    lookup_plan,
    plan_for,
    reset,
    stats,
)
