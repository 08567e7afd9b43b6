"""Collective communication layer of the data-parallel trainer.

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

The JAX package's ``comms/reshard.py`` (cross-mesh hand-offs) waits for
the sharding subsystem (ROADMAP A: "The remainder, in dependency
order").
"""

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
