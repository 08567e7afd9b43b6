"""Declarative sharding subsystem (the JAX package's ``sharding/``).

- :mod:`~deeplearning4j_tpu_torch.sharding.rules` — regex-over-param-path
  -> ``PartitionSpec`` rule tables (``match_partition_rules``), written in
  the reference's layouts and mapped onto the port's storage, and
  optimizer-state spec cloning (``create_opt_spec``);
- :mod:`~deeplearning4j_tpu_torch.sharding.plan` — :class:`ShardingPlan`:
  a rule table bound to a composed DPxTP mesh of ranks, with per-rank
  placement, envelope-cache sharding keys, ``explain()`` debugging and
  per-rank byte accounting;
- :mod:`~deeplearning4j_tpu_torch.sharding.zero` — the flatten/pad/scatter
  layout behind ``ParallelWrapper(zero_optimizer=True)``'s ZeRO-style
  optimizer-state sharding.

``deeplearning4j_tpu_torch.zoo.rules`` ships rule tables for the built-in
nets; ``ParallelWrapper(partition_rules=...)`` trains under a plan.
"""

from deeplearning4j_tpu_torch.sharding.plan import (  # noqa: F401
    ShardingPlan,
    active_plans,
    plans_summary,
)
from deeplearning4j_tpu_torch.sharding.rules import (  # noqa: F401
    PartitionSpec,
    bytes_per_device,
    create_opt_spec,
    match_partition_rules,
    named_paths,
)
from deeplearning4j_tpu_torch.sharding.zero import ZeroSpec  # noqa: F401
