"""Sharding: the ZeRO optimizer-state layout behind
``ParallelWrapper(zero_optimizer=True)``.

The JAX package's rule tables and ``ShardingPlan`` (``sharding/rules.py``,
``sharding/plan.py``) wait for the sharding subsystem (ROADMAP A: "The
remainder, in dependency order").
"""

from deeplearning4j_tpu_torch.sharding.zero import ZeroSpec  # noqa: F401
