"""Sharding: the ZeRO optimizer-state layout behind
``ParallelWrapper(zero_optimizer=True)``.

The JAX package's rule tables and ``ShardingPlan`` (``sharding/rules.py``,
``sharding/plan.py``) wait for ROADMAP A item 5.
"""

from deeplearning4j_tpu_torch.sharding.zero import ZeroSpec  # noqa: F401
