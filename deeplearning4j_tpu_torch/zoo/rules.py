"""Partition-rule tables for the built-in zoo nets (the JAX package's
``zoo/rules.py``).

One table per architecture family, written against the zoo configs'
actual vertex/param paths (``"res2a_branch2a/W"``, ``"b0_attn/Wq"``,
``"4/W"`` for sequential nets) and the reference's layouts: dense/conv
KERNELS are tensor-parallel split over the ``model`` axis, biases and
normalization parameters replicate. Every table ends with a
replicate-by-default catch-all, and :func:`plan_for` builds the table into a
``ShardingPlan`` with ``demote_indivisible=True``: classifier heads follow
``num_classes``, which a generic table cannot promise divides the ``model``
axis.

Usage (on 4 ranks)::

    from deeplearning4j_tpu_torch.zoo import rules as zoo_rules

    plan = zoo_rules.plan_for(zoo_rules.resnet_rules(), data=2, model=2)
    pw = ParallelWrapper(net, mesh=plan.mesh, partition_rules=plan)
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.sharding import ShardingPlan
from deeplearning4j_tpu_torch.sharding.rules import PartitionSpec as P

# split a rank-2 kernel's OUTPUT features / a rank-4 conv kernel's OUTPUT
# channels over the tensor-parallel axis (reference layouts)
DENSE_OUT = P(None, MODEL_AXIS)
DENSE_IN = P(MODEL_AXIS, None)
CONV_OUT = P(None, None, None, MODEL_AXIS)
REPLICATED = P()


def resnet_rules():
    """ResNet/VGG-family ComputationGraphs (ResNet50, VGG16/19,
    SqueezeNet, Darknet19, ...): conv kernels split on output channels,
    the dense head(s) on output features; biases / BN (gamma, beta,
    mean, var) replicated via the catch-all."""
    return [
        (r"(output|fc\d*)/W$", DENSE_OUT),
        (r"/W$", CONV_OUT),          # every remaining kernel is a conv
        (r".*", REPLICATED),
    ]


def transformer_rules():
    """``zoo.graphs.TransformerEncoder``: Megatron-style block split — QKV
    projections column-parallel, the attention output projection and second
    FFN matmul row-parallel (their input dim carries the split head/hidden
    features), embedding and classifier head column-parallel; LayerNorm
    and biases replicated."""
    return [
        (r"_attn/W[qkv]$", DENSE_OUT),
        (r"_attn/Wo$", DENSE_IN),
        (r"_ff1/W$", DENSE_OUT),
        (r"_ff2/W$", DENSE_IN),
        (r"(embed|output)/W$", DENSE_OUT),
        (r".*", REPLICATED),
    ]


def lenet_rules():
    """``zoo.models.LeNet`` (sequential — param paths are layer indices):
    conv kernels (layers 0/2) on output channels, dense + softmax head
    (layers 5/6) on output features."""
    return [
        (r"^[02]/W$", CONV_OUT),
        (r"^[56]/W$", DENSE_OUT),
        (r".*", REPLICATED),
    ]


def mlp_rules():
    """Any all-dense sequential net: every kernel column-parallel."""
    return [
        (r"/W$", DENSE_OUT),
        (r".*", REPLICATED),
    ]


def plan_for(rules, mesh=None, data: int = -1, model: int = 1
             ) -> ShardingPlan:
    """Rule table -> ``ShardingPlan`` on a DPxTP mesh, demoting indivisible
    dims (a demoted tensor replicates and shows up flagged in
    ``plan.explain()``)."""
    return ShardingPlan(rules, mesh=mesh, data=data, model=model,
                        demote_indivisible=True)
