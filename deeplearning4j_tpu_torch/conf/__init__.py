"""Configuration DSL (reference: ``deeplearning4j-nn/.../nn/conf/``).

Configs are plain dataclasses whose JSON (see
:mod:`deeplearning4j_tpu_torch.serde`) is the contract between this package
and the JAX package: the same ``@type`` tags and fields on both sides.
"""

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.weights import WeightInit

# import the config modules for their serde tag registrations, so from_json
# works regardless of which entry point the user imported first
from deeplearning4j_tpu_torch.conf import (  # noqa: E402,F401
    graph, layers, layers_attention, layers_cnn, layers_extra, layers_quant,
    losses, multilayer, regularization, schedules, updaters,
)
