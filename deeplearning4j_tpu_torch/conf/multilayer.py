"""The NeuralNetConfiguration builder DSL, up to ``graph_builder()``.

Reference: ``org.deeplearning4j.nn.conf.NeuralNetConfiguration.Builder``
(global hyperparameter defaults). The serving slice ports the builder as
far as the ComputationGraph builder needs it; ``.list()`` and
``MultiLayerConfiguration`` land with the MultiLayerNetwork slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.layers import BaseLayer, Layer
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.conf.weights import WeightInit


@serde.register_enum
class BackpropType(enum.Enum):
    """Reference: ``org.deeplearning4j.nn.conf.BackpropType``."""

    STANDARD = "standard"
    TRUNCATED_BPTT = "tbptt"


class NeuralNetConfiguration:
    """Namespace for the builder (reference ``NeuralNetConfiguration``)."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """Global-defaults builder (reference ``NeuralNetConfiguration.Builder``).
    Fluent setters mirror the reference's names (snake_cased)."""

    def __init__(self):
        self._seed = 12345
        self._updater: IUpdater = Sgd()
        self._weight_init: Optional[WeightInit] = None
        self._activation = None
        self._dropout: Optional[float] = None
        self._dtype = "float32"
        self._compute_dtype: Optional[str] = None
        self._use_kernels = False

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def updater(self, u: IUpdater) -> "Builder":
        self._updater = u
        return self

    def weight_init(self, w: WeightInit) -> "Builder":
        self._weight_init = w
        return self

    def activation(self, a) -> "Builder":
        self._activation = a
        return self

    def dropout(self, retain_prob: float) -> "Builder":
        self._dropout = retain_prob
        return self

    def dtype(self, dt: str) -> "Builder":
        self._dtype = dt
        return self

    def compute_dtype(self, dt: Optional[str]) -> "Builder":
        """Mixed-precision compute dtype (usually "bfloat16"); params and
        BN statistics stay in ``dtype``."""
        self._compute_dtype = dt
        return self

    def use_kernels(self, enabled: bool = True) -> "Builder":
        """Route 1x1 conv / dense forwards through the hand-written
        ``matmul_bias_act`` kernel (``deeplearning4j_tpu_torch.kernels``)."""
        self._use_kernels = bool(enabled)
        return self

    def graph_builder(self):
        """Reference ``NeuralNetConfiguration.Builder#graphBuilder``."""
        from deeplearning4j_tpu_torch.conf.graph import GraphBuilder

        return GraphBuilder(self)


def apply_builder_defaults(b: Builder, layer: Layer) -> Layer:
    """Fill builder-level defaults into layer fields still at their
    dataclass defaults (reference: global conf inherited unless the layer
    overrides). Always returns a copy, so build() never mutates the
    caller's layer objects."""
    layer = dataclasses.replace(layer)
    if not isinstance(layer, BaseLayer):
        return layer
    cls_defaults = {f.name: f.default for f in dataclasses.fields(layer)
                    if f.default is not dataclasses.MISSING}
    if b._weight_init is not None and layer.weight_init == cls_defaults.get(
            "weight_init"):
        layer.weight_init = b._weight_init
    if b._activation is not None and layer.activation == cls_defaults.get(
            "activation"):
        layer.activation = b._activation
    if b._dropout is not None and layer.dropout == 0.0:
        layer.dropout = b._dropout
    return layer
