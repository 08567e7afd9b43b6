"""MultiLayerConfiguration + the NeuralNetConfiguration builder DSL.

Reference: ``org.deeplearning4j.nn.conf.NeuralNetConfiguration.Builder``
(global hyperparameter defaults) -> ``.list()`` (``ListBuilder``) ->
``MultiLayerConfiguration``, or ``.graph_builder()`` for a
ComputationGraph. ``set_input_type`` drives nIn inference and inserts the
CNN -> feed-forward flatten where a dense layer follows a convolutional
one, as the reference's ``MultiLayerConfiguration.Builder#inputType`` and
the JAX package do. Fields and ``@type`` tags are the JAX package's, so
the JSON round-trips between the two.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import (
    BaseLayer,
    CnnToFeedForwardPreProcessor,
    DenseLayer,
    FeedForwardToCnnPreProcessor,
    Layer,
)
from deeplearning4j_tpu_torch.conf.regularization import (
    L1Regularization,
    L2Regularization,
    Regularization,
)
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.conf.weights import WeightInit


@serde.register_enum
class BackpropType(enum.Enum):
    """Reference: ``org.deeplearning4j.nn.conf.BackpropType``."""

    STANDARD = "standard"
    TRUNCATED_BPTT = "tbptt"


@serde.register
@dataclasses.dataclass
class MultiLayerConfiguration:
    """The serializable sequential model definition (reference
    ``MultiLayerConfiguration``). ``compute_dtype``: the mixed-precision
    compute dtype (params stay in ``dtype``); ``use_kernels``: route layer
    forwards through the hand-written kernels (``kernels.routing``);
    ``quantization``: the ``conf.layers_quant.QuantizationSpec`` stamped by
    ``nn.inference_opt.quantize_for_inference`` on the artifact it emits,
    never set by the builder. ``gradient_checkpointing`` recomputes each
    layer's activations in the backward (``torch.utils.checkpoint``);
    ``backprop_type`` and the tBPTT lengths select truncated BPTT in ``fit``
    (``nn.multilayer``) and round-trip through the JSON."""

    layers: Tuple[Layer, ...] = ()
    input_type: Optional[object] = None
    seed: int = 12345
    updater: IUpdater = dataclasses.field(default_factory=Sgd)
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    gradient_checkpointing: bool = False
    use_kernels: bool = False
    quantization: Optional[object] = None

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = serde.from_json(s)
        if not isinstance(obj, MultiLayerConfiguration):
            raise TypeError(f"JSON is a {type(obj).__name__}, "
                            "not MultiLayerConfiguration")
        return obj

    def input_types(self) -> List[object]:
        """Per-layer input InputType list (shape inference pass)."""
        if self.input_type is None:
            raise ValueError(
                "MultiLayerConfiguration requires input_type for shape "
                "inference (reference: setInputType / explicit nIn)")
        types = []
        cur = self.input_type
        for layer in self.layers:
            types.append(cur)
            cur = layer.output_type(cur)
        return types

    def output_types(self) -> List[object]:
        types = self.input_types()
        return types[1:] + [self.layers[-1].output_type(types[-1])]


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
        self._regularization: List[Regularization] = []
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

    def l2(self, v: float) -> "Builder":
        """L2 weight regularization for every layer that sets none."""
        self._regularization.append(L2Regularization(l2=v))
        return self

    def l1(self, v: float) -> "Builder":
        """L1 weight regularization for every layer that sets none."""
        self._regularization.append(L1Regularization(l1=v))
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
        """Route layer forwards through the hand-written kernels
        (``deeplearning4j_tpu_torch.kernels.routing``)."""
        self._use_kernels = bool(enabled)
        return self

    def list(self) -> "ListBuilder":
        """Reference ``NeuralNetConfiguration.Builder#list``."""
        return ListBuilder(self)

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
        # wrappers (Bidirectional, LastTimeStep, MaskZeroLayer): the
        # defaults reach the wrapped layer
        inner = getattr(layer, "layer", None)
        if isinstance(inner, Layer):
            layer.layer = apply_builder_defaults(b, inner)
            if hasattr(layer, "__post_init__"):
                layer.__post_init__()
        return layer
    cls_defaults = {f.name: f.default for f in dataclasses.fields(layer)
                    if f.default is not dataclasses.MISSING}
    if b._weight_init is not None and layer.weight_init == cls_defaults.get(
            "weight_init"):
        layer.weight_init = b._weight_init
    if b._activation is not None and layer.activation == cls_defaults.get(
            "activation"):
        layer.activation = b._activation
    if b._regularization and not layer.regularization:
        layer.regularization = tuple(b._regularization)
    if b._dropout is not None and layer.dropout == 0.0:
        layer.dropout = b._dropout
    return layer


class ListBuilder:
    """Reference ``NeuralNetConfiguration.ListBuilder``."""

    def __init__(self, base: Builder):
        self._base = base
        self._layers: List[Layer] = []
        self._input_type = None
        self._backprop_type = BackpropType.STANDARD
        self._grad_checkpoint = False
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, conf: Layer) -> "ListBuilder":
        self._layers.append(conf)
        return self

    def set_input_type(self, input_type) -> "ListBuilder":
        self._input_type = input_type
        return self

    def gradient_checkpointing(self, enabled: bool = True) -> "ListBuilder":
        """Recompute per-layer activations during the backward instead of
        storing them."""
        self._grad_checkpoint = bool(enabled)
        return self

    def backprop_type(self, bp: BackpropType, fwd: int = 20,
                      back: int = 20) -> "ListBuilder":
        self._backprop_type = bp
        self._tbptt_fwd = fwd
        self._tbptt_back = back
        return self

    def build(self) -> MultiLayerConfiguration:
        if self._input_type is None:
            raise ValueError(
                "set_input_type(...) is required: layers infer nIn from the "
                "InputType chain (reference: setInputType / explicit nIn)")
        layers = [apply_builder_defaults(self._base, l) for l in self._layers]
        layers = _insert_preprocessors(layers, self._input_type)
        for i, l in enumerate(layers):
            if l.name is None:
                l.name = f"layer{i}"
        b = self._base
        return MultiLayerConfiguration(
            layers=tuple(layers), input_type=self._input_type, seed=b._seed,
            updater=b._updater, backprop_type=self._backprop_type,
            gradient_checkpointing=self._grad_checkpoint,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back, dtype=b._dtype,
            compute_dtype=b._compute_dtype, use_kernels=b._use_kernels)


def _insert_preprocessors(layers: List[Layer], input_type) -> List[Layer]:
    """Insert a ``CnnToFeedForwardPreProcessor`` where a dense layer
    follows CNN-shaped input and a ``FeedForwardToCnnPreProcessor`` where a
    convolution or pooling layer follows flat image input
    (``InputType.convolutional_flat``), as the reference's
    ``InputType#getPreProcessorForInputType`` in setInputType does; flat
    image input feeds any other layer as feed-forward. A dense layer after
    3-D CNN input gets a ``Cnn3DToFeedForwardPreProcessor``."""
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_extra import (
        Cnn3DToFeedForwardPreProcessor,
    )

    out: List[Layer] = []
    cur = input_type
    for layer in layers:
        if isinstance(cur, it.Convolutional) and isinstance(layer, DenseLayer):
            pre = CnnToFeedForwardPreProcessor(
                height=cur.height, width=cur.width, channels=cur.channels)
            out.append(pre)
            cur = pre.output_type(cur)
        if isinstance(cur, it.Convolutional3D) and isinstance(layer,
                                                              DenseLayer):
            pre = Cnn3DToFeedForwardPreProcessor(
                depth=cur.depth, height=cur.height, width=cur.width,
                channels=cur.channels)
            out.append(pre)
            cur = pre.output_type(cur)
        if isinstance(cur, it.ConvolutionalFlat):
            if isinstance(layer, (ConvolutionLayer, SubsamplingLayer)):
                pre = FeedForwardToCnnPreProcessor(
                    height=cur.height, width=cur.width, channels=cur.channels)
                out.append(pre)
                cur = pre.output_type(cur)
            else:
                cur = it.FeedForward(size=cur.arity())
        out.append(layer)
        cur = layer.output_type(cur)
    return out
