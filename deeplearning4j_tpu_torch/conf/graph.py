"""ComputationGraph configuration: DAG of vertices + GraphBuilder DSL.

Reference: ``org.deeplearning4j.nn.conf.ComputationGraphConfiguration``
(+ ``#graphBuilder``) and the vertex confs in
``org.deeplearning4j.nn.conf.graph``. Fields and ``@type`` tags are the JAX
package's, so ``ResNet50().conf()`` JSON written there loads here. The
serving slice carries ``LayerVertex`` and ``ElementWiseVertex``; the other
vertex kinds land with the slices whose models use them.

Vertex contract (multi-input generalization of ``conf.layers.Layer``):
- ``output_type(input_types: list) -> InputType``
- ``init(gen, input_types, dtype) -> params dict``
- ``init_state(input_types, dtype) -> state dict``
- ``forward(params, state, inputs: list) -> (y, state)`` (eval mode)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import (
    CnnToFeedForwardPreProcessor,
    DenseLayer,
    Layer,
)
from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, Sgd


@dataclasses.dataclass
class GraphVertex:
    """Base vertex conf (reference ``org.deeplearning4j.nn.conf.graph
    .GraphVertex``)."""

    name: Optional[str] = None

    def output_type(self, input_types: List[object]):
        return input_types[0]

    def init(self, gen, input_types, dtype=torch.float32) -> dict:
        return {}

    def init_state(self, input_types, dtype=torch.float32) -> dict:
        return {}

    def param_order(self) -> List[str]:
        return []

    def forward(self, params, state, inputs: List):
        raise NotImplementedError

    def has_params(self) -> bool:
        return bool(self.param_order())


@serde.register
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """Wraps a layer conf as a single-input vertex (reference
    ``LayerVertex`` = layer + optional InputPreProcessor)."""

    layer: Optional[Layer] = None
    preprocessor: Optional[Layer] = None

    def _pre(self, input_types):
        t = input_types[0]
        return self.preprocessor.output_type(t) if self.preprocessor else t

    def output_type(self, input_types):
        return self.layer.output_type(self._pre(input_types))

    def init(self, gen, input_types, dtype=torch.float32):
        return self.layer.init(gen, self._pre(input_types), dtype)

    def init_state(self, input_types, dtype=torch.float32):
        return self.layer.init_state(self._pre(input_types), dtype)

    def param_order(self):
        return self.layer.param_order()

    def forward(self, params, state, inputs):
        x = inputs[0]
        if self.preprocessor is not None:
            x, _ = self.preprocessor.forward({}, {}, x)
        return self.layer.forward(params, state, x)


@serde.register_enum
class ElementWiseOp(enum.Enum):
    """Reference ``ElementWiseVertex.Op``."""

    ADD = "add"
    SUBTRACT = "subtract"
    PRODUCT = "product"
    AVERAGE = "average"
    MAX = "max"


@serde.register
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Reference ``ElementWiseVertex``: pointwise combine of same-shaped
    inputs (the residual-connection workhorse in ResNet50)."""

    op: ElementWiseOp = ElementWiseOp.ADD

    def forward(self, params, state, inputs):
        y = inputs[0]
        if self.op is ElementWiseOp.ADD:
            for x in inputs[1:]:
                y = y + x
        elif self.op is ElementWiseOp.SUBTRACT:
            if len(inputs) != 2:
                raise ValueError("SUBTRACT requires exactly 2 inputs")
            y = inputs[0] - inputs[1]
        elif self.op is ElementWiseOp.PRODUCT:
            for x in inputs[1:]:
                y = y * x
        elif self.op is ElementWiseOp.AVERAGE:
            y = sum(inputs) / float(len(inputs))
        elif self.op is ElementWiseOp.MAX:
            for x in inputs[1:]:
                y = torch.maximum(y, x)
        return y, state


@serde.register
@dataclasses.dataclass
class VertexSpec:
    """One named node in the DAG: vertex conf + its input vertex names."""

    name: str = ""
    vertex: Optional[GraphVertex] = None
    inputs: Tuple[str, ...] = ()


@serde.register
@dataclasses.dataclass
class ComputationGraphConfiguration:
    """The serializable DAG definition (reference
    ``ComputationGraphConfiguration``)."""

    network_inputs: Tuple[str, ...] = ()
    network_outputs: Tuple[str, ...] = ()
    vertices: Tuple[VertexSpec, ...] = ()
    input_types: Tuple[object, ...] = ()
    seed: int = 12345
    updater: IUpdater = dataclasses.field(default_factory=Sgd)
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"
    # mixed-precision compute dtype: the forward runs in this dtype while
    # params, BN statistics and the network outputs stay in ``dtype``
    compute_dtype: Optional[str] = None
    # route 1x1 conv / dense forwards through the hand-written
    # matmul_bias_act kernel (kernels/routing.py); default OFF
    use_kernels: bool = False

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = serde.from_json(s)
        if not isinstance(obj, ComputationGraphConfiguration):
            raise TypeError(f"JSON is a {type(obj).__name__}, "
                            "not ComputationGraphConfiguration")
        return obj

    def vertex_map(self) -> Dict[str, VertexSpec]:
        return {v.name: v for v in self.vertices}

    def topo_order(self) -> List[str]:
        """Topological vertex order (reference
        ``ComputationGraph#topologicalSortOrder``), deterministic: repeated
        scans emitting ready vertices in declaration order."""
        vmap = self.vertex_map()
        for v in self.vertices:
            for src in v.inputs:
                if src not in vmap and src not in self.network_inputs:
                    raise ValueError(
                        f"vertex {v.name!r} references unknown input {src!r}")
        order, done = [], set(self.network_inputs)
        pending = list(self.vertices)
        while pending:
            progressed = False
            remaining = []
            for v in pending:
                if all(src in done for src in v.inputs):
                    order.append(v.name)
                    done.add(v.name)
                    progressed = True
                else:
                    remaining.append(v)
            if not progressed:
                cyc = [v.name for v in remaining]
                raise ValueError(f"graph has a cycle involving {cyc}")
            pending = remaining
        return order

    def vertex_output_types(self) -> Dict[str, object]:
        """Shape-inference pass over the DAG."""
        if len(self.input_types) != len(self.network_inputs):
            raise ValueError(
                f"{len(self.network_inputs)} network inputs but "
                f"{len(self.input_types)} input types (setInputTypes)")
        types: Dict[str, object] = dict(zip(self.network_inputs,
                                            self.input_types))
        vmap = self.vertex_map()
        for name in self.topo_order():
            spec = vmap[name]
            types[name] = spec.vertex.output_type([types[s] for s in spec.inputs])
        return types


class GraphBuilder:
    """Reference ``ComputationGraphConfiguration.GraphBuilder`` (obtained
    via ``NeuralNetConfiguration.Builder#graph_builder``)."""

    def __init__(self, base):
        self._base = base  # conf.multilayer.Builder (global defaults)
        self._inputs: List[str] = []
        self._input_types: List[object] = []
        self._specs: List[VertexSpec] = []
        self._outputs: List[str] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types) -> "GraphBuilder":
        self._input_types.extend(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        self._specs.append(VertexSpec(name=name, vertex=LayerVertex(layer=layer),
                                      inputs=tuple(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._specs.append(VertexSpec(name=name, vertex=vertex,
                                      inputs=tuple(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        from deeplearning4j_tpu_torch.conf.multilayer import (
            apply_builder_defaults,
        )

        specs = []
        for s in self._specs:
            v = s.vertex
            if isinstance(v, LayerVertex):
                v = LayerVertex(layer=apply_builder_defaults(self._base, v.layer),
                                preprocessor=v.preprocessor)
            else:
                v = dataclasses.replace(v)
            v.name = s.name
            specs.append(VertexSpec(name=s.name, vertex=v, inputs=s.inputs))
        conf = ComputationGraphConfiguration(
            network_inputs=tuple(self._inputs),
            network_outputs=tuple(self._outputs),
            vertices=tuple(specs),
            input_types=tuple(self._input_types),
            seed=self._base._seed,
            updater=self._base._updater,
            dtype=self._base._dtype,
            compute_dtype=self._base._compute_dtype,
            use_kernels=self._base._use_kernels,
        )
        if self._input_types:
            _insert_graph_preprocessors(conf)
            conf.vertex_output_types()  # validate shape inference end-to-end
        return conf


def _insert_graph_preprocessors(conf: ComputationGraphConfiguration) -> None:
    """Auto-insert CNN->FF flatten preprocessors into LayerVertex where the
    incoming type is Convolutional but the layer is dense-like (reference:
    ``ComputationGraphConfiguration#addPreProcessors``). Mutates vertex
    confs in place (pre-serialization, during build only)."""
    types: Dict[str, object] = dict(zip(conf.network_inputs, conf.input_types))
    vmap = conf.vertex_map()
    for name in conf.topo_order():
        spec = vmap[name]
        v = spec.vertex
        in_types = [types[src] for src in spec.inputs]
        if (isinstance(v, LayerVertex) and v.preprocessor is None
                and in_types and isinstance(in_types[0], it.Convolutional)
                and isinstance(v.layer, DenseLayer)):
            t = in_types[0]
            v.preprocessor = CnnToFeedForwardPreProcessor(
                height=t.height, width=t.width, channels=t.channels)
        types[name] = v.output_type(in_types)
