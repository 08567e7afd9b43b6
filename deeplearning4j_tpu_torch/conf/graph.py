"""ComputationGraph configuration: DAG of vertices + GraphBuilder DSL.

Reference: ``org.deeplearning4j.nn.conf.ComputationGraphConfiguration``
(+ ``#graphBuilder``) and the vertex confs in
``org.deeplearning4j.nn.conf.graph``: ``LayerVertex``, ``AttentionVertex``,
``ElementWiseVertex``, ``MergeVertex``, ``SubsetVertex``, ``ScaleVertex``,
``ShiftVertex``, ``L2NormalizeVertex``, ``StackVertex``, ``UnstackVertex``,
``ReshapeVertex`` and ``PreprocessorVertex``. Fields and ``@type`` tags are
the JAX package's, so a configuration written by either package loads in
the other.

Axes are the reference's. The port's images are logical NCHW, so the
feature axis of ``MergeVertex`` and ``SubsetVertex`` is dim 1 for a 4-D
input and the last dim otherwise (the JAX package's last NHWC axis either
way), and ``ReshapeVertex`` reshapes in the JAX package's NHWC element
order.

Vertex contract (multi-input generalization of ``conf.layers.Layer``):
- ``output_type(input_types: list) -> InputType``
- ``init(gen, input_types, dtype) -> params dict``
- ``init_state(input_types, dtype) -> state dict``
- ``forward(params, state, inputs: list) -> (y, state)`` (eval mode); a
  ``LayerVertex`` also takes the feature ``mask`` the graph propagates
- ``param_order()``: the flat-params order (serializer parity)
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import (
    CnnToFeedForwardPreProcessor,
    DenseLayer,
    Layer,
)
from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.conf.weights import WeightInit


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

    def regularized_param_keys(self) -> List[str]:
        return []

    def forward(self, params, state, inputs: List, train=False, gen=None):
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

    def regularized_param_keys(self):
        return self.layer.regularized_param_keys()

    def _layer_input(self, inputs, mask):
        """The layer's input (preprocessed) and its mask keywords."""
        x = inputs[0]
        if self.preprocessor is not None:
            x, _ = self.preprocessor.forward({}, {}, x)
        kw = ({"mask": mask} if mask is not None
              and getattr(self.layer, "uses_mask", False) else {})
        return x, kw

    def forward(self, params, state, inputs, train=False, gen=None,
                mask=None):
        """``mask``: the [batch, time] feature mask reaching this vertex;
        handed on only to a layer with ``uses_mask`` (the recurrent and
        attention layers), as the JAX package's LayerVertex does, so a
        GlobalPoolingLayer in a graph pools unmasked."""
        x, kw = self._layer_input(inputs, mask)
        return self.layer.forward(params, state, x, train=train, gen=gen,
                                  **kw)

    # recurrent carry pass-through (tBPTT, rnn_time_step): a LayerVertex
    # bears a carry iff its layer does (reference
    # ComputationGraph#rnnUpdateStateWithTBPTTState)
    @property
    def has_carry(self) -> bool:
        return getattr(self.layer, "has_carry", False)

    def zero_carry(self, batch: int, dtype=torch.float32, device=None):
        return self.layer.zero_carry(batch, dtype, device)

    def forward_with_carry(self, params, carry, inputs, train=False,
                           gen=None, mask=None):
        x, kw = self._layer_input(inputs, mask)
        return self.layer.forward_with_carry(params, carry, x, train=train,
                                             gen=gen, **kw)

    # score hook when wrapping an output layer (reference: output vertices
    # are LayerVertex over an IOutputLayer)
    def score(self, params, x, labels, mask=None):
        if self.preprocessor is not None:
            x, _ = self.preprocessor.forward({}, {}, x)
        return self.layer.score(params, x, labels, mask)

    def is_output(self) -> bool:
        return hasattr(self.layer, "score")


@serde.register
@dataclasses.dataclass
class AttentionVertex(GraphVertex):
    """Multi-head dot-product attention vertex (reference
    ``org.deeplearning4j.nn.conf.graph.AttentionVertex``). Inputs
    ``[queries, keys, values]`` or ``[queries, keys, values, key_mask]``:
    sequences ``[batch, time, size]``, the mask ``[batch, time_k]`` (valid
    where > 0; a ``[batch, time_k, 1]`` mask is squeezed). The port keeps
    the projections in torch's ``nn.Linear`` layout, ``Wq/Wk/Wv: [nHeads *
    headSize, nIn*]`` and ``Wo: [nOut, nHeads * headSize]`` (the JAX
    package's ``[nIn*, nHeads * headSize]`` / ``[nHeads * headSize, nOut]``
    transposed; ``util.convert`` maps them). The softmax(QK^T)V core runs
    the stock tier of :func:`ops.attention.dot_product_attention`, or, with
    ``use_kernels`` (``kernels.routing``), the flash kernel, as the JAX
    package's ``attention_impl="auto"`` dispatches to its flash kernel.

    ``streaming_window > 0`` (requires ``causal``): the vertex streams
    through ``rnn_time_step``, and threads across tBPTT segments, with a
    key/value cache of the last ``streaming_window`` steps as its carry:
    exact causal attention while the streamed history fits the window,
    sliding-window attention beyond it. 0 = whole-sequence attention only
    (``rnn_time_step`` refuses the vertex)."""

    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    project_input: bool = True
    weight_init: WeightInit = None  # set in __post_init__
    attention_impl: str = "auto"
    causal: bool = False
    streaming_window: int = 0

    def __post_init__(self):
        if self.weight_init is None:
            self.weight_init = WeightInit.XAVIER
        if self.streaming_window and not self.causal:
            raise ValueError(
                "AttentionVertex: streaming_window requires causal=True "
                "(non-causal attention reads future keys and cannot "
                "stream)")

    def _head_size(self, nq):
        return self.head_size or (self.n_out // self.n_heads)

    def streaming_safe(self) -> bool:
        # whole-sequence attention cannot stream; a causal KV-cache window
        # can (exact while the history fits streaming_window)
        return bool(self.causal and self.streaming_window > 0)

    @property
    def has_carry(self):
        return self.streaming_safe()

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        w = int(self.streaming_window)
        e = self.n_heads * (self.head_size or self.n_out // self.n_heads)
        return {"k": torch.zeros((batch, w, e), dtype=dtype, device=device),
                "v": torch.zeros((batch, w, e), dtype=dtype, device=device),
                "m": torch.zeros((batch, w), dtype=dtype, device=device)}

    def forward_with_carry(self, params, carry, inputs, train=False,
                           gen=None):
        """Chunked causal attention over the cached and the current keys
        and values: query i of the chunk sees every valid cached step and
        the chunk's steps <= i; the new carry keeps the last
        ``streaming_window`` steps. Scores materialize ``[B, H, Tc, W +
        Tc]`` (streamed chunks are small); a query that sees no valid key
        emits zeros."""
        from deeplearning4j_tpu_torch.conf.layers_attention import (
            _merge_heads,
            _split_heads,
        )

        q_in, k_in, v_in = inputs[0], inputs[1], inputs[2]
        mask = inputs[3] if len(inputs) > 3 else None
        if mask is not None and mask.ndim == 3:
            mask = mask[:, :, 0]
        if self.project_input:
            q = F.linear(q_in, params["Wq"], params["bq"])
            k = F.linear(k_in, params["Wk"], params["bk"])
            v = F.linear(v_in, params["Wv"], params["bv"])
        else:
            q, k, v = q_in, k_in, v_in
        b, tc, _ = q.shape
        w = int(self.streaming_window)
        chunk_m = (torch.ones((b, tc), dtype=q.dtype, device=q.device)
                   if mask is None else mask.to(q.dtype))
        kcat = torch.cat([carry["k"].to(k.dtype), k], dim=1)
        vcat = torch.cat([carry["v"].to(v.dtype), v], dim=1)
        mcat = torch.cat([carry["m"].to(q.dtype), chunk_m], dim=1)
        qh = _split_heads(q, self.n_heads)                  # [B, H, Tc, hs]
        kh = _split_heads(kcat, self.n_heads)
        vh = _split_heads(vcat, self.n_heads)
        scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        # the band: chunk query i sees the cached keys (j < W) and chunk
        # keys j <= i
        j = torch.arange(w + tc, device=q.device)[None, :]
        i = torch.arange(tc, device=q.device)[:, None]
        vis = (j <= w + i).to(q.dtype)[None, None] * mcat[:, None, None, :]
        scores = scores.masked_fill(vis <= 0, -1e30)
        any_vis = vis.amax(dim=-1, keepdim=True)
        o = (torch.softmax(scores, dim=-1) * any_vis) @ vh
        y = _merge_heads(o)
        if self.project_input:
            y = F.linear(y, params["Wo"], params["bo"])
        new_carry = {"k": kcat[:, -w:].to(carry["k"].dtype),
                     "v": vcat[:, -w:].to(carry["v"].dtype),
                     "m": mcat[:, -w:].to(carry["m"].dtype)}
        return y, new_carry

    def output_type(self, input_types):
        tq = input_types[0]
        ts = tq.timesteps if isinstance(tq, it.Recurrent) else -1
        # unprojected attention emits a weighted sum of the VALUES
        n = self.n_out if self.project_input else input_types[2].size
        return it.Recurrent(size=n, timesteps=ts)

    def init(self, gen, input_types, dtype=torch.float32):
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads == 1")
            return {}
        nq, nk, nv = (t.size for t in input_types[:3])
        e = self.n_heads * self._head_size(nq)
        wi = self.weight_init

        def w(n_o, n_i):
            return wi.init(gen, (n_o, n_i), n_i, n_o, dtype)

        return {
            "Wq": w(e, nq), "Wk": w(e, nk), "Wv": w(e, nv),
            "Wo": w(self.n_out, e),
            "bq": torch.zeros((e,), dtype=dtype),
            "bk": torch.zeros((e,), dtype=dtype),
            "bv": torch.zeros((e,), dtype=dtype),
            "bo": torch.zeros((self.n_out,), dtype=dtype),
        }

    def param_order(self):
        if not self.project_input:
            return []
        return ["Wq", "bq", "Wk", "bk", "Wv", "bv", "Wo", "bo"]

    def regularized_param_keys(self):
        return ["Wq", "Wk", "Wv", "Wo"] if self.project_input else []

    def forward(self, params, state, inputs, train=False, gen=None,
                use_kernels=False):
        from deeplearning4j_tpu_torch.conf.layers_attention import (
            _attn_core,
            _merge_heads,
            _split_heads,
        )

        q_in, k_in, v_in = inputs[0], inputs[1], inputs[2]
        mask = inputs[3] if len(inputs) > 3 else None
        if mask is not None and mask.ndim == 3:
            mask = mask[:, :, 0]
        if self.project_input:
            q = F.linear(q_in, params["Wq"], params["bq"])
            k = F.linear(k_in, params["Wk"], params["bk"])
            v = F.linear(v_in, params["Wv"], params["bv"])
        else:
            q, k, v = q_in, k_in, v_in
        o = _attn_core(_split_heads(q, self.n_heads),
                       _split_heads(k, self.n_heads),
                       _split_heads(v, self.n_heads), mask, self.causal,
                       self.attention_impl, train, use_kernels)
        y = _merge_heads(o)
        if self.project_input:
            y = F.linear(y, params["Wo"], params["bo"])
        return y, state


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

    def forward(self, params, state, inputs, train=False, gen=None):
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


def _feature_dim(x) -> int:
    """The reference's feature axis in the port's layout: channels (dim 1)
    of a logical NCHW image or NCDHW volume, else the last dim."""
    return 1 if x.ndim in (4, 5) else x.ndim - 1


@serde.register
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Reference ``MergeVertex``: concatenation along the feature axis
    (channels of an image, features of a dense or sequence input)."""

    def output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, it.Convolutional):
            return it.Convolutional(t0.height, t0.width,
                                    sum(t.channels for t in input_types))
        if isinstance(t0, it.Recurrent):
            return it.Recurrent(size=sum(t.size for t in input_types),
                                timesteps=t0.timesteps)
        return it.FeedForward(size=sum(t.arity() for t in input_types))

    def forward(self, params, state, inputs, train=False, gen=None):
        return torch.cat(inputs, dim=_feature_dim(inputs[0])), state


@serde.register
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Reference ``SubsetVertex``: features ``from_idx..to_idx``
    INCLUSIVE (the reference's interval) along the feature axis."""

    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t0 = input_types[0]
        if isinstance(t0, it.Convolutional):
            return it.Convolutional(t0.height, t0.width, n)
        if isinstance(t0, it.Recurrent):
            return it.Recurrent(size=n, timesteps=t0.timesteps)
        return it.FeedForward(size=n)

    def forward(self, params, state, inputs, train=False, gen=None):
        x = inputs[0]
        return x.narrow(_feature_dim(x), self.from_idx,
                        self.to_idx - self.from_idx + 1), state


@serde.register
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """Reference ``ScaleVertex``: ``y = scale_factor * x``."""

    scale_factor: float = 1.0

    def forward(self, params, state, inputs, train=False, gen=None):
        return inputs[0] * self.scale_factor, state


@serde.register
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """Reference ``ShiftVertex``: ``y = x + shift_factor``."""

    shift_factor: float = 0.0

    def forward(self, params, state, inputs, train=False, gen=None):
        return inputs[0] + self.shift_factor, state


@serde.register
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """Reference ``L2NormalizeVertex``: ``x / max(||x||_2, eps)`` over all
    non-batch dims of each example."""

    eps: float = 1e-8

    def forward(self, params, state, inputs, train=False, gen=None):
        x = inputs[0]
        dims = tuple(range(1, x.ndim))
        norm = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
        return x / torch.clamp(norm, min=self.eps), state


@serde.register
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Reference ``StackVertex``: concatenation along the BATCH axis (the
    dual of ``UnstackVertex``, for weight-shared towers)."""

    def forward(self, params, state, inputs, train=False, gen=None):
        return torch.cat(inputs, dim=0), state


@serde.register
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Reference ``UnstackVertex``: slice ``from_idx`` of ``stack_size``
    equal chunks along the batch axis."""

    from_idx: int = 0
    stack_size: int = 1

    def forward(self, params, state, inputs, train=False, gen=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step], state


@serde.register
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Reference ``ReshapeVertex``: reshape to ``new_shape`` (its first
    entry the batch placeholder -1) in the JAX package's element order: an
    image input is read in NHWC order and a 4-D ``new_shape`` is
    ``[-1, height, width, channels]``, returned as the port's logical NCHW
    image."""

    new_shape: Tuple[int, ...] = ()

    def output_type(self, input_types):
        s = self.new_shape
        if len(s) == 2:
            return it.FeedForward(size=s[1])
        if len(s) == 3:
            return it.Recurrent(size=s[2], timesteps=s[1])
        if len(s) == 4:
            return it.Convolutional(height=s[1], width=s[2], channels=s[3])
        raise ValueError(f"cannot infer InputType for reshape to {s}")

    def forward(self, params, state, inputs, train=False, gen=None):
        x = inputs[0]
        if x.ndim == 4:  # logical NCHW -> the reference's NHWC order
            x = x.permute(0, 2, 3, 1)
        y = x.reshape(tuple(self.new_shape))
        if y.ndim == 4:
            y = y.permute(0, 3, 1, 2)
        return y, state


@serde.register
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """Reference ``PreprocessorVertex``: a standalone InputPreProcessor."""

    preprocessor: Optional[Layer] = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def forward(self, params, state, inputs, train=False, gen=None):
        return self.preprocessor.forward({}, {}, inputs[0], train=train,
                                         gen=gen)


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

    def output_vertices(self) -> List[VertexSpec]:
        vmap = self.vertex_map()
        return [vmap[n] for n in self.network_outputs]

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
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

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

    def backprop_type(self, bp: BackpropType, fwd: int = 20,
                      back: int = 20) -> "GraphBuilder":
        """Reference ``GraphBuilder#backpropType`` (+ the tBPTT lengths:
        ``fit`` trains sequence batches with truncated BPTT)."""
        self._backprop_type = bp
        self._tbptt_fwd = fwd
        self._tbptt_back = back
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
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
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
