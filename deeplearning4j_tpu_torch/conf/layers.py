"""Layer configurations + their eval-mode forward passes.

Reference: config classes in ``org.deeplearning4j.nn.conf.layers`` and the
runtime impls in ``org.deeplearning4j.nn.layers``. As in the JAX package the
conf dataclass *is* the layer: fields and ``@type`` tags are the JAX
package's, so a configuration written by either package loads in the other.

Contract:

- ``output_type(input_type)``: shape inference.
- ``init(gen, input_type, dtype) -> params dict`` of CPU tensors drawn from
  the ``torch.Generator`` ``gen``.
- ``init_state(input_type, dtype) -> state dict`` (e.g. BN running stats).
- ``forward(params, state, x, train=False, gen=None) -> (y, new_state)``:
  ``train`` selects batch statistics and dropout; ``gen`` is the
  ``torch.Generator`` of the step's dropout draws (None = no dropout). A
  new state is computed outside the autograd graph.
- ``forward_sharded(params, state, x, split, axis, ...)`` (the dense and
  sequence-embedding layers here, ``ConvolutionLayer`` and
  ``SelfAttentionLayer``): the forward of this rank's slice of the
  layer's weights under a tensor-parallel plan, over the model subgroup
  (``parallel.tensor``: ``split`` says how the leaves are cut, ``axis``
  holds the operators);
- ``param_order()``: canonical parameter ordering;
  ``regularized_param_keys()``: the params the layer's weight
  regularization applies to (the others take ``regularization_bias``).

Layouts: CNN activations are logical NCHW tensors in ``channels_last``
memory (byte-identical to the JAX package's NHWC arrays); conv weights are
OIHW; dense weights are ``[nOut, nIn]`` (torch's ``nn.Linear`` layout, which
is K-contiguous for the ``matmul_bias_act`` kernel). ``util.convert`` maps
the JAX package's HWIO / ``[nIn, nOut]`` weights onto these.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.losses import ILossFunction, LossMCXENT
from deeplearning4j_tpu_torch.conf.regularization import Regularization
from deeplearning4j_tpu_torch.conf.updaters import IUpdater
from deeplearning4j_tpu_torch.conf.weights import Distribution, WeightInit


@serde.register_enum
class GradientNormalization(enum.Enum):
    """Reference: ``org.deeplearning4j.nn.conf.GradientNormalization``."""

    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "l2_per_param"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param"


@dataclasses.dataclass
class Layer:
    """Base layer conf (reference: ``org.deeplearning4j.nn.conf.layers.Layer``)."""

    name: Optional[str] = None

    def output_type(self, input_type):
        return input_type

    def init(self, gen, input_type, dtype=torch.float32) -> dict:
        return {}

    def init_state(self, input_type, dtype=torch.float32) -> dict:
        return {}

    def param_order(self) -> List[str]:
        return []

    def regularized_param_keys(self) -> List[str]:
        return ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        return x, state

    def has_params(self) -> bool:
        return bool(self.param_order())


@dataclasses.dataclass
class BaseLayer(Layer):
    """Layers with weights (reference ``BaseLayer``): common hyperparams.
    ``dropout`` is the reference's RETAIN probability applied to the layer
    INPUT in training (inverted dropout: kept values scale by 1/p); 0
    disables."""

    activation: Activation = Activation.IDENTITY
    weight_init: WeightInit = WeightInit.XAVIER
    bias_init: float = 0.0
    distribution: Optional[Distribution] = None
    updater: Optional[IUpdater] = None
    regularization: Tuple[Regularization, ...] = ()
    regularization_bias: Tuple[Regularization, ...] = ()
    dropout: float = 0.0
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0

    def _dropout_input(self, x, train, gen):
        return _inverted_dropout(x, self.dropout, train, gen)


def _inverted_dropout(x, keep: float, train: bool, gen):
    """Training with a generator: each value kept with probability
    ``keep`` (0 < keep < 1) and scaled by 1/keep, else 0; otherwise x."""
    if train and 0.0 < keep < 1.0 and gen is not None:
        u = torch.rand(x.shape, generator=gen, device=gen.device)
        mask = (u < keep).to(x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))
    return x


def promote(*tensors):
    """Cast tensors (None passes through) to their common dtype, as jnp's
    type promotion does: under a bf16 compute policy the output vertex
    keeps float32 params and receives bfloat16 activations."""
    dts = [t.dtype for t in tensors if t is not None]
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.promote_types(dt, d)
    return tuple(None if t is None else t.to(dt) for t in tensors)


def _fold_out_channels(layer, params, key, scale, shift, axis=0):
    """``params[key]`` (output channels on ``axis``: 0 for dense [nOut,
    nIn] and conv OIHW, 1 for a transposed conv's [in, out, kh, kw]) times
    ``scale`` and the bias ``b*scale + shift``, computed in float32 and
    stored in the weight's dtype; the layer gains a bias."""
    w = params[key]
    dt = w.dtype
    scale = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=w.device)
    view = [1] * w.ndim
    view[axis] = -1
    out = dict(params)
    out[key] = (w.float() * scale.reshape(view)).to(dt)
    b = params["b"].float() if layer.has_bias else 0.0
    out["b"] = (b * scale + shift).to(dt)
    return dataclasses.replace(layer, has_bias=True), out


def _local_dense(layer, act, params, state, x, train, gen, split, axis):
    """``layer`` cut to this rank's output rows (``act`` its activation)
    run as the unsharded layer runs: through ``kernels.maybe_forward``
    (row 1) under ``use_kernels``, else its own forward."""
    w = params["W"]
    local = dataclasses.replace(layer, n_out=int(w.shape[0]),
                                activation=act)
    p = {"W": w}
    if layer.has_bias:
        p["b"] = axis.local_bias(split, params, "b")
    if axis.use_kernels:
        from deeplearning4j_tpu_torch import kernels

        routed = kernels.maybe_forward(local, p, state, x, train, gen)
        if routed is not None:
            return routed[0]
    return local.forward(p, state, x, train=train, gen=gen)[0]


def _as_ff_size(input_type) -> int:
    if isinstance(input_type, it.FeedForward):
        return input_type.size
    if isinstance(input_type, (it.Convolutional, it.ConvolutionalFlat)):
        return input_type.arity()
    if isinstance(input_type, it.Recurrent):
        return input_type.size
    raise ValueError(f"cannot treat {input_type} as feed-forward input")


@serde.register
@dataclasses.dataclass
class DenseLayer(BaseLayer):
    """Fully connected (reference ``DenseLayer``). W: [nOut, nIn], b: [nOut]."""

    n_out: int = 0
    has_bias: bool = True

    def output_type(self, input_type):
        if isinstance(input_type, it.Recurrent):
            return it.Recurrent(size=self.n_out, timesteps=input_type.timesteps)
        return it.FeedForward(size=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _as_ff_size(input_type)
        w = self.weight_init.init(gen, (self.n_out, n_in), n_in, self.n_out,
                                  dtype, self.distribution)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return params

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        return self.activation.apply(self.pre_output(params, x)), state

    def pre_output(self, params, x):
        x, w, b = promote(x, params["W"], params.get("b"))
        return F.linear(x, w, b if self.has_bias else None)

    def fold_scale_shift(self, params, scale, shift):
        """Inference fold hook (``nn.inference_opt``): absorb a following
        per-output-channel affine ``y*scale + shift`` (an eval-mode batch
        norm) into W/b, in float32. Valid only when this layer's activation
        is IDENTITY — the caller checks. Returns ``(new_layer,
        new_params)``; a bias appears if the layer had none."""
        return _fold_out_channels(self, params, "W", scale, shift)

    # --- tensor parallel (parallel/tensor.py) --------------------------------
    def forward_sharded(self, params, state, x, split, axis, train=False,
                        gen=None):
        """This rank's slice of the layer. Column-parallel (W's rows, the
        output features, split): the product of this rank's rows on the
        whole input (row 1 where the unsharded layer routes there), the
        replicated bias sliced to them, then the features of every rank
        gathered, after an elementwise activation or before any other (or
        left split for a row-parallel consumer). Row-parallel (W's columns
        split): this rank's input features (already split, or sliced),
        the partial products summed over the model ranks, then the bias
        and the activation."""
        if split.kind == "column":
            pointwise = self.activation is not Activation.SOFTMAX
            act = self.activation if pointwise else Activation.IDENTITY
            y = _local_dense(self, act, params, state,
                             axis.into(x), train, gen, split, axis)
            if split.keep_out:
                return y, state
            y = axis.gather(y)
            return (y if pointwise else self.activation.apply(y)), state
        x = self._dropout_input(x, train, gen)
        return self.activation.apply(self._row_pre(params, x, split,
                                                   axis)), state

    def _row_pre(self, params, x, split, axis):
        if not split.split_in:
            x = axis.scatter(x)
        x, w, b = promote(x, params["W"], params.get("b"))
        z = axis.reduce(F.linear(x, w))
        return z + b if self.has_bias else z

    def pre_output_sharded(self, params, x, split, axis):
        """:meth:`pre_output` of this rank's slice, whole."""
        if split.kind == "column":
            x, w = promote(axis.into(x), params["W"])
            b = axis.local_bias(split, params, "b") if self.has_bias \
                else None
            return axis.gather(F.linear(x, w, None if b is None
                                        else b.to(w.dtype)))
        return self._row_pre(params, x, split, axis)


@serde.register
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (reference ``OutputLayer``). The network scores
    with :meth:`score` on the pre-activations, so the loss can take its
    fused form (log-softmax for MCXENT)."""

    loss_fn: ILossFunction = dataclasses.field(default_factory=LossMCXENT)
    activation: Activation = Activation.SOFTMAX

    def score(self, params, x, labels, mask=None):
        z = self.pre_output(params, x)
        return self.loss_fn.score(labels, z, self.activation, mask)


@serde.register
@dataclasses.dataclass
class LossLayer(BaseLayer):
    """Reference ``LossLayer``: a loss without params (input size == label
    size): the activation, and the loss on the un-activated input."""

    loss_fn: ILossFunction = dataclasses.field(default_factory=LossMCXENT)

    def forward(self, params, state, x, train=False, gen=None):
        return self.activation.apply(x), state

    def score(self, params, x, labels, mask=None):
        return self.loss_fn.score(labels, x, self.activation, mask)

    def regularized_param_keys(self):
        return []


@serde.register
@dataclasses.dataclass
class EmbeddingLayer(BaseLayer):
    """Reference ``EmbeddingLayer``: integer ids ``[batch]`` or ``[batch,
    1]`` -> ``[batch, nOut]`` rows of W ``[nIn, nOut]`` (the JAX package's
    layout, one row per id), plus the bias when ``has_bias``. The gradient
    of W is a scatter-add of the output gradient into the looked-up rows
    (``F.embedding``'s backward). An out-of-range id raises, as in
    ``EmbeddingSequenceLayer`` (a jnp gather would clamp it)."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False

    def output_type(self, input_type):
        return it.FeedForward(size=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        w = self.weight_init.init(gen, (self.n_in, self.n_out), self.n_in,
                                  self.n_out, dtype, self.distribution)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype)
        return params

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        y = F.embedding(idx, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@serde.register
@dataclasses.dataclass
class EmbeddingSequenceLayer(BaseLayer):
    """Reference ``EmbeddingSequenceLayer``: token ids [batch, time] ->
    [batch, time, nOut]. W: [nIn, nOut] (one row per token id, the JAX
    package's layout and ``F.embedding``'s). Ids index W as ``long``; an
    out-of-range id raises (a jnp gather would clamp it)."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, input_type):
        ts = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(size=self.n_out, timesteps=ts)

    def init(self, gen, input_type, dtype=torch.float32):
        w = self.weight_init.init(gen, (self.n_in, self.n_out), self.n_in,
                                  self.n_out, dtype, self.distribution)
        return {"W": w}

    def param_order(self):
        return ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        y = F.embedding(x.long(), params["W"])
        return self.activation.apply(y), state

    def forward_sharded(self, params, state, x, split, axis, train=False,
                        gen=None):
        """This rank's columns of the table (its share of the output
        features): looked up, then every rank's gathered."""
        y = axis.gather(F.embedding(x.long(), params["W"]))
        return self.activation.apply(y), state


@serde.register
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Reference ``ActivationLayer``: applies an activation, no params."""

    activation: Activation = Activation.RELU

    def forward(self, params, state, x, train=False, gen=None):
        return self.activation.apply(x), state


@serde.register
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Reference ``DropoutLayer``; ``dropout`` = retain probability
    (inverted dropout in training; the identity in eval mode)."""

    dropout: float = 0.5

    def forward(self, params, state, x, train=False, gen=None):
        return _inverted_dropout(x, self.dropout, train, gen), state


@serde.register
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(Layer):
    """Reference ``CnnToFeedForwardPreProcessor``: CNN -> flat [batch, hwc],
    flattened in the JAX package's NHWC order so dense weights carry over."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type):
        return it.FeedForward(size=self.height * self.width * self.channels)

    def forward(self, params, state, x, train=False, gen=None):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), state


@serde.register
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(Layer):
    """Reference ``FeedForwardToCnnPreProcessor``: flat [batch, hwc] in the
    JAX package's NHWC element order -> a logical NCHW image in
    ``channels_last`` memory (the same bytes, so the permute is a view)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type):
        return it.Convolutional(self.height, self.width, self.channels)

    def forward(self, params, state, x, train=False, gen=None):
        y = x.reshape(x.shape[0], self.height, self.width, self.channels)
        return y.permute(0, 3, 1, 2), state


@serde.register
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(Layer):
    """Reference ``RnnToFeedForwardPreProcessor``: ``[b, t, f]`` kept as
    it is; the dense layers after it apply time-distributed (the reference
    reshapes to ``[b * t, f]``; a batched matmul is the same)."""

    def forward(self, params, state, x, train=False, gen=None):
        return x, state


@serde.register
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(Layer):
    """Reference ``FeedForwardToRnnPreProcessor``: the identity on the
    time-distributed ``[b, t, f]`` activations (its inverse above)."""

    def forward(self, params, state, x, train=False, gen=None):
        return x, state
