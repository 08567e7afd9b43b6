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
        if train and 0.0 < self.dropout < 1.0 and gen is not None:
            keep = self.dropout
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
class ActivationLayer(Layer):
    """Reference ``ActivationLayer``: applies an activation, no params."""

    activation: Activation = Activation.RELU

    def forward(self, params, state, x, train=False, gen=None):
        return self.activation.apply(x), state


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
