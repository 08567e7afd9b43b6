"""Post-training int8 quantized inference layers.

Counterpart of the JAX package's ``conf/layers_quant.py``: produced by
:func:`deeplearning4j_tpu_torch.nn.inference_opt.quantize_for_inference`,
never built by hand and never trained. The scheme is the dequant-free
affine fold:

- activations: per-input-channel asymmetric int8,
  ``xq = clip(round(x / xs + xz), -128, 127)`` with ``xs``/``xz``
  calibrated from observed ranges;
- weights: the per-channel activation scale is folded into the weight
  before quantizing (``W2 = diag(xs) @ W``), then per-output-channel
  symmetric int8 (``scale[n] = max|W2[:, n]| / 127``);
- the zero-point correction ``scale[n] * sum_k(xz_k * Wq[k, n])`` is folded
  into an effective bias at quantize time.

The forward is therefore ``act(float32(int32_dot(xq, Wq)) * scale + b)``:
one int8 product with a float32 epilogue. With ``conf.use_kernels`` the
routing runs it on the ``matmul_bias_act_int8`` kernel; the layers' own
forward (the stock route) runs the kernel's plain version.

Params (both layers), the JAX package's order and layouts: ``Wq`` int8
``[K, N]`` (the kernel's contract layout), ``scale`` f32 ``[N]``, ``b`` f32
``[N]`` (effective bias), ``xs`` f32 ``[K]``, ``xz`` f32 ``[K]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import BaseLayer, _as_ff_size


@serde.register
@dataclasses.dataclass
class QuantizationSpec:
    """Stamp on ``MultiLayerConfiguration.quantization`` identifying the
    calibration that produced a quantized artifact (``digest`` is the full
    sha256 of the calibration record)."""

    scheme: str = "int8"
    digest: str = ""
    seed: int = 0
    clip_percentile: float = 99.9


def quantize_input(x: torch.Tensor, xs: torch.Tensor,
                   xz: torch.Tensor) -> torch.Tensor:
    """float activations -> int8, per channel of the last axis (round half
    to even, as ``jnp.round``). Plain PyTorch on both routes: the kernel
    receives the already-int8 tensor."""
    q = torch.round(x.float() / xs + xz)
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def quant_pre_output(params, x: torch.Tensor) -> torch.Tensor:
    """The stock int8 forward of ``x [..., K]``: ``quantize_input``, then
    the exact int32 product with the float32 scale / bias epilogue
    (``impls.matmul_bias_act_int8_plain``); ``[..., N]`` float32."""
    from deeplearning4j_tpu_torch.kernels import impls

    xq = quantize_input(x, params["xs"], params["xz"])
    wq = params["Wq"]
    y = impls.matmul_bias_act_int8_plain(
        xq.reshape(-1, wq.shape[0]), wq, params["scale"], params["b"],
        Activation.IDENTITY)
    return y.reshape(x.shape[:-1] + (wq.shape[1],))


def _placeholder_params(n_in: int, n_out: int) -> dict:
    # shapes and dtypes only: quantize_for_inference or a weight import
    # (util.convert.params_from_jax) supplies the values
    return {
        "Wq": torch.zeros((n_in, n_out), dtype=torch.int8),
        "scale": torch.ones((n_out,), dtype=torch.float32),
        "b": torch.zeros((n_out,), dtype=torch.float32),
        "xs": torch.ones((n_in,), dtype=torch.float32),
        "xz": torch.zeros((n_in,), dtype=torch.float32),
    }


@serde.register
@dataclasses.dataclass
class QuantizedDenseLayer(BaseLayer):
    """int8 replacement for an eligible ``DenseLayer`` (post BN-fold)."""

    n_out: int = 0

    def output_type(self, input_type):
        return it.FeedForward(size=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        return _placeholder_params(_as_ff_size(input_type), self.n_out)

    def param_order(self):
        return ["Wq", "scale", "b", "xs", "xz"]

    def regularized_param_keys(self):
        return []  # inference only: never trained, never regularized

    def forward(self, params, state, x, train=False, gen=None):
        y = quant_pre_output(params, x)
        return self.activation.apply(y).to(x.dtype), state


@serde.register
@dataclasses.dataclass
class QuantizedConv1x1Layer(BaseLayer):
    """int8 replacement for an eligible 1x1 convolution (post BN-fold): a
    matmul over ``[B*H*W, Cin]`` after the stride subsample, as the
    routing's 1x1-conv path reshapes it."""

    n_out: int = 0
    stride: Tuple[int, int] = (1, 1)

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional):
            raise ValueError(
                f"{type(self).__name__} needs CNN input, got {input_type}")
        sh, sw = self.stride
        return it.Convolutional(
            height=-(-input_type.height // sh),
            width=-(-input_type.width // sw),
            channels=self.n_out,
        )

    def init(self, gen, input_type, dtype=torch.float32):
        return _placeholder_params(input_type.channels, self.n_out)

    def param_order(self):
        return ["Wq", "scale", "b", "xs", "xz"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        sh, sw = self.stride
        if (sh, sw) != (1, 1):
            x = x[:, :, ::sh, ::sw]
        b, cin, h, w = x.shape
        y = quant_pre_output(params, x.permute(0, 2, 3, 1).reshape(b * h * w,
                                                                    cin))
        y = y.reshape(b, h, w, self.n_out).permute(0, 3, 1, 2)
        return self.activation.apply(y).to(x.dtype), state
