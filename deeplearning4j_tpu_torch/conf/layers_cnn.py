"""Convolutional / pooling / normalization layer configs.

Reference confs: ``ConvolutionLayer``, ``Convolution1DLayer``,
``SeparableConvolution2D``, ``Deconvolution2D``, ``SubsamplingLayer``,
``BatchNormalization``, ``LocalResponseNormalization``,
``GlobalPoolingLayer``, ``Upsampling2D``, ``ZeroPaddingLayer``,
``Cropping2D``, ``SpaceToDepthLayer``, ``CnnLossLayer`` and the JAX
package's ``FusedConvBN1x1`` (``org.deeplearning4j.nn.conf.layers``).
Fields and ``@type`` tags are the JAX package's. Tensors are logical NCHW
in ``channels_last`` memory; weights are OIHW (a ``Deconvolution2D``'s are
``[in, out, kh, kw]``, ``F.conv_transpose2d``'s layout; a
``Convolution1DLayer``'s ``[out, in, k]``, ``F.conv1d``'s).

``ConvolutionMode.SAME`` follows XLA, not PyTorch: the output is
``ceil(size / stride)`` and an odd total padding puts the extra element on
the HIGH side (the 7x7/2 ResNet stem at 224 pads (2, 3); the 3x3/2 max-pool
at 112 pads (0, 1) with -inf). ``nn.Conv2d(padding=...)`` pads symmetrically
and would shift every window, so asymmetric cases pad explicitly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.comms import global_batch
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import (
    BaseLayer,
    Layer,
    _as_ff_size,
    _fold_out_channels,
)
from deeplearning4j_tpu_torch.conf.losses import ILossFunction, LossMCXENT


@serde.register_enum
class ConvolutionMode(enum.Enum):
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


@serde.register_enum
class PoolingType(enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _out_size(size, k, s, p, mode: ConvolutionMode, dilation=1):
    eff_k = k + (k - 1) * (dilation - 1)
    if mode is ConvolutionMode.SAME:
        return -(-size // s)  # ceil
    out = (size + 2 * p - eff_k) // s + 1
    if mode is ConvolutionMode.STRICT and (size + 2 * p - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.STRICT: (size={size} + 2*pad={p} - kernel={eff_k})"
            f" not divisible by stride={s} (reference throws DL4JException here;"
            f" use TRUNCATE or SAME)"
        )
    return out


def _same_pads(size, k, s, dilation=1) -> Tuple[int, int]:
    """XLA's SAME split: (low, high) with the odd element on the high side."""
    eff_k = k + (k - 1) * (dilation - 1)
    total = max((-(-size // s) - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _window_pads(x, mode, kernel, stride, padding, dilation=(1, 1)):
    """F.pad-ordered (left, right, top, bottom) padding of an NCHW input."""
    (kh, kw), (sh, sw), (dh, dw) = _pair(kernel), _pair(stride), _pair(dilation)
    if mode is ConvolutionMode.SAME:
        top, bottom = _same_pads(x.shape[2], kh, sh, dh)
        left, right = _same_pads(x.shape[3], kw, sw, dw)
        return left, right, top, bottom
    ph, pw = _pair(padding)
    return pw, pw, ph, ph


@serde.register
@dataclasses.dataclass
class ConvolutionLayer(BaseLayer):
    """2D convolution (reference ``ConvolutionLayer``). Weights OIHW:
    [out_c, in_c, kh, kw]; fan_in = kh*kw*in_c (reference WeightInitUtil)."""

    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional):
            raise ValueError(
                f"{type(self).__name__} needs CNN input, got {input_type}")
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        return it.Convolutional(
            height=_out_size(input_type.height, kh, sh, ph, self.convolution_mode, dh),
            width=_out_size(input_type.width, kw, sw, pw, self.convolution_mode, dw),
            channels=self.n_out,
        )

    def init(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        in_c = input_type.channels
        w = self.weight_init.init(gen, (self.n_out, in_c, kh, kw), kh * kw * in_c,
                                  kh * kw * self.n_out, dtype, self.distribution)
        return self._with_bias({"W": w}, dtype)

    def _with_bias(self, params, dtype):
        """``params`` plus the bias ``b`` (``bias_init``) when ``has_bias``."""
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return params

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        left, right, top, bottom = _window_pads(
            x, self.convolution_mode, self.kernel_size, self.stride,
            self.padding, self.dilation)
        b = params["b"] if self.has_bias else None
        if (left, top) == (right, bottom):
            y = F.conv2d(x, params["W"], b, _pair(self.stride), (top, left),
                         _pair(self.dilation))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), params["W"], b,
                         _pair(self.stride), 0, _pair(self.dilation))
        return self.activation.apply(y), state

    def fold_scale_shift(self, params, scale, shift):
        """Inference fold hook (``nn.inference_opt``): absorb a following
        per-output-channel affine (an eval-mode BN) into W/b. OIHW weights
        put the output channel first. The caller guarantees the activation
        is IDENTITY."""
        return _fold_out_channels(self, params, "W", scale, shift)


def _conv1d_pads(size, mode, kernel, stride, padding) -> Tuple[int, int]:
    """(low, high) time padding of a ``Convolution1DLayer``: XLA's SAME
    split, or ``padding1d`` on both sides."""
    if mode is ConvolutionMode.SAME:
        return _same_pads(size, kernel, stride)
    return padding, padding


@serde.register
@dataclasses.dataclass
class Convolution1DLayer(ConvolutionLayer):
    """Reference ``Convolution1DLayer``: a convolution over the time axis
    of ``[batch, time, features]`` sequences (the JAX package's NWC; the
    reference's ``[b, f, t]``). W is ``[out, in, k]``; the input is
    transposed to ``F.conv1d``'s ``[b, f, t]`` and back."""

    kernel: int = 3
    stride1d: int = 1
    padding1d: int = 0

    def output_type(self, input_type):
        if not isinstance(input_type, it.Recurrent):
            raise ValueError(
                f"Convolution1DLayer needs sequence input, got {input_type}")
        t = input_type.timesteps
        if t > 0:
            t = _out_size(t, self.kernel, self.stride1d, self.padding1d,
                          self.convolution_mode)
        return it.Recurrent(size=self.n_out, timesteps=t)

    def init(self, gen, input_type, dtype=torch.float32):
        in_c = input_type.size
        w = self.weight_init.init(gen, (self.n_out, in_c, self.kernel),
                                  self.kernel * in_c, self.kernel * self.n_out,
                                  dtype, self.distribution)
        return self._with_bias({"W": w}, dtype)

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen).transpose(1, 2)
        lo, hi = _conv1d_pads(x.shape[2], self.convolution_mode, self.kernel,
                              self.stride1d, self.padding1d)
        b = params["b"] if self.has_bias else None
        y = F.conv1d(F.pad(x, (lo, hi)), params["W"], b, self.stride1d)
        return self.activation.apply(y.transpose(1, 2)), state

    def streaming_safe(self) -> bool:
        """``rnn_time_step`` cuts the sequence at arbitrary boundaries: a
        window spanning one would see zeros instead of the previous chunk's
        steps. Only a pointwise, unpadded, stride-1 conv is exact."""
        return (self.kernel == 1 and self.stride1d == 1
                and (self.convolution_mode is ConvolutionMode.SAME
                     or self.padding1d == 0))

    def resize_mask(self, mask):
        """A ``[batch, time]`` mask through this layer's time geometry
        (reference ``feedForwardMaskArray``): an output step is valid iff
        any input step in its window is, the mask max-pooled with the
        conv's kernel, stride and padding; padding counts as 0."""
        lo, hi = _conv1d_pads(mask.shape[1], self.convolution_mode,
                              self.kernel, self.stride1d, self.padding1d)
        m = F.pad(mask[:, None, :], (lo, hi))
        # the JAX package's reduce_window starts every window at 0.0
        return F.max_pool1d(m, self.kernel, self.stride1d)[:, 0].clamp(min=0.0)


@serde.register
@dataclasses.dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Reference ``SeparableConvolution2D``: a depthwise convolution
    (``depth_multiplier`` filters per input channel, ``groups = in_c``)
    then a pointwise 1x1. ``dW`` is ``[in_c * mult, 1, kh, kw]``: output
    channel ``c * mult + m`` is input channel ``c``'s ``m``-th filter, the
    order of XLA's grouped convolution. ``pW`` is ``[n_out, in_c * mult,
    1, 1]``. The depthwise stage takes the stride, dilation and padding
    (SAME: XLA's split, the odd element high)."""

    depth_multiplier: int = 1

    def init(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        in_c = input_type.channels
        mid = in_c * self.depth_multiplier
        dw = self.weight_init.init(gen, (mid, 1, kh, kw), kh * kw * in_c,
                                   kh * kw * mid, dtype, self.distribution)
        pw = self.weight_init.init(gen, (self.n_out, mid, 1, 1), mid,
                                   self.n_out, dtype, self.distribution)
        return self._with_bias({"dW": dw, "pW": pw}, dtype)

    def param_order(self):
        return ["dW", "pW", "b"] if self.has_bias else ["dW", "pW"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        pads = _window_pads(x, self.convolution_mode, self.kernel_size,
                            self.stride, self.padding, self.dilation)
        y = F.conv2d(F.pad(x, pads) if any(pads) else x, params["dW"], None,
                     _pair(self.stride), 0, _pair(self.dilation),
                     groups=x.shape[1])
        b = params["b"] if self.has_bias else None
        y = F.conv2d(y, params["pW"], b)
        return self.activation.apply(y), state

    def fold_scale_shift(self, params, scale, shift):
        """The affine folds into the pointwise kernel (the last product
        before the bias); the depthwise stage stays."""
        return _fold_out_channels(self, params, "pW", scale, shift)


@serde.register
@dataclasses.dataclass
class Deconvolution2D(ConvolutionLayer):
    """Reference ``Deconvolution2D`` (transposed convolution), the JAX
    package's function: a direct convolution over the stride-dilated
    input with the spatially flipped kernel, padded ``(k-1-p, k-1-p)``
    (TRUNCATE: output ``s*(i-1) + k - 2p``) or, for SAME (output ``i*s``),
    ``s + k - 2`` in all split ``pt // 2`` low and the rest high.

    W is ``[in, out, kh, kw]``, ``F.conv_transpose2d``'s layout, which
    computes that convolution unflipped: ``conv_transpose2d`` without
    padding is the full output (pads ``k - 1`` both sides), and the
    layer's output is cut out of it (or padded with zeros where a pad
    exceeds ``k - 1``). ``F.conv_transpose2d``'s own ``padding`` is
    symmetric with ``output_padding`` high only and below the stride, so
    it cannot express an odd ``s + k`` at stride 1. ``dilation`` is not
    applied, as in the JAX package."""

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode is ConvolutionMode.SAME:
            h = input_type.height * sh
            w = input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return it.Convolutional(height=h, width=w, channels=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        in_c = input_type.channels
        w = self.weight_init.init(gen, (in_c, self.n_out, kh, kw),
                                  kh * kw * in_c, kh * kw * self.n_out, dtype,
                                  self.distribution)
        return self._with_bias({"W": w}, dtype)

    def _pads(self):
        """The dilated input's (low, high) padding per spatial dim."""
        out = []
        for k, s, p in zip(_pair(self.kernel_size), _pair(self.stride),
                           _pair(self.padding)):
            if self.convolution_mode is ConvolutionMode.SAME:
                total = s + k - 2
                out.append((total // 2, total - total // 2))
            else:
                out.append((k - 1 - p, k - 1 - p))
        return out

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        kh, kw = _pair(self.kernel_size)
        (top, bottom), (left, right) = self._pads()
        full = F.conv_transpose2d(x, params["W"], None, _pair(self.stride))
        # F.pad with negative amounts cuts; the full output has pads k-1
        y = F.pad(full, (left - (kw - 1), right - (kw - 1),
                         top - (kh - 1), bottom - (kh - 1)))
        if self.has_bias:
            y = y + params["b"].reshape(1, -1, 1, 1)
        return self.activation.apply(_channels_last(y)), state

    def fold_scale_shift(self, params, scale, shift):
        """The output channel is W's axis 1."""
        return _fold_out_channels(self, params, "W", scale, shift, axis=1)


@serde.register
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling (reference ``SubsamplingLayer``). Padded positions never
    count: -inf for MAX, 0 for SUM/PNORM, excluded from AVG's divisor."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional):
            raise ValueError(f"SubsamplingLayer needs CNN input, got {input_type}")
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return it.Convolutional(
            height=_out_size(input_type.height, kh, sh, ph, self.convolution_mode),
            width=_out_size(input_type.width, kw, sw, pw, self.convolution_mode),
            channels=input_type.channels,
        )

    def forward(self, params, state, x, train=False, gen=None):
        k, s = _pair(self.kernel_size), _pair(self.stride)
        pads = _window_pads(x, self.convolution_mode, k, s, self.padding)

        def pad(v, value=0.0):
            return F.pad(v, pads, value=value) if any(pads) else v

        def window_sum(v):
            return F.avg_pool2d(pad(v), k, s, divisor_override=1)

        if self.pooling_type is PoolingType.MAX:
            y = F.max_pool2d(pad(x, float("-inf")), k, s)
        elif self.pooling_type is PoolingType.SUM:
            y = window_sum(x)
        elif self.pooling_type is PoolingType.AVG:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = window_sum(x) / window_sum(ones)
        elif self.pooling_type is PoolingType.PNORM:
            p = float(self.pnorm)
            y = window_sum(torch.abs(x) ** p) ** (1.0 / p)
        else:
            raise ValueError(f"unknown pooling type {self.pooling_type}")
        return y, state


def _channel_view(v, ndim):
    """Broadcast a per-channel [C] vector over an [N, C, ...] tensor."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def _bn_running_update(state, mean, var, decay):
    """decay*running + (1-decay)*batch — the reference's update rule, shared
    by BatchNormalization and FusedConvBN1x1. The batch statistics enter
    detached: the running state is never part of the autograd graph."""
    mean, var = mean.detach(), var.detach()
    return {"mean": decay * state["mean"] + (1 - decay) * mean,
            "var": decay * state["var"] + (1 - decay) * var}


def _bn_normalize(y32, mean, var, eps, gamma, beta):
    """(y-mean)*rsqrt(var+eps)*gamma + beta (gamma None = locked), in the
    JAX package's operation order."""
    nd = y32.ndim
    xhat = (y32 - _channel_view(mean, nd)) * torch.rsqrt(_channel_view(var, nd) + eps)
    if gamma is not None:
        xhat = xhat * _channel_view(gamma, nd) + _channel_view(beta, nd)
    return xhat


def _channel_axes(x):
    """Every axis but the channel axis (1) of an [N, C, ...] tensor."""
    return (0,) + tuple(range(2, x.ndim))


@serde.register
@dataclasses.dataclass
class BatchNormalization(BaseLayer):
    """Reference ``BatchNormalization``. Statistics are computed in the
    STATE dtype (f32 under a bf16 compute policy) and the output cast back
    to the input dtype. Train mode normalizes with one-pass batch
    statistics (``E[x^2] - E[x]^2``, clamped at 0) and returns the running
    mean/var moved by ``decay``; eval mode reads the running statistics."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    use_batch_mean_in_eval: bool = False  # reference's isMinibatch inverse

    def _n_features(self, input_type):
        if isinstance(input_type, it.Convolutional):
            return input_type.channels
        return _as_ff_size(input_type)

    def init(self, gen, input_type, dtype=torch.float32):
        n = self._n_features(input_type)
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.ones((n,), dtype=dtype),
                "beta": torch.zeros((n,), dtype=dtype)}

    def init_state(self, input_type, dtype=torch.float32):
        n = self._n_features(input_type)
        return {"mean": torch.zeros((n,), dtype=dtype),
                "var": torch.ones((n,), dtype=dtype)}

    def param_order(self):
        return [] if self.lock_gamma_beta else ["gamma", "beta"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        x32 = x.to(state["mean"].dtype)
        axes = _channel_axes(x32)
        new_state = state
        if train:
            # one pass: E[x] and E[x^2] in the same read of the activation
            # (over every rank's rows in exact data-parallel training)
            mean, ex2 = global_batch.batch_moments(x32, axes)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            new_state = _bn_running_update(state, mean, var, self.decay)
        elif self.use_batch_mean_in_eval:
            # reference isMinibatch=false: batch statistics at inference
            mean = x32.mean(dim=axes)
            var = x32.var(dim=axes, unbiased=False)
        else:
            mean, var = state["mean"], state["var"]
        locked = self.lock_gamma_beta
        xhat = _bn_normalize(x32, mean, var, self.eps,
                             None if locked else params["gamma"],
                             None if locked else params["beta"])
        return self.activation.apply(xhat).to(x.dtype), new_state


@serde.register
@dataclasses.dataclass
class FusedConvBN1x1(BaseLayer):
    """The JAX package's fused 1x1 convolution + batch norm: the function of
    ``ConvolutionLayer(kernel=(1,1), has_bias=False)`` followed by
    ``BatchNormalization(activation=self.activation)``, with the same
    params (W, gamma, beta) and running mean/var state.

    Train mode takes the BN statistics from the convolution's own output
    pass: ``ops.conv_fused.conv1x1_bn_stats`` (the ``matmul_stats``
    kernel) returns y with per-channel ``sum(y)`` and ``sum(y*y)``, and the
    variance is the one-pass ``E[y^2] - E[y]^2`` clamped at 0. The stock
    path (``F.conv2d`` and the same one-pass statistics) computes the same
    function. ``kernel_mode="auto"`` takes the kernel on a CUDA card for
    the shapes ``conv_fused.fusable`` admits; ``force_kernel`` takes it on
    any device (the plain version on the CPU). Eval mode reads the running
    statistics and always runs ``F.conv2d``. With ``conf.use_kernels`` the
    routing takes the kernel for every train-mode shape."""

    n_out: int = 0
    stride: Tuple[int, int] = (1, 1)
    decay: float = 0.9
    eps: float = 1e-5
    kernel_mode: str = "off"
    force_kernel: bool = False

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional):
            raise ValueError(f"FusedConvBN1x1 needs CNN input, got {input_type}")
        sh, sw = _pair(self.stride)
        return it.Convolutional(
            height=_out_size(input_type.height, 1, sh, 0, ConvolutionMode.SAME),
            width=_out_size(input_type.width, 1, sw, 0, ConvolutionMode.SAME),
            channels=self.n_out,
        )

    def init(self, gen, input_type, dtype=torch.float32):
        in_c = input_type.channels
        w = self.weight_init.init(gen, (self.n_out, in_c, 1, 1), in_c,
                                  self.n_out, dtype, self.distribution)
        return {"W": w,
                "gamma": torch.ones((self.n_out,), dtype=dtype),
                "beta": torch.zeros((self.n_out,), dtype=dtype)}

    def init_state(self, input_type, dtype=torch.float32):
        return {"mean": torch.zeros((self.n_out,), dtype=dtype),
                "var": torch.ones((self.n_out,), dtype=dtype)}

    def param_order(self):
        return ["W", "gamma", "beta"]

    def _use_kernel(self, m, cin, device):
        from deeplearning4j_tpu_torch.ops import conv_fused

        if not conv_fused.fusable(m, cin, self.n_out):
            return False
        return self.force_kernel or (self.kernel_mode != "off"
                                     and device.type == "cuda")

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        sh, sw = _pair(self.stride)
        xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
        b, cin, h, wd = xs.shape
        if train and self._use_kernel(b * h * wd, cin, x.device):
            return self.forward_kernel(params, state, x)
        y = F.conv2d(xs, params["W"])
        sdt = state["mean"].dtype
        new_state = state
        if train:
            # one-pass statistics, the kernel path's formulation
            mean, ex2 = global_batch.batch_moments(y.to(sdt), (0, 2, 3))
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            new_state = _bn_running_update(state, mean, var, self.decay)
        else:
            mean, var = state["mean"], state["var"]
        return self._normalize(params, y, mean, var, x.dtype), new_state

    def forward_kernel(self, params, state, x, tiling=None):
        """Train mode through ``matmul_stats`` (``x`` after dropout): the
        layer's kernel path and the routed path of ``conf.use_kernels``
        (which passes the registry's tuned ``tiling``)."""
        from deeplearning4j_tpu_torch.ops import conv_fused

        y, s, q = conv_fused.conv1x1_bn_stats(x, params["W"],
                                              _pair(self.stride), tiling)
        # exact data-parallel training sums s, q and the rows over ranks
        s, q, m = global_batch.global_sums(
            s, q, y.shape[0] * y.shape[2] * y.shape[3])
        sdt = state["mean"].dtype
        mean = (s / m).to(sdt)
        var = torch.clamp((q / m).to(sdt) - mean * mean, min=0.0)
        new_state = _bn_running_update(state, mean, var, self.decay)
        return self._normalize(params, y, mean, var, x.dtype), new_state

    def _normalize(self, params, y, mean, var, dtype):
        sdt = mean.dtype
        xhat = _bn_normalize(y.to(sdt), mean, var, self.eps,
                             params["gamma"].to(sdt), params["beta"].to(sdt))
        return self.activation.apply(xhat).to(dtype)


@serde.register
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Reference ``LocalResponseNormalization`` (AlexNet-era LRN):
    ``y = x / (k + alpha * s)**beta`` with ``s`` the sum of ``x**2`` over
    a window of ``n`` adjacent channels (dim 1), zero-padded by
    ``(n // 2, n - 1 - n // 2)`` as the JAX package pads its last axis."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def forward(self, params, state, x, train=False, gen=None):
        half = self.n // 2
        c = x.shape[1]
        sq = F.pad(x * x, (0, 0, 0, 0, half, self.n - 1 - half))
        s = sq[:, 0:c]
        for i in range(1, self.n):
            s = s + sq[:, i:i + c]
        return x / (self.k + self.alpha * s) ** self.beta, state


@serde.register
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Reference ``GlobalPoolingLayer``: CNN [b,c,h,w] -> [b,c] or sequence
    [b,t,f] -> [b,f]. A ``[b, t]`` mask on a sequence excludes the masked
    steps (the reference's masked pooling: max over the valid steps, which
    is -inf for a row with none; sum and pnorm of the masked input; the
    average over max(valid count, 1)). The layer has no ``uses_mask``, as in
    the JAX package, so a network hands it no mask: masked pooling is this
    method's, for a caller that passes one."""

    pooling_type: PoolingType = PoolingType.MAX

    def output_type(self, input_type):
        if isinstance(input_type, it.Convolutional):
            return it.FeedForward(size=input_type.channels)
        if isinstance(input_type, it.Recurrent):
            return it.FeedForward(size=input_type.size)
        return input_type

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        if mask is not None and x.ndim == 3:
            m = mask.to(device=x.device, dtype=x.dtype)[..., None]
            if self.pooling_type is PoolingType.MAX:
                y = torch.amax(torch.where(m > 0, x, float("-inf")), dim=1)
            elif self.pooling_type is PoolingType.SUM:
                y = torch.sum(x * m, dim=1)
            elif self.pooling_type is PoolingType.AVG:
                y = torch.sum(x * m, dim=1) / torch.clamp(m.sum(dim=1),
                                                          min=1.0)
            else:
                y = torch.sum(torch.abs(x * m) ** 2.0, dim=1) ** 0.5
            return y, state
        dims = (2, 3) if x.ndim == 4 else tuple(range(1, x.ndim - 1))
        if self.pooling_type is PoolingType.MAX:
            return torch.amax(x, dim=dims), state
        if self.pooling_type is PoolingType.SUM:
            return torch.sum(x, dim=dims), state
        if self.pooling_type is PoolingType.AVG:
            return torch.mean(x, dim=dims), state
        return torch.sum(torch.abs(x) ** 2.0, dim=dims) ** 0.5, state


def _channels_last(y):
    """A logical NCHW result in the port's ``channels_last`` memory."""
    return y.contiguous(memory_format=torch.channels_last)


@serde.register
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Reference ``ZeroPaddingLayer``: zero rows and columns around the
    image. ``padding`` is the reference's ``(top, bottom, left, right)``
    (``F.pad`` takes the last dimension first: ``(left, right, top,
    bottom)``)."""

    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)  # t, b, l, r

    def output_type(self, input_type):
        t, b, l, r = self.padding
        return it.Convolutional(input_type.height + t + b,
                                input_type.width + l + r, input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        t, b, l, r = self.padding
        return _channels_last(F.pad(x, (l, r, t, b))), state


@serde.register
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """Reference ``SpaceToDepthLayer``: each ``block_size`` x
    ``block_size`` block of pixels becomes one pixel with ``block_size**2``
    times the channels, in the JAX package's channel order: output channel
    ``(a * block_size + b) * C + ch`` holds input pixel ``(bs*i + a, bs*j +
    b)``, channel ``ch`` (the NHWC reshape/transpose of the reference, so a
    weight written for the JAX package applies unchanged)."""

    block_size: int = 2

    def output_type(self, input_type):
        bs = self.block_size
        return it.Convolutional(input_type.height // bs,
                                input_type.width // bs,
                                input_type.channels * bs * bs)

    def forward(self, params, state, x, train=False, gen=None):
        n, c, h, w = x.shape
        bs = self.block_size
        y = x.permute(0, 2, 3, 1).reshape(n, h // bs, bs, w // bs, bs, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // bs, w // bs,
                                                bs * bs * c)
        # NHWC-contiguous, so the NCHW view is channels_last already
        return y.permute(0, 3, 1, 2), state


@serde.register
@dataclasses.dataclass
class Upsampling2D(Layer):
    """Reference ``Upsampling2D``: nearest-neighbour repeat, each pixel
    ``size[0]`` times down and ``size[1]`` times across."""

    size: Tuple[int, int] = (2, 2)

    def output_type(self, input_type):
        sh, sw = _pair(self.size)
        return it.Convolutional(input_type.height * sh, input_type.width * sw,
                                input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        sh, sw = _pair(self.size)
        y = x.repeat_interleave(sh, dim=2).repeat_interleave(sw, dim=3)
        return _channels_last(y), state


@serde.register
@dataclasses.dataclass
class Cropping2D(Layer):
    """Reference ``Cropping2D``: ``cropping`` is ``(top, bottom, left,
    right)`` rows and columns cut from the image."""

    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)  # t, b, l, r

    def output_type(self, input_type):
        t, b, l, r = self.cropping
        return it.Convolutional(input_type.height - t - b,
                                input_type.width - l - r, input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        t, b, l, r = self.cropping
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t:h - b, l:w - r], state


@serde.register
@dataclasses.dataclass
class CnnLossLayer(Layer):
    """Reference ``CnnLossLayer``: the activation and loss per position
    of an image (UNet's segmentation head); no params. Both act on the
    NHWC view, so a softmax runs over the channels and labels (and a
    mask) arrive in the JAX package's ``[b, h, w, c]`` layout."""

    activation: Activation = Activation.IDENTITY
    loss_fn: ILossFunction = dataclasses.field(default_factory=LossMCXENT)

    def forward(self, params, state, x, train=False, gen=None):
        y = self.activation.apply(x.permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2), state

    def score(self, params, x, labels, mask=None):
        return self.loss_fn.score(labels, x.permute(0, 2, 3, 1),
                                  self.activation, mask)

    def regularized_param_keys(self):
        return []
