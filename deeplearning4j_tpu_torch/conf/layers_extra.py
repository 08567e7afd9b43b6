"""The rest of the reference's layer surface: 3-D convolution, pooling
and resizing, the 1-D pooling / resizing layers over sequences, the
depthwise and locally connected convolutions, PReLU, the elementwise
scale, Permute, RepeatVector and MaskLayer; and layer normalization,
learned position embeddings and the Graves bidirectional LSTM.

Counterparts of the JAX package's ``conf/layers_extra.py``, with the same
fields and ``@type`` tags, so configurations round-trip between the
packages. Layouts are the port's: a 3-D volume is a logical NCDHW tensor
in ``channels_last_3d`` memory (the JAX package's NDHWC bytes) and a
``Convolution3D``'s ``W`` is OIDHW; sequences are ``[batch, time,
features]`` in both packages. ``SAME`` padding is XLA's split, the odd
element on the high side, as in ``conf.layers_cnn``.

Weights the port keeps in the JAX package's layout: ``LocallyConnected2D``
``W [oh, ow, C*kh*kw, nOut]`` and ``b [oh, ow, nOut]`` (``F.unfold`` emits
each patch channel-major, C outer then kh, kw, as XLA's
``conv_general_dilated_patches`` does), ``LocallyConnected1D`` ``W [ot,
f*k, nOut]`` and ``b [ot, nOut]`` (f outer, k inner), ``PReLULayer``
``alpha`` and ``ElementWiseMultiplicationLayer`` ``W``/``b``. A
``DepthwiseConvolution2D``'s ``W`` is ``[C*mult, 1, kh, kw]`` (the JAX
package's ``[kh, kw, 1, C*mult]``), the layout of
``SeparableConvolution2D``'s depthwise stage, whose function it shares.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import BaseLayer, Layer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    ConvolutionMode,
    PoolingType,
    _same_pads,
    depthwise_conv2d,
    window_pool,
)
from deeplearning4j_tpu_torch.conf.layers_rnn import (
    Bidirectional,
    BidirectionalMode,
    GravesLSTM,
)


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _out3d(size, k, s, mode):
    if mode is ConvolutionMode.SAME:
        return -(-size // s)
    return (size - k) // s + 1


def _pads(shape, kernel, stride, mode):
    """``F.pad``-ordered (last axis first) padding of the trailing
    ``len(kernel)`` axes of ``shape``: XLA's SAME split, or none."""
    out = []
    for size, k, s in zip(reversed(shape[-len(kernel):]), reversed(kernel),
                          reversed(stride)):
        out += (_same_pads(size, k, s) if mode is ConvolutionMode.SAME
                else (0, 0))
    return tuple(out)


def _channels_last_3d(y):
    return y.contiguous(memory_format=torch.channels_last_3d)


# ---------------------------------------------------------------------------
# 3-D convolution, pooling and resizing
# ---------------------------------------------------------------------------

@serde.register
@dataclasses.dataclass
class Convolution3D(BaseLayer):
    """Reference ``Convolution3D``: NCDHW x OIDHW (the JAX package's NDHWC
    x DHWIO); ``fan_in = kd*kh*kw*in_c``."""

    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (1, 1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.SAME
    has_bias: bool = True

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional3D):
            raise ValueError(
                f"Convolution3D needs 3-D CNN input, got {input_type}")
        k, s = _triple(self.kernel_size), _triple(self.stride)
        m = self.convolution_mode
        return it.Convolutional3D(
            depth=_out3d(input_type.depth, k[0], s[0], m),
            height=_out3d(input_type.height, k[1], s[1], m),
            width=_out3d(input_type.width, k[2], s[2], m),
            channels=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        kd, kh, kw = _triple(self.kernel_size)
        in_c = input_type.channels
        w = self.weight_init.init(gen, (self.n_out, in_c, kd, kh, kw),
                                  kd * kh * kw * in_c,
                                  kd * kh * kw * self.n_out, dtype,
                                  self.distribution)
        p = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype)
        return p

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        k, s = _triple(self.kernel_size), _triple(self.stride)
        pads = _pads(x.shape, k, s, self.convolution_mode)
        b = params["b"] if self.has_bias else None
        if pads[0::2] == pads[1::2]:  # symmetric: the conv pads itself
            y = F.conv3d(x, params["W"], b, s, pads[0::2][::-1])
        else:
            y = F.conv3d(F.pad(x, pads), params["W"], b, s)
        return self.activation.apply(_channels_last_3d(y)), state


@serde.register
@dataclasses.dataclass
class Cnn3DToFeedForwardPreProcessor(Layer):
    """Reference ``Cnn3DToFeedForwardPreProcessor``: a volume flattened to
    ``[batch, d*h*w*c]`` in the JAX package's NDHWC order, so the dense
    weights after it carry over between the packages."""

    depth: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type):
        return it.FeedForward(size=input_type.arity())

    def forward(self, params, state, x, train=False, gen=None):
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1), state


@serde.register
@dataclasses.dataclass
class Subsampling3DLayer(Layer):
    """Reference ``Subsampling3DLayer``: MAX / AVG / SUM / PNORM over
    ``kernel_size`` windows, ``conf.layers_cnn.window_pool``'s rules."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def output_type(self, input_type):
        k, s = _triple(self.kernel_size), _triple(self.stride)
        m = self.convolution_mode
        return it.Convolutional3D(
            depth=_out3d(input_type.depth, k[0], s[0], m),
            height=_out3d(input_type.height, k[1], s[1], m),
            width=_out3d(input_type.width, k[2], s[2], m),
            channels=input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        k, s = _triple(self.kernel_size), _triple(self.stride)
        pads = _pads(x.shape, k, s, self.convolution_mode)
        y = window_pool(x, self.pooling_type, k, s, pads, self.pnorm)
        return _channels_last_3d(y), state


@serde.register
@dataclasses.dataclass
class Upsampling3D(Layer):
    """Reference ``Upsampling3D``: each voxel repeated ``size`` times along
    depth, height and width."""

    size: Tuple[int, int, int] = (2, 2, 2)

    def output_type(self, input_type):
        sd, sh, sw = _triple(self.size)
        return it.Convolutional3D(
            depth=input_type.depth * sd, height=input_type.height * sh,
            width=input_type.width * sw, channels=input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        sd, sh, sw = _triple(self.size)
        y = x.repeat_interleave(sd, dim=2).repeat_interleave(
            sh, dim=3).repeat_interleave(sw, dim=4)
        return _channels_last_3d(y), state


@serde.register
@dataclasses.dataclass
class Cropping3D(Layer):
    """Reference ``Cropping3D``: ``cropping`` is ``(d0, d1, h0, h1, w0,
    w1)``, cut from the low and high side of each axis."""

    cropping: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def output_type(self, input_type):
        c = self.cropping
        return it.Convolutional3D(
            depth=input_type.depth - c[0] - c[1],
            height=input_type.height - c[2] - c[3],
            width=input_type.width - c[4] - c[5],
            channels=input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        c = self.cropping
        d, h, w = x.shape[2:]
        return x[:, :, c[0]:d - c[1], c[2]:h - c[3], c[4]:w - c[5]], state


@serde.register
@dataclasses.dataclass
class ZeroPadding3DLayer(Layer):
    """Reference ``ZeroPadding3DLayer``: ``padding`` is ``(d0, d1, h0, h1,
    w0, w1)`` zeros added on the low and high side of each axis."""

    padding: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)

    def output_type(self, input_type):
        p = self.padding
        return it.Convolutional3D(
            depth=input_type.depth + p[0] + p[1],
            height=input_type.height + p[2] + p[3],
            width=input_type.width + p[4] + p[5],
            channels=input_type.channels)

    def forward(self, params, state, x, train=False, gen=None):
        p = self.padding
        y = F.pad(x, (p[4], p[5], p[2], p[3], p[0], p[1]))
        return _channels_last_3d(y), state


# ---------------------------------------------------------------------------
# 1-D pooling and resizing over [batch, time, features]
# ---------------------------------------------------------------------------

class _TimeResizing(Layer):
    """A layer that windows or resizes the time axis without a carry:
    ``rnn_time_step`` would cut its windows at call boundaries."""

    def streaming_safe(self) -> bool:
        return False


@serde.register
@dataclasses.dataclass
class Subsampling1DLayer(_TimeResizing):
    """Reference ``Subsampling1DLayer``: pooling along time, the 2-D
    pooling's rules (``window_pool`` over ``[b, f, t, 1]``)."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: int = 2
    stride: int = 2
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def output_type(self, input_type):
        ts = input_type.timesteps
        if ts and ts > 0:
            ts = _out3d(ts, self.kernel_size, self.stride,
                        self.convolution_mode)
        return it.Recurrent(size=input_type.size, timesteps=ts)

    def _time_pads(self, t):
        return (_same_pads(t, self.kernel_size, self.stride)
                if self.convolution_mode is ConvolutionMode.SAME else (0, 0))

    def forward(self, params, state, x, train=False, gen=None):
        lo, hi = self._time_pads(x.shape[1])
        y = window_pool(x.transpose(1, 2)[..., None], self.pooling_type,
                        (self.kernel_size, 1), (self.stride, 1),
                        (0, 0, lo, hi), self.pnorm)
        return y[..., 0].transpose(1, 2), state

    def resize_mask(self, mask):
        """A ``[batch, time]`` mask through the pooling's time geometry:
        max-pooled, padding counting as 0 (reference
        ``feedForwardMaskArray``)."""
        lo, hi = self._time_pads(mask.shape[1])
        m = F.pad(mask[:, None, :], (lo, hi))
        return F.max_pool1d(m, self.kernel_size, self.stride)[:, 0].clamp(
            min=0.0)


@serde.register
@dataclasses.dataclass
class Upsampling1D(_TimeResizing):
    """Reference ``Upsampling1D``: each step repeated ``size`` times."""

    size: int = 2

    def output_type(self, input_type):
        ts = input_type.timesteps
        return it.Recurrent(size=input_type.size,
                            timesteps=ts * self.size if ts and ts > 0 else ts)

    def forward(self, params, state, x, train=False, gen=None):
        return x.repeat_interleave(self.size, dim=1), state

    def resize_mask(self, mask):
        return mask.repeat_interleave(self.size, dim=1)


@serde.register
@dataclasses.dataclass
class Cropping1D(_TimeResizing):
    """Reference ``Cropping1D``: ``cropping`` = (first, last) steps cut."""

    cropping: Tuple[int, int] = (0, 0)

    def output_type(self, input_type):
        a, b = _pair(self.cropping)
        ts = input_type.timesteps
        return it.Recurrent(size=input_type.size,
                            timesteps=ts - a - b if ts and ts > 0 else ts)

    def forward(self, params, state, x, train=False, gen=None):
        a, b = _pair(self.cropping)
        return x[:, a:x.shape[1] - b, :], state

    def resize_mask(self, mask):
        a, b = _pair(self.cropping)
        return mask[:, a:mask.shape[1] - b]


@serde.register
@dataclasses.dataclass
class ZeroPadding1DLayer(_TimeResizing):
    """Reference ``ZeroPadding1DLayer``: ``padding`` = (before, after)
    zero steps; the mask marks them invalid."""

    padding: Tuple[int, int] = (0, 0)

    def output_type(self, input_type):
        a, b = _pair(self.padding)
        ts = input_type.timesteps
        return it.Recurrent(size=input_type.size,
                            timesteps=ts + a + b if ts and ts > 0 else ts)

    def forward(self, params, state, x, train=False, gen=None):
        a, b = _pair(self.padding)
        return F.pad(x, (0, 0, a, b)), state

    def resize_mask(self, mask):
        a, b = _pair(self.padding)
        return F.pad(mask, (a, b))


# ---------------------------------------------------------------------------
# 2-D extras
# ---------------------------------------------------------------------------

@serde.register
@dataclasses.dataclass
class DepthwiseConvolution2D(BaseLayer):
    """Reference ``DepthwiseConvolution2D``: ``depth_multiplier`` filters
    per input channel, ``nOut = nIn * depth_multiplier``; ``W [C*mult, 1,
    kh, kw]``, ``fan_in = kh*kw``, as the JAX package draws it."""

    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    depth_multiplier: int = 1
    convolution_mode: ConvolutionMode = ConvolutionMode.SAME
    has_bias: bool = True

    def output_type(self, input_type):
        k, s = _pair(self.kernel_size), _pair(self.stride)
        m = self.convolution_mode
        return it.Convolutional(
            height=_out3d(input_type.height, k[0], s[0], m),
            width=_out3d(input_type.width, k[1], s[1], m),
            channels=input_type.channels * self.depth_multiplier)

    def init(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        n_out = input_type.channels * self.depth_multiplier
        w = self.weight_init.init(gen, (n_out, 1, kh, kw), kh * kw,
                                  kh * kw * self.depth_multiplier, dtype,
                                  self.distribution)
        p = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((n_out,), self.bias_init, dtype=dtype)
        return p

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        y = depthwise_conv2d(x, params["W"],
                             params["b"] if self.has_bias else None,
                             self.convolution_mode, self.kernel_size,
                             self.stride, (0, 0))
        return self.activation.apply(y), state


@serde.register
@dataclasses.dataclass
class LocallyConnected2D(BaseLayer):
    """Reference ``LocallyConnected2D``: a VALID convolution with its own
    weights at every output position. ``W [oh, ow, C*kh*kw, nOut]``, ``b
    [oh, ow, nOut]``; the patches (``F.unfold``, channel-major) meet ``W``
    in one batched product over the positions."""

    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    has_bias: bool = True

    def _out_hw(self, input_type):
        k, s = _pair(self.kernel_size), _pair(self.stride)
        return ((input_type.height - k[0]) // s[0] + 1,
                (input_type.width - k[1]) // s[1] + 1)

    def output_type(self, input_type):
        oh, ow = self._out_hw(input_type)
        return it.Convolutional(height=oh, width=ow, channels=self.n_out)

    def init(self, gen, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        oh, ow = self._out_hw(input_type)
        fan_in = kh * kw * input_type.channels
        w = self.weight_init.init(gen, (oh, ow, fan_in, self.n_out), fan_in,
                                  self.n_out, dtype, self.distribution)
        p = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((oh, ow, self.n_out), self.bias_init,
                                dtype=dtype)
        return p

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        w = params["W"]
        oh, ow, k, o = w.shape
        patches = F.unfold(x, _pair(self.kernel_size),
                           stride=_pair(self.stride))      # [b, k, oh*ow]
        y = torch.bmm(patches.permute(2, 0, 1),           # [oh*ow, b, k]
                      w.reshape(oh * ow, k, o))            # [oh*ow, b, o]
        y = y.permute(1, 0, 2).reshape(x.shape[0], oh, ow, o)
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y.permute(0, 3, 1, 2)), state


@serde.register
@dataclasses.dataclass
class LocallyConnected1D(BaseLayer):
    """Reference ``LocallyConnected1D`` over ``[batch, time, features]``:
    ``W [ot, f*k, nOut]`` (each patch feature-major), ``b [ot, nOut]``."""

    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    has_bias: bool = True

    def streaming_safe(self) -> bool:
        # per-position kernels window the time axis across call boundaries
        return False

    def _out_t(self, input_type):
        return (input_type.timesteps - self.kernel_size) // self.stride + 1

    def output_type(self, input_type):
        return it.Recurrent(size=self.n_out, timesteps=self._out_t(input_type))

    def init(self, gen, input_type, dtype=torch.float32):
        ot = self._out_t(input_type)
        fan_in = self.kernel_size * input_type.size
        w = self.weight_init.init(gen, (ot, fan_in, self.n_out), fan_in,
                                  self.n_out, dtype, self.distribution)
        p = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((ot, self.n_out), self.bias_init,
                                dtype=dtype)
        return p

    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        b_, _, f = x.shape
        patches = x.unfold(1, self.kernel_size, self.stride)  # [b, ot, f, k]
        ot = patches.shape[1]
        y = torch.bmm(patches.reshape(b_, ot, -1).transpose(0, 1),
                      params["W"])                          # [ot, b, o]
        y = y.transpose(0, 1)
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@serde.register
@dataclasses.dataclass
class PReLULayer(BaseLayer):
    """Reference ``PReLULayer``: ``max(0, x) + alpha * min(0, x)`` with a
    learned ``alpha`` (0.25 at init, not regularized): one a channel on
    image input (the port's axis 1), one an element on flat image input,
    one a feature otherwise."""

    def output_type(self, input_type):
        return input_type

    def _alpha_shape(self, input_type):
        if isinstance(input_type, (it.Convolutional, it.Convolutional3D)):
            return (input_type.channels,)
        if isinstance(input_type, it.ConvolutionalFlat):
            return (input_type.arity(),)
        return (input_type.size,)

    def init(self, gen, input_type, dtype=torch.float32):
        return {"alpha": torch.full(self._alpha_shape(input_type), 0.25,
                                    dtype=dtype)}

    def param_order(self):
        return ["alpha"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        a = params["alpha"]
        if x.ndim in (4, 5):  # NC(D)HW: one alpha a channel
            a = a.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0), state


@serde.register
@dataclasses.dataclass
class ElementWiseMultiplicationLayer(BaseLayer):
    """Reference ``ElementWiseMultiplicationLayer``: ``act(x * W + b)``
    with a learned per-feature scale (ones at init) and shift."""

    def output_type(self, input_type):
        return input_type

    def init(self, gen, input_type, dtype=torch.float32):
        n = input_type.size
        return {"W": torch.ones((n,), dtype=dtype),
                "b": torch.full((n,), self.bias_init, dtype=dtype)}

    def param_order(self):
        return ["W", "b"]

    def forward(self, params, state, x, train=False, gen=None):
        x = self._dropout_input(x, train, gen)
        return self.activation.apply(x * params["W"] + params["b"]), state


@serde.register
@dataclasses.dataclass
class Permute(Layer):
    """Permute the non-batch axes (Keras ``Permute``): ``dims`` are
    1-indexed over the JAX package's non-batch axes, ``(t, f)`` for a
    sequence and ``(h, w, c)`` for an image. On the port's NCHW image the
    result is the tensor whose NHWC view is the JAX package's output, a
    permutation that moves the channels into a spatial axis included."""

    dims: Tuple[int, ...] = ()

    def _perm(self, rank: int) -> Tuple[int, ...]:
        if sorted(self.dims) != list(range(1, rank)):
            raise ValueError(
                f"Permute dims {self.dims} must be a permutation of "
                f"1..{rank - 1} (1-indexed non-batch axes)")
        return (0,) + tuple(self.dims)

    def output_type(self, input_type):
        if isinstance(input_type, it.Recurrent):
            sizes = [input_type.timesteps, input_type.size]
            self._perm(3)
            out = [sizes[d - 1] for d in self.dims]
            if out[1] is not None and out[1] < 0:
                raise ValueError(
                    f"Permute {self.dims}: the variable-length time axis "
                    "(timesteps=-1) cannot become the feature axis — "
                    "downstream layers need a static feature size")
            return it.Recurrent(size=out[1], timesteps=out[0])
        if isinstance(input_type, it.Convolutional):
            sizes = [input_type.height, input_type.width,
                     input_type.channels]
            self._perm(4)
            out = [sizes[d - 1] for d in self.dims]
            return it.Convolutional(height=out[0], width=out[1],
                                    channels=out[2])
        raise ValueError(
            f"Permute supports Recurrent/Convolutional input, got "
            f"{input_type}")

    def forward(self, params, state, x, train=False, gen=None):
        perm = self._perm(x.ndim)
        if x.ndim != 4:
            return x.permute(perm), state
        # NCHW -> the NHWC view, permuted as the JAX package does, -> NCHW
        nhwc = x.permute(0, 2, 3, 1).permute(perm)
        return nhwc.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), state


@serde.register
@dataclasses.dataclass
class RepeatVector(Layer):
    """Reference ``RepeatVector``: ``[batch, size] -> [batch, n, size]``."""

    repetition_factor: int = 1

    def output_type(self, input_type):
        return it.Recurrent(size=input_type.size,
                            timesteps=self.repetition_factor)

    def forward(self, params, state, x, train=False, gen=None):
        return x[:, None, :].repeat(1, self.repetition_factor, 1), state


@serde.register
@dataclasses.dataclass
class MaskLayer(Layer):
    """Reference ``util.MaskLayer``: the masked steps of a ``[batch, time,
    features]`` input set to zero (the identity without a mask)."""

    uses_mask = True

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        if mask is None:
            return x, state
        return x * mask.to(device=x.device, dtype=x.dtype)[:, :, None], state


@serde.register
@dataclasses.dataclass
class LayerNormalization(BaseLayer):
    """Layer normalization over the last (feature) axis with learnable
    ``gain`` / ``b``: ``(x - mean) * rsqrt(var + eps) * gain + b``, the
    biased variance, as the JAX package computes it."""

    eps: float = 1e-5

    def output_type(self, input_type):
        return input_type

    def _n(self, input_type):
        if isinstance(input_type, (it.Convolutional, it.Convolutional3D)):
            return input_type.channels
        return input_type.size

    def init(self, gen, input_type, dtype=torch.float32):
        n = self._n(input_type)
        return {"gain": torch.ones((n,), dtype=dtype),
                "b": torch.zeros((n,), dtype=dtype)}

    def param_order(self):
        return ["gain", "b"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * params["gain"] + params["b"], state


@serde.register
@dataclasses.dataclass
class PositionEmbeddingLayer(BaseLayer):
    """Learned absolute position embeddings added to a sequence
    ``[batch, time, size]``. Param ``P: [max_len, size]``; a sequence
    longer than ``max_len`` raises."""

    max_len: int = 512

    def output_type(self, input_type):
        return input_type

    def init(self, gen, input_type, dtype=torch.float32):
        n = input_type.size
        w = self.weight_init.init(gen, (self.max_len, n), self.max_len, n,
                                  dtype, self.distribution)
        return {"P": w * 0.02}

    def param_order(self):
        return ["P"]

    def regularized_param_keys(self):
        return []

    def forward(self, params, state, x, train=False, gen=None):
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds "
                             f"max_len={self.max_len}")
        return x + params["P"][None, :t, :], state


@serde.register
@dataclasses.dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """Reference ``GravesBidirectionalLSTM``: a bidirectional Graves LSTM
    with CONCAT combining (its own conf class for parity; the modern
    reference deprecates it for ``Bidirectional(GravesLSTM)``)."""

    n_out: int = 0
    forget_gate_bias_init: float = 1.0

    def __post_init__(self):
        if self.layer is None:
            self.layer = GravesLSTM(
                n_out=self.n_out,
                forget_gate_bias_init=self.forget_gate_bias_init)
        self.mode = BidirectionalMode.CONCAT
