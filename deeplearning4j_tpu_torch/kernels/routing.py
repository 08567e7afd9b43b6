"""Layer-to-kernel routing + the capability probe.

``maybe_forward(layer, ..., train, gen)`` is the dispatch point the graph
forward calls when ``conf.use_kernels`` is on. It takes the same qualifiers
as the JAX package's ``kernels/routing.py``:

- ``DenseLayer`` (2-D input) and 1x1 ``ConvolutionLayer`` → ``matmul_bias_act``,
  only for the layer's exact class forward (a subclass with its own forward
  is never rerouted) and an elementwise activation;
- the 1x1 conv only when pad-free (explicit padding would add zero rows) or
  SAME; a stride subsamples the input before the GEMM, so the output is
  ``ceil(h / s)`` by ``ceil(w / s)``;
- a missing bias (``has_bias=False``) is a zero bias;
- the int8 layers of a quantized artifact (``QuantizedDenseLayer`` on 2-D
  input, ``QuantizedConv1x1Layer`` on 4-D input, exact class forward,
  elementwise activation) → ``matmul_bias_act_int8``; the round / clip /
  cast of ``quantize_input`` stays plain PyTorch before the kernel, as the
  JAX package keeps it in XLA;
- ``FusedConvBN1x1`` in train mode → ``matmul_stats`` (the statistics pass
  fused into the conv's output pass); eval mode reads the running
  statistics and takes the stock forward;
- ``SelfAttentionLayer`` (3-D input, ``attention_impl`` auto or flash, a
  head size the kernels take) → the layer's own forward with the
  softmax(QK^T)V core on ``flash_attention``, so dropout, projections,
  activation and mask-zeroing stay single-sourced in the layer. The graph's
  feature ``mask`` rides through to it as the flash kernels' key mask; a
  masked input to any other layer is never routed (the JAX package's rule).
  ``flash_attention`` is an autograd Function whose backward is the dq and
  dk/dv kernels, so a routed train-mode forward trains on the card.

In a graph, an ``AttentionVertex`` (``attention_impl`` auto or flash, a
head size the kernels take) runs its own forward with the core on
``flash_attention`` too, its fourth input the key mask: the JAX package's
``attention_impl="auto"`` dispatches the vertex's core to its flash kernel.

The generation path routes through the functional twins
:func:`maybe_flash_attention` (prefill) and :func:`maybe_decode_attention`
(the paged single-token kernel), called from ``SelfAttentionLayer.prefill``
/ ``decode_step`` when the decoder runs with ``use_kernels``.

Dropout (train mode with a generator) masks the full input first, as the
layer's own forward does. The float GEMM kernels are differentiable, so a
routed forward trains; the int8 kernel serves only (quantized layers never
train). Anything else returns ``None`` and the caller runs the
stock forward. The JAX route takes its kernel only for a *tuned* envelope;
this port has no tuner yet, so the route takes the kernel for every shape
the qualifiers admit (the JAX package's tuned and stock paths agree, so no
output changes).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import impls

_CAPABILITY: Dict[int, str] = {}
_CAPABILITY_LOCK = threading.Lock()


def capability(device="cuda") -> str:
    """``"cpu"`` for the CPU (the wrappers run their plain versions), else
    ``"cuda"`` once the kernel library has built and the probe kernel has
    launched and returned ``x + 1`` on that card — checked once per card.
    A failure raises; the port never degrades to a slower path."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no kernels for device {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _CAPABILITY_LOCK:
        if index not in _CAPABILITY:
            x = torch.zeros((8, 128), dtype=torch.float32,
                            device=torch.device("cuda", index))
            y = impls.probe(x)
            if not torch.equal(y.cpu(), torch.ones((8, 128))):
                raise RuntimeError(
                    f"probe kernel on cuda:{index} did not return x + 1")
            _CAPABILITY[index] = "cuda"
        return _CAPABILITY[index]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _zero_bias(layer, x):
    return torch.zeros((layer.n_out,), dtype=x.dtype, device=x.device)


def _route_dense(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, promote

    if type(layer).forward is not DenseLayer.forward:
        return None  # a subclass with its own forward: never reroute it
    if x.ndim != 2 or not impls.elementwise(layer.activation):
        return None
    x = layer._dropout_input(x, train, gen)
    b = params["b"] if layer.has_bias else _zero_bias(layer, x)
    x, w, b = promote(x, params["W"], b)
    y = impls.matmul_bias_act(x.contiguous(), w, b, layer.activation)
    return y, state


def _route_conv1x1(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        ConvolutionMode,
    )

    if type(layer).forward is not ConvolutionLayer.forward:
        return None
    if x.ndim != 4 or not impls.elementwise(layer.activation):
        return None
    if _pair(layer.kernel_size) != (1, 1) or _pair(layer.dilation) != (1, 1):
        return None
    # a 1x1 conv reads no neighborhood, so explicit padding changes the
    # output (zero rows appear): only pad-free geometries are a pure
    # matmul. SAME/stride s samples positions 0, s, 2s, ... exactly.
    if (layer.convolution_mode is not ConvolutionMode.SAME
            and _pair(layer.padding) != (0, 0)):
        return None
    sh, sw = _pair(layer.stride)
    b_, cin, h, wd = x.shape
    h_o, w_o = -(-h // sh), -(-wd // sw)
    x = layer._dropout_input(x, train, gen)  # the full input, as the layer
    xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    # NCHW in channels_last memory: the NHWC permute is the memory order,
    # so [M, Cin] is a view unless the stride subsample made a gap
    x2 = xs.permute(0, 2, 3, 1).reshape(b_ * h_o * w_o, cin).contiguous()
    w2 = params["W"].reshape(layer.n_out, cin)
    b = params["b"] if layer.has_bias else _zero_bias(layer, x)
    y2 = impls.matmul_bias_act(x2, w2, b, layer.activation)
    return y2.view(b_, h_o, w_o, layer.n_out).permute(0, 3, 1, 2), state


def _route_quant_dense(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers_quant import (
        QuantizedDenseLayer,
        quantize_input,
    )

    if type(layer).forward is not QuantizedDenseLayer.forward:
        return None
    if x.ndim != 2 or not impls.elementwise(layer.activation):
        return None
    xq = quantize_input(x, params["xs"], params["xz"])
    y = impls.matmul_bias_act_int8(xq.contiguous(), params["Wq"],
                                   params["scale"], params["b"],
                                   layer.activation)
    return y.to(x.dtype), state


def _route_quant_conv1x1(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers_quant import (
        QuantizedConv1x1Layer,
        quantize_input,
    )

    if type(layer).forward is not QuantizedConv1x1Layer.forward:
        return None
    if x.ndim != 4 or not impls.elementwise(layer.activation):
        return None
    sh, sw = _pair(layer.stride)
    b_, cin, h, wd = x.shape
    h_o, w_o = -(-h // sh), -(-wd // sw)
    xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    x2 = xs.permute(0, 2, 3, 1).reshape(b_ * h_o * w_o, cin)
    xq = quantize_input(x2, params["xs"], params["xz"])
    y2 = impls.matmul_bias_act_int8(xq.contiguous(), params["Wq"],
                                    params["scale"], params["b"],
                                    layer.activation)
    y = y2.view(b_, h_o, w_o, layer.n_out).permute(0, 3, 1, 2)
    return y.to(x.dtype), state


def _route_fused_conv_bn(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers_cnn import FusedConvBN1x1

    if type(layer).forward is not FusedConvBN1x1.forward:
        return None
    if not train or x.ndim != 4:
        return None  # eval mode reads running stats: no statistics pass
    # exactly the layer's train-mode kernel path (stride subsample first,
    # statistics in the state dtype, var = max(q/m - mean^2, 0))
    return layer.forward_kernel(params, state,
                                layer._dropout_input(x, train, gen))


def _qualifies(q) -> bool:
    from deeplearning4j_tpu_torch.ops.attention import head_dim_supported

    return (q.dtype in impls.DTYPE_IDS and q.device.type in ("cpu", "cuda")
            and head_dim_supported(q.shape[-1]))


def maybe_flash_attention(q, k, v, key_mask=None, causal=False):
    """Head-split ``[B, H, T, D]`` attention through the flash kernel, or
    ``None`` for the stock tier (a dtype or head size the kernel does not
    take). On a CUDA tensor the first call per card checks
    :func:`capability`."""
    from deeplearning4j_tpu_torch.ops import attention

    if not _qualifies(q):
        return None
    if q.is_cuda:
        capability(q.device)
    return attention.flash_attention(q, k, v, key_mask, causal)


def maybe_decode_attention(q, k_cache, v_cache, positions):
    """Single-token decode attention (``q [B, H, D]`` against ``[B, S, H,
    D]`` caches valid through ``positions``) through the paged decode
    kernel, or ``None`` for the stock masked full-cache read (a dtype or
    head size the kernel does not take, or a cache length that
    ``min(64, S)``-slot pages do not divide)."""
    from deeplearning4j_tpu_torch.ops import attention

    s = k_cache.shape[1]
    if not _qualifies(q) or s % min(64, s):
        return None
    if q.is_cuda:
        capability(q.device)
    return attention.paged_decode_attention(q, k_cache, v_cache, positions)


def _route_self_attention(layer, params, state, x, train, gen, mask):
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.ops.attention import head_dim_supported

    if type(layer).forward is not SelfAttentionLayer.forward:
        return None
    if x.ndim != 3 or layer.attention_impl not in ("auto", "flash"):
        return None
    if not head_dim_supported(layer._head_size(x.shape[-1])):
        return None
    return layer.forward(params, state, x, train=train, gen=gen, mask=mask,
                         use_kernels=True)


def _route_attention_vertex(vertex, params, state, xs, train, gen):
    from deeplearning4j_tpu_torch.conf.graph import AttentionVertex
    from deeplearning4j_tpu_torch.ops.attention import head_dim_supported

    if type(vertex).forward is not AttentionVertex.forward:
        return None
    if xs[0].ndim != 3 or vertex.attention_impl not in ("auto", "flash"):
        return None
    hs = (vertex._head_size(xs[0].shape[-1]) if vertex.project_input
          else xs[2].shape[-1])
    if not head_dim_supported(hs):
        return None
    return vertex.forward(params, state, xs, train=train, gen=gen,
                          use_kernels=True)


def maybe_forward(layer, params, state, x, train=False, gen=None, mask=None):
    """Run ``layer`` through its kernel, or return ``None`` for the stock
    forward. ``mask`` (a [batch, time] feature mask) routes only a
    SelfAttentionLayer. On a CUDA tensor the first routed call per card
    checks :func:`capability`."""
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        FusedConvBN1x1,
    )
    from deeplearning4j_tpu_torch.conf.layers_quant import (
        QuantizedConv1x1Layer,
        QuantizedDenseLayer,
    )

    if isinstance(layer, SelfAttentionLayer):
        return _route_self_attention(layer, params, state, x, train, gen,
                                     mask)
    if mask is not None:
        return None
    # the quantized layers first, in the JAX package's order
    if isinstance(layer, QuantizedDenseLayer):
        route = _route_quant_dense
    elif isinstance(layer, QuantizedConv1x1Layer):
        route = _route_quant_conv1x1
    elif isinstance(layer, FusedConvBN1x1):
        route = _route_fused_conv_bn
    elif isinstance(layer, ConvolutionLayer):
        route = _route_conv1x1
    elif isinstance(layer, DenseLayer):
        route = _route_dense
    else:
        return None
    if x.is_cuda:
        capability(x.device)
    return route(layer, params, state, x, train, gen)


def maybe_vertex_forward(vertex, params, state, xs, train=False, gen=None,
                         mask=None):
    """Graph-side dispatch: route a single-input ``LayerVertex``'s wrapped
    layer, applying its preprocessor first exactly as ``LayerVertex.forward``
    does, or an ``AttentionVertex``'s core. A feature ``mask`` rides through
    only for SelfAttentionLayer (the one routed layer that consumes it).
    None = run the stock vertex forward."""
    from deeplearning4j_tpu_torch.conf.graph import AttentionVertex

    if isinstance(vertex, AttentionVertex):
        return _route_attention_vertex(vertex, params, state, xs, train, gen)
    layer = getattr(vertex, "layer", None)
    if layer is None or len(xs) != 1:
        return None
    x = xs[0]
    pre = getattr(vertex, "preprocessor", None)
    if pre is not None:
        x, _ = pre.forward({}, {}, x)
    return maybe_forward(layer, params, state, x, train, gen, mask)
