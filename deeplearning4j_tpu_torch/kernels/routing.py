"""Layer-to-kernel routing + the capability probe.

``maybe_forward(layer, ...)`` is the dispatch point the graph forward calls
when ``conf.use_kernels`` is on. It takes the same qualifiers as the JAX
package's ``kernels/routing.py``:

- ``DenseLayer`` (2-D input) and 1x1 ``ConvolutionLayer`` → ``matmul_bias_act``,
  only for the layer's exact class forward (a subclass with its own forward
  is never rerouted) and an elementwise activation;
- the 1x1 conv only when pad-free (explicit padding would add zero rows) or
  SAME; a stride subsamples the input before the GEMM, so the output is
  ``ceil(h / s)`` by ``ceil(w / s)``;
- a missing bias (``has_bias=False``) is a zero bias.

Anything else returns ``None`` and the caller runs the stock forward. The
JAX route takes its kernel only for a *tuned* envelope; this port has no
tuner yet, so the route takes the kernel for every shape the qualifiers
admit (the JAX package's tuned and stock paths agree, so no output changes).
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


def _route_dense(layer, params, state, x):
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, promote

    if type(layer).forward is not DenseLayer.forward:
        return None  # a subclass with its own forward: never reroute it
    if x.ndim != 2 or not impls.elementwise(layer.activation):
        return None
    b = params["b"] if layer.has_bias else _zero_bias(layer, x)
    x, w, b = promote(x, params["W"], b)
    y = impls.matmul_bias_act(x.contiguous(), w, b, layer.activation)
    return y, state


def _route_conv1x1(layer, params, state, x):
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
    xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    # NCHW in channels_last memory: the NHWC permute is the memory order,
    # so [M, Cin] is a view unless the stride subsample made a gap
    x2 = xs.permute(0, 2, 3, 1).reshape(b_ * h_o * w_o, cin).contiguous()
    w2 = params["W"].reshape(layer.n_out, cin)
    b = params["b"] if layer.has_bias else _zero_bias(layer, x)
    y2 = impls.matmul_bias_act(x2, w2, b, layer.activation)
    return y2.view(b_, h_o, w_o, layer.n_out).permute(0, 3, 1, 2), state


def maybe_forward(layer, params, state, x):
    """Run ``layer`` through ``matmul_bias_act``, or return ``None`` for the
    stock forward. On a CUDA tensor the first routed call per card checks
    :func:`capability`."""
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.conf.layers_cnn import ConvolutionLayer

    if isinstance(layer, ConvolutionLayer):
        route = _route_conv1x1
    elif isinstance(layer, DenseLayer):
        route = _route_dense
    else:
        return None
    if x.is_cuda:
        capability(x.device)
    return route(layer, params, state, x)


def maybe_vertex_forward(vertex, params, state, xs):
    """Graph-side dispatch: route a single-input ``LayerVertex``'s wrapped
    layer, applying its preprocessor first exactly as ``LayerVertex.forward``
    does. None = run the stock vertex forward."""
    layer = getattr(vertex, "layer", None)
    if layer is None or len(xs) != 1:
        return None
    x = xs[0]
    pre = getattr(vertex, "preprocessor", None)
    if pre is not None:
        x, _ = pre.forward({}, {}, x)
    return maybe_forward(layer, params, state, x)
