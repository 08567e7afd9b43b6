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
stock forward.

Every route derives its concrete envelope (:mod:`kernels.registry`) and
asks ``REGISTRY.select`` for its tiling: a tuned envelope runs the
winner's tiling; an untuned one, or a cached winner the kernel's
``tiling_ok`` refuses, runs the kernel at its default tiling (the
launcher's own rule), never the stock op. The JAX route takes its kernel
only for a *tuned* envelope and runs stock XLA otherwise; here a
``use_kernels`` route never degrades. :func:`plan_envelopes` /
:func:`autotune_model` and :func:`decoder_envelopes` /
:func:`autotune_decoder` plan and tune the envelopes a model or a decoder
will route, from its conf alone.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import impls
from deeplearning4j_tpu_torch.kernels.registry import (
    REGISTRY,
    AttentionEnvelope,
    MatmulEnvelope,
)

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


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.float16: "float16",
                torch.float64: "float64"}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return _DTYPE_NAMES.get(dtype) or str(dtype).replace("torch.", "")


def default_mode() -> str:
    """The backend envelopes are planned for when no ``mode`` is given:
    ``"cuda"`` where a card is visible, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _env(m: int, k: int, n: int, dtype, act: str = "identity",
         mode: Optional[str] = None) -> MatmulEnvelope:
    return MatmulEnvelope(int(m), int(k), int(n), _dtype_name(dtype),
                          mode or default_mode(), act)


def _attn_env(b: int, h: int, tq: int, tk: int, d: int, dtype,
              causal: bool, masked: bool,
              mode: Optional[str] = None) -> AttentionEnvelope:
    return AttentionEnvelope(int(b), int(h), int(tq), int(tk), int(d),
                             _dtype_name(dtype), mode or default_mode(),
                             bool(causal), bool(masked))


def _tuned(kernel_id: str, env) -> dict:
    """``{"tiling": winner}`` for a tuned envelope, else ``{}``: the
    wrapper is called as it was before the registry and its launcher runs
    its default rule (untuned, a refused winner, or an envelope the
    registry does not cover, where the wrapper checks the call)."""
    sel = REGISTRY.select(kernel_id, env)
    return {"tiling": sel.tiling} if sel is not None and sel.tuned else {}


def _route_dense(layer, params, state, x, train, gen):
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, promote

    if type(layer).forward is not DenseLayer.forward:
        return None  # a subclass with its own forward: never reroute it
    if x.ndim != 2 or not impls.elementwise(layer.activation):
        return None
    x = layer._dropout_input(x, train, gen)
    b = params["b"] if layer.has_bias else _zero_bias(layer, x)
    x, w, b = promote(x, params["W"], b)
    act = layer.activation
    tuned = _tuned("matmul_bias_act",
                   MatmulEnvelope(x.shape[0], x.shape[1], layer.n_out,
                                  _dtype_name(x.dtype), x.device.type,
                                  act.value))
    y = impls.matmul_bias_act(x.contiguous(), w, b, act, **tuned)
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
    act = layer.activation
    tuned = _tuned("matmul_bias_act",
                   MatmulEnvelope(x2.shape[0], cin, layer.n_out,
                                  _dtype_name(x2.dtype), x.device.type,
                                  act.value))
    y2 = impls.matmul_bias_act(x2, w2, b, act, **tuned)
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
    act = layer.activation
    tuned = _tuned("matmul_bias_act_int8",
                   MatmulEnvelope(x.shape[0], x.shape[1], layer.n_out,
                                  "int8", x.device.type, act.value))
    y = impls.matmul_bias_act_int8(xq.contiguous(), params["Wq"],
                                   params["scale"], params["b"], act,
                                   **tuned)
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
    act = layer.activation
    tuned = _tuned("matmul_bias_act_int8",
                   MatmulEnvelope(x2.shape[0], cin, layer.n_out, "int8",
                                  x.device.type, act.value))
    y2 = impls.matmul_bias_act_int8(xq.contiguous(), params["Wq"],
                                    params["scale"], params["b"], act,
                                    **tuned)
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
    sh, sw = _pair(layer.stride)
    b_, cin, h, wd = x.shape
    m = b_ * -(-h // sh) * -(-wd // sw)
    tuned = _tuned("conv_bn_act",
                   MatmulEnvelope(m, cin, layer.n_out, _dtype_name(x.dtype),
                                  x.device.type))
    return layer.forward_kernel(params, state,
                                layer._dropout_input(x, train, gen), **tuned)


def _qualifies(q) -> bool:
    from deeplearning4j_tpu_torch.ops.attention import head_dim_supported

    return (q.dtype in impls.DTYPE_IDS and q.device.type in ("cpu", "cuda")
            and head_dim_supported(q.shape[-1]))


def maybe_flash_attention(q, k, v, key_mask=None, causal=False):
    """Head-split ``[B, H, T, D]`` attention through the flash kernel at
    its selected tiling, or ``None`` for the stock tier (a dtype or head
    size the kernel does not take). On a CUDA tensor the first call per
    card checks :func:`capability`."""
    from deeplearning4j_tpu_torch.ops import attention

    if not _qualifies(q):
        return None
    b, h, tq, d = q.shape
    sel = REGISTRY.select(
        "flash_attention",
        AttentionEnvelope(b, h, tq, k.shape[2], d, _dtype_name(q.dtype),
                          q.device.type, bool(causal), key_mask is not None))
    if sel is None:
        return None
    if q.is_cuda:
        capability(q.device)
    if sel.tuned:
        return attention.flash_attention(q, k, v, key_mask, causal,
                                         tiling=sel.tiling)
    return attention.flash_attention(q, k, v, key_mask, causal)


def maybe_decode_attention(q, k_cache, v_cache, positions):
    """Single-token decode attention (``q [B, H, D]`` against ``[B, S, H,
    D]`` caches valid through ``positions``) through the paged decode
    kernel at its selected page, or ``None`` for the stock masked
    full-cache read (a dtype or head size the kernel does not take, or a
    cache length that ``min(64, S)``-slot pages do not divide)."""
    from deeplearning4j_tpu_torch.ops import attention

    if not _qualifies(q):
        return None
    b, h, d = q.shape
    sel = REGISTRY.select(
        "paged_decode_attention",
        AttentionEnvelope(b, h, 1, k_cache.shape[1], d, _dtype_name(q.dtype),
                          q.device.type, True, False))
    if sel is None:
        return None
    if q.is_cuda:
        capability(q.device)
    if sel.tuned:
        return attention.paged_decode_attention(q, k_cache, v_cache,
                                                positions, page=sel.tiling[0])
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


# --------------------------------------------------------------------------
# envelope planning + whole-model autotune
# --------------------------------------------------------------------------

def _layer_envelope(layer, itype, batch: int, dtype,
                    mode: Optional[str]) -> Optional[Tuple[str, object]]:
    """The ``(kernel_id, envelope)`` a routable layer at this input type
    and batch would select against, or None: the static-shape twin of the
    ``_route_*`` checks (the JAX package's qualifiers and geometry)."""
    from deeplearning4j_tpu_torch.conf import inputs as it
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, _as_ff_size
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        ConvolutionMode,
        FusedConvBN1x1,
    )
    from deeplearning4j_tpu_torch.conf.layers_quant import (
        QuantizedConv1x1Layer,
        QuantizedDenseLayer,
    )

    def rows(layer):  # M of a 1x1 site: the stride subsamples first
        sh, sw = _pair(layer.stride)
        return batch * -(-itype.height // sh) * -(-itype.width // sw)

    elementwise = (hasattr(layer, "activation")
                   and impls.elementwise(layer.activation))
    if isinstance(layer, QuantizedDenseLayer) \
            and type(layer).forward is QuantizedDenseLayer.forward \
            and elementwise:
        try:
            k = _as_ff_size(itype)
        except ValueError:
            return None
        return ("matmul_bias_act_int8",
                _env(batch, k, layer.n_out, "int8",
                     act=layer.activation.value, mode=mode))
    if isinstance(layer, QuantizedConv1x1Layer) \
            and type(layer).forward is QuantizedConv1x1Layer.forward \
            and isinstance(itype, it.Convolutional) and elementwise:
        return ("matmul_bias_act_int8",
                _env(rows(layer), itype.channels, layer.n_out, "int8",
                     act=layer.activation.value, mode=mode))
    if isinstance(layer, SelfAttentionLayer) \
            and type(layer).forward is SelfAttentionLayer.forward \
            and isinstance(itype, it.Recurrent) \
            and itype.timesteps and itype.timesteps > 0 \
            and layer.attention_impl in ("auto", "flash"):
        h = layer.n_heads if layer.project_input else 1
        t = itype.timesteps
        # masked=False: the planned fit envelope is the no-feature-mask
        # path; a masked fit resolves its own envelope when it runs
        return ("flash_attention",
                _attn_env(batch, h, t, t, layer._head_size(itype.size),
                          dtype, causal=layer.causal, masked=False,
                          mode=mode))
    if isinstance(layer, FusedConvBN1x1) \
            and type(layer).forward is FusedConvBN1x1.forward \
            and isinstance(itype, it.Convolutional):
        return ("conv_bn_act",
                _env(rows(layer), itype.channels, layer.n_out, dtype,
                     mode=mode))
    if isinstance(layer, ConvolutionLayer) \
            and type(layer).forward is ConvolutionLayer.forward \
            and isinstance(itype, it.Convolutional) \
            and _pair(layer.kernel_size) == (1, 1) \
            and _pair(layer.dilation) == (1, 1) \
            and (layer.convolution_mode is ConvolutionMode.SAME
                 or _pair(layer.padding) == (0, 0)) and elementwise:
        return ("matmul_bias_act",
                _env(rows(layer), itype.channels, layer.n_out, dtype,
                     act=layer.activation.value, mode=mode))
    if isinstance(layer, DenseLayer) \
            and type(layer).forward is DenseLayer.forward \
            and not isinstance(itype, it.Recurrent) and elementwise:
        try:
            k = _as_ff_size(itype)
        except ValueError:
            return None
        return ("matmul_bias_act",
                _env(batch, k, layer.n_out, dtype,
                     act=layer.activation.value, mode=mode))
    return None


def routed_sites(conf, batch: int, mode: Optional[str] = None
                 ) -> List[Tuple[str, str, object]]:
    """``(site, kernel_id, envelope)`` for every layer a ``use_kernels``
    forward or fit of this conf at ``batch`` routes, in topological order:
    one kernel launch a site and forward. ``site`` is a graph's vertex
    name or a MultiLayerNetwork's layer index. Derived from the conf's
    static shape chain, so it needs no params or data. Takes a
    MultiLayerConfiguration (layer chain) or a
    ComputationGraphConfiguration (DAG walk over its single-input
    LayerVertex specs, preprocessors applied). ``mode``: the envelopes'
    backend ("cuda" or "cpu"; default :func:`default_mode`), so the CPU can
    plan the card's."""
    dtype = getattr(conf, "compute_dtype", None) or conf.dtype
    out: List[Tuple[str, str, object]] = []

    def add(site, pair):
        if pair is not None:
            out.append((site,) + pair)

    if hasattr(conf, "vertices"):  # ComputationGraphConfiguration
        types = conf.vertex_output_types()
        vmap = conf.vertex_map()
        inputs_t = dict(zip(conf.network_inputs, conf.input_types))
        for name in conf.topo_order():
            spec = vmap[name]
            layer = getattr(spec.vertex, "layer", None)
            if layer is None or len(spec.inputs) != 1:
                continue
            src = spec.inputs[0]
            itype = inputs_t.get(src, types.get(src))
            pre = getattr(spec.vertex, "preprocessor", None)
            if pre is not None and itype is not None:
                itype = pre.output_type(itype)
            if itype is not None:
                add(name, _layer_envelope(layer, itype, batch, dtype, mode))
    else:
        for i, (layer, itype) in enumerate(zip(conf.layers,
                                               conf.input_types())):
            add(str(i), _layer_envelope(layer, itype, batch, dtype, mode))
    return out


def plan_envelopes(conf, batch: int,
                   mode: Optional[str] = None) -> List[Tuple[str, object]]:
    """The distinct ``(kernel_id, envelope)`` pairs of
    :func:`routed_sites`, in first-seen order: what :func:`autotune_model`
    tunes."""
    out: List[Tuple[str, object]] = []
    seen = set()
    for _, kid, env in routed_sites(conf, batch, mode):
        if (kid, env.key) not in seen:
            seen.add((kid, env.key))
            out.append((kid, env))
    return out


def _autotune_all(pairs, retune: bool, autotune_kw) -> List[object]:
    from deeplearning4j_tpu_torch.kernels import tuner

    results = []
    for kid, env in pairs:
        kernel = REGISTRY.get(kid)
        if kernel is None or not kernel.supports(env):
            continue
        if not retune \
                and REGISTRY.tuning.winner(kid, env.key) is not None:
            continue
        results.append(tuner.autotune(kernel, env, **autotune_kw))
    return results


def autotune_model(conf, batch: int, retune: bool = False,
                   **autotune_kw) -> List[object]:
    """Autotune every routable envelope of a model conf (MLN chain or
    graph DAG) at one batch size on this process's backend
    (already-tuned envelopes are skipped unless ``retune``). Returns the
    :class:`tuner.AutotuneResult` list; after this, a ``use_kernels``
    forward or fit at ``batch`` selects a tuned winner at every planned
    site. ``autotune_kw``: :func:`tuner.autotune`'s ``warmup``,
    ``trials``, ``max_candidates``, ``cache``, ``record``."""
    return _autotune_all(plan_envelopes(conf, batch), retune, autotune_kw)


def decoder_envelopes(decoder,
                      mode: Optional[str] = None
                      ) -> List[Tuple[str, object]]:
    """The attention ``(kernel_id, envelope)`` list a ``use_kernels``
    :class:`nn.decoding.TransformerDecoder` routes: one paged-decode
    envelope per KV bucket (a decode window runs at full ``max_batch``)
    and one flash envelope per (prompt bucket, join width); cold prefill
    attends under the prompt-length key mask, so those are
    ``masked=True``. Derived from the decoder's ladders and attention
    geometry; needs no params or traffic."""
    out: List[Tuple[str, object]] = []
    seen = set()

    def add(kid, env):
        if (kid, env.key) not in seen:
            seen.add((kid, env.key))
            out.append((kid, env))

    dtype = decoder._dtype
    geoms = set()
    for name, n_in in decoder._attn.items():
        layer = decoder._layer(name)
        geoms.add((layer.n_heads, layer._head_size(n_in)))
    for h, d in sorted(geoms):
        for s in decoder.kv_ladder:
            add("paged_decode_attention",
                _attn_env(decoder.max_batch, h, 1, s, d, dtype,
                          causal=True, masked=False, mode=mode))
        for tp in decoder.prompt_ladder:
            for bp in decoder.join_ladder:
                add("flash_attention",
                    _attn_env(bp, h, tp, tp, d, dtype, causal=True,
                              masked=True, mode=mode))
    return out


def autotune_decoder(decoder, retune: bool = False,
                     **autotune_kw) -> List[object]:
    """Autotune every attention envelope a ``use_kernels`` decoder routes
    (paged decode per KV bucket, flash prefill per prompt / join bucket
    pair). Selection is resolved per call, so tuning before or after the
    decoder's warmup both take effect at the next step."""
    return _autotune_all(decoder_envelopes(decoder), retune, autotune_kw)
