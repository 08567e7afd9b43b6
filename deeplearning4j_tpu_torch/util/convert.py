"""Carry a JAX-package network's weights into the port.

The JAX package keeps conv weights HWIO ``[kh, kw, in, out]`` and dense
weights ``[nIn, nOut]``; the port keeps conv weights OIHW
``[out, in, kh, kw]`` and dense weights ``[nOut, nIn]`` (torch's
``nn.Linear`` layout, K-contiguous for the ``matmul_bias_act`` kernel).
A ``SeparableConvolution2D``'s ``dW`` (HWIO ``[kh, kw, 1, in*mult]``) and
``pW`` (``[1, 1, in*mult, out]``) become OIHW the same way; a
``Deconvolution2D``'s ``W`` becomes ``[in, out, kh, kw]``
(``F.conv_transpose2d``'s layout) and a ``Convolution1DLayer``'s ``[k,
in, out]`` becomes ``[out, in, k]`` (``F.conv1d``'s). A conv weight of any
other rank has no rule and raises.
``SelfAttentionLayer``'s projections ``Wq/Wk/Wv`` ``[nIn, e]`` and ``Wo``
``[e, nOut]`` are transposed the same way, to ``[e, nIn]`` and
``[nOut, e]``, and so are ``AttentionVertex``'s (a graph vertex with
params of its own) and ``LearnedSelfAttentionLayer``'s ``Wk/Wv/Wo`` (its
learned queries ``Q [nQueries, e]`` are rows in both packages). The
recurrent layers (``conf.layers_rnn``: ``W``, ``RW``, GRU's ``rb``,
GravesLSTM's peepholes, ``Bidirectional``'s ``f``/``b``-prefixed copies,
the wrappers' inner layer) and ``RecurrentAttentionLayer`` keep the JAX
package's ``[in, out]`` layouts, so they carry over as they are;
``RnnOutputLayer`` is a dense layer. Embedding tables (``EmbeddingLayer.W`` and
``EmbeddingSequenceLayer.W [vocab, nOut]``,
``PositionEmbeddingLayer.P [max_len, size]``) keep their layout: a row per
id in both packages. Biases, LayerNormalization ``gain``/``b``, BN
``gamma``/``beta`` and the BN running ``mean``/``var`` state are vectors in
both packages. A quantized layer's ``Wq`` is ``[K, N]`` int8 in both
packages (the int8 kernel's contract layout) and stays int8; its
``scale``, ``b``, ``xs`` and ``xz`` are vectors. An updater's state (Adam's ``m`` and
``v``, Nesterovs' ``v``) has its parameter's shape, so it converts by the
parameter's rule.

This module imports neither package's JAX code: it takes the JAX network's
``params``/``state`` as nested dicts of numpy arrays
(``{vertex: {"W": ..., "b": ...}}`` for a graph, ``{"0": {...}, ...}`` by
layer index for a MultiLayerNetwork; e.g. ``np.asarray`` of each leaf).
``params_to_jax`` / ``opt_state_to_jax`` go the other way, to numpy in the
JAX package's layouts (the flat vector of ``util.params`` is built on
them).

A MultiLayerNetwork's 6400-wide dense layer after AlexNet's flatten keeps
its rows: the port's ``CnnToFeedForwardPreProcessor`` flattens in the JAX
package's NHWC order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf.graph import AttentionVertex
from deeplearning4j_tpu_torch.conf.layers import (
    DenseLayer,
    EmbeddingLayer,
    EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.conf.layers_attention import (
    LearnedSelfAttentionLayer,
    RecurrentAttentionLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    Convolution1DLayer,
    ConvolutionLayer,
    Deconvolution2D,
    FusedConvBN1x1,
    SeparableConvolution2D,
)
from deeplearning4j_tpu_torch.conf.layers_rnn import (
    BaseRecurrentLayer,
    Bidirectional,
    _RecurrentWrapper,
)


_ATTN_WEIGHTS = ("Wq", "Wk", "Wv", "Wo")


def layout_perm(layer, key: str, ndim: int):
    """The axes permutation that takes ``layer``'s param ``key`` from the
    port's layout to the JAX package's (``np.transpose(v, perm)``), or None
    where the two layouts agree."""
    while isinstance(layer, _RecurrentWrapper):
        layer = layer.layer
    if (isinstance(layer, (SelfAttentionLayer, AttentionVertex,
                           LearnedSelfAttentionLayer))
            and key in _ATTN_WEIGHTS):
        return (1, 0)  # [out, in] -> [in, out]
    if isinstance(layer, SeparableConvolution2D) and key in ("dW", "pW"):
        return _conv_perm(layer, key, ndim, 4, (2, 3, 1, 0))  # OIHW -> HWIO
    if key != "W":
        return None
    if isinstance(layer, (BaseRecurrentLayer, Bidirectional,
                          RecurrentAttentionLayer)):
        return None  # the JAX package's [in, out] in both packages
    if isinstance(layer, Convolution1DLayer):
        return _conv_perm(layer, key, ndim, 3, (2, 1, 0))  # [out, in, k]
    if isinstance(layer, Deconvolution2D):
        return _conv_perm(layer, key, ndim, 4, (2, 3, 0, 1))  # [in, out, ..]
    if isinstance(layer, (ConvolutionLayer, FusedConvBN1x1)):
        return _conv_perm(layer, key, ndim, 4, (2, 3, 1, 0))  # OIHW -> HWIO
    if isinstance(layer, DenseLayer):
        return (1, 0)  # [nOut, nIn] -> [nIn, nOut]
    if isinstance(layer, (EmbeddingLayer, EmbeddingSequenceLayer)):
        return None
    raise ValueError(f"no weight layout rule for {type(layer).__name__}")


def _conv_perm(layer, key, ndim, rank, perm):
    """``perm`` for a conv weight of its layer's ``rank``; any other rank
    (a 3-D weight on a 2-D conv, say) has no rule."""
    if ndim != rank:
        raise ValueError(f"no {ndim}-D layout rule for "
                         f"{type(layer).__name__}.{key} (its weights are "
                         f"{rank}-D)")
    return perm


def convert_layer_params(layer, params: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """One layer's JAX-package params (``{"W": ..., "b": ...}``, numpy) in
    the port's layouts, as CPU tensors."""
    out = {}
    for key, v in params.items():
        v = np.asarray(v)
        perm = layout_perm(layer, key, v.ndim)
        if perm is not None:
            v = np.transpose(v, np.argsort(perm))
        out[key] = torch.tensor(v)
    return out


def layer_params_to_jax(layer, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """One layer's port params in the JAX package's layouts, as C-ordered
    numpy arrays (the inverse of :func:`convert_layer_params`)."""
    out = {}
    for key, v in params.items():
        a = v.detach().cpu()
        if a.dtype == torch.bfloat16:  # numpy has no bfloat16
            a = a.float()
        a = a.numpy()
        perm = layout_perm(layer, key, a.ndim)
        out[key] = np.ascontiguousarray(
            a if perm is None else np.transpose(a, perm))
    return out


def _layer_of(conf, key: str):
    """The conf whose layout rules apply to a params key: a graph vertex's
    layer (the vertex itself when it holds params of its own, as
    ``AttentionVertex`` does), or a MultiLayerNetwork's layer by its string
    index."""
    if hasattr(conf, "vertex_map"):
        vertex = conf.vertex_map()[key].vertex
        layer = getattr(vertex, "layer", None)
        return vertex if layer is None else layer
    return conf.layers[int(key)]


def params_from_jax(conf, params: Dict[str, dict], state: Dict[str, dict]
                    ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """Map the JAX network's ``params``/``state`` onto the port's layouts
    for ``conf`` (a port ``ComputationGraphConfiguration`` or
    ``MultiLayerConfiguration``). Returns ``(params, state)`` as dicts of
    CPU tensors, ready for ``set_params`` of either network."""
    out_p = {name: convert_layer_params(_layer_of(conf, name), vp)
             for name, vp in params.items()}
    out_s = {name: {key: torch.tensor(np.asarray(v)) for key, v in vs.items()}
             for name, vs in state.items()}
    return out_p, out_s


def opt_state_from_jax(conf, opt_state: Dict[str, dict]) -> Dict[str, dict]:
    """Map the JAX network's updater state (``{key: {param: {"m": ...,
    "v": ...}}}``, numpy; keys are a graph's vertex names or a
    MultiLayerNetwork's layer indices) onto the port's layouts, so training
    resumes in the port: pass the result to ``set_params`` of either
    network (and carry the JAX network's ``iteration``, which Adam's bias
    correction reads)."""
    out = {}
    for name, vp in opt_state.items():
        layer = _layer_of(conf, name)
        out[name] = {
            pk: {sk: convert_layer_params(layer, {pk: v})[pk]
                 for sk, v in leaf.items()}
            for pk, leaf in vp.items()}
    return out


def params_to_jax(conf, params: Dict[str, dict], state: Dict[str, dict]
                  ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """The port network's ``params``/``state`` in the JAX package's layouts,
    as numpy (the inverse of :func:`params_from_jax`)."""
    out_p = {name: layer_params_to_jax(_layer_of(conf, name), vp)
             for name, vp in params.items()}
    out_s = {name: layer_params_to_jax(None, vs)
             for name, vs in state.items()}
    return out_p, out_s


def opt_state_to_jax(conf, opt_state: Dict[str, dict]) -> Dict[str, dict]:
    """The port network's updater state in the JAX package's layouts, as
    numpy (the inverse of :func:`opt_state_from_jax`)."""
    out = {}
    for name, vp in opt_state.items():
        layer = _layer_of(conf, name)
        out[name] = {
            pk: {sk: layer_params_to_jax(layer, {pk: v})[pk]
                 for sk, v in leaf.items()}
            for pk, leaf in vp.items()}
    return out
