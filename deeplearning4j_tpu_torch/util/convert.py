"""Carry a JAX-package ComputationGraph's weights into the port.

The JAX package keeps conv weights HWIO ``[kh, kw, in, out]`` and dense
weights ``[nIn, nOut]``; the port keeps conv weights OIHW
``[out, in, kh, kw]`` and dense weights ``[nOut, nIn]`` (torch's
``nn.Linear`` layout, K-contiguous for the ``matmul_bias_act`` kernel).
Biases, BN ``gamma``/``beta`` and the BN running ``mean``/``var`` state are
per-channel vectors in both packages. An updater's state (Adam's ``m`` and
``v``, Nesterovs' ``v``) has its parameter's shape, so it converts by the
parameter's rule.

This module imports neither package's JAX code: it takes the JAX graph's
``params``/``state`` as nested dicts of numpy arrays
(``{vertex: {"W": ..., "b": ...}}``, e.g. ``np.asarray`` of each leaf).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf.layers import DenseLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    ConvolutionLayer,
    FusedConvBN1x1,
)


def convert_layer_params(layer, params: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """One layer's JAX-package params (``{"W": ..., "b": ...}``, numpy) in
    the port's layouts, as CPU tensors."""
    out = {}
    for key, v in params.items():
        v = np.asarray(v)
        if key == "W":
            if isinstance(layer, (ConvolutionLayer, FusedConvBN1x1)):
                v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
            elif isinstance(layer, DenseLayer):
                v = np.transpose(v)  # [nIn, nOut] -> [nOut, nIn]
            else:
                raise ValueError(
                    f"no weight layout rule for {type(layer).__name__}")
        out[key] = torch.tensor(v)
    return out


def params_from_jax(conf, params: Dict[str, dict], state: Dict[str, dict]
                    ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """Map the JAX graph's ``params``/``state`` onto the port's layouts for
    the graph ``conf`` (a port ``ComputationGraphConfiguration``). Returns
    ``(params, state)`` as dicts of CPU tensors, ready for
    ``ComputationGraph.set_params``."""
    vmap = conf.vertex_map()
    out_p = {name: convert_layer_params(getattr(vmap[name].vertex, "layer",
                                                None), vp)
             for name, vp in params.items()}
    out_s = {name: {key: torch.tensor(np.asarray(v)) for key, v in vs.items()}
             for name, vs in state.items()}
    return out_p, out_s


def opt_state_from_jax(conf, opt_state: Dict[str, dict]) -> Dict[str, dict]:
    """Map the JAX graph's updater state (``{vertex: {param: {"m": ...,
    "v": ...}}}``, numpy) onto the port's layouts, so training resumes in
    the port: pass the result to ``ComputationGraph.set_params`` (and carry
    the JAX graph's ``iteration``, which Adam's bias correction reads)."""
    vmap = conf.vertex_map()
    out = {}
    for name, vp in opt_state.items():
        layer = getattr(vmap[name].vertex, "layer", None)
        out[name] = {
            pk: {sk: convert_layer_params(layer, {pk: v})[pk]
                 for sk, v in leaf.items()}
            for pk, leaf in vp.items()}
    return out
