"""MultiLayerNetwork — sequential model runtime, inference.

Reference: ``org.deeplearning4j.nn.multilayer.MultiLayerNetwork``;
counterpart of the JAX package's ``deeplearning4j_tpu/nn/multilayer.py``
for inference: ``init``, ``output``, ``feed_forward``, ``clone`` and
``num_params``. Training (``fit``) lands with a later slice.

Params and state are keyed ``"0".."n"`` by layer index, as in the JAX
package. At the public boundary ``output`` takes the JAX package's arrays
(NHWC images, numpy or torch; uint8 images are scaled by 1/255 on the
device) and returns numpy; inside, image tensors are logical NCHW in
``channels_last`` memory. Floating-point params are held in the storage
dtype; integer params (a quantized layer's int8 ``Wq``) keep their dtype.

``conf.use_kernels`` sends every layer through ``kernels.maybe_forward``
first, as the JAX package's ``_forward`` does: dense layers and 1x1
convolutions then run ``matmul_bias_act``, the int8 layers of a quantized
artifact ``matmul_bias_act_int8``. ``feed_forward`` runs the stock layer
forwards, as the JAX package's does (calibration reads it).

Precision as in ``nn.graph``: a network on a CUDA device serves float32 in
full float32 (TF32 off).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn import io as nn_io
from deeplearning4j_tpu_torch.nn.graph import (
    _place,
    _torch_dtype,
    _vertex_seed,
    serve_full_f32,
)


class MultiLayerNetwork:
    """Sequential network (reference ``MultiLayerNetwork``), eval mode."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        self.conf = conf
        self.device = torch.device(device)
        if self.device.type == "cuda":
            serve_full_f32()
        self.params: Optional[Dict[str, dict]] = None
        self.state: Dict[str, dict] = {}
        self._dtype = _torch_dtype(conf.dtype)
        self._cdtype = (_torch_dtype(conf.compute_dtype)
                        if conf.compute_dtype else None)
        self._cast_params = None  # compute-dtype copy of params, built once
        self._image = nn_io.image_input(conf.input_type)

    # --- lifecycle ---------------------------------------------------------
    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's params from a ``torch.Generator`` seeded by
        ``conf.seed`` and the layer index (on the CPU, so a seed gives the
        same weights on every device), then place them."""
        params, state = {}, {}
        for i, (layer, itype) in enumerate(zip(self.conf.layers,
                                               self.conf.input_types())):
            gen = torch.Generator().manual_seed(_vertex_seed(self.conf.seed, i))
            p = layer.init(gen, itype, self._dtype)
            if p:
                params[str(i)] = p
            s = layer.init_state(itype, self._dtype)
            if s:
                state[str(i)] = s
        return self.set_params(params, state)

    def set_params(self, params: Dict[str, dict], state: Dict[str, dict]
                   ) -> "MultiLayerNetwork":
        """Adopt ``{"i": {name: tensor}}`` params and state (e.g. from
        ``util.convert.params_from_jax``), copied onto this network's
        device: floating-point tensors in the storage dtype, integer ones
        (int8 ``Wq``) in their own; conv weights ``channels_last``, every
        other tensor contiguous (the kernels take row-major operands)."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            t = torch.as_tensor(tree)
            t = _place(t, self.device,
                       self._dtype if t.is_floating_point() else None)
            return t if t.ndim == 4 else t.contiguous()

        self.params = place(params)
        self.state = place(state)
        self._cast_params = None
        return self

    # --- forward -----------------------------------------------------------
    def _forward(self, params, x, keep_all=False):
        """Eval-mode forward over every layer; returns the last activation,
        or every layer's with ``keep_all`` (stock forwards only, as the JAX
        package's ``feed_forward``)."""
        acts = []
        route = self.conf.use_kernels and not keep_all
        for i, layer in enumerate(self.conf.layers):
            p = params.get(str(i), {})
            s = self.state.get(str(i), {})
            routed = kernels.maybe_forward(layer, p, s, x) if route else None
            x, _ = routed if routed is not None else layer.forward(p, s, x)
            if keep_all:
                acts.append(x)
        return acts if keep_all else x

    def _fwd_params(self):
        """The eval forward's params: under a compute-dtype policy every
        float param but the output layer's in the compute dtype (so logits
        land in the storage dtype), cast once per set of params."""
        if self._cdtype is None:
            return self.params
        if self._cast_params is None:
            last = str(len(self.conf.layers) - 1)
            self._cast_params = {
                k: (vp if k == last else
                    {pk: v.to(self._cdtype) if v.is_floating_point() else v
                     for pk, v in vp.items()})
                for k, vp in self.params.items()}
        return self._cast_params

    def _prepare(self, x) -> torch.Tensor:
        t = nn_io.as_device(x, self.device, self._dtype,
                            self._cdtype or self._dtype, scale=self._image)
        if t.ndim == 4:  # NHWC -> logical NCHW, channels_last memory
            t = t.permute(0, 3, 1, 2)
        return t

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        t = t.to(self._dtype)
        if t.ndim == 4:
            t = t.permute(0, 2, 3, 1)
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()

    def output(self, x) -> np.ndarray:
        """Forward pass, eval mode (reference ``#output``), as a host array
        in the storage dtype."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            return self._to_host(self._forward(self._fwd_params(),
                                               self._prepare(x)))

    def feed_forward(self, x) -> List[np.ndarray]:
        """Every layer's activation, eval mode, input excluded (reference
        ``MultiLayerNetwork#feedForward``), as host arrays in the JAX
        package's layouts."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts = self._forward(self._fwd_params(), self._prepare(x),
                                 keep_all=True)
            return [self._to_host(a) for a in acts]

    # --- misc --------------------------------------------------------------
    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return int(sum(v.numel() for vp in self.params.values()
                       for v in vp.values()))

    def clone(self) -> "MultiLayerNetwork":
        """A new network on the same conf and device with copied params
        and state."""
        other = MultiLayerNetwork(self.conf, self.device)
        if self.params is not None:
            other.set_params(self.params, self.state)
        return other
