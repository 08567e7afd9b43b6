"""ComputationGraph — DAG model runtime (eval mode).

Reference: ``org.deeplearning4j.nn.graph.ComputationGraph``; counterpart of
the JAX package's ``deeplearning4j_tpu/nn/graph.py``. The JAX package
traces the topological walk once into one XLA program; PyTorch runs eagerly,
so here the walk runs on every forward, and an activation is released as
soon as its last consumer has run.

At the public boundary ``output`` takes the JAX package's arrays (NHWC for
images, numpy or torch) and returns numpy; inside, image tensors are
logical NCHW in ``channels_last`` memory, the same bytes as NHWC, so the
permute at the boundary is free.

Precision: float32 is served in full float32. Constructing a graph on a
CUDA device turns TF32 off for cuBLAS and cuDNN (``allow_tf32 = False``);
TF32 keeps about three decimal digits, the JAX package's CPU semantics keep
float32's.

``conf.use_kernels`` sends every vertex through
``kernels.maybe_vertex_forward`` first, exactly where the JAX package's
``_forward`` does; 1x1 convolutions and dense layers then run the
hand-written ``matmul_bias_act`` kernel.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn import io as nn_io

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def serve_full_f32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _vertex_seed(seed: int, index: int) -> int:
    """Per-vertex init seed (the counterpart of ``fold_in(key, i)``): each
    vertex's weights depend only on the conf seed and its topo index."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63)


def _place(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    t = t.to(device=device, dtype=dtype or t.dtype)
    if t.ndim == 4:  # conv weights match the channels_last activations
        t = t.contiguous(memory_format=torch.channels_last)
    return t


class ComputationGraph:
    """DAG network (reference ``ComputationGraph``), serving slice: ``init``,
    ``output``, ``feed_forward``, ``clone``."""

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
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
        self._topo = conf.topo_order()
        self._vmap = conf.vertex_map()
        self._image = [nn_io.image_input(t) for t in conf.input_types]
        # activations each vertex is the last consumer of (freed after it)
        last = {}
        for i, name in enumerate(self._topo):
            for src in self._vmap[name].inputs:
                last[src] = i
        self._frees: Dict[int, List[str]] = defaultdict(list)
        for src, i in last.items():
            if src not in conf.network_outputs:
                self._frees[i].append(src)

    # --- lifecycle ---------------------------------------------------------
    def init(self) -> "ComputationGraph":
        """Draw every vertex's params from a ``torch.Generator`` seeded by
        ``conf.seed`` and the vertex's topo index (on the CPU, so a seed
        gives the same weights on every device), then place them."""
        types = self.conf.vertex_output_types()
        params, state = {}, {}
        for i, name in enumerate(self._topo):
            spec = self._vmap[name]
            in_types = [types[src] for src in spec.inputs]
            gen = torch.Generator().manual_seed(_vertex_seed(self.conf.seed, i))
            p = spec.vertex.init(gen, in_types, self._dtype)
            if p:
                params[name] = p
            s = spec.vertex.init_state(in_types, self._dtype)
            if s:
                state[name] = s
        return self.set_params(params, state)

    def set_params(self, params: Dict[str, dict],
                   state: Dict[str, dict]) -> "ComputationGraph":
        """Adopt ``{vertex: {name: tensor}}`` params and state (e.g. from
        ``util.convert.params_from_jax``), copied onto this graph's device
        in the storage dtype."""
        self.params = {k: {pk: _place(torch.as_tensor(v), self.device,
                                      self._dtype)
                           for pk, v in vp.items()}
                       for k, vp in params.items()}
        self.state = {k: {sk: _place(torch.as_tensor(v), self.device,
                                     self._dtype)
                          for sk, v in vs.items()}
                      for k, vs in state.items()}
        self._cast_params = None
        return self

    # --- functional core ---------------------------------------------------
    def _forward(self, params, state, inputs: Sequence, keep_all=False):
        """Eval-mode DAG forward; returns the activations dict (every vertex
        when ``keep_all``, else the network outputs)."""
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        for i, name in enumerate(self._topo):
            spec = self._vmap[name]
            xs = [acts[src] for src in spec.inputs]
            p = params.get(name, {})
            s = state.get(name, {})
            routed = None
            if self.conf.use_kernels:
                routed = kernels.maybe_vertex_forward(spec.vertex, p, s, xs)
            y, _ = (routed if routed is not None
                    else spec.vertex.forward(p, s, xs))
            acts[name] = y
            if not keep_all:
                for src in self._frees.get(i, ()):
                    del acts[src]
        return acts

    def _fwd_params(self):
        """Params in the compute dtype (mixed precision); the output
        vertices keep the storage dtype so logits land in it."""
        if self._cdtype is None:
            return self.params
        if self._cast_params is None:
            outs = set(self.conf.network_outputs)
            self._cast_params = {
                k: (vp if k in outs else
                    {pk: v.to(self._cdtype) if v.is_floating_point() else v
                     for pk, v in vp.items()})
                for k, vp in self.params.items()}
        return self._cast_params

    def _prepare(self, inputs: Sequence) -> List[torch.Tensor]:
        if len(inputs) != len(self.conf.network_inputs):
            raise ValueError(f"graph takes {len(self.conf.network_inputs)} "
                             f"input array(s), got {len(inputs)}")
        xs = []
        for i, x in enumerate(inputs):
            t = nn_io.as_device(x, self.device, self._dtype,
                                self._cdtype or self._dtype,
                                scale=self._image[i] if i < len(self._image)
                                else True)
            if t.ndim == 4:  # NHWC -> logical NCHW, channels_last memory
                t = t.permute(0, 3, 1, 2)
            xs.append(t)
        return xs

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        t = t.to(self._dtype)
        if t.ndim == 4:
            t = t.permute(0, 2, 3, 1)
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()

    def feed_forward(self, *inputs) -> Dict[str, np.ndarray]:
        """Every vertex's activation, eval mode, as host arrays in the JAX
        package's layouts (reference ``ComputationGraph#feedForward``)."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts = self._forward(self._fwd_params(), self.state,
                                 self._prepare(inputs), keep_all=True)
            return {n: self._to_host(acts[n]) for n in self._topo}

    def output(self, *inputs):
        """Forward pass, eval mode (reference ``#output(INDArray...)``).
        Returns a numpy array per network output (a single array for one
        output), in the storage dtype."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts = self._forward(self._fwd_params(), self.state,
                                 self._prepare(inputs))
            outs = [self._to_host(acts[n]) for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # --- misc --------------------------------------------------------------
    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return int(sum(v.numel() for vp in self.params.values()
                       for v in vp.values()))

    def clone(self) -> "ComputationGraph":
        """A new graph on the same conf and device with copied params."""
        other = ComputationGraph(self.conf, self.device)
        if self.params is not None:
            other.set_params(
                {k: {pk: v.clone() for pk, v in vp.items()}
                 for k, vp in self.params.items()},
                {k: {sk: v.clone() for sk, v in vs.items()}
                 for k, vs in self.state.items()})
        return other
