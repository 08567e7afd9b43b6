"""ComputationGraph — DAG model runtime: inference and training.

Reference: ``org.deeplearning4j.nn.graph.ComputationGraph``; counterpart of
the JAX package's ``deeplearning4j_tpu/nn/graph.py``. The JAX package
traces the topological walk once into one XLA program; PyTorch runs eagerly,
so here the walk runs on every forward, and in eval mode an activation is
released as soon as its last consumer has run.

Training (``fit``, ``fit_batch``, ``compute_gradient_and_score``): one step
is the train-mode forward up to the output vertices, the output vertices'
loss on the pre-activations (on the storage-dtype params), ``backward()``,
then under ``torch.no_grad()`` each layer's gradient normalization,
regularization and updater (``optimize.solver``), applied to the params in
place. BN running statistics come back as a new state outside the autograd
graph. Dropout draws come from a ``torch.Generator`` per vertex and step,
seeded from ``conf.seed``, the iteration and the vertex's topo index.

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
hand-written ``matmul_bias_act`` kernel, train-mode ``FusedConvBN1x1``
layers ``matmul_stats`` (both carry the JAX package's backward), and
``SelfAttentionLayer`` its core on the forward-only ``flash_attention``.
An input consumed by an ``EmbeddingSequenceLayer`` holds token ids and
crosses as ``long``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers import EmbeddingSequenceLayer
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.nn import io as nn_io
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

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
    """Per-vertex seed (the counterpart of ``fold_in(key, i)``): each
    vertex's weights (and a step's dropout draws) depend only on the seed
    and its topo index."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63)


def _place(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """A copy of ``t`` on ``device`` (training updates params in place, so
    two graphs never share a tensor)."""
    t = t.to(device=device, dtype=dtype or t.dtype, copy=True)
    if t.ndim == 4:  # conv weights match the channels_last activations
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _as_multi(ds) -> MultiDataSet:
    """DataSet -> single-input/single-output MultiDataSet (reference
    ``ComputationGraph#fit(DataSet)`` convenience overload)."""
    if isinstance(ds, MultiDataSet):
        return ds
    return MultiDataSet(
        features=[ds.features], labels=[ds.labels],
        labels_masks=([ds.labels_mask] if ds.labels_mask is not None
                      else None))


class ComputationGraph:
    """DAG network (reference ``ComputationGraph``): ``init``, ``output``,
    ``feed_forward``, ``fit``, ``fit_batch``, ``score``,
    ``compute_gradient_and_score``, ``clone``."""

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
        self.conf = conf
        self.device = torch.device(device)
        if self.device.type == "cuda":
            serve_full_f32()
        self.params: Optional[Dict[str, dict]] = None
        self.state: Dict[str, dict] = {}
        self.opt_state: Dict[str, dict] = {}
        self.iteration = 0  # steps taken (the next step's 0-based index)
        self.epoch = 0
        self.listeners: List[TrainingListener] = []
        self._score: Optional[torch.Tensor] = None  # the last step's loss
        self._dtype = _torch_dtype(conf.dtype)
        self._cdtype = (_torch_dtype(conf.compute_dtype)
                        if conf.compute_dtype else None)
        self._cast_params = None  # compute-dtype copy of params, built once
        self._topo = conf.topo_order()
        self._vmap = conf.vertex_map()
        self._image = [nn_io.image_input(t) for t in conf.input_types]
        self._ids = [self._feeds_embedding(n) for n in conf.network_inputs]
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

    def set_params(self, params: Dict[str, dict], state: Dict[str, dict],
                   opt_state: Optional[Dict[str, dict]] = None
                   ) -> "ComputationGraph":
        """Adopt ``{vertex: {name: tensor}}`` params and state (e.g. from
        ``util.convert.params_from_jax``), copied onto this graph's device
        in the storage dtype. ``opt_state`` (``{vertex: {param: {name:
        tensor}}}``, e.g. from ``util.convert.opt_state_from_jax``) resumes
        an updater; None starts each layer's updater afresh."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            return _place(torch.as_tensor(tree), self.device, self._dtype)

        self.params = place(params)
        self.state = place(state)
        self.opt_state = (place(opt_state) if opt_state is not None else
                          {k: {pk: self._updater_for(k).init_state(v)
                               for pk, v in vp.items()}
                           for k, vp in self.params.items()})
        self._cast_params = None
        return self

    def _feeds_embedding(self, name: str) -> bool:
        """Whether network input ``name`` holds token ids: some vertex
        consuming it is an ``EmbeddingSequenceLayer``."""
        return any(name in spec.inputs and isinstance(
            getattr(spec.vertex, "layer", None), EmbeddingSequenceLayer)
            for spec in self.conf.vertices)

    def set_listeners(self, *listeners: TrainingListener
                      ) -> "ComputationGraph":
        self.listeners = list(listeners)
        return self

    def _updater_for(self, name: str):
        layer = getattr(self._vmap[name].vertex, "layer", None)
        return getattr(layer, "updater", None) or self.conf.updater

    # --- functional core ---------------------------------------------------
    def _forward(self, params, state, inputs: Sequence, train=False,
                 seed=None, keep_all=False, skip=frozenset()):
        """DAG forward; returns ``(activations, new_state)``. Eval mode keeps
        every vertex's activation only with ``keep_all`` (else it frees each
        one after its last consumer); train mode keeps them all for the
        backward. ``seed`` seeds the step's dropout generators; ``skip``:
        vertices left out (the loss scores the output vertices itself)."""
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        new_state = {}
        for i, name in enumerate(self._topo):
            if name in skip:
                continue
            spec = self._vmap[name]
            xs = [acts[src] for src in spec.inputs]
            p = params.get(name, {})
            s = state.get(name, {})
            gen = self._dropout_gen(spec.vertex, seed, i) if train else None
            routed = None
            if self.conf.use_kernels:
                routed = kernels.maybe_vertex_forward(spec.vertex, p, s, xs,
                                                      train, gen)
            y, s2 = (routed if routed is not None
                     else spec.vertex.forward(p, s, xs, train=train, gen=gen))
            acts[name] = y
            if name in state:
                new_state[name] = s2
            if not (keep_all or train):
                for src in self._frees.get(i, ()):
                    del acts[src]
        return acts, new_state

    @staticmethod
    def _dropout_gen(vertex, seed, index) -> Optional[torch.Generator]:
        """The vertex's dropout generator for one step (None without
        dropout or without a step seed)."""
        layer = getattr(vertex, "layer", None)
        if seed is None or not 0.0 < getattr(layer, "dropout", 0.0) < 1.0:
            return None
        return torch.Generator().manual_seed(_vertex_seed(seed, index))

    def _cast(self, params):
        """Params in the compute dtype (mixed precision); the output
        vertices keep the storage dtype so logits land in it."""
        if self._cdtype is None:
            return params
        outs = set(self.conf.network_outputs)
        return {k: (vp if k in outs else
                    {pk: v.to(self._cdtype) if v.is_floating_point() else v
                     for pk, v in vp.items()})
                for k, vp in params.items()}

    def _fwd_params(self):
        """The eval forward's params, cast once per set of params."""
        if self._cast_params is None:
            self._cast_params = self._cast(self.params)
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
                                else True,
                                ids=i < len(self._ids) and self._ids[i])
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
            acts, _ = self._forward(self._fwd_params(), self.state,
                                    self._prepare(inputs), keep_all=True)
            return {n: self._to_host(acts[n]) for n in self._topo}

    def output(self, *inputs):
        """Forward pass, eval mode (reference ``#output(INDArray...)``).
        Returns a numpy array per network output (a single array for one
        output), in the storage dtype."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._forward(self._fwd_params(), self.state,
                                    self._prepare(inputs))
            outs = [self._to_host(acts[n]) for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # --- training ----------------------------------------------------------
    def _output_specs(self):
        specs = self.conf.output_vertices()
        for s in specs:
            if not (hasattr(s.vertex, "score") and s.vertex.is_output()):
                raise TypeError(
                    f"output vertex {s.name!r} is not an output layer "
                    "(reference: outputs must be IOutputLayer vertices)")
        return specs

    def _prep_batch(self, ds):
        """(features, labels, label masks) on this graph's device: features
        as ``output`` takes them (uint8 images dequantized on the device),
        labels and masks in the storage dtype."""
        mds = _as_multi(ds)

        def place(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            return t.to(device=self.device, dtype=self._dtype)

        labels = [place(lab) for lab in mds.labels]
        masks = (mds.labels_masks if mds.labels_masks is not None
                 else [None] * len(labels))
        lmasks = [None if m is None else place(m) for m in masks]
        return self._prepare(mds.features), labels, lmasks

    def _loss(self, params, state, features, labels, lmasks, train=True,
              seed=None):
        """The score of one batch and the forward's new state: the forward
        up to the output vertices, then each output vertex's loss on its
        pre-activations with the storage-dtype (f32 master) params, plus
        the regularization terms."""
        out_specs = self._output_specs()
        acts, new_state = self._forward(self._cast(params), state, features,
                                        train, seed,
                                        skip={s.name for s in out_specs})
        loss = 0.0
        for i, spec in enumerate(out_specs):
            x = acts[spec.inputs[0]].to(self._dtype)
            loss = loss + spec.vertex.score(params.get(spec.name, {}), x,
                                            labels[i], lmasks[i])
        return loss + self._regularization_score(params), new_state

    def _regularization_score(self, params):
        total = 0.0
        for name, vparams in params.items():
            v = self._vmap[name].vertex
            conf = getattr(v, "layer", None) or v
            reg_keys = set(v.regularized_param_keys())
            for k, p in vparams.items():
                regs = (getattr(conf, "regularization", ()) if k in reg_keys
                        else getattr(conf, "regularization_bias", ()))
                for r in regs or ():
                    total = total + r.score_term(p)
        return total

    def _backward(self, ds, train_seed=None):
        """Forward + ``backward()`` on detached leaves of the params:
        ``(loss, new_state, grads)``."""
        if self.params is None:
            self.init()
        features, labels, lmasks = self._prep_batch(ds)
        leaves = {k: {pk: v.detach().requires_grad_(v.is_floating_point())
                      for pk, v in vp.items()}
                  for k, vp in self.params.items()}
        loss, new_state = self._loss(leaves, self.state, features, labels,
                                     lmasks, train=True, seed=train_seed)
        loss.backward()
        grads = {k: {pk: (v.grad if v.grad is not None
                          else torch.zeros_like(v))
                     for pk, v in vp.items()}
                 for k, vp in leaves.items()}
        return loss.detach(), new_state, grads

    def compute_gradient_and_score(self, ds):
        """``(grads, score)`` of one batch in train mode, without updating
        params or state (reference ``#computeGradientAndScore``). ``grads``
        mirrors ``params`` (the port's layouts)."""
        loss, _, grads = self._backward(ds)
        return grads, float(loss)

    def fit(self, data, labels=None, epochs: int = 1) -> "ComputationGraph":
        """Train (reference ``ComputationGraph#fit`` overloads: a
        DataSetIterator, a (Multi)DataSet, or (features, labels) arrays)."""
        if self.params is None:
            self.init()
        reset = None
        if isinstance(data, (DataSet, MultiDataSet)):
            batches = [data]
        elif isinstance(data, DataSetIterator) or hasattr(data, "reset"):
            batches, reset = data, data.reset
        elif labels is not None:
            f = data if isinstance(data, (list, tuple)) else [data]
            lab = labels if isinstance(labels, (list, tuple)) else [labels]
            batches = [MultiDataSet(features=list(f), labels=list(lab))]
        else:
            raise TypeError(f"cannot fit from {type(data)}")
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch)
            for ds in batches:
                self._fit_batch(ds)
            if reset is not None:
                reset()
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch)
            self.epoch += 1
        return self

    def fit_batch(self, ds) -> float:
        """One optimization step; returns its loss."""
        return float(self._fit_batch(ds))

    def _fit_batch(self, ds) -> torch.Tensor:
        cur = self.iteration
        loss, new_state, grads = self._backward(
            ds, train_seed=_vertex_seed(self.conf.seed, cur + 1_000_003))
        with torch.no_grad():
            for k in grads:
                v = self._vmap[k].vertex
                layer_conf = getattr(v, "layer", None) or v
                upd = self._updater_for(k)
                g = solver.normalize_layer_gradients(layer_conf, grads[k])
                self.params[k], self.opt_state[k] = \
                    solver.apply_updater_to_layer(
                        layer_conf, upd, self.params[k], g, self.opt_state[k],
                        upd.current_lr(cur, self.epoch), cur, self.epoch)
        self.state.update(new_state)
        self._cast_params = None
        self._score = loss
        self.iteration += 1  # listeners see iteration == next-to-run
        for lst in self.listeners:
            lst.iteration_done(self, cur, self.epoch, loss)
        return loss

    def score(self, ds=None) -> float:
        """The eval-mode loss of ``ds`` (reference ``#score(DataSet)``); with
        no argument, the last training step's loss."""
        if ds is None:
            return float("nan") if self._score is None else float(self._score)
        if self.params is None:
            self.init()
        features, labels, lmasks = self._prep_batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, features, labels,
                                 lmasks, train=False)
        return float(loss)

    # --- misc --------------------------------------------------------------
    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return int(sum(v.numel() for vp in self.params.values()
                       for v in vp.values()))

    def clone(self) -> "ComputationGraph":
        """A new graph on the same conf and device with copied params,
        state and updater state."""
        other = ComputationGraph(self.conf, self.device)
        if self.params is not None:
            other.set_params(self.params, self.state, self.opt_state)
        return other
