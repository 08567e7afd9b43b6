"""ComputationGraph — DAG model runtime: inference and training.

Reference: ``org.deeplearning4j.nn.graph.ComputationGraph``; counterpart of
the JAX package's ``deeplearning4j_tpu/nn/graph.py``. The JAX package
traces the topological walk once into one XLA program; PyTorch runs eagerly,
so here the walk runs on every forward, and in eval mode an activation is
released as soon as its last consumer has run.

Training (``fit``, ``fit_batch``, ``compute_gradient_and_score``,
``evaluate``; ``params_flat`` is the JAX package's flat vector): one step
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
float32's. It also keeps cuBLAS's bfloat16 GEMMs from reducing split-K
partial sums in bfloat16
(``allow_bf16_reduced_precision_reduction = False``): XLA's bfloat16 dot
and the port's kernels accumulate in float32.

Mixed precision (``conf.compute_dtype="bfloat16"``, the JAX package's
policy): the forward and backward run in the compute dtype on a cast copy
of the params, made anew in every step (only the eval forward caches its
copy, dropped whenever the params change); the output vertices keep their
float32 params, so logits and the loss are float32; BN statistics are
taken in the state dtype, float32; gradients land in float32 on the
float32 master params the updater steps. Params, updater state, BN state
and every output stay float32.

``conf.use_kernels`` sends every vertex through
``kernels.maybe_vertex_forward`` first, exactly where the JAX package's
``_forward`` does; 1x1 convolutions and dense layers then run the
hand-written ``matmul_bias_act`` kernel, train-mode ``FusedConvBN1x1``
layers ``matmul_stats``, and ``SelfAttentionLayer`` its core on
``flash_attention`` (each carries the JAX package's backward). An input
consumed by an ``EmbeddingSequenceLayer`` holds token ids and crosses as
``long``.

Truncated BPTT and ``rnn_time_step`` as in ``nn.multilayer``, the carries
keyed by vertex name: every network input must be a sequence of one time
length (a batch of static inputs only trains with the standard step), and
the labels and masks must be per step at that length.

The health layer's guards, the flight recorder and the telemetry step
count as in ``nn.multilayer`` (path ``graph``).

Feature masks (``DataSet.features_mask``, ``MultiDataSet.features_masks``,
``fmasks=`` of ``output`` / ``feed_forward``) are ``[batch, time]`` per
network input. ``_forward`` propagates them along sequence-shaped paths
(``nn.io.propagate_mask``), ANDs (``min``) the masks of a vertex's several
inputs, and hands the result to each ``LayerVertex``, which passes it on
only to a layer with ``uses_mask``, as the JAX package does. A feature
mask is never a label mask: a missing label mask means the mean over
examples.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels, profiler
from deeplearning4j_tpu_torch.comms import global_batch
from deeplearning4j_tpu_torch.conf.graph import (
    ComputationGraphConfiguration,
    LayerVertex,
)
from deeplearning4j_tpu_torch.conf.layers import (
    EmbeddingLayer,
    EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.conf.layers_moe import sum_aux_losses
from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet,
    MultiDataSet,
    host_array,
)
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import io as nn_io
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.telemetry import flightrec
from deeplearning4j_tpu_torch.util import params as params_util

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def serve_full_f32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32),
    and bfloat16 GEMMs' partial sums in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _vertex_seed(seed: int, index: int) -> int:
    """Per-vertex seed (the counterpart of ``fold_in(key, i)``): each
    vertex's weights (and a step's dropout draws) depend only on the seed
    and its topo index."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63)


def dropout_gen(layer, seed, index) -> Optional[torch.Generator]:
    """A layer's dropout generator for one step, seeded from the step seed
    and the layer's index (None without dropout or without a step
    seed)."""
    if seed is None or not 0.0 < getattr(layer, "dropout", 0.0) < 1.0:
        return None
    return torch.Generator().manual_seed(_vertex_seed(seed, index))


def _place(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """A copy of ``t`` on ``device`` (training updates params in place, so
    two graphs never share a tensor)."""
    t = t.to(device=device, dtype=dtype or t.dtype, copy=True)
    if t.ndim == 4:  # conv weights match the channels_last activations
        t = t.contiguous(memory_format=torch.channels_last)
    elif t.ndim == 5:  # 3-D conv weights match channels_last_3d volumes
        t = t.contiguous(memory_format=torch.channels_last_3d)
    return t


def _ndim(a) -> int:
    return a.ndim if hasattr(a, "ndim") else np.ndim(a)


def _is_go_backwards(vertex) -> bool:
    """Whether a vertex's (possibly wrapped) layer processes time reversed
    (Keras go_backwards): under truncated BPTT it restarts from zeros in
    every segment, since its carry would come from the FUTURE segment."""
    return nn_io.contains_go_backwards(getattr(vertex, "layer", None))


def _as_multi(ds) -> MultiDataSet:
    """DataSet -> single-input/single-output MultiDataSet (reference
    ``ComputationGraph#fit(DataSet)`` convenience overload)."""
    if isinstance(ds, MultiDataSet):
        return ds
    return MultiDataSet(
        features=[ds.features], labels=[ds.labels],
        features_masks=([ds.features_mask] if ds.features_mask is not None
                        else None),
        labels_masks=([ds.labels_mask] if ds.labels_mask is not None
                      else None))


class ComputationGraph(nn_io.HealthHooks):
    """DAG network (reference ``ComputationGraph``): ``init``, ``output``,
    ``feed_forward``, ``fit``, ``fit_batch``, ``score``, ``evaluate``,
    ``compute_gradient_and_score``, ``params_flat``, ``summary``,
    ``clone``."""

    _health_path = "graph"

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
        self._rnn_carries: Optional[Dict[str, dict]] = None  # rnn_time_step
        self.last_segment_losses: Optional[torch.Tensor] = None  # tBPTT
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
        consuming it is an embedding layer."""
        return any(name in spec.inputs and isinstance(
            getattr(spec.vertex, "layer", None),
            (EmbeddingLayer, EmbeddingSequenceLayer))
            for spec in self.conf.vertices)

    def set_listeners(self, *listeners: TrainingListener
                      ) -> "ComputationGraph":
        self.listeners = list(listeners)
        return self

    def _updater_for(self, name: str):
        layer = getattr(self._vmap[name].vertex, "layer", None)
        return getattr(layer, "updater", None) or self.conf.updater

    # --- functional core ---------------------------------------------------
    def _ktag(self) -> str:
        """The kernel registry's ``:kern:<id>:<digest>`` tokens
        (``kernels.cache_tag``): empty unless ``conf.use_kernels``, else
        one token per kernel, changed by any retune. The JAX package folds
        it into its step keys; eager PyTorch has no executables to key,
        so it is reported (``GenerationEngine.warmup``), and each routed
        call resolves its tiling against the tuning cache's epoch."""
        if not getattr(self.conf, "use_kernels", False):
            return ""
        return kernels.cache_tag(self.conf)

    def _forward(self, params, state, inputs: Sequence, train=False,
                 seed=None, keep_all=False, skip=frozenset(), fmasks=None,
                 carries=None):
        """DAG forward; returns ``(activations, new_state)``. Eval mode keeps
        every vertex's activation only with ``keep_all`` (else it frees each
        one after its last consumer); train mode keeps them all for the
        backward. ``seed`` seeds the step's dropout generators; ``skip``:
        vertices left out (the loss scores the output vertices itself);
        ``fmasks``: per-input [batch, time] feature masks (or None),
        propagated and handed to mask-consuming layers. ``carries``
        ({vertex name: carry}, or None for zero carries): each
        carry-bearing vertex (``go_backwards`` layers excepted) starts from
        its entry, and the dict receives its final carry in place."""
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        masks: Dict[str, torch.Tensor] = {}
        if fmasks is not None:
            masks.update(zip(self.conf.network_inputs, fmasks))
        new_state = {}
        for i, name in enumerate(self._topo):
            if name in skip:
                continue
            spec = self._vmap[name]
            xs = [acts[src] for src in spec.inputs]
            # several masked inputs (merge vertices): a step is valid only
            # where every input is
            mask = None
            for src in spec.inputs:
                m = masks.get(src)
                if m is not None:
                    mask = m if mask is None else torch.minimum(mask, m)
            kw = ({"mask": mask} if mask is not None
                  and isinstance(spec.vertex, LayerVertex) else {})
            p = params.get(name, {})
            s = state.get(name, {})
            gen = (dropout_gen(getattr(spec.vertex, "layer", None), seed, i)
                   if train else None)
            threaded = carries is not None and getattr(
                spec.vertex, "has_carry", False) and not _is_go_backwards(
                spec.vertex)
            routed = None
            if self.conf.use_kernels and not threaded:
                routed = kernels.maybe_vertex_forward(spec.vertex, p, s, xs,
                                                      train, gen, **kw)
            if threaded:
                c = carries.get(name)
                if c is None:
                    c = spec.vertex.zero_carry(xs[0].shape[0], xs[0].dtype,
                                               xs[0].device)
                y, carries[name] = spec.vertex.forward_with_carry(
                    p, c, xs, train=train, gen=gen, **kw)
                s2 = s
            elif routed is not None:
                y, s2 = routed
            else:
                y, s2 = spec.vertex.forward(p, s, xs, train=train, gen=gen,
                                            **kw)
            acts[name] = y
            masks[name] = nn_io.propagate_mask(mask, y, spec.vertex)
            if name in state:
                new_state[name] = s2
            if not (keep_all or train):
                for src in self._frees.get(i, ()):
                    del acts[src]
        return acts, new_state

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
            t = nn_io.to_internal(t)
            xs.append(t)
        return xs

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        t = nn_io.to_external(t.to(self._dtype))
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()

    def _place_masks(self, masks, n: int):
        """Per-input feature masks on this graph's device in the storage
        dtype (None stays None), or None when no input has one."""
        if masks is None:
            return None
        if len(masks) != n:
            raise ValueError(f"graph takes {n} feature mask(s), got "
                             f"{len(masks)}")
        return [None if m is None else
                (m if isinstance(m, torch.Tensor) else torch.as_tensor(
                    np.asarray(m))).to(device=self.device, dtype=self._dtype)
                for m in masks]

    def feed_forward(self, *inputs, fmasks=None) -> Dict[str, np.ndarray]:
        """Every vertex's activation, eval mode, as host arrays in the JAX
        package's layouts (reference ``ComputationGraph#feedForward``).
        ``fmasks``: per-input feature masks."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._forward(self._fwd_params(), self.state,
                                    self._prepare(inputs), keep_all=True,
                                    fmasks=self._place_masks(fmasks,
                                                             len(inputs)))
            return {n: self._to_host(acts[n]) for n in self._topo}

    def output(self, *inputs, fmasks=None):
        """Forward pass, eval mode (reference ``#output(INDArray...)``).
        Returns a numpy array per network output (a single array for one
        output), in the storage dtype. ``fmasks``: per-input feature masks
        (reference ``#output(INDArray[], INDArray[] featureMasks, ...)``)."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._forward(self._fwd_params(), self.state,
                                    self._prepare(inputs),
                                    fmasks=self._place_masks(fmasks,
                                                             len(inputs)))
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
        """(features, labels, feature masks, label masks) on this graph's
        device: features as ``output`` takes them (uint8 images dequantized
        on the device), labels and masks in the storage dtype (a CUDA
        tensor on this device passes through without a copy)."""
        mds = _as_multi(ds)

        def place(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            return t.to(device=self.device, dtype=self._dtype)

        labels = [place(lab) for lab in mds.labels]
        masks = (mds.labels_masks if mds.labels_masks is not None
                 else [None] * len(labels))
        lmasks = [None if m is None else place(m) for m in masks]
        features = self._prepare(mds.features)
        return (features, labels,
                self._place_masks(mds.features_masks, len(features)), lmasks)

    def _loss(self, params, state, features, labels, fmasks, lmasks,
              train=True, seed=None, carries=None):
        """The score of one batch and the forward's new state: the forward
        up to the output vertices (feature masks propagated), then each
        output vertex's loss on its pre-activations with the storage-dtype
        (f32 master) params, plus the regularization terms. ``carries``:
        as :meth:`_forward`'s."""
        out_specs = self._output_specs()
        acts, new_state = self._forward(self._cast(params), state, features,
                                        train, seed,
                                        skip={s.name for s in out_specs},
                                        fmasks=fmasks, carries=carries)
        loss = 0.0
        for i, spec in enumerate(out_specs):
            x = acts[spec.inputs[0]].to(self._dtype)
            loss = loss + spec.vertex.score(params.get(spec.name, {}), x,
                                            labels[i], lmasks[i])
        if global_batch.adds_regularization():  # once over the ranks
            loss = loss + solver.regularization_score(params,
                                                      self._layer_conf)
        if train:  # eval must not pick up the last step's aux
            loss = loss + sum_aux_losses(new_state, self._dtype)
        return loss, new_state

    def _layer_conf(self, name: str):
        """The conf whose hyperparameters (regularization, gradient
        normalization) apply to vertex ``name``'s params."""
        v = self._vmap[name].vertex
        return getattr(v, "layer", None) or v

    def _layer_updater(self, name: str):
        """``(layer conf, updater)`` of vertex ``name``'s params."""
        return self._layer_conf(name), self._updater_for(name)

    def _train_seed(self, iteration: int) -> int:
        """The dropout seed of the step at ``iteration``."""
        return _vertex_seed(self.conf.seed, iteration + 1_000_003)

    def _backward(self, ds, train_seed=None):
        """Forward + ``backward()`` on detached leaves of the params:
        ``(loss, new_state, grads)``."""
        if self.params is None:
            self.init()
        return self._backward_arrays(*self._prep_batch(ds), seed=train_seed)

    def _backward_arrays(self, features, labels, fmasks, lmasks, seed=None,
                         on_leaves=None, carries=None):
        """The gradient pass on prepared arrays (``_prep_batch``'s):
        ``(loss, new_state, grads)``. ``on_leaves(leaves)`` sees the
        detached param leaves before the forward (the data-parallel
        trainer hooks their gradients). ``carries`` (a tBPTT segment's):
        read, then replaced in place by the final carries, detached."""
        leaves = {k: {pk: v.detach().requires_grad_(v.is_floating_point())
                      for pk, v in vp.items()}
                  for k, vp in self.params.items()}
        if on_leaves is not None:
            on_leaves(leaves)
        loss, new_state = self._loss(leaves, self.state, features, labels,
                                     fmasks, lmasks, train=True, seed=seed,
                                     carries=carries)
        loss.backward()
        if carries is not None:
            for k, c in carries.items():
                carries[k] = {n: t.detach() for n, t in c.items()}
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

    def fit(self, data, labels=None, epochs: int = 1,
            fused_steps: Optional[int] = None) -> "ComputationGraph":
        """Train (reference ``ComputationGraph#fit`` overloads: a
        DataSetIterator, a (Multi)DataSet, or (features, labels) arrays).
        ``fused_steps=K`` trains identically to K = 1, as in
        ``MultiLayerNetwork.fit``: the steps run one after another."""
        if self.params is None:
            self.init()
        nn_io.check_fused_steps(fused_steps, self.conf)
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
        with flightrec.flight_recorder(model=self), \
                self._health_fused(fused_steps):
            for _ in range(epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self, self.epoch)
                for ds in batches:
                    self._fit_batch(ds)
                self._health_flush_fused()
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
        if self.params is None:
            self.init()
        if self.conf.backprop_type is BackpropType.TRUNCATED_BPTT:
            ndims = [_ndim(f) for f in _as_multi(ds).features]
            if all(d == 3 for d in ndims):
                args = self.tbptt_batch_arrays(ds)
                feats = args[0]
                # the same once-per-step injection site as the standard step
                feats = [faults.fault_point("train.step", feats[0])] + list(
                    feats[1:])
                return self._fit_tbptt(feats, *args[1:])
            if any(d == 3 for d in ndims):
                # a mixed sequence / static batch must not silently train
                # the standard step under a tBPTT conf
                raise ValueError(
                    "ComputationGraph truncated BPTT requires every "
                    "network input to be a sequence [batch, time, size]; "
                    f"got feature ranks {ndims}. Use STANDARD backprop "
                    "for mixed sequence/static inputs")
            # no sequence input at all: the standard step
        features, labels, fmasks, lmasks = self._prep_batch(ds)
        # injection site (raise = preemption mid-training, corrupt = a
        # poisoned batch for the health guards)
        features = [faults.fault_point("train.step", features[0])] + list(
            features[1:])
        cur = self.iteration
        loss, new_state, grads = self._backward_arrays(
            features, labels, fmasks, lmasks, seed=self._train_seed(cur))
        vec = self._update_pass(loss, grads, new_state, cur)
        return self._finish_step(loss, cur, vec, (features, labels))

    def _apply_updates(self, grads, cur: int) -> None:
        """The update pass: each layer's gradient normalization,
        regularization and updater, applied to the params in place."""
        solver.apply_updates(self, grads, cur, self.epoch)

    def _finish_step(self, loss, cur: int, vec=None,
                     batch=None) -> torch.Tensor:
        """Step bookkeeping after the update: the score, the counters,
        the telemetry step (``batch``: the step's (features, labels)), the
        health epilogue (``vec``: its guard vector) and the listeners."""
        self._cast_params = None
        self._score = loss
        self.iteration += 1  # listeners see iteration == next-to-run
        if batch is not None:
            self._health_epilogue(cur, loss, vec, batch)
        if profiler.panic_enabled():
            profiler.check_step(loss, self._health_path, cur)
        for lst in self.listeners:
            lst.iteration_done(self, cur, self.epoch, loss)
        return loss

    # --- truncated BPTT ----------------------------------------------------
    def tbptt_batch_arrays(self, ds):
        """One tBPTT batch as :meth:`tbptt_scan_fn`'s run takes it: on the
        device, every input a sequence of one T, the labels per step at
        that T, all-ones default masks, per-example labels masks expanded
        per step, every mask at the input rate."""
        features, labels, fmasks, lmasks = self._prep_batch(ds)
        if any(f.ndim != 3 for f in features):
            raise ValueError(
                "ComputationGraph truncated BPTT requires every network "
                "input to be a sequence [batch, time, size]; got shapes "
                f"{[tuple(f.shape) for f in features]}")
        ts = {int(f.shape[1]) for f in features}
        if len(ts) != 1:
            raise ValueError(
                f"tBPTT inputs must share one time length, got {sorted(ts)}")
        total_t = ts.pop()
        n = int(features[0].shape[0])
        for i, l in enumerate(labels):
            if l.ndim != 3 or int(l.shape[1]) != total_t:
                raise ValueError(
                    f"truncated BPTT needs per-timestep labels [batch, "
                    f"{total_t}, nOut] for output {i}, got shape "
                    f"{tuple(l.shape)} (reference tBPTT operates on "
                    "sequence labels)")
        ones = torch.ones((n, total_t), dtype=self._dtype, device=self.device)
        fmasks = [ones if m is None else m
                  for m in (fmasks or [None] * len(features))]
        lmasks = [ones if m is None else (m[:, None] * ones if m.ndim == 1
                                          else m) for m in lmasks]
        for kind, group in (("features mask", fmasks),
                            ("labels mask", lmasks)):
            for i, m in enumerate(group):
                if int(m.shape[1]) != total_t:
                    raise ValueError(
                        f"truncated BPTT {kind} {i} has {m.shape[1]} "
                        f"timesteps but the sequences have {total_t}: "
                        "masks must be at the INPUT rate (a wrong-length "
                        "mask would desynchronize the segments)")
        return features, labels, fmasks, lmasks

    def tbptt_scan_parts(self, seg: int, back: Optional[int] = None):
        """``MultiLayerNetwork.tbptt_scan_parts`` over the DAG:
        ``segments(group)`` cuts each array of a list, ``zero_carries``
        keys the carries by vertex name, ``advance`` runs the segment's
        head through the graph minus its output vertices."""
        back = seg if back is None else min(int(back), seg)
        cut = seg - back
        out_names = set(self.conf.network_outputs)
        cdt = self._cdtype or self._dtype

        def segments(group):
            return [nn_io.tbptt_segments(a, seg, cut) for a in group]

        def zero_carries(features):
            f0 = features[0]
            return {name: self._vmap[name].vertex.zero_carry(
                        f0.shape[0], cdt, f0.device)
                    for name in self._topo
                    if getattr(self._vmap[name].vertex, "has_carry", False)
                    and not _is_go_backwards(self._vmap[name].vertex)}

        def advance(carries, f_s, l_s, fm_s, lm_s):
            if cut:
                with torch.no_grad():
                    self._forward(self._cast(self.params), self.state,
                                  [f[:, :cut] for f in f_s], skip=out_names,
                                  fmasks=[m[:, :cut] for m in fm_s],
                                  carries=carries)
                f_s, l_s, fm_s, lm_s = ([a[:, cut:] for a in g]
                                        for g in (f_s, l_s, fm_s, lm_s))
            return f_s, l_s, fm_s, lm_s

        return segments, zero_carries, advance, cut

    def tbptt_scan_fn(self, seg: int, back: Optional[int] = None):
        """The whole-batch tBPTT runner over the DAG: ``run(features,
        labels, fmasks, lmasks) -> segment losses [n_seg]`` (lists of
        arrays), one optimization step per segment in place."""
        segments, zero_carries, advance, _ = self.tbptt_scan_parts(seg, back)

        def run(features, labels, fmasks, lmasks):
            carries = zero_carries(features)
            groups = [list(zip(*segments(g)))
                      for g in (features, labels, fmasks, lmasks)]
            losses, vecs = [], []
            for f_s, l_s, fm_s, lm_s in zip(*groups):
                f_s, l_s, fm_s, lm_s = advance(carries, f_s, l_s, fm_s, lm_s)
                cur = self.iteration
                old = dict(carries)
                loss, new_state, grads = self._backward_arrays(
                    list(f_s), list(l_s), list(fm_s), list(lm_s),
                    seed=self._train_seed(cur), carries=carries)
                vecs.append(self._update_pass(loss, grads, new_state, cur,
                                              (old, carries)))
                self._cast_params = None
                self.iteration += 1
                losses.append(loss)
            self._tbptt_guard = self._combine_guards(vecs)
            return torch.stack(losses)

        return run

    def _fit_tbptt(self, features, labels, fmasks, lmasks) -> torch.Tensor:
        """Truncated BPTT on one prepared batch: one update per segment,
        the score the mean of the segment losses, one listener call at the
        last segment's iteration."""
        seg = int(self.conf.tbptt_fwd_length)
        back = min(int(self.conf.tbptt_back_length or seg), seg)
        losses = self.tbptt_scan_fn(seg, back)(features, labels, fmasks,
                                               lmasks)
        self.last_segment_losses = losses
        loss = losses.mean()
        self._score = loss
        self._health_epilogue(self.iteration - 1, loss, self._tbptt_guard,
                              (features, labels))
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration - 1, self.epoch, loss)
        return loss

    # --- stateful RNN inference (reference CG#rnnTimeStep) -------------------
    def rnn_time_step(self, *inputs, fmasks=None):
        """Streaming inference (reference ``#rnnTimeStep``): feed a chunk
        ``[batch, t, size]`` (or one step ``[batch, size]``) per input, get
        each output as a host array, the carry-bearing vertices' state
        carried across calls."""
        if self.params is None:
            self.init()
        for name in self._topo:
            # the vertex itself (AttentionVertex), then its layer chain
            nn_io.check_streaming_safe(self._vmap[name].vertex,
                                       f"vertex {name!r}")
        xs = [x[:, None, :] if x.ndim == 2 else x
              for x in self._prepare(inputs)]
        if self._rnn_carries is None:
            cdt = self._cdtype or self._dtype
            self._rnn_carries = {
                name: self._vmap[name].vertex.zero_carry(
                    xs[0].shape[0], cdt, self.device)
                for name in self._topo
                if getattr(self._vmap[name].vertex, "has_carry", False)}
        with torch.no_grad():
            acts, _ = self._forward(self._fwd_params(), self.state, xs,
                                    fmasks=self._place_masks(fmasks,
                                                             len(xs)),
                                    carries=self._rnn_carries)
            outs = [self._to_host(acts[n]) for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        """Reference ``#rnnClearPreviousState``."""
        self._rnn_carries = None

    def rnn_get_previous_state(self, vertex_name: str) -> Optional[dict]:
        """Reference ``#rnnGetPreviousState(layerName)``: the vertex's carry
        in the storage dtype, or None."""
        if self._rnn_carries is None:
            return None
        c = self._rnn_carries.get(vertex_name)
        if c is None:
            return None
        return {k: v.to(self._dtype) for k, v in c.items()}

    def rnn_set_previous_state(self, vertex_name: str, state: dict) -> None:
        """Reference ``#rnnSetPreviousState(layerName, state)``: the
        vertex's carry, held in the compute dtype."""
        if self._rnn_carries is None:
            self._rnn_carries = {}
        cdt = self._cdtype or self._dtype
        self._rnn_carries[vertex_name] = {
            k: torch.as_tensor(v).to(device=self.device, dtype=cdt)
            for k, v in state.items()}

    def score(self, ds=None) -> float:
        """The eval-mode loss of ``ds`` (reference ``#score(DataSet)``); with
        no argument, the last training step's loss."""
        if ds is None:
            return float("nan") if self._score is None else float(self._score)
        if self.params is None:
            self.init()
        features, labels, fmasks, lmasks = self._prep_batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, features, labels,
                                 fmasks, lmasks, train=False)
        return float(loss)

    def evaluate(self, iterator, evaluation: Optional[Evaluation] = None):
        """Reference ``#evaluate(DataSetIterator)`` on the first output."""
        ev = evaluation if evaluation is not None else Evaluation()
        for ds in ([iterator] if isinstance(iterator, (DataSet, MultiDataSet))
                   else iterator):
            mds = _as_multi(ds)
            out = self.output(*mds.features, fmasks=mds.features_masks)
            if isinstance(out, list):
                out = out[0]
            mask = (mds.labels_masks[0] if mds.labels_masks is not None
                    else None)
            ev.eval(host_array(mds.labels[0]), out, mask=host_array(mask))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    # --- params vector -----------------------------------------------------
    def params_flat(self) -> np.ndarray:
        """The one contiguous params vector (reference ``#params()``), in
        the JAX package's order and layouts (``util.params``)."""
        if self.params is None:
            self.init()
        return params_util.flatten_params(self.conf, self.params)

    def set_params_flat(self, flat) -> "ComputationGraph":
        """Copy ``flat`` (``params_flat``'s layout) into the params in
        place; the updater state stays."""
        params_util.unflatten_params(self.conf, flat, self.params)
        self._cast_params = None
        return self

    def summary(self) -> str:
        """Vertex table (reference ``#summary``)."""
        lines = ["=" * 78,
                 f"{'vertex':<24} {'type':<24} {'inputs':<18} {'params':>9}",
                 "-" * 78]
        total = 0
        for name in self._topo:
            spec = self._vmap[name]
            n = 0
            if self.params and name in self.params:
                n = sum(v.numel() for v in self.params[name].values())
            total += n
            layer = getattr(spec.vertex, "layer", None)
            vname = type(layer if layer is not None else spec.vertex).__name__
            lines.append(f"{name:<24} {vname:<24} "
                         f"{','.join(spec.inputs):<18} {n:>9,}")
        lines += ["-" * 78, f"Total params: {total:,}", "=" * 78]
        return "\n".join(lines)

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
