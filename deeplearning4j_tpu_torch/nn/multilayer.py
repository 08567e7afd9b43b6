"""MultiLayerNetwork — sequential model runtime: inference and training.

Reference: ``org.deeplearning4j.nn.multilayer.MultiLayerNetwork``;
counterpart of the JAX package's ``deeplearning4j_tpu/nn/multilayer.py``:
``init``, ``fit`` (an iterator, a DataSet or arrays), ``fit_batch``,
``output``, ``feed_forward``, ``score``, ``evaluate``,
``compute_gradient_and_score``, truncated BPTT, ``rnn_time_step`` and the
previous-state API, the flat params vector, ``summary``, ``clone`` and
``num_params``.

Params, state and updater state are keyed ``"0".."n"`` by layer index, as
in the JAX package. At the public boundary ``output`` takes the JAX
package's arrays (NHWC images, numpy or torch; uint8 images are scaled by
1/255 on the device) and returns numpy; inside, image tensors are logical
NCHW in ``channels_last`` memory. Floating-point params are held in the
storage dtype; integer params (a quantized layer's int8 ``Wq``) keep their
dtype. ``params_flat`` is the reference's one contiguous vector in the
JAX package's order and layouts (``util.params``), the vector the
ModelSerializer zip holds.

One training step is the train-mode forward up to the output layer, the
output layer's loss on its pre-activations with the storage-dtype params
plus the regularization score, ``backward()``, then under
``torch.no_grad()`` each layer's gradient normalization, regularization
and updater (``optimize.solver``), applied to the params in place. BN
running statistics come back as a new state outside the autograd graph.
Dropout draws come from a ``torch.Generator`` per layer and step, seeded
from ``conf.seed``, the iteration and the layer index. The step's score
stays on the device until something reads it (``score()``, a listener's
``float(score)``), so ``fit`` launches step after step without waiting for
the card. ``fused_steps=K`` feeds ``fit`` from a K-stacking
``datasets.prefetch.DeviceRingIterator`` on the network's device (one
staged ``[K, B, ...]`` super-batch a group, its copy under the running
steps) and trains each group's K batches one after another, identically
to K = 1: eager PyTorch has no compiled multi-step program to fuse, and
the step already launches without a host sync.

Under a health mode (``telemetry.health.configure``) every step also
computes its guard vector on the device and hands it to the monitor; under
``SKIP_STEP`` the update is selected against the old values by the guard's
device flag, so a poisoned step changes nothing (``nn.io.HealthHooks``).
A tBPTT batch's guard is the elementwise max over its segments; a fused
group's K vectors reach the monitor together after the group, as the JAX
package's fused scan hands them over. ``fit`` runs inside the flight
recorder, and every step counts into ``telemetry.record_step``.

Truncated BPTT (``BackpropType.TRUNCATED_BPTT`` with sequence features
``[batch, time, size]``): the time axis is cut into segments of
``tbptt_fwd_length`` (the tail padded with masked steps), and the segments
run in a Python loop, one optimization step each, the recurrent layers'
carries handed from segment to segment detached. With ``tbptt_back_length
< tbptt_fwd_length`` the first ``fwd - back`` steps of a segment only
advance the carries, in eval mode under ``torch.no_grad()``, and the
gradient window is the segment's last ``back`` steps (a padded tail's real
steps are moved into that window). The batch's score is the mean of its
segment losses. ``go_backwards`` layers restart from zeros in every
segment. ``rnn_time_step`` streams chunks through the same carries (the
reference's ``rnnTimeStep`` state maps); the carries live in the compute
dtype.

``conf.use_kernels`` sends every layer through ``kernels.maybe_forward``
first, in train mode as in eval mode, as the JAX package's ``_forward``
does: dense layers and 1x1 convolutions then run ``matmul_bias_act`` (an
autograd Function, so the routed layer trains), the int8 layers of a
quantized artifact ``matmul_bias_act_int8``. ``feed_forward`` runs the
stock layer forwards, as the JAX package's does (calibration reads it).

Precision and the mixed-precision policy (``conf.compute_dtype``) as in
``nn.graph``: a network on a CUDA device runs float32 in full float32 (TF32
off); under ``compute_dtype="bfloat16"`` the layers before the output layer
run in bfloat16 on a cast copy of the params made in every step, while the
output layer, the loss, params, updater state, BN state and outputs stay
float32. A first layer that embeds token ids takes them as ``long``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels, profiler
from deeplearning4j_tpu_torch.comms import global_batch
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import (
    EmbeddingLayer,
    EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.conf.layers_moe import sum_aux_losses
from deeplearning4j_tpu_torch.conf.multilayer import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, host_array
from deeplearning4j_tpu_torch.datasets.iterators import (
    ArrayDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import io as nn_io
from deeplearning4j_tpu_torch.nn.graph import (
    _ndim,
    _place,
    _torch_dtype,
    _vertex_seed,
    dropout_gen,
    serve_full_f32,
)
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.telemetry import flightrec
from deeplearning4j_tpu_torch.util import params as params_util


def _as_iterator(data, labels=None, batch_size: Optional[int] = None):
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        return ListDataSetIterator([data])
    if labels is not None:
        return ArrayDataSetIterator(data, labels,
                                    batch_size or np.asarray(data).shape[0],
                                    drop_last=False)
    raise TypeError(f"cannot build DataSetIterator from {type(data)}")


class MultiLayerNetwork(nn_io.HealthHooks):
    """Sequential network (reference ``MultiLayerNetwork``)."""

    _health_path = "multilayer"

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
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
        self.last_batch_size: Optional[int] = None
        self._score: Optional[torch.Tensor] = None  # the last step's loss
        self._dtype = _torch_dtype(conf.dtype)
        self._cdtype = (_torch_dtype(conf.compute_dtype)
                        if conf.compute_dtype else None)
        self._cast_params = None  # compute-dtype copy of params, built once
        self._rnn_carries: Optional[Dict[str, dict]] = None  # rnn_time_step
        self.last_segment_losses: Optional[torch.Tensor] = None  # tBPTT
        # a tensor-parallel step's parallel.tensor.ModelAxis: params hold
        # this rank's slices, and split layers run through it
        self._model_axis = None
        self._image = nn_io.image_input(conf.input_type)
        # token ids cross as integers (a bfloat16 cast would round them)
        self._ids = bool(conf.layers) and isinstance(
            conf.layers[0], (EmbeddingLayer, EmbeddingSequenceLayer))

    # --- lifecycle ---------------------------------------------------------
    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's params from a ``torch.Generator`` seeded by
        ``conf.seed`` and the layer index (on the CPU, so a seed gives the
        same weights on every device), then place them; the updater starts
        afresh."""
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

    def set_params(self, params: Dict[str, dict], state: Dict[str, dict],
                   opt_state: Optional[Dict[str, dict]] = None
                   ) -> "MultiLayerNetwork":
        """Adopt ``{"i": {name: tensor}}`` params and state (e.g. from
        ``util.convert.params_from_jax``), copied onto this network's
        device: floating-point tensors in the storage dtype, integer ones
        (int8 ``Wq``) in their own; conv weights ``channels_last``, every
        other tensor contiguous (the kernels take row-major operands).
        ``opt_state`` (``{"i": {param: {name: tensor}}}``, e.g. from
        ``util.convert.opt_state_from_jax``) resumes an updater; None
        starts each layer's updater afresh."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            t = torch.as_tensor(tree)
            t = _place(t, self.device,
                       self._dtype if t.is_floating_point() else None)
            return t if t.ndim in (4, 5) else t.contiguous()

        self.params = place(params)
        self.state = place(state)
        self.opt_state = (place(opt_state) if opt_state is not None else
                          {k: {pk: self._updater_for(int(k)).init_state(v)
                               for pk, v in vp.items()}
                           for k, vp in self.params.items()})
        self._cast_params = None
        return self

    def set_listeners(self, *listeners: TrainingListener
                      ) -> "MultiLayerNetwork":
        self.listeners = list(listeners)
        return self

    def _updater_for(self, index: int):
        layer = self.conf.layers[index]
        return getattr(layer, "updater", None) or self.conf.updater

    # --- forward -----------------------------------------------------------
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

    def _run(self, params, state, x, train=False, seed=None, upto=None,
             fmask=None, keep_all=False, carries=None, start=0):
        """The forward over layers ``[start, upto)`` (a pipeline stage runs
        its own span); returns ``(x, new_state)``
        (``keep_all``: every layer's activation instead of the last, stock
        forwards only, as the JAX package's ``feed_forward``). ``seed``
        seeds the step's dropout generators; ``fmask`` ([batch, time]) goes
        to layers with ``uses_mask`` and is propagated past each layer.
        ``carries`` ({layer index: carry}, or None for zero carries): each
        recurrent layer (``go_backwards`` ones excepted) starts from its
        entry, and the dict receives the layer's final carry in place."""
        n = len(self.conf.layers) if upto is None else upto
        route = self.conf.use_kernels and not keep_all
        remat = train and self.conf.gradient_checkpointing
        acts, new_state = [], {}
        for i in range(start, n):
            layer = self.conf.layers[i]
            p = params.get(str(i), {})
            s = state.get(str(i), {})
            kw = ({"mask": fmask} if getattr(layer, "uses_mask", False)
                  else {})
            threaded = carries is not None and getattr(
                layer, "has_carry", False) and not nn_io.contains_go_backwards(
                layer)
            routed = None
            ax = self._model_axis
            if ax is not None and str(i) in ax.splits:
                if ax.direct(str(i)) and not threaded:
                    routed = ax.layer_forward(layer, str(i), p, s, x, train,
                                              dropout_gen(layer, seed, i), kw)
                else:  # the general route: the sharded leaves whole
                    p = ax.gathered(str(i), p)
            if routed is None and route and not threaded:
                routed = kernels.maybe_forward(
                    layer, p, s, x, train, dropout_gen(layer, seed, i), **kw)
            if threaded:
                c = carries.get(str(i))
                if c is None:
                    c = layer.zero_carry(x.shape[0], x.dtype, x.device)
                x, carries[str(i)] = layer.forward_with_carry(
                    p, c, x, train=train, gen=dropout_gen(layer, seed, i),
                    **kw)
                s2 = s
            elif routed is not None:
                x, s2 = routed
            elif remat and layer.has_params():
                x, s2 = self._checkpointed(layer, p, s, x, seed, i, kw)
            else:
                x, s2 = layer.forward(p, s, x, train=train,
                                      gen=dropout_gen(layer, seed, i), **kw)
            if str(i) in state:
                new_state[str(i)] = s2
            fmask = nn_io.propagate_mask(fmask, x, layer)
            if keep_all:
                acts.append(x)
        return (acts if keep_all else x), new_state

    @staticmethod
    def _checkpointed(layer, p, s, x, seed, index, kw):
        """A train-mode layer forward whose activations are recomputed in
        the backward (``gradient_checkpointing``). The dropout generator is
        made inside, so the recompute draws the same mask."""
        from torch.utils.checkpoint import checkpoint

        names = list(p)
        holder = {}

        def fwd(x, *values):
            y, s2 = layer.forward(dict(zip(names, values)), s, x, train=True,
                                  gen=dropout_gen(layer, seed, index), **kw)
            holder["state"] = s2
            return y

        y = checkpoint(fwd, x, *[p[k] for k in names], use_reentrant=False)
        return y, holder["state"]

    def _forward(self, params, x, keep_all=False):
        """Eval-mode forward over every layer; returns the last activation,
        or every layer's with ``keep_all``."""
        return self._run(params, self.state, x, keep_all=keep_all)[0]

    def _cast(self, params):
        """Params in the compute dtype (mixed precision); the output layer
        keeps the storage dtype so logits land in it."""
        if self._cdtype is None:
            return params
        last = str(len(self.conf.layers) - 1)
        return {k: (vp if k == last else
                    {pk: v.to(self._cdtype) if v.is_floating_point() else v
                     for pk, v in vp.items()})
                for k, vp in params.items()}

    def _fwd_params(self):
        """The eval forward's params, cast once per set of params."""
        if self._cast_params is None:
            self._cast_params = self._cast(self.params)
        return self._cast_params

    def _prepare(self, x) -> torch.Tensor:
        return nn_io.to_internal(nn_io.as_device(
            x, self.device, self._dtype, self._cdtype or self._dtype,
            scale=self._image, ids=self._ids))

    def _on_device(self, a) -> Optional[torch.Tensor]:
        """A label or mask array on this network's device in the storage
        dtype (None stays None; a tensor already there is not copied)."""
        if a is None:
            return None
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(device=self.device, dtype=self._dtype)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        t = nn_io.to_external(t.to(self._dtype))
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()

    def output(self, x, batch_size: Optional[int] = None,
               fmask=None) -> np.ndarray:
        """Forward pass, eval mode (reference ``#output``), as a host array
        in the storage dtype; ``batch_size`` runs it in chunks of that many
        examples, ``fmask`` is a [batch, time] feature mask."""
        if self.params is None:
            self.init()
        n = int(x.shape[0]) if hasattr(x, "shape") else len(x)
        step = int(batch_size) if batch_size else max(n, 1)
        outs = []
        with torch.inference_mode():
            for lo in range(0, max(n, 1), step):
                m = (None if fmask is None
                     else self._on_device(fmask[lo:lo + step]))
                y, _ = self._run(self._fwd_params(), self.state,
                                 self._prepare(x[lo:lo + step]), fmask=m)
                outs.append(self._to_host(y))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def feed_forward(self, x, fmask=None) -> List[np.ndarray]:
        """Every layer's activation, eval mode, input excluded (reference
        ``MultiLayerNetwork#feedForward``), as host arrays in the JAX
        package's layouts."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._run(self._fwd_params(), self.state,
                                self._prepare(x),
                                fmask=self._on_device(fmask),
                                keep_all=True)
            return [self._to_host(a) for a in acts]

    # --- training ----------------------------------------------------------
    def _output_layer(self):
        last = self.conf.layers[-1]
        if not hasattr(last, "score"):
            raise TypeError(
                f"last layer {type(last).__name__} is not an output layer "
                "(reference: fit() requires an IOutputLayer)")
        return last

    def _batch_arrays(self, ds: DataSet):
        """(features, labels, feature mask, labels mask) on this network's
        device: features as ``output`` takes them, the rest in the storage
        dtype."""
        return (self._prepare(ds.features), self._on_device(ds.labels),
                self._on_device(ds.features_mask),
                self._on_device(ds.labels_mask))

    def _loss(self, params, features, labels, fmask, lmask, train=True,
              seed=None, carries=None):
        """The score of one batch and the forward's new state: the forward
        up to the output layer, then the output layer's loss on its
        pre-activations with the storage-dtype (f32 master) params, plus
        the regularization score. ``carries``: as :meth:`_run`'s."""
        last = len(self.conf.layers) - 1
        out_layer = self._output_layer()
        x, new_state = self._run(self._cast(params), self.state, features,
                                 train, seed, upto=last, fmask=fmask,
                                 carries=carries)
        ax = self._model_axis
        if ax is not None and str(last) in ax.splits:
            loss = ax.layer_score(out_layer, str(last),
                                  params.get(str(last), {}),
                                  x.to(self._dtype), labels, lmask)
        else:
            loss = out_layer.score(params.get(str(last), {}),
                                   x.to(self._dtype), labels, lmask)
        if global_batch.adds_regularization():  # once over the ranks
            loss = loss + solver.regularization_score(
                params, lambda key: self.conf.layers[int(key)])
        if train:  # eval must not pick up the last step's aux
            loss = loss + sum_aux_losses(new_state, self._dtype)
        return loss, new_state

    def _layer_updater(self, key: str):
        """``(layer conf, updater)`` of layer ``key``'s params."""
        return self.conf.layers[int(key)], self._updater_for(int(key))

    def _train_seed(self, iteration: int) -> int:
        """The dropout seed of the step at ``iteration``."""
        return _vertex_seed(self.conf.seed, iteration + 1_000_003)

    def _backward(self, features, labels, fmask, lmask, seed=None,
                  on_leaves=None, carries=None):
        """Forward + ``backward()`` on detached leaves of the params:
        ``(loss, new_state, grads)``. ``on_leaves(leaves)`` sees the
        detached param leaves before the forward (the data-parallel
        trainer hooks their gradients). ``carries`` (a tBPTT segment's):
        read, then replaced in place by the final carries, detached (no
        gradient crosses a segment boundary)."""
        leaves = {k: {pk: v.detach().requires_grad_(v.is_floating_point())
                      for pk, v in vp.items()}
                  for k, vp in self.params.items()}
        if on_leaves is not None:
            on_leaves(leaves)
        loss, new_state = self._loss(leaves, features, labels, fmask, lmask,
                                     train=True, seed=seed, carries=carries)
        loss.backward()
        if carries is not None:
            for k, c in carries.items():
                carries[k] = {n: t.detach() for n, t in c.items()}
        grads = {k: {pk: (v.grad if v.grad is not None
                          else torch.zeros_like(v))
                     for pk, v in vp.items()}
                 for k, vp in leaves.items()}
        return loss.detach(), new_state, grads

    def compute_gradient_and_score(self, ds: DataSet):
        """``(grads, score)`` of one batch in train mode without dropout,
        updating nothing (reference ``#computeGradientAndScore``). ``grads``
        mirrors ``params`` (the port's layouts)."""
        if self.params is None:
            self.init()
        loss, _, grads = self._backward(*self._batch_arrays(ds))
        return grads, float(loss)

    def fit(self, data, labels=None, epochs: int = 1,
            batch_size: Optional[int] = None,
            fused_steps: Optional[int] = None) -> "MultiLayerNetwork":
        """Train (reference ``MultiLayerNetwork#fit`` overloads: a
        DataSetIterator, a DataSet, or (features, labels) arrays, batched
        by ``batch_size``). ``fused_steps=K`` groups K steps fed by a
        K-stacking device ring (see the module docstring); K > 1 takes
        standard backprop only."""
        if self.params is None:
            self.init()
        iterator = nn_io.wrap_fused(_as_iterator(data, labels, batch_size),
                                    fused_steps, self.conf, self.device)
        with flightrec.flight_recorder(model=self), \
                self._health_fused(fused_steps):
            for _ in range(epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self, self.epoch)
                for ds in iterator:
                    self._fit_batch(ds)
                self._health_flush_fused()
                iterator.reset()
                for lst in self.listeners:
                    lst.on_epoch_end(self, self.epoch)
                self.epoch += 1
        return self

    def fit_batch(self, ds: DataSet) -> float:
        """One optimization step on one minibatch; returns its loss."""
        if self.params is None:
            self.init()
        return float(self._fit_batch(ds))

    def _fit_batch(self, ds: DataSet) -> torch.Tensor:
        k = int(getattr(ds, "fused_stack", 0) or 0)
        if k > 1:
            return self._fit_stacked(ds, k)
        if self.conf.backprop_type is BackpropType.TRUNCATED_BPTT \
                and _ndim(ds.features) == 3:
            args = self.tbptt_batch_arrays(ds)
            # the same once-per-step injection site as the standard step
            args = (faults.fault_point("train.step", args[0]),) + args[1:]
            return self._fit_tbptt(*args)
        features, labels, fmask, lmask = self._batch_arrays(ds)
        # injection site (raise = preemption mid-training, corrupt = a
        # poisoned batch for the health guards)
        features = faults.fault_point("train.step", features)
        cur = self.iteration
        loss, new_state, grads = self._backward(
            features, labels, fmask, lmask, seed=self._train_seed(cur))
        vec = self._update_pass(loss, grads, new_state, cur)
        self.last_batch_size = int(features.shape[0])
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
    def tbptt_batch_arrays(self, ds: DataSet):
        """One tBPTT batch as :meth:`tbptt_scan_fn`'s run takes it: on the
        device, per-step labels checked, all-ones default masks, a
        per-example labels mask expanded per step. The run pads T to a
        multiple of the segment (``nn.io.tbptt_segments``)."""
        features, labels, fmask, lmask = self._batch_arrays(ds)
        if labels.ndim != 3:
            raise ValueError(
                "truncated BPTT needs per-timestep labels [batch, time, "
                f"nOut], got shape {tuple(labels.shape)} (reference tBPTT "
                "operates on sequence labels; use STANDARD backprop for "
                "sequence-level classification heads)")
        n, t = features.shape[:2]
        ones = torch.ones((n, t), dtype=self._dtype, device=self.device)
        if fmask is None:
            fmask = ones
        if lmask is None:
            lmask = ones
        elif lmask.ndim == 1:
            lmask = lmask[:, None] * ones
        return features, labels, fmask, lmask

    def tbptt_scan_parts(self, seg: int, back: Optional[int] = None):
        """The tBPTT plumbing, ``(segments, zero_carries, advance, cut)``:

        - ``segments(arr)``: ``nn.io.tbptt_segments`` of ``arr``;
        - ``zero_carries(features)``: {layer index: zero carry} in the
          compute dtype for the carry-bearing layers (``go_backwards``
          layers excepted: they restart every segment);
        - ``advance(carries, f, l, fm, lm)``: run the segment's first
          ``cut = seg - back`` steps in eval mode without gradients,
          advancing ``carries`` in place, and return the gradient
          window's ``(f, l, fm, lm)``."""
        back = seg if back is None else min(int(back), seg)
        cut = seg - back
        last = len(self.conf.layers) - 1
        cdt = self._cdtype or self._dtype

        def segments(arr):
            return nn_io.tbptt_segments(arr, seg, cut)

        def zero_carries(features):
            return {str(i): layer.zero_carry(features.shape[0], cdt,
                                             features.device)
                    for i, layer in enumerate(self.conf.layers)
                    if getattr(layer, "has_carry", False)
                    and not nn_io.contains_go_backwards(layer)}

        def advance(carries, f_s, l_s, fm_s, lm_s):
            if cut:
                with torch.no_grad():
                    self._run(self._cast(self.params), self.state,
                              f_s[:, :cut], upto=last, fmask=fm_s[:, :cut],
                              carries=carries)
                f_s, l_s, fm_s, lm_s = (a[:, cut:]
                                        for a in (f_s, l_s, fm_s, lm_s))
            return f_s, l_s, fm_s, lm_s

        return segments, zero_carries, advance, cut

    def tbptt_scan_fn(self, seg: int, back: Optional[int] = None):
        """The whole-batch tBPTT runner: ``run(features, labels, fmask,
        lmask) -> segment losses [n_seg]`` trains one optimization step per
        segment on this network's params in place, the carries handed on
        detached."""
        segments, zero_carries, advance, _ = self.tbptt_scan_parts(seg, back)

        def run(features, labels, fmask, lmask):
            carries = zero_carries(features)
            losses, vecs = [], []
            for f_s, l_s, fm_s, lm_s in zip(*(segments(a) for a in (
                    features, labels, fmask, lmask))):
                f_s, l_s, fm_s, lm_s = advance(carries, f_s, l_s, fm_s, lm_s)
                cur = self.iteration
                old = dict(carries)
                loss, new_state, grads = self._backward(
                    f_s, l_s, fm_s, lm_s, seed=self._train_seed(cur),
                    carries=carries)
                vecs.append(self._update_pass(loss, grads, new_state, cur,
                                              (old, carries)))
                self._cast_params = None
                self.iteration += 1
                losses.append(loss)
            self._tbptt_guard = self._combine_guards(vecs)
            return torch.stack(losses)

        return run

    def _fit_tbptt(self, features, labels, fmask, lmask) -> torch.Tensor:
        """Truncated BPTT on one prepared batch (:meth:`tbptt_batch_arrays`):
        one update per segment; the batch's score is the mean of the
        segment losses, and the listeners see one call, at the last
        segment's iteration."""
        seg = int(self.conf.tbptt_fwd_length)
        back = min(int(self.conf.tbptt_back_length or seg), seg)
        losses = self.tbptt_scan_fn(seg, back)(features, labels, fmask,
                                               lmask)
        self.last_segment_losses = losses
        self.last_batch_size = int(features.shape[0])
        loss = losses.mean()
        self._score = loss
        self._health_epilogue(self.iteration - 1, loss, self._tbptt_guard,
                              (features, labels))
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration - 1, self.epoch, loss)
        return loss

    # --- stateful RNN inference (reference rnnTimeStep) ---------------------
    def rnn_time_step(self, x, fmask=None) -> np.ndarray:
        """Streaming inference (reference ``#rnnTimeStep``): feed a chunk
        ``[batch, t, size]`` (or one step ``[batch, size]``), get the
        outputs ``[batch, t, nOut]`` as a host array, the recurrent layers'
        state carried across calls."""
        if self.params is None:
            self.init()
        for i, layer in enumerate(self.conf.layers):
            nn_io.check_streaming_safe(layer, f"layer {i}")
        t = self._prepare(x)
        if t.ndim == 2:  # one step [batch, size]
            t = t[:, None, :]
        if self._rnn_carries is None:
            cdt = self._cdtype or self._dtype
            self._rnn_carries = {
                str(i): layer.zero_carry(t.shape[0], cdt, self.device)
                for i, layer in enumerate(self.conf.layers)
                if getattr(layer, "has_carry", False)}
        with torch.no_grad():
            y, _ = self._run(self._fwd_params(), self.state, t,
                             fmask=self._on_device(fmask),
                             carries=self._rnn_carries)
        return self._to_host(y)

    def rnn_clear_previous_state(self) -> None:
        """Reference ``#rnnClearPreviousState``."""
        self._rnn_carries = None

    def rnn_get_previous_state(self, layer_idx: int) -> Optional[dict]:
        """Reference ``#rnnGetPreviousState(layer)``: the layer's carry
        (``{"h": ..., "c": ...}`` tensors) in the storage dtype, or None."""
        if self._rnn_carries is None:
            return None
        c = self._rnn_carries.get(str(layer_idx))
        if c is None:
            return None
        return {k: v.to(self._dtype) for k, v in c.items()}

    def rnn_set_previous_state(self, layer_idx: int, state: dict) -> None:
        """Reference ``#rnnSetPreviousState(layer, state)``: the layer's
        carry from ``{name: array}``, held in the compute dtype."""
        if self._rnn_carries is None:
            self._rnn_carries = {}
        cdt = self._cdtype or self._dtype
        self._rnn_carries[str(layer_idx)] = {
            k: torch.as_tensor(v).to(device=self.device, dtype=cdt)
            for k, v in state.items()}

    def score(self, ds: Optional[DataSet] = None) -> float:
        """The eval-mode loss of ``ds``, regularization included (reference
        ``#score(DataSet)``); with no argument, the last training step's
        loss."""
        if ds is None:
            return float("nan") if self._score is None else float(self._score)
        if self.params is None:
            self.init()
        features, labels, fmask, lmask = self._batch_arrays(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, features, labels, fmask, lmask,
                                 train=False)
        return float(loss)

    def evaluate(self, iterator, evaluation: Optional[Evaluation] = None):
        """Reference ``#evaluate(DataSetIterator)`` -> Evaluation."""
        ev = evaluation if evaluation is not None else Evaluation()
        iterator = _as_iterator(iterator)
        for ds in iterator:
            out = self.output(ds.features, fmask=ds.features_mask)
            ev.eval(host_array(ds.labels), out,
                    mask=host_array(ds.labels_mask))
        iterator.reset()
        return ev

    # --- params vector -----------------------------------------------------
    def params_flat(self) -> np.ndarray:
        """The one contiguous params vector (reference ``#params()``), in
        the JAX package's order and layouts."""
        if self.params is None:
            self.init()
        return params_util.flatten_params(self.conf, self.params)

    def set_params_flat(self, flat) -> "MultiLayerNetwork":
        """Copy ``flat`` (``params_flat``'s layout) into the params in
        place; the updater state stays."""
        params_util.unflatten_params(self.conf, flat, self.params)
        self._cast_params = None
        return self

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return int(sum(v.numel() for vp in self.params.values()
                       for v in vp.values()))

    def clone(self) -> "MultiLayerNetwork":
        """A new network on the same conf and device with copied params,
        state and updater state."""
        other = MultiLayerNetwork(self.conf, self.device)
        if self.params is not None:
            other.set_params(self.params, self.state, self.opt_state)
        return other

    def summary(self) -> str:
        """Layer table (reference ``#summary``)."""
        lines = ["=" * 70,
                 f"{'idx':<4} {'layer':<30} {'output':<20} {'params':>10}",
                 "-" * 70]
        total = 0
        for i, (layer, itype) in enumerate(zip(self.conf.layers,
                                               self.conf.input_types())):
            n = 0
            if self.params and str(i) in self.params:
                n = sum(v.numel() for v in self.params[str(i)].values())
            total += n
            lines.append(f"{i:<4} {type(layer).__name__:<30} "
                         f"{_fmt_type(layer.output_type(itype)):<20} "
                         f"{n:>10,}")
        lines += ["-" * 70, f"Total params: {total:,}", "=" * 70]
        return "\n".join(lines)


def _fmt_type(t) -> str:
    if isinstance(t, it.Convolutional):
        return f"[{t.height},{t.width},{t.channels}]"
    if isinstance(t, it.Recurrent):
        return f"[t={t.timesteps},{t.size}]"
    if isinstance(t, it.FeedForward):
        return f"[{t.size}]"
    return str(t)
