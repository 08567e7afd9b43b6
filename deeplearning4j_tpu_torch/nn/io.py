"""Host <-> device batch placement for the port's networks.

As in the JAX package (``deeplearning4j_tpu/nn/io.py``), uint8 FEATURE
batches keep their dtype across the host -> device copy (4x fewer bytes) and
are dequantized on the device: image-shaped inputs to ``[0, 1]``
(``x * (1/255)``, the ``ImagePreProcessingScaler`` math), other integer
inputs by a plain cast. Token ids (an input consumed by an embedding) cross
as integers and land as ``long``: a float dtype would round them (bfloat16
holds integers exactly only up to 256). Everything else lands in the
network dtype.

``propagate_mask`` threads a ``[batch, time]`` feature mask past one vertex,
as the JAX package's ``nn/io.py::propagate_mask`` does; a recurrent layer
keeps the mask (its output has the input's time axis), ``LastTimeStep``
and pooling over time end it. ``contains_go_backwards`` and
``check_streaming_safe`` are the recurrent guards both networks share
(truncated BPTT's per-segment reset, ``rnn_time_step``'s refusals).
``HealthHooks``
gives both network classes the snapshot and restore hooks of the JAX
package's ``nn/io.py`` that the health layer's rollback calls, and the
health layer's part of their train steps: the update pass (plain, or
guarded under a health mode) and the per-step epilogue.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.multilayer import BackpropType


def image_input(input_type) -> bool:
    """Whether a network InputType is image-shaped (uint8 batches then mean
    pixels, dequantized to [0,1]); non-image uint8 (token ids) only cast."""
    return isinstance(input_type, (it.Convolutional, it.ConvolutionalFlat))


def as_device(a, device, dtype: torch.dtype, compute_dtype: torch.dtype,
              scale: bool, ids: bool = False) -> torch.Tensor:
    """Place one feature array on ``device`` in ``compute_dtype``: floats
    pass through the storage ``dtype`` first, as the JAX package casts
    them; uint8 crosses as uint8 and is dequantized there in the compute
    dtype (``scale``: image input). ``ids``: token ids, placed as ``long``
    (floats truncate, as the JAX package's ``astype(int32)`` does)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    t = t.to(device)
    if ids:
        return t.long()
    if t.dtype == torch.uint8:
        t = t.to(compute_dtype)
        return t * (1.0 / 255.0) if scale else t
    return t.to(dtype).to(compute_dtype)


def to_internal(t: torch.Tensor) -> torch.Tensor:
    """An NHWC image or NDHWC volume as the logical NCHW / NCDHW tensor
    the layers take (channels-last memory: the same bytes, a view); any
    other rank as it is."""
    if t.ndim == 4:
        return t.permute(0, 3, 1, 2)
    if t.ndim == 5:
        return t.permute(0, 4, 1, 2, 3)
    return t


def to_external(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_internal`: an NC(D)HW result in the JAX
    package's NHWC / NDHWC layout."""
    if t.ndim == 4:
        return t.permute(0, 2, 3, 1)
    if t.ndim == 5:
        return t.permute(0, 2, 3, 4, 1)
    return t


def warm_dtype_variants(input_types, base_dtype):
    """The client-visible input-dtype combinations a serving engine warms
    per padding bucket: image-typed inputs arrive as the float base dtype
    or as raw uint8, everything else as the base dtype only. Returns the
    cross-product list of per-input numpy dtype tuples."""
    base = np.dtype(base_dtype)
    per_input = []
    for t in input_types:
        if t is not None and image_input(t):
            per_input.append((base, np.dtype(np.uint8)))
        else:
            per_input.append((base,))
    return list(itertools.product(*per_input))


def propagate_mask(mask, y, layer_or_vertex):
    """Thread a [batch, time] feature mask past one layer/vertex whose
    OUTPUT is ``y`` (reference ``feedForwardMaskArray`` semantics, decided
    from the output's shape): a same-T sequence output keeps the mask; a
    time-resizing layer exposing ``resize_mask`` transforms it; losing the
    sequence shape (pooling over time, flatten) or resizing without a
    resizer ends it."""
    if mask is None or getattr(y, "ndim", 0) != 3:
        return None
    if y.shape[1] == mask.shape[1]:
        return mask
    layer = layer_or_vertex
    while layer is not None:
        rm = getattr(layer, "resize_mask", None)
        if rm is not None:
            resized = rm(mask)
            return resized if resized.shape[1] == y.shape[1] else None
        layer = getattr(layer, "layer", None)
    return None


def contains_go_backwards(layer) -> bool:
    """Whether a layer, or a layer it wraps (``.layer`` chains), has the
    Keras ``go_backwards`` flag: such layers get a per-segment reset under
    truncated BPTT and refuse ``rnn_time_step``."""
    while layer is not None:
        if getattr(layer, "go_backwards", False):
            return True
        layer = getattr(layer, "layer", None)
    return False


def check_streaming_safe(layer, label: str) -> None:
    """``rnn_time_step``'s guard: raise for a layer (or vertex) whose
    chunk-by-chunk streaming would diverge from the whole-sequence forward:
    ``Bidirectional`` and ``go_backwards`` layers (they need the whole
    sequence), and carry-less layers that mix the time axis
    (``streaming_safe() is False``: attention over the whole sequence).
    Walks wrapper ``.layer`` chains."""
    inner = layer
    while inner is not None:
        if type(inner).__name__ in ("Bidirectional",
                                    "GravesBidirectionalLSTM"):
            raise RuntimeError(
                f"rnn_time_step is unsupported for Bidirectional layers "
                f"({label}, including wrapped ones): the backward pass needs "
                "the full sequence (reference throws "
                "UnsupportedOperationException here)")
        inner = getattr(inner, "layer", None)
    inner = layer
    while inner is not None:
        if getattr(inner, "go_backwards", False):
            raise RuntimeError(
                f"rnn_time_step is unsupported for go_backwards RNNs "
                f"({label}): reversed processing needs the full sequence")
        safe = getattr(inner, "streaming_safe", None)
        if safe is not None and not safe():
            raise RuntimeError(
                f"rnn_time_step is unsupported for {label} "
                f"({type(inner).__name__}): it mixes the time axis without "
                "recurrent state, so per-segment streaming would diverge "
                "from the full forward at call boundaries")
        inner = getattr(inner, "layer", None)


def check_fused_steps(fused_steps, conf) -> None:
    """``fit(fused_steps=K)``'s checks, shared by both networks: K >= 1,
    and K > 1 only under standard backprop (a tBPTT batch already trains
    as its chain of segments)."""
    if fused_steps is None:
        return
    if int(fused_steps) < 1:
        raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    if int(fused_steps) > 1 \
            and conf.backprop_type is BackpropType.TRUNCATED_BPTT:
        raise ValueError(
            "fused_steps composes with STANDARD backprop only: a tBPTT "
            "batch already trains as one chain of segments")


def tbptt_segments(arr, seg: int, cut: int) -> List[torch.Tensor]:
    """``[B, T, ...]`` cut into ``ceil(T / seg)`` segments ``[B, seg,
    ...]``: the JAX package's ``_tbptt_prepad`` and in-trace segmentation
    in one. The tail is zero-padded (masks too, so the padded steps are
    masked); with a no-gradient head (``cut > 0``) the padding goes
    BEFORE the tail's real steps, so they land in the gradient window and
    not in the head (masked steps pass the carries through: the
    reference's shorter tail slice)."""
    t = arr.shape[1]
    pad = -t % seg
    if pad:
        z = arr.new_zeros(arr.shape[:1] + (pad,) + arr.shape[2:])
        split = t - t % seg if cut else t
        arr = torch.cat([arr[:, :split], z, arr[:, split:]], dim=1)
    return list(arr.split(seg, dim=1))


class HealthHooks:
    """The health layer's part of both networks' train steps.

    - ``_health_snapshot`` / ``_health_restore`` (the JAX package's
      rollback hooks): a host snapshot of the training state and its
      restore (``optimize.checkpoint``);
    - ``_update_pass``: one step's update, plain or, under a health mode,
      guarded (``telemetry.health.guarded_update``), returning the guard
      vector;
    - ``_health_epilogue``: after the step's counters moved, the telemetry
      step count and the guard vector to the monitor, or, while a fused
      group is open (``fit(fused_steps=K)`` under a health mode), into the
      group, which reaches the monitor as one ``[K, G]`` stack.

    The network names its path (``_health_path``) and has ``params``,
    ``state``, ``opt_state``, ``conf``, ``iteration``, ``epoch`` and
    ``_apply_updates``."""

    _health_path = "multilayer"
    _fused_group = None  # [(step, loss, vec, batch)] of an open group
    _fused_k = 1

    def _update_pass(self, loss, grads, new_state, cur: int, carries=None):
        from deeplearning4j_tpu_torch.telemetry import health

        mode = health.graph_mode()
        if not mode:
            self._apply_updates(grads, cur)
            self.state.update(new_state)
            return None
        return health.guarded_update(self, loss, grads, new_state, cur,
                                     self.epoch, mode, carries)

    @staticmethod
    def _combine_guards(vecs):
        """A batch's guard from its segments' (None when unguarded)."""
        from deeplearning4j_tpu_torch.telemetry import health

        vecs = [v for v in vecs if v is not None]
        return health.combine(vecs) if vecs else None

    def _health_epilogue(self, cur: int, loss, vec, batch) -> None:
        from deeplearning4j_tpu_torch import telemetry
        from deeplearning4j_tpu_torch.telemetry import health

        features = batch[0][0] if isinstance(batch[0], list) else batch[0]
        telemetry.record_step(self._health_path, int(features.shape[0]))
        if vec is None:
            return
        if self._fused_group is not None:
            self._fused_group.append((cur, loss, vec, batch))
            if len(self._fused_group) >= self._fused_k:
                self._health_flush_fused()
            return
        health.observe_step(self, self._health_path, cur, self.epoch, loss,
                            vec, health.bucket_keys(self.params),
                            batch=batch,
                            rng_seed=int(getattr(self.conf, "seed", 0) or 0))

    @contextlib.contextmanager
    def _health_fused(self, fused_steps):
        """Open fused groups of ``fused_steps`` for the duration of a fit
        (only under a health mode and K > 1)."""
        from deeplearning4j_tpu_torch.telemetry import health

        k = int(fused_steps or 1)
        if k > 1 and health.enabled():
            self._fused_group, self._fused_k = [], k
        try:
            yield
        finally:
            self._fused_group, self._fused_k = None, 1

    def _health_flush_fused(self) -> None:
        """Hand an open group's steps to the monitor (a shorter group at
        an epoch's end)."""
        from deeplearning4j_tpu_torch.telemetry import health

        group = self._fused_group
        if not group:
            return
        self._fused_group = []
        health.observe_fused(
            self, self._health_path, group[0][0], self.epoch,
            torch.stack([g[1] for g in group]),
            torch.stack([g[2] for g in group]),
            health.bucket_keys(self.params), len(group), batch=group[-1][3],
            rng_seed=int(getattr(self.conf, "seed", 0) or 0))

    def _health_snapshot(self):
        from deeplearning4j_tpu_torch.optimize import checkpoint

        return checkpoint.snapshot_training_state(self)

    def _health_restore(self, snap):
        from deeplearning4j_tpu_torch.optimize import checkpoint

        checkpoint.restore_training_state(self, snap)
