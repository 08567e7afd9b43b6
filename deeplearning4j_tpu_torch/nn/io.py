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
package's ``nn/io.py`` that the health layer's rollback calls.
"""

from __future__ import annotations

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
    """The health layer's rollback hooks (the JAX package's
    ``_health_snapshot`` / ``_health_restore``): a host snapshot of the
    training state, and its restore (``optimize.checkpoint``)."""

    def _health_snapshot(self):
        from deeplearning4j_tpu_torch.optimize import checkpoint

        return checkpoint.snapshot_training_state(self)

    def _health_restore(self, snap):
        from deeplearning4j_tpu_torch.optimize import checkpoint

        checkpoint.restore_training_state(self, snap)
