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
as the JAX package's ``nn/io.py::propagate_mask`` does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf import inputs as it


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
