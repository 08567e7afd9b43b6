"""Inference-graph optimization pass (serving-time, applied once).

Counterpart of the JAX package's ``nn/inference_opt.py``. For a
``ComputationGraph`` that pass is structurally a no-op: it returns a copy
with its own parameters (so a model that keeps training never changes the
serving copy) and, with ``bf16=True``, the bfloat16 compute policy. The
MultiLayerNetwork transforms (BN fold, prune) land with that model type.
"""

from __future__ import annotations

import dataclasses

import torch


def optimize_for_inference(model, bf16: bool = False):
    """Return a serving copy of ``model`` (the original is never mutated):
    ``model.clone()``, serving its forward in bfloat16 when ``bf16``.
    A model without ``clone`` is returned as is."""
    clone = getattr(model, "clone", None)
    if clone is None:
        return model
    out = clone()
    if bf16:
        out.conf = dataclasses.replace(out.conf, compute_dtype="bfloat16")
        out._cdtype = torch.bfloat16
        out._cast_params = None
    return out
