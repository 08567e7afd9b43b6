"""Threshold-compressed gradient exchange and the bucketed collectives.

Counterpart of the JAX package's ``parallel/compression.py`` (reference
``EncodedGradientsAccumulator`` + nd4j ``encodeThreshold`` /
``decodeThreshold`` + ``ThresholdAlgorithm``). A worker sends only entries
with |g| > tau, as ±tau flips; the unsent remainder (residual) stays in a
local buffer and is added to the next step's gradient, so the scheme
corrects itself. ``AdaptiveThresholdAlgorithm`` retunes tau toward a
target sparsity.

As in the JAX package the encoded tensors are dense ±tau / 0 tensors
summed by an all-reduce: sparsity is what information crosses ranks, not
a wire format. The encode is elementwise torch (the JAX package's is
jnp, not a Pallas kernel), and gives the JAX package's bits.

``bucketed_psum`` / ``bucketed_psum_scatter`` / ``bucketed_all_gather``
are one ``comms.scheduler.exchange`` call each over a process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.comms.scheduler import (  # noqa: F401
    bucket_layout,
    bucket_partition,
    exchange,
    tree_flatten,
    tree_unflatten,
)


def threshold_encode(g, tau):
    """Split ``g`` into (encoded, residual): encoded = ±tau where |g|>tau
    else 0; residual = g - encoded (kept locally)."""
    tau = torch.as_tensor(tau, dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    enc = torch.where(g > tau, tau, torch.where(g < -tau, -tau, zero))
    return enc, g - enc


def threshold_decode(enc):
    """Identity: the encoded tensor already holds ±tau values."""
    return enc


def bitmap_encode(g, tau):
    """Reference ``encodeBitmap``: the same ±tau / 0 quantization (a
    denser wire encoding in the reference)."""
    return threshold_encode(g, tau)


@dataclasses.dataclass
class ThresholdAlgorithm:
    """Fixed threshold (reference ``FixedThresholdAlgorithm``)."""

    threshold: float = 1e-3

    def initial(self) -> float:
        return self.threshold

    def update(self, tau, sparsity):
        return tau


@dataclasses.dataclass
class AdaptiveThresholdAlgorithm(ThresholdAlgorithm):
    """Reference ``AdaptiveThresholdAlgorithm``: drift tau toward a target
    update sparsity (fraction of entries sent). Computed in float32, as
    the JAX package's jnp update is."""

    threshold: float = 1e-3
    min_target_sparsity: float = 1e-4
    max_target_sparsity: float = 1e-2
    decay: float = 0.95

    def update(self, tau, sparsity):
        # the wrapper hands the JAX package's update a host float: the
        # band is compared in float64, tau moves in float32
        tau = np.float32(tau)
        if float(sparsity) > self.max_target_sparsity:
            return np.float32(tau / np.float32(self.decay))
        if float(sparsity) < self.min_target_sparsity:
            return np.float32(tau * np.float32(self.decay))
        return tau


def encode_tree(grads, residuals, tau):
    """Threshold encoding leaf-wise over a gradient tree. Returns
    (encoded_tree, new_residual_tree, sparsity) with sparsity a float32
    tensor, counted as the JAX package counts it (a float32 running sum
    of each leaf's sent entries over the number of entries)."""
    leaves, spec = tree_flatten(grads)
    res_leaves = tree_flatten(residuals)[0]
    enc_leaves, new_res, total = [], [], 0
    sent = None
    for g, r in zip(leaves, res_leaves):
        e, nr = threshold_encode(g + r, tau)
        enc_leaves.append(e)
        new_res.append(nr)
        n = torch.count_nonzero(e).to(torch.float32)
        sent = n if sent is None else sent + n
        total += e.numel()
    sparsity = sent / torch.tensor(float(total), dtype=torch.float32,
                                   device=sent.device)
    return (tree_unflatten(spec, enc_leaves),
            tree_unflatten(spec, new_res), sparsity)


def bucketed_psum(tree, group=None, bucket_bytes=None):
    """Sum a tree over the process group on the scheduler's
    ``all_reduce`` plan: one collective a bucket, buckets in plan order
    (``bucket_bytes=None``: one bucket). The reduction is elementwise, so
    every bucket size gives the same bits."""
    return exchange(tree, "all_reduce", bucket_bytes=bucket_bytes,
                    group=group)


def bucketed_psum_scatter(tree, group=None, bucket_bytes=None):
    """Reduce-scatter a tree of FLAT, rank-count-padded vectors: every
    rank receives its ``1/n`` slice of each leaf's sum (the ZeRO
    exchange's first half; ``sharding.zero.ZeroSpec`` pads the leaves)."""
    return exchange(tree, "reduce_scatter", bucket_bytes=bucket_bytes,
                    group=group)


def bucketed_all_gather(tree, full_sizes, group=None, bucket_bytes=None):
    """All-gather a tree of per-rank 1-D slices back into full flat
    vectors of ``full_sizes`` (the ZeRO exchange's second half)."""
    return exchange(tree, "all_gather", bucket_bytes=bucket_bytes,
                    group=group, full_sizes=full_sizes)
