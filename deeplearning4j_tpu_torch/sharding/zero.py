"""ZeRO-style optimizer-state sharding: the flatten / pad / scatter layout.

Counterpart of the JAX package's ``sharding/zero.py``. The ZeRO-1 exchange
(``ParallelWrapper(zero_optimizer=True)``) partitions every gradient,
param and moment tensor FLAT across the ranks: leaf ``i`` (``s_i``
elements) is padded to ``n * m_i`` (``m_i = ceil(s_i / n)``) and rank
``k`` owns elements ``[k*m_i, (k+1)*m_i)``. Updaters and regularization
are elementwise, so applying them to the local slice of the
reduce-scattered gradient with the local slice of params and moments
gives the all-reduce path's update bit for bit on each element; only the
optimizer state (and the update's work) divides by ``n``.

:class:`ZeroSpec` is the static layout of one tree (leaves in the JAX
package's flatten order), with the helpers the wrapper's ZeRO step
composes with ``compression.bucketed_psum_scatter`` /
``bucketed_all_gather``. :class:`ZeroExchange` runs the training step's
two exchanges on the same buckets with one block of memory a bucket.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.comms.scheduler import (
    _itemsize,
    bucket_partition,
    tree_flatten,
    tree_unflatten,
)


class ZeroSpec:
    """Flatten / pad / scatter layout for one tree over ``n`` ranks."""

    def __init__(self, tree, n: int):
        leaves, self.treedef = tree_flatten(tree)
        self.n = int(n)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.itemsizes = [_itemsize(l) for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.slice_sizes = [-(-s // self.n) for s in self.sizes]   # m_i
        self.padded_sizes = [m * self.n for m in self.slice_sizes]

    # --- layout -------------------------------------------------------------
    def flat_padded(self, tree):
        """Full-shape tree -> tree of flat ``[n*m_i]`` vectors (reshape +
        zero-pad; the ``bucketed_psum_scatter`` input contract)."""
        leaves = tree_flatten(tree)[0]
        out = []
        for leaf, size, padded in zip(leaves, self.sizes,
                                      self.padded_sizes):
            flat = leaf.reshape(-1)
            if padded != size:
                flat = torch.cat([flat, flat.new_zeros((padded - size,))])
            out.append(flat)
        return tree_unflatten(self.treedef, out)

    def local_slices(self, tree, index: int):
        """Full-shape tree -> tree of rank ``index``'s flat ``[m_i]``
        slices (copies)."""
        flat = tree_flatten(self.flat_padded(tree))[0]
        out = [f[index * m:(index + 1) * m].clone()
               for f, m in zip(flat, self.slice_sizes)]
        return tree_unflatten(self.treedef, out)

    def unflatten_full(self, full_flat):
        """Tree of gathered ``[n*m_i]`` vectors -> full-shape tree."""
        leaves = tree_flatten(full_flat)[0]
        out = [f[:size].reshape(shape)
               for f, size, shape in zip(leaves, self.sizes, self.shapes)]
        return tree_unflatten(self.treedef, out)

    def assemble(self, slices, group=None, bucket_bytes=None):
        """Per-rank slice tree -> full-shape tree on every rank (the ZeRO
        all-gather, on this layout's bucket sizes)."""
        from deeplearning4j_tpu_torch.parallel.compression import (
            bucketed_all_gather,
        )

        return self.unflatten_full(bucketed_all_gather(
            slices, self.padded_sizes, group, bucket_bytes))

    # --- sizes ----------------------------------------------------------------
    def bytes_per_device(self) -> int:
        """Bytes of the scattered tree each rank holds (one ``m_i`` slice a
        leaf)."""
        return sum(m * it for m, it in zip(self.slice_sizes,
                                           self.itemsizes))

    def total_bytes(self) -> int:
        return sum(s * it for s, it in zip(self.sizes, self.itemsizes))

    def layout_bytes(self, bucket_bytes=None) -> List[int]:
        """Per-bucket payload bytes of one scatter / gather schedule over
        this layout (the scheduler's ``bucket_partition``)."""
        sizes = [p * it for p, it in zip(self.padded_sizes,
                                         self.itemsizes)]
        if not sizes:
            return []
        if bucket_bytes is None or len(sizes) <= 1:
            return [sum(sizes)]
        return [sum(sizes[i] for i in bucket)
                for bucket in bucket_partition(sizes, int(bucket_bytes))]


def _put(dst: torch.Tensor, flat: torch.Tensor) -> None:
    """Write ``flat`` into the leading elements of ``dst`` (an ``[n, m]``
    view, read row by row); the rest of ``dst`` is left as it is."""
    m = dst.shape[1]
    q, r = divmod(flat.numel(), m)
    if q:
        dst[:q].copy_(flat[:q * m].view(q, m))
    if r:
        dst[q, :r].copy_(flat[q * m:])


class ZeroExchange:
    """The ZeRO step's gradient reduce-scatter and param all-gather over
    one params tree, on the scheduler's plans for :class:`ZeroSpec`'s
    flat padded layout (the buckets of ``bucketed_psum_scatter`` /
    ``bucketed_all_gather``, and their telemetry plans).

    Bucket ``b`` is one ``[n, M_b]`` block, ``M_b`` the sum of its leaves'
    ``m_i``: row ``r`` holds slice ``r`` of every leaf of the bucket side
    by side, so the block reduce-scatters to this rank's row and the row
    all-gathers back to the block with no further copy. This rank's rows
    lie one after another in one flat vector of ``sum m_i`` elements
    (:meth:`slice_of` gives leaf ``i``'s part). A block lives only while
    its bucket is exchanged, and :meth:`scatter` drops each gradient once
    it is packed: besides the gradients, the exchange holds the rank's
    flat vector and one bucket's block."""

    def __init__(self, spec: ZeroSpec, bucket_bytes=None,
                 axis_name: str = scheduler.DATA_AXIS):
        self.spec = spec

        def meta(sizes):
            return tree_unflatten(spec.treedef, [
                torch.empty((n,), dtype=dt, device="meta")
                for n, dt in zip(sizes, spec.dtypes)])

        # the gather's plan partitions the same padded sizes: one layout
        # serves both exchanges
        scheduler.plan_for(meta(spec.slice_sizes), "all_gather", axis_name,
                           bucket_bytes, full_sizes=spec.padded_sizes)
        self.buckets = scheduler.plan_for(
            meta(spec.padded_sizes), "reduce_scatter", axis_name,
            bucket_bytes).buckets
        self.col, self.start, self.width = {}, [], []
        total = 0
        for bucket in self.buckets:
            self.start.append(total)
            c = 0
            for i in bucket:
                self.col[i] = c
                c += spec.slice_sizes[i]
            self.width.append(c)
            total += c
        self.total = total
        self.offset = {i: self.start[b] + self.col[i]
                       for b, bucket in enumerate(self.buckets)
                       for i in bucket}

    def slice_of(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s ``m_i`` elements of a rank's flat vector (a view)."""
        o = self.offset[i]
        return flat[o:o + self.spec.slice_sizes[i]]

    def scatter(self, grads: list, weight: float,
                group=None) -> torch.Tensor:
        """Every rank's ``grads`` (full-shape leaves in flatten order),
        each times ``weight``, summed: this rank's flat vector of slices.
        Each entry of ``grads`` is set to None once packed, so a caller
        that holds no other reference frees it there."""
        spec, n = self.spec, self.spec.n
        out = grads[0].new_empty((self.total,))
        for b, bucket in enumerate(self.buckets):
            block = out.new_zeros((n, self.width[b]))
            for i in bucket:
                g, grads[i] = grads[i], None
                c = self.col[i]
                _put(block[:, c:c + spec.slice_sizes[i]], g.reshape(-1))
                del g
            block.mul_(weight)
            scheduler.reduce_scatter(
                out[self.start[b]:self.start[b] + self.width[b]], block,
                group)
            del block
        return out

    def local_slice(self, leaf: torch.Tensor, i: int,
                    rank: int) -> torch.Tensor:
        """Rank ``rank``'s ``m_i`` elements of a full-shape leaf (a
        zero-padded copy)."""
        m, size = self.spec.slice_sizes[i], self.spec.sizes[i]
        out = leaf.new_zeros((m,))
        lo = min(rank * m, size)
        hi = min(lo + m, size)
        if hi > lo:
            out[:hi - lo].copy_(leaf.reshape(-1)[lo:hi])
        return out

    def gather_into(self, flat: torch.Tensor, leaves: list,
                    group=None) -> None:
        """Every rank's flat vector gathered into the full-shape
        ``leaves`` (written in place), bucket by bucket."""
        spec, n = self.spec, self.spec.n
        for b, bucket in enumerate(self.buckets):
            block = flat.new_empty((n, self.width[b]))
            scheduler.all_gather(
                block, flat[self.start[b]:self.start[b] + self.width[b]],
                group)
            for i in bucket:
                c = self.col[i]
                leaf = leaves[i]
                leaf.copy_(block[:, c:c + spec.slice_sizes[i]].reshape(-1)
                           [:spec.sizes[i]].view(leaf.shape))
            del block
