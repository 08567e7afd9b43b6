"""Async prefetching and K-batch stacking iterators.

Copies of the two iterators of the JAX package's ``datasets/prefetch.py``
that ``ParallelWrapper`` uses (reference
``org.nd4j.linalg.dataset.api.iterator.AsyncDataSetIterator``):

- :class:`AsyncDataSetIterator`: a background thread pulls from the
  wrapped iterator into a bounded queue, so ETL overlaps training;
- :class:`StackBatchIterator`: K uniform batches stacked on the host into
  one ``[K, B, ...]`` super-batch tagged ``fused_stack=K``
  (:func:`stack_batch_group`); ragged tails and non-uniform groups pass
  through as plain batches.

Torch tensors pass through both (a group of tensors stacks with
``torch.stack``). The JAX package's ``DeviceRingIterator`` (device
staging ahead of the step) is not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

_SENTINEL = object()


def _uniform(arrs) -> bool:
    """True when every column entry shares shape and dtype (or all are
    None)."""
    first = arrs[0]
    if first is None:
        return all(a is None for a in arrs)
    if any(a is None for a in arrs[1:]):
        return False
    shape = tuple(first.shape)
    dtype = first.dtype
    return all(tuple(a.shape) == shape and a.dtype == dtype
               for a in arrs[1:])


def _stack_col(arrs):
    """Stack one column to [K, ...] (tensors with ``torch.stack``)."""
    if arrs[0] is None:
        return None
    if any(isinstance(a, torch.Tensor) for a in arrs):
        return torch.stack([torch.as_tensor(a) for a in arrs])
    return np.stack([np.asarray(a) for a in arrs])


def stack_batch_group(group):
    """K uniform batches -> ONE stacked container ([K, B, ...] per array,
    tagged ``fused_stack=K``); None when the group cannot stack (mixed
    types, ragged shapes, mismatched mask presence)."""
    k = len(group)
    if k < 2:
        return None
    first = group[0]
    if isinstance(first, DataSet) and all(type(g) is DataSet
                                          for g in group):
        cols = [[g.features for g in group], [g.labels for g in group],
                [g.features_mask for g in group],
                [g.labels_mask for g in group]]
        if not all(_uniform(c) for c in cols):
            return None
        out = DataSet(*(_stack_col(c) for c in cols))
        out.fused_stack = k
        return out
    if isinstance(first, MultiDataSet) and all(type(g) is MultiDataSet
                                               for g in group):
        n_f, n_l = len(first.features), len(first.labels)
        if any(len(g.features) != n_f or len(g.labels) != n_l
               for g in group):
            return None

        def col(attr, i):
            out = []
            for g in group:
                m = getattr(g, attr)
                out.append(None if m is None else m[i])
            return out

        fcols = [[g.features[i] for g in group] for i in range(n_f)]
        lcols = [[g.labels[i] for g in group] for i in range(n_l)]
        fmcols = [col("features_masks", i) for i in range(n_f)]
        lmcols = [col("labels_masks", i) for i in range(n_l)]
        if not all(_uniform(c) for c in fcols + lcols + fmcols + lmcols):
            return None
        fms = [_stack_col(c) for c in fmcols]
        lms = [_stack_col(c) for c in lmcols]
        out = MultiDataSet(
            features=[_stack_col(c) for c in fcols],
            labels=[_stack_col(c) for c in lcols],
            features_masks=(fms if any(m is not None for m in fms)
                            else None),
            labels_masks=(lms if any(m is not None for m in lms)
                          else None))
        out.fused_stack = k
        return out
    return None


def unstack(ds, j: int):
    """Step ``j`` of a stacked super-batch, as a plain batch."""
    def pick(a):
        return None if a is None else a[j]

    if isinstance(ds, MultiDataSet):
        return MultiDataSet(
            features=[pick(a) for a in ds.features],
            labels=[pick(a) for a in ds.labels],
            features_masks=(None if ds.features_masks is None
                            else [pick(a) for a in ds.features_masks]),
            labels_masks=(None if ds.labels_masks is None
                          else [pick(a) for a in ds.labels_masks]))
    return DataSet(pick(ds.features), pick(ds.labels),
                   pick(ds.features_mask), pick(ds.labels_mask))


class AsyncDataSetIterator(DataSetIterator):
    """Bounded-queue prefetch wrapper (reference ``AsyncDataSetIterator``,
    default queue size 8)."""

    def __init__(self, wrapped: DataSetIterator, queue_size: int = 8):
        self.wrapped = wrapped
        self.queue_size = max(1, int(queue_size))
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

    def batch_size(self):
        return self.wrapped.batch_size()

    def total_examples(self):
        return self.wrapped.total_examples()

    def _producer(self):
        try:
            for ds in self.wrapped:
                if self._stop.is_set():
                    return
                while not self._stop.is_set():
                    try:
                        self._queue.put(ds, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        self._shutdown()
        self._stop.clear()
        self._error = None
        self._queue = queue.Queue(self.queue_size)
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="AsyncDataSetIterator")
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if item is _SENTINEL:
                    break
                yield item
            self._thread.join(timeout=5)
            if self._error is not None:
                raise self._error
        finally:
            # the consumer may abandon the generator early: stop the
            # producer rather than leak the thread and its batches
            self._shutdown()

    def _shutdown(self):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            self._thread.join(timeout=5)
        self._thread = None

    def reset(self):
        self._shutdown()
        self.wrapped.reset()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


class StackBatchIterator(DataSetIterator):
    """Host-side K-batch stacking: yields :func:`stack_batch_group`
    super-batches; ragged tails and non-uniform groups degrade to plain
    batches."""

    def __init__(self, wrapped: DataSetIterator, stack_batches: int):
        self.wrapped = wrapped
        self.stack_batches = int(stack_batches)

    def batch_size(self):
        return self.wrapped.batch_size()

    def total_examples(self):
        return self.wrapped.total_examples()

    def __iter__(self):
        group = []
        for ds in self.wrapped:
            group.append(ds)
            if len(group) < self.stack_batches:
                continue
            stacked = stack_batch_group(group)
            if stacked is not None:
                yield stacked
            else:
                yield from group
            group = []
        yield from group

    def reset(self):
        self.wrapped.reset()
