"""Async prefetching, K-batch stacking and device-staging iterators.

Copies of the JAX package's ``datasets/prefetch.py`` (reference
``org.nd4j.linalg.dataset.api.iterator.AsyncDataSetIterator``):

- :class:`AsyncDataSetIterator`: a background thread pulls from the
  wrapped iterator into a bounded queue, so ETL overlaps training; with
  ``device_put=True`` the thread also stages each batch on the device;
- :class:`StackBatchIterator`: K uniform batches stacked on the host into
  one ``[K, B, ...]`` super-batch tagged ``fused_stack=K``
  (:func:`stack_batch_group`); ragged tails and non-uniform groups pass
  through as plain batches;
- :class:`DeviceRingIterator`: a ``depth``-deep ring on the consumer
  thread that stages batch N+1 before batch N is handed to the training
  loop, so its host-to-device copy runs under the step.

Torch tensors pass through the stackers (a group of tensors stacks with
``torch.stack``).

Staging on a CUDA device (:class:`_Stager`): each host array is copied
into page-locked memory (a copy from pageable memory would be synchronous
whatever ``non_blocking`` says), then ``copy_(..., non_blocking=True)``
into a device tensor allocated on the device's copy stream (one a device
and process). The page-locked blocks come from PyTorch's caching host
allocator, which reuses a block only once the copy that read it has run
and serves any shape from its size classes, so the staging keeps no
buffers of its own. An event recorded after a batch's copies is what the
consumer's stream waits on when the batch is handed out, and every staged
tensor is ``record_stream``-ed on that consumer stream: the caching
allocator then reuses its block only after the work the consumer queued
on it has run, so dropping the ring's reference (the counterpart of the
JAX ring's ``delete``) never frees memory a kernel still reads. A
K-stacking ring copies each of a group's K host batches straight into its
slice of the device super-batch: the group is never stacked on the host.
On the CPU a staged batch is a copy (``device="cpu"`` is honoured); a CUDA
device never falls back to the host path, and a staging failure that
outlives ``resilience.retry.INGEST_RETRY``'s attempts raises. A batch
enters the ring only whole: a fault mid-copy leaves nothing half-staged in
it.
"""

from __future__ import annotations

import collections
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


def stack_batch_group(group, materialize: bool = True):
    """K uniform batches -> ONE stacked container ([K, B, ...] per array,
    tagged ``fused_stack=K``); None when the group cannot stack (mixed
    types, ragged shapes, mismatched mask presence).

    ``materialize=False`` runs only the uniformity decision and returns a
    placeholder (the first batch's arrays, tagged ``fused_stack=K``): a
    resuming session's fast-forward needs the yield positions, not the
    K-batch copies."""
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
        if materialize:
            out = DataSet(*(_stack_col(c) for c in cols))
        else:
            out = DataSet(first.features, first.labels,
                          first.features_mask, first.labels_mask)
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
        if materialize:
            fms = [_stack_col(c) for c in fmcols]
            lms = [_stack_col(c) for c in lmcols]
            out = MultiDataSet(
                features=[_stack_col(c) for c in fcols],
                labels=[_stack_col(c) for c in lcols],
                features_masks=(fms if any(m is not None for m in fms)
                                else None),
                labels_masks=(lms if any(m is not None for m in lms)
                              else None))
        else:
            out = MultiDataSet(features=list(first.features),
                               labels=list(first.labels),
                               features_masks=first.features_masks,
                               labels_masks=first.labels_masks)
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
    default queue size 8). ``device_put=True`` stages each batch on
    ``device`` (None: the card) in the worker thread, off the training
    thread: the worker waits for its copies before it queues the batch,
    and the staged tensors are tied to the consumer's stream."""

    def __init__(self, wrapped: DataSetIterator, queue_size: int = 8,
                 device_put: bool = False, device=None):
        self.wrapped = wrapped
        self.queue_size = max(1, int(queue_size))
        self.device_put = bool(device_put)
        self.device = device
        self._stager = None
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
                if self._stager is not None:
                    ds, owned, event = self._stager.stage(ds)
                    self._stager.handout(owned, event,
                                         self._stager.consumer)
                    self._stager.wait()
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
        if self.device_put:
            # built on the consumer's thread: its current stream is the one
            # the staged tensors are tied to
            self._stager = _Stager(self.device, retry=None)
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
    batches. ``materialize=False`` yields a uniform group as the list of
    its K batches instead, unstacked (the device ring copies each into
    its slice of the device super-batch)."""

    def __init__(self, wrapped: DataSetIterator, stack_batches: int,
                 materialize: bool = True):
        self.wrapped = wrapped
        self.stack_batches = int(stack_batches)
        self.materialize = bool(materialize)
        self._skip_next = 0

    def batch_size(self):
        return self.wrapped.batch_size()

    def total_examples(self):
        return self.wrapped.total_examples()

    def skip_stacking(self, n: int) -> None:
        """One-shot: the next iteration's first ``n`` yields keep their
        positions (the uniformity decision still runs) but skip the
        K-batch copies: placeholders a fast-forwarding consumer
        discards."""
        self._skip_next = max(0, int(n))

    def __iter__(self):
        from deeplearning4j_tpu_torch import telemetry

        skip = self._skip_next
        self._skip_next = 0
        group = []
        for ds in self.wrapped:
            group.append(ds)
            if len(group) < self.stack_batches:
                continue
            skipped = skip > 0
            with telemetry.span(telemetry.PHASE_INGEST):
                stacked = stack_batch_group(
                    group, materialize=self.materialize and not skipped)
            if stacked is not None:
                skip -= 1
                yield (stacked if self.materialize or skipped
                       else list(group))
            else:
                for g in group:
                    skip -= 1
                    yield g
            group = []
        yield from group

    def reset(self):
        self.wrapped.reset()


# one copy stream a CUDA device, shared by every stager of the process
_COPY_STREAMS: dict = {}


def _copy_stream(dev: torch.device):
    if dev not in _COPY_STREAMS:
        _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
    return _COPY_STREAMS[dev]


class _Stager:
    """Copies batches' host arrays onto one device (see the module
    docstring): ``stage`` issues the copies and returns the staged batch,
    the tensors it owns and the event its copies end with; ``handout``
    makes the consumer's stream wait on that event and ties the owned
    tensors to it. A single batch's arrays already on the device pass
    through unowned; a K-batch group (a list of uniform batches) is staged
    as one ``[K, B, ...]`` super-batch tagged ``fused_stack=K``."""

    def __init__(self, device=None, retry=...):
        from deeplearning4j_tpu_torch.resilience import retry as _retry

        dev = torch.device("cuda" if device is None else device)
        self.cuda = dev.type == "cuda"
        self.consumer = None
        if self.cuda:
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            # raises where there is no card: a CUDA ring never stages on
            # the host instead
            self.stream = _copy_stream(dev)
            self.consumer = torch.cuda.current_stream(dev)
        self.device = dev
        self.retry = _retry.INGEST_RETRY if retry is ... else retry

    def _resident(self, a) -> bool:
        return isinstance(a, torch.Tensor) and a.device == self.device

    def _put_once(self, parts, stacked: bool) -> torch.Tensor:
        """One array (``parts == [a]``) or one column of a K-batch group
        (``stacked``: ``[K, ...]``, part ``j`` copied into slice ``j``)
        on the device."""
        from deeplearning4j_tpu_torch.resilience import faults

        faults.fault_point("ingest.device_put")
        hosts = [a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a))
                 for a in parts]
        if not self.cuda:
            if stacked:
                return torch.stack(hosts).to(self.device)
            return hosts[0].to(self.device, copy=True)
        if any(h.is_cuda for h in hosts):
            # a part made on the consumer's stream: copy it after that work
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        first = hosts[0]
        shape = ((len(hosts),) if stacked else ()) + tuple(first.shape)
        with torch.cuda.stream(self.stream):
            out = torch.empty(shape, dtype=first.dtype, device=self.device)
            for j, h in enumerate(hosts):
                if h.device.type == "cpu" and not h.is_pinned():
                    # a copy from pageable memory would not be
                    # asynchronous; the caching host allocator hands this
                    # block out again only once the copy below has run
                    h = torch.empty(h.shape, dtype=h.dtype,
                                    pin_memory=True).copy_(h)
                (out[j] if stacked else out).copy_(h, non_blocking=True)
        return out

    def stage(self, ds):
        """-> ``(staged batch, owned tensors, ready event or None)``; a
        stacked super-batch keeps its ``fused_stack`` tag, a K-batch group
        gets one."""
        from deeplearning4j_tpu_torch import telemetry

        group = ds if isinstance(ds, list) else [ds]
        first = group[0]
        if not isinstance(first, (DataSet, MultiDataSet)):
            return ds, [], None
        stacked = isinstance(ds, list)
        owned = []

        def put(col):
            if col[0] is None:
                return None
            if not stacked and self._resident(col[0]):
                return col[0]
            d = (self.retry.call(self._put_once, col, stacked,
                                 op="ingest.device_put")
                 if self.retry is not None
                 else self._put_once(col, stacked))
            owned.append(d)
            return d

        def put_list(attr):
            if getattr(first, attr) is None:
                return None
            out = [put([None if getattr(g, attr) is None
                        else getattr(g, attr)[i] for g in group])
                   for i in range(len(getattr(first, attr)))]
            # a stacked group's all-None masks: None, as stack_batch_group
            return (None if stacked and all(a is None for a in out)
                    else out)

        with telemetry.span(telemetry.PHASE_INGEST):
            if isinstance(first, DataSet):
                staged = DataSet(*(put([getattr(g, f) for g in group])
                                   for f in ("features", "labels",
                                             "features_mask",
                                             "labels_mask")))
            else:
                staged = MultiDataSet(
                    features=put_list("features"),
                    labels=put_list("labels"),
                    features_masks=put_list("features_masks"),
                    labels_masks=put_list("labels_masks"))
        k = len(group) if stacked else getattr(ds, "fused_stack", 0)
        if k:
            staged.fused_stack = k
        event = None
        if self.cuda and owned:
            event = torch.cuda.Event()
            event.record(self.stream)
        if owned and telemetry.enabled():
            telemetry.record_ingest(sum(t.numel() * t.element_size()
                                        for t in owned))
        return staged, owned, event

    def handout(self, owned, event, stream=None) -> None:
        """Before the consumer reads a staged batch: its ``stream`` (the
        current one by default) waits for the copies, and the allocator
        may reuse the owned blocks only after that stream's work on them."""
        if event is None:
            return
        stream = stream or torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in owned:
            t.record_stream(stream)

    def wait(self) -> None:
        """Block the calling thread until every copy issued has landed."""
        if self.cuda:
            self.stream.synchronize()


class DeviceRingIterator(DataSetIterator):
    """Double-buffered device ingest (default ``depth=2``), the JAX
    package's ring.

    The copies are asynchronous: staging batch N+1 BEFORE batch N is
    handed to the training loop lets its copy run under the step. The
    ring keeps ``depth`` staged batches in flight; when the consumer comes
    back for the next batch it has launched its step on the previous one,
    so the batch before that is consumed and the ring lets go of its
    tensors (each is tied to the consumer's stream, so its memory
    returns to the allocator once that step has run). Only tensors
    the ring staged itself are released: batches already on the device
    pass through untouched.

    ``stack_batches=K``: K batches at a time are staged as one ``[K, B,
    ...]`` super-batch (tagged ``fused_stack=K``, the arrays
    ``stack_batch_group`` would give), each batch copied into its slice on
    the device; ragged tails and non-uniform groups pass as plain
    batches. ``device`` None is the card. Transient staging failures are
    retried by ``retry`` (``INGEST_RETRY``; None stages without one).
    ``donate`` keeps the JAX signature: it decides only whether
    ``retired_count`` counts the released batches."""

    def __init__(self, wrapped: DataSetIterator, depth: int = 2,
                 donate: bool = True, device=None, retry=...,
                 stack_batches: int = 0):
        from deeplearning4j_tpu_torch.resilience import retry as _retry

        self.wrapped = wrapped
        self.depth = max(1, int(depth))
        self.donate = bool(donate)
        self.device = device
        self.stack_batches = int(stack_batches or 0)
        self.retry = _retry.INGEST_RETRY if retry is ... else retry
        self._skip_next = 0
        self._stager = None  # built at the first epoch, kept for the next
        self.staged_count = 0
        self.retired_count = 0

    def batch_size(self):
        return self.wrapped.batch_size()

    def total_examples(self):
        return self.wrapped.total_examples()

    def skip_staging(self, n: int) -> None:
        """The next iteration's first ``n`` items bypass staging (yielded
        as they are, on the host): a resuming ``TrainingSession``
        fast-forwards past trained (super-)steps and must not pay their
        copies. It discards the same yielded items either way, so the
        positions stay aligned."""
        self._skip_next = max(0, int(n))

    def _retire(self, owned) -> None:
        # the ring lets go of a consumed batch either way (its tensors are
        # tied to the consumer's stream); ``donate`` only says whether
        # ``retired_count`` counts it, as the JAX ring counts its deletes
        if self.donate and owned:
            self.retired_count += 1
        owned.clear()

    def __iter__(self):
        if self._stager is None:
            self._stager = _Stager(self.device, self.retry)
        stager = self._stager
        ring = collections.deque()
        last_owned = None
        skip = self._skip_next
        self._skip_next = 0
        source = (StackBatchIterator(self.wrapped, self.stack_batches,
                                     materialize=False)
                  if self.stack_batches > 1 else self.wrapped)
        if skip and isinstance(source, StackBatchIterator):
            source.skip_stacking(skip)  # skip the host copies too

        def pop():
            out, owned, event = ring.popleft()
            stager.handout(owned, event)
            return out, owned

        for ds in source:
            if skip > 0:
                skip -= 1
                yield ds  # fast-forward: unstaged, the consumer discards
                continue
            entry = stager.stage(ds)  # whole, or raises with nothing kept
            self.staged_count += 1
            ring.append(entry)
            if len(ring) < self.depth:
                continue
            out, owned = pop()
            yield out
            # the consumer is back: it launched its step on ``out``, so
            # the batch it held before is consumed
            if last_owned is not None:
                self._retire(last_owned)
            last_owned = owned
        while ring:
            out, owned = pop()
            yield out
            if last_owned is not None:
                self._retire(last_owned)
            last_owned = owned
        # the last batch stays referenced until the generator is collected

    def reset(self):
        self.wrapped.reset()
