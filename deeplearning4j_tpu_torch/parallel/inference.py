"""ParallelInference — batched inference over several devices.

Reference: ``org.deeplearning4j.parallelism.ParallelInference``: caller
threads hand it requests, per-device ``InferenceWorker`` replicas run
batched forwards, results are demuxed. Counterpart of the JAX package's
``parallel/inference.py``, where one program splits a padded batch over
the mesh with the inputs sharded on the data axis; here each device holds
a replica of the model (the first one is the model itself, on its own
device, the reference's ``INPLACE`` mode) and a padded batch is cut into
one equal slice per replica. The replicas run one after the other: each
forward returns host arrays.

Padding: rows quantize to the serving ladder (``parallel.batcher.
bucket_rows`` with ``align=workers``), so a sweep of ragged request sizes
touches O(log) envelopes and ``cache_stats()`` (the
``optimize.aot_cache`` counters: a miss is a first forward at a new
envelope) shows hits after the first call a bucket. ``bucketize=False``
pads to the next multiple of the worker count instead. ``batch_limit``
caps the rows of one launch; the tail rides the same ladder.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.parallel.batcher import bucket_rows


def _same_device(a, b) -> bool:
    """``cuda`` and ``cuda:0`` name one card (the current one is 0 here)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class ParallelInference:
    """Batched inference over every CUDA device (or ``devices``).

    Usage::

        pi = ParallelInference(net, batch_limit=256)
        y = pi.output(x)          # any leading batch size, ragged included

    ``model``: a ``MultiLayerNetwork`` or ``ComputationGraph``. ``devices``
    defaults to one replica on each CUDA device; ``workers`` keeps the
    first that many.
    """

    def __init__(self, model, workers: Optional[int] = None,
                 batch_limit: int = 0,
                 devices: Optional[Sequence] = None,
                 bucketize: bool = True):
        import torch

        if model.params is None:
            model.init()
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "ParallelInference found no CUDA device; pass "
                    "devices=[...] to run on others")
            devices = [f"cuda:{i}" for i in range(n)]
        devices = [torch.device(d) for d in devices]
        if workers is not None:
            if not 1 <= workers <= len(devices):
                raise ValueError(f"workers={workers} but {len(devices)} "
                                 f"device(s): {devices}")
            devices = devices[:workers]
        self.model = model
        self.devices = devices
        self.workers = len(devices)
        # max examples per launch (reference batchLimit); 0 = whole request
        self.batch_limit = int(batch_limit)
        self.bucketize = bool(bucketize)
        self.replicas = [
            model if i == 0 and _same_device(d, model.device)
            else type(model)(model.conf, d).set_params(model.params,
                                                       model.state)
            for i, d in enumerate(devices)]
        self._signature = aot_cache.graph_signature(model.conf)

    def _run(self, xs):
        """One padded launch: equal slices, one per replica."""
        n = xs[0].shape[0]
        if self.bucketize:
            target = bucket_rows(n, align=self.workers)
        else:
            target = math.ceil(n / self.workers) * self.workers
        if target != n:
            xs = [np.concatenate(
                [a, np.zeros((target - n,) + a.shape[1:], a.dtype)])
                for a in xs]
        per = target // self.workers
        outs = []
        for i, (net, dev) in enumerate(zip(self.replicas, self.devices)):
            part = [a[i * per:(i + 1) * per] for a in xs]
            outs.append(aot_cache.run_envelope(
                aot_cache.envelope_key(self._signature, part, dev),
                lambda: net.output(*part)))
        if isinstance(outs[0], (list, tuple)):
            return [np.concatenate([o[j] for o in outs])[:n]
                    for j in range(len(outs[0]))]
        return np.concatenate(outs)[:n]

    def output(self, x, *more_inputs):
        """Forward a request batch (reference ``ParallelInference#output``).
        For multi-input ComputationGraphs pass all inputs positionally."""
        xs = tuple(np.asarray(a) for a in (x,) + more_inputs)
        n = xs[0].shape[0]
        if not self.batch_limit or n <= self.batch_limit:
            return self._run(xs)
        # tail chunks ride the same bucket ladder as full chunks, so a
        # batch_limit that sits on a bucket boundary never adds envelopes
        chunks = [self._run(tuple(a[i:i + self.batch_limit] for a in xs))
                  for i in range(0, n, self.batch_limit)]
        if isinstance(chunks[0], list):
            return [np.concatenate([c[j] for c in chunks])
                    for j in range(len(chunks[0]))]
        return np.concatenate(chunks)

    def cache_stats(self) -> dict:
        """The envelope counters (``optimize.aot_cache.stats``): after the
        first call a bucket, ragged request sizes register as hits."""
        return aot_cache.stats()
