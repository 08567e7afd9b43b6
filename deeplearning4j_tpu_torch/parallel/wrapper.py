"""ParallelWrapper — data-parallel training on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/wrapper.py`` (reference
``org.deeplearning4j.parallelism.ParallelWrapper``). The JAX package runs
one program over a mesh of devices; the port runs one process per rank
(``torchrun``, or ``parallel.launch.spawn``), each holding one replica
and feeding ``fit`` ITS OWN partition of every global batch: rank ``r``
of a global batch of ``B`` rows holds rows ``[r*s, (r+1)*s)``,
``s = ceil(B / workers)``; a short partition is zero-padded to the
per-rank size the fit established, with a zero label mask, and a larger
one raises. N ranks fed their partitions compute what the JAX wrapper at
``workers=N`` computes on the global batch.

Modes (the JAX package's semantics):

- **SHARED_GRADIENTS, exact** (the default): ``fit`` on the global padded
  batch. The train-mode forward runs inside ``comms.global_batch``: the
  loss's mean and batch-norm statistics (stock BN, ``FusedConvBN1x1``'s
  stock and ``matmul_stats`` routes) are taken over every rank's rows,
  padding rows included, through all-reduces whose backward all-reduces
  the cotangent; regularization counts once. The gradients are summed by
  one all-reduce, issued from the last gradient hook of the backward.
- **SHARED_GRADIENTS, bucketed** (``gradient_bucket_mb``): per-rank
  forward and backward (per-rank BN statistics, as the JAX package's
  ``shard_map`` step), gradients weighted by ``c / ctot`` (valid rows of
  this rank over all) and summed over the scheduler's buckets, each
  all-reduce issued from the post-accumulate-grad hook that completes its
  bucket (in plan order), so it overlaps the rest of the backward;
  ``gradient_bucket_mb=0`` is one fused collective. The running BN state
  is averaged with weight ``c / ctot``.
- **SHARED_GRADIENTS, threshold** (``threshold_algorithm``): a residual
  per rank, ``encode(grad * w + residual)`` to ±tau, the messages summed,
  the adaptive tau retuned on the host from the step's sparsity.
- **SHARED_GRADIENTS, ZeRO** (``zero_optimizer=True``): the gradients'
  reduce-scatter over the flat padded tree, the updater and
  regularization on this rank's 1/n slice, the params' all-gather; the
  optimizer state stays scattered.
- **SHARED_GRADIENTS, expert-parallel** (``expert_parallel=True``): each
  ``MoELayer``'s experts split over the ranks (``n_experts / world``
  each, experts riding the data axis, GShard's layout) and its tokens
  cross by all-to-all (``parallel.expert``); the JAX package's
  ``shard_map`` step: per-rank forward and backward, the replicated
  leaves' gradients averaged, an expert shard's gradient its own (every
  rank's share arrives through the all-to-all's backward), a penalty on
  the shards counted in full, floating state averaged. The model holds
  every expert again after ``fit`` (and for a save mid-fit).
- **AVERAGING**: independent replicas (an all-padding rank does not
  move); every ``averaging_frequency`` iterations params, state and (with
  ``average_updaters``) updater state are averaged.

Under a health mode (``telemetry.health.configure``) every mode guards
its step as the JAX package's wrapper does: exact, bucketed and ZeRO on
the summed (post-exchange) gradients, identical on every rank (ZeRO from
the reduce-scattered slices' squared sums); threshold on the summed
messages, SKIP_STEP reverting the residual too; averaging on each
replica's own step, the vectors max-combined across the ranks
(``health.combine_across``); expert-parallel on the loss alone. Under
SKIP_STEP the update is selected on the device by the step's flag, on
every rank alike, and nothing reads the flag on the host. The monitor
sees the wrapper as the owner (its ``_health_snapshot`` /
``_health_restore`` serve ROLLBACK).

While ``fit`` runs, the model's ``_live_trainer`` points here, so
``util.serializer.write_model``, ``CheckpointListener`` and the training
snapshots gather the live trees first (ZeRO's scattered updater state,
the averaging replicas' mean). That gather is a collective: every rank
runs the same listeners and calls, as every JAX process does, and a
``CheckpointListener`` writes on rank 0 only.
"""

from __future__ import annotations

import enum
import weakref
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler, telemetry
from deeplearning4j_tpu_torch.comms import global_batch, scheduler
from deeplearning4j_tpu_torch.parallel import expert
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel.compression import (
    ThresholdAlgorithm,
    bucket_layout,
    bucketed_psum,
    encode_tree,
)
from deeplearning4j_tpu_torch.telemetry import health

DATA = mesh_mod.DATA_AXIS


def _shard_axes(layer) -> dict:
    """The leaves a layer shards over the expert axis (``MoELayer``'s
    ``param_shard_axes``), by param key."""
    return getattr(layer, "param_shard_axes", dict)()


class TrainingMode(enum.Enum):
    """Reference ``ParallelWrapper.TrainingMode``."""

    AVERAGING = "averaging"
    SHARED_GRADIENTS = "shared_gradients"


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class _HookedAllReduce:
    """The gradient all-reduce of one step on a plan's buckets. Each
    leaf's post-accumulate-grad hook files its gradient; a bucket whose
    leaves are all in, and whose predecessors in the plan are issued, is
    flattened (weighted), and its all-reduce starts at once, while the
    backward goes on. :meth:`finish` issues what the backward never
    reached (leaves with no gradient count zero), waits in plan order and
    returns the summed gradient tree."""

    def __init__(self, plan, keys, group):
        self.plan, self.keys, self.group = plan, keys, group
        self.owner = {i: b for b, bucket in enumerate(plan.buckets)
                      for i in bucket}

    def arm(self, weight: Optional[float]):
        """The ``on_leaves`` callback of one gradient pass."""
        self.weight = weight
        self.grads = [None] * len(self.keys)
        self.left = [len(b) for b in self.plan.buckets]
        self.next = 0
        self.works = []
        self.handles = []

        def on_leaves(leaves):
            self.leaves = [leaves[k][pk] for k, pk in self.keys]
            for i, leaf in enumerate(self.leaves):
                if leaf.requires_grad:
                    self.handles.append(
                        leaf.register_post_accumulate_grad_hook(
                            lambda t, i=i: self._ready(i, t)))

        return on_leaves

    def _ready(self, i, leaf):
        self.grads[i] = leaf.grad
        self.left[self.owner[i]] -= 1
        while (self.next < len(self.plan.buckets)
               and self.left[self.next] == 0):
            self._launch(self.next)
            self.next += 1

    def _launch(self, b):
        idx = self.plan.buckets[b]
        vals = [self.grads[i] if self.grads[i] is not None
                else torch.zeros_like(self.leaves[i]) for i in idx]
        for dt in dict.fromkeys(v.dtype for v in vals):
            sub = [i for i, v in zip(idx, vals) if v.dtype == dt]
            flat = torch.cat([v.reshape(-1) for v in vals if v.dtype == dt])
            if self.weight is not None:
                flat.mul_(self.weight)
            work = scheduler.all_reduce(flat, self.group, async_op=True)
            self.works.append((sub, flat, work))

    def finish(self):
        while self.next < len(self.plan.buckets):
            self._launch(self.next)
            self.next += 1
        for h in self.handles:
            h.remove()
        out = {}
        for sub, flat, work in self.works:
            if work is not None:
                work.wait()
            shapes = [self.leaves[i].shape for i in sub]
            for i, g in zip(sub, scheduler.split_flat(flat, shapes)):
                k, pk = self.keys[i]
                out.setdefault(k, {})[pk] = g
        self.grads = self.leaves = self.works = None
        return out


class ParallelWrapper:
    """Data-parallel trainer (reference ``ParallelWrapper``)::

        mesh = initialize_distributed()          # one process per rank
        pw = ParallelWrapper(net, training_mode=TrainingMode.SHARED_GRADIENTS)
        pw.fit(iterator_over_this_ranks_partition, epochs=2)

    ``workers`` = the world size (the mesh's data axis); ``mesh`` defaults
    to the whole process group (one rank without one)."""

    def __init__(self, model, workers: Optional[int] = None,
                 training_mode: TrainingMode = TrainingMode.SHARED_GRADIENTS,
                 averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 threshold_algorithm: Optional[ThresholdAlgorithm] = None,
                 prefetch_buffer: int = 2,
                 mesh=None, expert_parallel: bool = False,
                 gradient_bucket_mb: Optional[float] = None,
                 fused_steps: Optional[int] = None,
                 zero_optimizer: bool = False,
                 partition_rules=None):
        from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if model.params is None:
            model.init()
        self.model = model
        self._is_graph = isinstance(model, ComputationGraph)
        if not self._is_graph and not isinstance(model, MultiLayerNetwork):
            raise TypeError(f"unsupported model type {type(model)}")
        self.expert_parallel = bool(expert_parallel)
        if self.expert_parallel and (
                training_mode is not TrainingMode.SHARED_GRADIENTS
                or threshold_algorithm is not None
                or model.conf.backprop_type is BackpropType.TRUNCATED_BPTT):
            raise ValueError(
                "expert_parallel composes with the exact "
                "SHARED_GRADIENTS mode only (no threshold "
                "compression, no tBPTT)")
        if partition_rules is not None:
            raise NotImplementedError(
                "partition_rules is not ported yet: it waits for "
                "sharding/plan.py's ShardingPlan (ROADMAP A: 'The remainder, "
                "in dependency order')")
        if model.conf.backprop_type is BackpropType.TRUNCATED_BPTT:
            raise NotImplementedError(
                "truncated BPTT through ParallelWrapper is not ported yet "
                "(ROADMAP A: 'What PRs 12-15 left of their slices')")
        self.mesh = mesh if mesh is not None else mesh_mod.single_host_mesh(
            n_devices=workers)
        self.workers = self.mesh.world
        if workers is not None and self.workers != workers:
            raise ValueError(
                f"mesh data axis = {self.workers}, workers = {workers}")
        self.rank = self.mesh.rank
        self.group = self.mesh.group
        if self.mesh.backend == "nccl" and model.device.type != "cuda":
            raise ValueError(
                "NCCL moves CUDA tensors only: train a CPU model over gloo")
        sharded = [(name, layer) for name, layer in self._layer_confs()
                   if _shard_axes(layer)]
        if self.expert_parallel:
            for name, layer in sharded:
                if layer.n_experts % self.workers != 0:
                    raise ValueError(
                        f"layer {name}: n_experts={layer.n_experts} must "
                        f"be a multiple of the data-axis size "
                        f"{self.workers}")
        elif sharded and self.workers > 1:
            raise NotImplementedError(
                f"layer {sharded[0][0]}: an MoE layer's capacity is shared "
                "over the global batch, which the per-rank data-parallel "
                "modes do not see; train it with expert_parallel=True")
        self.training_mode = training_mode
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = bool(average_updaters)
        self.threshold_algorithm = threshold_algorithm
        self.prefetch_buffer = int(prefetch_buffer)
        # gradient_bucket_mb: None = the default single-collective paths;
        # a number = explicit buckets of ~that many MB (0: one fused
        # collective) for both SHARED_GRADIENTS variants and AVERAGING's
        # periodic average
        if gradient_bucket_mb is None:
            self.gradient_bucket_bytes = None
            self._explicit_exchange = False
        else:
            mb = float(gradient_bucket_mb)
            if mb < 0:
                raise ValueError(
                    f"gradient_bucket_mb must be >= 0, got {mb}")
            self.gradient_bucket_bytes = (int(mb * 2 ** 20) if mb > 0
                                          else None)
            self._explicit_exchange = True
        if self._explicit_exchange and self.expert_parallel:
            raise ValueError(
                "gradient_bucket_mb composes with the standard "
                "SHARED_GRADIENTS / AVERAGING steps only (no "
                "expert_parallel, no tBPTT yet)")
        self._zero = bool(zero_optimizer)
        if self._zero and (training_mode is not TrainingMode.SHARED_GRADIENTS
                           or threshold_algorithm is not None
                           or self.expert_parallel):
            raise ValueError(
                "zero_optimizer composes with the exact SHARED_GRADIENTS "
                "path only (no threshold compression, no expert_parallel, "
                "no tBPTT, no AVERAGING)")
        self.fused_steps = int(fused_steps or 0)
        if self.fused_steps > 1 and (
                training_mode is not TrainingMode.SHARED_GRADIENTS
                or threshold_algorithm is not None or self.expert_parallel
                or self._explicit_exchange or self._zero):
            raise ValueError(
                "fused_steps composes with the exact SHARED_GRADIENTS "
                "SPMD path only (no threshold compression, no "
                "gradient_bucket_mb, no expert_parallel, no tBPTT, "
                "no AVERAGING, no zero_optimizer/partition_rules)")
        self._score = None
        self._tau = None
        self._residual = None
        self._hooks = None
        self._mp_target = None
        self._health_mode = None  # the guard mode the steps were set up for
        self._fused_group = None  # a fused group's [(step, loss, vec)]
        # True while the model's trees hold the live training state
        # (ZeRO's updater state and the averaging replicas live here)
        self._synced = True
        self._setup_done = False

    # --- model-type adapters -----------------------------------------------
    def _layer_confs(self):
        """-> (params key, conf layer) for every layer / vertex."""
        m = self.model
        if self._is_graph:
            for name, spec in m.conf.vertex_map().items():
                yield name, getattr(spec.vertex, "layer", None) or spec.vertex
        else:
            for i, layer in enumerate(m.conf.layers):
                yield str(i), layer

    def _prep(self, ds):
        """-> (batch arrays as the model's gradient pass takes them, rows):
        graph ``(features, labels, fmasks, lmasks)`` lists, MLN single
        arrays."""
        m = self.model
        if self._is_graph:
            features, labels, fmasks, lmasks = m._prep_batch(ds)
            return (list(features), list(labels), fmasks,
                    list(lmasks)), int(features[0].shape[0])
        features, labels, fmask, lmask = m._batch_arrays(ds)
        return (features, labels, fmask, lmask), int(features.shape[0])

    def _pad(self, batch, rows: int, target: int):
        """Zero-pad the batch to ``target`` rows; padded rows get a zero
        label mask (a missing mask is materialized as ones first)."""
        if rows == target:
            return batch
        m = self.model
        features, labels, fmasks, lmasks = batch

        def ones(lab):
            return torch.ones((lab.shape[0],), dtype=m._dtype,
                              device=lab.device)

        if self._is_graph:
            lmasks = [ones(lab) if lm is None else lm
                      for lm, lab in zip(lmasks, labels)]
        elif lmasks is None:
            lmasks = ones(labels)
        return mesh_mod.pad_leading((features, labels, fmasks, lmasks),
                                    target)

    def _step_seed(self, cur: int) -> int:
        seed = self.model._train_seed(cur)
        return seed if self.rank == 0 else (
            seed + self.rank * 1_000_003) % (2 ** 63)

    def _gradients(self, batch, cur, on_leaves=None):
        m = self.model
        if self._is_graph:
            return m._backward_arrays(*batch, seed=self._step_seed(cur),
                                      on_leaves=on_leaves)
        return m._backward(*batch, seed=self._step_seed(cur),
                           on_leaves=on_leaves)

    def _grad_keys(self):
        """(layer key, param key) of every param leaf, in flatten order."""
        p = self.model.params
        return [(k, pk) for k in sorted(p) for pk in sorted(p[k])]

    # --- set-up -------------------------------------------------------------
    def _setup(self):
        m = self.model
        mode = health.graph_mode()
        if self._health_mode != mode:
            # a guarded and an unguarded step differ: set the step up anew
            # (the JAX package drops its compiled step)
            self._hooks = None
            self._health_mode = mode
        self._synced = True
        if self.training_mode is TrainingMode.AVERAGING:
            # this rank's replica starts from the model's trees; the model
            # gets the replicas' mean back at write-back
            clone = lambda t: scheduler.tree_map(  # noqa: E731
                lambda x: x.detach().clone(), t)
            self._params = {k: clone(v) for k, v in m.params.items()}
            self._state = {k: clone(v) for k, v in m.state.items()}
            self._opt = {k: clone(v) for k, v in m.opt_state.items()}
        elif self.threshold_algorithm is not None:
            self._residual = scheduler.tree_map(torch.zeros_like, m.params)
            if self._tau is None:
                self._tau = np.float32(self.threshold_algorithm.threshold)
        elif self._zero:
            from deeplearning4j_tpu_torch.sharding.zero import (
                ZeroExchange,
                ZeroSpec,
            )

            self._zero_pspec = ZeroSpec(m.params, self.workers)
            self._zero_x = ZeroExchange(self._zero_pspec,
                                        self.gradient_bucket_bytes, DATA)
            self._zero_ospec = ZeroSpec(m.opt_state, self.workers)
            self._opt_slices = self._zero_ospec.local_slices(m.opt_state,
                                                             self.rank)
            # the full updater state leaves the card: each rank holds 1/n
            m.opt_state = {}
            self._synced = False
            telemetry.record_shard_bytes(
                self._zero_pspec.total_bytes(),
                self._zero_ospec.bytes_per_device(), m.device)
        elif self.expert_parallel:
            self._experts = [(k, pk, layer)
                             for k, layer in self._layer_confs()
                             for pk in sorted(_shard_axes(layer))
                             if pk in m.params.get(k, {})]
            self._shard_experts()
        if not (self._zero or self.expert_parallel) and \
                self.training_mode is TrainingMode.SHARED_GRADIENTS and \
                self.threshold_algorithm is None and self._hooks is None:
            plan = scheduler.plan_for(m.params, "all_reduce", DATA,
                                      self.gradient_bucket_bytes)
            self._hooks = _HookedAllReduce(plan, self._grad_keys(),
                                           self.group)
        self._setup_done = True

    # --- training loop ------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1):
        """Train this rank's partition (reference ``ParallelWrapper#fit``):
        a DataSetIterator, a (Multi)DataSet, or (features, labels)
        arrays; under the health mode that is on when it starts."""
        from deeplearning4j_tpu_torch.datasets.iterators import (
            ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.datasets.prefetch import (
            AsyncDataSetIterator,
            StackBatchIterator,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import _as_iterator

        m = self.model
        if self._is_graph:
            if labels is not None:
                from deeplearning4j_tpu_torch.datasets.dataset import DataSet

                data = DataSet(data, labels)
            iterator = (data if hasattr(data, "reset")
                        else ListDataSetIterator([data]))
        else:
            iterator = _as_iterator(data, labels)
        already_async = isinstance(iterator, AsyncDataSetIterator)
        if self.fused_steps > 1 and getattr(
                iterator, "stack_batches", 0) != self.fused_steps:
            iterator = StackBatchIterator(iterator, self.fused_steps)
        if self.prefetch_buffer > 0 and not already_async:
            iterator = AsyncDataSetIterator(iterator,
                                            queue_size=self.prefetch_buffer)
        self._setup()
        # gather-on-save: while this wrapper owns the live trees, a
        # write_model of the model gathers them first
        m._live_trainer = weakref.ref(self)
        self._mp_target = None  # the per-rank batch size of this fit
        telemetry.host_gap_reset()
        try:
            for _ in range(epochs):
                for lst in m.listeners:
                    lst.on_epoch_start(m, m.epoch)
                for ds in iterator:
                    self._fit_batch(ds)
                iterator.reset()
                for lst in m.listeners:
                    lst.on_epoch_end(m, m.epoch)
                m.epoch += 1
        finally:
            telemetry.host_gap_stop()
            self._write_back()
            m._live_trainer = None
        return m

    def _counts(self, rows: int):
        """(this rank's valid rows, all ranks' valid rows) as float32."""
        t = torch.tensor([float(rows)], dtype=torch.float32,
                         device=self.model.device)
        scheduler.all_reduce(t, self.group)
        return np.float32(rows), np.float32(max(float(t), 1.0))

    def _sum_scalar(self, x: torch.Tensor) -> torch.Tensor:
        t = x.detach().reshape(1).to(torch.float32).clone()
        scheduler.all_reduce(t, self.group)
        return t[0]

    def _weighted_state(self, new_state, w: float):
        """psum(s * w) of every floating state leaf."""
        if not new_state:
            return new_state
        scaled = scheduler.tree_map(
            lambda s: s * w if _is_float(s) else s, new_state)
        floats = {k: {n: v for n, v in d.items() if _is_float(v)}
                  for k, d in scaled.items()}
        summed = bucketed_psum(floats, self.group, self.gradient_bucket_bytes)
        return {k: {n: summed[k].get(n, v) for n, v in d.items()}
                for k, d in scaled.items()}

    def _fit_batch(self, ds):
        from deeplearning4j_tpu_torch.resilience import faults

        faults.fault_point("train.step")
        k = int(getattr(ds, "fused_stack", 0) or 0)
        if k > 1:
            return self._fit_batch_fused(ds, k)
        m = self.model
        with telemetry.span(telemetry.PHASE_INGEST):
            batch, rows = self._prep(ds)
            target = rows
            if self.workers > 1:
                # every rank presents the same per-rank size: lock it to
                # the largest partition of the fit's first global batch
                # and pad tails up to it
                if self._mp_target is None:
                    t = torch.tensor([float(rows)], device=m.device)
                    scheduler.all_reduce(t, self.group, op="max")
                    self._mp_target = int(t)
                if target > self._mp_target:
                    raise ValueError(
                        f"multi-host batch of {rows} rows exceeds the "
                        f"established per-host batch of {self._mp_target}; "
                        f"all hosts must feed equal-size batches "
                        f"(repartition your data as Spark does in the "
                        f"reference)")
                target = self._mp_target
            batch = self._pad(batch, rows, target)
        cur = m.iteration
        did_avg = False
        vec = None
        telemetry.host_gap_close()
        # each step brackets its gradient pass (PHASE_COMPUTE) and its
        # exchange with the update (PHASE_GRAD_SYNC); under a health mode
        # each returns its guard vector too
        if self.training_mode is TrainingMode.AVERAGING:
            loss, vec, did_avg = self._averaging_step(batch, rows, cur)
        elif self.threshold_algorithm is not None:
            loss, vec = self._threshold_step(batch, rows, cur)
        elif self._zero:
            loss, vec = self._zero_step(batch, rows, cur)
        elif self.expert_parallel:
            loss, vec = self._expert_step(batch, cur)
        elif self._explicit_exchange:
            loss, vec = self._bucketed_step(batch, rows, cur)
        else:
            loss, vec = self._exact_step(batch, target, cur)
        telemetry.host_gap_open()
        if telemetry.enabled():
            telemetry.record_step("parallel", rows)
            self._record_exchange(did_avg)
        self._score = loss
        if (self._zero or self.expert_parallel
                or self.training_mode is TrainingMode.AVERAGING):
            self._synced = False  # the live trees moved past the model's
        # the networks' step bookkeeping, with the wrapper's health
        # epilogue between the counters and the listeners (the JAX host
        # loop's order)
        m._cast_params = None
        m._score = loss
        m.iteration += 1
        if vec is not None:
            self._observe(cur, loss, vec, batch)
        if profiler.panic_enabled():
            profiler.check_step(loss, "parallel", cur)
        for lst in m.listeners:
            lst.iteration_done(m, cur, m.epoch, loss)

    def _observe(self, cur: int, loss, vec, batch) -> None:
        """The step's guard vector to the monitor, the wrapper the owner
        (or into an open fused group, which reaches it as one stack)."""
        m = self.model
        keys = (("all",) if self.expert_parallel
                else health.bucket_keys(m.params))
        # expert-parallel applies no SKIP_STEP (a loss-only guard): its
        # anomalous updates are never reported as discarded
        skipped = False if self.expert_parallel else None
        if self._fused_group is not None:
            self._fused_group.append((cur, loss, vec))
            return
        health.observe_step(self, "parallel", cur, m.epoch, loss, vec, keys,
                            batch=batch[:2],
                            rng_seed=int(getattr(m.conf, "seed", 0) or 0),
                            skipped=skipped)

    def _fit_batch_fused(self, ds, k: int):
        """A ``[K, B, ...]`` super-batch: K exact steps, one after
        another (the JAX package's fused scan trains bit-identically to
        K single steps)."""
        from deeplearning4j_tpu_torch.datasets.prefetch import unstack

        if (self.training_mode is not TrainingMode.SHARED_GRADIENTS
                or self.threshold_algorithm is not None
                or self._explicit_exchange or self._zero):
            raise ValueError(
                "fused [K, B, ...] batches require the exact "
                "SHARED_GRADIENTS SPMD path (see fused_steps)")
        m = self.model
        if not self._health_mode:
            for j in range(k):
                self._fit_batch(unstack(ds, j))
            return
        # the K steps' guards reach the monitor as one [K, G] stack, as the
        # JAX package's fused scan returns them
        self._fused_group = []
        try:
            for j in range(k):
                self._fit_batch(unstack(ds, j))
            group = self._fused_group
        finally:
            self._fused_group = None
        health.observe_fused(
            self, "parallel", group[0][0], m.epoch,
            torch.stack([g[1] for g in group]),
            torch.stack([g[2] for g in group]),
            health.bucket_keys(m.params), len(group),
            rng_seed=int(getattr(m.conf, "seed", 0) or 0))

    # --- the modes' steps ---------------------------------------------------
    def _exact_step(self, batch, target: int, cur: int):
        """``fit`` on the global padded batch: the global-batch forward,
        this rank's share of the backward, one summed exchange."""
        m = self.model
        on_leaves = self._hooks.arm(None)
        with telemetry.span(telemetry.PHASE_COMPUTE), \
                global_batch.global_batch(self.group, target,
                                          target * self.workers):
            loss, new_state, _ = self._gradients(batch, cur, on_leaves)
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            return self._update(self._hooks.finish(), new_state,
                                self._sum_scalar(loss), cur)

    def _update(self, grads, new_state, loss, cur: int):
        """The update pass of the modes whose ``grads`` are the summed
        (shared) gradients, the same on every rank: plain, or guarded on
        those gradients (``health.guarded_update``, SKIP_STEP's select
        included). Returns ``(loss, guard vector or None)``."""
        m = self.model
        if not self._health_mode:
            m._apply_updates(grads, cur)
            m.state.update(new_state)
            return loss, None
        return loss, health.guarded_update(m, loss, grads, new_state, cur,
                                           m.epoch, self._health_mode)

    def _bucketed_step(self, batch, rows: int, cur: int):
        m = self.model
        c, ctot = self._counts(rows)
        w = float(c / ctot)
        on_leaves = self._hooks.arm(w)
        with telemetry.span(telemetry.PHASE_COMPUTE):
            loss, new_state, _ = self._gradients(batch, cur, on_leaves)
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            return self._update(
                self._hooks.finish(), self._weighted_state(new_state, w),
                self._sum_scalar(loss * float(c)) / float(ctot), cur)

    def _threshold_step(self, batch, rows: int, cur: int):
        m = self.model
        c, ctot = self._counts(rows)
        n = self.workers
        w = float(c * np.float32(n) / ctot)
        with telemetry.span(telemetry.PHASE_COMPUTE):
            loss, new_state, grads = self._gradients(batch, cur)
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            grads = scheduler.tree_map(lambda g: g * w, grads)
            old_residual = self._residual
            enc, self._residual, sparsity = encode_tree(
                grads, self._residual, float(self._tau))
            shared = bucketed_psum(enc, self.group,
                                   self.gradient_bucket_bytes)
            loss, vec = self._update(
                shared, self._weighted_state(new_state, float(c / ctot)),
                self._sum_scalar(loss * float(c)) / float(ctot), cur)
            if self._health_mode == "skip":
                # SKIP_STEP reverts the residual with the params
                self._residual = health.apply_skip(
                    vec, (self._residual,), (old_residual,))[0]
            feedback = self._sum_scalar(sparsity) / n
            # the adaptive threshold needs the sparsity on the host: this
            # mode syncs every step, as the reference's feedback loop does
            self._tau = np.float32(self.threshold_algorithm.update(
                self._tau, np.float32(float(feedback))))
            return loss, vec

    def _zero_step(self, batch, rows: int, cur: int):
        """Reduce-scatter the weighted gradients, update this rank's
        slices of params and updater state, all-gather the params."""
        m = self.model
        c, ctot = self._counts(rows)
        w = float(c / ctot)
        if m.opt_state:  # a mid-fit write-back put the full state back
            m.opt_state = {}
        with telemetry.span(telemetry.PHASE_COMPUTE):
            loss, new_state, grads = self._gradients(batch, cur)
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            loss = self._sum_scalar(loss * float(c)) / float(ctot)
            # the list holds the gradients' only references: the scatter
            # frees each one as it packs it
            grads = scheduler.tree_leaves(grads)
            vec = self._zero_update(
                self._zero_x.scatter(grads, w, self.group), cur, loss)
            new_state = self._weighted_state(new_state, w)
            if vec is not None and self._health_mode == "skip":
                ok = health.vec_ok(vec)
                new_state = {k: health._select(ok, s, m.state[k])
                             if k in m.state else s
                             for k, s in new_state.items()}
            m.state.update(new_state)
            return loss, vec

    def _zero_update(self, flat, cur: int, loss):
        """Gradient normalization (full-tensor norms from the slices'
        summed squares), regularization and the updater on this rank's
        slices (``flat``: the reduce-scattered gradients), then the params'
        all-gather into the model's tensors. Each layer's new param slices
        take its gradients' place in ``flat``, which the gather sends.

        Under a health mode the guard vector comes from the slices: each
        bucket's squared gradient sum, and the update's and the params'
        squared norms, summed over the ranks in the same all-reduce
        (slices partition every tensor, so these are the full trees'
        sums). SKIP_STEP selects the new param and updater-state slices
        against the old by the step's flag before the gather. Returns the
        guard vector (None without a health mode)."""
        from deeplearning4j_tpu_torch.conf.layers import GradientNormalization
        from deeplearning4j_tpu_torch.optimize import solver
        m, x = self.model, self._zero_x
        mode = self._health_mode
        keys = sorted(m.params)
        index = {kp: i for i, kp in enumerate(self._grad_keys())}
        gn = {k for k in keys if getattr(
            m._layer_updater(k)[0], "gradient_normalization", None)
            not in (None, GradientNormalization.NONE)}
        sq = {}
        if gn:
            pairs = [(k, pk) for k in keys if k in gn
                     for pk in sorted(m.params[k])]
            loc = torch.stack([x.slice_of(flat, index[kp]).float().pow(2)
                               .sum() for kp in pairs])
            scheduler.all_reduce(loc, self.group)
            sq = {kp: loc[i] for i, kp in enumerate(pairs)}
        with torch.no_grad():
            if mode:
                # per bucket: the squared sum of its slices' gradients,
                # before normalization (what the JAX step guards)
                bkeys = health.bucket_keys(m.params)
                bucket_sq = [health.sq_sum(
                    [x.slice_of(flat, index[(k, pk)])
                     for pk in sorted(m.params.get(k, {}))], flat.device)
                    for k in bkeys]
            news, diffs, olds = {}, [], []
            for k in keys:
                layer, upd = m._layer_updater(k)
                slot = {pk: x.slice_of(flat, index[(k, pk)])
                        for pk in m.params[k]}
                g_k = dict(slot)
                if k in gn:
                    g_k = solver.normalize_layer_slices(
                        layer, g_k, {pk: sq[(k, pk)] for pk in g_k})
                p_k = {pk: x.local_slice(p, index[(k, pk)], self.rank)
                       for pk, p in m.params[k].items()}
                lr = upd.current_lr(cur, m.epoch)
                if mode:
                    # out of place (the bits p.sub_(update) gives), so the
                    # old slices stay for the norms and SKIP_STEP's select
                    upds, new_o = solver.layer_updates(
                        layer, upd, p_k, g_k, self._opt_slices[k], lr, cur,
                        m.epoch)
                    new_p = {pk: p - upds[pk] for pk, p in p_k.items()}
                    floats = [pk for pk in sorted(p_k)
                              if p_k[pk].is_floating_point()]
                    diffs.append(health.sq_sum(
                        [new_p[pk].float() - p_k[pk].float()
                         for pk in floats], flat.device))
                    olds.append(health.sq_sum([p_k[pk] for pk in floats],
                                              flat.device))
                else:
                    new_p, new_o = solver.apply_updater_to_layer(
                        layer, upd, p_k, g_k, self._opt_slices[k], lr, cur,
                        m.epoch)
                news[k] = (slot, p_k, new_p, new_o)
            vec = None
            if mode:
                total = torch.stack(bucket_sq + [torch.stack(diffs).sum(),
                                                 torch.stack(olds).sum()])
                scheduler.all_reduce(total, self.group)
                vec = health.assemble(loss, list(total[:-2]), total[-2],
                                      total[-1])
            ok = health.vec_ok(vec) if mode == "skip" else None
            for k, (slot, p_k, new_p, new_o) in news.items():
                if ok is not None:
                    new_p = {pk: torch.where(ok, v, p_k[pk])
                             for pk, v in new_p.items()}
                    old_o = self._opt_slices[k]
                    new_o = {pk: {sk: torch.where(ok, v, old_o[pk][sk])
                                  for sk, v in st.items()}
                             for pk, st in new_o.items()}
                self._opt_slices[k] = new_o
                for pk, p in new_p.items():
                    slot[pk].copy_(p)
            x.gather_into(flat, scheduler.tree_leaves(m.params), self.group)
        return vec

    def _expert_step(self, batch, cur: int):
        """The JAX package's expert-parallel step: each rank's forward and
        backward over its own rows (per-rank batch-norm statistics, as its
        ``shard_map`` step), the sharded ``MoELayer`` s exchanging tokens
        by all-to-all; the objective is the ranks' mean loss. The
        replicated leaves' gradients are averaged over the ranks; an expert
        shard's gradient is its own, which the all-to-all's backward fills
        with every rank's share. A penalty on the expert shards counts in
        full: ``psum(extra) - pmean(extra)`` of the sharded leaves' terms
        joins the objective. Floating state is averaged."""
        m = self.model
        n = float(self.workers)
        self._shard_experts()
        with telemetry.span(telemetry.PHASE_COMPUTE), \
                expert.active_expert_axis(DATA, self.group):
            loss, new_state, grads = self._gradients(batch, cur)
            extra, extra_g = self._sharded_penalty()
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            shards = {(k, pk) for k, pk, _ in self._experts}
            replicated = {k: {pk: g for pk, g in vg.items()
                              if (k, pk) not in shards}
                          for k, vg in grads.items()}
            summed = bucketed_psum(replicated, self.group, None)
            for k, vg in grads.items():
                for pk in vg:
                    g = (summed[k][pk] if (k, pk) not in shards
                         else vg[pk] + extra_g[(k, pk)] * (n - 1.0))
                    vg[pk] = g / n
            m._apply_updates(grads, cur)
            m.state.update(self._weighted_state(new_state, 1.0 / n))
            loss = self._sum_scalar((loss + extra * (n - 1.0)) / n)
        vec = None
        if self._health_mode:
            # the expert shards' gradients stay on their ranks: the guard
            # reads the loss, which a NaN gradient reaches within a step
            # through the shared layers (the JAX package's rule)
            vec = health.loss_guard_vector(loss)
        return loss, vec

    def _sharded_penalty(self):
        """The regularization score of this rank's expert shards and its
        gradient by leaf (zero where no regularization is configured)."""
        m = self.model
        leaves = {}
        total = torch.zeros((), device=m.device)
        for k, pk, layer in self._experts:
            regs = (layer.regularization
                    if pk in layer.regularized_param_keys()
                    else layer.regularization_bias) or ()
            leaf = m.params[k][pk].detach().requires_grad_()
            leaves[(k, pk)] = leaf
            for r in regs:
                total = total + r.score_term(leaf)
        if not total.requires_grad:
            return total, {kp: torch.zeros_like(v)
                           for kp, v in leaves.items()}
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        return total.detach(), {
            kp: torch.zeros_like(v) if g is None else g
            for (kp, v), g in zip(leaves.items(), grads)}

    def _shard_experts(self):
        """Cut every full expert leaf (and its updater state) down to this
        rank's ``n_experts / world`` experts; a leaf already cut stays."""
        m = self.model
        for k, pk, layer in self._experts:
            full = m.params[k][pk]
            if full.shape[0] != layer.n_experts:
                continue
            n = layer.n_experts // self.workers
            lo = self.rank * n

            def cut(t):
                return t[lo:lo + n].clone()

            m.params[k][pk] = cut(full)
            st = m.opt_state.get(k, {}).get(pk)
            if st is not None:
                m.opt_state[k][pk] = {
                    sk: cut(v) if v.ndim and v.shape[0] == layer.n_experts
                    else v for sk, v in st.items()}
        m._cast_params = None

    def _gather_experts(self):
        """Every expert leaf (and its updater state) whole again, from the
        ranks' shards."""
        m = self.model

        def whole(t):
            out = t.new_empty((self.workers,) + tuple(t.shape))
            scheduler.all_gather(out, t.contiguous().view(-1), self.group)
            return out.reshape((-1,) + tuple(t.shape[1:]))

        for k, pk, layer in self._experts:
            part = m.params[k][pk]
            if part.shape[0] == layer.n_experts:
                continue
            m.params[k][pk] = whole(part)
            st = m.opt_state.get(k, {}).get(pk)
            if st is not None:
                m.opt_state[k][pk] = {
                    sk: whole(v) if v.ndim and v.shape[0] == part.shape[0]
                    else v for sk, v in st.items()}
        m._cast_params = None

    def _averaging_step(self, batch, rows: int, cur: int):
        """A local step on this rank's replica (none for an all-padding
        rank), then every ``averaging_frequency`` iterations the average
        over the replicas."""
        m = self.model
        m.params, m.state, m.opt_state = self._params, self._state, self._opt
        c, ctot = self._counts(rows)
        mode = self._health_mode
        vec = None
        with telemetry.span(telemetry.PHASE_COMPUTE):
            if c > 0:
                loss, new_state, grads = self._gradients(batch, cur)
                if mode:
                    # each replica guards (and under SKIP_STEP skips) its
                    # own step
                    vec = health.guarded_update(m, loss, grads, new_state,
                                                cur, m.epoch, mode)
                else:
                    m._apply_updates(grads, cur)
                    m.state.update(new_state)
            else:
                loss = torch.zeros((), device=m.device)
        if mode:
            if vec is None:  # an all-padding replica reports 0
                vec = torch.zeros(
                    (health.GUARD_HEAD
                     + len(health.bucket_keys(m.params)),),
                    dtype=torch.float32, device=m.device)
            # any replica's anomaly is the step's anomaly
            vec = health.combine_across(vec, self.group)
        did_avg = ((cur + 1) // self.averaging_frequency
                   > cur // self.averaging_frequency)
        with telemetry.span(telemetry.PHASE_GRAD_SYNC):
            if did_avg:
                group = (self._params, self._state) + (
                    (self._opt,) if self.average_updaters else ())
                self._average_into(group)
            return (self._sum_scalar(loss * float(c)) / float(ctot), vec,
                    did_avg)

    def _average_into(self, trees):
        """Replace every floating leaf of ``trees`` by its mean over the
        replicas (in place)."""
        floats = scheduler.tree_map(
            lambda x: x if _is_float(x) else None, trees)
        summed = bucketed_psum(floats, self.group,
                               self.gradient_bucket_bytes)
        for dst, s in zip(scheduler.tree_leaves(floats),
                          scheduler.tree_leaves(summed)):
            dst.copy_(s / self.workers)

    # --- gather-on-save ------------------------------------------------------
    def sync_model(self):
        """Gather the live training trees back onto the wrapped model
        without ending training (ZeRO's updater state, the averaging
        replicas' mean): the hook ``serializer.write_model`` calls. A
        collective: every rank calls it."""
        self._write_back()
        return self.model

    def _write_back(self):
        if self._synced or not self._setup_done:
            return
        self._synced = True
        m = self.model
        if self.training_mode is TrainingMode.AVERAGING:
            mean = scheduler.tree_map(
                lambda x: x.detach().clone(),
                (self._params, self._state, self._opt))
            self._average_into(mean)
            m.params, m.state, m.opt_state = mean
            m._cast_params = None
        elif self._zero:
            m.opt_state = {
                k: {pk: {sk: v.detach().clone() for sk, v in st.items()}
                    for pk, st in vp.items()}
                for k, vp in self._zero_ospec.assemble(
                    self._opt_slices, self.group).items()}
        elif self.expert_parallel:
            self._gather_experts()

    # --- health-layer hooks (thin, as the networks') ------------------------
    def _health_snapshot(self):
        """A host copy of the live training trees: this rank's own replica
        in averaging mode (as the JAX package snapshots each replica), else
        the model's, gathered first (ZeRO's slices: a collective, which
        every rank reaches on the same step, its guard being the same on
        every rank)."""
        from deeplearning4j_tpu_torch.optimize import checkpoint

        m = self.model
        if (self.training_mode is TrainingMode.AVERAGING
                and self._setup_done):
            return {"params": checkpoint._host_copy(self._params),
                    "state": checkpoint._host_copy(self._state),
                    "opt_state": checkpoint._host_copy(self._opt),
                    "iteration": int(m.iteration), "epoch": int(m.epoch)}
        snap = checkpoint.snapshot_training_state(m)
        if self._residual is not None:
            snap["residual"] = checkpoint._host_copy(self._residual)
            snap["tau"] = self._tau
        return snap

    def _health_restore(self, snap):
        from deeplearning4j_tpu_torch.optimize import checkpoint

        checkpoint.restore_training_state(self.model, snap)
        if self._setup_done:
            self._setup()  # re-stage replicas / slices from the model
        if "residual" in snap:
            dev = self.model.device
            self._residual = scheduler.tree_map(
                lambda a: torch.as_tensor(a, device=dev), snap["residual"])
            self._tau = snap["tau"]
        self._score = None

    # --- score / telemetry ---------------------------------------------------
    @property
    def score_value(self) -> float:
        return float("nan") if self._score is None else float(self._score)

    def _record_exchange(self, did_average: bool = False):
        """The JAX package's counters: this step's logical per-rank
        payload and collectives by operation, the bucket layout once per
        schedule."""
        m = self.model
        if self.training_mode is TrainingMode.AVERAGING:
            if did_average:
                group = (self._params, self._state) + (
                    (self._opt,) if self.average_updaters else ())
                layout = bucket_layout(group, self.gradient_bucket_bytes
                                       if self._explicit_exchange else None)
                telemetry.record_collective("average", sum(layout),
                                            len(layout))
            return
        if self._zero:
            layout = getattr(self, "_zero_layout", None)
            if layout is None:
                layout = self._zero_layout = self._zero_pspec.layout_bytes(
                    self.gradient_bucket_bytes)
                telemetry.record_bucket_layout("grad_reduce_scatter",
                                               layout)
                telemetry.record_bucket_layout("param_all_gather", layout)
            for op in ("grad_reduce_scatter", "param_all_gather"):
                telemetry.record_collective(op, sum(layout), len(layout))
            return
        op = ("threshold_psum" if self.threshold_algorithm is not None
              else "grad_psum")
        layout = getattr(self, "_grad_layout", None)
        if layout is None:
            layout = self._grad_layout = bucket_layout(
                m.params, self.gradient_bucket_bytes)
            telemetry.record_bucket_layout(op, layout)
        telemetry.record_collective(op, sum(layout), len(layout))
