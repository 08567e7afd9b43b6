"""Pipeline parallelism over the mesh's ``pipeline`` axis.

Counterpart of the JAX package's ``parallel/pipeline.py``. The JAX package
compiles the whole pipeline (every stage, microbatch, forward and
backward) into one program: a ``lax.scan`` whose hand-off is a
``ppermute`` and whose backward is the scan's transpose. The port runs
one process per rank (the PyTorch idiom): each rank of the ``pipeline``
axis is one stage, holds only its stage's trees, and hands activations to
the next stage and gradients to the previous one as point-to-point sends
(``comms.scheduler.p2p``: NCCL on the card, gloo through the host, every
send counted). A rank's schedule is a loop over its micro-operations; a
receive blocks until its neighbour's send lands, so the ticks of the JAX
scan are implicit.

The functional API (stages given as functions):

- :func:`stack_stage_params` keeps this rank's stage's tree;
- :func:`pipeline_spmd_fn`: the GPipe forward of equal-signature stages
  (``S + M - 1`` ticks: microbatch ``m`` runs on stage ``s`` at tick
  ``m + s``); the last stage's outputs reach every rank of the pipeline;
- :func:`pipeline_train_step`: the same forward, the loss on the outputs,
  the reverse schedule (each stage's backward of each microbatch, the
  input's gradient sent back), plain SGD on each stage's own params;
- :class:`HeteroPipeline`: stages with their own param trees and
  activation shapes (inferred on ``meta`` tensors, the counterpart of
  ``jax.eval_shape``); :func:`serial_reference` and
  :func:`hetero_serial_reference` are the oracles.

The JAX package's ``psum_replicate`` fixes how ``shard_map`` transposes a
replicating ``psum`` under its older type system; the port has no such
transpose (each stage runs its own autograd), so it has no counterpart.

:class:`PipelineParallelWrapper` trains a ``MultiLayerNetwork`` or a
single-output ``ComputationGraph`` from its configuration: the layers
(vertices, in topo order) before the loss head split into contiguous
stages balanced by parameter count, none empty; a graph's boundaries
carry their crossing sets (every tensor made before the cut and read at or
after it: a skip connection widens the boundary, the head's input rides to
the last one), each tensor sent in its own dtype (token ids as integers).
The head (the MLN's last layer, the graph's output vertex) lives on the
last stage. One step on every rank:

- **GPipe** (``schedule="gpipe"``): every microbatch forward through the
  stage, its autograd graph kept, mutable state (BN running statistics)
  threaded in microbatch order; then microbatch by microbatch the
  backward: the last stage scores ``head.score(out_m, y_m) / M`` and
  backpropagates, each other stage receives its outputs' gradient from
  stage ``s + 1`` and sends its inputs' to ``s - 1``. Each stage adds its
  regularization score (the last its head's) and backpropagates it once.
- **1F1B** (``schedule="1f1b"``): each rank follows its row of
  :func:`_one_f1b_tables` (the JAX package's static timetables, copied
  with their asserted invariants): a slot holds at most one forward and
  one backward micro-operation, at most ``S - s`` microbatches in flight
  on stage ``s``. The JAX package stashes each in-flight microbatch's
  input and recomputes its forward under ``jax.vjp``, because its scan
  needs a fixed-size carry; the port keeps each in-flight microbatch's
  autograd graph instead: the same O(S) bound on live activations, and
  no forward launched twice. The head folds into the last stage's
  backward.
- **data axis**: data replica ``r`` takes its slice of every microbatch
  (the JAX ``P(None, 'data')`` cut), the loss, the stage's gradients and
  its BN state are averaged over the stage's data subgroup.
- **update**: each stage's gradients stay on it and go through the port's
  solver chain (per-layer gradient normalization, regularization, the
  layer's updater at ``current_lr(iteration, epoch)``); updater state
  starts afresh when the stages are built, as in the JAX package.

Dropout draws in each layer from a ``torch.Generator`` seeded from the
configuration's seed, the iteration, the microbatch and the layer's index
(the layer index of an MLN, the topo index of a graph), as the JAX
package folds ``PRNGKey(seed)`` with the iteration, the microbatch and the
index: the masks depend on neither the schedule nor ``S``.

Refused as the JAX package refuses them: tBPTT, ``compute_dtype``,
masked DataSets, MoE aux-loss and mask-dependent layers, multi-output
graphs and heads that are not single-input output layers, a batch that
does not split into ``n_micro x data`` rows, a changed microbatch shape.
A mesh with ``model`` or ``sequence`` ranks beside its pipeline ranks is
refused too (the JAX wrapper's ``shard_map`` names only the stage and data
axes). ``write_back`` gives every rank's model every stage's params, BN
state and updater state and the head's.
"""

from __future__ import annotations

import time
import types
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel.mesh import PIPELINE_AXIS as STAGE_AXIS

_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_NDIM = 8


def _check_stages(mesh, n_stages: int) -> None:
    if mesh.shape[STAGE_AXIS] != n_stages:
        raise ValueError(f"mesh stage axis = {mesh.shape[STAGE_AXIS]}, "
                         f"n_stages = {n_stages}")


class _Link:
    """This rank's hand-offs to its neighbour stages (default-group ranks)
    through ``scheduler.p2p``: receives block, sends run on until
    :meth:`flush`; ``ms`` is the wall time spent in them."""

    def __init__(self, mesh):
        self.prev, self.next = mesh.prev_stage, mesh.next_stage
        self.pending = []
        self.ms = 0.0

    def send(self, dst: int, tensors) -> None:
        if not tensors:
            return
        t0 = time.perf_counter()
        self.pending.append(scheduler.p2p(
            [(dst, t.detach()) for t in tensors], [], wait=False))
        self.ms += (time.perf_counter() - t0) * 1e3

    def recv(self, src: int, bufs) -> None:
        if not bufs:
            return
        t0 = time.perf_counter()
        scheduler.p2p([], [(src, b) for b in bufs])
        self.ms += (time.perf_counter() - t0) * 1e3

    def flush(self) -> None:
        t0 = time.perf_counter()
        for p in self.pending:
            p.wait()
        self.pending = []
        self.ms += (time.perf_counter() - t0) * 1e3


def _broadcast_stage(tree_like: dict, src: int, group) -> None:
    """Every leaf of ``tree_like`` (a {key: {name: tensor}} tree, in
    place) from process ``src`` to the group, one flat buffer a dtype."""
    leaves = scheduler.tree_leaves(tree_like)
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, device), ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1 \
            else ts[0].reshape(-1).clone()
        scheduler.broadcast(flat, src, group)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape))
            off += n


# --------------------------------------------------------------------------
# the functional API
# --------------------------------------------------------------------------

def stack_stage_params(per_stage: list, mesh, device="cuda"):
    """[S trees with one structure] -> this rank's stage's tree, copied
    onto ``device`` (stage ``s``'s params live on its rank only)."""
    if len(per_stage) != mesh.shape[STAGE_AXIS]:
        raise ValueError(f"{len(per_stage)} stage trees for a mesh stage "
                         f"axis of {mesh.shape[STAGE_AXIS]}")
    return scheduler.tree_map(
        lambda t: torch.as_tensor(t).to(device=device, copy=True),
        per_stage[mesh.stage])


def _gpipe_forward(fns, params, x_micro, mesh, in_specs, grad: bool):
    """This rank's GPipe forward (shared by inference and training, so
    the two cannot drift): microbatch ``m`` runs on stage ``s`` at tick
    ``m + s`` of ``S + M - 1``, stage 0 injecting ``x_micro[m]``, each
    other stage receiving it from ``s - 1``. Returns the stage's inputs and
    outputs per microbatch (with ``grad``, a received input requires
    grad and the outputs keep their autograd graphs) and the link."""
    S, s = mesh.shape[STAGE_AXIS], mesh.stage
    link = _Link(mesh)
    fn = fns[s]
    shape, dtype = in_specs[s]
    xs, ys = [], []
    for m in range(x_micro.shape[0]):
        if s == 0:
            x = x_micro[m]
        else:
            x = torch.empty(shape, dtype=dtype, device=x_micro.device)
            link.recv(link.prev, [x])
            if grad and x.is_floating_point():
                x.requires_grad_(True)
        with torch.set_grad_enabled(grad):
            y = fn(params, x)
        if s < S - 1:
            link.send(link.next, [y])
        xs.append(x)
        ys.append(y)
    return xs, ys, link


def _replicated_outputs(ys, mesh, out_spec, device):
    """The last stage's ``[M, ...]`` outputs on every rank of the
    pipeline (the JAX package's replicating ``psum``)."""
    S = mesh.shape[STAGE_AXIS]
    if mesh.stage == S - 1:
        out = torch.stack([y.detach() for y in ys])
    else:
        out = torch.empty((len(ys),) + tuple(out_spec[0]),
                          dtype=out_spec[1], device=device)
    if S > 1:
        scheduler.broadcast(out, mesh.stage_rank(S - 1), mesh.pipeline_group)
    return out


def _reverse(xs, ys, link, mesh, loss_fn_last):
    """The reverse schedule after :func:`_gpipe_forward`: the last stage
    backpropagates ``loss_fn_last(ys)`` (returns the loss), every other
    stage each microbatch's output gradient received from ``s + 1``; each
    stage but the first sends its inputs' gradients to ``s - 1``."""
    S, s = mesh.shape[STAGE_AXIS], mesh.stage
    loss = None
    if s == S - 1:
        loss = loss_fn_last(ys)
        loss.backward()
    for m in range(len(xs)):
        if s < S - 1:
            g = torch.empty_like(ys[m])
            link.recv(link.next, [g])
            if ys[m].requires_grad:
                ys[m].backward(g)
        if s > 0:
            x = xs[m]
            link.send(link.prev, [x.grad if x.grad is not None
                                  else torch.zeros_like(x)])
    link.flush()
    return loss


def _replicated_loss(loss, mesh, device):
    S = mesh.shape[STAGE_AXIS]
    out = (loss.detach().reshape(1).to(torch.float32).clone()
           if loss is not None else torch.zeros(1, device=device))
    if S > 1:
        scheduler.broadcast(out, mesh.stage_rank(S - 1), mesh.pipeline_group)
    return out[0]


def _sgd(params, lr):
    with torch.no_grad():
        return scheduler.tree_map(
            lambda p: (p - lr * p.grad) if p.grad is not None
            else p.detach().clone(), params)


def _leaves(params):
    return scheduler.tree_map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()), params)


def pipeline_spmd_fn(stage_fn, n_stages: int, n_micro: int, mesh):
    """-> ``(my_params, x_micro) -> outputs``. ``stage_fn(params, x) -> y``
    is ONE stage's forward (y has x's shape); ``my_params`` is this rank's
    stage tree (:func:`stack_stage_params`); ``x_micro`` is ``[M, mb,
    ...]`` on every rank (only stage 0 reads it). Returns the ``[M, mb,
    ...]`` outputs on every rank."""
    _check_stages(mesh, n_stages)

    def run(my_params, x_micro):
        spec = (tuple(x_micro.shape[1:]), x_micro.dtype)
        xs, ys, link = _gpipe_forward([stage_fn] * n_stages, my_params,
                                      x_micro, mesh, [spec] * n_stages,
                                      grad=False)
        link.flush()
        return _replicated_outputs(ys, mesh, spec, x_micro.device)

    return run


def pipeline_train_step(stage_fn, loss_fn, n_stages: int, n_micro: int,
                        mesh, lr: float = 0.05):
    """-> ``(my_params, x_micro, y_micro) -> (new_params, loss)``: the
    pipelined forward, ``loss_fn(outputs [M, ...], y_micro)`` on the last
    stage, the reverse schedule, stage-local SGD (each rank updates only
    its own stage's params: no gradient crosses stages). The loss reaches
    every rank."""
    _check_stages(mesh, n_stages)

    def step(my_params, x_micro, y_micro):
        spec = (tuple(x_micro.shape[1:]), x_micro.dtype)
        leaves = _leaves(my_params)
        xs, ys, link = _gpipe_forward([stage_fn] * n_stages, leaves,
                                      x_micro, mesh, [spec] * n_stages,
                                      grad=True)
        loss = _reverse(xs, ys, link, mesh,
                        lambda outs: loss_fn(torch.stack(outs), y_micro))
        return (_sgd(leaves, lr),
                _replicated_loss(loss, mesh, x_micro.device))

    return step


def serial_reference(stage_fn, per_stage_params: list, x):
    """The pipeline's oracle: apply the stages one after another."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x


def _meta(t):
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class HeteroPipeline:
    """S stages with their own param trees and activation shapes.

    ``stage_fns[s](params_s, x_s) -> y_s``; the shapes chain from
    ``example_in`` (anything with ``shape`` and ``dtype``: one microbatch)
    on ``meta`` tensors, the counterpart of ``jax.eval_shape``, into
    ``in_shapes`` / ``out_shape``. :meth:`stack_params` keeps this rank's
    stage's tree, :meth:`spmd_fn` runs the GPipe forward, :meth:`train_step`
    a plain-SGD step (``PipelineParallelWrapper`` drives a network with
    its configuration's updaters)."""

    def __init__(self, stage_fns, per_stage_params, example_in, mesh,
                 n_micro: int, device="cuda"):
        self.stage_fns = list(stage_fns)
        self.n_stages = len(self.stage_fns)
        self.n_micro = int(n_micro)
        self.mesh = mesh
        self.device = torch.device(device)
        _check_stages(mesh, self.n_stages)
        self._like = [scheduler.tree_map(lambda t: torch.as_tensor(t), p)
                      for p in per_stage_params]
        x = torch.empty(tuple(example_in.shape),
                        dtype=_torch_dtype(example_in.dtype), device="meta")
        self.in_shapes, self._in_specs = [], []
        for f, p in zip(self.stage_fns, self._like):
            self.in_shapes.append(tuple(x.shape))
            self._in_specs.append((tuple(x.shape), x.dtype))
            x = f(scheduler.tree_map(_meta, p), x)
        self.out_shape = tuple(x.shape)
        self.out_dtype = x.dtype

    def stack_params(self, per_stage_params):
        """This rank's stage's tree on the pipeline's device."""
        return stack_stage_params(per_stage_params, self.mesh, self.device)

    def unstack_params(self, my_params):
        """Every stage's tree on every rank of the pipeline (a broadcast
        from each stage's rank)."""
        out = []
        for s in range(self.n_stages):
            tree = (scheduler.tree_map(lambda t: t.detach().clone(), my_params)
                    if s == self.mesh.stage else
                    scheduler.tree_map(lambda t: torch.empty(
                        t.shape, dtype=t.dtype, device=self.device),
                        self._like[s]))
            if self.n_stages > 1:
                _broadcast_stage(tree, self.mesh.stage_rank(s),
                                 self.mesh.pipeline_group)
            out.append(tree)
        return out

    def spmd_fn(self):
        """-> ``(my_params, x_micro [M, ...]) -> [M, ...]`` outputs on
        every rank."""
        def run(my_params, x_micro):
            xs, ys, link = _gpipe_forward(
                self.stage_fns, my_params, x_micro, self.mesh,
                self._in_specs, grad=False)
            link.flush()
            return _replicated_outputs(ys, self.mesh,
                                       (self.out_shape, self.out_dtype),
                                       x_micro.device)

        return run

    def train_step(self, loss_fn, lr: float = 0.05):
        """``(my_params, x_micro, y_micro) -> (new_params, loss)``: plain
        SGD, gradients stage-local."""
        def step(my_params, x_micro, y_micro):
            leaves = _leaves(my_params)
            xs, ys, link = _gpipe_forward(
                self.stage_fns, leaves, x_micro, self.mesh, self._in_specs,
                grad=True)
            loss = _reverse(xs, ys, link, self.mesh,
                            lambda outs: loss_fn(torch.stack(outs),
                                                 y_micro))
            return (_sgd(leaves, lr),
                    _replicated_loss(loss, self.mesh, x_micro.device))

        return step


def hetero_serial_reference(stage_fns, per_stage_params, x):
    for f, p in zip(stage_fns, per_stage_params):
        x = f(p, x)
    return x


# --------------------------------------------------------------------------
# the 1F1B timetables (the JAX package's, unchanged)
# --------------------------------------------------------------------------

def _one_f1b_tables(S: int, M: int):
    """Static 1F1B timetables: ``fwd[s, t]`` / ``bwd[s, t]`` = microbatch
    index (or -1) stage ``s`` forwards / backwards at slot ``t``.

    Greedy simulation of the classic non-interleaved schedule
    (PipeDream-flush): each stage backwards the oldest ready microbatch
    every slot, and forwards the next microbatch only while its
    in-flight count (forwarded, not yet backwarded) stays under
    ``S - s``. The message-lifetime invariants the JAX package's S-slot
    rings rely on are asserted, not assumed."""
    INF = 10 ** 9
    fwd_t = np.full((S, M), INF, np.int64)   # slot of fwd(s, m)
    bwd_t = np.full((S, M), INF, np.int64)
    next_fwd = [0] * S
    next_bwd = [0] * S
    t = 0
    while any(nb < M for nb in next_bwd):
        if t > 4 * (S + M) + 16:
            raise AssertionError("1F1B simulator did not converge")
        for s in range(S):
            def try_bwd():
                m = next_bwd[s]
                if m >= M or fwd_t[s][m] > t:
                    return
                if s < S - 1 and bwd_t[s + 1][m] >= t:
                    return
                bwd_t[s][m] = t
                next_bwd[s] += 1

            def try_fwd():
                m = next_fwd[s]
                if m >= M:
                    return
                if s > 0 and fwd_t[s - 1][m] >= t:
                    return
                if next_fwd[s] - next_bwd[s] >= S - s:
                    return  # 1F1B in-flight bound
                fwd_t[s][m] = t
                next_fwd[s] += 1

            if s == S - 1:
                try_fwd()   # head may bwd its own fwd in the same slot
                try_bwd()
            else:
                try_bwd()
                try_fwd()
        t += 1
    total = t
    # ring-lifetime invariants (S-slot rings indexed m % S):
    for s in range(S):
        for m in range(M):
            if m + S < M:
                # fwd message (s -> s+1): consumed before slot m+S lands
                if s + 1 < S:
                    assert fwd_t[s + 1][m] <= fwd_t[s][m + S], (s, m)
                # bwd message (s+1 -> s): same, reversed direction
                if s > 0:
                    assert bwd_t[s - 1][m] <= bwd_t[s][m + S], (s, m)
                # input stash at s: read strictly before fwd(m+S) lands
                assert bwd_t[s][m] <= fwd_t[s][m + S], (s, m)
    fwd = np.full((S, total), -1, np.int32)
    bwd = np.full((S, total), -1, np.int32)
    for s in range(S):
        for m in range(M):
            fwd[s, fwd_t[s][m]] = m
            bwd[s, bwd_t[s][m]] = m
    return fwd, bwd, total


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class PipelineParallelWrapper:
    """Pipeline-parallel training of a ``MultiLayerNetwork`` or a
    single-output ``ComputationGraph`` (see the module docstring)::

        mesh = single_host_mesh(pipeline=2)      # after initialize_distributed
        pw = PipelineParallelWrapper(net, n_micro=4, mesh=mesh)
        pw.fit(iterator_of_global_batches)       # every rank, every batch

    Every rank builds the whole network from the same seed and is fed the
    same global batches; stage ``s``'s params, BN state and updater state
    move only on its rank until :meth:`write_back`. ``mesh`` defaults to
    every rank on the pipeline axis."""

    def __init__(self, model, n_micro: int = 4, mesh=None,
                 n_stages: Optional[int] = None, schedule: str = "gpipe"):
        from deeplearning4j_tpu_torch.conf.layers_moe import AUX_LOSS_KEY
        from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if isinstance(model, MultiLayerNetwork):
            self._is_graph = False
        elif isinstance(model, ComputationGraph):
            self._is_graph = True
        else:
            raise TypeError(
                "PipelineParallelWrapper drives MultiLayerNetwork or "
                "ComputationGraph models")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.schedule = schedule
        if model.params is None:
            model.init()
        if getattr(model.conf, "backprop_type", None) \
                is BackpropType.TRUNCATED_BPTT:
            raise ValueError("pipeline training does not compose with "
                             "tBPTT yet")
        if getattr(model, "_cdtype", None) is not None:
            raise ValueError(
                "compute_dtype policies are not supported under pipeline "
                "training yet (the stages keep float32 masters)")
        self.model = model
        if mesh is None:
            mesh = mesh_mod.single_host_mesh(pipeline=scheduler.world_of())
        self.mesh = mesh
        if STAGE_AXIS not in self.mesh.shape:
            raise ValueError(f"mesh needs a '{STAGE_AXIS}' axis")
        self.n_stages = n_stages or self.mesh.shape[STAGE_AXIS]
        if self.mesh.shape[STAGE_AXIS] != self.n_stages:
            raise ValueError(
                f"mesh stage axis = {self.mesh.shape[STAGE_AXIS]} but "
                f"n_stages = {self.n_stages}")
        other = {a: self.mesh.shape[a] for a in (mesh_mod.MODEL_AXIS,
                                                 mesh_mod.SEQUENCE_AXIS)
                 if self.mesh.shape[a] > 1}
        if other and self.n_stages > 1:
            raise NotImplementedError(
                f"mesh axes {other} beside the pipeline axis: pipeline "
                f"stages compose with the data axis only (the JAX "
                f"wrapper's shard_map names the stage and data axes)")
        if self.mesh.backend == "nccl" and model.device.type != "cuda":
            raise ValueError(
                "NCCL moves CUDA tensors only: train a CPU model over gloo")
        self.data_size = self.mesh.shape.get(mesh_mod.DATA_AXIS, 1)
        self.n_micro = int(n_micro)
        self.stage = self.mesh.stage if self.n_stages > 1 else 0
        if self._is_graph:
            self._init_graph_plan(AUX_LOSS_KEY)
        else:
            self._init_mln_plan(AUX_LOSS_KEY)
        self._pipe_built = False
        self.score_value = float("nan")
        self.last_step: dict = {}
        self._on_grads = None  # a hook: this stage's gradients, each step

    # --- partitioning ------------------------------------------------------

    def _balanced_bounds(self, counts):
        """Contiguous partition of ``len(counts)`` units into n_stages,
        balanced by count, no stage empty."""
        total = sum(counts) or 1
        n = len(counts)
        if n < self.n_stages:
            raise ValueError(
                f"{n} stage-able layers < {self.n_stages} stages")
        bounds, acc, nxt = [0], 0.0, 1
        for i, c in enumerate(counts):
            acc += c
            if nxt >= self.n_stages:
                break
            remaining = n - (i + 1)
            rem_stages = self.n_stages - nxt
            if (acc >= nxt * total / self.n_stages
                    or remaining == rem_stages) and remaining >= rem_stages:
                bounds.append(i + 1)
                nxt += 1
        bounds.append(n)
        return bounds

    def _check_key(self, key, conf, state, aux_key):
        if isinstance(state.get(key), dict) and aux_key in state[key]:
            raise ValueError(
                f"{key}: layers carrying auxiliary losses (MoE) are not "
                "supported under pipeline training yet")
        if getattr(conf, "mask_dependent", False):
            raise ValueError(f"{key}: mask-consuming layers need masked "
                             "DataSets, unsupported under pipeline")

    @staticmethod
    def _count(params: dict) -> int:
        return sum(int(np.prod(tuple(p.shape))) for p in params.values())

    def _init_mln_plan(self, aux_key):
        model = self.model
        layers = model.conf.layers
        self.out_layer = layers[-1]
        if not hasattr(self.out_layer, "score"):
            raise ValueError("last layer must be a loss head (score())")
        self._head_key = str(len(layers) - 1)
        self._head_input = "__x__"
        for i, layer in enumerate(layers[:-1]):
            self._check_key(str(i), layer, model.state, aux_key)
        counts = [self._count(model.params.get(str(i), {}))
                  for i in range(len(layers) - 1)]
        bounds = self._balanced_bounds(counts)
        self.stage_layers = [list(range(bounds[s], bounds[s + 1]))
                             for s in range(self.n_stages)]
        self.stage_keys = [[str(i) for i in idxs]
                           for idxs in self.stage_layers]
        # a chain crosses exactly one activation at every boundary
        self._crossings = [["__x__"] for _ in range(self.n_stages + 1)]
        self._plan_kind = "chain"

    def _init_graph_plan(self, aux_key):
        model = self.model
        conf = model.conf
        if len(conf.network_outputs) != 1:
            raise ValueError("pipeline training supports single-output "
                             "graphs (got "
                             f"{len(conf.network_outputs)})")
        out_spec = conf.vertex_map()[conf.network_outputs[0]]
        if not (hasattr(out_spec.vertex, "score")
                and getattr(out_spec.vertex, "is_output", lambda: False)()):
            raise ValueError("output vertex is not an output layer")
        if len(out_spec.inputs) != 1:
            raise ValueError("pipeline training needs a single-input "
                             "output vertex")
        self.out_layer = out_spec.vertex
        self._head_key = out_spec.name
        self._head_input = out_spec.inputs[0]
        topo = [n for n in model._topo if n != out_spec.name]
        for n in topo:
            v = model._vmap[n].vertex
            lconf = getattr(v, "layer", None) or v
            self._check_key(n, lconf, model.state, aux_key)
        counts = [self._count(model.params.get(n, {})) for n in topo]
        bounds = self._balanced_bounds(counts)
        self.stage_keys = [topo[bounds[s]:bounds[s + 1]]
                           for s in range(self.n_stages)]
        self.stage_layers = self.stage_keys  # alias for introspection
        self._plan_kind = "dag"
        # crossing set per boundary b = names produced before b (network
        # inputs count as produced at -1) and consumed at / after b (the
        # head's input is consumed at boundary S)
        seg_of = {n: s for s, keys in enumerate(self.stage_keys)
                  for n in keys}
        vmap = model._vmap
        self._crossings = []
        for b in range(self.n_stages + 1):
            names = []
            for src in list(conf.network_inputs) + topo:
                prod = -1 if src in conf.network_inputs else seg_of[src]
                if prod >= b:
                    continue
                consumers = [n for n in topo
                             if src in vmap[n].inputs and seg_of[n] >= b]
                # the head's input rides to the last boundary even with
                # no further vertex consumers
                if consumers or src == self._head_input:
                    names.append(src)
            self._crossings.append(names)
        self._crossings[-1] = [self._head_input]

    # --- build (first batch) -----------------------------------------------

    def _my_keys(self):
        keys = list(self.stage_keys[self.stage])
        if self.stage == self.n_stages - 1:
            keys.append(self._head_key)
        return keys

    def _build(self):
        m = self.model
        self._keys = self._my_keys()
        self._opt = {k: {pk: m._layer_updater(k)[1].init_state(v)
                         for pk, v in m.params[k].items()}
                     for k in self._keys if k in m.params}
        # the solver's view of this stage: the model's params (updated in
        # place), this stage's updater state
        self._solver = types.SimpleNamespace(
            params=m.params, opt_state=self._opt,
            _layer_updater=m._layer_updater)
        self._in_specs = None     # (name, shape, dtype) of what arrives
        self._header_sent = False
        self._tables = (_one_f1b_tables(self.n_stages, self.n_micro)
                        if self.schedule == "1f1b" else None)
        self._pipe_built = True

    # --- hand-offs ---------------------------------------------------------

    def _header(self, names, tensors) -> torch.Tensor:
        h = torch.zeros((len(names), 2 + _MAX_NDIM), dtype=torch.int64)
        for i, n in enumerate(names):
            t = tensors[n]
            h[i, 0] = _DTYPES.index(t.dtype)
            h[i, 1] = t.ndim
            h[i, 2:2 + t.ndim] = torch.tensor(list(t.shape),
                                              dtype=torch.int64)
        return h.to(self.model.device)

    def _send_fwd(self, outs: dict) -> None:
        names = self._crossings[self.stage + 1]
        if not self._header_sent:
            # the first step tells the next stage what it will receive
            self._link.send(self._link.next, [self._header(names, outs)])
            self._header_sent = True
        self._link.send(self._link.next, [outs[n] for n in names])

    def _recv_fwd(self) -> dict:
        names = self._crossings[self.stage]
        dev = self.model.device
        if self._in_specs is None:
            h = torch.empty((len(names), 2 + _MAX_NDIM), dtype=torch.int64,
                            device=dev)
            self._link.recv(self._link.prev, [h])
            h = h.cpu()
            self._in_specs = [
                (n, tuple(int(d) for d in h[i, 2:2 + int(h[i, 1])]),
                 _DTYPES[int(h[i, 0])]) for i, n in enumerate(names)]
        bufs = {n: torch.empty(shape, dtype=dt, device=dev)
                for n, shape, dt in self._in_specs}
        self._link.recv(self._link.prev, list(bufs.values()))
        for t in bufs.values():
            if t.is_floating_point():
                t.requires_grad_(True)
        return bufs

    # --- micro-operations --------------------------------------------------

    def _inject(self, m: int) -> dict:
        """Stage 0's inputs of microbatch ``m``: this data replica's rows
        of it."""
        lo = m * self._mb + self._replica * self._mbd
        names = self._crossings[0]
        if self._plan_kind == "chain":
            return {"__x__": self._feats[0][lo:lo + self._mbd]}
        by_name = dict(zip(self.model.conf.network_inputs, self._feats))
        return {n: by_name[n][lo:lo + self._mbd] for n in names}

    def _micro_seed(self, m: int) -> int:
        from deeplearning4j_tpu_torch.nn.graph import _vertex_seed

        return _vertex_seed(self._step_seed, m)

    def _apply(self, ins: dict, m: int) -> dict:
        """The stage's train-mode forward of microbatch ``m`` (its autograd
        graph kept, its BN state threaded on): the next boundary's
        tensors by name."""
        model = self.model
        seed = self._micro_seed(m)
        keys = self.stage_keys[self.stage]
        if self._plan_kind == "chain":
            lo, hi = int(keys[0]), int(keys[-1]) + 1
            x, new_state = model._run(self._leaves, self._state, ins["__x__"],
                                      train=True, seed=seed, upto=hi,
                                      start=lo)
            self._state.update(new_state)
            return {"__x__": x}
        acts, new_state = model._forward(self._leaves, self._state, [],
                                         train=True, seed=seed, preset=ins,
                                         only=set(keys))
        self._state.update(new_state)
        return {n: acts[n] for n in self._crossings[self.stage + 1]}

    def _head_score(self, x, m: int):
        lo = m * self._mb + self._replica * self._mbd
        y = self._labels[lo:lo + self._mbd]
        p = self._leaves.get(self._head_key, {})
        return self.out_layer.score(p, x.to(self.model._dtype), y, None)

    def _fwd_op(self, m: int) -> None:
        s = self.stage
        ins = self._inject(m) if s == 0 else self._recv_fwd()
        outs = self._apply(ins, m)
        if s < self.n_stages - 1:
            self._send_fwd(outs)
        self._live[m] = (ins, outs)
        self._in_flight = max(self._in_flight, len(self._live))

    def _bwd_op(self, m: int) -> None:
        s, S = self.stage, self.n_stages
        ins, outs = self._live.pop(m)
        if s == S - 1:
            loss_m = self._head_score(outs[self._head_input], m) / self.n_micro
            if loss_m.requires_grad:
                loss_m.backward()
            self._loss_acc = self._loss_acc + loss_m.detach()
        else:
            names = [n for n in self._crossings[s + 1] if _is_float(outs[n])]
            grads = [torch.empty_like(outs[n]) for n in names]
            self._link.recv(self._link.next, grads)
            ts, gs = [], []
            for n, g in zip(names, grads):
                if outs[n].requires_grad:
                    ts.append(outs[n])
                    gs.append(g)
            if ts:
                torch.autograd.backward(ts, gs)
        if s > 0:
            floats = [ins[n] for n in self._crossings[s] if _is_float(ins[n])]
            self._link.send(self._link.prev, [
                t.grad if t.grad is not None else torch.zeros_like(t)
                for t in floats])

    # --- one step ----------------------------------------------------------

    def _run_schedule(self) -> None:
        S, M, s = self.n_stages, self.n_micro, self.stage
        if self.schedule == "gpipe":
            for m in range(M):
                self._fwd_op(m)
            for m in range(M):
                self._bwd_op(m)
            return
        fwd, bwd, total = self._tables
        for t in range(total):
            mf, mb = int(fwd[s, t]), int(bwd[s, t])
            # the simulator's slot order: the head may backward the
            # microbatch it forwarded in the same slot
            if s == S - 1:
                if mf >= 0:
                    self._fwd_op(mf)
                if mb >= 0:
                    self._bwd_op(mb)
            else:
                if mb >= 0:
                    self._bwd_op(mb)
                if mf >= 0:
                    self._fwd_op(mf)

    def _regularization(self):
        """This stage's regularization score (the last stage's with the
        head's), differentiable in the leaves."""
        from deeplearning4j_tpu_torch.optimize import solver

        m = self.model
        mine = {k: self._leaves[k] for k in self._keys if k in self._leaves}
        layer_of = ((lambda key: m.conf.layers[int(key)])
                    if self._plan_kind == "chain" else m._layer_conf)
        return solver.regularization_score(mine, layer_of)

    def _step(self, it: int):
        from deeplearning4j_tpu_torch.optimize import solver

        m = self.model
        dev = m.device
        self._step_seed = m._train_seed(it)
        self._leaves = {k: {pk: v.detach().requires_grad_(
            v.is_floating_point()) for pk, v in m.params[k].items()}
            for k in self._keys if k in m.params}
        self._state = {k: m.state[k] for k in self.stage_keys[self.stage]
                       if k in m.state}
        self._live = {}
        self._in_flight = 0
        self._loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        self._link = _Link(self.mesh) if self.n_stages > 1 else None
        before = scheduler.stats()["p2p"]
        self._run_schedule()
        reg = self._regularization()
        if isinstance(reg, torch.Tensor):
            if reg.requires_grad:
                reg.backward()
            self._loss_acc = self._loss_acc + reg.detach().to(torch.float32)
        if self._link is not None:
            self._link.flush()
        grads = {k: {pk: (v.grad if v.grad is not None
                          else torch.zeros_like(v))
                     for pk, v in vp.items()}
                 for k, vp in self._leaves.items()}
        loss = self._loss_acc.reshape(1).clone()
        if self.n_stages > 1:
            scheduler.all_reduce(loss, self.mesh.pipeline_group)
        if self.data_size > 1:
            self._data_mean(loss, grads)
        if self._on_grads is not None:
            self._on_grads(grads)
        solver.apply_updates(self._solver, grads, it, m.epoch)
        for k, st in self._state.items():
            m.state[k] = st
        after = scheduler.stats()["p2p"]
        self.last_step = {
            "sends": after.get("sends", 0) - before.get("sends", 0),
            "recvs": after.get("recvs", 0) - before.get("recvs", 0),
            "bytes_sent": (after.get("bytes_sent", 0)
                           - before.get("bytes_sent", 0)),
            "handoff_ms": self._link.ms if self._link is not None else 0.0,
            "max_in_flight": self._in_flight}
        self._leaves = self._live = self._link = None
        return loss[0]

    def _data_mean(self, loss, grads) -> None:
        """The loss, this stage's gradients and its floating BN state
        averaged over the stage's data subgroup."""
        group, n = self.mesh.group, float(self.data_size)
        leaves = [loss] + scheduler.tree_leaves(grads) + [
            t for st in self._state.values() for t in st.values()
            if _is_float(t)]
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in leaves])
        scheduler.all_reduce(flat, group)
        flat /= n
        off = 0
        for t in leaves:
            k = t.numel()
            t.copy_(flat[off:off + k].view(t.shape).to(t.dtype))
            off += k

    # --- user API ----------------------------------------------------------

    def _batch(self, ds):
        if getattr(ds, "features_mask", None) is not None \
                or getattr(ds, "labels_mask", None) is not None \
                or any(x is not None for x in
                       (getattr(ds, "features_masks", None) or ())) \
                or any(x is not None for x in
                       (getattr(ds, "labels_masks", None) or ())):
            raise ValueError(
                "masked DataSets are not supported under pipeline "
                "training yet (the head's score runs unmasked)")
        if self._plan_kind == "dag":
            from deeplearning4j_tpu_torch.nn.graph import _as_multi

            mds = _as_multi(ds)
            return list(mds.features), mds.labels[0]
        return [ds.features], ds.labels

    def fit_batch(self, ds) -> float:
        """One pipelined step on a global batch (every rank feeds the same
        one); returns its loss, the same on every rank."""
        from deeplearning4j_tpu_torch.telemetry import health

        m = self.model
        feats, labels = self._batch(ds)
        rows = int(feats[0].shape[0])
        div = self.n_micro * self.data_size
        if rows % div:
            raise ValueError(
                f"batch of {rows} rows must divide into n_micro x "
                f"data_axis = {self.n_micro} x {self.data_size}")
        mb = rows // self.n_micro
        mb_shapes = tuple((mb // self.data_size,) + tuple(f.shape[1:])
                          for f in feats)
        if not self._pipe_built:
            self._build()
            self._built_mb_shapes = mb_shapes
        elif mb_shapes != self._built_mb_shapes:
            raise ValueError(
                f"pipeline compiled for microbatch shape "
                f"{self._built_mb_shapes}, got {mb_shapes}; feed equal-"
                "size batches (pad the trailing batch)")
        self._mb, self._mbd = mb, mb // self.data_size
        self._replica = self.mesh.data_rank if self.data_size > 1 else 0
        with telemetry.span(telemetry.PHASE_INGEST):
            # stage 0 reads the features, the last stage the labels
            self._feats = self._labels = None
            if self.stage == 0:
                self._feats = (m._prepare(feats) if self._is_graph
                               else [m._prepare(feats[0])])
            if self.stage == self.n_stages - 1:
                y = labels if isinstance(labels, torch.Tensor) else \
                    torch.as_tensor(np.asarray(labels))
                self._labels = y.to(device=m.device, dtype=m._dtype)
        it = m.iteration
        with telemetry.span(telemetry.PHASE_COMPUTE) as sp:
            loss = self._step(it)
            sp.set_result(loss)
        self._feats = self._labels = None
        if telemetry.enabled():
            telemetry.record_step("pipeline", rows)
            telemetry.record_pipeline_schedule(self.n_stages, self.n_micro,
                                               self.schedule)
        m.iteration += 1
        m._score = loss
        m._cast_params = None
        if health.enabled():
            # loss-only guard: a non-finite gradient reaches the summed
            # loss within the same step; no SKIP_STEP select here, so an
            # anomalous update was applied and is never reported as
            # discarded
            gvec = health.loss_guard(loss)
            health.observe_step(
                self, "pipeline", m.iteration - 1, m.epoch, loss, gvec,
                ("all",), batch=tuple(feats) + (labels,), skipped=False)
        self.score_value = float(loss)
        return self.score_value

    def fit(self, data, epochs: int = 1):
        """Train on every batch of ``data`` (a DataSetIterator, or one
        (Multi)DataSet) for ``epochs`` epochs under the flight recorder;
        every rank's model holds the trained trees after it."""
        from deeplearning4j_tpu_torch.datasets.iterators import (
            ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.telemetry import flightrec

        if not hasattr(data, "reset"):
            data = ListDataSetIterator([data])
        with flightrec.flight_recorder(model=self.model):
            for _ in range(epochs):
                for ds in data:
                    self.fit_batch(ds)
                data.reset()
                self.model.epoch += 1
        self.write_back()
        return self.model

    # --- health-layer rollback hooks ---------------------------------------

    def _health_snapshot(self):
        """Copies of this stage's params, BN state and updater state (the
        head's on the last stage)."""
        m = self.model
        clone = lambda t: scheduler.tree_map(  # noqa: E731
            lambda x: x.detach().clone(), t)
        keys = self._my_keys()
        return {"params": {k: clone(m.params[k]) for k in keys
                           if k in m.params},
                "state": {k: clone(m.state[k]) for k in keys
                          if k in m.state},
                "opt": clone(getattr(self, "_opt", {})),
                "iteration": int(m.iteration), "epoch": int(m.epoch)}

    def _health_restore(self, snap):
        m = self.model
        with torch.no_grad():
            for k, vp in snap["params"].items():
                for pk, v in vp.items():
                    m.params[k][pk].copy_(v)
        for k, st in snap["state"].items():
            m.state[k] = {n: v.clone() for n, v in st.items()}
        if self._pipe_built:
            # fresh copies: the snapshot survives repeated rollbacks
            self._opt.clear()
            self._opt.update(scheduler.tree_map(lambda x: x.clone(), snap["opt"]))
        m.iteration = snap["iteration"]
        m.epoch = snap["epoch"]

    def write_back(self):
        """Every stage's params, BN state and updater state, and the
        head's, onto every rank's wrapped model (a broadcast from each
        stage's rank over the pipeline)."""
        if not self._pipe_built:
            return
        m = self.model
        S = self.n_stages
        for s in range(S):
            keys = list(self.stage_keys[s])
            if s == S - 1:
                keys.append(self._head_key)
            keys = [k for k in keys if k in m.params]
            if s == self.stage:
                opt = {k: self._opt[k] for k in keys}
            else:
                opt = {k: {pk: scheduler.tree_map(torch.zeros_like,
                                         m._layer_updater(k)[1].init_state(v))
                           for pk, v in m.params[k].items()} for k in keys}
            trees = {"params": {k: m.params[k] for k in keys},
                     "state": {k: m.state[k] for k in keys if k in m.state},
                     "opt": opt}
            if S > 1:
                _broadcast_stage(trees, self.mesh.stage_rank(s),
                                 self.mesh.pipeline_group)
            for k in keys:
                m.opt_state[k] = opt[k]
        m._cast_params = None
