"""Process grid / topology for data-, tensor- and sequence-parallel
training.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package
names mesh axes over the devices of one program; the port runs one process
per rank (the PyTorch idiom) joined by ``torch.distributed``, and a
:class:`Mesh` here is a grid of those processes: ``data`` x ``model`` x
``pipeline`` x ``sequence`` ranks, ordered as the JAX package's device
mesh orders its devices (``sequence`` fastest, then ``pipeline``, then
``model``, then ``data``: rank ``((d * model + m) * pipeline + p) *
sequence + s``). Each axis has one ``torch.distributed`` subgroup for
every slice of the grid along it (:meth:`MeshConfig.build` creates them
all, in one fixed order, on every rank); a mesh of the data axis alone
keeps the default group. A pipeline rank is one stage of
``parallel.pipeline.PipelineParallelWrapper``: :attr:`Mesh.stage`, and the
previous and next stages' ranks :attr:`Mesh.prev_stage` /
:attr:`Mesh.next_stage`. Experts ride the data axis
(``ParallelWrapper(expert_parallel=True)``, ``parallel/expert.py``), as
in the JAX package's GShard layout, so an ``expert`` axis of its own is
refused.

Backends: NCCL when the model lives on a CUDA device, gloo on the CPU, and
gloo on CUDA tensors only when the caller names ``backend="gloo"``
(:func:`initialize_distributed`); the subgroups take the world's backend.

Batches follow the JAX package's multi-process contract over the data axis
only: data index ``r`` of a global batch of ``B`` rows holds rows
``[r*s, (r+1)*s)`` with ``s = ceil(B / workers)`` (``workers`` = the data
axis's size), and ranks that share a data index read the same rows; a
short partition is zero-padded to ``s`` rows (:func:`pad_leading`) and its
padding rows carry a zero label mask (:func:`shard_valid_counts` gives each
data index's valid rows).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import typing as tp

import numpy as np
import torch

from deeplearning4j_tpu_torch.comms import scheduler

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPELINE_AXIS = "pipeline"
SEQUENCE_AXIS = "sequence"
EXPERT_AXIS = "expert"

ALL_AXES = (DATA_AXIS, MODEL_AXIS, PIPELINE_AXIS, SEQUENCE_AXIS, EXPERT_AXIS)

# seconds a collective may wait before the process group raises
DEFAULT_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: ``data`` ranks on the data axis (this process at
    data index ``data_rank``, its data subgroup ``group``), ``model`` on the
    model axis, ``pipeline`` on the pipeline axis and ``sequence`` on the
    sequence axis, each with this process's index and subgroup. ``group``
    None is the default group (or, with no process group initialized, a
    one-rank mesh whose collectives are the identity); a mesh with model,
    pipeline or sequence ranks always has subgroups."""

    data: int
    data_rank: int
    group: object = None
    model: int = 1
    sequence: int = 1
    model_rank: int = 0
    sequence_rank: int = 0
    model_group: object = None
    sequence_group: object = None
    pipeline: int = 1
    pipeline_rank: int = 0
    pipeline_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                PIPELINE_AXIS: self.pipeline, SEQUENCE_AXIS: self.sequence,
                EXPERT_AXIS: 1}

    @property
    def axis_names(self) -> tuple:
        return ALL_AXES

    def index(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return {DATA_AXIS: self.data_rank, MODEL_AXIS: self.model_rank,
                PIPELINE_AXIS: self.pipeline_rank,
                SEQUENCE_AXIS: self.sequence_rank}.get(axis, 0)

    def axis_group(self, axis: str):
        """The subgroup of this process's slice along ``axis`` (None on a
        mesh of the data axis alone: the default group for ``data``, and
        for the others, of size 1, no group at all: their collectives are
        skipped)."""
        return {DATA_AXIS: self.group, MODEL_AXIS: self.model_group,
                PIPELINE_AXIS: self.pipeline_group,
                SEQUENCE_AXIS: self.sequence_group}[axis]

    def coords(self, rank: int) -> dict:
        """The grid coordinates of process ``rank`` (the default group's
        numbering); ``pipeline`` only on a mesh with pipeline ranks."""
        s = rank % self.sequence
        p = (rank // self.sequence) % self.pipeline
        m = (rank // (self.sequence * self.pipeline)) % self.model
        d = rank // (self.sequence * self.pipeline * self.model)
        out = {DATA_AXIS: d, MODEL_AXIS: m, SEQUENCE_AXIS: s}
        if self.pipeline > 1:
            out[PIPELINE_AXIS] = p
        return out

    def rank_at(self, data: int = 0, model: int = 0, sequence: int = 0,
                pipeline: int = 0):
        """The process at these grid coordinates."""
        return (((data * self.model + model) * self.pipeline + pipeline)
                * self.sequence + sequence)

    @property
    def stage(self) -> int:
        """This process's pipeline stage."""
        return self.pipeline_rank

    def stage_rank(self, stage: int) -> int:
        """The process of pipeline stage ``stage`` in this process's
        pipeline (its data, model and sequence coordinates)."""
        return self.rank_at(self.data_rank, self.model_rank,
                            self.sequence_rank, stage)

    @property
    def prev_stage(self):
        """The previous stage's process (None on stage 0)."""
        return (self.stage_rank(self.stage - 1) if self.stage > 0
                else None)

    @property
    def next_stage(self):
        """The next stage's process (None on the last stage)."""
        return (self.stage_rank(self.stage + 1)
                if self.stage < self.pipeline - 1 else None)

    @property
    def backend(self) -> tp.Optional[str]:
        import torch.distributed as dist

        if not dist.is_initialized():
            return None
        return str(dist.get_backend(self.group)).lower()


def _axis_slices(data: int, model: int, sequence: int, pipeline: int = 1):
    """For each axis, the rank lists of every slice along it (the grid's
    row-major order: sequence fastest); the pipeline axis only where it
    has ranks."""
    def at(d, m, p, s):
        return ((d * model + m) * pipeline + p) * sequence + s

    grid = [(d, m, p, s) for d in range(data) for m in range(model)
            for p in range(pipeline) for s in range(sequence)]

    def slices(axis: int):
        out = {}
        for c in grid:
            key = c[:axis] + c[axis + 1:]
            out.setdefault(key, []).append(at(*c))
        return list(out.values())

    out = {DATA_AXIS: slices(0), MODEL_AXIS: slices(1)}
    if pipeline > 1:
        out[PIPELINE_AXIS] = slices(2)
    out[SEQUENCE_AXIS] = slices(3)
    return out


@dataclasses.dataclass
class MeshConfig:
    """Declarative mesh shape (the JAX package's). ``data=-1`` takes the
    ranks the other axes leave; ``data * model * pipeline * sequence`` must
    be the process group's world size. ``expert`` must be 1."""

    data: int = -1
    model: int = 1
    pipeline: int = 1
    sequence: int = 1
    expert: int = 1

    def build(self) -> Mesh:
        if self.expert != 1:
            raise NotImplementedError(
                f"mesh axis 'expert' = {self.expert}: experts ride the data "
                f"axis (ParallelWrapper(expert_parallel=True)), as in the "
                f"JAX package's GShard layout")
        world = scheduler.world_of()
        fixed = int(self.model) * int(self.pipeline) * int(self.sequence)
        if min(int(self.model), int(self.pipeline), int(self.sequence)) < 1:
            raise ValueError(f"mesh axes model={self.model}, pipeline="
                             f"{self.pipeline}, sequence={self.sequence} "
                             f"must be >= 1")
        if self.data == -1:
            if world % fixed:
                raise ValueError(f"{world} ranks not divisible by model*"
                                 f"pipeline*sequence={fixed}")
            data = world // fixed
        else:
            data = int(self.data)
        if data * fixed != world:
            if fixed == 1:
                raise ValueError(f"mesh data axis {self.data} must equal the "
                                 f"process group's world size {world} (one "
                                 f"replica a process)")
            raise ValueError(f"mesh {data} x {self.model} x {self.pipeline} "
                             f"x {self.sequence} needs {data * fixed} ranks, "
                             f"the process group has {world}")
        rank = scheduler.rank_of()
        if fixed == 1:
            return Mesh(world, rank)
        import torch.distributed as dist

        model, pipe, seq = int(self.model), int(self.pipeline), \
            int(self.sequence)
        groups = {}
        for axis, slices in _axis_slices(data, model, seq, pipe).items():
            # every rank creates every subgroup, in this order
            groups[axis], _ = dist.new_subgroups_by_enumeration(slices)
        s = rank % seq
        p = (rank // seq) % pipe
        m = (rank // (seq * pipe)) % model
        return Mesh(data, rank // fixed, groups[DATA_AXIS], model, seq, m, s,
                    groups[MODEL_AXIS], groups[SEQUENCE_AXIS], pipe, p,
                    groups.get(PIPELINE_AXIS))


def single_host_mesh(n_devices: tp.Optional[int] = None, **axes) -> Mesh:
    """The grid over the whole process group: ``axes`` as
    :class:`MeshConfig` takes them (``n_devices``, when given, must equal
    the world size; with no other axis it is the data axis)."""
    if n_devices is not None and axes:
        world = scheduler.world_of()
        if int(n_devices) != world:
            raise ValueError(f"n_devices={n_devices} must equal the process "
                             f"group's world size {world}")
        return MeshConfig(**axes).build()
    if "data" not in axes:
        axes["data"] = -1 if n_devices is None else int(n_devices)
    return MeshConfig(**axes).build()


def device_count(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]


def initialize_distributed(coordinator_address: tp.Optional[str] = None,
                           num_processes: tp.Optional[int] = None,
                           process_id: tp.Optional[int] = None,
                           backend: tp.Optional[str] = None,
                           device="cuda",
                           timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """Join the process group: ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``, or the usual environment
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as
    ``torchrun`` sets them) for any left None. ``backend`` defaults to
    NCCL for a CUDA ``device`` and gloo for the CPU; a collective that
    waits longer than ``timeout`` seconds raises. With NCCL the process
    takes the card ``LOCAL_RANK`` (else ``process_id`` modulo the card
    count). One small all-reduce runs before returning, so a backend that
    cannot start raises here. Returns the data-axis :class:`Mesh`."""
    import torch.distributed as dist

    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout)))
    probe = torch.ones(1, device=(torch.device("cuda")
                                  if backend == "nccl" else device))
    dist.all_reduce(probe)
    if float(probe) != world:
        raise RuntimeError(f"{backend} all-reduce over {world} ranks gave "
                           f"{float(probe)}")
    return single_host_mesh()


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

def shard_valid_counts(rows: int, workers: int) -> np.ndarray:
    """Valid (non-padded) row count per shard after ``pad_leading`` to
    ``ceil(rows/workers)*workers`` and an even split: shard i holds rows
    [i*s, (i+1)*s)."""
    s = -(-rows // workers)
    return np.clip(rows - np.arange(workers) * s, 0, s).astype(np.float32)


def _pad_rows(x, target: int):
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.shape[0] == target:
            return x
        pad = np.zeros((target - x.shape[0],) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad])
    if x.shape[0] == target:
        return x
    out = x.new_zeros((target,) + tuple(x.shape[1:]))
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        out = out.contiguous(memory_format=torch.channels_last)
    out[:x.shape[0]].copy_(x)
    return out


def pad_leading(tree, target: int):
    """Zero-pad every leaf's leading (batch) dim to ``target`` rows
    (tensors keep their device, dtype and memory format; None stays
    None)."""
    return scheduler.tree_map(lambda x: _pad_rows(x, target), tree)


def partition_rows(rows: int, rank: int, workers: int):
    """``(lo, hi, s)``: rank ``rank``'s rows ``[lo, hi)`` of a global batch
    of ``rows``, and the per-rank size ``s`` its partition pads to."""
    s = -(-rows // workers)
    lo = min(rank * s, rows)
    return lo, min(lo + s, rows), s


def shard_batch(mesh: Mesh, batch):
    """This rank's partition of a GLOBAL batch tree (every leaf's leading
    axis), zero-padded to ``ceil(B / workers)`` rows: what each rank feeds
    ``ParallelWrapper.fit`` when every process holds the whole batch."""
    rows = int(np.shape(scheduler.tree_leaves(batch)[0])[0])
    lo, hi, s = partition_rows(rows, mesh.data_rank, mesh.data)
    return pad_leading(scheduler.tree_map(lambda x: x[lo:hi], batch), s)


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every rank's tensors (a broadcast, in place);
    returns ``tree``."""
    for t in scheduler.tree_leaves(tree):
        scheduler.broadcast(t, 0, mesh.group)
    return tree


def host_gather(tree):
    """Tensor tree -> host numpy tree (bfloat16 as float32)."""
    def pull(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
        return np.asarray(t)

    return scheduler.tree_map(pull, tree)
