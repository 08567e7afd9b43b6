"""Process group / topology for data-parallel training.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package
names mesh axes over the devices of one program; the port runs one
process per rank (the PyTorch idiom) joined by ``torch.distributed``, and
a :class:`Mesh` here is the data axis of that process group: its size is
the world size, and each process holds one replica. The other axes
(``model``, ``pipeline``, ``sequence``, ``expert``) are refused until
``parallel/{tensor, expert, pipeline}.py`` are ported (ROADMAP A: "The
remainder, in dependency order").

Backends: NCCL when the model lives on a CUDA device, gloo on the CPU, and
gloo on CUDA tensors only when the caller names ``backend="gloo"``
(:func:`initialize_distributed`).

Batches follow the JAX package's multi-process contract: rank ``r`` of a
global batch of ``B`` rows holds rows ``[r*s, (r+1)*s)`` with
``s = ceil(B / workers)``; a short partition is zero-padded to ``s`` rows
(:func:`pad_leading`) and its padding rows carry a zero label mask
(:func:`shard_valid_counts` gives each rank's valid rows).
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
    """The data axis of a process group: ``shape[DATA_AXIS]`` ranks, this
    process at ``rank``. ``group`` None is the default group (or, with no
    process group initialized, a one-rank mesh whose collectives are the
    identity)."""

    world: int
    rank: int
    group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world, MODEL_AXIS: 1, PIPELINE_AXIS: 1,
                SEQUENCE_AXIS: 1, EXPERT_AXIS: 1}

    @property
    def backend(self) -> tp.Optional[str]:
        import torch.distributed as dist

        if not dist.is_initialized():
            return None
        return str(dist.get_backend(self.group)).lower()


@dataclasses.dataclass
class MeshConfig:
    """Declarative mesh shape (the JAX package's). ``data=-1`` takes the
    whole process group; every other axis must be 1 until its item is
    ported."""

    data: int = -1
    model: int = 1
    pipeline: int = 1
    sequence: int = 1
    expert: int = 1

    def build(self) -> Mesh:
        for name in (MODEL_AXIS, PIPELINE_AXIS, SEQUENCE_AXIS, EXPERT_AXIS):
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"mesh axis {name!r} = {getattr(self, name)}: only the "
                    f"data axis is ported; tensor, pipeline, sequence and "
                    f"expert parallelism wait for parallel/{{tensor, expert, "
                    f"pipeline}}.py (ROADMAP A: 'The remainder, in "
                    f"dependency order')")
        world = scheduler.world_of()
        if self.data not in (-1, world):
            raise ValueError(f"mesh data axis {self.data} must equal the "
                             f"process group's world size {world} (one "
                             f"replica a process)")
        return Mesh(world, scheduler.rank_of())


def single_host_mesh(n_devices: tp.Optional[int] = None, **axes) -> Mesh:
    """The data axis over the whole process group (``n_devices``, when
    given, must equal its world size)."""
    return MeshConfig(data=-1 if n_devices is None else int(n_devices),
                      **axes).build()


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
    lo, hi, s = partition_rows(rows, mesh.rank, mesh.world)
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
