"""The global batch of exact data-parallel training.

The JAX package's exact SHARED_GRADIENTS mode jits the model's own train
step over the whole (padded) global batch with the batch sharded over the
mesh, so XLA keeps the global batch's math: the loss's mean runs over
every rank's rows and train-mode batch-norm statistics are taken over
every rank's rows, zero-padding rows included. The port runs one process
per rank, each holding its partition, so a train-mode forward inside
:func:`global_batch` takes the same global quantities through
collectives:

- batch-norm moments: every rank's ``E[x]`` and ``E[x^2]`` weighted by its
  share of the rows (``local_rows / global_rows``) and summed
  (:func:`batch_moments`), or the ``matmul_stats`` kernel's column sums
  ``s``, ``q`` summed with the row count scaled to the global batch
  (:func:`global_sums`);
- a loss's masked mean: this rank's mean weighted by its share of the
  mask (:func:`loss_share`); summed over the ranks it is the global mean;
- regularization: counted by rank 0 only (:func:`adds_regularization`),
  so the summed score and gradients count it once.
- an MoE layer's routing: its router probabilities gathered from every rank
  (:func:`gather_rows`), so the router's top-k, the capacity queue and the
  auxiliary loss see the global batch; each rank runs its own tokens
  through the experts and adds ``1 / world`` of the auxiliary loss
  (:func:`world_share`).

Each sum is an all-reduce whose backward is an all-reduce of the
cotangent (:func:`all_reduce_sum`), since every rank's loss depends on
every rank's statistics. At one rank every sum is the identity:
:func:`global_batch` then sets nothing, and the forward and backward are
``fit``'s own, with no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.comms import scheduler


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """The group, this rank, and the padded row counts of one step."""

    group: object
    rank: int
    world: int
    local_rows: int
    global_rows: int

    @property
    def row_share(self) -> float:
        return self.local_rows / self.global_rows


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "global_batch", default=None)


@contextlib.contextmanager
def global_batch(group, local_rows: int, global_rows: int):
    """Run a train-mode forward (and its backward) over the global batch:
    ``local_rows`` is this rank's padded partition, ``global_rows`` every
    rank's together."""
    world = scheduler.world_of(group)
    if world == 1:
        yield
        return
    token = _ACTIVE.set(GlobalBatch(
        group, scheduler.rank_of(group), world, int(local_rows),
        int(global_rows)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[GlobalBatch]:
    return _ACTIVE.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the cotangent is summed the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        scheduler.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        scheduler.all_reduce(g, ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group."""
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, rank-major; the cotangent of this rank's rows is
    the sum of every rank's cotangent for them."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        out = x.new_empty((world,) + tuple(x.shape))
        scheduler.all_gather(out, x.contiguous().view(-1), group)
        return out.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        scheduler.all_reduce(g, ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def gather_rows(x: torch.Tensor):
    """``(rows of every rank, this rank's first row in them)`` inside
    :func:`global_batch` (every rank holds the same number of rows), else
    ``(x, 0)``; differentiable."""
    gb = active()
    if gb is None:
        return x, 0
    return (_GatherRows.apply(x, gb.group, gb.world, gb.rank),
            gb.rank * x.shape[0])


def batch_moments(x32: torch.Tensor, axes):
    """``(E[x], E[x^2])`` per channel of a train-mode batch norm: over the
    global batch inside :func:`global_batch`, else over this tensor."""
    mean, ex2 = x32.mean(dim=axes), (x32 * x32).mean(dim=axes)
    gb = active()
    if gb is None:
        return mean, ex2
    both = all_reduce_sum(torch.stack([mean, ex2]) * gb.row_share,
                          gb.group)
    return both[0], both[1]


def global_sums(s: torch.Tensor, q: torch.Tensor, m: int):
    """Column sums ``s``, ``q`` over ``m`` rows -> the same over the
    global batch, and its row count."""
    gb = active()
    if gb is None:
        return s, q, m
    both = all_reduce_sum(torch.stack([s, q]), gb.group)
    return both[0], both[1], m // gb.local_rows * gb.global_rows


def loss_share(local: torch.Tensor, denom) -> torch.Tensor:
    """A masked mean ``local`` over ``denom`` positions -> this rank's
    share of the global mean (``local * denom / sum of denoms``)."""
    gb = active()
    if gb is None:
        return local
    if isinstance(denom, torch.Tensor):
        den = denom.detach().to(local.dtype).reshape(1).clone()
    else:  # filled on the device: a host scalar copied there would sync
        den = local.new_full((1,), float(denom))
    tot = den.clone()
    scheduler.all_reduce(tot, gb.group)
    return local * (den / torch.clamp(tot, min=1.0))[0]


def global_total(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks inside
    :func:`global_batch` (a loss over the whole batch, such as the
    F-measure's counts), else ``x``."""
    gb = active()
    return x if gb is None else all_reduce_sum(x, gb.group)


def world_share() -> float:
    """1 / world inside :func:`global_batch`, else 1: the share of a loss
    that every rank computes over the global batch."""
    gb = active()
    return 1.0 if gb is None else 1.0 / gb.world


def adds_regularization() -> bool:
    """Whether this rank adds the regularization score (rank 0 only
    inside :func:`global_batch`)."""
    gb = active()
    return gb is None or gb.rank == 0
