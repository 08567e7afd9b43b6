"""Expert parallelism (MoE) over a process group.

Counterpart of the JAX package's ``parallel/expert.py``. ``E`` experts
live ``E / world`` to a rank; tokens arrive sharded over the same ranks
(each rank holds its partition of the batch, the GShard layout).

``moe_apply`` holds the JAX package's semantics:

- top-1 keeps the RAW router probability as its combine gate (the router
  then learns through the task loss); top-2 renormalizes the gates over
  the chosen pair;
- top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (a stable descending sort);
- the capacity queue takes every rank-0 choice before any rank-1 choice,
  in token order, ``capacity`` slots an expert; a token dropped by
  capacity keeps only its residual;
- the aux loss is ``E * sum_e mean(prob_e) * mean(rank-0 assignment_e)``.

The JAX package dispatches and combines through dense one-hot einsums
(``[t, E, C]``). The same slots are computed here by index: positions from
the same cumulative sum over the queue, a gather of the tokens into ``[E,
C, d]``, ``bmm`` through the experts, and a gate-weighted gather back. A
one-hot weight of 1 and zeros gives what the einsum gives.

With sharded experts (``e_loc < n_experts``) the ``[E, C, d]`` buffers go
to the ranks that own their experts by an all-to-all whose backward is the
reverse all-to-all (:class:`_AllToAll`), so every rank's tokens reach an
expert's gradient. ``moe_spmd_fn`` and ``moe_train_step`` are the raw
entry points over a mesh: this rank's tokens and expert shard in, this
rank's outputs out.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.parallel.mesh import EXPERT_AXIS

# the active expert axis: set by ParallelWrapper's expert-parallel step
# around its forward and backward, read by MoELayer.forward when its
# expert weights arrive sharded
_ACTIVE_EXPERT_AXIS: list = [(None, None)]

# bytes this process sent through the all-to-all exchange, forward and
# backward, and the rows its experts ran forward (experts x capacity;
# under moe_apply_global, the kept choices), since the last reset_stats()
_STATS = {"all_to_all": 0, "bytes": 0, "expert_rows": 0}


@contextlib.contextmanager
def active_expert_axis(name: str, group=None):
    """Inside the block, a sharded ``MoELayer`` exchanges its tokens over
    ``group`` (None: the default process group) under the axis ``name``."""
    _ACTIVE_EXPERT_AXIS.append((name, group))
    try:
        yield
    finally:
        _ACTIVE_EXPERT_AXIS.pop()


def current_expert_axis():
    return _ACTIVE_EXPERT_AXIS[-1][0]


def current_expert_group():
    return _ACTIVE_EXPERT_AXIS[-1][1]


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(all_to_all=0, bytes=0, expert_rows=0)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Row ``r`` of ``x`` ``[world, ...]`` to rank ``r``; row ``r`` of the
    result from rank ``r``."""
    out = torch.empty_like(x)
    scheduler.all_to_all(out, x.contiguous(), group)
    _STATS["all_to_all"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    return out


class _AllToAll(torch.autograd.Function):
    """The exchange with a gradient: an all-to-all is its own adjoint (it
    transposes the (rank, row) blocks), so the backward sends every
    cotangent back where its row came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-to-all of ``x`` ``[world, ...]`` over ``group``."""
    return _AllToAll.apply(x, group)


def moe_init(gen, d_model: int, d_hidden: int, n_experts: int,
             dtype=torch.float32) -> dict:
    """One logical copy: router ``[d, E]`` (replicated) and the experts'
    ``w1 [E, d, h]``, ``w2 [E, h, d]``, normal with std ``1/sqrt(fan_in)``,
    drawn from ``gen`` on the CPU."""
    def normal(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32).normal_(
            0.0, 1.0, generator=gen)
        return (t / math.sqrt(fan_in)).to(dtype)

    return {"router": normal((d_model, n_experts), d_model),
            "w1": normal((n_experts, d_model, d_hidden), d_model),
            "w2": normal((n_experts, d_hidden, d_model), d_hidden)}


def route(probs: torch.Tensor, top_k: int, capacity: int):
    """``(kidx, gates, pos, keep)`` of a ``[t, E]`` router softmax: the
    top-k experts of each token (ties to the lower index), their combine
    gates, each choice's slot in its expert's queue (rank-0 choices first,
    in token order) and whether it fits in ``capacity``."""
    t, e = probs.shape
    kidx = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :top_k]           # [t, k]
    gates = probs.gather(1, kidx)
    if top_k > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = kidx.t().reshape(-1)                                # rank-major
    hot = F.one_hot(flat, e)
    pos = (hot.cumsum(0) - hot).gather(1, flat[:, None])[:, 0]
    pos = pos.view(top_k, t).t()                               # [t, k]
    return kidx, gates, pos, pos < capacity


def _experts(x, kidx, gates, pos, keep, w1, w2, b1, b2, n_experts: int,
             capacity: int, axis_name, group):
    """``y`` of ``x`` ``[t, d]``: each kept choice (expert ``kidx``, slot
    ``pos`` of ``capacity``) through its expert, scaled by its gate and
    summed over the token's choices."""
    t, d = x.shape
    top_k = kidx.shape[1]
    e_loc = w1.shape[0]
    slots = n_experts * capacity
    slot = torch.where(keep, kidx * capacity + pos, slots)     # [t, k]
    _STATS["expert_rows"] += slots

    # dispatch: slot s of expert e holds token src[e*C + s]; an empty slot
    # reads the zero row t
    src = torch.full((slots + 1,), t, dtype=torch.long, device=x.device)
    src[slot.reshape(-1)] = torch.arange(
        t, device=x.device).repeat_interleave(top_k)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    send = x_pad[src[:slots]].view(n_experts, capacity, d)

    n_shards = n_experts // e_loc
    if n_shards > 1:
        if axis_name is None:
            raise ValueError(
                f"w1 holds {e_loc}/{n_experts} experts but no mesh axis "
                "was given for the all_to_all exchange")
        # grouped by destination rank -> by source rank, my experts' rows
        recv = all_to_all(send.view(n_shards, e_loc * capacity, d), group)
        recv = recv.view(n_shards, e_loc, capacity, d).transpose(
            0, 1).reshape(e_loc, n_shards * capacity, d)
    else:
        recv = send

    h = torch.bmm(recv, w1)
    if b1 is not None:
        h = h + b1[:, None, :]
    out = torch.bmm(torch.relu(h), w2)
    if b2 is not None:
        out = out + b2[:, None, :]

    if n_shards > 1:
        out = out.view(e_loc, n_shards, capacity, d).transpose(
            0, 1).reshape(n_shards, e_loc * capacity, d)
        out = all_to_all(out, group)
    back = torch.cat([out.reshape(slots, d), out.new_zeros((1, d))])
    # combine: each kept choice's expert output scaled by its gate
    w = gates * keep.to(gates.dtype)
    return (back[slot] * w[..., None].to(back.dtype)).sum(1)


def _aux(probs, kidx, n_experts: int):
    """The load-balance aux (GShard): the rank-0 assignment only."""
    assign = F.one_hot(kidx[:, 0], n_experts).to(probs.dtype).mean(0)
    return n_experts * torch.sum(assign * probs.mean(0))


def moe_apply(router, w1, w2, x, n_experts: int, capacity: int,
              top_k: int = 1, axis_name: str | None = EXPERT_AXIS,
              b1=None, b2=None, residual: bool = True, group=None):
    """The MoE layer's math over ``x`` ``[t, d]`` (this rank's tokens):
    ``w1 [e_loc, d, h]`` / ``w2 [e_loc, h, d]`` this rank's experts
    (``e_loc == n_experts`` unsharded), ``router [d, E]`` replicated.
    Returns ``(x + y, aux)`` (``y`` alone with ``residual=False``). With
    ``e_loc < n_experts`` the buffers cross ``group`` by all-to-all;
    ``axis_name`` None refuses that."""
    probs = torch.softmax(x @ router, dim=-1)                  # [t, E]
    kidx, gates, pos, keep = route(probs, top_k, capacity)
    y = _experts(x, kidx, gates, pos, keep, w1, w2, b1, b2, n_experts,
                 capacity, axis_name, group)
    return (x + y if residual else y), _aux(probs, kidx, n_experts)


def moe_apply_global(router, w1, w2, x, n_experts: int,
                     capacity_factor: float, top_k: int, gather,
                     b1=None, b2=None, residual: bool = True):
    """:func:`moe_apply` with unsharded experts over this rank's ``x`` ``[t,
    d]`` when the routing is the global batch's (the data-parallel exact
    mode). ``gather(probs)`` -> ``(every rank's [T, E] router softmax,
    this rank's first row in it)``, differentiable
    (``comms.global_batch.gather_rows``). The top-k, the capacity (sized
    from ``T``), the queue and the aux are the global batch's; then each
    expert runs over exactly this rank's choices it kept (grouped by
    expert, one host read of the ``E`` counts a call), so a rank's expert
    work is its own tokens'. Returns ``(x + y, aux)`` for this rank's
    rows, ``aux`` the global batch's."""
    t, d = x.shape
    probs = torch.softmax(x @ router, dim=-1)                  # [t, E]
    every, lo = gather(probs)                                  # [T, E]
    capacity = max(1, math.ceil(
        top_k * every.shape[0] / n_experts * capacity_factor))
    kidx, gates, _, keep = route(every, top_k, capacity)
    aux = _aux(every, kidx, n_experts)
    # this rank's kept choices, choice-major (choice j of token i at j*t+i),
    # grouped by expert
    flat = kidx[lo:lo + t].t().reshape(-1)
    kept = keep[lo:lo + t].t().reshape(-1).nonzero()[:, 0]
    order = kept[torch.argsort(flat[kept], stable=True)]
    counts = torch.bincount(flat[order], minlength=n_experts).tolist()
    _STATS["expert_rows"] += len(order)
    rows = x[order % t]
    outs = []
    for e, chunk in enumerate(rows.split(counts)):
        h = chunk @ w1[e]
        if b1 is not None:
            h = h + b1[e]
        out = torch.relu(h) @ w2[e]
        if b2 is not None:
            out = out + b2[e]
        outs.append(out)
    gate = gates[lo:lo + t].t().reshape(-1)[order]
    out = torch.cat(outs) * gate[:, None].to(x.dtype)
    # back to (choice, token), summed over the choices as moe_apply does
    y = x.new_zeros((top_k * t, d)).index_put((order,), out)
    y = y.view(top_k, t, d).sum(0)
    return (x + y if residual else y), aux


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's share of ``moe_init``'s params: the router whole, the
    experts' leading axis cut into ``mesh.data`` blocks."""
    e = params["w1"].shape[0]
    if e % mesh.data:
        raise ValueError(f"{e} experts do not split over {mesh.data} ranks")
    n = e // mesh.data
    lo = mesh.data_rank * n
    return {k: (v if k == "router" else v[lo:lo + n]).detach().clone()
            for k, v in params.items()}


def _moe_local(params, x, n_experts, capacity, top_k, group):
    return moe_apply(params["router"], params["w1"], params["w2"], x,
                     n_experts, capacity, top_k=top_k, group=group)


def moe_spmd_fn(n_experts: int, capacity: int, mesh, top_k: int = 1):
    """-> ``(params, x) -> (y, aux)`` on this rank: ``params`` from
    :func:`shard_moe_params`, ``x`` this rank's ``[T / world, d]`` tokens;
    ``aux`` is the mean over the ranks (the JAX package's ``pmean``)."""
    def fn(params, x):
        y, aux = _moe_local(params, x, n_experts, capacity, top_k,
                            mesh.group)
        aux = aux.detach().reshape(1).clone()
        scheduler.all_reduce(aux, mesh.group)
        return y, aux[0] / mesh.data

    return fn


def moe_train_step(n_experts: int, capacity: int, mesh, lr: float = 0.05,
                   aux_weight: float = 1e-2, top_k: int = 1):
    """-> ``(params, x, target) -> (params, loss)`` on this rank: the mean
    over the ranks of MSE + ``aux_weight`` * aux, one SGD step. Each
    rank's backward runs from its loss over ``world`` (the ranks' mean),
    so the expert shards collect every rank's share through the
    all-to-all's backward; the replicated router's gradient is summed over
    the ranks."""
    def step(params, x, target):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y, aux = _moe_local(leaves, x, n_experts, capacity, top_k,
                            mesh.group)
        loss = (torch.mean((y - target) ** 2) + aux_weight * aux) / mesh.data
        loss.backward()
        g = {k: v.grad for k, v in leaves.items()}
        scheduler.all_reduce(g["router"], mesh.group)
        total = loss.detach().reshape(1).clone()
        scheduler.all_reduce(total, mesh.group)
        with torch.no_grad():
            new = {k: params[k] - lr * g[k] for k in params}
        return new, total[0]

    return step
