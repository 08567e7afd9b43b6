"""Ring attention: sequence (context) parallelism over a mesh of ranks.

Counterpart of the JAX package's ``ops/ring.py``: the time axis is cut over
the mesh's ``sequence`` axis and the key / value blocks (with the key
mask) rotate one hop a step around the ring, each rank folding every block
into an online softmax as FlashAttention does across key blocks (the
blockwise-parallel / RingAttention construction, PAPERS.md). The port runs
one process per rank: a hop is a point-to-point send to the next rank and a
receive from the previous one over the ``sequence`` subgroup
(``torch.distributed``; gloo moves CUDA tensors through the host). The
rotation's backward is its own ``torch.autograd.Function``: the cotangents
of the rotated K / V travel the other way round.

``ring_attention_local`` is the per-rank body on this rank's ``[B, H, Tl,
D]`` slices; ``ring_attention`` takes the whole ``[B, H, T, D]`` arrays on
every rank of the axis, cuts them, runs the ring and gathers the output
(its gradients are the whole arrays' on every rank).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _peer(group, index: int) -> int:
    """The default group's rank of ``group``'s rank ``index``."""
    if group is None:
        return index
    import torch.distributed as dist

    return dist.get_global_rank(group, index)


def _shift(x: torch.Tensor, group, size: int, index: int,
           step: int) -> torch.Tensor:
    """``x`` sent ``step`` hops round the ring (to ``index + step``), the
    block of ``index - step`` received."""
    from deeplearning4j_tpu_torch.comms import scheduler

    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    scheduler.p2p([(_peer(group, (index + step) % size), x.contiguous())],
                  [(_peer(group, (index - step) % size), out)], group)
    return out


class _Rotate(torch.autograd.Function):
    """One hop forward round the ring; the cotangent one hop back."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size, ctx.index = group, size, index
        return _shift(x, group, size, index, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, ctx.size, ctx.index, -1), None, None, None


def ring_attention_local(q, k, v, key_mask, group, axis_size: int,
                         axis_index: int, causal: bool = False,
                         scale: Optional[float] = None):
    """Per-rank ring attention body. ``q, k, v: [B, H, Tl, D]`` hold this
    rank's slice of the time axis (rank ``axis_index`` of ``axis_size`` on
    the ``group`` ring); ``key_mask: [B, Tl]`` (may be None). Returns the
    local ``[B, H, Tl, D]`` output, computed in float32."""
    b, h, tl, d = q.shape
    sm = (1.0 / math.sqrt(d)) if scale is None else scale
    if key_mask is None:
        key_mask = torch.ones((b, tl), dtype=q.dtype, device=q.device)
    km = key_mask.to(q.dtype)
    q32 = q.float()
    tloc = torch.arange(tl, device=q.device)
    acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    kr, vr, kmr = k, v, km
    # axis_size steps: K / V / mask rotate one hop a step, so every rank
    # sees every key block exactly once
    for step in range(axis_size):
        owner = (axis_index - step) % axis_size  # whose block this is
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kr.float()) * sm
        s = s.masked_fill(~(kmr[:, None, None, :] > 0), NEG_INF)
        if causal:
            qpos = axis_index * tl + tloc  # global positions
            kpos = owner * tl + tloc
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vr.float())
        m = m_new
        if step != axis_size - 1:
            kr = _Rotate.apply(kr, group, axis_size, axis_index)
            vr = _Rotate.apply(vr, group, axis_size, axis_index)
            kmr = _shift(kmr, group, axis_size, axis_index, 1)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, key_mask=None, axis_name: str = "sequence",
                   causal: bool = False, scale: Optional[float] = None):
    """Whole-array entry point: ``[B, H, T, D]`` (the same on every rank of
    the axis) cut on T over ``mesh``'s ``axis_name`` ranks, the ring run,
    the output gathered. T must divide evenly."""
    from deeplearning4j_tpu_torch.parallel import tensor

    n = int(mesh.shape[axis_name])
    if q.shape[2] % n:
        raise ValueError(f"time axis {q.shape[2]} not divisible by "
                         f"{axis_name} axis size {n}")
    if key_mask is None:
        key_mask = torch.ones((q.shape[0], k.shape[2]), dtype=q.dtype,
                              device=q.device)
    if n == 1:
        return ring_attention_local(q, k, v, key_mask, None, 1, 0, causal,
                                    scale)
    group, index = mesh.axis_group(axis_name), mesh.index(axis_name)
    ql, kl, vl = (tensor.scatter_to(t, group, n, index, 2) for t in (q, k, v))
    tl = q.shape[2] // n
    kml = key_mask[:, index * tl:(index + 1) * tl].contiguous()
    o = ring_attention_local(ql, kl, vl, kml, group, n, index, causal, scale)
    return tensor.gather_from(o, group, n, index, 2)


__all__ = ["NEG_INF", "ring_attention", "ring_attention_local"]
