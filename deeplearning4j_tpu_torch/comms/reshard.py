"""Cross-mesh resharding by slice intersection (arXiv:2112.01075).

Counterpart of the JAX package's ``comms/reshard.py``. A tensor placed on
a mesh of ranks under a ``PartitionSpec`` (a :class:`Placement`: each rank
holds the index box its grid coordinates select) moves to another
placement, on another mesh shape over the same processes, in the paper's
three phases: **per-rank slice intersection** (each target box is
intersected with the source boxes that cover it), **minimal exchange**
(only the intersecting blocks move, point to point, and a block the target
rank already holds moves nothing; a replicated source box is sent by the
target itself where it holds a copy, else by its lowest holder) and
**reassembly** (the blocks written into the target box). The moves run
through ``scheduler.p2p``: gloo moves CUDA tensors through the host
(``scheduler.stats()["host_staged"]``); NCCL moves them on the card.

Consumers:

- **restore across mesh shapes**: :func:`reshard_training_state` hands a
  live ``ParallelWrapper``'s training state (params, layer state, updater
  state; a plan's slices or ZeRO's flat slices) to a wrapper on another
  mesh shape, bit for bit what the host route (``sync_model``, then the
  destination's set-up) gives; :func:`recut_flat` re-cuts a flat vector
  between layouts of different slice counts, each rank keeping only its
  slice (the port's pod restore builds whole vectors by host
  concatenation, so it does not call it);
- **train -> serve**: :func:`publish_to_engine` gathers a live wrapper's
  params once and publishes them into a running ``InferenceEngine``.

Without a process group every placement holds the whole tensor and each
move is a local copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.comms import scheduler


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and a spec (a ``PartitionSpec`` on the tensor's storage
    layout): where each rank's block of a tensor lies."""

    mesh: object
    spec: tuple = ()

    def box(self, shape, rank: int) -> Tuple[Tuple[int, int], ...]:
        """Process ``rank``'s ``(lo, hi)`` on every dim of a tensor of
        ``shape``."""
        if self.mesh is None or not any(e is not None for e in self.spec):
            return tuple((0, int(n)) for n in shape)
        coords = self.mesh.coords(rank)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            if entry is None:
                out.append((0, int(n)))
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            parts, idx = 1, 0
            for ax in axes:
                size = int(self.mesh.shape[ax])
                idx, parts = idx * size + coords.get(ax, 0), parts * size
            step = int(n) // parts
            out.append((idx * step, (idx + 1) * step))
        return tuple(out)


REPLICATED = Placement(None, ())


def _intersect(a, b):
    box = tuple((max(lo, lo2), min(hi, hi2))
                for (lo, hi), (lo2, hi2) in zip(a, b))
    return None if any(lo >= hi for lo, hi in box) else box


def _rel(box, origin):
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in zip(box, origin))


def _plan_leaf(shape, src: Placement, dst: Placement, world: int, me: int):
    """This rank's part of one leaf's move: ``(sends, recvs, locals)``
    with sends ``(dst rank, my source-block slices)``, recvs ``(src rank,
    box in my target block)`` and local copies ``(my source-block slices,
    box in my target block)``."""
    src_boxes = [src.box(shape, r) for r in range(world)]
    dst_boxes = [dst.box(shape, r) for r in range(world)]
    holders: Dict[tuple, List[int]] = {}
    for r, b in enumerate(src_boxes):
        holders.setdefault(b, []).append(r)
    sends, recvs, local = [], [], []
    for d in range(world):
        for b in sorted(holders):
            inter = _intersect(b, dst_boxes[d])
            if inter is None:
                continue
            owners = holders[b]
            sender = d if d in owners else owners[0]
            if sender == me and d == me:
                local.append((_rel(inter, b), _rel(inter, dst_boxes[d])))
            elif sender == me:
                sends.append((d, _rel(inter, b)))
            elif d == me:
                recvs.append((sender, _rel(inter, dst_boxes[d]),
                              tuple(hi - lo for lo, hi in inter)))
    return sends, recvs, local


def _reshard_leaves(leaves, shapes, sources, targets, group=None):
    """Move every leaf (this rank's block under its source placement, of
    the whole ``shapes``) to this rank's block under its target placement,
    in one batched exchange. Returns the new blocks (fresh tensors)."""
    world = scheduler.world_of(group)
    me = scheduler.rank_of(group)
    outs, sends, recvs = [], [], []
    for x, shape, src, dst in zip(leaves, shapes, sources, targets):
        box = dst.box(shape, me) if world > 1 else tuple(
            (0, int(n)) for n in shape)
        out = x.new_empty(tuple(hi - lo for lo, hi in box))
        if world == 1:
            out.copy_(x.reshape(out.shape))
            outs.append(out)
            continue
        s, r, local = _plan_leaf(shape, src, dst, world, me)
        for cut, into in local:
            out[into].copy_(x[cut])
        sends.extend((d, x[cut]) for d, cut in s)
        for src_rank, into, block in r:
            buf = x.new_empty(block)
            recvs.append((src_rank, buf, out, into))
        outs.append(out)
    scheduler.p2p(sends, [(s, buf) for s, buf, _, _ in recvs], group)
    for _, buf, out, into in recvs:
        out[into].copy_(buf)
    return outs


def _flat(tree):
    return scheduler.tree_leaves(tree)


def reshard(tree, sharding, source=None, shapes=None):
    """Recommit ``tree`` (this rank's blocks under ``source``, a placement
    or a matching tree of them; None: every rank holds the whole tensors)
    under ``sharding`` (a placement or a matching tree of them) by slice
    intersection. ``shapes``: the whole shapes (a matching tree of
    ``Leaf`` or shapes), needed where the source blocks are not whole."""
    leaves = _flat(tree)
    n = len(leaves)

    def spread(p):
        if p is None:
            return [REPLICATED] * n
        if isinstance(p, Placement):
            return [p] * n
        return scheduler.tree_leaves(p)

    srcs, dsts = spread(source), spread(sharding)
    if shapes is None:
        full = [tuple(t.shape) for t in leaves]
    else:
        full = [tuple(getattr(s, "shape", s)) for s in _shape_leaves(shapes)]
    outs = _reshard_leaves(leaves, full, srcs, dsts)
    return scheduler.tree_unflatten(scheduler.tree_flatten(tree)[1], outs)


def _shape_leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _shape_leaves(tree[k])]
    return [tree]


def recut_flat(x, logical_size: int, target_padded: int, group=None,
               n_src: Optional[int] = None, like: torch.Tensor = None):
    """Re-cut one flat vector between layouts of different slice counts:
    ``[0, logical_size)`` kept, the target's pad tail zero. ``x``: the
    source slices this rank holds, ``{slice index: 1-D tensor}`` of
    ``n_src`` equal slices of ``ceil(logical_size / n_src)`` elements
    (slice ``h`` held by rank ``h % world``; ``like`` gives the dtype and
    device where this rank holds none), or one tensor, slice ``rank`` of
    ``world``. Returns this rank's slice of the target layout
    (``target_padded / world`` elements). Without a group (or at one rank)
    the whole re-cut vector."""
    world = scheduler.world_of(group)
    me = scheduler.rank_of(group)
    if not isinstance(x, dict):
        n_src = world if n_src is None else n_src
        m_src = int(x.shape[0])
        x = {me: x}
    else:
        n_src = int(n_src if n_src is not None else len(x))
        m_src = -(-int(logical_size) // n_src)
    m_dst = int(target_padded) // world
    logical = int(logical_size)
    lo_me = me * m_dst
    proto = next(iter(x.values())) if x else like
    out = proto.new_zeros((m_dst,))
    sends, recvs, local = [], [], []
    for h in range(n_src):
        owner = h % world
        s_lo, s_hi = h * m_src, min((h + 1) * m_src, logical)
        for d in range(world):
            lo, hi = max(s_lo, d * m_dst), min(s_hi, (d + 1) * m_dst)
            if lo >= hi:
                continue
            if owner == me and d == me:
                local.append((x[h][lo - s_lo:hi - s_lo], lo - lo_me,
                              hi - lo_me))
            elif owner == me:
                sends.append((d, x[h][lo - s_lo:hi - s_lo]))
            elif d == me:
                recvs.append((owner, proto.new_empty((hi - lo,)),
                              lo - lo_me, hi - lo_me))
    for block, a, b in local:
        out[a:b].copy_(block)
    if world > 1:
        scheduler.p2p(sends, [(s, buf) for s, buf, _, _ in recvs], group)
    for _, buf, a, b in recvs:
        out[a:b].copy_(buf)
    return out


def reshard_flat(x, logical_size: int, target_padded: int, group=None):
    """One ZeRO flat slice re-cut to a layout of another padded length
    (:func:`recut_flat` with this rank's one source slice)."""
    return recut_flat(x, logical_size, target_padded, group)


# --------------------------------------------------------------------------
# live-state consumers
# --------------------------------------------------------------------------

def _shape_view(tree, specs, mesh):
    """Whole storage shapes (``Leaf`` s) of ``tree``'s blocks placed under
    ``specs`` on ``mesh`` (None: the blocks are whole)."""
    from deeplearning4j_tpu_torch.sharding.rules import Leaf, _dtype_name

    def rec(t, s):
        if isinstance(t, dict):
            return {k: rec(t[k], None if s is None else s[k]) for k in t}
        shape = list(t.shape)
        if s is not None:
            for d, e in enumerate(s):
                if e is None:
                    continue
                for ax in (e if isinstance(e, (tuple, list)) else (e,)):
                    shape[d] *= int(mesh.shape[ax])
        return Leaf(tuple(shape), _dtype_name(t))

    return rec(tree, specs)


@dataclasses.dataclass
class _ShapeNet:
    """A network's whole storage shapes, for a plan to resolve."""

    params: dict
    opt_state: dict
    conf: object


def _placements(specs, mesh, tree):
    if specs is None:
        return scheduler.tree_map(lambda _: REPLICATED, tree)
    return {k: _placements(specs[k], mesh, tree[k]) if isinstance(
        tree[k], dict) else Placement(mesh, specs[k]) for k in tree}


def _exact_family(w, role: str) -> None:
    from deeplearning4j_tpu_torch.parallel.wrapper import TrainingMode

    if (w.training_mode is not TrainingMode.SHARED_GRADIENTS
            or w.threshold_algorithm is not None or w.expert_parallel):
        raise ValueError(
            f"{role} wrapper must use the exact SHARED_GRADIENTS family "
            f"(AVERAGING replica stacks / threshold residuals do not "
            f"reshard across worker counts)")


def reshard_training_state(src, dst) -> None:
    """Hand a live ``ParallelWrapper``'s training state to ``dst``, a
    wrapper on a possibly different mesh shape over the same processes, by
    slice intersection over collectives instead of the host route (gather
    with ``sync_model``, re-cut in ``dst``'s set-up). Bit for bit: values
    move, never recomputed. ``dst`` must wrap the same network
    configuration in the exact SHARED_GRADIENTS family (plain, bucketed,
    ZeRO, or a partition-rules plan). A collective: every rank calls it.
    ``dst`` takes over ``src.model``; ``src`` must not train on after."""
    if not src._setup_done:
        raise ValueError("source wrapper has no staged training state "
                         "(fit or _setup first)")
    for w, role in ((src, "source"), (dst, "destination")):
        _exact_family(w, role)
    m = src.model
    if getattr(src, "_zero", False):
        # ZeRO's flat updater slices: the whole updater state first
        src._write_back()
    cut = src._plan is not None and src._cut
    pspecs = src._pspecs if cut else None
    ospecs = src._ospecs if cut else None
    shapes = _ShapeNet(_shape_view(m.params, pspecs, src.mesh),
                       _shape_view(m.opt_state, ospecs, src.mesh), m.conf)
    if dst._plan is not None:
        d_p = dst._plan.storage_specs(shapes)
        d_o = dst._plan.opt_storage_specs(shapes)
    else:
        d_p = d_o = None
    params = reshard(m.params, _placements(d_p, dst.mesh, m.params),
                     _placements(pspecs, src.mesh, m.params), shapes.params)
    opt = reshard(m.opt_state, _placements(d_o, dst.mesh, m.opt_state),
                  _placements(ospecs, src.mesh, m.opt_state),
                  shapes.opt_state)
    state = scheduler.tree_map(lambda t: t.detach().clone(), m.state)
    m._model_axis = None
    m.params, m.opt_state, m.state = params, opt, state
    m._cast_params = None
    src._cut = False
    src._synced = True
    src._setup_done = False
    dst.model = m
    dst._prestaged = shapes if dst._plan is not None else None
    dst._cut = dst._plan is not None


def publish_to_engine(wrapper, engine):
    """Train -> serve: the wrapper's live params and state, gathered once
    (a plan's slices and ZeRO's trees whole; the averaging replicas'
    mean), published into a running ``InferenceEngine`` between its
    launches. The training loop keeps its tensors: where the engine skips
    its inference-graph pass (``graph_opt=False``) and would serve the
    live tensors themselves, they are copied first (the donation-safety
    rule). A collective where the gather is one: every rank calls it."""
    import copy

    m = wrapper.model
    params, state = m.params, m.state
    if getattr(wrapper, "_plan", None) is not None and wrapper._cut:
        params = wrapper._gather_tree(m.params, wrapper._pspecs)
    elif wrapper._setup_done and not wrapper._synced:
        wrapper.sync_model()
        params, state = m.params, m.state
    if not getattr(engine, "_graph_opt", True):
        live = {id(t) for t in _flat((m.params, m.state))}
        params, state = scheduler.tree_map(
            lambda t: t.detach().clone() if id(t) in live else t,
            (params, state))
    src = copy.copy(m)
    src._model_axis = None
    return engine.publish(src, params=params, state=state)


__all__ = ["Placement", "reshard", "reshard_flat", "recut_flat",
           "reshard_training_state", "publish_to_engine"]
