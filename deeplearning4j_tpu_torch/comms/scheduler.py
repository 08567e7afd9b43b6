"""Collective scheduler: one planner for bucket layout, issue order and
collective choice, on ``torch.distributed``.

Counterpart of the JAX package's ``comms/scheduler.py``. It owns the
three decisions of every explicit exchange of the data-parallel trainer
(``parallel.compression``'s ``bucketed_psum`` / ``bucketed_psum_scatter``
/ ``bucketed_all_gather`` are thin wrappers over it):

- **layout** — :func:`bucket_partition`: size-targeted buckets over the
  leaves in reverse flatten order (backprop produces the last leaves'
  gradients first), shared by every intent;
- **order** — buckets are issued one after another in plan order on every
  rank, so the ranks' collectives always pair up;
- **choice** — per bucket, with the JAX package's names: ``variadic`` and
  ``densify`` (all-reduce; in torch both are one flat buffer a bucket,
  the reduction is elementwise, so the bits do not depend on it),
  ``variadic`` (reduce-scatter, per-leaf slices) and ``all_gather`` (the
  native gather; the JAX package's ``masked_psum`` fallback was a jax
  type-system artefact and is never chosen here).

A bucket runs as ONE collective: its leaves are flattened into one tensor
(``all_reduce``), one ``[n, sum m_i]`` tensor whose row ``r`` is every
leaf's slice ``r`` (``reduce_scatter_tensor``), or the concatenated
slices (``all_gather_into_tensor``).

Every plan is content-addressed: :attr:`CollectivePlan.digest` hashes the
(intent, axis, layout, choices, leaf sizes and dtypes) exactly as the JAX
package does, so the same tree gives the same digest in both packages.
Trees flatten as JAX flattens them (dicts in sorted key order, lists and
tuples in order, None holds no leaf).

gloo holds CUDA tensors for ``all_reduce`` and ``broadcast``; its
reduce-scatter, all-gather and all-to-all on CUDA tensors vary by torch
version, so on CUDA tensors those three always run through an explicit
host stage (copy to the CPU, the CPU collective, copy back), counted in
:func:`stats` under ``host_staged``.
NCCL never takes that path. Every backend's errors raise.

Point to point (:func:`p2p`: a pipeline's stage hand-offs, the slice
moves of ``comms.reshard``): gloo moves CUDA tensors through the host,
counted under ``host_staged`` (``send`` / ``recv``); NCCL moves them on
the card. Every send and receive counts under ``p2p`` (``sends``,
``recvs``, ``bytes_sent``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"   # parallel.mesh.DATA_AXIS

INTENTS = ("all_reduce", "reduce_scatter", "all_gather")

# densified accumulation thresholds (the JAX package's): a bucket of >=
# MIN_LEAVES leaves, every one at most MAX_LEAF_BYTES and all one dtype
DENSIFY_MIN_LEAVES = 8
DENSIFY_MAX_LEAF_BYTES = 16 << 10   # 16 KiB


# --------------------------------------------------------------------------
# trees, flattened as jax flattens them
# --------------------------------------------------------------------------

def _walk(t, leaves):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("d", keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return ("l", type(t), [_walk(v, leaves) for v in t])
    if t is None:
        return ("n",)
    leaves.append(t)
    return ("x",)


def tree_flatten(tree):
    """``(leaves, spec)``: dicts in sorted key order, lists and tuples in
    order, None no leaf, anything else one leaf (the order of
    ``jax.tree_util.tree_flatten``). The walk is a module-level function:
    a recursive closure would be a reference cycle holding the leaves
    until the garbage collector runs (on the card, whole trees of
    tensors)."""
    leaves = []
    spec = _walk(tree, leaves)
    return leaves, spec


def _build(s, it):
    if s[0] == "d":
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    if s[0] == "l":
        return s[1](_build(c, it) for c in s[2])
    if s[0] == "n":
        return None
    return next(it)


def tree_unflatten(spec, leaves):
    """Inverse of :func:`tree_flatten`."""
    return _build(spec, iter(leaves))


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*args) for args in zip(leaves, *others)])


def _numel(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    return int(np.prod(tuple(shape if shape is not None
                             else np.shape(leaf))))


def _dtype_name(leaf) -> str:
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt))


def _itemsize(leaf) -> int:
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return np.dtype(dt).itemsize


# --------------------------------------------------------------------------
# layout (the single shared implementation)
# --------------------------------------------------------------------------

def bucket_partition(sizes, bucket_bytes: int):
    """Partition leaf indices into size-targeted buckets, walking the
    leaves in REVERSE order. Returns a list of index lists; every index
    appears exactly once. A leaf larger than ``bucket_bytes`` gets its own
    bucket."""
    buckets, cur, acc = [], [], 0
    for i in reversed(range(len(sizes))):
        if cur and acc + sizes[i] > bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += sizes[i]
    if cur:
        buckets.append(cur)
    return buckets


def bucket_layout(tree, bucket_bytes=None):
    """Per-bucket payload bytes of an all-reduce schedule, in issue order.
    ``bucket_bytes=None`` returns one bucket holding the whole tree."""
    leaves = tree_leaves(tree)
    if not leaves:
        return []
    sizes = [_numel(l) * _itemsize(l) for l in leaves]
    if bucket_bytes is None or len(leaves) <= 1:
        return [sum(sizes)]
    return [sum(sizes[i] for i in bucket)
            for bucket in bucket_partition(sizes, int(bucket_bytes))]


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """One resolved exchange schedule: what moves, in which buckets, in
    which order, through which collective. Immutable and
    content-addressed."""

    intent: str
    axis: str
    bucket_bytes: Optional[int]
    buckets: Tuple[Tuple[int, ...], ...]   # leaf indices, issue order
    choices: Tuple[str, ...]               # one per bucket
    leaf_sizes: Tuple[int, ...]            # payload bytes per leaf
    leaf_dtypes: Tuple[str, ...]
    digest: str = ""

    def bytes_moved(self) -> int:
        """Logical per-rank payload of one exchange."""
        return int(sum(self.leaf_sizes))

    def launches(self) -> int:
        """Collectives issued per exchange (1 = fused single exchange)."""
        return len(self.buckets)

    def bucket_bytes_list(self):
        return [sum(self.leaf_sizes[i] for i in b) for b in self.buckets]

    def choice_summary(self) -> str:
        return "+".join(sorted(set(self.choices)))

    def key_token(self) -> str:
        """``plan:<digest>``, the JAX package's step-key component."""
        return f"plan:{self.digest}"

    def summary(self) -> dict:
        return {
            "intent": self.intent,
            "axis": self.axis,
            "digest": self.digest,
            "buckets": self.launches(),
            "choices": list(self.choices),
            "bytes": self.bytes_moved(),
            "bucket_bytes": [int(b) for b in self.bucket_bytes_list()],
        }


def _leaf_meta(leaves, intent, full_sizes):
    """-> (payload bytes per leaf, dtype names). For ``all_gather`` the
    payload is the GATHERED vector (``full_sizes``)."""
    dtypes = [_dtype_name(l) for l in leaves]
    if intent == "all_gather":
        if full_sizes is None:
            raise ValueError("all_gather plans need full_sizes")
        sizes = [int(f) * _itemsize(l) for f, l in zip(full_sizes, leaves)]
    else:
        sizes = [_numel(l) * _itemsize(l) for l in leaves]
    return sizes, dtypes


def _choose(intent, idxs, sizes, dtypes):
    """Per-bucket collective choice (the JAX package's rule)."""
    if intent == "all_reduce":
        if (len(idxs) >= DENSIFY_MIN_LEAVES
                and max(sizes[i] for i in idxs) <= DENSIFY_MAX_LEAF_BYTES
                and len({dtypes[i] for i in idxs}) == 1):
            return "densify"
        return "variadic"
    if intent == "reduce_scatter":
        return "variadic"
    if intent == "all_gather":
        # torch.distributed gathers natively on every backend (the JAX
        # package's probe picks its masked-psum fallback on old jax)
        return "all_gather"
    raise ValueError(f"unknown intent {intent!r}; expected one of "
                     f"{INTENTS}")


class _Stats:
    def __init__(self):
        self.plans_built = 0
        self.plan_cache_hits = 0
        self.host_staged: Dict[str, int] = {}
        self.p2p: Dict[str, int] = {}


_STATS = _Stats()
_PLAN_CACHE: Dict[tuple, CollectivePlan] = {}
_BY_DIGEST: Dict[str, CollectivePlan] = {}
_LOCK = threading.Lock()


def stats() -> dict:
    """Process-global planner counters, and the collectives the gloo path
    staged through the host (CUDA tensors), by operation."""
    with _LOCK:
        return {"plans_built": _STATS.plans_built,
                "plan_cache_hits": _STATS.plan_cache_hits,
                "registered": len(_BY_DIGEST),
                "host_staged": dict(_STATS.host_staged),
                "p2p": dict(_STATS.p2p)}


def lookup_plan(digest: str) -> Optional[CollectivePlan]:
    """Digest -> plan (None when this process never built it)."""
    with _LOCK:
        return _BY_DIGEST.get(digest)


def reset() -> None:
    """Test hook: drop cached plans and counters."""
    with _LOCK:
        _PLAN_CACHE.clear()
        _BY_DIGEST.clear()
        _STATS.plans_built = 0
        _STATS.plan_cache_hits = 0
        _STATS.host_staged.clear()
        _STATS.p2p.clear()


class CollectiveScheduler:
    """The planner: takes a gradient / param tree plus an intent and emits
    a :class:`CollectivePlan`; :meth:`execute` runs one exchange under it
    over a process group (``group=None``: the default group; with no
    process group initialized, a one-rank identity)."""

    def __init__(self, axis_name: str = DATA_AXIS,
                 bucket_bytes: Optional[int] = None):
        self.axis_name = axis_name
        self.bucket_bytes = (None if bucket_bytes is None
                             else int(bucket_bytes))

    def plan(self, tree, intent: str, full_sizes=None) -> CollectivePlan:
        """Resolve the exchange schedule for ``tree`` (tensors, arrays or
        anything with ``.shape`` and ``.dtype``)."""
        leaves = tree_leaves(tree)
        sizes, dtypes = _leaf_meta(leaves, intent, full_sizes)
        key = (intent, self.axis_name, self.bucket_bytes, tuple(sizes),
               tuple(dtypes))
        with _LOCK:
            cached = _PLAN_CACHE.get(key)
            if cached is not None:
                _STATS.plan_cache_hits += 1
                return cached
        if not leaves:
            buckets = ()
        elif self.bucket_bytes is None or len(leaves) <= 1:
            buckets = (tuple(range(len(leaves))),)
        else:
            buckets = tuple(
                tuple(b) for b in bucket_partition(sizes,
                                                   self.bucket_bytes))
        choices = tuple(_choose(intent, b, sizes, dtypes)
                        for b in buckets)
        digest = hashlib.sha1(repr(
            (intent, self.axis_name, buckets, choices, tuple(sizes),
             tuple(dtypes))).encode()).hexdigest()[:16]
        plan = CollectivePlan(
            intent=intent, axis=self.axis_name,
            bucket_bytes=self.bucket_bytes, buckets=buckets,
            choices=choices, leaf_sizes=tuple(sizes),
            leaf_dtypes=tuple(dtypes), digest=digest)
        with _LOCK:
            raced = _PLAN_CACHE.get(key)
            if raced is not None:
                _STATS.plan_cache_hits += 1
                return raced
            _PLAN_CACHE[key] = plan
            _BY_DIGEST[digest] = plan
            _STATS.plans_built += 1
        _record_plan(plan)
        return plan

    def execute(self, plan: CollectivePlan, tree, group=None,
                full_sizes=None):
        """Run one exchange under ``plan``, bucket after bucket. Leaves of
        ``reduce_scatter`` are flat vectors of ``n * m_i`` elements and
        come back as this rank's ``m_i`` slices; leaves of ``all_gather``
        are ``m_i`` slices and come back as ``full_sizes[i] = n * m_i``
        vectors (the ``sharding.zero.ZeroSpec`` contract)."""
        leaves, spec = tree_flatten(tree)
        if not leaves:
            return tree
        if plan.intent == "all_gather" and full_sizes is None:
            raise ValueError("all_gather execution needs full_sizes")
        out = [None] * len(leaves)
        for bucket in plan.buckets:
            vals = [leaves[i] for i in bucket]
            for i, r in zip(bucket, run_bucket(plan.intent, vals, group)):
                out[i] = r
        return tree_unflatten(spec, out)


# --------------------------------------------------------------------------
# one bucket = one collective
# --------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist


def _joined() -> bool:
    """Whether this process is in a process group (without one the mesh
    is one rank and every collective is the identity)."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_of(group=None) -> int:
    return _dist().get_world_size(group) if _joined() else 1


def rank_of(group=None) -> int:
    return _dist().get_rank(group) if _joined() else 0


def _backend(group) -> str:
    return str(_dist().get_backend(group)).lower()


def _count(table: dict, op: str, n: int = 1) -> None:
    with _LOCK:
        table[op] = table.get(op, 0) + n


def all_reduce(t: torch.Tensor, group=None, async_op: bool = False,
               op: str = "sum"):
    """Sum (or ``op="max"``) ``t`` in place over the group. gloo and NCCL
    both take CPU (gloo) and CUDA tensors. Returns the work handle with
    ``async_op`` (None without a process group)."""
    if not _joined():
        return None
    dist = _dist()
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    return dist.all_reduce(t, op=red, group=group, async_op=async_op)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> None:
    if not _joined():
        return
    _dist().broadcast(t, src=src, group=group)


def _single(dist, op: str):
    """The one-tensor collective: ``<op>_single`` where this torch has it
    (the ``<op>_tensor`` names are deprecated there), else
    ``reduce_scatter_tensor`` / ``all_gather_into_tensor``."""
    new = getattr(dist, f"{op}_single", None)
    if new is not None:
        return new
    return (dist.reduce_scatter_tensor if op == "reduce_scatter"
            else dist.all_gather_into_tensor)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group=None):
    """``out`` <- this rank's row of the sum of every rank's ``inp``
    (``inp`` holds ``n`` rows of ``out.numel()`` elements)."""
    if not _joined():
        out.copy_(inp.view(-1))
        return
    if _backend(group) == "gloo" and inp.is_cuda:
        _count(_STATS.host_staged, "reduce_scatter")
        host = torch.empty(out.shape, dtype=out.dtype)
        reduce_scatter(host, inp.cpu(), group)
        out.copy_(host)
        return
    _single(_dist(), "reduce_scatter")(out, inp.reshape(-1), group=group)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` (``n`` rows of ``inp.numel()``) <- every rank's ``inp``,
    row ``r`` from rank ``r``."""
    if not _joined():
        out.copy_(inp.view(out.shape))
        return
    if _backend(group) == "gloo" and inp.is_cuda:
        _count(_STATS.host_staged, "all_gather")
        host = torch.empty(out.shape, dtype=out.dtype)
        all_gather(host, inp.cpu(), group)
        out.copy_(host)
        return
    _single(_dist(), "all_gather")(out.view(-1), inp, group=group)


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` row ``r`` <- rank ``r``'s ``inp`` row of this rank (both
    ``[world, ...]``). gloo on CUDA tensors runs through the host stage."""
    if not _joined():
        out.copy_(inp)
        return
    if _backend(group) == "gloo" and inp.is_cuda:
        _count(_STATS.host_staged, "all_to_all")
        host = torch.empty(out.shape, dtype=out.dtype)
        all_to_all(host, inp.cpu(), group)
        out.copy_(host)
        return
    _dist().all_to_all_single(out, inp, group=group)


class Pending:
    """Sends :func:`p2p` posted without waiting: :meth:`wait` completes
    them (their host copies live until then)."""

    def __init__(self, works, keep):
        self._works, self._keep = works, keep

    def wait(self) -> None:
        for work in self._works:
            work.wait()
        self._works, self._keep = [], []


def p2p(sends, recvs, group=None, wait: bool = True) -> Pending:
    """Point-to-point ``sends`` [(dst, tensor)] and ``recvs`` [(src,
    buffer)] (``dst`` / ``src``: ranks of the default group), matched in
    order for each pair of ranks; every receive has landed in its buffer
    on return. gloo stages CUDA tensors through the host. With ``wait``
    False the sends are left running: the returned :class:`Pending`
    completes them (a rank that both sends and later receives from the
    same peer must not block on its send first)."""
    if not sends and not recvs:
        return Pending([], [])
    dist = _dist()
    staged = _backend(group) == "gloo"
    ops, back, keep = [], [], []
    for dst, t in sends:
        _count(_STATS.p2p, "sends")
        _count(_STATS.p2p, "bytes_sent", t.numel() * t.element_size())
        if staged and t.is_cuda:
            _count(_STATS.host_staged, "send")
            t = t.cpu()
        t = t.contiguous()
        keep.append(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group))
    n_sends = len(ops)
    for src, buf in recvs:
        _count(_STATS.p2p, "recvs")
        host = buf
        if staged and buf.is_cuda:
            _count(_STATS.host_staged, "recv")
            host = torch.empty(buf.shape, dtype=buf.dtype)
            back.append((buf, host))
        ops.append(dist.P2POp(dist.irecv, host, src, group))
    works = dist.batch_isend_irecv(ops)
    for work in works[n_sends:]:
        work.wait()
    for buf, host in back:
        buf.copy_(host)
    pending = Pending(works[:n_sends], keep)
    if wait:
        pending.wait()
    return pending


def run_bucket(intent: str, vals, group=None):
    """One bucket's collective over ``vals`` (same dtype and device);
    returns the per-leaf results."""
    if intent == "all_reduce":
        # one flat buffer per dtype (a bucket is one dtype in practice)
        out = [None] * len(vals)
        for dt in dict.fromkeys(v.dtype for v in vals):
            idx = [i for i, v in enumerate(vals) if v.dtype == dt]
            flat = torch.cat([vals[i].reshape(-1) for i in idx])
            all_reduce(flat, group)
            for i, r in zip(idx, split_flat(flat, [vals[i].shape
                                                   for i in idx])):
                out[i] = r
        return out
    n = world_of(group)
    if intent == "reduce_scatter":
        ms = [v.numel() // n for v in vals]
        inp = torch.cat([v.reshape(n, m) for v, m in zip(vals, ms)], dim=1)
        out = inp.new_empty((sum(ms),))
        reduce_scatter(out, inp.contiguous(), group)
        return list(torch.split(out, ms))
    if intent == "all_gather":
        ms = [v.numel() for v in vals]
        inp = torch.cat([v.reshape(-1) for v in vals])
        out = inp.new_empty((n, sum(ms)))
        all_gather(out, inp, group)
        return [c.reshape(-1) for c in torch.split(out, ms, dim=1)]
    raise ValueError(f"unknown intent {intent!r}")


def split_flat(flat: torch.Tensor, shapes):
    """Views of ``flat`` in the given shapes, one after another."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape)) if len(shape) else 1
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


# --------------------------------------------------------------------------
# module-level conveniences (the thin-wrapper surface compression uses)
# --------------------------------------------------------------------------

def plan_for(tree, intent: str, axis_name: str = DATA_AXIS,
             bucket_bytes=None, full_sizes=None) -> CollectivePlan:
    """Build (or fetch) the plan for one exchange without running it."""
    return CollectiveScheduler(axis_name, bucket_bytes).plan(
        tree, intent, full_sizes=full_sizes)


def exchange(tree, intent: str, axis_name: str = DATA_AXIS,
             bucket_bytes=None, group=None, full_sizes=None):
    """Plan + execute one exchange over ``group``."""
    sched = CollectiveScheduler(axis_name, bucket_bytes)
    plan = sched.plan(tree, intent, full_sizes=full_sizes)
    return sched.execute(plan, tree, group=group, full_sizes=full_sizes)


def _record_plan(plan: CollectivePlan) -> None:
    """Telemetry on each fresh plan (the JAX package's
    ``dl4j_collective_plan_*`` series)."""
    from deeplearning4j_tpu_torch import telemetry

    telemetry.record_collective_plan(
        plan.intent, plan.choice_summary(), plan.bytes_moved(),
        plan.launches())
