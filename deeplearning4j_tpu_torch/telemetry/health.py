"""Training health: per-step non-finite guards and the anomaly policy.

Counterpart of the JAX package's ``telemetry/health.py``. Two halves:

1. **Guards** (:func:`guard_vector`, :func:`apply_skip`): reductions on
   the device over one step's loss, gradients and update, packed into one
   small float32 vector: the loss, its non-finite flag, a gradient
   non-finite flag, the global gradient norm, the update and param norms,
   their ratio and one gradient norm per bucket (a top-level key of the
   gradient tree, i.e. a layer or vertex). The vector stays on the device.
   Under ``SKIP_STEP`` the update is selected against the old values with
   ``torch.where`` on a device flag, so a poisoned step leaves params,
   layer state and updater state bit-identical without the host reading
   the flag.
2. **Policy** (:class:`HealthMonitor`): ``WARN`` counts (guard vectors
   queue as device tensors and reach the host in one stacked transfer
   every ``flush_every`` steps), ``SKIP_STEP`` discards the update and
   counts the same way, ``ROLLBACK`` restores the last-good snapshot
   (``optimize.checkpoint``) and ``HALT`` raises :class:`DivergenceError`.
   ROLLBACK and HALT read each step's vector on the step.

The module mode (:func:`graph_mode`) is what the train steps read: ""
(no guards), "observe" or "skip". Disabled (the default), a train step
pays one flag check. The JAX package compiles the mode into its step;
eager PyTorch reads it at every step.
"""

from __future__ import annotations

import enum
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.telemetry.registry import REGISTRY

# guard-vector layout: a fixed head, then one gradient norm a bucket.
# Aggregations across segments or steps take the elementwise max, so every
# entry reads "bigger = worse".
GUARD_LOSS = 0            # the loss
GUARD_LOSS_NONFINITE = 1  # 1.0 when the loss is NaN / Inf
GUARD_GRAD_NONFINITE = 2  # 1.0 when any gradient element is NaN / Inf
GUARD_GRAD_NORM = 3       # global L2 gradient norm
GUARD_UPDATE_NORM = 4     # L2 norm of (new params - params)
GUARD_PARAM_NORM = 5      # L2 norm of the params
GUARD_RATIO = 6           # update norm / (param norm + 1e-12)
GUARD_HEAD = 7


class AnomalyPolicy(enum.Enum):
    """What the monitor does on a step with a non-finite loss or
    gradient."""

    WARN = "warn"              # count and log; training goes on
    SKIP_STEP = "skip_step"    # discard the update on the device
    ROLLBACK = "rollback"      # restore the last-good snapshot
    HALT = "halt"              # raise DivergenceError


class DivergenceError(RuntimeError):
    """Raised by HALT (and by ROLLBACK with no snapshot to restore);
    carries the host guard vector."""

    def __init__(self, msg: str, vec=None, step: Optional[int] = None,
                 path: str = ""):
        super().__init__(msg)
        self.vec = None if vec is None else list(_host(vec).ravel())
        self.step = step
        self.path = path


def _host(vec) -> np.ndarray:
    """A guard vector (device tensor or host array) as float64 numpy."""
    if isinstance(vec, torch.Tensor):
        return vec.detach().to("cpu", torch.float64).numpy()
    return np.asarray(vec, np.float64)


# ---------------------------------------------------------------------------
# guard math (torch ops on device tensors; nothing reads them on the host)
# ---------------------------------------------------------------------------

def bucket_keys(grads) -> Tuple[str, ...]:
    """The buckets of :func:`guard_vector`'s tail: the sorted top-level
    keys of a dict gradient tree, or one bucket ``"all"`` for anything
    else."""
    if isinstance(grads, dict) and grads:
        return tuple(sorted(grads))
    return ("all",)


def _float_leaves(tree) -> List[torch.Tensor]:
    """The floating-point tensors of a nested dict / list, dict keys in
    sorted order (the JAX package's tree-leaf order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _float_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _float_leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


def _zero(like: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = like.device if like is not None else "cpu"
    return torch.zeros((), dtype=torch.float32, device=dev)


def sq_sum(leaves: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Sum of squares of every element of ``leaves``, in float32, as one
    device scalar: one ``torch._foreach_norm`` over the tensors. A NaN or
    Inf element makes it non-finite."""
    leaves = [t if t.dtype == torch.float32 else t.float() for t in leaves]
    if not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm(leaves)
    return torch.stack(norms).square().sum()


def assemble(loss, bucket_sq, upd_sq=None, par_sq=None) -> torch.Tensor:
    """The packed vector from a step's loss, per-bucket squared gradient
    sums and (optional) squared update and param norms."""
    loss32 = torch.as_tensor(loss).detach().to(torch.float32)
    bucket_sq = [torch.as_tensor(b).to(device=loss32.device,
                                       dtype=torch.float32)
                 for b in bucket_sq]
    total_sq = (torch.stack(bucket_sq).sum() if bucket_sq
                else _zero(loss32))
    grad_nf = (~torch.isfinite(total_sq)).to(torch.float32)
    loss_nf = (~torch.isfinite(loss32)).to(torch.float32)
    if upd_sq is not None and par_sq is not None:
        unorm = torch.as_tensor(upd_sq).to(loss32.device).sqrt()
        pnorm = torch.as_tensor(par_sq).to(loss32.device).sqrt()
    else:
        unorm = pnorm = _zero(loss32)
    ratio = unorm / (pnorm + 1e-12)
    return torch.stack([loss32.reshape(()), loss_nf.reshape(()), grad_nf,
                        total_sq.sqrt(), unorm, pnorm, ratio]
                       + [b.sqrt() for b in bucket_sq])


def _update_sqs(params, new_params):
    new_l, old_l = _float_leaves(new_params), _float_leaves(params)
    upd = sq_sum([n.float() - o.float() for n, o in zip(new_l, old_l)],
                 old_l[0].device if old_l else None)
    return upd, sq_sum(old_l, upd.device)


def guard_vector(loss, grads, params=None, new_params=None) -> torch.Tensor:
    """The packed health vector (float32, ``GUARD_HEAD + n_buckets``
    wide) of one step: one squared-sum reduction a bucket (a NaN / Inf
    element poisons its sum, so no separate ``isfinite`` pass over the
    tensors); ``params`` / ``new_params`` add the update / param norms
    (else 0)."""
    keys = bucket_keys(grads)
    dev = torch.as_tensor(loss).device
    bucket_sq = [sq_sum(_float_leaves(
        grads[k] if (isinstance(grads, dict) and k in grads) else grads),
        dev) for k in keys]
    return guard_vector_from_sq(loss, bucket_sq, params=params,
                                new_params=new_params)


def guard_vector_from_sq(loss, bucket_sq, params=None, new_params=None):
    """:func:`guard_vector` from pre-reduced per-bucket squared sums (in
    :func:`bucket_keys` order)."""
    if params is not None and new_params is not None:
        upd_sq, par_sq = _update_sqs(params, new_params)
        return assemble(loss, bucket_sq, upd_sq, par_sq)
    return assemble(loss, bucket_sq)


def loss_guard_vector(loss) -> torch.Tensor:
    """A loss-only guard for paths that do not expose their gradients:
    the same layout with one bucket (``"all"``), gradient entries 0."""
    loss32 = torch.as_tensor(loss).detach().to(torch.float32).reshape(())
    z = _zero(loss32)
    return torch.stack([loss32, (~torch.isfinite(loss32)).to(torch.float32),
                        z, z, z, z, z, z])


def loss_guard(loss) -> torch.Tensor:
    """The host-callable loss-only guard (the JAX package's
    ``loss_guard``): :func:`loss_guard_vector` on the step's device loss,
    queued behind it with no host read (the monitor decides when to
    materialize)."""
    return loss_guard_vector(loss)


def vec_ok(vec) -> torch.Tensor:
    """A device bool: the step is numerically healthy."""
    return (vec[GUARD_LOSS_NONFINITE] + vec[GUARD_GRAD_NONFINITE]) == 0


def _select(ok, new, old):
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(ok, n, o) for n, o in zip(new, old))
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return new


def apply_skip(vec, new_trees, old_trees) -> tuple:
    """SKIP_STEP: ``new`` tensors on a healthy step, ``old`` ones on an
    anomalous one (``torch.where`` on the device flag). ``*_trees`` are
    matching tuples of nested dicts."""
    ok = vec_ok(vec)
    return tuple(_select(ok, nt, ot) for nt, ot in zip(new_trees, old_trees))


def combine(stacked_vecs) -> torch.Tensor:
    """Stacked guard vectors ``[n, G]`` (one a tBPTT segment or fused
    step) as one: the elementwise max (NaN propagates)."""
    if isinstance(stacked_vecs, (list, tuple)):
        stacked_vecs = torch.stack(list(stacked_vecs))
    return torch.amax(stacked_vecs, dim=0)


def combine_across(vec, group=None) -> torch.Tensor:
    """One guard vector across the ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default one): the
    elementwise max by all-reduce, so any rank's anomaly is the step's
    anomaly (the JAX package's ``pmax`` over the data axis). The result
    stays on the device. The non-finite flags are 0 or 1 on every rank, so
    the max keeps them whatever a backend's max does with a NaN."""
    from deeplearning4j_tpu_torch.comms import scheduler

    out = vec.detach().to(torch.float32).clone()
    scheduler.all_reduce(out, group, op="max")
    return out


# ---------------------------------------------------------------------------
# the guarded update pass of the networks' train steps
# ---------------------------------------------------------------------------

def guarded_update(net, loss, grads, new_state, t, epoch, mode: str,
                   carries=None) -> torch.Tensor:
    """One step's update pass under a health mode, on ``net`` in place:
    the per-bucket gradient sums and the step's ``ok`` flag first, then
    each layer's gradient normalization, regularization and updater
    (``optimize.solver``) out of place; under ``mode == "skip"`` the new
    params, updater state, layer state and tBPTT ``carries`` (``(old,
    new)`` dicts, the new ones selected in place) are chosen against the
    old ones by the flag. Returns the guard vector; nothing is read on the
    host. ``net`` exposes ``params``, ``opt_state``, ``state`` and
    ``_layer_updater(key)``."""
    from deeplearning4j_tpu_torch.optimize import solver

    keys = bucket_keys(grads)
    dev = torch.as_tensor(loss).device
    bucket_sq = [sq_sum(_float_leaves(grads[k]), dev) for k in keys]
    ok = None
    if mode == "skip":
        total = torch.stack(bucket_sq).sum() if bucket_sq else _zero()
        ok = torch.isfinite(total) & torch.isfinite(
            torch.as_tensor(loss).detach())
    upd_sq, par_sq = solver.apply_updates_guarded(net, grads, t, epoch, ok)
    if ok is not None:
        for k, s in new_state.items():
            if k in net.state:
                new_state[k] = _select(ok, s, net.state[k])
        if carries is not None:
            old, new = carries
            for k in list(new):
                if k in old:
                    new[k] = _select(ok, new[k], old[k])
    net.state.update(new_state)
    return assemble(loss, bucket_sq, upd_sq, par_sq)


# ---------------------------------------------------------------------------
# module mode
# ---------------------------------------------------------------------------

_MODE = ""  # "" disabled | "observe" | "skip"


def graph_mode() -> str:
    """What a train step must compute: ``""`` (no guards), ``"observe"``
    (the guard vector) or ``"skip"`` (the vector and the SKIP_STEP
    select)."""
    return _MODE


def enabled() -> bool:
    return bool(_MODE)


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Applies the anomaly policy to guard vectors.

    WARN / SKIP_STEP are lazy: vectors queue as device tensors and reach
    the host in one stacked transfer every ``flush_every`` steps (or on
    ``report()`` / ``flush()``), so training gains no per-step
    synchronization. ROLLBACK / HALT read each step's vector on the step.
    ROLLBACK snapshots every ``snapshot_every`` healthy steps through the
    owner's ``_health_snapshot`` / ``_health_restore`` hooks (host copies,
    ``optimize.checkpoint``)."""

    def __init__(self, policy: AnomalyPolicy = AnomalyPolicy.WARN,
                 flush_every: int = 64, snapshot_every: int = 10):
        self.policy = policy
        self.flush_every = max(1, int(flush_every))
        self.snapshot_every = max(1, int(snapshot_every))
        self._lock = threading.RLock()
        self.reset()

    def reset(self):
        with self._lock:
            self.steps = 0
            self.nonfinite_steps = 0
            self.skipped_steps = 0
            self.rollbacks = 0
            self.halted = False
            self.last_vec: Optional[List[float]] = None
            self.last_keys: Tuple[str, ...] = ()
            self.last_anomaly_step: Optional[int] = None
            self._pending: List[tuple] = []
            self._pending_steps = 0

    # --- recording ----------------------------------------------------------
    def _lazy(self) -> bool:
        return self.policy in (AnomalyPolicy.WARN, AnomalyPolicy.SKIP_STEP)

    def on_step(self, vec, keys: Sequence[str] = (), path: str = "",
                owner=None,
                snapshot: Optional[Callable[[], object]] = None,
                restore: Optional[Callable[[object], None]] = None,
                skipped: Optional[bool] = None) -> str:
        """Feed one step's guard vector. Returns the action taken
        (``"none"`` or ``"rollback"``); HALT raises. ``owner`` holds the
        rollback snapshot (``_health_last_good``). ``skipped``: whether an
        anomalous update was really discarded (None: by the policy)."""
        if skipped is None:
            skipped = self.policy is AnomalyPolicy.SKIP_STEP
        self.steps += 1
        if self._lazy():
            self._pending.append((vec, tuple(keys), path, self.steps,
                                  skipped))
            self._pending_steps += 1
            if self._pending_steps >= self.flush_every:
                self.flush()
            return "none"
        v = _host(vec)
        anomalous = (v[GUARD_LOSS_NONFINITE] + v[GUARD_GRAD_NONFINITE]) > 0
        self._observe_host([(v, tuple(keys), path, self.steps, skipped)])
        if not anomalous:
            self._maybe_snapshot(owner, snapshot)
            return "none"
        return self._remediate(v, keys, path, self.steps, "step", owner,
                               restore)

    def _remediate(self, v, keys, path, step: int, frag: str, owner,
                   restore) -> str:
        """ROLLBACK's restore, or HALT's raise; ``frag`` names the
        offending step."""
        if self.policy is AnomalyPolicy.ROLLBACK:
            tag = getattr(owner, "_health_last_good", None) \
                if owner is not None else None
            if tag is None or restore is None:
                self.halted = True
                raise DivergenceError(
                    f"non-finite {frag} on path {path!r} with ROLLBACK "
                    "policy but no last-good snapshot to restore "
                    f"(guard={self._describe(v, keys)})",
                    vec=v, step=step, path=path)
            restore(tag[0])
            self.rollbacks += 1
            REGISTRY.counter("dl4j_rollbacks_total",
                             help="health-policy snapshot restores",
                             path=path).inc()
            return "rollback"
        self.halted = True
        REGISTRY.counter("dl4j_halts_total",
                         help="DivergenceError raises", path=path).inc()
        raise DivergenceError(
            f"non-finite training {frag} on path {path!r} "
            f"(guard={self._describe(v, keys)})",
            vec=v, step=step, path=path)

    def _maybe_snapshot(self, owner, snapshot):
        """ROLLBACK's snapshot cadence over healthy steps (a snapshot
        newer than the step count is a leftover from before a reset)."""
        if self.policy is AnomalyPolicy.ROLLBACK and owner is not None \
                and snapshot is not None:
            tag = getattr(owner, "_health_last_good", None)
            if tag is None or tag[1] > self.steps \
                    or self.steps - tag[1] >= self.snapshot_every:
                owner._health_last_good = (snapshot(), self.steps)

    def on_steps(self, vecs, k: int, keys: Sequence[str] = (),
                 path: str = "", owner=None,
                 snapshot: Optional[Callable[[], object]] = None,
                 restore: Optional[Callable[[object], None]] = None,
                 skipped: Optional[bool] = None) -> str:
        """Feed a fused group's stacked guard vectors (``[K, G]``; row j =
        step j). Counts as K :meth:`on_step` calls; WARN / SKIP_STEP queue
        the stack as one entry, ROLLBACK / HALT resolve for the whole
        group and name its first offending step."""
        k = int(k)
        if skipped is None:
            skipped = self.policy is AnomalyPolicy.SKIP_STEP
        first = self.steps + 1
        self.steps += k
        if self._lazy():
            self._pending.append((vecs, tuple(keys), path, self.steps,
                                  skipped))
            self._pending_steps += k
            if self._pending_steps >= self.flush_every:
                self.flush()
            return "none"
        v = _host(vecs).reshape(k, -1)
        self._observe_host([(v, tuple(keys), path, self.steps, skipped)])
        bad = np.flatnonzero((v[:, GUARD_LOSS_NONFINITE]
                              + v[:, GUARD_GRAD_NONFINITE]) > 0)
        if bad.size == 0:
            self._maybe_snapshot(owner, snapshot)
            return "none"
        j = int(bad[0])
        offending = first + j
        return self._remediate(
            v[j], tuple(keys), path, offending,
            f"step {offending} (step {j + 1}/{k} of the fused "
            "super-step)", owner, restore)

    def _describe(self, v, keys) -> str:
        parts = [f"loss={v[GUARD_LOSS]:.4g}",
                 f"loss_nonfinite={int(v[GUARD_LOSS_NONFINITE])}",
                 f"grad_nonfinite={int(v[GUARD_GRAD_NONFINITE])}",
                 f"grad_norm={v[GUARD_GRAD_NORM]:.4g}"]
        bad = [k for k, n in zip(keys, v[GUARD_HEAD:])
               if not math.isfinite(float(n))]
        if bad:
            parts.append(f"nonfinite_buckets={bad}")
        return ", ".join(parts)

    # --- lazy accounting ----------------------------------------------------
    def flush(self) -> int:
        """Bring the queued vectors to the host (one stacked transfer a
        vector width) and fold them into the counts and registry series.
        Returns the anomalies in this batch."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._pending_steps = 0
        if not pending:
            return 0
        rows = [v.reshape(-1, v.shape[-1]) if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64).reshape(
                    -1, np.shape(v)[-1])
                for v, *_ in pending]
        host = [None] * len(rows)
        groups = {}
        for i, r in enumerate(rows):
            if isinstance(r, torch.Tensor):
                groups.setdefault((r.shape[-1], r.device), []).append(i)
            else:
                host[i] = r
        for idx in groups.values():
            flat = _host(torch.cat([rows[i].detach().float() for i in idx]))
            pos = 0
            for i in idx:
                n = rows[i].shape[0]
                host[i] = flat[pos:pos + n]
                pos += n
        entries = []
        for h, (v, keys, path, step, skipped) in zip(host, pending):
            ndim = v.ndim if isinstance(v, torch.Tensor) else np.ndim(v)
            entries.append((h if ndim == 2 else h.reshape(-1), keys, path,
                            step, skipped))
        return self._observe_host(entries)

    def _observe_host(self, entries) -> int:
        anomalies = 0
        with self._lock:
            for v, keys, path, step, skipped in entries:
                # a fused group queues its K vectors as one [K, G] stack;
                # ``step`` is the last step's count
                rows = v if v.ndim == 2 else v.reshape(1, -1)
                base = step - len(rows) + 1
                for i, r in enumerate(rows):
                    self.last_vec = [float(x) for x in r]
                    self.last_keys = keys
                    if not (r[GUARD_LOSS_NONFINITE]
                            + r[GUARD_GRAD_NONFINITE]) > 0:
                        continue
                    anomalies += 1
                    self.nonfinite_steps += 1
                    self.last_anomaly_step = base + i
                    REGISTRY.counter(
                        "dl4j_nonfinite_steps_total",
                        help="steps with non-finite loss/gradients",
                        path=path).inc()
                    if skipped and self.policy is AnomalyPolicy.SKIP_STEP:
                        self.skipped_steps += 1
                        REGISTRY.counter(
                            "dl4j_skipped_steps_total",
                            help="updates discarded by SKIP_STEP",
                            path=path).inc()
            if self.last_vec is not None:
                REGISTRY.gauge("dl4j_grad_global_norm",
                               help="last observed global gradient "
                                    "norm").set(
                    self.last_vec[GUARD_GRAD_NORM])
                REGISTRY.gauge("dl4j_update_param_ratio",
                               help="last update:param norm ratio").set(
                    self.last_vec[GUARD_RATIO])
        return anomalies

    # --- reporting ----------------------------------------------------------
    def report(self) -> dict:
        """Flush and summarize (the ``/health`` payload)."""
        self.flush()
        with self._lock:
            if self.halted:
                status = "halted"
            elif self.nonfinite_steps:
                status = "anomalous"
            else:
                status = "ok"
            last = None
            if self.last_vec is not None:
                last = {
                    "loss": self.last_vec[GUARD_LOSS],
                    "grad_norm": self.last_vec[GUARD_GRAD_NORM],
                    "update_norm": self.last_vec[GUARD_UPDATE_NORM],
                    "param_norm": self.last_vec[GUARD_PARAM_NORM],
                    "update_param_ratio": self.last_vec[GUARD_RATIO],
                    "bucket_norms": dict(zip(
                        self.last_keys, self.last_vec[GUARD_HEAD:])),
                }
            return {
                "enabled": enabled(),
                "policy": self.policy.value,
                "status": status,
                "steps": self.steps,
                "nonfinite_steps": self.nonfinite_steps,
                "skipped_steps": self.skipped_steps,
                "rollbacks": self.rollbacks,
                "last_anomaly_step": self.last_anomaly_step,
                "last": last,
            }


MONITOR = HealthMonitor()


def monitor() -> HealthMonitor:
    return MONITOR


def _hooks(owner, snapshot, restore):
    if snapshot is None and owner is not None:
        snapshot = getattr(owner, "_health_snapshot", None)
    if restore is None and owner is not None:
        restore = getattr(owner, "_health_restore", None)
    return snapshot, restore


def observe_step(owner, path: str, step: int, epoch: int, loss, vec,
                 keys: Sequence[str], batch=None,
                 rng_seed: Optional[int] = None,
                 snapshot: Optional[Callable[[], object]] = None,
                 restore: Optional[Callable[[object], None]] = None,
                 skipped: Optional[bool] = None) -> str:
    """The per-step health epilogue of every guarded training path:
    flight-record the step (the batch's shapes only if the recorder is
    on), then apply the policy. ``snapshot`` / ``restore`` default to the
    owner's hooks. Returns the monitor's action."""
    from deeplearning4j_tpu_torch.telemetry import flightrec

    if flightrec.RECORDER._enabled:
        flightrec.RECORDER.record_step(
            path, step, epoch, score=loss, guard=vec, guard_keys=keys,
            rng_seed=rng_seed,
            batch_fp=(flightrec.batch_fingerprint(*batch)
                      if batch is not None else None))
    snapshot, restore = _hooks(owner, snapshot, restore)
    return MONITOR.on_step(vec, keys=keys, path=path, owner=owner,
                           snapshot=snapshot, restore=restore,
                           skipped=skipped)


def observe_fused(owner, path: str, first_step: int, epoch: int, losses,
                  vecs, keys: Sequence[str], k: int, batch=None,
                  rng_seed: Optional[int] = None,
                  snapshot: Optional[Callable[[], object]] = None,
                  restore: Optional[Callable[[object], None]] = None,
                  skipped: Optional[bool] = None) -> str:
    """The fused K-step epilogue: one flight record for the group (the
    max-combined guard, the last step's loss) and the ``[K, G]`` stack to
    the monitor."""
    from deeplearning4j_tpu_torch.telemetry import flightrec

    if flightrec.RECORDER._enabled:
        flightrec.RECORDER.record_step(
            path, first_step + k - 1, epoch, score=losses[-1],
            guard=combine(vecs), guard_keys=keys, rng_seed=rng_seed,
            batch_fp=(flightrec.batch_fingerprint(*batch)
                      if batch is not None else None))
    snapshot, restore = _hooks(owner, snapshot, restore)
    return MONITOR.on_steps(vecs, k, keys=keys, path=path, owner=owner,
                            snapshot=snapshot, restore=restore,
                            skipped=skipped)


def configure(policy: AnomalyPolicy = AnomalyPolicy.WARN,
              flush_every: int = 64, snapshot_every: int = 10,
              record_flights: bool = True) -> HealthMonitor:
    """Turn the health layer on: set the mode the train steps read,
    reset and reconfigure the monitor and (by default) enable the flight
    recorder, so a HALT or a crash leaves a bundle behind."""
    global _MODE
    if isinstance(policy, str):
        policy = AnomalyPolicy(policy)
    MONITOR.policy = policy
    MONITOR.flush_every = max(1, int(flush_every))
    MONITOR.snapshot_every = max(1, int(snapshot_every))
    MONITOR.reset()
    _MODE = "skip" if policy is AnomalyPolicy.SKIP_STEP else "observe"
    if record_flights:
        from deeplearning4j_tpu_torch.telemetry import flightrec

        flightrec.RECORDER.enable()
    return MONITOR


def disable() -> None:
    """Back to the unguarded step (the recorded counts stay)."""
    global _MODE
    _MODE = ""


def report() -> dict:
    return MONITOR.report()
