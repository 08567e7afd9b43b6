"""Preemption-safe resumable training.

Counterpart of the JAX package's ``resilience/session.py``, with the same
``session.json`` manifest and snapshot files. :class:`TrainingSession`
wraps the fit loop with periodic durable snapshots (the atomic
``serializer.write_model`` zips, or pod snapshots, plus the RNG and the
iterator's epoch / position in a ``session.json`` manifest) and
auto-resumes after a resumable failure to results bit-identical with an
uninterrupted run.

Why bit-identical holds: a training step is a function of (params, layer
state, updater state, batch, iteration, epoch, the base seed). The
per-step dropout seed is derived from the configuration's seed and the
iteration (``_train_seed``: ``vertex_seed(seed, iteration + 1000003)``,
and on a ``ParallelWrapper`` rank ``r`` plus ``r * 1000003``), both of
which the snapshot restores; the manifest's ``rng_key`` records the base
seed (as two 32-bit words, where the JAX package keeps its key's two
words), and a resume checks it against the restored configuration.
Replaying the same batch order from the snapshot's position therefore
reproduces the uninterrupted run, provided each step is deterministic
(on the card: cuDNN's deterministic algorithms).

Resume chain (newest first): digest-verified on-disk snapshots (a
corrupt or truncated one falls back to the previous one), then the
in-memory last-good snapshot (``optimize.checkpoint``) for in-process
restarts when the disk copies are gone.

Usage::

    sess = TrainingSession(net, "ckpts/run1",
                           snapshot_every_n_iterations=50)
    sess.fit(iterator, epochs=3)          # auto-resumes on preemption

    # after a process crash: resume and FINISH the original 3-epoch
    # budget (epochs= is relative to the resumed position, so use the
    # absolute to_epoch= form when re-running the same script)
    sess = TrainingSession(None, "ckpts/run1")
    sess.resume()                          # -> restored model
    sess.fit(iterator, to_epoch=3)         # continues where it died
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple, Type

from deeplearning4j_tpu_torch.resilience.faults import InjectedFault
from deeplearning4j_tpu_torch.resilience.retry import (
    CHECKPOINT_RETRY,
    RetryPolicy,
)

MANIFEST = "session.json"
_MANIFEST_VERSION = 1

logger = logging.getLogger(__name__)


class PreemptionError(RuntimeError):
    """Raise (or map your platform's preemption signal to) this to tell a
    :class:`TrainingSession` the interruption is resumable."""


def _rng_key(net) -> list:
    """The base seed as the manifest records it: two 32-bit words."""
    seed = int(getattr(net.conf, "seed", 0) or 0) & (2 ** 64 - 1)
    return [seed >> 32, seed & 0xFFFFFFFF]


class TrainingSession:
    """Crash / preemption-safe ``fit`` for a MultiLayerNetwork, a
    ComputationGraph, or a ``ParallelWrapper`` in exact SHARED_GRADIENTS
    mode (plain or ZeRO).

    Args:
        model: the network or wrapper (``None`` to resume a dead process's
            session purely from ``directory``).
        directory: snapshot home (created if missing).
        snapshot_every_n_iterations: periodic durable snapshot cadence (0
            disables; epoch boundaries always snapshot).
        keep_last: on-disk snapshots retained (older ones pruned — but at
            least two, so the digest fallback always has a predecessor).
        retry: policy for snapshot writes (default ``CHECKPOINT_RETRY``).
        resumable: exception classes that trigger auto-resume inside
            :meth:`fit`; anything else propagates. The default,
            ``(PreemptionError, InjectedFault, OSError, HostDeathError)``,
            holds no kernel error: a kernel that fails to build or launch
            raises ``RuntimeError`` and ends the fit.
        max_restarts: auto-resumes per :meth:`fit` call before giving up.
        pod: pod snapshots (:mod:`~deeplearning4j_tpu_torch.resilience.
            pod`): an int ``N`` (``PodConfig(n_hosts=N)``) or a
            ``PodConfig``. Snapshots become per-host shard directories,
            resume verifies every shard and falls back newest-first past
            partial snapshots (the reason logged), and the fit loop
            carries the ``pod.heartbeat`` fault site.
        device: where a network restored without a live one goes
            (``model=None``); otherwise the live network's device.
    """

    def __init__(self, model, directory: str,
                 snapshot_every_n_iterations: int = 50,
                 keep_last: int = 2,
                 retry: Optional[RetryPolicy] = None,
                 resumable: Optional[
                     Tuple[Type[BaseException], ...]] = None,
                 max_restarts: int = 3,
                 pod=None, device="cuda"):
        from deeplearning4j_tpu_torch.resilience import pod as pod_mod

        if resumable is None:
            resumable = (PreemptionError, InjectedFault, OSError,
                         pod_mod.HostDeathError)
        self.model = model
        t = self._trainer()
        if isinstance(pod, int):
            pod = pod_mod.PodConfig(
                n_hosts=pod, group=t.group if t is not None else None)
        self.pod = pod
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        if t is not None:
            from deeplearning4j_tpu_torch.parallel.wrapper import TrainingMode

            if (t.training_mode is not TrainingMode.SHARED_GRADIENTS
                    or t.threshold_algorithm is not None):
                # model-level snapshots capture params / state / opt only:
                # AVERAGING's per-replica divergence and the threshold
                # accumulator's residual / tau would silently reset on
                # resume, breaking the bit-identical guarantee
                raise ValueError(
                    "TrainingSession drives exact SHARED_GRADIENTS "
                    "wrappers only (AVERAGING replica state and "
                    "threshold-compression residuals are not captured "
                    "by model-level snapshots)")
        self.device = device
        self.every_iters = int(snapshot_every_n_iterations)
        self.keep_last = max(2, int(keep_last))
        self.retry = retry or CHECKPOINT_RETRY
        self.resumable = tuple(resumable)
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._batch_in_epoch = 0
        self._mem = None        # in-memory last-good (fallback of last resort)
        self._mem_entry = None
        self._manifest = self._read_manifest()

    # --- wrapper adapter ----------------------------------------------------
    def _trainer(self):
        """The ``ParallelWrapper`` this session drives, else None. A
        wrapper session snapshots the WRAPPED model (full trees, gathered
        through the ``_live_trainer`` hook: ZeRO's updater slices), and a
        resume re-stages onto the wrapper's ranks."""
        from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

        return self.model if isinstance(self.model, ParallelWrapper) \
            else None

    @property
    def _net(self):
        """The underlying network (counters and serialization authority)."""
        t = self._trainer()
        return t.model if t is not None else self.model

    def _writes_manifest(self) -> bool:
        """One writer of ``session.json`` on a real pod: the coordinator
        (every rank keeps the same rows in memory)."""
        return self.pod is None or not self.pod.real \
            or self.pod.is_coordinator

    # --- manifest -----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if isinstance(m, dict) and isinstance(m.get("snapshots"), list):
                return m
        except (OSError, ValueError):
            pass
        return {"format_version": _MANIFEST_VERSION, "snapshots": []}

    def _write_manifest(self) -> None:
        # temp + replace, as write_model: the manifest is the resume
        # authority and must never be half-written
        tmp = f"{self._manifest_path()}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._manifest, f, indent=1)
            os.replace(tmp, self._manifest_path())
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def snapshots(self) -> list:
        """Manifest rows for snapshots whose file still exists."""
        return [s for s in self._manifest["snapshots"]
                if os.path.exists(os.path.join(self.directory, s["file"]))]

    # --- snapshot -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Write one durable snapshot now (atomic zip, or pod shards, and a
        manifest row with the content digest and the iterator position).
        Returns the manifest entry. On a real pod every rank calls it."""
        from deeplearning4j_tpu_torch.optimize import checkpoint as ckpt
        from deeplearning4j_tpu_torch.resilience import pod as pod_mod
        from deeplearning4j_tpu_torch.util import serializer

        t = self._trainer()
        if t is not None:
            # gather-on-save: ZeRO's updater slices back to full trees
            # (a collective: every rank is here on the same step)
            t.sync_model()
        m = self._net
        if self.pod is not None:
            dname = f"pod_iter{int(m.iteration):08d}"
            args = (pod_mod.write_pod_snapshot, m,
                    os.path.join(self.directory, dname), self.pod)
            kw = dict(batch_in_epoch=int(self._batch_in_epoch),
                      rng_key=_rng_key(m))
            if not self.pod.real:
                self.retry.call(*args, op="checkpoint.write", **kw)
            else:
                # a real pod's write holds barriers: a retry on one rank
                # would re-enter them while the others wait at the next;
                # a failed collective snapshot propagates instead
                args[0](*args[1:], **kw)
            entry = {
                "file": dname,
                "pod": True,
                "n_hosts": self.pod.n_hosts,
                "iteration": int(m.iteration),
                "epoch": int(m.epoch),
                "batch_in_epoch": int(self._batch_in_epoch),
            }
        else:
            fname = f"session_iter{int(m.iteration):08d}.zip"
            path = os.path.join(self.directory, fname)
            # stored, not deflated: a resume point's write time counts,
            # and both packages read either kind of zip
            self.retry.call(serializer.write_model, m, path, compress=False,
                            op="checkpoint.write")
            entry = {
                "file": fname,
                "digest": serializer.file_digest(path),
                "iteration": int(m.iteration),
                "epoch": int(m.epoch),
                "batch_in_epoch": int(self._batch_in_epoch),
            }
        snaps = [s for s in self._manifest["snapshots"]
                 if s["file"] != entry["file"]] + [entry]
        self._manifest["snapshots"] = snaps[-max(self.keep_last, 2):]
        self._manifest["rng_key"] = _rng_key(m)
        if self._writes_manifest():
            self._write_manifest()
            self._prune(snaps)
        if self.pod is not None:
            # no rank reads session.json before the coordinator wrote it
            pod_mod._pod_barrier(self.pod)
        self._mem = ckpt.snapshot_training_state(m)
        self._mem_entry = dict(entry)
        return entry

    def _prune(self, all_snaps: list) -> None:
        import shutil

        keep = {s["file"] for s in self._manifest["snapshots"]}
        for s in all_snaps:
            if s["file"] in keep:
                continue
            p = os.path.join(self.directory, s["file"])
            if os.path.exists(p):
                try:
                    # pod snapshots are directories of shard files
                    shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
                except OSError:
                    pass  # retention is best-effort; resume only needs keep

    # --- resume -------------------------------------------------------------
    def resume(self, scope: str = "job"):
        """Restore the newest loadable snapshot (digest-verified; a
        corrupt or truncated one falls back to the previous one, then to
        the in-memory last-good). Pod snapshots verify every host shard;
        a partial one is skipped with its ``PodSnapshotIncompleteError``
        reason logged. Counts ``dl4j_resumes_total{scope=...}``
        (``"host"`` when a pod host died, ``"job"`` otherwise)."""
        from deeplearning4j_tpu_torch import telemetry
        from deeplearning4j_tpu_torch.optimize import checkpoint as ckpt
        from deeplearning4j_tpu_torch.util import serializer

        self._manifest = self._read_manifest()
        net = self._net
        device = net.device if net is not None else self.device
        listeners = list(getattr(net, "listeners", []) or [])
        snaps = self._manifest["snapshots"]
        restored, entry = None, None
        if any(s.get("pod") for s in snaps):
            restored, entry = self._resume_pod_walk(snaps, device)
        else:
            restored, idx, _ = serializer.restore_newest_verified(
                [(os.path.join(self.directory, s["file"]),
                  s.get("digest", "")) for s in snaps],
                lambda p: serializer.restore_model(p, device=device))
            entry = snaps[idx] if restored is not None else None
        if restored is None and self._mem is not None and net is not None:
            ckpt.restore_training_state(net, self._mem)
            restored, entry = net, self._mem_entry
        if restored is None:
            raise FileNotFoundError(
                f"no loadable snapshot in {self.directory}")
        key = self._manifest.get("rng_key")
        if key is not None and list(key) != _rng_key(restored):
            raise ValueError(
                f"session.json's rng_key {key} is not the restored "
                f"configuration's seed {_rng_key(restored)}: a resumed run "
                "would draw other dropout masks")
        if listeners and not getattr(restored, "listeners", None):
            restored.listeners = listeners
        trainer = self._trainer()
        if trainer is not None:
            # the wrapper re-stages (re-scatters ZeRO's slices) from the
            # restored model on its next run
            trainer.model = restored
            trainer._residual = None
            trainer._hooks = None
            trainer._synced = True
            trainer._setup_done = False
        else:
            self.model = restored
        self._batch_in_epoch = int((entry or {}).get("batch_in_epoch", 0))
        telemetry.record_resume(scope=scope)
        return restored

    def _resume_pod_walk(self, snaps, device):
        """Newest-first walk over pod snapshot rows: a partial snapshot is
        SKIPPED with its reason in the log and the walk falls back to the
        previous generation. Zip rows interleave (a session switched to
        pod mode keeps its old snapshots restorable)."""
        from deeplearning4j_tpu_torch.resilience import pod as pod_mod
        from deeplearning4j_tpu_torch.util import serializer

        for s in reversed(snaps):
            path = os.path.join(self.directory, s["file"])
            if s.get("pod"):
                try:
                    net, _ = pod_mod.restore_pod_snapshot(path, self.pod,
                                                          device)
                    return net, s
                except pod_mod.PodSnapshotIncompleteError as e:
                    logger.warning("skipping pod snapshot %s: %s",
                                   s["file"], e.reason)
                    continue
            restored, _, _ = serializer.restore_newest_verified(
                [(path, s.get("digest", ""))],
                lambda p: serializer.restore_model(p, device=device))
            if restored is not None:
                return restored, s
        return None, None

    # --- training -----------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1,
            batch_size: Optional[int] = None,
            to_epoch: Optional[int] = None):
        """Train to ``model.epoch + epochs`` — ``epochs`` is RELATIVE to
        the resumed position — snapshotting periodically and auto-resuming
        on resumable failure. A restart that must finish the ORIGINAL
        run's budget passes the absolute ``to_epoch``: ``fit(it,
        to_epoch=3)`` trains to epoch 3 wherever the snapshot left off.
        The data order must be deterministic across replays (it is, for
        the port's iterators)."""
        from deeplearning4j_tpu_torch.nn.multilayer import _as_iterator
        from deeplearning4j_tpu_torch.resilience import pod as pod_mod

        if self.model is None:
            self.resume()
        net = self._net
        if net.params is None:
            net.init()
        if labels is None and hasattr(data, "reset") \
                and hasattr(data, "__iter__"):
            iterator = data
        else:
            iterator = _as_iterator(data, labels, batch_size)
        trainer = self._trainer()
        if trainer is not None and trainer.fused_steps > 1:
            from deeplearning4j_tpu_torch.datasets.prefetch import (
                StackBatchIterator,
            )

            # one stacked item is one super-step, so the position counts
            # super-steps and a kill replays a super-step whole
            iterator = StackBatchIterator(iterator, trainer.fused_steps)
        target_epoch = int(to_epoch) if to_epoch is not None \
            else int(net.epoch) + int(epochs)
        restarts_this_fit = 0
        while True:
            try:
                return self._run(iterator, target_epoch)
            except self.resumable as e:
                restarts_this_fit += 1
                if restarts_this_fit > self.max_restarts:
                    raise
                self.restarts += 1  # counts resumes performed
                # host scope: one pod host died and the whole job resumes
                # from the last distributed snapshot; job scope: the
                # whole process failed
                self.resume(scope="host"
                            if isinstance(e, pod_mod.HostDeathError)
                            else "job")

    def _run(self, iterator, target_epoch: int):
        import weakref

        from deeplearning4j_tpu_torch import telemetry

        telemetry.host_gap_reset()
        if self.pod is not None:
            telemetry.record_pod_hosts(self.pod.n_hosts)
        trainer = self._trainer()
        if trainer is not None:
            # stage (or RE-stage after a resume) and arm the
            # gather-on-save hook before the pre-first-step snapshot
            trainer._setup()
            trainer._mp_target = None
            self._net._live_trainer = weakref.ref(trainer)
        try:
            if not self.snapshots():
                # a pre-first-step snapshot: a kill before the first
                # periodic snapshot still resumes (from iteration 0)
                self.snapshot()
            self._run_epochs(iterator, target_epoch)
        finally:
            telemetry.host_gap_stop()
            if trainer is not None:
                trainer._write_back()
                self._net._live_trainer = None
        return self.model

    def _heartbeat(self) -> None:
        """The pod's liveness edge, once a batch: the ``pod.heartbeat``
        fault site. On a real pod a host death is every rank's: the ranks
        max-reduce a flag (the dead host's id + 1), so each raises the
        same ``HostDeathError`` and the job resumes together."""
        from deeplearning4j_tpu_torch.resilience import faults
        from deeplearning4j_tpu_torch.resilience import pod as pod_mod

        if not self.pod.real:
            faults.fault_point("pod.heartbeat")
            return
        import torch

        from deeplearning4j_tpu_torch.comms import scheduler

        dead = 0
        try:
            faults.fault_point("pod.heartbeat")
        except pod_mod.HostDeathError as e:
            dead = 1 + (e.host if e.host is not None
                        else self.pod.host_id)
        t = self._trainer()
        dev = self._net.device if (t is None or t.mesh.backend == "nccl") \
            else "cpu"
        flag = torch.tensor([float(dead)], device=dev)
        scheduler.all_reduce(flag, self.pod.group, op="max")
        host = int(flag.item()) - 1
        if host >= 0:
            raise pod_mod.HostDeathError(host=host)

    def _run_epochs(self, iterator, target_epoch: int):
        from deeplearning4j_tpu_torch.telemetry import flightrec

        trainer = self._trainer()
        m = self._net
        with flightrec.flight_recorder(model=m):
            while m.epoch < target_epoch:
                for lst in m.listeners:
                    lst.on_epoch_start(m, m.epoch)
                iterator.reset()
                skip = self._batch_in_epoch
                for i, ds in enumerate(iterator):
                    if i < skip:
                        continue  # replay fast-forward to the crash point
                    if self.pod is not None:
                        self._heartbeat()
                    it_before = m.iteration
                    if trainer is not None:
                        trainer._fit_batch(ds)
                    else:
                        m._fit_batch(ds)
                    self._batch_in_epoch = i + 1
                    # a crossing check: a fused super-step moves the
                    # counter by K an item
                    if self.every_iters \
                            and (m.iteration // self.every_iters
                                 > it_before // self.every_iters):
                        self.snapshot()
                for lst in m.listeners:
                    lst.on_epoch_end(m, m.epoch)
                m.epoch += 1
                self._batch_in_epoch = 0
                self.snapshot()  # epoch boundary: the position resets to 0
        return m
