"""Checkpointing.

Reference: ``org.deeplearning4j.optimize.listeners.CheckpointListener``;
counterpart of the JAX package's ``optimize/checkpoint.py``: periodic
model zips (every N iterations, epochs or seconds) with retention
(keep-last-N, keep-every-N), ``checkpoint.csv`` as the numbering authority,
digest-verified loads, and the in-process snapshot the health layer rolls
back to. The checkpoint is the ModelSerializer zip (``util.serializer``:
config, params, updater state, BN state, counters), the same archive the
JAX package writes, so a resume is exact and a zip restores in either
package.

The port updates params IN PLACE (``optimize.solver``), so a reference to
a parameter tensor held across a training step silently goes stale: every
snapshot here is a host copy taken before the next step can run.
"""

from __future__ import annotations

import concurrent.futures
import csv
import os
import re
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util import serializer


def _host_copy(tree):
    """A numpy copy of every tensor of a nested dict (bfloat16 as float32,
    which numpy lacks); never a view of the live storage."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.cpu().numpy(), copy=True)


def snapshot_training_state(model) -> dict:
    """Host copy of everything an exact in-process resume needs: params,
    layer state, updater state and counters, as numpy arrays in the port's
    layouts. The copies are taken now (a device copy waits for the card),
    so a later in-place step never reaches them."""
    return {
        "params": _host_copy(model.params),
        "state": _host_copy(model.state),
        "opt_state": _host_copy(model.opt_state),
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
    }


def restore_training_state(model, snap: dict) -> None:
    """Inverse of :func:`snapshot_training_state`: fresh device copies of
    the snapshot on the model (the snapshot stays valid for repeated
    rollbacks), and the counters rewound, so learning-rate schedules and
    dropout draws replay exactly."""
    model.set_params(snap["params"], snap["state"], snap["opt_state"])
    model.iteration = int(snap["iteration"])
    model.epoch = int(snap["epoch"])
    model._score = None  # it reflected the rolled-back step


class Checkpoint:
    """One row of ``checkpoint.csv`` (reference ``Checkpoint``). ``digest``
    (sha256 of the zip, recorded at save time) is empty for rows written
    without it; those load unverified."""

    def __init__(self, number: int, timestamp: float, iteration: int,
                 epoch: int, filename: str, digest: str = ""):
        self.number = int(number)
        self.timestamp = float(timestamp)
        self.iteration = int(iteration)
        self.epoch = int(epoch)
        self.filename = filename
        self.digest = digest


class CheckpointListener(TrainingListener):
    """Save-every-N listener with retention (reference
    ``CheckpointListener.Builder``)::

        CheckpointListener(dir, save_every_n_epochs=1, keep_last=3)
        CheckpointListener(dir, save_every_n_iterations=500, keep_mod=5)

    ``keep_last``: only the newest N zips survive; ``keep_mod``: every
    ``keep_mod``-th checkpoint is also kept for good (reference
    ``keepLastAndEvery``). The default keeps everything. The loads build
    the network on ``device`` ("cuda" unless the caller asks for the
    CPU)."""

    def __init__(self, directory: str,
                 save_every_n_epochs: Optional[int] = None,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_seconds: Optional[float] = None,
                 keep_last: Optional[int] = None,
                 keep_mod: Optional[int] = None,
                 delete_existing: bool = False):
        if not any((save_every_n_epochs, save_every_n_iterations,
                    save_every_n_seconds)):
            raise ValueError("configure at least one save frequency")
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._csv = os.path.join(self.directory, "checkpoint.csv")
        if delete_existing:
            for c in self.list_checkpoints():
                os.remove(os.path.join(self.directory, c.filename))
            if os.path.exists(self._csv):
                os.remove(self._csv)
        self.every_epochs = save_every_n_epochs
        self.every_iters = save_every_n_iterations
        self.every_seconds = save_every_n_seconds
        self.keep_last = keep_last
        self.keep_mod = keep_mod
        self._last_save_time = time.monotonic()
        rows = self._read_rows()
        self._count = (max(c.number for c in rows) + 1) if rows else 0

    # --- listener hooks -----------------------------------------------------
    def iteration_done(self, model, iteration, epoch, score):
        if self.every_iters and (iteration + 1) % self.every_iters == 0:
            self._save(model, iteration, epoch)
        elif (self.every_seconds
              and time.monotonic() - self._last_save_time
              >= self.every_seconds):
            self._save(model, iteration, epoch)

    def on_epoch_end(self, model, epoch):
        if self.every_epochs and (epoch + 1) % self.every_epochs == 0:
            self._save(model, model.iteration, epoch)

    # --- mechanics ----------------------------------------------------------
    def _save(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.resilience.retry import (
            CHECKPOINT_RETRY,
        )

        num = self._count
        self._count += 1
        fname = f"checkpoint_{num}_iter_{iteration}_epoch_{epoch}.zip"
        path = os.path.join(self.directory, fname)
        # retried: a transient ENOSPC / EINTR costs a backoff, not the
        # checkpoint (write_model removes its temp file on each attempt)
        CHECKPOINT_RETRY.call(serializer.write_model, model, path,
                              op="checkpoint.write")
        # recorded after the atomic publish: the csv only ever names
        # complete zips, with the digest a load verifies
        rows = self._read_rows() + [Checkpoint(
            num, time.time(), iteration, epoch, fname,
            serializer.file_digest(path))]
        tmp = f"{self._csv}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", newline="") as f:
                w = csv.writer(f)
                for c in rows:
                    w.writerow([c.number, c.timestamp, c.iteration,
                                c.epoch, c.filename, c.digest])
            os.replace(tmp, self._csv)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self._last_save_time = time.monotonic()
        self._apply_retention(rows)

    def _apply_retention(self, rows: List[Checkpoint]):
        if self.keep_last is None:
            return
        rows = [c for c in rows if os.path.exists(
            os.path.join(self.directory, c.filename))]
        keep = {c.number for c in rows[-self.keep_last:]}
        if self.keep_mod:
            keep |= {c.number for c in rows if c.number % self.keep_mod == 0}
        for c in rows:
            if c.number not in keep:
                os.remove(os.path.join(self.directory, c.filename))

    # --- static API (the reference's static helpers) ------------------------
    def _read_rows(self) -> List[Checkpoint]:
        """Every row ever written (retention-deleted ones too): the
        numbering authority."""
        if not os.path.exists(self._csv):
            return []
        with open(self._csv, newline="") as f:
            return [Checkpoint(*row) for row in csv.reader(f) if row]

    def list_checkpoints(self) -> List[Checkpoint]:
        """The checkpoints whose zip still exists, oldest first."""
        return [c for c in self._read_rows() if os.path.exists(
            os.path.join(self.directory, c.filename))]

    def last_checkpoint(self) -> Optional[Checkpoint]:
        cps = self.list_checkpoints()
        return cps[-1] if cps else None

    def verify(self, cp: Checkpoint) -> bool:
        """Whether ``cp``'s zip matches the digest recorded at save time
        (a row without a digest passes unverified)."""
        path = os.path.join(self.directory, cp.filename)
        if not os.path.exists(path):
            return False
        return not cp.digest or serializer.file_digest(path) == cp.digest

    def _restore_chain(self, number, restore_fn):
        """Digest-verified restore, falling back to the newest checkpoint
        that verifies and loads; an explicit ``number`` takes exactly that
        one or raises."""
        cps = self.list_checkpoints()
        if not cps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if number is not None:
            cp = next(c for c in cps if c.number == number)
            if not self.verify(cp):
                raise OSError(
                    f"checkpoint {cp.filename} failed digest verification")
            return restore_fn(os.path.join(self.directory, cp.filename))
        restored, _, last_err = serializer.restore_newest_verified(
            [(os.path.join(self.directory, c.filename), c.digest)
             for c in cps], restore_fn)
        if restored is None:
            raise FileNotFoundError(
                f"no loadable checkpoint in {self.directory} "
                f"({len(cps)} present, all corrupt or truncated)") \
                from last_err
        return restored

    def load_checkpoint(self, number: Optional[int] = None, device="cuda"):
        """A MultiLayerNetwork restored from checkpoint ``number`` (default:
        the newest that verifies and loads)."""
        return self._restore_chain(
            number, lambda p: serializer.restore_multi_layer_network(
                p, device=device))

    def load_checkpoint_graph(self, number: Optional[int] = None,
                              device="cuda"):
        """A ComputationGraph restored from checkpoint ``number``."""
        return self._restore_chain(
            number, lambda p: serializer.restore_computation_graph(
                p, device=device))


def _snapshot_model(model):
    """What ``serializer.write_model`` reads of a network, from a host
    snapshot taken now: the zip can then be written on another thread
    while training goes on."""
    from deeplearning4j_tpu_torch.util import params as params_util

    snap = snapshot_training_state(model)
    params = {k: {n: torch.from_numpy(a) for n, a in vp.items()}
              for k, vp in snap["params"].items()}
    conf = model.conf
    return SimpleNamespace(
        conf=conf, params=params,
        state={k: {n: torch.from_numpy(a) for n, a in vs.items()}
               for k, vs in snap["state"].items()},
        opt_state={k: {p: {n: torch.from_numpy(a) for n, a in st.items()}
                       for p, st in vp.items()}
                   for k, vp in snap["opt_state"].items()},
        iteration=snap["iteration"], epoch=snap["epoch"],
        model_class=type(model).__name__,
        params_flat=lambda: params_util.flatten_params(conf, params))


class AsyncCheckpointListener(TrainingListener):
    """Checkpoints written on a background thread, so the training loop
    does not wait for serialization: every ``save_every_n_iterations``
    steps the listener copies params, state, updater state and counters
    to the host (before the next step can change them in place), and a
    worker thread writes them as the ModelSerializer zip
    ``checkpoint_<iteration>.zip``; ``max_to_keep`` keeps the newest.

    The JAX package's listener of this name writes an Orbax directory of
    pytrees beside ``configuration.json``; this one keeps its surface
    (``save_every_n_iterations``, ``max_to_keep``, ``wait``, ``all_steps``,
    ``restore_latest``) but writes the zip that both packages read, so its
    directory differs from the JAX package's."""

    _NAME = re.compile(r"^checkpoint_(\d+)\.zip$")

    def __init__(self, directory: str, save_every_n_iterations: int = 100,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.every = int(save_every_n_iterations)
        self.max_to_keep = int(max_to_keep)
        self._pool = None  # one writer thread while saves are pending
        self._pending: List[concurrent.futures.Future] = []

    def iteration_done(self, model, iteration, epoch, score):
        if (iteration + 1) % self.every:
            return
        snap = _snapshot_model(model)
        path = os.path.join(self.directory, f"checkpoint_{iteration}.zip")
        for f in [f for f in self._pending if f.done()]:
            f.result()  # a failed earlier save raises here
            self._pending.remove(f)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dl4j-checkpoint")
        self._pending.append(self._pool.submit(self._write, snap, path))

    def _write(self, snap, path):
        serializer.write_model(snap, path)
        for step in self.all_steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory,
                                   f"checkpoint_{step}.zip"))

    def wait(self):
        """Block until every pending save has finished and stop the writer
        thread (call before exit); a failed save raises here."""
        pending, self._pending = self._pending, []
        pool, self._pool = self._pool, None
        try:
            for f in pending:
                f.result()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return self

    def all_steps(self) -> List[int]:
        """The iterations with a checkpoint on disk, ascending."""
        steps = [int(m.group(1)) for m in map(
            self._NAME.match, os.listdir(self.directory)) if m]
        return sorted(steps)

    def restore_latest(self, device="cuda"):
        """The network at the newest step, restored exactly (updater state
        and counters included)."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints in {self.directory}")
        return serializer.restore_model(
            os.path.join(self.directory, f"checkpoint_{steps[-1]}.zip"),
            device=device)
