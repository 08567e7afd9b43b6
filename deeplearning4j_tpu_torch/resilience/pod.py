"""Pod-grade distributed snapshots + preemption.

Counterpart of the JAX package's ``resilience/pod.py``, with the same
files, so a pod snapshot written by either package restores in the other
bit for bit.

A pod checkpoint is not one zip: every host writes ITS OWN shard of the
training state — params and updater state cut flat across hosts by the
same :class:`~deeplearning4j_tpu_torch.sharding.zero.ZeroSpec` layout the
ZeRO exchange uses (component padded to ``n * m``, host ``h`` owns
``[h*m, (h+1)*m)``) — so snapshot bandwidth and disk I/O scale out with
the pod instead of funneling through one coordinator. The components are
the ModelSerializer zip's vectors (``coefficients``, ``updaterState``:
the JAX package's flat order and layouts).

Commit protocol (a crash anywhere leaves the PRIOR complete snapshot
authoritative)::

    1. each host:  shard_h{h}.npz       temp + os.replace, per-shard
                                        sha256 recorded in...
    2. each host:  host_h{h}.json       ...its host manifest
                                        (temp + os.replace)
    3. barrier     (real pods: torch.distributed.barrier on the pod's
                   group; emulated pods: the loop)
    4. host 0:     state.npz + manifest.json   the COORDINATOR manifest,
                   written only after every host manifest is durable
                   and digest-recorded — this os.replace IS the commit

A snapshot without a committed coordinator manifest, with a missing or
digest-mismatched shard, or whose coordinator manifest no longer matches
its host manifests (staleness) is never selected:
:func:`verify_pod_snapshot` raises :class:`PodSnapshotIncompleteError`
with the SPECIFIC reason, and ``TrainingSession`` falls back newest-first
logging it.

Restore concatenates the hosts' slices (each shard digest-verified): the
full vectors whatever pod shape restores them, so a restore across pod
shapes is the same bits (the JAX package re-cuts through its
``comms.reshard`` where it has the devices, to the same bits; the port's
device re-cut waits for ``comms/reshard.py``).

Real and emulated pods: on ``torch.distributed`` ranks (world > 1) each
rank is one host and writes its own shard; in one process,
``PodConfig(n_hosts=N)`` makes this process play every host — the same
shard files, manifests, commit order and fault sites
(``snapshot.shard_write``, ``pod.heartbeat``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.resilience.faults import fault_point

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


class PodSnapshotIncompleteError(RuntimeError):
    """A pod snapshot directory that must NOT be restored from, with the
    specific reason (uncommitted coordinator manifest, missing host
    manifest / shard, shard digest mismatch, stale coordinator manifest).
    ``TrainingSession`` resume logs the reason and falls back to the
    previous snapshot."""

    def __init__(self, directory: str, reason: str):
        super().__init__(f"pod snapshot {directory!r} unusable: {reason}")
        self.directory = str(directory)
        self.reason = reason


class HostDeathError(RuntimeError):
    """One pod host died (preemption, hardware loss). Resumable by default
    in :class:`~deeplearning4j_tpu_torch.resilience.session.
    TrainingSession`: the whole job resumes from the last complete
    distributed snapshot — host scope, counted as
    ``dl4j_resumes_total{scope="host"}``. A ``FaultPlan`` raises it at
    the ``pod.heartbeat`` site::

        plan = FaultPlan(seed=7)
        plan.inject("pod.heartbeat", on_calls=[3],
                    exc=lambda: HostDeathError(host=1))
    """

    def __init__(self, host: Optional[int] = None, message: str = None):
        super().__init__(message or
                         f"pod host {host if host is not None else '?'} "
                         f"died (preemption)")
        self.host = host


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class PodConfig:
    """The pod shape one process sees.

    - **Real pod** (``torch.distributed`` initialized with world > 1):
      ``n_hosts`` defaults to the world size (and must equal it),
      ``host_id`` to this rank; each rank writes its own shard, and the
      commit's barriers run on ``group`` (None: the default group; pass
      the ``ParallelWrapper``'s).
    - **Emulated pod** (one process, ``n_hosts > 1``): this process plays
      every host — same files, same order, same fault sites.
    """

    def __init__(self, n_hosts: Optional[int] = None,
                 host_id: Optional[int] = None, group=None):
        dist = _dist()
        procs = dist.get_world_size(group) if dist is not None else 1
        self.group = group
        self.n_hosts = int(n_hosts) if n_hosts else procs
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if procs > 1 and self.n_hosts != procs:
            raise ValueError(
                f"n_hosts={self.n_hosts} must equal the process count "
                f"{procs} on a real pod (each process is one host)")
        rank = dist.get_rank(group) if dist is not None else 0
        self.host_id = int(host_id) if host_id is not None else rank
        if not 0 <= self.host_id < self.n_hosts:
            raise ValueError(
                f"host_id {self.host_id} outside [0, {self.n_hosts})")
        self.emulated = procs == 1 and self.n_hosts > 1
        self._procs = procs

    def hosts_here(self):
        """Host ids THIS process writes shards for: every host when
        emulated (or trivially pod-of-one), else exactly its own."""
        if self.emulated or self._procs == 1:
            return range(self.n_hosts)
        return (self.host_id,)

    @property
    def is_coordinator(self) -> bool:
        return self.emulated or self.host_id == 0

    @property
    def real(self) -> bool:
        return self._procs > 1

    def __repr__(self):
        mode = "emulated" if self.emulated else "real"
        return (f"PodConfig(n_hosts={self.n_hosts}, "
                f"host_id={self.host_id}, {mode})")


# --------------------------------------------------------------------------
# layout + shard mechanics
# --------------------------------------------------------------------------

def _components(model) -> dict:
    """The flat host vectors a bit-exact resume needs, in the serializer's
    order and layouts: ``coefficients`` (params) and ``updaterState``.
    Layer runtime state (BN running statistics) is small and rides the
    coordinator commit as ``state.npz``."""
    from deeplearning4j_tpu_torch.util import params as params_util

    comps = {"coefficients": np.asarray(model.params_flat())}
    if model.opt_state:
        comps["updaterState"] = np.asarray(
            params_util.flatten_state_like(model.conf, model.opt_state))
    return comps


def _zero_spec(comps: dict, n_hosts: int):
    """The per-host cut of every component: a
    :class:`~deeplearning4j_tpu_torch.sharding.zero.ZeroSpec` over the
    component tree, the layout the ZeRO exchange shards optimizer state
    with."""
    import torch

    from deeplearning4j_tpu_torch.sharding.zero import ZeroSpec

    return ZeroSpec({k: torch.from_numpy(v) for k, v in comps.items()},
                    n_hosts)


def _host_slice(flat: np.ndarray, m: int, h: int) -> np.ndarray:
    """Host ``h``'s ``[h*m, (h+1)*m)`` slice, zero-padded at the tail
    (the ZeroSpec padding contract)."""
    out = np.zeros((m,), flat.dtype)
    lo, hi = h * m, min(flat.size, (h + 1) * m)
    if hi > lo:
        out[:hi - lo] = flat[lo:hi]
    return out


def _write_atomic(path: str, writer) -> None:
    """temp + ``os.replace`` with cleanup, as ``serializer.write_model``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        writer(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _dump_json(obj, tmp: str) -> None:
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)


def shard_name(h: int) -> str:
    return f"shard_h{h:03d}.npz"


def host_manifest_name(h: int) -> str:
    return f"host_h{h:03d}.json"


def write_pod_snapshot(model, directory: str, pod: PodConfig,
                       batch_in_epoch: int = 0, rng_key=None) -> dict:
    """Write one distributed snapshot of ``model`` into ``directory``
    following the commit protocol in the module docstring. Returns the
    coordinator manifest (None on the other hosts of a real pod). On a
    real pod every rank calls this collectively, with the full model (a
    ZeRO wrapper's ``sync_model`` first)."""
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.util.convert import params_to_jax
    from deeplearning4j_tpu_torch.util.serializer import file_digest

    t_start = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    comps = _components(model)
    spec = _zero_spec(comps, pod.n_hosts)
    names = sorted(comps)                  # the JAX dict-flatten order
    iteration = int(model.iteration)
    epoch = int(model.epoch)

    for h in pod.hosts_here():
        t0 = time.perf_counter()
        fname = shard_name(h)
        path = os.path.join(directory, fname)

        def write_shard(tmp, h=h):
            payload = {name: _host_slice(comps[name], m, h)
                       for name, m in zip(names, spec.slice_sizes)}
            with open(tmp, "wb") as f:
                # mid-write injection site: a raise here IS a partial
                # shard — the temp holds some bytes, the publish never
                # happens, no host manifest references it, and the
                # coordinator manifest is never committed
                fault_point("snapshot.shard_write")
                np.savez(f, **payload)

        _write_atomic(path, write_shard)
        nbytes = os.path.getsize(path)
        hman = {
            "format_version": _FORMAT_VERSION,
            "host": h,
            "n_hosts": pod.n_hosts,
            "iteration": iteration,
            "epoch": epoch,
            "shards": [{"file": fname, "sha256": file_digest(path),
                        "bytes": nbytes}],
        }
        _write_atomic(
            os.path.join(directory, host_manifest_name(h)),
            lambda tmp, hman=hman: _dump_json(hman, tmp))
        telemetry.record_pod_shard(h, nbytes, time.perf_counter() - t0)

    _pod_barrier(pod)
    manifest = None
    if pod.is_coordinator:
        hosts = []
        for h in range(pod.n_hosts):
            hpath = os.path.join(directory, host_manifest_name(h))
            if not os.path.exists(hpath):
                raise PodSnapshotIncompleteError(
                    directory, f"host manifest {host_manifest_name(h)} "
                               f"missing at commit time")
            hosts.append({"file": host_manifest_name(h),
                          "sha256": file_digest(hpath)})
        state_digest = ""
        if model.state:
            spath = os.path.join(directory, "state.npz")
            _, state = params_to_jax(model.conf, {}, model.state)

            def write_state(tmp):
                flat = {f"{k}/{name}": np.asarray(v)
                        for k, d in state.items() for name, v in d.items()}
                with open(tmp, "wb") as f:
                    np.savez(f, **flat)

            _write_atomic(spath, write_state)
            state_digest = file_digest(spath)
        manifest = {
            "format_version": _FORMAT_VERSION,
            "n_hosts": pod.n_hosts,
            "iteration": iteration,
            "epoch": epoch,
            "batch_in_epoch": int(batch_in_epoch),
            "model_class": getattr(model, "model_class",
                                   type(model).__name__),
            "configuration": model.conf.to_json(),
            "components": {
                name: {"size": int(size),
                       "dtype": str(comps[name].dtype)}
                for name, size in zip(names, spec.sizes)},
            "state_digest": state_digest,
            "hosts": hosts,
        }
        if rng_key is not None:
            manifest["rng_key"] = [int(v) for v in
                                   np.asarray(rng_key).ravel()]
        # THE commit: everything above is invisible to restore until this
        # replace lands
        _write_atomic(os.path.join(directory, MANIFEST),
                      lambda tmp: _dump_json(manifest, tmp))
    _pod_barrier(pod)
    telemetry.record_pod_snapshot_seconds(time.perf_counter() - t_start)
    telemetry.record_pod_hosts(pod.n_hosts)
    return manifest


def _pod_barrier(pod: PodConfig) -> None:
    """Real pods synchronize between the host-manifest and coordinator-
    commit phases (no host may observe a committed manifest whose own
    shard is still in flight); emulated pods are sequential — the loop IS
    the barrier."""
    if not pod.real:
        return
    _dist().barrier(group=pod.group)


# --------------------------------------------------------------------------
# verification + restore
# --------------------------------------------------------------------------

def verify_pod_snapshot(directory: str) -> dict:
    """Full integrity walk of one pod snapshot directory — coordinator
    manifest committed, every host manifest present and matching the
    digest the coordinator recorded (staleness check), every shard file
    present with its recorded sha256, host / coordinator counters
    agreeing. Returns the coordinator manifest; raises
    :class:`PodSnapshotIncompleteError` naming the first violation."""
    from deeplearning4j_tpu_torch.util.serializer import file_digest

    if not os.path.isdir(directory):
        raise PodSnapshotIncompleteError(directory,
                                         "snapshot directory missing")
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.exists(mpath):
        raise PodSnapshotIncompleteError(
            directory, "uncommitted coordinator manifest (crash before "
                       "the commit point)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise PodSnapshotIncompleteError(
            directory, f"unreadable coordinator manifest ({e})") from e
    if not isinstance(manifest.get("hosts"), list) \
            or "components" not in manifest:
        raise PodSnapshotIncompleteError(
            directory, "malformed coordinator manifest")
    for hrow in manifest["hosts"]:
        hname = hrow["file"]
        hpath = os.path.join(directory, hname)
        if not os.path.exists(hpath):
            raise PodSnapshotIncompleteError(
                directory, f"missing host manifest {hname}")
        if hrow.get("sha256") and file_digest(hpath) != hrow["sha256"]:
            raise PodSnapshotIncompleteError(
                directory, f"stale coordinator manifest: host manifest "
                           f"{hname} does not match the digest recorded "
                           f"at commit")
        try:
            with open(hpath) as f:
                hman = json.load(f)
        except (OSError, ValueError) as e:
            raise PodSnapshotIncompleteError(
                directory, f"unreadable host manifest {hname} "
                           f"({e})") from e
        if int(hman.get("iteration", -1)) != int(manifest["iteration"]):
            raise PodSnapshotIncompleteError(
                directory, f"stale coordinator manifest: host manifest "
                           f"{hname} is from iteration "
                           f"{hman.get('iteration')}, coordinator says "
                           f"{manifest['iteration']}")
        for srow in hman.get("shards", []):
            spath = os.path.join(directory, srow["file"])
            if not os.path.exists(spath):
                raise PodSnapshotIncompleteError(
                    directory, f"missing shard file {srow['file']} "
                               f"(host {hman.get('host')})")
            if file_digest(spath) != srow["sha256"]:
                raise PodSnapshotIncompleteError(
                    directory, f"shard digest mismatch in "
                               f"{srow['file']} (host "
                               f"{hman.get('host')})")
    sd = manifest.get("state_digest", "")
    if sd:
        spath = os.path.join(directory, "state.npz")
        if not os.path.exists(spath):
            raise PodSnapshotIncompleteError(directory,
                                             "missing state.npz")
        if file_digest(spath) != sd:
            raise PodSnapshotIncompleteError(directory,
                                             "state.npz digest mismatch")
    return manifest


def _aggregate_flat(slices, size: int) -> np.ndarray:
    """Host slices (the saving pod's layout) -> the full logical vector:
    their concatenation, cut to ``size``. The full vector does not depend
    on the restoring pod's shape; a restoring ZeRO wrapper re-scatters it
    onto its own ranks in its set-up."""
    return (np.concatenate(slices) if len(slices) > 1 else slices[0])[:size]


def restore_pod_snapshot(directory: str, pod: Optional[PodConfig] = None,
                         device="cuda"):
    """Digest-verified restore of one pod snapshot: every host's shards
    concatenated back into the full flat components, the network rebuilt
    from the recorded configuration on ``device``; returns ``(net,
    manifest)``. ``pod``: the restoring pod (any shape; the full vectors
    are the same bits). Raises :class:`PodSnapshotIncompleteError` when
    the snapshot is partial."""
    import torch

    from deeplearning4j_tpu_torch import serde, telemetry
    from deeplearning4j_tpu_torch.util import params as params_util

    t0 = time.perf_counter()
    manifest = verify_pod_snapshot(directory)
    n_saved = int(manifest["n_hosts"])
    comps = {}
    per_host = [np.load(os.path.join(directory, shard_name(h)))
                for h in range(n_saved)]
    try:
        for name, meta in manifest["components"].items():
            slices = [np.asarray(ph[name]) for ph in per_host]
            comps[name] = _aggregate_flat(
                slices, int(meta["size"])).astype(meta["dtype"])
    finally:
        for ph in per_host:
            ph.close()

    conf = serde.from_json(manifest["configuration"])
    if manifest.get("model_class") == "ComputationGraph" \
            or type(conf).__name__ == "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        net = ComputationGraph(conf, device)
    else:
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        net = MultiLayerNetwork(conf, device)
    net.init()
    net.set_params_flat(comps["coefficients"])
    if "updaterState" in comps and net.opt_state:
        params_util.unflatten_state_like(net.conf, comps["updaterState"],
                                         net.opt_state)
    if manifest.get("state_digest"):
        with np.load(os.path.join(directory, "state.npz")) as data:
            for key in data.files:
                layer, name = key.split("/", 1)
                with torch.no_grad():
                    net.state[layer][name].copy_(
                        torch.from_numpy(data[key]))
    net.iteration = int(manifest["iteration"])
    net.epoch = int(manifest["epoch"])
    telemetry.record_pod_restore_seconds(time.perf_counter() - t0)
    return net, manifest
