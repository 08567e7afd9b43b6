"""ModelSerializer — checkpoint save/restore, the JAX package's zip.

Reference: ``org.deeplearning4j.util.ModelSerializer``; counterpart of the
JAX package's ``util/serializer.py``, with the same archive, so a zip
written by either package restores in the other:

- ``configuration.json`` — the config DSL JSON (the same ``@type`` tags
  and fields in both packages);
- ``coefficients.npy`` — the flat params vector (``util.params``: the JAX
  package's order and layouts);
- ``updaterState.npy`` — the flat updater state (when saved);
- ``state.npz`` — layer runtime state (BN running statistics), keyed
  ``<layer>/<name>``;
- ``metadata.json`` — iteration and epoch counters, the format version and
  the model class.

``write_model`` is atomic: the zip is assembled in a temp file beside the
target and published with ``os.replace``, so a crash mid-save (the
``checkpoint.write`` fault site) never leaves a truncated archive where the
last good checkpoint was. Restoring builds the network on ``device``
("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util.convert import params_to_jax

FORMAT_VERSION = 1


def file_digest(path) -> str:
    """sha256 of a file's content: the integrity check a checkpoint
    manifest records at save time and verifies before a restore."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def restore_newest_verified(candidates, restore_fn):
    """Try ``candidates`` (``(path, digest)`` pairs, oldest first) newest
    first, skipping any whose file is missing, whose content no longer
    matches its recorded digest (an empty digest skips the check), or that
    ``restore_fn`` fails to open. Returns ``(restored, index,
    last_error)``, or ``(None, -1, err)`` when nothing loads."""
    last_err = None
    for i in range(len(candidates) - 1, -1, -1):
        path, digest = candidates[i]
        if not os.path.exists(path):
            continue
        if digest and file_digest(path) != digest:
            continue
        try:
            return restore_fn(path), i, None
        except Exception as e:  # unreadable despite matching digest
            last_err = e
    return None, -1, last_err


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def _read_npy(z: zipfile.ZipFile, name: str) -> np.ndarray:
    with z.open(name) as f:
        return np.load(io.BytesIO(f.read()))


def live_trainer(net):
    """The data-parallel trainer that owns ``net``'s live training trees
    while its ``fit`` runs (``net._live_trainer``), or None."""
    live = getattr(net, "_live_trainer", None)
    return live() if live is not None else None


def write_model(net, path, save_updater: bool = True,
                compress: bool = True) -> None:
    """Reference ``ModelSerializer#writeModel(net, file, saveUpdater)``.

    Gather-on-save: while a ``ParallelWrapper`` fit owns the live trees
    (ZeRO's scattered updater state, the averaging replicas), they are
    gathered onto ``net`` first, so the zip always holds full, current
    trees. That gather is a collective: every rank calls ``write_model``
    at the same point. ``compress=False`` stores the entries uncompressed
    (a training snapshot, where the write's time counts and deflate costs
    seconds a hundred MB); either zip restores in both packages."""
    trainer = live_trainer(net)
    if trainer is not None:
        trainer.sync_model()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        with zipfile.ZipFile(tmp, "w", method) as z:
            z.writestr("configuration.json", net.conf.to_json())
            z.writestr("coefficients.npy", _npy_bytes(net.params_flat()))
            # a raise here is a partial write: the temp file holds some
            # entries, the publish never happens, the cleanup removes it
            faults.fault_point("checkpoint.write")
            if save_updater and net.opt_state:
                z.writestr("updaterState.npy", _npy_bytes(
                    params_util.flatten_state_like(net.conf, net.opt_state)))
            if net.state:
                buf = io.BytesIO()
                _, state = params_to_jax(net.conf, {}, net.state)
                np.savez(buf, **{f"{k}/{name}": v for k, d in state.items()
                                 for name, v in d.items()})
                z.writestr("state.npz", buf.getvalue())
            z.writestr("metadata.json", json.dumps({
                "format_version": FORMAT_VERSION,
                "iteration": net.iteration,
                "epoch": net.epoch,
                "model_class": getattr(net, "model_class",
                                       type(net).__name__),
            }))
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _restore(net, z: zipfile.ZipFile, load_updater: bool):
    """Fill a freshly initialized ``net`` from the open archive ``z``:
    params, updater state, layer state and counters."""
    net.set_params_flat(_read_npy(z, "coefficients.npy"))
    if load_updater and "updaterState.npy" in z.namelist():
        params_util.unflatten_state_like(
            net.conf, _read_npy(z, "updaterState.npy"), net.opt_state)
    if "state.npz" in z.namelist():
        with z.open("state.npz") as f:
            data = np.load(io.BytesIO(f.read()))
            for key in data.files:
                layer, name = key.split("/", 1)
                with torch.no_grad():
                    net.state[layer][name].copy_(torch.from_numpy(data[key]))
    meta = json.loads(z.read("metadata.json").decode())
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net


def restore_multi_layer_network(path, load_updater: bool = True,
                                device="cuda"):
    """Reference ``ModelSerializer#restoreMultiLayerNetwork``: an exact
    resume (params, updater state, layer state, iteration and epoch)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(Path(path), "r") as z:
        conf = serde.from_json(z.read("configuration.json").decode())
        return _restore(MultiLayerNetwork(conf, device).init(), z,
                        load_updater)


def restore_computation_graph(path, load_updater: bool = True,
                              device="cuda"):
    """Reference ``ModelSerializer#restoreComputationGraph``."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    with zipfile.ZipFile(Path(path), "r") as z:
        conf = serde.from_json(z.read("configuration.json").decode())
        return _restore(ComputationGraph(conf, device).init(), z,
                        load_updater)


def restore_model(path, load_updater: bool = True, device="cuda"):
    """Restore whichever model type the zip holds (by the serialized
    configuration's class)."""
    with zipfile.ZipFile(path) as z:
        kind = json.loads(z.read("configuration.json").decode()).get(
            "@type", "")
    if "ComputationGraph" in kind:
        return restore_computation_graph(path, load_updater, device)
    return restore_multi_layer_network(path, load_updater, device)
