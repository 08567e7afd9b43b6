"""Pretrained weights for the model zoo.

Reference: ``org.deeplearning4j.zoo.ZooModel#initPretrained(PretrainedType)``
and ``DL4JResources``; counterpart of the JAX package's
``zoo/pretrained.py``, with the same cache layout, checksums and
artifact format:

- the artifact IS the ModelSerializer zip (``util.serializer``), so a
  pretrained model is a saved model, and a zip published by either package
  loads in the other;
- the cache is ``$DL4J_TPU_HOME/models/<model_name>_<type>.zip`` with a
  ``.sha256`` sidecar (``DL4J_TPU_HOME`` defaults to
  ``~/.deeplearning4j_tpu``): pointing it at a local directory keeps every
  artifact there;
- every load re-hashes the artifact against its sidecar, and against a
  class-pinned hash (``PRETRAINED_CHECKSUMS``) where the model pins one;
- ``fetch`` downloads a missing artifact from the model's
  ``PRETRAINED_URLS`` entry (no zoo class publishes one, so by default
  nothing is fetched); ``save_pretrained`` is the publish half;
- ``restore_partial`` copies every param whose key and shape match into an
  initialized network: a pretrained backbone under a new head. A
  reference 7x7 ResNet stem loads into the space-to-depth stem's 4x4 slot
  through ``ResNet50.stem_weights_to_s2d``.

``init_pretrained`` / ``load_pretrained`` build the network on ``device``
("cuda" unless the caller asks for the CPU), as ``ModelRegistry.load``
does; the JAX package's take no device.
"""

from __future__ import annotations

import enum
import hashlib
import os
import shutil
import urllib.request
import warnings
from pathlib import Path

import torch

from deeplearning4j_tpu_torch.util import serializer


class PretrainedType(enum.Enum):
    """Reference ``org.deeplearning4j.zoo.PretrainedType``."""

    IMAGENET = "imagenet"
    IMAGENETLARGE = "imagenetlarge"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    SEGMENT = "segment"


def base_directory() -> Path:
    """Reference ``DL4JResources#getBaseDirectory`` (``$DL4J_TPU_HOME``)."""
    root = os.environ.get("DL4J_TPU_HOME",
                          os.path.join(os.path.expanduser("~"),
                                       ".deeplearning4j_tpu"))
    return Path(root)


def model_cache_dir() -> Path:
    return base_directory() / "models"


def artifact_path(model_name: str, ptype: PretrainedType) -> Path:
    return model_cache_dir() / f"{model_name}_{ptype.value}.zip"


def sha256_of(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_pretrained(net, model_name: str, ptype: PretrainedType,
                    save_updater: bool = False) -> Path:
    """Publish a network's weights as a cached pretrained artifact:
    ``<cache>/<model_name>_<type>.zip`` and its ``.sha256`` sidecar."""
    path = artifact_path(model_name, ptype)
    path.parent.mkdir(parents=True, exist_ok=True)
    serializer.write_model(net, path, save_updater=save_updater)
    path.with_suffix(".zip.sha256").write_text(sha256_of(path) + "\n")
    return path


def _verify(path: Path, expected, model_name: str, actual=None) -> None:
    sidecar = path.with_suffix(".zip.sha256")
    if expected is None and not sidecar.exists():
        return  # nothing to check against: skip the full-file hash
    actual = actual or sha256_of(path)
    if sidecar.exists():
        recorded = sidecar.read_text().strip()
        if actual != recorded:
            raise IOError(
                f"checksum mismatch for {path}: artifact hashes to "
                f"{actual[:16]}… but its sidecar records {recorded[:16]}… "
                "(corrupted download/copy — delete the artifact and "
                "re-fetch; reference: ZooModel#initPretrained checksum "
                "failure)")
    if expected is not None and actual != expected:
        raise IOError(
            f"checksum mismatch for {model_name}: artifact hashes to "
            f"{actual[:16]}… but the model pins {expected[:16]}…")


def _fetch(url: str, dest: Path) -> None:
    """Copy ``url`` to ``dest`` (no proxy: a proxy variable must never
    send a local URL elsewhere)."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url) as src, open(dest, "wb") as out:  # noqa: S310
        shutil.copyfileobj(src, out)


def load_pretrained(model, ptype: PretrainedType = PretrainedType.IMAGENET,
                    fetch: bool = True, load_updater: bool = False,
                    device="cuda"):
    """Core of ``ZooModel#initPretrained``: resolve the cached artifact
    (fetching it by URL if it is missing and the model publishes one),
    verify its checksums and restore the network on ``device``."""
    name = getattr(model, "model_name", None) or type(model).__name__
    if not model.pretrained_available(ptype):
        raise ValueError(
            f"{name} has no pretrained weights for {ptype.name} "
            "(reference: initPretrained throws UnsupportedOperationException)"
        )
    path = artifact_path(name, ptype)
    if not path.exists():
        url = model.pretrained_url(ptype)
        if not (fetch and url):
            raise FileNotFoundError(
                f"no cached artifact at {path} and no fetchable URL; "
                "publish weights locally with zoo.pretrained.save_pretrained"
                "(net, model_name, type) or place the artifact in the cache")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".zip.part")
        try:
            _fetch(url, tmp)
        except Exception as e:
            tmp.unlink(missing_ok=True)
            raise IOError(
                f"could not fetch {name} {ptype.name} weights from {url}: "
                f"{e} (zero-egress environment? pre-populate the cache via "
                f"save_pretrained or copy the artifact to {path})") from e
        tmp.rename(path)
        # the sidecar records the downloaded bytes: it detects later
        # corruption of the cache, not a bad download
        digest = sha256_of(path)
        path.with_suffix(".zip.sha256").write_text(digest + "\n")
        if model.pretrained_checksum(ptype) is None:
            warnings.warn(
                f"{name} {ptype.name}: no pinned checksum for this "
                f"artifact — the download from {url} is trusted on first "
                "use (the .sha256 sidecar only guards against cache "
                "corruption, not a bad fetch). Pin pretrained_checksum() "
                "to remove this trust assumption.", stacklevel=2)
        _verify(path, model.pretrained_checksum(ptype), name, actual=digest)
    else:
        _verify(path, model.pretrained_checksum(ptype), name)
    return serializer.restore_model(path, load_updater=load_updater,
                                    device=device)


def _stem_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """A ``[O, C, 7, 7]`` stem kernel (the port's OIHW) as the
    space-to-depth stem's ``[O, 4C, 4, 4]``: through the JAX package's
    HWIO remap, ``ResNet50.stem_weights_to_s2d``."""
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    hwio = w7.detach().cpu().permute(2, 3, 1, 0).numpy()
    return torch.from_numpy(ResNet50.stem_weights_to_s2d(hwio)).permute(
        3, 2, 0, 1)


def restore_partial(path, net) -> tuple:
    """Copy every param (and layer-state entry) whose layer key, param key
    and shape match from the artifact into ``net`` (already initialized),
    in place on its device. Returns the ``(loaded, skipped)`` key lists,
    as the JAX function names them: ``"<layer>/<param>"`` and
    ``"state:<layer>/<name>"``. The weight surgery behind transfer
    learning with a replaced head."""
    donor = serializer.restore_model(path, load_updater=False, device="cpu")
    loaded, skipped = [], []
    with torch.no_grad():
        for lk, lp in donor.params.items():
            for pk, pv in lp.items():
                tgt = net.params.get(lk, {})
                if pk in tgt and tuple(tgt[pk].shape) != tuple(pv.shape):
                    o, c = pv.shape[:2] if pv.ndim == 4 else (0, 0)
                    if (pk == "W" and pv.ndim == 4
                            and tuple(pv.shape[2:]) == (7, 7)
                            and tuple(tgt[pk].shape) == (o, 4 * c, 4, 4)):
                        tgt[pk].copy_(_stem_to_s2d(pv))
                        loaded.append(f"{lk}/{pk}")
                        continue
                if pk in tgt and tuple(tgt[pk].shape) == tuple(pv.shape):
                    tgt[pk].copy_(pv)
                    loaded.append(f"{lk}/{pk}")
                else:
                    skipped.append(f"{lk}/{pk}")
        for lk, ls in donor.state.items():
            for sk, sv in ls.items():
                tgt = net.state.get(lk, {})
                if sk in tgt and tuple(tgt[sk].shape) == tuple(sv.shape):
                    tgt[sk].copy_(sv)
                    loaded.append(f"state:{lk}/{sk}")
                else:
                    skipped.append(f"state:{lk}/{sk}")
    net._cast_params = None
    return loaded, skipped


class PretrainedMixin:
    """Mixed into ``ZooModel``: the ``initPretrained`` API.

    A model declares its weights available by an entry in
    ``PRETRAINED_URLS`` (type -> URL; an empty URL marks a cache-only
    artifact) and may pin ``PRETRAINED_CHECKSUMS`` (type -> sha256 hex, the
    reference's ``pretrainedChecksum``)."""

    PRETRAINED_URLS: dict = {}
    PRETRAINED_CHECKSUMS: dict = {}

    @property
    def model_name(self) -> str:
        return type(self).__name__

    def pretrained_available(self, ptype: PretrainedType) -> bool:
        """Reference ``ZooModel#pretrainedAvailable``; also true when a
        published artifact is in the cache."""
        return (ptype in self.PRETRAINED_URLS
                or artifact_path(self.model_name, ptype).exists())

    def pretrained_url(self, ptype: PretrainedType):
        """Reference ``ZooModel#pretrainedUrl(type)``."""
        return self.PRETRAINED_URLS.get(ptype) or None

    def pretrained_checksum(self, ptype: PretrainedType):
        """Reference ``ZooModel#pretrainedChecksum(type)``."""
        return self.PRETRAINED_CHECKSUMS.get(ptype)

    def init_pretrained(self, ptype: PretrainedType = PretrainedType.IMAGENET,
                        load_updater: bool = False, device="cuda"):
        """Reference ``ZooModel#initPretrained(type)``: the network with
        the checksum-verified pretrained weights, on ``device``."""
        return load_pretrained(self, ptype, load_updater=load_updater,
                               device=device)
