"""DataSet containers.

Reference: ``org.nd4j.linalg.dataset.DataSet`` (features + labels +
featuresMask + labelsMask) and ``MultiDataSet`` (lists of each); copied
from the JAX package's ``datasets/dataset.py``. Arrays are host numpy (or
torch tensors) until the network places them on its device; ``migrate``
moves them onto a device in place and ``detach`` brings them back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

_FIELDS = ("features", "labels", "features_mask", "labels_mask")


def host_array(a):
    """``a`` as a host numpy array (a torch tensor is copied off its
    device); None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        """``(first n_train examples, the rest)``."""
        a = DataSet(self.features[:n_train], self.labels[:n_train],
                    _slice(self.features_mask, None, n_train),
                    _slice(self.labels_mask, None, n_train))
        b = DataSet(self.features[n_train:], self.labels[n_train:],
                    _slice(self.features_mask, n_train, None),
                    _slice(self.labels_mask, n_train, None))
        return a, b

    def shuffle(self, seed: int | None = None) -> "DataSet":
        """Permute the examples in place with numpy's seeded generator (the
        JAX package's permutation for the same seed)."""
        perm = np.random.default_rng(seed).permutation(self.num_examples())
        for attr in _FIELDS:
            v = getattr(self, attr)
            if v is not None:
                setattr(self, attr, host_array(v)[perm])
        return self

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([host_array(d.features) for d in datasets]),
            np.concatenate([host_array(d.labels) for d in datasets]),
            _cat([d.features_mask for d in datasets]),
            _cat([d.labels_mask for d in datasets]),
        )

    def migrate(self, device="cuda") -> "DataSet":
        """Move every array onto ``device`` in place, as torch tensors
        (reference ``DataSet#migrate``); uint8 features keep their dtype
        (the network dequantizes them on the device). A DataSet reused
        across epochs then crosses to the device once."""
        dev = torch.device(device)
        for attr in _FIELDS:
            v = getattr(self, attr)
            if v is not None:
                t = (v if isinstance(v, torch.Tensor)
                     else torch.as_tensor(np.asarray(v)))
                setattr(self, attr, t.to(dev))
        return self

    def detach(self) -> "DataSet":
        """Back to host numpy (reference ``DataSet#detach``)."""
        for attr in _FIELDS:
            v = getattr(self, attr)
            if v is not None:
                setattr(self, attr, host_array(v))
        return self


def _slice(arr, a, b):
    return None if arr is None else arr[a:b]


def _cat(arrs):
    if any(a is None for a in arrs):
        return None
    return np.concatenate([host_array(a) for a in arrs])


@dataclasses.dataclass
class MultiDataSet:
    """Reference ``org.nd4j.linalg.dataset.MultiDataSet``: multi-input /
    multi-output sample container for ComputationGraph training."""

    features: Sequence[np.ndarray]
    labels: Sequence[np.ndarray]
    features_masks: Optional[Sequence[Optional[np.ndarray]]] = None
    labels_masks: Optional[Sequence[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
