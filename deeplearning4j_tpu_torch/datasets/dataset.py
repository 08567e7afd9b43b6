"""DataSet containers.

Reference: ``org.nd4j.linalg.dataset.DataSet`` (features + labels +
featuresMask + labelsMask) and ``MultiDataSet`` (lists of each); copied
from the JAX package's ``datasets/dataset.py``. Arrays are host numpy (or
torch tensors) until the network places them on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])


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
