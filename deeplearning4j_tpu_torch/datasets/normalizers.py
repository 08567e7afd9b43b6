"""Data normalizers.

Reference: ``org.nd4j.linalg.dataset.api.preprocessor.*`` —
``NormalizerStandardize`` (fit mean/std over an iterator, transform/revert),
``NormalizerMinMaxScaler``, ``ImagePreProcessingScaler`` (pixel [0,255] →
[min,max]) and the label-normalizing variants. Fitted normalizers are saved
with the model by the serializer, so they carry a JSON state round-trip.
Copied from the JAX package's ``datasets/normalizers.py`` (numpy only); the
state dicts are the same in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataNormalization:
    """Fit/transform/revert contract (reference ``DataNormalization``)."""

    def fit(self, iterator) -> "DataNormalization":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def transform_features(self, features: np.ndarray) -> np.ndarray:
        ds = DataSet(np.asarray(features), np.zeros((len(features), 0)))
        return self.transform(ds).features

    # --- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> "DataNormalization":
        raise NotImplementedError


def _feature_axes(arr: np.ndarray):
    """All axes except the last = per-feature stats over batch (+time/space).
    Matches the reference's per-feature-column statistics."""
    return tuple(range(arr.ndim - 1))


class NormalizerStandardize(DataNormalization):
    """z-score per feature (reference ``NormalizerStandardize``); optionally
    also normalizes labels (regression use)."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def fit(self, iterator):
        f_sum = f_sumsq = n = None
        l_sum = l_sumsq = ln = None
        for ds in _iter_of(iterator):
            f = np.asarray(ds.features, np.float64)
            f2 = f.reshape(-1, f.shape[-1])
            f_sum = f2.sum(0) if f_sum is None else f_sum + f2.sum(0)
            f_sumsq = ((f2 ** 2).sum(0) if f_sumsq is None
                       else f_sumsq + (f2 ** 2).sum(0))
            n = f2.shape[0] if n is None else n + f2.shape[0]
            if self.fit_labels:
                l = np.asarray(ds.labels, np.float64).reshape(
                    -1, np.asarray(ds.labels).shape[-1])
                l_sum = l.sum(0) if l_sum is None else l_sum + l.sum(0)
                l_sumsq = ((l ** 2).sum(0) if l_sumsq is None
                           else l_sumsq + (l ** 2).sum(0))
                ln = l.shape[0] if ln is None else ln + l.shape[0]
        _reset(iterator)
        self.mean = (f_sum / n).astype(np.float32)
        var = f_sumsq / n - (f_sum / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        if self.fit_labels:
            self.label_mean = (l_sum / ln).astype(np.float32)
            lvar = l_sumsq / ln - (l_sum / ln) ** 2
            self.label_std = np.sqrt(np.maximum(lvar, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds):
        ds.features = ((np.asarray(ds.features) - self.mean) /
                       self.std).astype(np.float32)
        if self.fit_labels and self.label_mean is not None:
            ds.labels = ((np.asarray(ds.labels) - self.label_mean) /
                         self.label_std).astype(np.float32)
        return ds

    def revert(self, ds):
        ds.features = (np.asarray(ds.features) * self.std + self.mean)
        if self.fit_labels and self.label_mean is not None:
            ds.labels = np.asarray(ds.labels) * self.label_std + self.label_mean
        return ds

    def revert_labels(self, labels: np.ndarray) -> np.ndarray:
        if self.label_mean is None:
            return labels
        return np.asarray(labels) * self.label_std + self.label_mean

    def state_dict(self):
        return {"kind": "standardize", "fit_labels": self.fit_labels,
                "mean": _tolist(self.mean), "std": _tolist(self.std),
                "label_mean": _tolist(self.label_mean),
                "label_std": _tolist(self.label_std)}

    def load_state_dict(self, state):
        self.fit_labels = state["fit_labels"]
        self.mean = _fromlist(state["mean"])
        self.std = _fromlist(state["std"])
        self.label_mean = _fromlist(state["label_mean"])
        self.label_std = _fromlist(state["label_std"])
        return self


class NormalizerMinMaxScaler(DataNormalization):
    """Scale features to [min,max] (reference ``NormalizerMinMaxScaler``)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, iterator):
        lo = hi = None
        for ds in _iter_of(iterator):
            f = np.asarray(ds.features, np.float64)
            f2 = f.reshape(-1, f.shape[-1])
            cur_lo, cur_hi = f2.min(0), f2.max(0)
            lo = cur_lo if lo is None else np.minimum(lo, cur_lo)
            hi = cur_hi if hi is None else np.maximum(hi, cur_hi)
        _reset(iterator)
        self.data_min = lo.astype(np.float32)
        self.data_max = hi.astype(np.float32)
        return self

    def _scale(self):
        rng = self.data_max - self.data_min
        return np.where(rng == 0, 1.0, rng)

    def transform(self, ds):
        frac = (np.asarray(ds.features) - self.data_min) / self._scale()
        ds.features = (self.min_range +
                       frac * (self.max_range - self.min_range)).astype(np.float32)
        return ds

    def revert(self, ds):
        frac = ((np.asarray(ds.features) - self.min_range) /
                (self.max_range - self.min_range))
        ds.features = frac * self._scale() + self.data_min
        return ds

    def state_dict(self):
        return {"kind": "minmax", "min_range": self.min_range,
                "max_range": self.max_range,
                "data_min": _tolist(self.data_min),
                "data_max": _tolist(self.data_max)}

    def load_state_dict(self, state):
        self.min_range = state["min_range"]
        self.max_range = state["max_range"]
        self.data_min = _fromlist(state["data_min"])
        self.data_max = _fromlist(state["data_max"])
        return self


class ImagePreProcessingScaler(DataNormalization):
    """Pixel [0, 2^bits−1] → [min,max]; no fitting needed (reference
    ``ImagePreProcessingScaler``)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_bits: int = 8):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(2 ** max_bits - 1)

    def fit(self, iterator):
        return self

    def transform(self, ds):
        frac = np.asarray(ds.features, np.float32) / self.max_pixel
        ds.features = self.min_range + frac * (self.max_range - self.min_range)
        return ds

    def revert(self, ds):
        frac = ((np.asarray(ds.features) - self.min_range) /
                (self.max_range - self.min_range))
        ds.features = frac * self.max_pixel
        return ds

    def state_dict(self):
        return {"kind": "image_scaler", "min_range": self.min_range,
                "max_range": self.max_range, "max_pixel": self.max_pixel}

    def load_state_dict(self, state):
        self.min_range = state["min_range"]
        self.max_range = state["max_range"]
        self.max_pixel = state["max_pixel"]
        return self


_KINDS = {"standardize": NormalizerStandardize,
          "minmax": NormalizerMinMaxScaler,
          "image_scaler": ImagePreProcessingScaler}


def normalizer_from_state(state: dict) -> DataNormalization:
    """Restore any normalizer from its ``state_dict`` (serializer hook)."""
    return _KINDS[state["kind"]]().load_state_dict(state)


def _iter_of(iterator):
    if isinstance(iterator, DataSet):
        return [iterator]
    return iterator


def _reset(iterator):
    if hasattr(iterator, "reset"):
        iterator.reset()


def _tolist(a):
    return None if a is None else np.asarray(a).tolist()


def _fromlist(v):
    return None if v is None else np.asarray(v, np.float32)
