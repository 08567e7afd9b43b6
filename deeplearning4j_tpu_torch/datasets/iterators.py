"""DataSetIterator contract + ``ListDataSetIterator`` and
``ArrayDataSetIterator``.

Reference: ``org.nd4j.linalg.dataset.api.iterator.DataSetIterator`` and
``ListDataSetIterator``; copied from the JAX package's
``datasets/iterators.py``. Iterators yield :class:`DataSet`s of host numpy
arrays. ``ArrayDataSetIterator`` shuffles with numpy's generator seeded by
``seed + epoch``, exactly as the JAX package does, so both packages see the
same batches in the same order for the same seed. It drops the final
partial batch by default (``drop_last``), or pads it with zeroed examples
that the labels mask excludes (``pad_last``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterator protocol (subset of the reference's interface)."""

    def reset(self) -> None:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def total_examples(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-built list of DataSets (reference
    ``ListDataSetIterator``)."""

    def __init__(self, datasets: List[DataSet]):
        self._data = list(datasets)

    def reset(self):
        pass

    def batch_size(self):
        return self._data[0].num_examples() if self._data else 0

    def __iter__(self):
        return iter(self._data)

    def total_examples(self):
        return sum(d.num_examples() for d in self._data)


class ArrayDataSetIterator(DataSetIterator):
    """Mini-batch iterator over whole arrays, with optional shuffling per
    epoch (``reset`` advances the epoch) and tail handling."""

    def __init__(self, features, labels, batch: int,
                 features_mask=None, labels_mask=None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, pad_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))
        self.batch = int(batch)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._epoch = 0

    def reset(self):
        self._epoch += 1

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return self.features.shape[0]

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        stop = (n - (n % self.batch) if (self.drop_last and not self.pad_last)
                else n)
        for start in range(0, stop, self.batch):
            sel = idx[start:start + self.batch]
            fm = (None if self.features_mask is None
                  else self.features_mask[sel])
            lm = None if self.labels_mask is None else self.labels_mask[sel]
            f, lab = self.features[sel], self.labels[sel]
            if self.pad_last and len(sel) < self.batch:
                pad = self.batch - len(sel)
                f = _pad0(f, pad)
                lab = _pad0(lab, pad)
                # the padded examples are excluded from the loss by the mask
                base_lm = np.ones(len(sel), np.float32) if lm is None else lm
                lm = _pad0(base_lm, pad)
                fm = None if fm is None else _pad0(fm, pad)
            yield DataSet(f, lab, fm, lm)


def _pad0(arr, pad):
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width)
