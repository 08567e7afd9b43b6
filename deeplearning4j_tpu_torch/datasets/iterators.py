"""DataSetIterator contract + ``ListDataSetIterator``.

Reference: ``org.nd4j.linalg.dataset.api.iterator.DataSetIterator`` and
``ListDataSetIterator``; copied from the JAX package's
``datasets/iterators.py``. Iterators yield :class:`DataSet`s.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

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
