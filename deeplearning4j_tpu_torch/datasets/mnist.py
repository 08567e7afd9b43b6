"""MNIST and Iris dataset iterators.

Reference: ``org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator``
+ ``MnistDataFetcher`` (auto-download + idx-file cache); copied from the JAX
package's ``datasets/mnist.py`` (numpy only). Nothing is ever fetched: the
data resolves in order:

1. cached idx files under ``~/.deeplearning4j_tpu/mnist/`` (standard
   ``train-images-idx3-ubyte`` etc., gz or raw) — byte-compatible with the
   reference's cache;
2. a deterministic SYNTHETIC digit set: 5x7 bitmap-font glyphs for 0-9
   rendered into 28x28 with random shift/scale jitter + noise. Learnable by
   LeNet to >95%, so the e2e demo and bench exercise the full pipeline.

Images are NHWC [batch, 28, 28, 1] floats in [0,1]; labels one-hot [batch,10].
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

_CACHE = Path(os.path.expanduser("~/.deeplearning4j_tpu/mnist"))

# 5x7 bitmap font for digits 0-9 (rows top->bottom, 5 bits per row)
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def _find(name: str) -> Path | None:
    for cand in (_CACHE / name, _CACHE / (name + ".gz")):
        if cand.exists():
            return cand
    return None


def _load_real(train: bool):
    img = _find(("train" if train else "t10k") + "-images-idx3-ubyte")
    lab = _find(("train" if train else "t10k") + "-labels-idx1-ubyte")
    if img is None or lab is None:
        return None
    images = _read_idx(img).astype(np.float32) * (1.0 / 255.0)
    labels = _read_idx(lab)
    features = images[..., None]  # NHWC
    onehot = np.eye(10, dtype=np.float32)[labels]
    return features, onehot


def _glyph(digit: int) -> np.ndarray:
    g = np.array([[int(c) for c in row] for row in _FONT[digit]], np.float32)
    return g  # [7, 5]


def synthesize(num: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic MNIST-like set: the JAX package's arrays,
    bit for bit, for the same ``(num, seed)``."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(0, 10, size=num)
    imgs = np.zeros((num, 28, 28), np.float32)
    for i, d in enumerate(digits):
        scale = rng.integers(2, 4)  # 2x or 3x
        glyph = np.kron(_glyph(int(d)), np.ones((scale, scale), np.float32))
        gh, gw = glyph.shape
        max_y, max_x = 28 - gh, 28 - gw
        y = rng.integers(0, max_y + 1)
        x = rng.integers(0, max_x + 1)
        intensity = 0.7 + 0.3 * rng.random()
        imgs[i, y:y + gh, x:x + gw] = glyph * intensity
    imgs += rng.normal(0, 0.08, imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    labels = np.eye(10, dtype=np.float32)[digits]
    return imgs[..., None], labels


class MnistDataSetIterator(ArrayDataSetIterator):
    """Reference ``MnistDataSetIterator(batch, train, seed)``."""

    def __init__(self, batch: int, train: bool = True, seed: int = 123,
                 num_examples: int | None = None, shuffle: bool = True):
        real = _load_real(train)
        if real is not None:
            features, labels = real
            self.synthetic = False
        else:
            n = num_examples or (8192 if train else 2048)
            features, labels = synthesize(n, seed + (0 if train else 777))
            self.synthetic = True
        if num_examples is not None:
            features, labels = features[:num_examples], labels[:num_examples]
        super().__init__(features, labels, batch, shuffle=shuffle, seed=seed)


class IrisDataSetIterator(ArrayDataSetIterator):
    """Reference ``IrisDataSetIterator`` — the tiny built-in dataset used
    throughout the reference's tests. Fisher's iris is reproduced
    synthetically here (three separable gaussian clusters in 4-D matching
    class means/stds of the real data)."""

    _MEANS = np.array([[5.01, 3.43, 1.46, 0.25],
                       [5.94, 2.77, 4.26, 1.33],
                       [6.59, 2.97, 5.55, 2.03]], np.float32)
    _STDS = np.array([[0.35, 0.38, 0.17, 0.11],
                      [0.52, 0.31, 0.47, 0.20],
                      [0.64, 0.32, 0.55, 0.27]], np.float32)

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 6):
        rng = np.random.default_rng(seed)
        per = num_examples // 3
        feats, labs = [], []
        for c in range(3):
            feats.append(rng.normal(self._MEANS[c], self._STDS[c],
                                    size=(per, 4)).astype(np.float32))
            labs.append(np.full(per, c))
        features = np.concatenate(feats)
        labels = np.eye(3, dtype=np.float32)[np.concatenate(labs)]
        perm = rng.permutation(len(features))
        super().__init__(features[perm], labels[perm], batch, shuffle=False,
                         drop_last=False)
