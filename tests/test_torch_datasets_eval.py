"""The port's datasets, normalizers and evaluation against the JAX
package's: the synthetic MNIST and Iris sets bit for bit, the iterators'
batches and their order (shuffled per epoch from the same seed), the
DataSet helpers, the normalizers' fit / transform / revert and their state
round trip in both directions, and the evaluation classes' numbers on the
same predictions. All numpy on both sides, so equality is exact except
where noted (the normalizers' float64 statistics: exact too).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu_torch.datasets import mnist, normalizers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as pev

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("num,seed", [(64, 123), (300, 900), (1, 0)])
def test_synthesize_is_bit_equal(num, seed):
    x, y = mnist.synthesize(num, seed)
    jx, jy = jmnist.synthesize(num, seed)
    assert x.dtype == jx.dtype == np.float32
    assert x.shape == (num, 28, 28, 1) and y.shape == (num, 10)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("train,shuffle", [(True, True), (False, False)])
def test_mnist_iterator_yields_the_same_batches(train, shuffle):
    kw = dict(batch=32, train=train, num_examples=160, seed=7,
              shuffle=shuffle)
    it, jit_ = mnist.MnistDataSetIterator(**kw), jmnist.MnistDataSetIterator(
        **kw)
    assert it.synthetic and jit_.synthetic
    for epoch in range(3):
        got, want = list(it), list(jit_)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
        it.reset()
        jit_.reset()


def test_iris_iterator_is_bit_equal():
    it, jit_ = mnist.IrisDataSetIterator(batch=40), \
        jmnist.IrisDataSetIterator(batch=40)
    for a, b in zip(it, jit_):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("drop_last,pad_last", [(True, False), (False, False),
                                                (True, True)])
def test_array_iterator_tails_and_masks(drop_last, pad_last):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(23, 4)).astype(np.float32)
    y = rng.normal(size=(23, 2)).astype(np.float32)
    fm = rng.integers(0, 2, (23, 4)).astype(np.float32)
    kw = dict(batch=5, features_mask=fm, shuffle=True, seed=11,
              drop_last=drop_last, pad_last=pad_last)
    got = list(ArrayDataSetIterator(x, y, **kw))
    want = list(JArrayIt(x, y, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for attr in ("features", "labels", "features_mask", "labels_mask"):
            va, vb = getattr(a, attr), getattr(b, attr)
            assert (va is None) == (vb is None), attr
            if va is not None:
                np.testing.assert_array_equal(va, vb)


def test_dataset_helpers_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = rng.normal(size=(10, 2)).astype(np.float32)
    lm = rng.integers(0, 2, 10).astype(np.float32)
    a, b = DataSet(x.copy(), y.copy(), labels_mask=lm.copy()), \
        JDataSet(x.copy(), y.copy(), labels_mask=lm.copy())
    a.shuffle(4)
    b.shuffle(4)
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels_mask, b.labels_mask)
    (a1, a2), (b1, b2) = a.split_test_and_train(6), b.split_test_and_train(6)
    for p, q in ((a1, b1), (a2, b2)):
        np.testing.assert_array_equal(p.features, q.features)
        np.testing.assert_array_equal(p.labels_mask, q.labels_mask)
    m = DataSet.merge([a2, a1])
    jm = JDataSet.merge([b2, b1])
    np.testing.assert_array_equal(m.features, jm.features)
    np.testing.assert_array_equal(m.labels_mask, jm.labels_mask)
    assert m.features_mask is None and m.num_examples() == 10


def test_migrate_and_detach_round_trip():
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    ds = DataSet(x, np.ones((3, 2), np.float32)).migrate("cpu")
    assert isinstance(ds.features, torch.Tensor)
    assert ds.features.dtype == torch.uint8  # uint8 stays uint8
    assert ds.labels_mask is None
    ds.detach()
    assert isinstance(ds.features, np.ndarray)
    np.testing.assert_array_equal(ds.features, x)


def _norm_batches(seed=1):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(2.0, 3.0, (7, 4)).astype(np.float32),
                    rng.normal(-1.0, 0.5, (7, 2)).astype(np.float32))
            for _ in range(3)]


def _jcopy(batches):
    return [JDataSet(d.features.copy(), d.labels.copy()) for d in batches]


@pytest.mark.parametrize("make", [
    lambda m: m.NormalizerStandardize(fit_labels=True),
    lambda m: m.NormalizerMinMaxScaler(min_range=-1.0, max_range=2.0),
    lambda m: m.ImagePreProcessingScaler(min_range=0.0, max_range=1.0,
                                         max_bits=8),
], ids=["standardize", "minmax", "image_scaler"])
def test_normalizers_match_and_round_trip(make):
    batches = _norm_batches()
    p, j = make(normalizers), make(jnorm)
    p.fit(batches)
    j.fit(_jcopy(batches))
    assert p.state_dict() == j.state_dict()
    for d, jd in zip(batches, _jcopy(batches)):
        a, b = p.transform(DataSet(d.features.copy(), d.labels.copy())), \
            j.transform(jd)
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(p.revert(a).features, d.features,
                                   rtol=1e-5, atol=1e-5)
    # state both ways
    from_j = normalizers.normalizer_from_state(j.state_dict())
    from_p = jnorm.normalizer_from_state(p.state_dict())
    assert type(from_j).__name__ == type(j).__name__
    assert from_j.state_dict() == j.state_dict()
    assert from_p.state_dict() == p.state_dict()


def _predictions(seed, n=60, c=4):
    rng = np.random.default_rng(seed)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    logits = rng.normal(size=(n, c)) + 1.5 * labels
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return labels, probs.astype(np.float32), rng.integers(0, 2, n)


def test_evaluation_stats_match():
    p, j = pev.Evaluation(), jev.Evaluation()
    for seed in (0, 1):
        labels, probs, mask = _predictions(seed)
        p.eval(labels, probs, mask=mask)
        j.eval(labels, probs, mask=mask)
    assert p.stats() == j.stats()
    np.testing.assert_array_equal(p.confusion, j.confusion)
    for cls in range(4):
        assert p.precision(cls) == j.precision(cls)
        assert p.recall(cls) == j.recall(cls)
        assert p.false_positive_rate(cls) == j.false_positive_rate(cls)
    assert (p.accuracy(), p.f1()) == (j.accuracy(), j.f1())


def test_binary_roc_regression_calibration_match():
    labels, probs, mask = _predictions(2)
    pairs = [(pev.EvaluationBinary(), jev.EvaluationBinary()),
             (pev.ROCMultiClass(), jev.ROCMultiClass()),
             (pev.ROCBinary(), jev.ROCBinary()),
             (pev.RegressionEvaluation(), jev.RegressionEvaluation()),
             (pev.EvaluationCalibration(), jev.EvaluationCalibration())]
    for p, j in pairs:
        p.eval(labels, probs, mask=mask)
        j.eval(labels, probs, mask=mask)
    eb, jeb = pairs[0]
    assert [eb.f1(i) for i in range(4)] == [jeb.f1(i) for i in range(4)]
    for p, j in pairs[1:3]:
        assert p.calculate_average_auc() == j.calculate_average_auc()
        assert p.calculate_average_auprc() == j.calculate_average_auprc()
    r, jr = pairs[3]
    assert [r.r_squared(c) for c in range(4)] == \
        [jr.r_squared(c) for c in range(4)]
    assert r.pearson_correlation(1) == jr.pearson_correlation(1)
    cal, jcal = pairs[4]
    assert cal.expected_calibration_error() == \
        jcal.expected_calibration_error()
    roc, jroc = pev.ROC(), jev.ROC()
    roc.eval(labels[:, 0], probs[:, 0])
    jroc.eval(labels[:, 0], probs[:, 0])
    assert roc.calculate_auc() == jroc.calculate_auc()
