"""All seventeen losses of the port against the JAX package's.

Each loss is scored on the same seeded pre-activations and labels, with
the activation the reference pairs it with, in both packages: the score
and its gradient with respect to the pre-output (``jax.grad`` against
torch autograd), without a mask, with a per-example mask, and with
per-output weights where the loss takes them. Float32 through the same
expressions, reduced in other orders: rtol 1e-5, atol 1e-6 on scores and
gradients (gradients of a mean over 8 examples are ~1e-2, so atol is
1e-4 of them). Every loss's config JSON round-trips between the packages.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import losses as jl
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import losses as pl
from deeplearning4j_tpu_torch.conf.activations import Activation

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-6)
B, N = 8, 5


def _onehot(rng, n=N):
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, B)]


def _labels(kind, rng):
    if kind == "real":
        return rng.normal(size=(B, N)).astype(np.float32)
    if kind == "away":  # MAPE divides by |label|
        return (rng.uniform(0.5, 2.0, (B, N))
                * rng.choice([-1.0, 1.0], (B, N))).astype(np.float32)
    if kind == "positive":
        return rng.uniform(0.0, 3.0, (B, N)).astype(np.float32)
    if kind == "onehot":
        return _onehot(rng)
    if kind == "index":
        return rng.integers(0, N, B).astype(np.float32)
    if kind == "binary":
        return rng.integers(0, 2, (B, N)).astype(np.float32)
    if kind == "pm1":
        return rng.choice([-1.0, 1.0], (B, N)).astype(np.float32)
    if kind == "dist":
        p = rng.uniform(0.1, 1.0, (B, N))
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "binary1":
        return rng.integers(0, 2, (B, 1)).astype(np.float32)
    if kind == "onehot2":
        return _onehot(rng, 2)
    raise ValueError(kind)


# loss name -> (activation, label kind, width of the pre-output, weights?)
CASES = {
    "LossMSE": ("identity", "real", N, True),
    "LossL2": ("identity", "real", N, True),
    "LossMAE": ("identity", "real", N, True),
    "LossL1": ("tanh", "real", N, True),
    "LossMAPE": ("identity", "away", N, True),
    "LossMSLE": ("softplus", "positive", N, True),
    "LossMCXENT": ("softmax", "onehot", N, True),
    "LossSparseMCXENT": ("softmax", "index", N, True),
    "LossBinaryXENT": ("sigmoid", "binary", N, True),
    "LossNegativeLogLikelihood": ("softmax", "onehot", N, True),
    "LossHinge": ("identity", "pm1", N, False),
    "LossSquaredHinge": ("tanh", "pm1", N, False),
    "LossCosineProximity": ("identity", "real", N, False),
    "LossPoisson": ("softplus", "positive", N, False),
    "LossKLD": ("softmax", "dist", N, False),
    "LossWasserstein": ("identity", "real", N, False),
    "LossFMeasure": ("sigmoid", "binary1", 1, False),
}
# the other branches: cross entropies off their fused activations, and
# FMeasure's two-column softmax form
EXTRA = [
    ("LossMCXENT", "sigmoid", "onehot", N, False),
    ("LossBinaryXENT", "softmax", "binary", N, False),
    ("LossFMeasure", "softmax", "onehot2", 2, False),
]


def _cases():
    out = []
    for name, (act, kind, width, weighted) in CASES.items():
        for mode in ("plain", "mask") + (("weights",) if weighted else ()):
            out.append((name, act, kind, width, mode))
    for name, act, kind, width, _ in EXTRA:
        out.append((name, act, kind, width, "mask"))
    return out


def test_every_loss_is_covered():
    names = {c.__name__ for c in vars(jl).values()
             if isinstance(c, type) and issubclass(c, jl.ILossFunction)
             and c is not jl.ILossFunction}
    assert names == set(CASES)
    assert set(jl.LOSS_FUNCTIONS) == set(pl.LOSS_FUNCTIONS)
    assert {k: v.__name__ for k, v in jl.LOSS_FUNCTIONS.items()} == \
        {k: v.__name__ for k, v in pl.LOSS_FUNCTIONS.items()}


@pytest.mark.parametrize("name,act,kind,width,mode", _cases())
def test_loss_score_and_gradient_match(name, act, kind, width, mode):
    rng = np.random.default_rng(zlib.crc32(f"{name}/{act}/{mode}".encode()))
    z = rng.normal(size=(B, width)).astype(np.float32)
    labels = _labels(kind, rng)
    mask = (rng.integers(0, 2, B).astype(np.float32) if mode == "mask"
            else None)
    if mask is not None:
        mask[0] = 1.0  # at least one example counts
    kw = {}
    if mode == "weights":
        kw["weights"] = [float(w) for w in rng.uniform(0.5, 2.0, width)]
    jloss = getattr(jl, name)(**kw)
    ploss = getattr(pl, name)(**kw)
    jact, pact = JAct(act), Activation(act)

    def jscore(zz):
        return jloss.score(jnp.asarray(labels), zz, jact,
                           None if mask is None else jnp.asarray(mask))

    jv, jg = jax.value_and_grad(jscore)(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    pv = ploss.score(torch.tensor(labels), zt, pact,
                     None if mask is None else torch.tensor(mask))
    pv.backward()
    np.testing.assert_allclose(float(pv.detach()), float(jv), **TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), **TOL)
    assert np.isfinite(zt.grad.numpy()).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_json_round_trips(name):
    kw = {"weights": [1.0, 2.0, 0.5]} if CASES[name][3] else {}
    if name == "LossFMeasure":
        kw = {"beta": 2.0}
    jloss = getattr(jl, name)(**kw)
    ported = serde.from_json(jserde.to_json(jloss))
    assert type(ported) is getattr(pl, name)
    assert jserde.from_json(serde.to_json(ported)) == jloss


def test_sparse_mcxent_takes_a_label_column():
    rng = np.random.default_rng(4)
    z = torch.tensor(rng.normal(size=(B, N)).astype(np.float32))
    idx = rng.integers(0, N, B)
    col = pl.LossSparseMCXENT().score(torch.tensor(idx[:, None]), z,
                                      Activation.SOFTMAX)
    onehot = pl.LossMCXENT().score(torch.tensor(np.eye(N)[idx],
                                                dtype=torch.float32),
                                   z, Activation.SOFTMAX)
    assert float(col) == pytest.approx(float(onehot), rel=1e-6)


def test_fmeasure_scores_the_batch_not_each_example():
    """Halving the batch does not halve or average FMeasure: the score of
    the whole batch is not the mean of the halves' scores."""
    rng = np.random.default_rng(5)
    z = torch.tensor(rng.normal(size=(B, 1)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 2, (B, 1)).astype(np.float32))
    loss = pl.LossFMeasure()
    whole = float(loss.score(y, z, Activation.SIGMOID))
    halves = [float(loss.score(y[i:i + B // 2], z[i:i + B // 2],
                               Activation.SIGMOID)) for i in (0, B // 2)]
    assert whole != pytest.approx(sum(halves) / 2, rel=1e-4)
