"""The legacy full-batch solvers (``optimize/legacy.py``:
``LineGradientDescent``, ``ConjugateGradient``, ``LBFGS``) in the port
against the JAX package's.

Networks: the JAX tests' regression MLP (3 -> 8 tanh -> 1 identity, MSE)
and a two-layer graph (2 -> 6 tanh -> 1, MSE), each the JAX
configuration's JSON on the JAX network's params; the data from numpy
seeds. Both solvers run the same steps in float32 (the port's flat vector
holds the params in the port's layouts, so its dot products sum in
another order): after 5 iterations the final loss and params agree at
rtol 1e-4, and each iteration's line search halves as often (a different
count would show as a loss apart by a factor of 2 in the step).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMSE as JMSE
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import legacy as jlegacy
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import legacy
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-4
SOLVERS = ("LineGradientDescent", "ConjugateGradient", "LBFGS")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jconf(kind, seed):
    b = JNNC.builder().seed(seed).updater(JSgd(0.1))
    if kind == "mln":
        return (b.list()
                .layer(JDense(n_out=8, activation=JAct.TANH))
                .layer(JOut(n_out=1, activation=JAct.IDENTITY,
                            loss_fn=JMSE()))
                .set_input_type(JIT.feed_forward(3)).build())
    return (b.graph_builder().add_inputs("in")
            .add_layer("h", JDense(n_out=6, activation=JAct.TANH), "in")
            .add_layer("out", JOut(n_out=1, activation=JAct.IDENTITY,
                                   loss_fn=JMSE()), "h")
            .set_outputs("out").set_input_types(JIT.feed_forward(2)).build())


def _data(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mln":
        x = rng.normal(size=(64, 3)).astype(np.float32)
        y = (x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32)
             + 0.1 * rng.normal(size=(64, 1)).astype(np.float32))
    else:
        x = rng.normal(size=(32, 2)).astype(np.float32)
        y = (x[:, :1] * x[:, 1:] + 0.5).astype(np.float32)
    return x, y


def _pair(kind, seed=7):
    jconf = _jconf(kind, seed)
    if kind == "mln":
        jnet = JMLN(jconf).init()
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        cls = MultiLayerNetwork
    else:
        jnet = JGraph(jconf).init()
        conf = ComputationGraphConfiguration.from_json(jconf.to_json())
        cls = ComputationGraph
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    x, y = _data(kind, seed)
    return cls(conf, "cpu").set_params(p, s), jnet, DataSet(x, y), \
        JDataSet(x, y)


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_matches_the_jax_solver(solver, kind):
    net, jnet, ds, jds = _pair(kind)
    final = getattr(legacy, solver)(max_iterations=5).optimize(net, ds)
    jfinal = getattr(jlegacy, solver)(max_iterations=5).optimize(jnet, jds)
    assert final == pytest.approx(jfinal, rel=RTOL)
    np.testing.assert_allclose(net.params_flat(), np.asarray(
        jnet.params_flat()), rtol=RTOL, atol=1e-6)
    assert net.score(ds) == pytest.approx(jnet.score(jds), rel=RTOL)


@pytest.mark.parametrize("iters", [1, 2, 3, 8])
@pytest.mark.parametrize("solver", SOLVERS)
def test_each_iteration_matches(solver, iters):
    """The loss after each count of iterations: a line search that halved
    another number of times would part the two here."""
    net, jnet, ds, jds = _pair("mln", seed=11)
    final = getattr(legacy, solver)(max_iterations=iters).optimize(net, ds)
    jfinal = getattr(jlegacy, solver)(max_iterations=iters).optimize(jnet,
                                                                      jds)
    assert final == pytest.approx(jfinal, rel=RTOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_minimizes_monotonically(solver):
    """Armijo never moves uphill: the loss after k + 1 iterations is at
    most the loss after k, and 60 iterations cut it fivefold."""
    net, _, ds, _ = _pair("mln")
    before = net.score(ds)
    losses = []
    for k in range(1, 6):
        trial = _pair("mln")[0]
        losses.append(getattr(legacy, solver)(max_iterations=k)
                      .optimize(trial, ds))
    assert all(b <= a for a, b in zip(losses, losses[1:]))
    final = getattr(legacy, solver)(max_iterations=60).optimize(net, ds)
    after = net.score(ds)
    assert after < before * 0.2
    assert final == pytest.approx(after, rel=0.05)


def test_lbfgs_beats_line_gd_iteration_for_iteration():
    net1, _, ds, _ = _pair("mln", seed=11)
    net2, _, _, _ = _pair("mln", seed=11)
    gd = [legacy.LineGradientDescent(max_iterations=k).optimize(
        _pair("mln", seed=11)[0], ds) for k in (5, 10, 15)]
    lb = [legacy.LBFGS(max_iterations=k).optimize(
        _pair("mln", seed=11)[0], ds) for k in (5, 10, 15)]
    assert all(b <= a * 1.05 for a, b in zip(gd, lb))
    legacy.LineGradientDescent(max_iterations=15).optimize(net1, ds)
    legacy.LBFGS(max_iterations=15).optimize(net2, ds)
    assert net2.score(ds) <= net1.score(ds) * 1.05  # curvature should help


def test_lbfgs_on_graph_minimizes():
    net, _, ds, _ = _pair("graph", seed=5)
    before = net.score(ds)
    legacy.LBFGS(max_iterations=80).optimize(net, ds)
    assert net.score(ds) < before * 0.5


def test_solver_writes_the_params_in_place_and_keeps_the_updater_state():
    net, _, ds, _ = _pair("mln")
    ids = {(k, pk): id(v) for k, vp in net.params.items()
           for pk, v in vp.items()}
    opt = {k: {pk: {sk: v.clone() for sk, v in st.items()}
               for pk, st in vp.items()} for k, vp in net.opt_state.items()}
    legacy.ConjugateGradient(max_iterations=3).optimize(net, ds)
    assert ids == {(k, pk): id(v) for k, vp in net.params.items()
                   for pk, v in vp.items()}
    for k, vp in opt.items():
        for pk, st in vp.items():
            for sk, v in st.items():
                assert torch.equal(v, net.opt_state[k][pk][sk])


def test_line_search_never_moves_uphill():
    """A direction along which the loss only rises: the search exhausts
    its halvings and returns alpha 0 with the old loss."""
    x = torch.zeros(3)
    g = torch.tensor([1.0, 0.0, 0.0])

    def f(v):  # rises by more than an ulp of 1 at every trial step
        return 1e6 * (v * v).sum() + 1.0

    alpha, loss = legacy._line_search(f, x, g, f(x), -g, 1.0)
    assert float(alpha) == 0.0 and float(loss) == 1.0
