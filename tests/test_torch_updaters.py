"""All eleven updaters of the port against the JAX package's.

A small MLP (6 -> 5 tanh -> 3 softmax, MCXENT) is built by the JAX
package's builder with each updater (with a learning-rate schedule where
the updater takes one, and Nesterovs with a momentum schedule too), carried
into the port through the configuration JSON and ``params_from_jax``, and
trained 5 steps on the same seeded batches in both packages. After every
step the scores, the params and the updater state, carried to the JAX
layouts, agree within rtol 1e-5: float32 through the same formulas,
rounded in other orders. The absolute tolerance is 1e-4 of the learning
rate (at least 1e-7): the JAX package computes the bias corrections
``1 - beta^t`` in float32, which at t = 1 is 1e-3 known to about 6e-5
relative, and the port in float64, so a weight's Adam-family step differs
by up to ~6e-5 of the learning rate. Each updater's config JSON
round-trips between the packages. The JAX package's ``AMSGrad.init_state`` gives m, v and vhat
one shared zeros buffer, which its donating train step refuses, so the
JAX network's fresh updater state is copied leaf by leaf first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import updaters as ju
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.schedules import ExponentialSchedule as JExp
from deeplearning4j_tpu.conf.schedules import StepSchedule as JStep
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import updaters as pu
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-5
STEPS = 5


def _exp(lr):
    return JExp(initial_value=lr, gamma=0.9)


def _step(lr):
    return JStep(initial_value=lr, decay_rate=0.5, step=2.0)


UPDATERS = {
    "Sgd": lambda: ju.Sgd(learning_rate=0.1, lr_schedule=_step(0.1)),
    "NoOp": lambda: ju.NoOp(),
    "Adam": lambda: ju.Adam(learning_rate=0.01, lr_schedule=_exp(0.01)),
    "AdamW": lambda: ju.AdamW(learning_rate=0.01, weight_decay=0.05,
                              lr_schedule=_exp(0.01)),
    "AMSGrad": lambda: ju.AMSGrad(learning_rate=0.01, lr_schedule=_exp(0.01)),
    "AdaMax": lambda: ju.AdaMax(learning_rate=0.02, lr_schedule=_step(0.02)),
    "Nadam": lambda: ju.Nadam(learning_rate=0.01, lr_schedule=_exp(0.01)),
    "Nesterovs": lambda: ju.Nesterovs(learning_rate=0.05, momentum=0.9,
                                      lr_schedule=_exp(0.05),
                                      momentum_schedule=_step(0.9)),
    "AdaGrad": lambda: ju.AdaGrad(learning_rate=0.05,
                                  lr_schedule=_step(0.05)),
    "AdaDelta": lambda: ju.AdaDelta(rho=0.9),
    "RmsProp": lambda: ju.RmsProp(learning_rate=0.01,
                                  lr_schedule=_exp(0.01)),
}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(updater):
    jconf = (JNNC.builder().seed(3).updater(updater).list()
             .layer(JDense(n_out=5, activation=JAct.TANH))
             .layer(JOut(n_out=3, activation=JAct.SOFTMAX))
             .set_input_type(JIT.feed_forward(6)).build())
    jnet = JMLN(jconf).init()
    # the JAX package's AMSGrad.init_state hands m, v and vhat one zeros
    # buffer, which its donating train step refuses; give each its own
    jnet.opt_state = jax.tree_util.tree_map(jnp.array, jnet.opt_state)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    return jnet, MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _batches(seed=0, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(n, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
        out.append((x, y))
    return out


def test_every_updater_is_listed():
    names = {c.__name__ for c in vars(ju).values()
             if isinstance(c, type) and issubclass(c, ju.IUpdater)
             and c is not ju.IUpdater}
    assert names == set(UPDATERS)


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_trains_as_the_jax_package(name):
    updater = UPDATERS[name]()
    tol = dict(rtol=RTOL, atol=max(1e-7, 1e-4 * getattr(
        updater, "learning_rate", 0.0)))
    jnet, net = _nets(updater)
    assert type(net.conf.updater).__name__ == name
    for step, (x, y) in enumerate(_batches()):
        ls = net.fit_batch(DataSet(x, y))
        lj = jnet.fit_batch(JDataSet(x, y))
        np.testing.assert_allclose(ls, lj, rtol=RTOL, err_msg=f"step {step}")
        got_p, _ = params_to_jax(net.conf, net.params, net.state)
        for k, vp in _to_np(jnet.params).items():
            for pk, v in vp.items():
                np.testing.assert_allclose(got_p[k][pk], v, **tol,
                                           err_msg=f"step {step} {k}.{pk}")
        got_o = opt_state_to_jax(net.conf, net.opt_state)
        want_o = _to_np(jnet.opt_state)
        assert {k: {pk: sorted(st) for pk, st in vp.items()}
                for k, vp in got_o.items()} == \
            {k: {pk: sorted(st) for pk, st in vp.items()}
             for k, vp in want_o.items()}
        for k, vp in want_o.items():
            for pk, st in vp.items():
                for sk, v in st.items():
                    np.testing.assert_allclose(
                        got_o[k][pk][sk], v, **tol,
                        err_msg=f"step {step} {k}.{pk}.{sk}")
    assert net.iteration == jnet.iteration == STEPS


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_json_round_trips(name):
    updater = UPDATERS[name]()
    ported = serde.from_json(jserde.to_json(updater))
    assert type(ported) is getattr(pu, name)
    assert jserde.from_json(serde.to_json(ported)) == updater


@pytest.mark.parametrize("name", ["Adam", "AdaDelta", "NoOp", "Nesterovs"])
def test_current_lr_matches(name):
    updater = UPDATERS[name]()
    ported = serde.from_json(jserde.to_json(updater))
    for it in (0, 1, 3, 7):
        assert ported.current_lr(it, 0) == pytest.approx(
            float(updater.current_lr(it, 0)), rel=1e-6)
