"""The port's training path (``ComputationGraph.fit``) against the JAX package.

The slice: ``ResNet50(num_classes=10, height=32, width=32)`` with
``fused_conv_bn=True`` at full depth, weights from the JAX package through
``params_from_jax``, one seeded batch of 8. Both ``use_kernels`` routes of
the port (``matmul_stats`` for the 36 fused sites, or ``F.conv2d`` with
one-pass statistics) are held against the JAX package's stock path:

- the loss and gradients of ``compute_gradient_and_score``;
- two ``fit`` steps with ``Sgd``: the parameter updates, the BN running
  statistics and the per-step losses.

Conditioning: every residual branch's last BN starts at gamma 0.1 (the
zero-init-residual recipe of Goyal et al. 2017 starts it at 0). With
gamma 1 the random 50-layer network amplifies float32 rounding chaotically
(a 1e-6 change of the input moves its gradients by ~2%), and no tolerance
would tell a wrong gradient from noise.

Tolerances: the loss rtol 1e-5. Gradients and updates: the relative L2
error over all tensors at most 2e-3, and of each tensor at most 2e-2. Not
elementwise: a ReLU whose input lies within float32 rounding of 0 takes the
other side in the other package (observed here at ``res3d_a_cb``: one
pre-activation at 5e-6), which changes that element's gradient by a whole
step and moves every upstream gradient a little (~0.2%); a wrong VJP moves
the gradients of whole tensors by O(1). BN running statistics after two
steps: 1e-3 relative to each vector's largest magnitude.

Adam is compared per leaf (``test_torch_training_layers.py``) and by
resuming a JAX updater state: its first steps move each weight by about
``lr * sign(g)``, so after an Adam step a near-zero gradient of the other
sign puts the packages ``2 * lr`` apart.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import inputs as jit_
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JCollect,
)
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers_cnn import FusedConvBN1x1
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.kernels import impls
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.util.convert import (
    opt_state_from_jax,
    params_from_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

pytestmark = pytest.mark.torch

LOSS_RTOL = 1e-5
GLOBAL_L2 = 2e-3
TENSOR_L2 = 2e-2
STATE_RTOL = 1e-3
BATCH = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, n=BATCH, hw=32, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.random((n, hw, hw, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _assert_trees_close(got, want, what):
    """Relative L2 error over all tensors and per tensor (see the module
    docstring for why not elementwise)."""
    num = den = 0.0
    for k in want:
        for p in want[k]:
            g, w = got[k][p].detach().double(), want[k][p].double()
            d2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
            num, den = num + d2, den + w2
            assert d2 <= TENSOR_L2 ** 2 * w2, (what, k, p, (d2 / w2) ** 0.5)
    assert num <= GLOBAL_L2 ** 2 * den, (what, (num / den) ** 0.5)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's ResNet-50 (fused_conv_bn) on one batch: its
    weights, gradients, and two Sgd fit steps."""
    zoo = JResNet50(num_classes=10, height=32, width=32,
                    updater=JSgd(learning_rate=0.01))
    zoo.fused_conv_bn = True
    jnet = zoo.init()
    params, state = _np(jnet.params), _np(jnet.state)
    for k in params:
        if k.endswith("_c_cb"):
            params[k]["gamma"] = np.full_like(params[k]["gamma"], 0.1)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    x, y = _batch(0)
    ds = JDataSet(x, y)
    loss, _, grads = jax.jit(jnet.grad_fn())(
        jnet.params, jnet.state, (jnp.asarray(x),), (jnp.asarray(y),),
        (None,), (jnp.ones((BATCH,)),), None)
    collect = JCollect()
    jnet.set_listeners(collect)
    jnet.fit(JListIterator([ds, ds]))
    return {"conf": jnet.conf, "params": params, "state": state, "x": x,
            "y": y, "loss": float(loss),
            "grads": _np(grads), "scores": list(collect.scores),
            "params_after": _np(jnet.params),
            "state_after": _np(jnet.state)}


def _port_net(r, use_kernels):
    conf = ComputationGraphConfiguration.from_json(r["conf"].to_json())
    conf = dataclasses.replace(conf, use_kernels=use_kernels)
    p, s = params_from_jax(conf, r["params"], r["state"])
    return ComputationGraph(conf, device="cpu").set_params(p, s)


@pytest.fixture
def stats_calls(monkeypatch):
    calls = []
    real = impls.matmul_stats

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(impls, "matmul_stats", spy)
    return calls


def test_fused_resnet50_conf_json_equals_the_jax_package():
    port, ref = ResNet50(), JResNet50()
    port.fused_conv_bn = ref.fused_conv_bn = True
    conf = port.conf()
    assert conf.to_json() == ref.conf().to_json()
    fused = [v.vertex.layer for v in conf.vertices
             if isinstance(getattr(v.vertex, "layer", None), FusedConvBN1x1)]
    assert len(fused) == 36
    assert ResNet50().conf().to_json() == JResNet50().conf().to_json()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_compute_gradient_and_score_matches_jax(jax_run, use_kernels,
                                                stats_calls):
    r = jax_run
    net = _port_net(r, use_kernels)
    grads, loss = net.compute_gradient_and_score(DataSet(r["x"], r["y"]))
    np.testing.assert_allclose(loss, r["loss"], rtol=LOSS_RTOL)
    want, _ = params_from_jax(net.conf, r["grads"], {})
    assert set(grads) == set(want)
    _assert_trees_close(grads, want, "gradients")
    # the kernel route sends the 36 fused sites through matmul_stats, the
    # first one over the 8 x 8 positions after the stem
    assert len(stats_calls) == (36 if use_kernels else 0)
    if use_kernels:
        assert stats_calls[0] == ((BATCH * 8 * 8, 64), (64, 64))
    # the running statistics are untouched by a gradient evaluation
    _, s0 = params_from_jax(net.conf, r["params"], r["state"])
    for k, vs in net.state.items():
        assert torch.equal(vs["mean"], s0[k]["mean"])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_two_sgd_fit_steps_match_jax(jax_run, use_kernels):
    r = jax_run
    net = _port_net(r, use_kernels)
    before = {k: {p: v.clone() for p, v in vp.items()}
              for k, vp in net.params.items()}
    collect = CollectScoresListener()
    net.set_listeners(collect)
    ds = DataSet(r["x"], r["y"])
    net.fit(ListDataSetIterator([ds, ds]))
    assert net.iteration == 2 and net.epoch == 1
    assert collect.iterations == [0, 1]
    np.testing.assert_allclose(collect.scores, r["scores"], rtol=1e-4)
    want_p, want_s = params_from_jax(net.conf, r["params_after"],
                                     r["state_after"])
    p0, _ = params_from_jax(net.conf, r["params"], r["state"])
    got_upd = {k: {p: net.params[k][p] - before[k][p] for p in vp}
               for k, vp in net.params.items()}
    want_upd = {k: {p: want_p[k][p] - p0[k][p] for p in vp}
                for k, vp in want_p.items()}
    _assert_trees_close(got_upd, want_upd, "updates")
    for k, vs in want_s.items():
        for sk, v in vs.items():
            got = net.state[k][sk]
            assert not got.requires_grad
            err = float((got - v).abs().max() / v.abs().max())
            assert err <= STATE_RTOL, (k, sk, err)


def test_eval_score_is_the_cross_entropy_of_the_eval_output(jax_run):
    """``score(ds)`` is eval mode (running statistics): the mean cross
    entropy of ``output`` (which ``test_torch_graph.py`` holds against the
    JAX package); ``score()`` is the last step's loss."""
    r = jax_run
    net = _port_net(r, use_kernels=True)
    got = net.score(DataSet(r["x"], r["y"]))
    probs = net.output(r["x"]).astype(np.float64)
    want = float(np.mean(-np.sum(r["y"] * np.log(probs), axis=-1)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isnan(net.score())  # no step taken yet
    net.fit_batch(DataSet(r["x"], r["y"]))
    np.testing.assert_allclose(net.score(), r["scores"][0], rtol=1e-4)


# --------------------------------------------------------------------------
# a small graph: updater-state resume, fit overloads, listeners
# --------------------------------------------------------------------------

def _small_conf(updater):
    g = (JNNC.builder().seed(3).updater(updater).graph_builder()
         .add_inputs("input").set_input_types(jit_.Convolutional(6, 6, 3)))
    g.add_layer("c3", JConv(n_out=8, kernel_size=(3, 3), has_bias=False,
                            convolution_mode=JMode.SAME), "input")
    g.add_layer("bn", JBN(activation=JAct.RELU), "c3")
    g.add_layer("c1", JConv(n_out=6, kernel_size=(1, 1),
                            activation=JAct.TANH), "bn")
    g.add_layer("pool", JGP(pooling_type=JPT.AVG), "c1")
    g.add_layer("out", JOut(n_out=4), "pool")
    g.set_outputs("out")
    return g.build()


def _small_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(5, 6, 6, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_adam_state_from_jax_resumes_training(use_kernels):
    """A JAX graph takes one Adam step; the port takes its params, BN
    state, Adam m/v and iteration, and its next step lands where the JAX
    package's next step does (rtol 1e-4 on the params: Adam's second step
    is a smooth function of both gradients). Without the m/v state the
    port's step lands elsewhere."""
    jconf = _small_conf(JAdam(learning_rate=0.01))
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    jnet = JGraph(jconf).init()
    (x0, y0), (x1, y1) = _small_batch(1), _small_batch(2)
    jnet.fit_batch(JDataSet(x0, y0))
    conf = dataclasses.replace(
        ComputationGraphConfiguration.from_json(jconf.to_json()),
        use_kernels=use_kernels)
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    o = opt_state_from_jax(conf, _np(jnet.opt_state))
    assert o["c3"]["W"]["m"].shape == p["c3"]["W"].shape  # OIHW
    net = ComputationGraph(conf, device="cpu").set_params(p, s, o)
    net.iteration = jnet.iteration
    fresh = ComputationGraph(conf, device="cpu").set_params(p, s)
    fresh.iteration = jnet.iteration
    jnet.fit_batch(JDataSet(x1, y1))
    net.fit_batch(DataSet(x1, y1))
    fresh.fit_batch(DataSet(x1, y1))
    want, _ = params_from_jax(conf, _np(jnet.params), {})
    far = 0.0
    for k, vp in want.items():
        for pk, v in vp.items():
            np.testing.assert_allclose(net.params[k][pk].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k}.{pk}")
            far = max(far, float((fresh.params[k][pk] - v).abs().max()))
    assert far > 1e-3


def test_fit_overloads_listeners_and_counters():
    conf = ComputationGraphConfiguration.from_json(
        _small_conf(JSgd(learning_rate=0.05)).to_json())
    net = ComputationGraph(conf, device="cpu").init()
    x, y = _small_batch(3)
    out = io.StringIO()
    collect = CollectScoresListener()
    net.set_listeners(ScoreIterationListener(1, stream=out), collect)
    net.fit(DataSet(x, y))
    net.fit(ListDataSetIterator([DataSet(x, y)] * 2), epochs=2)
    net.fit(x, y)
    net.fit(MultiDataSet(features=[x], labels=[y]))
    assert net.iteration == 7 and net.epoch == 5
    assert collect.iterations == list(range(7))
    assert "Score at iteration 6 is" in out.getvalue()
    assert collect.scores[-1] < collect.scores[0]
    with pytest.raises(TypeError):
        net.fit(x)


def test_uint8_features_dequantize_on_the_training_path():
    conf = ComputationGraphConfiguration.from_json(
        _small_conf(JSgd(learning_rate=0.05)).to_json())
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(4)
    pixels = rng.integers(0, 256, (5, 6, 6, 3), np.uint8)
    _, y = _small_batch(4)
    g8, l8 = net.compute_gradient_and_score(DataSet(pixels, y))
    gf, lf = net.compute_gradient_and_score(
        DataSet(pixels.astype(np.float32) * np.float32(1 / 255), y))
    np.testing.assert_allclose(l8, lf, rtol=1e-6)
    for k in gf:
        for p in gf[k]:
            np.testing.assert_allclose(g8[k][p].numpy(), gf[k][p].numpy(),
                                       rtol=1e-5, atol=1e-7)


def test_fused_param_remap_keeps_the_function():
    """The unfused ResNet-50's weights, remapped onto the fused graph, give
    the same eval output and the same train-mode loss."""
    plain = ResNet50(num_classes=5, height=32, width=32)
    fused = ResNet50(num_classes=5, height=32, width=32)
    fused.fused_conv_bn = True
    a = ComputationGraph(plain.conf(), device="cpu").init()
    p, s = ResNet50.fused_param_remap(a.params, a.state)
    b = ComputationGraph(fused.conf(), device="cpu")
    assert set(p) == {k for k in b.conf.vertex_map()
                      if b.conf.vertex_map()[k].vertex.has_params()}
    b.set_params(p, s)
    x, y = _batch(5, n=4, classes=5)
    np.testing.assert_allclose(b.output(x), a.output(x), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.score(DataSet(x, y)),
                               a.score(DataSet(x, y)), rtol=1e-5)
