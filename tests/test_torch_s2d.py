"""The space-to-depth stem of ResNet-50 in the port against the JAX package.

``SpaceToDepthLayer`` and ``ZeroPaddingLayer`` layer by layer (the port's
logical NCHW tensors hold the JAX package's NHWC values, channel order
``(a * bs + b) * C + ch``); ``ResNet50.stem_weights_to_s2d`` against the
JAX function; the stem identity of the JAX package's
``tests/test_zoo.py::test_resnet_space_to_depth_stem_is_exact`` (the s2d
network with remapped weights computes the 7x7 network's function); and
ResNet-50 with the s2d stem at 32x32 against the JAX network: the eval
forward, the train-mode loss and one Sgd step, and the ModelSerializer
zip both ways.

Tolerances: layers exactly (a reshape and a pad move values, no
arithmetic). The stem identity: the 7x7/2 and 4x4/1 convolutions sum the
same products in other orders, float32 rounding (rtol 1e-5 on the
features). ResNet-50 against JAX as ``tests/test_torch_training_graph.py``
holds it (loss rtol 1e-5; gradients and updates by relative L2: 2e-3
global, 2e-2 per tensor; every residual branch's last BN at gamma 0.1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.conf.layers_cnn import (
    SpaceToDepthLayer as JS2D,
    ZeroPaddingLayer as JPad,
)
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.util import serializer as jserializer
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.conf import InputType
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    SpaceToDepthLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util import serializer
from deeplearning4j_tpu_torch.util.convert import (
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

LOSS_RTOL = 1e-5
GLOBAL_L2 = 2e-3
TENSOR_L2 = 2e-2
OUT_RTOL = 1e-4
BATCH = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("bs,shape", [(2, (2, 8, 6, 3)), (3, (1, 9, 6, 2)),
                                      (4, (2, 8, 8, 5))])
def test_space_to_depth_layer_matches_jax(bs, shape):
    x = np.random.default_rng(bs).normal(size=shape).astype(np.float32)
    t = InputType.convolutional(shape[1], shape[2], shape[3])
    layer = SpaceToDepthLayer(block_size=bs)
    want, _ = JS2D(block_size=bs).forward({}, {}, jnp.asarray(x))
    got, _ = layer.forward({}, {}, _nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    assert got.is_contiguous(memory_format=torch.channels_last)
    jt = JS2D(block_size=bs).output_type(
        JInputType.convolutional(shape[1], shape[2], shape[3]))
    assert layer.output_type(t) == InputType.convolutional(
        jt.height, jt.width, jt.channels)
    assert (jt.height, jt.width, jt.channels) == (
        shape[1] // bs, shape[2] // bs, shape[3] * bs * bs)


@pytest.mark.parametrize("padding", [(1, 1, 1, 1), (1, 2, 1, 2),
                                     (0, 3, 2, 0)])
def test_zero_padding_layer_matches_jax(padding):
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 3)).astype(
        np.float32)
    layer = ZeroPaddingLayer(padding=padding)
    want, _ = JPad(padding=padding).forward({}, {}, jnp.asarray(x))
    got, _ = layer.forward({}, {}, _nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    assert got.is_contiguous(memory_format=torch.channels_last)
    t, b, l, r = padding
    assert layer.output_type(InputType.convolutional(5, 7, 3)) == \
        InputType.convolutional(5 + t + b, 7 + l + r, 3)


def test_stem_weights_to_s2d_equals_jax_and_is_the_7x7_conv():
    rng = np.random.default_rng(0)
    w7 = rng.normal(size=(7, 7, 3, 8)).astype(np.float32)
    w4 = ResNet50.stem_weights_to_s2d(w7)
    np.testing.assert_array_equal(w4, JResNet50.stem_weights_to_s2d(w7))
    assert w4.shape == (4, 4, 12, 8)
    # the conv identity through the port's layers: 7x7/2 SAME ==
    # s2d(2), pad (1, 2, 1, 2), 4x4/1 VALID
    x = _nchw(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (2, 3, 2, 3)),
        torch.from_numpy(w7).permute(3, 2, 0, 1), stride=2)
    xs, _ = SpaceToDepthLayer(block_size=2).forward({}, {}, x)
    xp, _ = ZeroPaddingLayer(padding=(1, 2, 1, 2)).forward({}, {}, xs)
    got = torch.nn.functional.conv2d(
        xp, torch.from_numpy(w4).permute(3, 2, 0, 1))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _s2d_zoo(**kw):
    z = ResNet50(num_classes=4, height=32, width=32, seed=9, **kw)
    z.stem_space_to_depth = True
    return z


@pytest.mark.parametrize("fused", [False, True])
def test_s2d_resnet50_conf_json_equals_the_jax_package(fused):
    port, ref = _s2d_zoo(), JResNet50(num_classes=4, height=32, width=32,
                                      seed=9)
    ref.stem_space_to_depth = True
    port.fused_conv_bn = ref.fused_conv_bn = fused
    conf = port.conf()
    assert conf.to_json() == ref.conf().to_json()
    names = [v.name for v in conf.vertices][:3]
    assert names == ["stem_s2d", "stem_pad", "stem_conv"]
    types = conf.vertex_output_types()
    assert types["stem_pad"] == InputType.convolutional(19, 19, 12)
    assert types["stem_conv"] == InputType.convolutional(16, 16, 64)


def test_s2d_stem_network_computes_the_7x7_network():
    """The JAX package's zoo test, on the port: the s2d network with the
    7x7 network's weights (stem remapped) gives its outputs."""
    base = ResNet50(num_classes=4, height=32, width=32, seed=9)
    na = base.init(device="cpu")
    params = {k: dict(v) for k, v in na.params.items()}
    w7 = na.params["stem_conv"]["W"].permute(2, 3, 1, 0).numpy()
    params["stem_conv"]["W"] = torch.from_numpy(
        ResNet50.stem_weights_to_s2d(w7)).permute(3, 2, 0, 1)
    nb = ComputationGraph(_s2d_zoo().conf(), device="cpu").set_params(
        params, na.state)
    x = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    fa, fb = na.feed_forward(x), nb.feed_forward(x)
    np.testing.assert_allclose(fb["stem_conv"], fa["stem_conv"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fb["avgpool"], fa["avgpool"], rtol=1e-5,
                               atol=1e-5 * np.abs(fa["avgpool"]).max())
    np.testing.assert_allclose(nb.output(x), na.output(x), rtol=1e-5,
                               atol=1e-6)


def jax_net_like(conf, net):
    """The JAX package's network for ``conf`` holding the port network
    ``net``'s params and state (its updater afresh): what ``init`` sets up,
    without the JAX package's eager random draws."""
    jnet = JGraph(conf)
    p, s = params_to_jax(net.conf, net.params, net.state)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, p)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, s)
    jnet.opt_state = {k: {pk: jnet._updater_for(k).init_state(v)
                          for pk, v in vp.items()}
                      for k, vp in jnet.params.items()}
    return jnet


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's s2d ResNet-50 at 32x32 on the port's seeded
    weights: the eval output, and one Sgd step (its loss, params and BN
    state after it)."""
    zoo = JResNet50(num_classes=10, height=32, width=32,
                    updater=JSgd(learning_rate=0.01))
    zoo.stem_space_to_depth = True
    conf = zoo.conf()
    port = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    for k, p in port.params.items():
        if k.endswith("_c_bn"):
            p["gamma"].fill_(0.1)
    jnet = jax_net_like(conf, port)
    params, state = _np(jnet.params), _np(jnet.state)
    rng = np.random.default_rng(0)
    x = rng.random((BATCH, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
    out = jnet.output(x)
    loss = jnet.fit_batch(JDataSet(x, y))
    return {"net": jnet, "conf": conf, "params": params,
            "state": state, "x": x, "y": y, "out": np.asarray(out),
            "loss": float(loss), "params_after": _np(jnet.params),
            "state_after": _np(jnet.state)}


def _port_net(r):
    conf = ComputationGraphConfiguration.from_json(r["conf"].to_json())
    p, s = params_from_jax(conf, r["params"], r["state"])
    return ComputationGraph(conf, device="cpu").set_params(p, s)


def _rel_l2(got, want):
    num = den = 0.0
    for k in want:
        for p in want[k]:
            g, w = got[k][p].detach().double(), want[k][p].double()
            d2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
            num, den = num + d2, den + w2
            assert d2 <= TENSOR_L2 ** 2 * max(w2, 1e-30), (
                k, p, (d2 / max(w2, 1e-30)) ** 0.5)
    assert num <= GLOBAL_L2 ** 2 * den, (num / den) ** 0.5


def test_s2d_resnet50_forward_matches_jax(jax_run):
    r = jax_run
    net = _port_net(r)
    np.testing.assert_allclose(net.output(r["x"]), r["out"], rtol=OUT_RTOL,
                               atol=1e-6)


def test_s2d_resnet50_sgd_step_matches_jax(jax_run):
    r = jax_run
    net = _port_net(r)
    before = {k: {p: v.clone() for p, v in vp.items()}
              for k, vp in net.params.items()}
    loss = net.fit_batch(DataSet(r["x"], r["y"]))
    np.testing.assert_allclose(loss, r["loss"], rtol=LOSS_RTOL)
    want, want_state = params_from_jax(net.conf, r["params_after"],
                                       r["state_after"])
    # the updates (after - before) by relative L2
    j0, _ = params_from_jax(net.conf, r["params"], {})
    _rel_l2({k: {p: net.params[k][p] - before[k][p] for p in vp}
             for k, vp in net.params.items()},
            {k: {p: want[k][p] - j0[k][p] for p in vp}
             for k, vp in want.items()})
    for k, vs in want_state.items():
        for n, v in vs.items():
            assert float((net.state[k][n] - v).abs().max()) <= \
                1e-3 * float(v.abs().max()), (k, n)


def test_s2d_zip_written_by_the_port_restores_in_jax(jax_run, tmp_path,
                                                    monkeypatch):
    r = jax_run
    net = _port_net(r)
    path = os.path.join(tmp_path, "port.zip")
    serializer.write_model(net, path)
    # the JAX restore draws a fresh network before it reads the zip into
    # it; zeros of the same shapes stand in for those eager draws (~18 s
    # for ResNet-50 on the CPU), so every value checked comes from the zip
    zeros = jax.tree_util.tree_map(np.zeros_like, _np(r["net"].params))
    zstate = jax.tree_util.tree_map(np.zeros_like, _np(r["net"].state))

    def zero_init(self):
        self.params = jax.tree_util.tree_map(jnp.asarray, zeros)
        self.state = jax.tree_util.tree_map(jnp.asarray, zstate)
        self.opt_state = {k: {pk: self._updater_for(k).init_state(v)
                              for pk, v in vp.items()}
                          for k, vp in self.params.items()}
        return self

    monkeypatch.setattr(JGraph, "init", zero_init)
    jback = jserializer.restore_computation_graph(path)
    np.testing.assert_array_equal(np.asarray(jback.params_flat()),
                                  net.params_flat())
    _, state = params_from_jax(net.conf, {}, _np(jback.state))
    for k, vs in net.state.items():
        for n, v in vs.items():
            assert torch.equal(state[k][n], v), (k, n)


def test_s2d_zip_written_by_jax_restores_in_the_port(jax_run, tmp_path):
    r = jax_run  # its network has taken one Sgd step
    path = os.path.join(tmp_path, "jax.zip")
    jserializer.write_model(r["net"], path)
    back = serializer.restore_computation_graph(path, device="cpu")
    np.testing.assert_array_equal(back.params_flat(),
                                  np.asarray(r["net"].params_flat()))
    assert back.iteration == r["net"].iteration == 1
    want = np.asarray(r["net"].output(r["x"]))
    np.testing.assert_allclose(back.output(r["x"]), want, rtol=OUT_RTOL,
                               atol=1e-6)
