"""The port's ComputationGraph, routing and ResNet50 against the JAX package.

- configuration JSON: the port builds ResNet50's JSON byte for byte and
  loads the JAX package's;
- the routed 1x1 convolution (strided, no bias) and dense layer against the
  JAX route through the Pallas kernel after ``kernels.autotune_model``;
- ``ResNet50(num_classes=7, height=64, width=64)`` against the JAX stock
  path on the same parameters, carried over by ``params_from_jax``.

Inputs are numpy from a seed. Tolerance: float32 through the whole network,
sums in other orders on each side — rtol 1e-4, atol 1e-6 on the softmax
and rtol 1e-4 (relative to the largest magnitude) on activations.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import kernels as jkernels
from deeplearning4j_tpu.conf import inputs as jit_
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.kernels import impls
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inference_opt import optimize_for_inference
from deeplearning4j_tpu_torch.util.convert import params_from_jax
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

OUT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_tuning():
    jkernels.TUNING.clear()
    yield
    jkernels.TUNING.clear()


@pytest.fixture
def routed_calls(monkeypatch):
    """Counts the routed matmul_bias_act calls (on the CPU the wrapper runs
    its plain version and counts no kernel launch)."""
    calls = []
    real = impls.matmul_bias_act

    def spy(x, w, b, act):
        calls.append((tuple(x.shape), tuple(w.shape), act.value))
        return real(x, w, b, act)

    monkeypatch.setattr(impls, "matmul_bias_act", spy)
    return calls


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_conf(jconf, **changes):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    return dataclasses.replace(conf, **changes) if changes else conf


def _port_net(jconf, params, state, **changes):
    conf = _port_conf(jconf, **changes)
    p, s = params_from_jax(conf, params, state)
    return ComputationGraph(conf, device="cpu").set_params(p, s)


def _randomize_bn(params, state, seed):
    rng = np.random.default_rng(seed)
    for k in state:
        n = state[k]["mean"].shape[0]
        params[k]["gamma"] = rng.uniform(0.1, 0.5, n).astype(np.float32)
        params[k]["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
        state[k]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        state[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)


def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------------------------
# configuration JSON
# --------------------------------------------------------------------------

def test_resnet50_conf_json_equals_the_jax_package():
    assert json.loads(ResNet50().conf().to_json()) == \
        json.loads(JResNet50().conf().to_json())


def test_jax_conf_json_round_trips_through_the_port():
    s = JResNet50(num_classes=7, height=64, width=64).conf().to_json()
    assert ComputationGraphConfiguration.from_json(s).to_json() == s
    with pytest.raises(TypeError):
        ComputationGraphConfiguration.from_json(
            json.dumps({"@type": "VertexSpec", "name": "x"}))


def test_resnet50_full_width_parameter_count():
    assert ResNet50().init(device="cpu").num_params() == 25_557_032


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def _small_graph_conf(use_kernels, seed=11):
    b = JNNC.builder().seed(seed)
    if use_kernels:
        b = b.use_kernels()
    g = (b.graph_builder().add_inputs("input")
         .set_input_types(jit_.Convolutional(6, 6, 8)))
    g.add_layer("c1", JConv(n_out=16, kernel_size=(1, 1), stride=(2, 2),
                            convolution_mode=JMode.SAME, has_bias=False,
                            activation=JAct.RELU), "input")
    g.add_layer("c2", JConv(n_out=12, kernel_size=(1, 1),
                            convolution_mode=JMode.TRUNCATE, bias_init=0.1,
                            activation=JAct.TANH), "c1")
    g.add_layer("pool", JGP(pooling_type=JPT.AVG), "c2")
    g.add_layer("fc", JDense(n_out=10, activation=JAct.GELU), "pool")
    g.add_layer("out", JOut(n_out=5), "fc")
    g.set_outputs("out")
    return g.build()


def test_routed_1x1_conv_and_dense_match_the_jax_kernel_route(routed_calls):
    batch = 4
    jconf = _small_graph_conf(use_kernels=True)
    tuned = jkernels.autotune_model(jconf, batch, max_candidates=1)
    assert len(tuned) == 3  # c1 (strided, no bias), c2, fc
    jnet = JGraph(jconf).init()
    x = np.random.default_rng(0).normal(size=(batch, 6, 6, 8)).astype(
        np.float32)
    want = np.asarray(jnet.output(x))
    net = _port_net(jconf, _np_tree(jnet.params), _np_tree(jnet.state))
    got = net.output(x)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    # the strided no-bias conv became [B*3*3, 8] @ [16, 8]^T, etc.
    assert routed_calls == [((batch * 9, 8), (16, 8), "relu"),
                            ((batch * 9, 16), (12, 16), "tanh"),
                            ((batch, 12), (10, 12), "gelu")]
    # and the stock port path agrees with both
    plain = _port_net(jconf, _np_tree(jnet.params), _np_tree(jnet.state),
                      use_kernels=False)
    np.testing.assert_allclose(plain.output(x), want, **OUT_TOL)
    assert len(routed_calls) == 3


def test_routing_leaves_unqualified_layers_on_the_stock_path(routed_calls):
    b = JNNC.builder().seed(3).use_kernels()
    g = (b.graph_builder().add_inputs("input")
         .set_input_types(jit_.Convolutional(5, 5, 4)))
    # a 3x3 conv, a padded 1x1 conv, a dilated... and a softmax dense head
    g.add_layer("c3", JConv(n_out=4, kernel_size=(3, 3),
                            convolution_mode=JMode.SAME), "input")
    g.add_layer("pad1", JConv(n_out=4, kernel_size=(1, 1), padding=(1, 1),
                              convolution_mode=JMode.TRUNCATE), "c3")
    g.add_layer("pool", JGP(pooling_type=JPT.MAX), "pad1")
    g.add_layer("out", JOut(n_out=3), "pool")
    g.set_outputs("out")
    jconf = g.build()
    jnet = JGraph(jconf).init()
    x = np.random.default_rng(1).normal(size=(2, 5, 5, 4)).astype(np.float32)
    got = _port_net(jconf, _np_tree(jnet.params),
                    _np_tree(jnet.state)).output(x)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), **OUT_TOL)
    assert routed_calls == []


# --------------------------------------------------------------------------
# ResNet50 end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_resnet():
    """JAX ResNet50(7 classes, 64x64) with non-trivial BN and its output."""
    jnet = JResNet50(num_classes=7, height=64, width=64).init()
    params, state = _np_tree(jnet.params), _np_tree(jnet.state)
    _randomize_bn(params, state, seed=5)
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
    x = np.random.default_rng(2).random((3, 64, 64, 3)).astype(np.float32)
    ff = jnet.feed_forward(x)
    return {"conf": jnet.conf, "params": params, "state": state, "x": x,
            "out": np.asarray(jnet.output(x)),
            "ff": {k: np.asarray(ff[k]) for k in
                   ("stem_conv", "stem_pool", "res3a_relu", "avgpool")}}


def test_resnet50_matches_jax_stock_path(small_resnet):
    r = small_resnet
    net = _port_net(r["conf"], r["params"], r["state"])
    got = net.output(r["x"])
    assert got.shape == (3, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, r["out"], **OUT_TOL)
    assert np.array_equal(got.argmax(-1), r["out"].argmax(-1))
    ff = net.feed_forward(r["x"])
    for name, want in r["ff"].items():
        assert ff[name].shape == want.shape, name  # NHWC at the boundary
        assert _rel_err(ff[name], want) < 1e-4, name


def test_resnet50_kernel_route_matches_jax(small_resnet, routed_calls):
    r = small_resnet
    net = _port_net(r["conf"], r["params"], r["state"], use_kernels=True)
    np.testing.assert_allclose(net.output(r["x"]), r["out"], **OUT_TOL)
    assert len(routed_calls) == 36  # every 1x1 conv, one forward


def test_uint8_images_dequantize_like_the_jax_package(small_resnet):
    r = small_resnet
    pixels = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    jnet = JGraph(r["conf"]).init()
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, r["params"])
    jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, r["state"])
    net = _port_net(r["conf"], r["params"], r["state"])
    got = net.output(pixels)
    np.testing.assert_allclose(got, np.asarray(jnet.output(pixels)),
                               **OUT_TOL)
    np.testing.assert_allclose(
        got, net.output(pixels.astype(np.float32) * np.float32(1 / 255)),
        rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# graph runtime
# --------------------------------------------------------------------------

def test_init_is_seeded_and_scaled_like_the_reference():
    conf = ResNet50(num_classes=7, height=32, width=32).conf()
    a = ComputationGraph(conf, device="cpu").init()
    b = ComputationGraph(conf, device="cpu").init()
    for k, vp in a.params.items():
        for pk, v in vp.items():
            assert torch.equal(v, b.params[k][pk]), (k, pk)
    w = a.params["res4a_b_conv"]["W"]  # RELU init: N(0, 2 / fan_in)
    assert tuple(w.shape) == (256, 256, 3, 3)
    assert abs(float(w.std()) / np.sqrt(2.0 / (9 * 256)) - 1.0) < 0.02
    other = ComputationGraph(dataclasses.replace(conf, seed=124),
                             device="cpu").init()
    assert not torch.equal(other.params["stem_conv"]["W"],
                           a.params["stem_conv"]["W"])


def test_serving_copy_owns_its_params_and_bf16_policy_is_close():
    conf = _port_conf(_small_graph_conf(use_kernels=True))
    net = ComputationGraph(conf, device="cpu").init()
    x = np.random.default_rng(4).normal(size=(3, 6, 6, 8)).astype(np.float32)
    want = net.output(x)
    copy = optimize_for_inference(net)
    copy.params["c1"]["W"].zero_()
    np.testing.assert_array_equal(net.output(x), want)
    half = optimize_for_inference(net, bf16=True)
    assert half.conf.compute_dtype == "bfloat16" and net.conf.compute_dtype \
        is None
    got = half.output(x)
    assert got.dtype == np.float32
    # bf16 compute: 8 mantissa bits through four layers
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
