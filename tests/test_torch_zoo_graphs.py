"""The port's zoo classifiers against the JAX package's, on the CPU:
``VGG16``, ``VGG19``, ``SqueezeNet``, ``Darknet19``, ``Xception``,
``InceptionResNetV1`` and ``NASNet`` at the sizes of ``tests/test_zoo.py``
(and their JSON at the zoo defaults too).

Per model: the configuration JSON is the JAX package's and crosses both
ways; topo order, every param shape and the param count equal the JAX
package's; the port network carried from the JAX one by
``params_from_jax`` gives its output on the stock route and on the kernel
route (``use_kernels``: the routing's plain twin of ``matmul_bias_act`` at
every routed 1x1 conv and dense layer, one call a site). A small
Xception's ModelSerializer zip crosses both ways. Each model's JAX run is
built once per module (its first forward compiles for seconds).

Tolerances (``tests/torch_zoo_cases.py``): the output rtol 1e-4, atol 1e-6;
the activation feeding the head within 1e-4 of its largest magnitude
(float32 through up to ~60 layers, sums in other orders on each side);
params through the zip bit for bit.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu.zoo import graphs as jzoo
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.zoo import graphs as zoo

from tests import torch_zoo_cases as cases
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

MODELS = {
    "VGG16": dict(num_classes=10, height=64, width=64),
    "VGG19": dict(num_classes=10, height=64, width=64),
    "SqueezeNet": dict(num_classes=10, height=96, width=96),
    "Darknet19": dict(num_classes=10, height=64, width=64),
    "Xception": dict(num_classes=5, height=71, width=71,
                     middle_flow_repeats=1),
    "InceptionResNetV1": dict(num_classes=5, height=96, width=96,
                              blocks_a=1, blocks_b=1, blocks_c=1),
    "NASNet": dict(num_classes=5, height=32, width=32, num_cells=1,
                   penultimate_filters=96),
}
NAMES = sorted(MODELS)
# routed sites a forward at the zoo defaults (1x1 convs and dense layers)
FULL_SITES = {"VGG16": 2, "VGG19": 2, "SqueezeNet": 17, "Darknet19": 7,
              "Xception": 4, "InceptionResNetV1": 71, "NASNet": 28}


def _models(name):
    return getattr(jzoo, name)(**MODELS[name]), getattr(zoo, name)(
        **MODELS[name])


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = cases.jax_run(_models(name)[0])
        return cache[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_conf_json_is_the_jax_packages_both_ways(name):
    for jm, m in (_models(name), (getattr(jzoo, name)(),
                                  getattr(zoo, name)())):
        js, s = jm.conf().to_json(), m.conf().to_json()
        assert json.loads(s) == json.loads(js)
        assert ComputationGraphConfiguration.from_json(js).to_json() == js
        assert type(jm.conf()).from_json(s).to_json() == s


@pytest.mark.parametrize("name", NAMES)
def test_topology_and_param_shapes_match_jax(name):
    cases.check_param_shapes(_models(name)[0].conf())


@pytest.mark.parametrize("name", NAMES)
def test_routed_sites_at_the_zoo_defaults(name):
    from deeplearning4j_tpu_torch.kernels import routing

    sites = routing.routed_sites(getattr(zoo, name)().conf(), 8, mode="cuda")
    assert len(sites) == FULL_SITES[name]
    assert {kid for _, kid, _ in sites} == {"matmul_bias_act"}


@pytest.mark.parametrize("name", NAMES)
def test_output_matches_jax_stock_route(name, runs, monkeypatch):
    cases.check_output(runs(name), monkeypatch, use_kernels=False)


@pytest.mark.parametrize("name", NAMES)
def test_output_matches_jax_kernel_route(name, runs, monkeypatch):
    cases.check_output(runs(name), monkeypatch, use_kernels=True)


def test_vgg16_dense_sites_are_fc1_fc2():
    from deeplearning4j_tpu_torch.kernels import routing

    sites = routing.routed_sites(zoo.VGG16().conf(), 8, mode="cuda")
    assert [(s, e.m, e.k, e.n, e.act) for s, _, e in sites] == [
        ("fc1", 8, 25088, 4096, "relu"), ("fc2", 8, 4096, 4096, "relu")]


def test_xception_zip_crosses_both_ways(runs, tmp_path):
    r = runs("Xception")
    net = cases.port_net_from_jax(r["jconf"], r["jnet"])
    path = tmp_path / "port.zip"
    ser.write_model(net, path)
    back = jser.restore_computation_graph(path)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  net.params_flat())
    np.testing.assert_allclose(np.asarray(back.output(r["x"])), r["out"],
                               **cases.OUT_TOL)
    jpath = tmp_path / "jax.zip"
    jser.write_model(r["jnet"], jpath)
    again = ser.restore_computation_graph(jpath, device="cpu")
    np.testing.assert_array_equal(again.params_flat(),
                                  np.asarray(r["jnet"].params_flat()))
    for k, st in again.state.items():
        for sk, v in st.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(r["jnet"].state[k][sk]))
    np.testing.assert_allclose(again.output(r["x"]), r["out"],
                               **cases.OUT_TOL)
