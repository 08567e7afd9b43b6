"""The port's dense-output zoo models against the JAX package's, on the
CPU: ``UNet`` (per-pixel sigmoid head), ``TinyYOLO`` and ``YOLO2``
(``Yolo2OutputLayer`` heads, YOLO2's passthrough through
``SpaceToDepthLayer`` and ``MergeVertex``) at the sizes of
``tests/test_zoo.py`` (and their JSON at the zoo defaults too).

Per model: the JSON crosses both ways; topo order, param shapes and count
equal the JAX package's; the port network carried by ``params_from_jax``
gives the JAX output on the stock and the kernel route (one routed call a
site), and YOLO2's detections (``get_predicted_objects`` + ``nms``) are the
JAX lists. One SGD ``fit_batch`` of UNet (``CnnLossLayer`` with
``LossBinaryXENT``) and of TinyYOLO (the YOLOv2 loss), train-mode batch
norms included, takes the JAX step: the loss, every param's update and the
BN running statistics. A small YOLO2's ModelSerializer zip crosses both
ways.

Tolerances: outputs as ``tests/torch_zoo_cases.py`` (rtol 1e-4, atol
1e-6; the head's input within 1e-4 of its largest magnitude); the loss rtol
1e-5; each param after the step within 1e-3 of its update's largest
magnitude (a gradient of float32 sums in other orders, through train-mode
BN over a few positions) plus 2 ulp of the param (each side rounds
``p - lr * g``); the running statistics rtol 1e-5, atol 1e-6.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.conf.layers_objdetect import (
    get_predicted_objects as jget,
)
from deeplearning4j_tpu.conf.layers_objdetect import nms as jnms
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu.zoo import graphs as jzoo
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers_objdetect import (
    get_predicted_objects,
    nms,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.zoo import graphs as zoo

from tests import torch_zoo_cases as cases
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

MODELS = {
    "UNet": dict(height=32, width=32, channels=1, base=8),
    "TinyYOLO": dict(num_classes=3, height=64, width=64),
    "YOLO2": dict(num_classes=3, height=64, width=64),
}
NAMES = sorted(MODELS)
FULL_SITES = {"UNet": 1, "TinyYOLO": 1, "YOLO2": 8}
LR = 0.01
UPDATE_RTOL = 1e-3


def _models(name, **extra):
    kw = dict(MODELS[name], **extra)
    return getattr(jzoo, name)(**kw), getattr(zoo, name)(**kw)


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

    conf = getattr(zoo, name)().conf()
    assert len(routing.routed_sites(conf, 8, mode="cuda")) == \
        FULL_SITES[name]
    out = conf.vertex_output_types()[conf.network_outputs[0]]
    want = ((128, 128, 1) if name == "UNet" else
            (13, 13, 5 * (5 + (20 if name == "TinyYOLO" else 80))))
    assert (out.height, out.width, out.channels) == want


@pytest.mark.parametrize("name", NAMES)
def test_output_matches_jax_stock_route(name, runs, monkeypatch):
    net = cases.check_output(runs(name), monkeypatch, use_kernels=False)
    out = net.output(runs(name)["x"])
    if name == "UNet":
        assert out.shape == (2, 32, 32, 1)
        assert ((out >= 0) & (out <= 1)).all()
    else:
        assert out.shape == (2, 2, 2, 40)


@pytest.mark.parametrize("name", NAMES)
def test_output_matches_jax_kernel_route(name, runs, monkeypatch):
    cases.check_output(runs(name), monkeypatch, use_kernels=True)


def test_yolo2_detections_match_jax(runs):
    """``get_predicted_objects`` + ``nms`` on the port's and the JAX
    package's outputs, at the JAX output's 90th-percentile score (a
    random detector's class probabilities sit near 1/3)."""
    r = runs("YOLO2")
    layer = r["jconf"].vertex_map()["yolo"].vertex.layer
    net = cases.port_net_from_jax(r["jconf"], r["jnet"], use_kernels=True)
    got_out = net.output(r["x"])
    grid = r["out"].reshape(2, 2, 2, 5, 8)
    t = float(np.quantile(grid[..., 4] * grid[..., 5:].max(-1), 0.9))
    want = jnms(jget(layer, r["out"], t))
    got = nms(get_predicted_objects(
        net.conf.vertex_map()["yolo"].vertex.layer, got_out, t))
    assert len(want) >= 2
    assert [(o.example, o.predicted_class) for o in got] == \
        [(o.example, o.predicted_class) for o in want]
    np.testing.assert_allclose(
        [[o.center_x, o.center_y, o.width, o.height, o.confidence]
         for o in got],
        [[o.center_x, o.center_y, o.width, o.height, o.confidence]
         for o in want], rtol=1e-4)


def _labels(name, rng):
    if name == "UNet":
        return (rng.uniform(size=(2, 32, 32, 1)) > 0.5).astype(np.float32)
    labels = np.zeros((2, 2, 2, 4 + 3), np.float32)
    labels[0, 0, 1, :4] = [1.1, 0.2, 1.8, 0.9]
    labels[0, 0, 1, 4 + 2] = 1.0
    labels[1, 1, 0, :4] = [0.0, 1.3, 0.9, 2.0]
    labels[1, 1, 0, 4] = 1.0
    return labels


def _pool_tie_gaps(jconf, acts):
    """The smallest relative gap between the two largest values of any
    max-pool window (2x2, stride 2) in a JAX train-mode forward's
    activations ``acts``, over the windows whose largest value is not an
    exact zero (a ReLU's: no gradient passes there in either package)."""
    gaps = []
    for name in jconf.topo_order():
        layer = getattr(jconf.vertex_map()[name].vertex, "layer", None)
        if type(layer).__name__ != "SubsamplingLayer" \
                or tuple(layer.stride) != (2, 2):
            continue
        v = np.asarray(acts[jconf.vertex_map()[name].inputs[0]])
        n, h, w, c = v.shape
        win = v.reshape(n, h // 2, 2, w // 2, 2, c).transpose(
            0, 1, 3, 5, 2, 4).reshape(-1, 4)
        top = np.sort(win, -1)
        top = top[top[:, -1] != 0.0]  # ReLU zeros: no gradient either way
        gaps.append(float(((top[:, -1] - top[:, -2])
                           / np.abs(top[:, -1])).min()))
    return min(gaps)


@pytest.mark.parametrize("name", ["UNet", "TinyYOLO"])
def test_one_sgd_step_matches_jax(name):
    """The batch is seeded so that no max-pool window of the train-mode
    forward is within 1e-5 (relative; the forwards agree to ~3e-6) of a
    tie: where two values lie
    within the packages' rounding of each other, each package routes the
    window's gradient to the element its own rounding makes larger, and
    every layer below takes another (equally right) gradient. The test
    asserts that precondition rather than assume it."""
    jm, _ = _models(name, updater=JSgd(learning_rate=LR))
    jconf = jm.conf()
    net = ComputationGraph(cases.port_conf(jconf), device="cpu").init()
    cases.randomize_bn(net, 3)
    jnet = cases.jax_net_like(jconf, net)
    before = {k: {pk: v.clone() for pk, v in vp.items()}
              for k, vp in net.params.items()}
    rng = np.random.default_rng(5)
    t = jconf.input_types[0]
    x = rng.random((2, t.height, t.width, t.channels)).astype(np.float32)
    y = _labels(name, rng)
    acts = jnet._forward(jnet.params, jnet.state, (x,), True,
                         jnet._base_key)[0]
    assert _pool_tie_gaps(jconf, acts) > 1e-5
    loss = net.fit_batch(DataSet(x, y))
    jloss = float(jnet.fit_batch(JDataSet(x, y)))
    assert loss == pytest.approx(jloss, rel=1e-5)
    jparams = cases.np_tree(jnet.params)
    port, _ = cases.params_to_jax(net.conf, net.params, net.state)
    start, _ = cases.params_to_jax(net.conf, before, net.state)
    for k, vp in jparams.items():
        for pk, v in vp.items():
            # the update within UPDATE_RTOL of its largest magnitude, plus
            # the rounding of each side's p - lr * g (2 ulp of p)
            scale = float(np.abs(v - start[k][pk]).max())
            bound = UPDATE_RTOL * scale + 2.0 ** -22 * np.abs(start[k][pk])
            assert (np.abs(port[k][pk] - v) <= bound).all(), f"{k}.{pk}"
    for k, st in cases.np_tree(jnet.state).items():
        for sk, v in st.items():
            np.testing.assert_allclose(net.state[k][sk].numpy(), v,
                                       rtol=1e-5, atol=1e-6)


def test_yolo2_zip_crosses_both_ways(runs, tmp_path):
    """The port's zip of YOLO2 (50.6 M float32 params) read by the JAX
    package and the JAX package's zip read by the port. The port writes its
    entries stored (``compress=False``): the same entries and bytes, less
    deflate's ~15 s on 200 MB (the deflated container crosses in
    ``test_torch_serializer.py``); the JAX zip is its own, deflated."""
    r = runs("YOLO2")
    assert "route_s2d" in r["jconf"].topo_order()
    net = cases.port_net_from_jax(r["jconf"], r["jnet"])
    path = tmp_path / "port.zip"
    ser.write_model(net, path, compress=False)
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
    np.testing.assert_allclose(again.output(r["x"]), r["out"],
                               **cases.OUT_TOL)
