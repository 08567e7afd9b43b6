"""The port's ``Yolo2OutputLayer`` and detection utilities against the JAX
package's, on the CPU (the cases of ``tests/test_objdetect.py``, each run
through both packages).

Inputs are the JAX layout (NHWC ``[b, H, W, nb*(5+C)]``) made from a seed
with numpy; the port's layer takes the logical NCHW view of the same
bytes. Forward, score (with and without the labels mask, several labelled
cells and a cell whose truth box sits between two priors) and the score's
gradient with respect to the input are compared; ``get_predicted_objects``
/ ``nms`` / ``iou`` give the JAX lists. A small detector trained by
``fit_batch`` (SGD) takes the JAX package's steps.

Tolerances: forwards rtol 1e-5, atol 1e-6 (sigmoid / exp / softmax in
float32); scores rtol 1e-5; gradients rtol 1e-4, atol 1e-6; detections
equal in example, class and order, boxes and confidences rtol 1e-5; the
training run's losses rtol 1e-5 and params rtol 1e-4, atol 1e-6 after 3
steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_objdetect as jod
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.conf.weights import WeightInit as JWI
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import layers_objdetect as od
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
PRIORS = ((1.0, 1.5), (3.0, 3.0))
C = 3
CH = 2 * (5 + C)


def _layers():
    jlayer = jod.Yolo2OutputLayer(boxes=PRIORS, lambda_coord=4.0,
                                  lambda_no_obj=0.3)
    return jlayer, serde.from_json(jserde.to_json(jlayer))


def _label_grid(b=2, h=4, w=4, c=C):
    """The JAX test's grid (one object per example at cell (1, 2)), plus a
    second object in example 1 at cell (3, 0) of class 2 whose box shape
    sits between the priors."""
    labels = np.zeros((b, h, w, 4 + c), np.float32)
    labels[:, 1, 2, 0:4] = [2.1, 1.2, 2.9, 1.9]
    labels[:, 1, 2, 4] = 1.0
    if b > 1:
        labels[1, 3, 0, 0:4] = [0.0, 2.2, 1.9, 4.0]
        labels[1, 3, 0, 4 + 2] = 1.0
    return labels


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(b=2, scale=1.0, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, 4, 4, CH))
            * scale).astype(np.float32)


def test_json_and_fields_match_jax():
    jlayer, layer = _layers()
    assert serde.to_json(layer) == jserde.to_json(jlayer)
    assert layer.boxes == PRIORS and layer.n_boxes == 2
    assert jserde.from_json(serde.to_json(layer)) == jlayer
    with pytest.raises(ValueError, match="priors"):
        od.Yolo2OutputLayer()


@pytest.mark.parametrize("scale", [0.1, 1.0, 3.0])
def test_forward_matches_jax(scale):
    jlayer, layer = _layers()
    x = _x(scale=scale)
    want = np.asarray(jlayer.forward({}, {}, jnp.asarray(x))[0])
    got, _ = layer.forward({}, {}, _nchw(x))
    assert got.shape == (2, CH, 4, 4)
    np.testing.assert_allclose(_nhwc(got), want, **FWD)
    grid = _nhwc(got).reshape(2, 4, 4, 2, 5 + C)
    assert (grid[..., 0] >= 0).all() and (grid[..., 0] <= 4).all()
    assert ((grid[..., 4] > 0) & (grid[..., 4] < 1)).all()
    np.testing.assert_allclose(grid[..., 5:].sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("scale", [0.1, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_score_and_its_gradient_match_jax(scale, masked):
    jlayer, layer = _layers()
    b = 3 if masked else 2
    x = _x(b=b, scale=scale, seed=1)
    labels = _label_grid(b=b)
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    js, jg = jax.value_and_grad(
        lambda xx: jlayer.score({}, xx, labels, mask))(jnp.asarray(x))
    tx = _nchw(x).requires_grad_(True)
    s = layer.score({}, tx, torch.tensor(labels),
                    None if mask is None else torch.tensor(mask))
    assert float(s.detach()) == pytest.approx(float(js), rel=1e-5)
    s.backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jg), **GRAD)
    assert np.abs(_nhwc(tx.grad)).sum() > 0


def test_mask_excludes_padded_examples():
    _, layer = _layers()
    x1 = _x(scale=0.1)
    labels = _label_grid(b=2)
    x2 = np.concatenate([x1, np.full((1, 4, 4, CH), 5.0, np.float32)])
    labels2 = np.concatenate([labels, np.zeros((1, 4, 4, 4 + C),
                                               np.float32)])
    unmasked = layer.score({}, _nchw(x1), torch.tensor(labels))
    masked = layer.score({}, _nchw(x2), torch.tensor(labels2),
                         mask=torch.tensor([1.0, 1.0, 0.0]))
    assert float(masked) == pytest.approx(float(unmasked), rel=1e-6)


def test_bad_depth_raises():
    _, layer = _layers()
    with pytest.raises(ValueError, match="nBoxes"):
        layer.forward({}, {}, torch.zeros((1, 15, 4, 4)))


def _hand_grid():
    """The JAX test's activated grid: a strong and an overlapping weaker
    box of class 1 in cell (1, 2), a distant class-0 box, and a second
    example with two boxes of one class far apart."""
    act = np.zeros((2, 4, 4, 2, 5 + C), np.float32)
    act[0, 1, 2, 0] = [2.5, 1.5, 1.0, 1.0, 0.9, 0.05, 0.9, 0.05]
    act[0, 1, 2, 1] = [2.6, 1.4, 1.2, 1.2, 0.6, 0.05, 0.9, 0.05]
    act[0, 3, 0, 0] = [0.5, 3.5, 1.0, 1.0, 0.8, 0.9, 0.05, 0.05]
    act[1, 0, 0, 1] = [0.5, 0.5, 1.0, 1.0, 0.7, 0.05, 0.05, 0.9]
    act[1, 3, 3, 0] = [3.5, 3.5, 1.0, 1.0, 0.95, 0.05, 0.05, 0.9]
    return act.reshape(2, 4, 4, CH)


def _same_objects(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.example, g.predicted_class) == (w.example,
                                                  w.predicted_class)
        np.testing.assert_allclose(
            [g.center_x, g.center_y, g.width, g.height, g.confidence],
            [w.center_x, w.center_y, w.width, w.height, w.confidence],
            rtol=1e-5)
        np.testing.assert_allclose(g.class_probs, w.class_probs, rtol=1e-5)


@pytest.mark.parametrize("threshold,iou_t", [(0.4, 0.4), (0.5, 0.45),
                                             (0.1, 0.9)])
def test_get_predicted_objects_and_nms_match_jax(threshold, iou_t):
    jlayer, layer = _layers()
    act = _hand_grid()
    want = jod.get_predicted_objects(jlayer, act, threshold=threshold)
    got = od.get_predicted_objects(layer, act, threshold=threshold)
    _same_objects(got, want)
    _same_objects(od.get_predicted_objects(layer, torch.tensor(act),
                                           threshold=threshold), want)
    _same_objects(od.nms(got, iou_threshold=iou_t),
                  jod.nms(want, iou_threshold=iou_t))


def test_jax_case_counts():
    _, layer = _layers()
    objs = od.get_predicted_objects(layer, _hand_grid()[:1], threshold=0.4)
    assert len(objs) == 3
    kept = od.nms(objs, iou_threshold=0.4)
    assert sorted(o.predicted_class for o in kept) == [0, 1]


def test_detections_of_a_forward_match_jax():
    """The utilities on the layer's own output, as a served answer."""
    jlayer, layer = _layers()
    x = _x(scale=2.0, seed=3)
    want_act = np.asarray(jlayer.forward({}, {}, jnp.asarray(x))[0])
    got_act = _nhwc(layer.forward({}, {}, _nchw(x))[0])
    t = float(np.quantile(want_act.reshape(2, 4, 4, 2, -1)[..., 4]
                          * want_act.reshape(2, 4, 4, 2, -1)[..., 5:].max(-1),
                          0.8))
    want = jod.nms(jod.get_predicted_objects(jlayer, want_act, t))
    got = od.nms(od.get_predicted_objects(layer, got_act, t))
    assert len(want) > 2
    _same_objects(got, want)


@pytest.mark.parametrize("a,b", [
    ((1.0, 1.0, 2.0, 2.0), (1.0, 1.0, 2.0, 2.0)),
    ((1.0, 1.0, 2.0, 2.0), (10.0, 10.0, 2.0, 2.0)),
    ((1.0, 1.0, 2.0, 2.0), (2.0, 1.5, 2.0, 3.0)),
    ((0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0))])
def test_iou_matches_jax(a, b):
    pa, pb = (od.DetectedObject(0, *v, 0, 1.0) for v in (a, b))
    ja, jb = (jod.DetectedObject(0, *v, 0, 1.0) for v in (a, b))
    assert od.iou(pa, pb) == pytest.approx(jod.iou(ja, jb))
    assert pa.top_left == ja.top_left and pa.bottom_right == ja.bottom_right


def _detector_jconf():
    g = (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.05))
         .weight_init(JWI.XAVIER).graph_builder().add_inputs("input")
         .set_input_types(JIT.convolutional(16, 16, 3)))
    g.add_layer("c1", JConv(n_out=8, kernel_size=(3, 3), stride=(2, 2),
                            activation=JAct.RELU,
                            convolution_mode=JMode.SAME), "input")
    g.add_layer("c2", JConv(n_out=8, kernel_size=(3, 3), stride=(2, 2),
                            activation=JAct.RELU,
                            convolution_mode=JMode.SAME), "c1")
    g.add_layer("detect", JConv(n_out=CH, kernel_size=(1, 1),
                                activation=JAct.IDENTITY,
                                convolution_mode=JMode.SAME), "c2")
    g.add_layer("yolo", jod.Yolo2OutputLayer(boxes=PRIORS), "detect")
    g.set_outputs("yolo")
    return g.build()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_detector_trains_like_jax(use_kernels):
    """``fit_batch`` through the YOLOv2 loss, 3 SGD steps in each package
    from the same params (the 1x1 detection conv on the routing's plain
    twin of the kernel with ``use_kernels``): losses and params agree and
    the loss falls."""
    jconf = _detector_jconf()
    jnet = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    conf = dataclasses.replace(conf, use_kernels=use_kernels)
    p, s = params_from_jax(conf, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params), {})
    net = ComputationGraph(conf, device="cpu").set_params(p, s)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    labels = _label_grid()
    losses, jlosses = [], []
    for _ in range(3):
        losses.append(net.fit_batch(DataSet(feats, labels)))
        jlosses.append(float(jnet.fit_batch(JDataSet(feats, labels))))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k, vp in params_from_jax(
            conf, jax.tree_util.tree_map(np.asarray, jnet.params),
            {})[0].items():
        for name, v in vp.items():
            np.testing.assert_allclose(net.params[k][name].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k}.{name}")
    np.testing.assert_allclose(net.output(feats),
                               np.asarray(jnet.output(feats)), **FWD)
