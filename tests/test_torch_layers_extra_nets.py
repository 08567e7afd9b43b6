"""Networks of the ``conf/layers_extra.py`` layers in the port against the
JAX package, on the CPU.

- The 3-D flatten: a ``Convolution3D -> Subsampling3DLayer -> DenseLayer
  -> OutputLayer`` MultiLayerNetwork gets its
  ``Cnn3DToFeedForwardPreProcessor`` where the JAX configuration has it,
  and from the JAX params gives the JAX outputs and the JAX SGD step
  (gradients through the NDHWC flatten order).
- A C3D-shaped MultiLayerNetwork (Tran et al. 2015's layer pattern at a
  narrow width, pool1 1x2x2, pool5 SAME) trained two SGD steps, and a
  MobileNet-v1-shaped graph (Howard et al. 2017's depthwise-separable
  blocks: depthwise 3x3, BN, ReLU, pointwise 1x1, BN, ReLU, a stride-2
  block at an odd size) served and trained a step, against the JAX
  package; their ``kernels.routed_sites`` are the dense layers and the
  pointwise convs (a depthwise conv is never routed).
- Nets holding every new layer, the 1-D layers under ragged masks, carried
  across the ModelSerializer zip both ways (a trained net's Adam state
  too); ``rnn_time_step`` refuses each 1-D layer as the JAX package does.

Tolerances: networks rtol 1e-4, atol 1e-6 (several layers of float32
rounding); scores rtol 1e-5; params after SGD steps atol 2e-6 (the
gradients summed in other orders, times the learning rate); zips bit for
bit.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_extra as jx
from deeplearning4j_tpu.conf.layers import ActivationLayer as JActLayer
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JCM
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.layers_rnn import LSTM as JLSTM
from deeplearning4j_tpu.conf.layers_rnn import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import params as jparams
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers_extra import (
    Cnn3DToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.kernels import routing
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import params as pparams
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.util.convert import (
    params_from_jax,
    params_to_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

NET = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=0, atol=2e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jconf, jnet):
    if hasattr(jconf, "vertices"):
        conf = ComputationGraphConfiguration.from_json(jconf.to_json())
        cls = ComputationGraph
    else:
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        cls = MultiLayerNetwork
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return cls(conf, device="cpu").set_params(p, s)


def _same_params(net, jnet, **tol):
    want = _np(jnet.params)
    got, _ = params_to_jax(net.conf, net.params, net.state)
    for k, vp in want.items():
        for name, v in vp.items():
            np.testing.assert_allclose(got[k][name], v, err_msg=f"{k}/{name}",
                                       **tol)


def _onehot(rng, n, classes, t=None):
    shape = (n,) if t is None else (n, t)
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, shape)]


# --------------------------------------------------------------------------
# the 3-D flatten
# --------------------------------------------------------------------------

def _flat3d_jconf():
    return (JNNC.builder().seed(3).updater(JSgd(learning_rate=0.1)).list()
            .layer(jx.Convolution3D(n_out=4, kernel_size=(3, 3, 3),
                                    activation=JAct.RELU))
            .layer(jx.Subsampling3DLayer(kernel_size=(2, 2, 2),
                                         stride=(2, 2, 2),
                                         convolution_mode=JCM.SAME))
            .layer(JDense(n_out=6, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional_3d(3, 5, 4, 2)).build())


def test_3d_cnn_then_dense_gets_the_preprocessor_where_jax_puts_it():
    jconf = _flat3d_jconf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    names = [type(layer).__name__ for layer in conf.layers]
    assert names == [type(layer).__name__ for layer in jconf.layers]
    assert names[2] == "Cnn3DToFeedForwardPreProcessor"
    pre = conf.layers[2]
    assert isinstance(pre, Cnn3DToFeedForwardPreProcessor)
    assert (pre.depth, pre.height, pre.width, pre.channels) == (2, 3, 2, 4)
    # the port's own builder inserts it too, with the same JSON
    from deeplearning4j_tpu_torch.conf import layers_extra as px
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.conf.updaters import Sgd

    built = (NeuralNetConfiguration.builder().seed(3)
             .updater(Sgd(learning_rate=0.1)).list()
             .layer(px.Convolution3D(n_out=4, kernel_size=(3, 3, 3),
                                     activation=Activation.RELU))
             .layer(px.Subsampling3DLayer(
                 kernel_size=(2, 2, 2), stride=(2, 2, 2),
                 convolution_mode=px.ConvolutionMode.SAME))
             .layer(DenseLayer(n_out=6, activation=Activation.TANH))
             .layer(OutputLayer(n_out=3))
             .set_input_type(InputType.convolutional_3d(3, 5, 4, 2)).build())
    assert built.to_json() == conf.to_json()


def test_3d_cnn_then_dense_gives_the_jax_outputs_and_step():
    jconf = _flat3d_jconf()
    jnet = JMLN(jconf).init()
    net = _port(jconf, jnet)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 5, 4, 2)).astype(np.float32)
    y = _onehot(rng, 4, 3)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    _same_params(net, jnet, **STEP)


# --------------------------------------------------------------------------
# C3D- and MobileNet-shaped networks
# --------------------------------------------------------------------------

def _c3d_jconf(width=4):
    b = (JNNC.builder().seed(7).updater(JSgd(learning_rate=0.05)).list())
    b.layer(jx.Convolution3D(n_out=width, kernel_size=(3, 3, 3),
                             activation=JAct.RELU))
    b.layer(jx.Subsampling3DLayer(kernel_size=(1, 2, 2), stride=(1, 2, 2)))
    b.layer(jx.Convolution3D(n_out=2 * width, kernel_size=(3, 3, 3),
                             activation=JAct.RELU))
    b.layer(jx.Subsampling3DLayer(kernel_size=(2, 2, 2), stride=(2, 2, 2)))
    b.layer(jx.Convolution3D(n_out=2 * width, kernel_size=(3, 3, 3),
                             activation=JAct.RELU))
    b.layer(jx.Subsampling3DLayer(kernel_size=(2, 2, 2), stride=(2, 2, 2),
                                  convolution_mode=JCM.SAME))
    b.layer(JDense(n_out=16, activation=JAct.RELU))
    b.layer(JDense(n_out=16, activation=JAct.RELU))
    b.layer(JOut(n_out=5, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
    return b.set_input_type(JIT.convolutional_3d(4, 12, 12, 3)).build()


def test_c3d_shaped_net_trains_as_the_jax_net():
    jconf = _c3d_jconf()
    jnet = JMLN(jconf).init()
    net = _port(jconf, jnet)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4, 12, 12, 3)).astype(np.float32)
    y = _onehot(rng, 3, 5)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    for _ in range(2):
        assert net.fit_batch(DataSet(x, y)) == pytest.approx(
            float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    _same_params(net, jnet, **STEP)
    sites = routing.routed_sites(net.conf, 3, mode="cuda")
    assert [(s, e.k, e.n) for s, _, e in sites] == [
        ("7", 8 * 1 * 2 * 2, 16), ("8", 16, 16)]


def _mobilenet_jconf():
    g = (JNNC.builder().seed(11).updater(JSgd(learning_rate=0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.convolutional(11, 11, 3)))

    def conv_bn(name, src, layer):
        g.add_layer(name, layer, src)
        g.add_layer(f"{name}_bn", JBN(), name)
        g.add_layer(f"{name}_relu", JActLayer(activation=JAct.RELU),
                    f"{name}_bn")
        return f"{name}_relu"

    h = conv_bn("conv0", "in", JConv(n_out=4, kernel_size=(3, 3),
                                     stride=(2, 2), has_bias=False,
                                     convolution_mode=JCM.SAME))
    for i, (stride, n_out) in enumerate([((1, 1), 8), ((2, 2), 8)]):
        h = conv_bn(f"dw{i}", h, jx.DepthwiseConvolution2D(
            kernel_size=(3, 3), stride=stride, has_bias=False))
        h = conv_bn(f"pw{i}", h, JConv(n_out=n_out, kernel_size=(1, 1),
                                       has_bias=False,
                                       convolution_mode=JCM.SAME))
    g.add_layer("gap", JGP(pooling_type=JPT.AVG), h)
    g.add_layer("out", JOut(n_out=5, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()), "gap")
    g.set_outputs("out")
    return g.build()


def test_mobilenet_shaped_graph_serves_and_trains_as_the_jax_graph():
    jconf = _mobilenet_jconf()
    jnet = JGraph(jconf).init()
    rng = np.random.default_rng(12)
    # seeded running statistics, so that eval mode reads them
    for name, st in jnet.state.items():
        jnet.state[name] = {
            "mean": jax.numpy.asarray(
                0.1 * rng.standard_normal(np.shape(st["mean"])), np.float32),
            "var": jax.numpy.asarray(
                rng.uniform(0.5, 1.5, np.shape(st["var"])), np.float32)}
    net = _port(jconf, jnet)
    x = rng.standard_normal((3, 11, 11, 3)).astype(np.float32)
    y = _onehot(rng, 3, 5)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    _same_params(net, jnet, **STEP)
    for name, st in _np(jnet.state).items():
        for key, v in st.items():
            np.testing.assert_allclose(net.state[name][key].numpy(), v,
                                       rtol=1e-5, atol=1e-6)
    sites = routing.routed_sites(net.conf, 3, mode="cuda")
    assert [s for s, _, _ in sites] == ["pw0", "pw1"]
    assert [(e.m, e.k, e.n) for _, _, e in sites] == [(3 * 6 * 6, 4, 8),
                                                      (3 * 3 * 3, 8, 8)]


# --------------------------------------------------------------------------
# every new layer in a net: masks, zips, rnn_time_step
# --------------------------------------------------------------------------

T_SEQ = 12


def _seq_jconf():
    """[b, 12, 4] through the 1-D resizing layers (15, 8, 16, 14 steps),
    the mask layer (the mask resized by each), PReLU, the elementwise scale
    and a locally connected layer back to 12 steps."""
    return (JNNC.builder().seed(21).updater(JAdam(learning_rate=1e-2)).list()
            .layer(jx.ZeroPadding1DLayer(padding=(1, 2)))
            .layer(jx.Subsampling1DLayer(kernel_size=2, stride=2,
                                         convolution_mode=JCM.SAME))
            .layer(jx.Upsampling1D(size=2))
            .layer(jx.Cropping1D(cropping=(1, 1)))
            .layer(jx.MaskLayer())
            .layer(jx.PReLULayer())
            .layer(jx.ElementWiseMultiplicationLayer(activation=JAct.TANH))
            .layer(jx.LocallyConnected1D(n_out=6, kernel_size=3,
                                         activation=JAct.TANH))
            .layer(JRnnOut(n_out=3, activation=JAct.SOFTMAX,
                           loss_fn=JMCXENT()))
            .set_input_type(JIT.recurrent(4, timesteps=T_SEQ)).build())


def _volume_jconf():
    return (JNNC.builder().seed(22).updater(JAdam(learning_rate=1e-2)).list()
            .layer(jx.Convolution3D(n_out=3, kernel_size=(2, 2, 2),
                                    stride=(1, 2, 2), activation=JAct.RELU))
            .layer(jx.ZeroPadding3DLayer(padding=(1, 0, 0, 1, 1, 1)))
            .layer(jx.Cropping3D(cropping=(0, 1, 1, 0, 0, 1)))
            .layer(jx.Upsampling3D(size=(1, 2, 1)))
            .layer(jx.Subsampling3DLayer(pooling_type=JPT.PNORM,
                                         kernel_size=(2, 2, 2),
                                         stride=(1, 2, 2)))
            .layer(jx.PReLULayer())
            .layer(JDense(n_out=5, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional_3d(3, 6, 5, 2)).build())


def _image_jconf():
    """Depthwise and locally connected convs, a channels-moving Permute,
    then a vector repeated into a sequence and permuted."""
    return (JNNC.builder().seed(23).updater(JAdam(learning_rate=1e-2)).list()
            .layer(jx.DepthwiseConvolution2D(depth_multiplier=2,
                                             stride=(2, 2),
                                             activation=JAct.RELU))
            .layer(jx.LocallyConnected2D(n_out=4, kernel_size=(2, 2),
                                         activation=JAct.TANH))
            .layer(jx.Permute(dims=(3, 1, 2)))
            .layer(jx.PReLULayer())
            .layer(JDense(n_out=6, activation=JAct.TANH))
            .layer(jx.RepeatVector(repetition_factor=3))
            .layer(jx.Permute(dims=(2, 1)))
            .layer(JRnnOut(n_out=2, activation=JAct.SOFTMAX,
                           loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(7, 9, 3)).build())


def _batch(kind, rng, n=3):
    if kind == "seq":
        x = rng.standard_normal((n, T_SEQ, 4)).astype(np.float32)
        return x, _onehot(rng, n, 3, T_SEQ)
    if kind == "volume":
        x = rng.standard_normal((n, 3, 6, 5, 2)).astype(np.float32)
        return x, _onehot(rng, n, 3)
    x = rng.standard_normal((n, 7, 9, 3)).astype(np.float32)
    return x, _onehot(rng, n, 2, 6)


JCONFS = {"seq": _seq_jconf, "volume": _volume_jconf, "image": _image_jconf}


@pytest.mark.parametrize("kind", sorted(JCONFS))
def test_net_of_new_layers_gives_the_jax_outputs(kind):
    jconf = JCONFS[kind]()
    jnet = JMLN(jconf).init()
    net = _port(jconf, jnet)
    x, _ = _batch(kind, np.random.default_rng(30))
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)


def test_ragged_masks_through_the_1d_layers_match_jax():
    """A feature mask resized by every 1-D layer reaches the mask layer;
    outputs and the masked score agree."""
    jconf = _seq_jconf()
    jnet = JMLN(jconf).init()
    net = _port(jconf, jnet)
    rng = np.random.default_rng(31)
    x, y = _batch("seq", rng)
    fmask = np.ones((3, T_SEQ), np.float32)
    fmask[1, 7:] = 0
    fmask[2, 2:] = 0
    got = net.output(x, fmask=fmask)
    want = np.asarray(jnet.output(x, fmask=fmask))
    np.testing.assert_allclose(got, want, **NET)
    assert not np.allclose(got, net.output(x))  # the mask reached a layer
    ds = DataSet(x, y, features_mask=fmask, labels_mask=fmask)
    jds = JDataSet(x, y, features_mask=fmask, labels_mask=fmask)
    assert net.score(ds) == pytest.approx(float(jnet.score(jds)), rel=1e-5)


@pytest.mark.parametrize("kind", sorted(JCONFS))
def test_trained_zip_crosses_both_ways(kind, tmp_path):
    """One Adam step in the JAX package, its zip restored in the port
    (params and updater state bit for bit, the next step agrees), and the
    port's zip restored in the JAX package (params bit for bit, the same
    outputs)."""
    jconf = JCONFS[kind]()
    jnet = JMLN(jconf).init()
    x, y = _batch(kind, np.random.default_rng(32))
    jnet.fit_batch(JDataSet(x, y))
    jpath = tmp_path / "jax.zip"
    jser.write_model(jnet, jpath)
    net = ser.restore_multi_layer_network(jpath, device="cpu")
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(
        pparams.flatten_state_like(net.conf, net.opt_state),
        jparams.flatten_state_like(_np(jnet.opt_state)))
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    path = tmp_path / "port.zip"
    ser.write_model(net, path)
    back = jser.restore_multi_layer_network(path)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  net.params_flat())
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x),
                               **NET)


@pytest.mark.parametrize("jlayer", [
    jx.Subsampling1DLayer(kernel_size=2, stride=2),
    jx.Upsampling1D(size=2),
    jx.Cropping1D(cropping=(1, 0)),
    jx.ZeroPadding1DLayer(padding=(1, 0)),
    jx.LocallyConnected1D(n_out=5, kernel_size=2),
], ids=lambda layer: type(layer).__name__)
def test_rnn_time_step_refuses_each_1d_layer_as_jax_does(jlayer):
    jconf = (JNNC.builder().seed(5).list()
             .layer(JLSTM(n_out=5))
             .layer(jlayer)
             .layer(JRnnOut(n_out=3, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
             .set_input_type(JIT.recurrent(4, timesteps=6)).build())
    jnet = JMLN(jconf).init()
    net = _port(jconf, jnet)
    x = np.random.default_rng(33).standard_normal((2, 6, 4)).astype(
        np.float32)
    name = type(jlayer).__name__
    with pytest.raises(RuntimeError, match=name):
        jnet.rnn_time_step(x[:, :3])
    with pytest.raises(RuntimeError, match=name):
        net.rnn_time_step(x[:, :3])
