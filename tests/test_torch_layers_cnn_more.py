"""The port's remaining CNN layers against the JAX package's, on the CPU.

``SeparableConvolution2D`` (multiplier 1 and 2, stride 2 SAME at odd
sizes, explicit padding, dilation), ``Deconvolution2D`` ((k, s) in (3, 2),
(2, 2), (4, 2), (3, 1) SAME, and TRUNCATE with p 1, at odd sizes),
``Convolution1DLayer`` (SAME, strided TRUNCATE, pointwise; its
``resize_mask`` and ``streaming_safe``; ``rnn_time_step``), ``Upsampling2D``,
``Cropping2D`` and ``CnnLossLayer`` (with a mask): the same configuration
(carried through the JSON), the same seeded weights (drawn with numpy in
the JAX layouts, carried by ``util.convert``), the same inputs. Forwards,
``output_type`` and the gradients of ``sum(y * r)`` with respect to the
params and the input are compared; ``fold_scale_shift`` against the JAX
fold. Networks built by the JAX package carry over by ``params_from_jax``
and give its outputs; the updater state of a trained separable net
crosses in the ModelSerializer zip.

Tolerances: forwards rtol 1e-5, atol 1e-6 (float32 sums of at most 8 x 7 x
7 terms in other orders); gradients rtol 1e-4, atol 1e-5 (the transposed
products summed in other orders); scores rtol 1e-5; networks rtol 1e-4,
atol 1e-6 (several layers of float32 rounding). Layout conversions are
compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_cnn as jcnn
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_rnn import LSTM as JLSTM
from deeplearning4j_tpu.conf.layers_rnn import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.conf.losses import LossBinaryXENT as JBXENT
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.losses import LossMSE as JMSE
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import params as jparams
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import layers_cnn as cnn
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import params as pparams
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    layer_params_to_jax,
    layout_perm,
    params_from_jax,
    params_to_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
NET = dict(rtol=1e-4, atol=1e-6)
B = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jlayer):
    return serde.from_json(jserde.to_json(jlayer))


def _jparams(jlayer, itype, seed=0):
    """The layer's params in the JAX layouts, drawn with numpy (biases
    nonzero)."""
    p = jlayer.init(jax.random.PRNGKey(0), itype)
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in p.items()}


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _compare_image_layer(jlayer, h, w, c, seed=0):
    """Forward, output type and gradients of an image layer in both
    packages; returns (jax y, port y) in NHWC."""
    itype = JIT.convolutional(h, w, c)
    layer = _port(jlayer)
    jp = _jparams(jlayer, itype, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, h, w, c)).astype(np.float32)

    def jfwd(p, xx):
        return jlayer.forward(p, {}, xx)[0]

    jy = np.asarray(jfwd(jp, x))
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * r),
                        argnums=(0, 1))(jp, x)

    tp = {k: v.requires_grad_(True)
          for k, v in convert_layer_params(layer, jp).items()}
    tx = _nchw(x).requires_grad_(True)
    ty, _ = layer.forward(tp, {}, tx)
    y = _nhwc(ty)
    np.testing.assert_allclose(y, jy, **FWD)
    jt = jlayer.output_type(itype)
    pt = layer.output_type(cnn.it.Convolutional(h, w, c))
    assert (pt.height, pt.width, pt.channels) == (jt.height, jt.width,
                                                  jt.channels) == jy.shape[1:]
    (ty * _nchw(r)).sum().backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jgx), **GRAD)
    got = layer_params_to_jax(layer, {k: v.grad for k, v in tp.items()})
    for k in jgp:
        np.testing.assert_allclose(got[k], np.asarray(jgp[k]), **GRAD,
                                   err_msg=k)
    return jy, y


# --------------------------------------------------------------------------
# SeparableConvolution2D
# --------------------------------------------------------------------------

SEPARABLE = {
    "m1_s1_same": dict(n_out=5, depth_multiplier=1,
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "m2_s1_same": dict(n_out=5, depth_multiplier=2,
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "m1_s2_same": dict(n_out=4, depth_multiplier=1, stride=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "m2_s2_same": dict(n_out=4, depth_multiplier=2, stride=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "m2_s2_same_5x5": dict(n_out=4, depth_multiplier=2, stride=(2, 2),
                           kernel_size=(5, 5),
                           convolution_mode=jcnn.ConvolutionMode.SAME),
    "m2_truncate_pad": dict(n_out=3, depth_multiplier=2, padding=(1, 2),
                            convolution_mode=jcnn.ConvolutionMode.TRUNCATE,
                            activation=JAct.TANH),
    "m1_dilated": dict(n_out=3, depth_multiplier=1, dilation=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "m2_no_bias": dict(n_out=3, depth_multiplier=2, has_bias=False,
                       convolution_mode=jcnn.ConvolutionMode.SAME),
}


@pytest.mark.parametrize("case", sorted(SEPARABLE))
def test_separable_matches_jax(case):
    jlayer = jcnn.SeparableConvolution2D(**{"kernel_size": (3, 3),
                                            **SEPARABLE[case]})
    _compare_image_layer(jlayer, 7, 9, 3)


def test_separable_depthwise_channel_order_is_xla_grouped():
    """Output channel c * mult + m of the depthwise stage is input channel
    c's m-th filter: with a pointwise identity, channel 2*c + m of the
    output is input channel c times dW[..., 0, 2*c + m]'s centre tap."""
    jlayer = jcnn.SeparableConvolution2D(
        n_out=6, kernel_size=(1, 1), depth_multiplier=2, has_bias=False)
    layer = _port(jlayer)
    dw = np.arange(1, 7, dtype=np.float32).reshape(1, 1, 1, 6)
    pw = np.eye(6, dtype=np.float32).reshape(1, 1, 6, 6)
    x = np.random.default_rng(0).standard_normal((1, 2, 2, 3)).astype(
        np.float32)
    p = convert_layer_params(layer, {"dW": dw, "pW": pw})
    y = _nhwc(layer.forward(p, {}, _nchw(x))[0])
    want = np.repeat(x, 2, axis=-1) * dw[0, 0, 0]
    np.testing.assert_allclose(y, want, **FWD)
    np.testing.assert_allclose(
        y, np.asarray(jlayer.forward({"dW": dw, "pW": pw}, {}, x)[0]), **FWD)


# --------------------------------------------------------------------------
# Deconvolution2D
# --------------------------------------------------------------------------

DECONV = {
    "k3_s2_same": dict(kernel_size=(3, 3), stride=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k2_s2_same": dict(kernel_size=(2, 2), stride=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k4_s2_same": dict(kernel_size=(4, 4), stride=(2, 2),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k3_s1_same": dict(kernel_size=(3, 3), stride=(1, 1),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k2_s1_same": dict(kernel_size=(2, 2), stride=(1, 1),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k2_s4_same": dict(kernel_size=(2, 2), stride=(4, 4),
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k3_s2_truncate_p1": dict(kernel_size=(3, 3), stride=(2, 2),
                              padding=(1, 1),
                              convolution_mode=jcnn.ConvolutionMode.TRUNCATE),
    "k4_s2_truncate_p1": dict(kernel_size=(4, 4), stride=(2, 2),
                              padding=(1, 1),
                              convolution_mode=jcnn.ConvolutionMode.TRUNCATE,
                              activation=JAct.RELU),
    "k3_s2_truncate_p0_3x2": dict(kernel_size=(3, 2), stride=(2, 1),
                                  convolution_mode=(
                                      jcnn.ConvolutionMode.TRUNCATE)),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_matches_jax(case):
    jlayer = jcnn.Deconvolution2D(n_out=4, **DECONV[case])
    jy, _ = _compare_image_layer(jlayer, 5, 7, 3)
    kh, kw = jlayer.kernel_size
    sh, sw = jlayer.stride
    if jlayer.convolution_mode is jcnn.ConvolutionMode.SAME:
        assert jy.shape[1:3] == (5 * sh, 7 * sw)
    else:
        ph, pw = jlayer.padding
        assert jy.shape[1:3] == (sh * 4 + kh - 2 * ph, sw * 6 + kw - 2 * pw)


def test_deconvolution_weight_layout_is_conv_transpose():
    """The port's W is F.conv_transpose2d's [in, out, kh, kw]: with
    padding 0 TRUNCATE the layer is ``conv_transpose2d`` itself."""
    jlayer = jcnn.Deconvolution2D(n_out=2, kernel_size=(3, 3),
                                  stride=(2, 2), has_bias=False)
    layer = _port(jlayer)
    jp = _jparams(jlayer, JIT.convolutional(4, 4, 3))
    p = convert_layer_params(layer, jp)
    assert tuple(p["W"].shape) == (3, 2, 3, 3)
    np.testing.assert_array_equal(p["W"].numpy(),
                                  jp["W"].transpose(2, 3, 0, 1))
    x = _nchw(np.random.default_rng(3).standard_normal(
        (1, 4, 4, 3)).astype(np.float32))
    np.testing.assert_allclose(
        layer.forward(p, {}, x)[0].detach().numpy(),
        torch.nn.functional.conv_transpose2d(x, p["W"], stride=2).numpy(),
        **FWD)


# --------------------------------------------------------------------------
# Convolution1DLayer
# --------------------------------------------------------------------------

CONV1D = {
    "k3_same": dict(kernel=3, convolution_mode=jcnn.ConvolutionMode.SAME),
    "k4_s2_same": dict(kernel=4, stride1d=2,
                       convolution_mode=jcnn.ConvolutionMode.SAME),
    "k3_s2_truncate_p1": dict(kernel=3, stride1d=2, padding1d=1,
                              convolution_mode=(
                                  jcnn.ConvolutionMode.TRUNCATE)),
    "k1_pointwise": dict(kernel=1, activation=JAct.RELU),
    "k2_truncate_no_bias": dict(kernel=2, has_bias=False),
}
T1D, F1D = 11, 4


def _conv1d_pair(case):
    jlayer = jcnn.Convolution1DLayer(n_out=5, **CONV1D[case])
    return jlayer, _port(jlayer)


@pytest.mark.parametrize("case", sorted(CONV1D))
def test_conv1d_matches_jax(case):
    jlayer, layer = _conv1d_pair(case)
    itype = JIT.recurrent(F1D, T1D)
    jp = _jparams(jlayer, itype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T1D, F1D)).astype(np.float32)
    jy = np.asarray(jlayer.forward(jp, {}, x)[0])
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(jlayer.forward(p, {}, xx)[0] * r),
        argnums=(0, 1))(jp, x)
    tp = {k: v.requires_grad_(True)
          for k, v in convert_layer_params(layer, jp).items()}
    assert tuple(tp["W"].shape) == (5, F1D, jlayer.kernel)
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = layer.forward(tp, {}, tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy, **FWD)
    jt = jlayer.output_type(itype)
    pt = layer.output_type(cnn.it.Recurrent(size=F1D, timesteps=T1D))
    assert (pt.size, pt.timesteps) == (jt.size, jt.timesteps) == (
        jy.shape[2], jy.shape[1])
    (ty * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    got = layer_params_to_jax(layer, {k: v.grad for k, v in tp.items()})
    for k in jgp:
        np.testing.assert_allclose(got[k], np.asarray(jgp[k]), **GRAD)


@pytest.mark.parametrize("case", sorted(CONV1D))
def test_conv1d_resize_mask_and_streaming_safe_match_jax(case):
    jlayer, layer = _conv1d_pair(case)
    mask = np.ones((4, T1D), np.float32)
    mask[1, 6:] = 0  # ALIGN_START, a padded tail
    mask[2, :4] = 0  # ALIGN_END
    mask[3, :] = 0   # no valid step
    want = np.asarray(jlayer.resize_mask(jnp.asarray(mask)))
    got = layer.resize_mask(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert layer.streaming_safe() == jlayer.streaming_safe()


def _seq_jconf(conv1d):
    return (JNNC.builder().seed(5).updater(JAdam(learning_rate=1e-3)).list()
            .layer(jcnn.Convolution1DLayer(n_out=6, activation=JAct.TANH,
                                           **conv1d))
            .layer(JLSTM(n_out=5))
            .layer(JRnnOut(n_out=3, activation=JAct.SOFTMAX,
                           loss_fn=JMCXENT()))
            .set_input_type(JIT.recurrent(F1D, T1D)).build())


def _port_mln(jconf, jnet):
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def test_conv1d_network_carried_from_jax_gives_its_outputs():
    """A strided SAME Conv1D + LSTM + RnnOutputLayer built by the JAX
    package: its params through ``params_from_jax``, its output, its
    masked output (the mask resized by the conv) and its score."""
    jconf = _seq_jconf(dict(kernel=3, stride1d=2,
                            convolution_mode=jcnn.ConvolutionMode.SAME))
    jnet = JMLN(jconf).init()
    net = _port_mln(jconf, jnet)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, T1D, F1D)).astype(np.float32)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    fmask = np.ones((3, T1D), np.float32)
    fmask[1, 5:] = 0
    np.testing.assert_allclose(net.output(x, fmask=fmask),
                               np.asarray(jnet.output(x, fmask=fmask)),
                               **NET)
    t_out = -(-T1D // 2)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, t_out))]
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    assert net.score(DataSet(x, y)) == pytest.approx(
        float(jnet.score(JDataSet(x, y))), rel=1e-5)


def test_conv1d_takes_part_in_rnn_time_step():
    """A pointwise Conv1D streams: chunks fed through ``rnn_time_step``
    give the whole sequence's output, in both packages alike; a k 3 conv
    refuses to stream in both."""
    jconf = _seq_jconf(dict(kernel=1))
    jnet = JMLN(jconf).init()
    net = _port_mln(jconf, jnet)
    x = np.random.default_rng(7).standard_normal((2, T1D, F1D)).astype(
        np.float32)
    whole = net.output(x)
    parts = [net.rnn_time_step(x[:, a:b]) for a, b in ((0, 4), (4, 5),
                                                       (5, T1D))]
    np.testing.assert_allclose(np.concatenate(parts, axis=1), whole, **NET)
    jparts = [np.asarray(jnet.rnn_time_step(x[:, a:b]))
              for a, b in ((0, 4), (4, 5), (5, T1D))]
    np.testing.assert_allclose(np.concatenate(parts, axis=1),
                               np.concatenate(jparts, axis=1), **NET)

    jconf3 = _seq_jconf(dict(kernel=3,
                             convolution_mode=jcnn.ConvolutionMode.SAME))
    jnet3 = JMLN(jconf3).init()
    net3 = _port_mln(jconf3, jnet3)
    with pytest.raises(RuntimeError, match="Convolution1DLayer"):
        net3.rnn_time_step(x[:, :4])
    with pytest.raises(RuntimeError, match="Convolution1DLayer"):
        jnet3.rnn_time_step(x[:, :4])


# --------------------------------------------------------------------------
# Upsampling2D, Cropping2D, CnnLossLayer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jlayer", [
    jcnn.Upsampling2D(size=(2, 2)), jcnn.Upsampling2D(size=(3, 2)),
    jcnn.Cropping2D(cropping=(1, 0, 2, 1)),
    jcnn.Cropping2D(cropping=(0, 2, 0, 0))],
    ids=["up2x2", "up3x2", "crop1021", "crop0200"])
def test_resampling_layers_match_jax(jlayer):
    _compare_image_layer(jlayer, 5, 6, 3)


@pytest.mark.parametrize("act,loss,masked", [
    (JAct.SIGMOID, JBXENT(), True), (JAct.SIGMOID, JBXENT(), False),
    (JAct.SOFTMAX, JMCXENT(), True), (JAct.IDENTITY, JMSE(), True)],
    ids=["sigmoid_bxent_mask", "sigmoid_bxent", "softmax_mcxent_mask",
         "identity_mse_mask"])
def test_cnn_loss_layer_matches_jax(act, loss, masked):
    jlayer = jcnn.CnnLossLayer(activation=act, loss_fn=loss)
    layer = _port(jlayer)
    rng = np.random.default_rng(8)
    h, w, c = 4, 5, 3
    x = rng.standard_normal((B, h, w, c)).astype(np.float32)
    if act is JAct.SOFTMAX:
        labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, (B, h, w))]
    else:
        labels = rng.uniform(0, 1, (B, h, w, c)).astype(np.float32)
    mask = ((rng.uniform(size=(B, h, w)) > 0.3).astype(np.float32)
            if masked else None)
    jy = np.asarray(jlayer.forward({}, {}, x)[0])
    tx = _nchw(x).requires_grad_(True)
    np.testing.assert_allclose(_nhwc(layer.forward({}, {}, tx)[0]), jy,
                               **FWD)
    js, jg = jax.value_and_grad(
        lambda xx: jlayer.score({}, xx, labels, mask))(x)
    s = layer.score({}, tx, torch.tensor(labels),
                    None if mask is None else torch.tensor(mask))
    assert float(s.detach()) == pytest.approx(float(js), rel=1e-5)
    s.backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jg), **GRAD)
    assert layer.param_order() == [] and layer.regularized_param_keys() == []


# --------------------------------------------------------------------------
# JSON, fold_scale_shift, conversion
# --------------------------------------------------------------------------

JSON_LAYERS = [
    jcnn.SeparableConvolution2D(n_out=3, depth_multiplier=2, stride=(2, 2)),
    jcnn.Deconvolution2D(n_out=3, kernel_size=(4, 4), stride=(2, 2),
                         convolution_mode=jcnn.ConvolutionMode.SAME),
    jcnn.Convolution1DLayer(n_out=3, kernel=5, stride1d=2, padding1d=1),
    jcnn.Upsampling2D(size=(2, 3)), jcnn.Cropping2D(cropping=(1, 2, 3, 4)),
    jcnn.CnnLossLayer(activation=JAct.SIGMOID, loss_fn=JBXENT()),
]


@pytest.mark.parametrize("jlayer", JSON_LAYERS,
                         ids=[type(j).__name__ for j in JSON_LAYERS])
def test_layer_json_round_trips_between_packages(jlayer):
    s = jserde.to_json(jlayer)
    layer = serde.from_json(s)
    assert type(layer).__name__ == type(jlayer).__name__
    assert serde.to_json(layer) == s
    assert jserde.to_json(jserde.from_json(serde.to_json(layer))) == s


FOLD = {
    "separable": (jcnn.SeparableConvolution2D(
        n_out=4, depth_multiplier=2,
        convolution_mode=jcnn.ConvolutionMode.SAME), "image"),
    "separable_no_bias": (jcnn.SeparableConvolution2D(
        n_out=4, has_bias=False,
        convolution_mode=jcnn.ConvolutionMode.SAME), "image"),
    "deconvolution": (jcnn.Deconvolution2D(
        n_out=4, kernel_size=(3, 3), stride=(2, 2),
        convolution_mode=jcnn.ConvolutionMode.SAME), "image"),
    "conv1d": (jcnn.Convolution1DLayer(n_out=4, kernel=3), "sequence"),
}


@pytest.mark.parametrize("case", sorted(FOLD))
def test_fold_scale_shift_matches_jax(case):
    jlayer, kind = FOLD[case]
    layer = _port(jlayer)
    image = kind == "image"
    itype = JIT.convolutional(5, 5, 3) if image else JIT.recurrent(3, 9)
    jp = _jparams(jlayer, itype)
    rng = np.random.default_rng(9)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    shift = rng.standard_normal(4).astype(np.float32)
    jfold, jfp = jlayer.fold_scale_shift(jp, scale, shift)
    fold, fp = layer.fold_scale_shift(convert_layer_params(layer, jp),
                                      scale, shift)
    assert fold.has_bias and jfold.has_bias
    got = layer_params_to_jax(fold, fp)
    assert sorted(got) == sorted(jfp)
    for k in jfp:
        np.testing.assert_allclose(got[k], np.asarray(jfp[k]), **FWD)
    shape = (B, 5, 5, 3) if image else (B, 9, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    tx = _nchw(x) if image else torch.tensor(x)
    y, _ = fold.forward(fp, {}, tx)
    y = _nhwc(y) if image else y.numpy()
    plain, _ = layer.forward(convert_layer_params(layer, jp), {}, tx)
    plain = _nhwc(plain) if image else plain.numpy()
    np.testing.assert_allclose(y, plain * scale + shift, rtol=1e-5,
                               atol=1e-5)


def test_layout_rules_per_key_and_rank():
    sep = cnn.SeparableConvolution2D(n_out=3)
    assert layout_perm(sep, "dW", 4) == layout_perm(sep, "pW", 4) == (
        2, 3, 1, 0)
    assert layout_perm(sep, "b", 1) is None
    assert layout_perm(cnn.Deconvolution2D(n_out=3), "W", 4) == (2, 3, 0, 1)
    assert layout_perm(cnn.Convolution1DLayer(n_out=3), "W", 3) == (2, 1, 0)
    assert layout_perm(cnn.ConvolutionLayer(n_out=3), "W", 4) == (2, 3, 1, 0)
    for layer, key, ndim in (
            (cnn.ConvolutionLayer(n_out=3), "W", 3),
            (cnn.Convolution1DLayer(n_out=3), "W", 4),
            (cnn.Deconvolution2D(n_out=3), "W", 3),
            (sep, "dW", 3), (sep, "pW", 2)):
        with pytest.raises(ValueError, match="layout rule"):
            layout_perm(layer, key, ndim)
    with pytest.raises(ValueError, match="layout rule"):
        convert_layer_params(cnn.ConvolutionLayer(n_out=3),
                             {"W": np.zeros((3, 4, 5), np.float32)})


# --------------------------------------------------------------------------
# networks carried from the JAX package
# --------------------------------------------------------------------------

def _image_jconf():
    g = (JNNC.builder().seed(13).updater(JAdam(learning_rate=1e-2))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.convolutional(9, 9, 3)))
    g.add_layer("sep", jcnn.SeparableConvolution2D(
        n_out=6, depth_multiplier=2, stride=(2, 2), activation=JAct.RELU,
        convolution_mode=jcnn.ConvolutionMode.SAME), "in")
    g.add_layer("bn", jcnn.BatchNormalization(), "sep")
    g.add_layer("up", jcnn.Upsampling2D(size=(2, 2)), "bn")
    g.add_layer("crop", jcnn.Cropping2D(cropping=(0, 1, 1, 0)), "up")
    g.add_layer("deconv", jcnn.Deconvolution2D(
        n_out=4, kernel_size=(3, 3), stride=(2, 2), activation=JAct.TANH,
        convolution_mode=jcnn.ConvolutionMode.SAME), "crop")
    g.add_layer("pool", jcnn.GlobalPoolingLayer(
        pooling_type=jcnn.PoolingType.AVG), "deconv")
    g.add_layer("out", JOut(n_out=3), "pool")
    g.set_outputs("out")
    return g.build()


def test_image_network_carried_from_jax_gives_its_outputs():
    jconf = _image_jconf()
    jnet = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    net = ComputationGraph(conf, device="cpu").set_params(p, s)
    x = np.random.default_rng(10).standard_normal((3, 9, 9, 3)).astype(
        np.float32)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    back, _ = params_to_jax(conf, net.params, net.state)
    for k, vp in _np(jnet.params).items():
        for name, v in vp.items():
            np.testing.assert_array_equal(back[k][name], v)
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))


def test_trained_separable_zip_crosses_with_its_updater_state(tmp_path):
    """One Adam ``fit_batch`` in the JAX package, its zip restored in the
    port: params, the updater state of ``b`` / ``dW`` / ``pW`` (the JAX
    step leaves them in the sorted order, which the zip holds) and the
    counters bit for bit, and the next step agrees; the port's zip
    restores in the JAX package with the same params."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    jconf = _image_jconf()
    jnet = JGraph(jconf).init()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 9, 9, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    jnet.fit_batch(JDataSet(x, y))
    jpath = tmp_path / "jax.zip"
    jser.write_model(jnet, jpath)
    net = ser.restore_computation_graph(jpath, device="cpu")
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(
        pparams.flatten_state_like(net.conf, net.opt_state),
        jparams.flatten_state_like(_np(jnet.opt_state)))
    assert list(jnet.opt_state["sep"]) == ["b", "dW", "pW"]
    assert net.iteration == jnet.iteration == 1
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)

    path = tmp_path / "port.zip"
    ser.write_model(net, path)
    back = jser.restore_computation_graph(path)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  net.params_flat())
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x),
                               **NET)
