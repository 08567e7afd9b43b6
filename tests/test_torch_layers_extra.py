"""The port's ``conf/layers_extra.py`` layers against the JAX package's, on
the CPU.

Every layer the JAX package's ``conf/layers_extra.py`` registers besides
layer normalization, position embeddings and the Graves bidirectional LSTM
(covered by the transformer and recurrent tests): ``Convolution3D``,
``Subsampling3DLayer`` (MAX / AVG / SUM / PNORM, TRUNCATE and SAME at
stride 2 and odd sizes, where XLA's SAME split puts the odd element on the
high side and AVG divides by the real elements), ``Upsampling3D``,
``Cropping3D``, ``ZeroPadding3DLayer``, the 1-D pooling and resizing layers
(with their ``resize_mask``), ``DepthwiseConvolution2D``, the locally
connected layers, ``PReLULayer`` on every input kind,
``ElementWiseMultiplicationLayer``, ``Permute`` (every permutation of an
image, channels moved into a spatial axis included), ``RepeatVector`` and
``MaskLayer``. The same configuration (through the JSON), the same seeded
weights (numpy, the JAX layouts, carried by ``util.convert``), the same
inputs; forwards, ``output_type`` and the gradients of ``sum(y * r)`` with
respect to the params and the input. Then the JAX package's own
``tests/test_layers_extra.py`` cases on the port, the layout rules, the
serde tag set, and the errors.

Tolerances: forwards rtol 1e-5, atol 1e-6 (float32 sums of at most 3 x 3 x
3 x 4 terms in other orders); gradients rtol 1e-4, atol 1e-5 (the
transposed products summed in other orders). Layout moves and pure data
movement (padding, cropping, repeats, permutes) compare bit for bit.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_extra as jx
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JCM
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import Activation, InputType
from deeplearning4j_tpu_torch.conf import layers_extra as px
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import PoolingType
from deeplearning4j_tpu_torch.conf.layers_rnn import RnnOutputLayer
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.conf.updaters import NoOp
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    layer_params_to_jax,
    layout_perm,
)
from deeplearning4j_tpu_torch.util.gradcheck import gradient_check

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
B = 2


def _port(jlayer):
    return serde.from_json(jserde.to_json(jlayer))


def _jparams(jlayer, itype, seed=0):
    """The layer's params in the JAX layouts, drawn with numpy."""
    p = jlayer.init(jax.random.PRNGKey(0), itype)
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in p.items()}


def _to_port(x):
    """A JAX-layout array as the port's tensor: NHWC / NDHWC become
    channels-last NCHW / NCDHW, other ranks stay."""
    t = torch.tensor(x)
    if t.ndim == 4:
        return t.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    if t.ndim == 5:
        return t.permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
    return t


def _to_jax(t):
    t = t.detach()
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    elif t.ndim == 5:
        t = t.permute(0, 2, 3, 4, 1)
    return t.numpy()


def _port_itype(jt):
    return serde.from_json(jserde.to_json(jt))


def _types_equal(jt, pt):
    assert jserde.to_json(jt) == serde.to_json(pt)


def compare(jlayer, itype, shape, seed=0, mask=None, params=True):
    """Forward, output type and gradients of one layer in both packages
    on a seeded input of ``shape`` (the JAX layout); returns (jax y, port
    y) in the JAX layout."""
    layer = _port(jlayer)
    jp = _jparams(jlayer, itype, seed) if params else {}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}

    def jfwd(p, xx):
        return jlayer.forward(p, {}, xx, **kw)[0]

    jy = np.asarray(jfwd(jp, x))
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * r),
                        argnums=(0, 1))(jp, x)
    tp = {k: v.requires_grad_(True)
          for k, v in convert_layer_params(layer, jp).items()}
    tx = _to_port(x).requires_grad_(True)
    pkw = {} if mask is None else {"mask": torch.tensor(mask)}
    ty, _ = layer.forward(tp, {}, tx, **pkw)
    y = _to_jax(ty)
    np.testing.assert_allclose(y, jy, **FWD)
    _types_equal(jlayer.output_type(itype),
                 layer.output_type(_port_itype(itype)))
    (ty * _to_port(r)).sum().backward()
    np.testing.assert_allclose(_to_jax(tx.grad), np.asarray(jgx), **GRAD)
    got = layer_params_to_jax(layer, {k: v.grad for k, v in tp.items()})
    for k in jgp:
        np.testing.assert_allclose(got[k], np.asarray(jgp[k]), **GRAD,
                                   err_msg=k)
    return jy, y


# --------------------------------------------------------------------------
# 3-D layers
# --------------------------------------------------------------------------

CONV3D = {
    "k3_s1_same": dict(n_out=4, kernel_size=(3, 3, 3)),
    "k3_s2_same_odd": dict(n_out=3, kernel_size=(3, 3, 3), stride=(2, 2, 2)),
    "k2_s2_same_odd": dict(n_out=3, kernel_size=(2, 2, 2), stride=(2, 2, 2)),
    "k2_s1_truncate": dict(n_out=3, kernel_size=(2, 3, 2),
                           convolution_mode=JCM.TRUNCATE,
                           activation=JAct.TANH),
    "k3_s2_no_bias": dict(n_out=2, kernel_size=(3, 3, 3), stride=(2, 1, 2),
                          has_bias=False),
}


@pytest.mark.parametrize("case", sorted(CONV3D))
def test_convolution3d_matches_jax(case):
    compare(jx.Convolution3D(**CONV3D[case]),
            JIT.convolutional_3d(5, 7, 6, 3), (B, 5, 7, 6, 3))


@pytest.mark.parametrize("pooling,mode", itertools.product(
    ["MAX", "AVG", "SUM", "PNORM"], ["TRUNCATE", "SAME"]))
def test_subsampling3d_matches_jax(pooling, mode):
    jlayer = jx.Subsampling3DLayer(pooling_type=JPT[pooling],
                                   kernel_size=(3, 2, 3), stride=(2, 2, 2),
                                   convolution_mode=JCM[mode], pnorm=3)
    compare(jlayer, JIT.convolutional_3d(5, 7, 6, 2), (B, 5, 7, 6, 2),
            params=False)


def test_avg_pool3d_same_divides_by_the_real_elements():
    """SAME at stride 2 over an odd size pads (0, 1): the last window of
    width 2 holds one real element, and AVG returns it unchanged."""
    layer = px.Subsampling3DLayer(pooling_type=PoolingType.AVG,
                                  kernel_size=(2, 2, 2), stride=(2, 2, 2),
                                  convolution_mode=px.ConvolutionMode.SAME)
    x = torch.arange(27, dtype=torch.float32).reshape(1, 1, 3, 3, 3)
    y, _ = layer.forward({}, {}, x)
    assert tuple(y.shape) == (1, 1, 2, 2, 2)
    assert float(y[0, 0, 1, 1, 1]) == float(x[0, 0, 2, 2, 2])
    assert float(y[0, 0, 0, 0, 0]) == float(
        x[0, 0, :2, :2, :2].mean())


@pytest.mark.parametrize("jlayer", [
    jx.Upsampling3D(size=(2, 1, 3)),
    jx.Cropping3D(cropping=(1, 0, 2, 1, 0, 2)),
    jx.ZeroPadding3DLayer(padding=(1, 2, 0, 1, 2, 0)),
], ids=lambda layer: type(layer).__name__)
def test_3d_resizing_matches_jax_bit_for_bit(jlayer):
    jy, y = compare(jlayer, JIT.convolutional_3d(4, 5, 6, 2),
                    (B, 4, 5, 6, 2), params=False)
    np.testing.assert_array_equal(y, jy)


# --------------------------------------------------------------------------
# 1-D layers over [batch, time, features]
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pooling,mode", itertools.product(
    ["MAX", "AVG", "SUM", "PNORM"], ["TRUNCATE", "SAME"]))
def test_subsampling1d_matches_jax(pooling, mode):
    jlayer = jx.Subsampling1DLayer(pooling_type=JPT[pooling], kernel_size=3,
                                   stride=2, convolution_mode=JCM[mode])
    compare(jlayer, JIT.recurrent(3, timesteps=9), (B, 9, 3), params=False)


ONE_D = [
    jx.Subsampling1DLayer(kernel_size=3, stride=2,
                          convolution_mode=JCM.SAME),
    jx.Subsampling1DLayer(pooling_type=JPT.AVG, kernel_size=2, stride=2),
    jx.Upsampling1D(size=3),
    jx.Cropping1D(cropping=(1, 2)),
    jx.ZeroPadding1DLayer(padding=(2, 1)),
]


@pytest.mark.parametrize("jlayer", ONE_D[2:],
                         ids=lambda layer: type(layer).__name__)
def test_1d_resizing_matches_jax_bit_for_bit(jlayer):
    jy, y = compare(jlayer, JIT.recurrent(3, timesteps=7), (B, 7, 3),
                    params=False)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("i", range(len(ONE_D)))
def test_1d_resize_mask_matches_jax(i):
    """Ragged masks through each layer's time geometry: pooling max-pools
    the mask over zero padding, padding marks its steps invalid."""
    jlayer = ONE_D[i]
    layer = _port(jlayer)
    mask = np.array([[1] * 9, [1] * 5 + [0] * 4, [1] + [0] * 8],
                    np.float32)
    want = np.asarray(jlayer.resize_mask(jnp.asarray(mask)))
    got = layer.resize_mask(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert layer.streaming_safe() is False


# --------------------------------------------------------------------------
# 2-D extras
# --------------------------------------------------------------------------

DEPTHWISE = {
    "m1_s1_same": dict(depth_multiplier=1),
    "m2_s1_same": dict(depth_multiplier=2),
    "m1_s2_same_odd": dict(depth_multiplier=1, stride=(2, 2)),
    "m2_s2_same_odd": dict(depth_multiplier=2, stride=(2, 2),
                           activation=JAct.RELU),
    "m2_truncate": dict(depth_multiplier=2, convolution_mode=JCM.TRUNCATE),
    "m1_5x5_no_bias": dict(kernel_size=(5, 5), has_bias=False),
}


@pytest.mark.parametrize("case", sorted(DEPTHWISE))
def test_depthwise_matches_jax(case):
    compare(jx.DepthwiseConvolution2D(**DEPTHWISE[case]),
            JIT.convolutional(7, 9, 3), (B, 7, 9, 3))


@pytest.mark.parametrize("kernel,stride", [((3, 3), (1, 1)),
                                           ((2, 3), (2, 2))])
def test_locally_connected2d_matches_jax(kernel, stride):
    compare(jx.LocallyConnected2D(n_out=4, kernel_size=kernel, stride=stride,
                                  activation=JAct.TANH),
            JIT.convolutional(6, 7, 3), (B, 6, 7, 3))


def test_unfold_patches_are_channel_major_as_xla_emits_them():
    """``F.unfold`` on NCHW and ``conv_general_dilated_patches`` on NHWC
    emit each patch in the same order (C outer, then kh, kw), so the JAX
    package's ``W`` applies unchanged."""
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 3)).astype(
        np.float32)
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        x, (2, 3), (1, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))     # [b, oh, ow, k]
    got = torch.nn.functional.unfold(_to_port(x), (2, 3), stride=(1, 2))
    got = got.reshape(2, -1, want.shape[1], want.shape[2]).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel,stride", [(3, 2), (2, 1)])
def test_locally_connected1d_matches_jax(kernel, stride):
    compare(jx.LocallyConnected1D(n_out=4, kernel_size=kernel, stride=stride,
                                  activation=JAct.TANH),
            JIT.recurrent(3, timesteps=7), (B, 7, 3))


PRELU_INPUTS = {
    "feed_forward": (JIT.feed_forward(5), (B, 5)),
    "recurrent": (JIT.recurrent(4, timesteps=3), (B, 3, 4)),
    "image": (JIT.convolutional(3, 4, 5), (B, 3, 4, 5)),
    "volume": (JIT.convolutional_3d(2, 3, 4, 3), (B, 2, 3, 4, 3)),
    "image_flat": (JIT.convolutional_flat(2, 3, 2), (B, 12)),
}


@pytest.mark.parametrize("kind", sorted(PRELU_INPUTS))
def test_prelu_matches_jax(kind):
    itype, shape = PRELU_INPUTS[kind]
    compare(jx.PReLULayer(), itype, shape)
    assert _port(jx.PReLULayer()).regularized_param_keys() == []


@pytest.mark.parametrize("itype,shape", [
    (JIT.feed_forward(5), (B, 5)),
    (JIT.recurrent(4, timesteps=3), (B, 3, 4))], ids=["ff", "recurrent"])
def test_elementwise_multiplication_matches_jax(itype, shape):
    compare(jx.ElementWiseMultiplicationLayer(activation=JAct.TANH), itype,
            shape)


@pytest.mark.parametrize("dims", list(itertools.permutations((1, 2, 3))))
def test_permute_image_matches_jax_bit_for_bit(dims):
    """Every permutation of (h, w, c), those moving the channels into a
    spatial axis included: the port's NCHW result is the tensor whose NHWC
    view is the JAX package's output."""
    jy, y = compare(jx.Permute(dims=dims), JIT.convolutional(3, 4, 5),
                    (B, 3, 4, 5), params=False)
    np.testing.assert_array_equal(y, jy)


def test_permute_sequence_matches_jax_bit_for_bit():
    jy, y = compare(jx.Permute(dims=(2, 1)), JIT.recurrent(4, timesteps=3),
                    (B, 3, 4), params=False)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("dims,itype,match", [
    ((1, 1), JIT.recurrent(4, timesteps=3), "must be a permutation"),
    ((2, 1), JIT.recurrent(4, timesteps=-1), "variable-length time axis"),
    ((1, 2), JIT.feed_forward(4), "supports Recurrent/Convolutional"),
])
def test_permute_errors_carry_the_jax_wording(dims, itype, match):
    with pytest.raises(ValueError, match=match):
        jx.Permute(dims=dims).output_type(itype)
    with pytest.raises(ValueError, match=match):
        _port(jx.Permute(dims=dims)).output_type(_port_itype(itype))


def test_repeat_vector_and_mask_layer_match_jax():
    jy, y = compare(jx.RepeatVector(repetition_factor=3),
                    JIT.feed_forward(4), (B, 4), params=False)
    np.testing.assert_array_equal(y, jy)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0]], np.float32)
    jy, y = compare(jx.MaskLayer(), JIT.recurrent(3, timesteps=4),
                    (B, 4, 3), mask=mask, params=False)
    np.testing.assert_array_equal(y, jy)
    assert px.MaskLayer.uses_mask


# --------------------------------------------------------------------------
# the JAX package's tests/test_layers_extra.py cases, on the port
# --------------------------------------------------------------------------

def _gen():
    return torch.Generator().manual_seed(0)


def _x(shape, seed=0):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape),
                        dtype=torch.float32)


def test_conv3d_stack_shapes():
    t = InputType.convolutional_3d(8, 8, 8, 2)
    c = px.Convolution3D(n_out=4, kernel_size=(3, 3, 3), stride=(2, 2, 2))
    out = c.output_type(t)
    assert (out.depth, out.height, out.width, out.channels) == (4, 4, 4, 4)
    y, _ = c.forward(c.init(_gen(), t), {}, _x((2, 2, 8, 8, 8)))
    assert tuple(y.shape) == (2, 4, 4, 4, 4)
    y2, _ = px.Subsampling3DLayer().forward({}, {}, y)
    assert tuple(y2.shape) == (2, 4, 2, 2, 2)
    y3, _ = px.Upsampling3D(size=(2, 2, 2)).forward({}, {}, y2)
    assert tuple(y3.shape) == (2, 4, 4, 4, 4)
    y4, _ = px.ZeroPadding3DLayer(padding=(1, 1, 0, 0, 2, 2)).forward(
        {}, {}, y3)
    assert tuple(y4.shape) == (2, 4, 6, 4, 8)
    y5, _ = px.Cropping3D(cropping=(1, 1, 0, 0, 2, 2)).forward({}, {}, y4)
    assert torch.equal(y5, y3)


def test_1d_layer_shapes_and_values():
    x = _x((2, 8, 3))
    s = px.Subsampling1DLayer(pooling_type=PoolingType.AVG, kernel_size=2,
                              stride=2)
    y, _ = s.forward({}, {}, x)
    assert tuple(y.shape) == (2, 4, 3)
    torch.testing.assert_close(y[:, 0], (x[:, 0] + x[:, 1]) / 2)
    assert tuple(px.Upsampling1D(size=3).forward({}, {}, y)[0].shape) == (
        2, 12, 3)
    assert tuple(px.ZeroPadding1DLayer(padding=(1, 2)).forward(
        {}, {}, x)[0].shape) == (2, 11, 3)
    assert tuple(px.Cropping1D(cropping=(1, 2)).forward(
        {}, {}, x)[0].shape) == (2, 5, 3)


def test_depthwise_shapes():
    t = InputType.convolutional(6, 6, 3)
    d = px.DepthwiseConvolution2D(kernel_size=(3, 3), depth_multiplier=2)
    y, _ = d.forward(d.init(_gen(), t), {}, _x((1, 3, 6, 6)))
    assert tuple(y.shape) == (1, 6, 6, 6)
    assert d.output_type(t).channels == 6


def test_locally_connected_2d_is_unshared():
    """Zeroing ONE position's weights changes that position only."""
    t = InputType.convolutional(5, 5, 2)
    lc = px.LocallyConnected2D(n_out=3, kernel_size=(3, 3))
    p = lc.init(_gen(), t)
    assert tuple(p["W"].shape) == (3, 3, 18, 3)
    x = _x((2, 2, 5, 5))
    y, _ = lc.forward(p, {}, x)
    assert tuple(y.shape) == (2, 3, 3, 3)
    w2 = p["W"].clone()
    w2[1, 1] = 0.0
    y2, _ = lc.forward({**p, "W": w2}, {}, x)
    diff = (y - y2).abs().sum(dim=(0, 1))
    assert diff[1, 1] > 0
    diff[1, 1] = 0
    assert float(diff.sum()) == 0.0


def test_locally_connected_1d_shape():
    t = InputType.recurrent(3, timesteps=7)
    lc = px.LocallyConnected1D(n_out=4, kernel_size=3, stride=2,
                               activation=Activation.TANH)
    y, _ = lc.forward(lc.init(_gen(), t), {}, _x((2, 7, 3)))
    assert tuple(y.shape) == (2, 3, 4)


def test_prelu_and_elementwise_values():
    t = InputType.feed_forward(4)
    x = torch.tensor([[-2.0, -1.0, 1.0, 2.0]])
    pr = px.PReLULayer()
    y, _ = pr.forward(pr.init(_gen(), t), {}, x)
    torch.testing.assert_close(y, torch.tensor([[-0.5, -0.25, 1.0, 2.0]]))
    ew = px.ElementWiseMultiplicationLayer()
    y2, _ = ew.forward(ew.init(_gen(), t), {}, x)
    torch.testing.assert_close(y2, x)


def test_repeat_vector_and_mask_values():
    y, _ = px.RepeatVector(repetition_factor=3).forward({}, {}, _x((2, 4)))
    assert tuple(y.shape) == (2, 3, 4)
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.float32)
    y2, _ = px.MaskLayer().forward({}, {}, _x((2, 3, 4)), mask=mask)
    assert float(y2[0, 2].abs().sum()) == 0.0
    assert float(y2[1, 1:].abs().sum()) == 0.0


def test_graves_bidirectional_lstm_gradient_check():
    conf = (NeuralNetConfiguration.builder()
            .seed(12345).updater(NoOp()).list()
            .layer(px.GravesBidirectionalLSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=2))
            .set_input_type(InputType.recurrent(3, timesteps=5))
            .build())
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 5, 3))
    labels = np.eye(2)[rng.integers(0, 2, (4, 5))]
    res = gradient_check(conf, DataSet(feats, labels), n_samples=50,
                         device="cpu")
    assert res.passed, res.summary()


@pytest.mark.parametrize("layer_fn", [px.PReLULayer,
                                      px.ElementWiseMultiplicationLayer])
def test_extra_ff_gradient_check(layer_fn):
    conf = (NeuralNetConfiguration.builder()
            .seed(12345).updater(NoOp()).list()
            .layer(DenseLayer(n_out=5, activation=Activation.TANH))
            .layer(layer_fn())
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.feed_forward(4))
            .build())
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(6, 4))
    labels = np.eye(3)[rng.integers(0, 3, 6)]
    res = gradient_check(conf, DataSet(feats, labels), n_samples=50,
                         device="cpu")
    assert res.passed, res.summary()


def test_pooling_sum_and_prelu_shapes():
    x = _x((1, 4, 3))
    y, _ = px.Subsampling1DLayer(pooling_type=PoolingType.SUM, kernel_size=2,
                                 stride=2).forward({}, {}, x)
    torch.testing.assert_close(y[:, 0], x[:, 0] + x[:, 1])
    y3, _ = px.Subsampling3DLayer(pooling_type=PoolingType.SUM).forward(
        {}, {}, _x((1, 2, 4, 4, 4)))
    assert tuple(y3.shape) == (1, 2, 2, 2, 2)
    assert tuple(px.PReLULayer().init(
        _gen(), InputType.convolutional_3d(4, 4, 4, 2))["alpha"].shape) == (2,)


# --------------------------------------------------------------------------
# serde, layout rules
# --------------------------------------------------------------------------

SERDE = [jx.Convolution3D(n_out=4), jx.Subsampling3DLayer(),
         jx.Subsampling1DLayer(), jx.Upsampling1D(size=3), jx.Upsampling3D(),
         jx.Cropping1D(cropping=(1, 2)), jx.Cropping3D(),
         jx.ZeroPadding1DLayer(padding=(1, 2)), jx.ZeroPadding3DLayer(),
         jx.DepthwiseConvolution2D(depth_multiplier=2),
         jx.LocallyConnected2D(n_out=3), jx.LocallyConnected1D(n_out=4),
         jx.PReLULayer(), jx.ElementWiseMultiplicationLayer(),
         jx.RepeatVector(repetition_factor=3), jx.MaskLayer(),
         jx.Permute(dims=(2, 1)),
         jx.Cnn3DToFeedForwardPreProcessor(depth=2, height=3, width=4,
                                           channels=5),
         jx.GravesBidirectionalLSTM(n_out=4)]


@pytest.mark.parametrize("jlayer", SERDE,
                         ids=lambda layer: type(layer).__name__)
def test_serde_round_trips_between_the_packages(jlayer):
    text = jserde.to_json(jlayer)
    layer = serde.from_json(text)
    assert type(layer).__name__ == type(jlayer).__name__
    assert serde.from_json(serde.to_json(layer)) == layer
    assert jserde.from_json(serde.to_json(layer)) == jlayer


def test_conf_tag_sets_are_equal():
    """Every ``@type`` tag the JAX package's ``conf/`` registers, the
    port's ``conf/`` registers, and no other."""
    import importlib
    import pkgutil

    import deeplearning4j_tpu.conf as jconf
    import deeplearning4j_tpu_torch.conf as pconf

    def tags(pkg, reg):
        for m in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{pkg.__name__}.{m.name}")
        return {t for t, c in reg.items()
                if c.__module__.startswith(pkg.__name__ + ".")}

    want = tags(jconf, jserde._REGISTRY)
    got = tags(pconf, serde._REGISTRY)
    assert got == want, (sorted(want - got), sorted(got - want))


@pytest.mark.parametrize("layer,key,ndim,perm", [
    (px.Convolution3D(n_out=2), "W", 5, (2, 3, 4, 1, 0)),
    (px.DepthwiseConvolution2D(), "W", 4, (2, 3, 1, 0)),
    (px.LocallyConnected2D(n_out=2), "W", 4, None),
    (px.LocallyConnected2D(n_out=2), "b", 3, None),
    (px.LocallyConnected1D(n_out=2), "W", 3, None),
    (px.PReLULayer(), "alpha", 1, None),
    (px.ElementWiseMultiplicationLayer(), "W", 1, None),
])
def test_layout_rules(layer, key, ndim, perm):
    assert layout_perm(layer, key, ndim) == perm


@pytest.mark.parametrize("layer,ndim", [(px.Convolution3D(n_out=2), 4),
                                        (px.DepthwiseConvolution2D(), 5)])
def test_an_unknown_conv_weight_rank_raises(layer, ndim):
    with pytest.raises(ValueError, match=f"no {ndim}-D layout rule"):
        layout_perm(layer, "W", ndim)
