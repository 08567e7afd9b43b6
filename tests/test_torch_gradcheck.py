"""The port's float64 gradient check (``util/gradcheck.py``), its own oracle.

The configurations of the JAX package's ``tests/test_gradcheck.py`` (a
dense layer under each activation, the losses, L1/L2 regularization, a
CNN, batch norm, layer-input gradients of the pooling and normalization
layers the port has) pass the port's check with the JAX package's
defaults (epsilon 1e-6, max relative error 1e-5, absolute threshold 1e-9),
and so do the layers and graph vertices of this slice: ``ZeroPaddingLayer``,
``SpaceToDepthLayer``, ``FusedConvBN1x1``, ``EmbeddingLayer``,
``LossLayer``, ``MergeVertex``, ``SubsetVertex``, ``ScaleVertex``,
``ShiftVertex``, ``L2NormalizeVertex``, ``StackVertex``,
``UnstackVertex``, ``ReshapeVertex``, ``PreprocessorVertex`` and
``AttentionVertex`` (with and without a key mask, causal). A layer whose
backward is deliberately scaled must fail the check, or the check would
prove nothing. The JAX package's own check runs on the same dense
configuration (both pass, over flat params vectors of the same length).
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.multilayer import (
    MultiLayerConfiguration as JMLConf,
)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.util.gradcheck import gradient_check as jax_check
from deeplearning4j_tpu_torch.conf import Activation, InputType, WeightInit
from deeplearning4j_tpu_torch.conf.graph import (
    AttentionVertex,
    ElementWiseOp,
    ElementWiseVertex,
    L2NormalizeVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)
from deeplearning4j_tpu_torch.conf.layers import (
    CnnToFeedForwardPreProcessor,
    DenseLayer,
    EmbeddingLayer,
    FeedForwardToCnnPreProcessor,
    LossLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    GlobalPoolingLayer,
    LocalResponseNormalization,
    PoolingType,
    SpaceToDepthLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.conf.losses import (
    LossBinaryXENT,
    LossHinge,
    LossMAE,
    LossMCXENT,
    LossMSE,
)
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.conf.regularization import (
    L1Regularization,
    L2Regularization,
)
from deeplearning4j_tpu_torch.conf.updaters import NoOp
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.util.gradcheck import (
    check_layer_input_gradient,
    gradient_check,
    gradient_check_graph,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch



@pytest.fixture
def rng():
    """Inputs drawn per test from one seed, whatever ran before (a
    PNORM window whose values all lie near 0 has a poorly conditioned
    gradient, so the draw must not depend on the test order)."""
    return np.random.default_rng(42)


def _msg(res):
    return (f"{res.n_failed}/{res.n_checked} failed, max_rel="
            f"{res.max_rel_error:.2e}, {res.failures[:3]}")


def dense_conf(activation, loss, out_act, n_in=4, n_hidden=5, n_out=3,
               regularization=()):
    return (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(NoOp())
            .weight_init(WeightInit.XAVIER)
            .list()
            .layer(DenseLayer(n_out=n_hidden, activation=activation,
                              regularization=tuple(regularization)))
            .layer(OutputLayer(n_out=n_out, activation=out_act, loss_fn=loss))
            .set_input_type(InputType.feed_forward(n_in))
            .build())


def random_ds(rng, n_in=4, n_out=3, batch=6, onehot=True):
    x = rng.normal(size=(batch, n_in))
    if onehot:
        y = np.eye(n_out)[rng.integers(0, n_out, batch)]
    else:
        y = rng.normal(size=(batch, n_out))
    return DataSet(x, y)


@pytest.mark.parametrize("act", [
    Activation.TANH, Activation.RELU, Activation.SIGMOID, Activation.ELU,
    Activation.SOFTPLUS, Activation.GELU, Activation.SWISH, Activation.CUBE,
    Activation.HARDSIGMOID, Activation.LEAKYRELU,
])
def test_dense_mcxent_gradients(act, rng):
    res = gradient_check(dense_conf(act, LossMCXENT(), Activation.SOFTMAX),
                         random_ds(rng), device="cpu")
    assert res.passed, f"{act}: {_msg(res)}"
    assert res.n_checked == res.n_params == 4 * 5 + 5 + 5 * 3 + 3


@pytest.mark.parametrize("loss,out_act,onehot", [
    (LossMSE(), Activation.IDENTITY, False),
    (LossMAE(), Activation.IDENTITY, False),
    (LossMCXENT(), Activation.SOFTMAX, True),
    (LossBinaryXENT(), Activation.SIGMOID, True),
    (LossHinge(), Activation.TANH, False),
])
def test_loss_gradients(loss, out_act, onehot, rng):
    res = gradient_check(dense_conf(Activation.TANH, loss, out_act),
                         random_ds(rng, onehot=onehot), device="cpu")
    assert res.passed, f"{loss}: {_msg(res)}"


def test_regularized_gradients(rng):
    conf = dense_conf(Activation.TANH, LossMCXENT(), Activation.SOFTMAX,
                      regularization=[L2Regularization(l2=0.01),
                                      L1Regularization(l1=0.005)])
    res = gradient_check(conf, random_ds(rng), device="cpu")
    assert res.passed, _msg(res)


def test_the_jax_check_and_the_ports_agree_on_the_protocol(rng):
    """The same configuration through both packages' checks: both pass,
    over a flat params vector of the same length, with the same sample
    count."""
    conf = dense_conf(Activation.TANH, LossMCXENT(), Activation.SOFTMAX)
    ds = random_ds(rng)
    jconf = JMLConf.from_json(conf.to_json())
    jres = jax_check(jconf, JDataSet(np.asarray(ds.features),
                                     np.asarray(ds.labels)), n_samples=20,
                     seed=3)
    res = gradient_check(conf, ds, n_samples=20, seed=3, device="cpu")
    assert jres.passed and res.passed, _msg(res)
    assert (res.n_params, res.n_checked) == (jres.n_params, jres.n_checked)


def test_cnn_gradients(rng):
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(NoOp())
            .list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                    activation=Activation.TANH,
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel_size=(2, 2), stride=(2, 2)))
            .layer(OutputLayer(n_out=2, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.convolutional(4, 4, 2))
            .build())
    x = rng.normal(size=(3, 4, 4, 2))
    y = np.eye(2)[rng.integers(0, 2, 3)]
    res = gradient_check(conf, DataSet(x, y), device="cpu")
    assert res.passed, _msg(res)


def test_batchnorm_gradients(rng):
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(NoOp())
            .list()
            .layer(DenseLayer(n_out=5, activation=Activation.IDENTITY))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.feed_forward(4))
            .build())
    res = gradient_check(conf, random_ds(rng), device="cpu")
    assert res.passed, _msg(res)


def test_s2d_stem_and_fused_conv_bn_gradients(rng):
    """The s2d stem's layers and FusedConvBN1x1 in train mode (its
    one-pass statistics on the plain path: the float64 network runs
    without kernels)."""
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(NoOp())
            .list()
            .layer(SpaceToDepthLayer(block_size=2))
            .layer(ZeroPaddingLayer(padding=(1, 2, 1, 2)))
            .layer(ConvolutionLayer(n_out=4, kernel_size=(4, 4),
                                    activation=Activation.TANH,
                                    convolution_mode=ConvolutionMode.TRUNCATE,
                                    has_bias=False))
            .layer(FusedConvBN1x1(n_out=3, activation=Activation.RELU))
            .layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
            .layer(OutputLayer(n_out=2, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.convolutional(8, 8, 2))
            .build())
    x = rng.normal(size=(4, 8, 8, 2))
    y = np.eye(2)[rng.integers(0, 2, 4)]
    res = gradient_check(conf, DataSet(x, y), n_samples=120, device="cpu")
    assert res.passed, _msg(res)


def test_embedding_and_loss_layer_gradients(rng):
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(NoOp())
            .list()
            .layer(EmbeddingLayer(n_in=7, n_out=4, has_bias=True,
                                  activation=Activation.TANH))
            .layer(DenseLayer(n_out=3, activation=Activation.IDENTITY))
            .layer(LossLayer(loss_fn=LossMCXENT(),
                             activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(1))
            .build())
    ids = np.array([[0], [3], [6], [3], [1]])
    y = np.eye(3)[rng.integers(0, 3, 5)]
    res = gradient_check(conf, DataSet(ids, y), device="cpu")
    assert res.passed, _msg(res)
    # every embedding row appears: the rows never looked up get exactly
    # zero gradient, and the check sees it
    assert res.n_checked == 7 * 4 + 4 + 4 * 3 + 3


@pytest.mark.parametrize("layer,shape", [
    (SubsamplingLayer(pooling_type=PoolingType.AVG, kernel_size=(2, 2),
                      stride=(2, 2)), (2, 4, 4, 3)),
    (SubsamplingLayer(pooling_type=PoolingType.PNORM, kernel_size=(2, 2),
                      stride=(2, 2)), (2, 4, 4, 3)),
    (GlobalPoolingLayer(pooling_type=PoolingType.AVG), (2, 4, 4, 3)),
    (LocalResponseNormalization(), (2, 3, 3, 4)),
    (ZeroPaddingLayer(padding=(1, 2, 0, 1)), (2, 3, 3, 2)),
    (SpaceToDepthLayer(block_size=2), (2, 4, 4, 3)),
    (ConvolutionLayer(n_out=3, kernel_size=(4, 4),
                      convolution_mode=ConvolutionMode.TRUNCATE,
                      activation=Activation.TANH), (2, 5, 5, 2)),
    (FusedConvBN1x1(n_out=3, stride=(2, 2), activation=Activation.TANH),
     (2, 4, 4, 3)),
])
def test_layer_input_gradients(layer, shape, rng):
    t = InputType.convolutional(shape[1], shape[2], shape[3])
    res = check_layer_input_gradient(layer, t, rng.normal(size=shape),
                                     device="cpu")
    assert res.passed, _msg(res)
    assert res.n_checked == int(np.prod(shape))


def _graph(builder_fn, *types):
    b = (NeuralNetConfiguration.builder().seed(12345).updater(NoOp())
         .graph_builder())
    return builder_fn(b).set_input_types(*types).build()


def test_ff_vertices_gradients(rng):
    """Merge, Subset, Scale, Shift, L2Normalize, Stack and Unstack in one
    graph."""
    def build(g):
        return (g.add_inputs("in")
                .add_layer("d1", DenseLayer(n_out=4,
                                            activation=Activation.TANH), "in")
                .add_layer("d2", DenseLayer(n_out=3,
                                            activation=Activation.SIGMOID),
                           "in")
                .add_vertex("merge", MergeVertex(), "d1", "d2")
                .add_vertex("sub", SubsetVertex(from_idx=1, to_idx=5),
                            "merge")
                .add_vertex("scale", ScaleVertex(scale_factor=0.5), "sub")
                .add_vertex("shift", ShiftVertex(shift_factor=0.3), "scale")
                .add_vertex("l2", L2NormalizeVertex(), "shift")
                .add_vertex("stack", StackVertex(), "l2", "sub")
                .add_vertex("u0", UnstackVertex(from_idx=0, stack_size=2),
                            "stack")
                .add_vertex("u1", UnstackVertex(from_idx=1, stack_size=2),
                            "stack")
                .add_vertex("prod", ElementWiseVertex(
                    op=ElementWiseOp.PRODUCT), "u0", "u1")
                .add_layer("out", OutputLayer(
                    n_out=3, activation=Activation.SOFTMAX,
                    loss_fn=LossMCXENT()), "prod")
                .set_outputs("out"))

    conf = _graph(build, InputType.feed_forward(6))
    x = rng.normal(size=(5, 6))
    y = np.eye(3)[rng.integers(0, 3, 5)]
    res = gradient_check_graph(conf, DataSet(x, y), device="cpu")
    assert res.passed, _msg(res)


def test_cnn_vertices_gradients(rng):
    """The s2d stem's layers as LayerVertex, an image Merge and Subset on
    the channel axis, Reshape in NHWC order and PreprocessorVertex."""
    def build(g):
        return (g.add_inputs("in")
                .add_layer("conv", ConvolutionLayer(
                    n_out=3, kernel_size=(2, 2), activation=Activation.TANH,
                    convolution_mode=ConvolutionMode.SAME), "in")
                .add_vertex("s2d", LayerVertex(
                    layer=SpaceToDepthLayer(block_size=2)), "conv")
                .add_vertex("pad", LayerVertex(
                    layer=ZeroPaddingLayer(padding=(1, 0, 0, 1))), "s2d")
                .add_vertex("merge", MergeVertex(), "pad", "pad")
                .add_vertex("sub", SubsetVertex(from_idx=2, to_idx=9),
                            "merge")
                .add_vertex("flat", ReshapeVertex(new_shape=(-1, 72)), "sub")
                .add_vertex("img", PreprocessorVertex(
                    preprocessor=FeedForwardToCnnPreProcessor(
                        height=3, width=3, channels=8)), "flat")
                .add_vertex("ff", PreprocessorVertex(
                    preprocessor=CnnToFeedForwardPreProcessor(
                        height=3, width=3, channels=8)), "img")
                .add_vertex("back", ReshapeVertex(new_shape=(-1, 3, 3, 8)),
                            "ff")
                .add_layer("pool", GlobalPoolingLayer(
                    pooling_type=PoolingType.AVG), "back")
                .add_layer("out", OutputLayer(
                    n_out=2, activation=Activation.SOFTMAX,
                    loss_fn=LossMCXENT()), "pool")
                .set_outputs("out"))

    conf = _graph(build, InputType.convolutional(4, 4, 2))
    x = rng.normal(size=(3, 4, 4, 2))
    y = np.eye(2)[rng.integers(0, 2, 3)]
    res = gradient_check_graph(conf, DataSet(x, y), device="cpu")
    assert res.passed, _msg(res)


@pytest.mark.parametrize("causal,masked", [(False, False), (False, True),
                                           (True, True)])
def test_attention_vertex_gradients(causal, masked, rng):
    def build(g):
        g = g.add_inputs("q", "kv", "mask")
        ins = ("q", "kv", "kv", "mask") if masked else ("q", "kv", "kv")
        return (g.add_vertex("attn", AttentionVertex(
                    n_out=6, n_heads=2, causal=causal), *ins)
                .add_layer("pool", GlobalPoolingLayer(
                    pooling_type=PoolingType.AVG), "attn")
                .add_layer("out", OutputLayer(
                    n_out=2, activation=Activation.SOFTMAX,
                    loss_fn=LossMCXENT()), "pool")
                .set_outputs("out"))

    t = 5
    conf = _graph(build, InputType.recurrent(4, timesteps=t),
                  InputType.recurrent(3, timesteps=t),
                  InputType.feed_forward(t))
    q, kv = rng.normal(size=(3, t, 4)), rng.normal(size=(3, t, 3))
    mask = np.ones((3, t))
    mask[0, 3:] = 0.0
    mask[2, 1:] = 0.0
    y = np.eye(2)[rng.integers(0, 2, 3)]
    res = gradient_check_graph(conf, MultiDataSet(features=[q, kv, mask],
                                                  labels=[y]), device="cpu")
    assert res.passed, _msg(res)
    assert res.n_checked == 4 * 6 + 3 * 6 * 2 + 6 * 6 + 6 * 4 + 6 * 2 + 2


class _ScaledBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


@dataclasses.dataclass
class _WrongGradientDense(DenseLayer):
    """A dense layer whose backward is scaled by 1.5: a wrong gradient."""

    def forward(self, params, state, x, train=False, gen=None):
        y, state = super().forward(params, state, x, train, gen)
        return _ScaledBackward.apply(y), state


def test_a_wrong_gradient_fails_the_check(rng):
    conf = (NeuralNetConfiguration.builder().seed(12345).updater(NoOp())
            .list()
            .layer(_WrongGradientDense(n_out=5, activation=Activation.TANH))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.feed_forward(4)).build())
    res = gradient_check(conf, random_ds(rng), device="cpu")
    assert not res.passed
    # the first layer's params (behind the scaled backward) fail, the
    # output layer's do not
    first = 4 * 5 + 5
    assert res.n_failed == first
    assert all(f[0] < first for f in res.failures)
    good = dense_conf(Activation.TANH, LossMCXENT(), Activation.SOFTMAX)
    assert gradient_check(good, random_ds(rng), device="cpu").passed
