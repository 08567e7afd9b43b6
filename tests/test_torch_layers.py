"""Each ported layer, vertex and activation against the JAX package's
forward on the same inputs and parameters.

The port's layer is the JAX layer's config sent through JSON (the packages
share ``@type`` tags); parameters are the JAX layer's own init, carried
over by ``util.convert.convert_layer_params``. Inputs are numpy from a
seed. Images cross between the layouts by a permute (JAX NHWC, port NCHW).

Tolerance: float32 with sums taken in another order on each side (XLA's
CPU convolution vs oneDNN's) — rtol 1e-5, atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import inputs as jit_
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.graph import ElementWiseOp as JOp
from deeplearning4j_tpu.conf.graph import ElementWiseVertex as JEW
from deeplearning4j_tpu.conf.graph import LayerVertex as JLV
from deeplearning4j_tpu.conf.layers import ActivationLayer as JActLayer
from deeplearning4j_tpu.conf.layers import CnnToFeedForwardPreProcessor as JFlat
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import FusedConvBN1x1 as JFused
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.layers_cnn import SubsamplingLayer as JPool
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.util.convert import convert_layer_params

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(jax_obj):
    """The JAX config object's counterpart in the port, through JSON."""
    return serde.from_json(jserde.to_json(jax_obj))


def _to_port(a):
    t = torch.tensor(np.asarray(a))
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def _from_port(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _image(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _random_bn(jparams, jstate, seed):
    """Non-trivial BN affine and running statistics (init's are identity)."""
    rng = np.random.default_rng(seed)
    p = {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
         if k == "gamma" else rng.normal(0, 0.2, v.shape).astype(np.float32)
         for k, v in jparams.items()}
    s = {"mean": rng.normal(0, 0.3, jstate["mean"].shape).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, jstate["var"].shape).astype(np.float32)}
    return p, s


def _check_layer(jlayer, in_shape, itype, seed=0, bn=False):
    """Forward ``jlayer`` and its port on one input; compare outputs."""
    x = _image(in_shape, seed)
    jparams = {k: np.asarray(v) for k, v in
               jlayer.init(jax.random.PRNGKey(seed), itype).items()}
    jstate = {k: np.asarray(v) for k, v in jlayer.init_state(itype).items()}
    if bn:
        rp, jstate = _random_bn(jparams, jstate, seed)
        jparams.update(rp)
    want, _ = jlayer.forward(jparams, jstate, x)
    layer = _port(jlayer)
    got, _ = layer.forward(convert_layer_params(layer, jparams),
                           {k: torch.tensor(v) for k, v in jstate.items()},
                           _to_port(x))
    got = _from_port(got)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # shape inference agrees with the JAX package's
    assert layer.output_type(_port(itype)) == _port(jlayer.output_type(itype))
    return got


CONV_CASES = [
    # (kernel, stride, mode, padding, dilation, size, has_bias, act)
    ((3, 3), (1, 1), "same", (0, 0), (1, 1), 7, True, "identity"),
    ((3, 3), (1, 1), "same", (0, 0), (1, 1), 8, False, "relu"),
    ((3, 3), (2, 2), "same", (0, 0), (1, 1), 7, True, "identity"),
    ((3, 3), (2, 2), "same", (0, 0), (1, 1), 8, False, "tanh"),
    ((7, 7), (2, 2), "same", (0, 0), (1, 1), 9, False, "identity"),
    ((7, 7), (2, 2), "same", (0, 0), (1, 1), 10, False, "identity"),
    ((1, 1), (2, 2), "same", (0, 0), (1, 1), 7, False, "identity"),
    ((3, 3), (2, 2), "truncate", (1, 1), (1, 1), 8, True, "relu"),
    ((2, 2), (1, 1), "truncate", (0, 0), (1, 1), 5, True, "identity"),
    ((3, 3), (1, 1), "same", (0, 0), (2, 2), 9, True, "identity"),
    ((3, 2), (2, 1), "same", (0, 0), (1, 1), 9, True, "identity"),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_convolution_matches_jax(case):
    k, s, mode, pad, dil, size, bias, act = case
    jl = JConv(n_out=5, kernel_size=k, stride=s, padding=pad, dilation=dil,
               convolution_mode=JMode(mode), has_bias=bias,
               activation=JAct(act), bias_init=0.3)
    _check_layer(jl, (2, size, size + 1, 3),
                 jit_.Convolutional(size, size + 1, 3))


POOL_CASES = [
    # (type, kernel, stride, mode, padding, size)
    (t, k, s, m, p, n)
    for t in ("max", "avg", "sum", "pnorm")
    for (k, s, m, p, n) in [((3, 3), (2, 2), "same", (0, 0), 7),
                            ((3, 3), (2, 2), "same", (0, 0), 8),
                            ((2, 2), (2, 2), "truncate", (0, 0), 6),
                            ((3, 3), (2, 2), "truncate", (1, 1), 7)]
]


@pytest.mark.parametrize("case", POOL_CASES)
def test_subsampling_matches_jax(case):
    t, k, s, mode, pad, size = case
    jl = JPool(pooling_type=JPT(t), kernel_size=k, stride=s, padding=pad,
               convolution_mode=JMode(mode))
    _check_layer(jl, (2, size, size, 3), jit_.Convolutional(size, size, 3))


def test_resnet_stem_same_padding_is_xla_asymmetric():
    """The 7x7/2 stem at 224 pads (2, 3) and the 3x3/2 max-pool at 112
    pads (0, 1): the port reproduces XLA's split, not torch's symmetric one."""
    from deeplearning4j_tpu_torch.conf.layers_cnn import _same_pads

    assert _same_pads(224, 7, 2) == (2, 3)
    assert _same_pads(112, 3, 2) == (0, 1)
    assert _same_pads(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("variant", ["running", "locked", "batch_mean",
                                     "feed_forward", "relu"])
def test_batch_normalization_eval_matches_jax(variant):
    kw = {}
    shape, itype = (3, 5, 4, 6), jit_.Convolutional(5, 4, 6)
    if variant == "locked":
        kw["lock_gamma_beta"] = True
    elif variant == "batch_mean":
        kw["use_batch_mean_in_eval"] = True
    elif variant == "feed_forward":
        shape, itype = (4, 6), jit_.FeedForward(6)
    elif variant == "relu":
        kw["activation"] = JAct.RELU
    _check_layer(JBN(**kw), shape, itype, bn=True)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_fused_conv_bn_eval_matches_jax(stride):
    jl = JFused(n_out=4, stride=stride, activation=JAct.RELU)
    _check_layer(jl, (2, 7, 6, 3), jit_.Convolutional(7, 6, 3), bn=True)


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(ptype):
    _check_layer(JGP(pooling_type=JPT(ptype)), (2, 5, 4, 3),
                 jit_.Convolutional(5, 4, 3))


@pytest.mark.parametrize("kind", ["relu", "identity", "no_bias", "output"])
def test_dense_and_output_layers_match_jax(kind):
    if kind == "output":
        jl = JOut(n_out=5)  # softmax head
    else:
        jl = JDense(n_out=5, has_bias=kind != "no_bias", bias_init=0.2,
                    activation=JAct.RELU if kind == "relu" else JAct.IDENTITY)
    _check_layer(jl, (4, 7), jit_.FeedForward(7))


@pytest.mark.parametrize("act", [a.value for a in JAct])
def test_activation_matches_jax(act):
    x = np.linspace(-6.0, 6.0, 241, dtype=np.float32).reshape(1, -1)
    want = np.asarray(JAct(act).apply(x))
    got = Activation(act).apply(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _check_layer(JActLayer(activation=JAct(act)), (2, 9), jit_.FeedForward(9))


@pytest.mark.parametrize("op", [o.value for o in JOp])
def test_elementwise_vertex_matches_jax(op):
    xs = [_image((2, 3, 4, 5), seed) for seed in range(2 if op == "subtract"
                                                        else 3)]
    jv = JEW(op=JOp(op))
    want, _ = jv.forward({}, {}, xs)
    got, _ = _port(jv).forward({}, {}, [_to_port(x) for x in xs])
    np.testing.assert_allclose(_from_port(got), np.asarray(want), **TOL)


def test_layer_vertex_flattens_images_in_jax_order():
    """A dense layer after a CNN input flattens NHWC (the JAX package's
    order), so dense weights carry over unchanged in meaning."""
    itype = jit_.Convolutional(3, 4, 2)
    jdense = JDense(n_out=5, activation=JAct.TANH)
    jv = JLV(layer=jdense, preprocessor=JFlat(height=3, width=4, channels=2))
    x = _image((2, 3, 4, 2), seed=9)
    jparams = {k: np.asarray(v) for k, v in
               jv.init(jax.random.PRNGKey(1), [itype]).items()}
    want, _ = jv.forward(jparams, {}, [x])
    v = _port(jv)
    got, _ = v.forward(convert_layer_params(v.layer, jparams), {},
                       [_to_port(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert v.output_type([_port(itype)]) == _port(jv.output_type([itype]))
