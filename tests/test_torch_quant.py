"""The port's int8 path, piece by piece, on the CPU: the
``matmul_bias_act_int8`` plain version (against a numpy int64 reference and
the JAX package's Pallas kernel in interpret mode), ``quantize_input``, the
quantized layers, LRN, the BN folds, ``_quantize_linear``,
``quantize_for_inference`` and ``calibrate`` against the JAX package, and
the refusals the JAX tests pin.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the int32 sums and the quantized params are exact (integer
math; the same float64 numpy fold). The port's epilogue rounds
``acc * scale`` and then ``+ b`` (its CUDA kernel does the same, bit for
bit); eager jnp does too, but XLA's compiled CPU code (the Pallas
interpreter, a jitted forward) contracts them into one FMA. Where the JAX
side is compiled, outputs agree within that one rounding of the product:
``|diff| <= ulp(acc * scale) + ulp(y)`` (relative ulps mean nothing where
``b`` cancels the product). LRN and the BN-folded layers sum in another
order, rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf import layers_quant as jlq
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import FusedConvBN1x1 as JFused
from deeplearning4j_tpu.conf.layers_cnn import (
    LocalResponseNormalization as JLRN,
)
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.kernels import impls as jimpls
from deeplearning4j_tpu.nn import inference_opt as jiopt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.conf.layers_quant import (
    QuantizedConv1x1Layer,
    QuantizedDenseLayer,
    quantize_input,
)
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.kernels import build, impls
from deeplearning4j_tpu_torch.nn import inference_opt as iopt
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import params_from_jax
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

pytestmark = pytest.mark.torch

FOLD_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)  # softmax outputs of folded f32 nets


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int64).astype(np.int8)


def _int8_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq, wq = _int8(rng, (m, k)), _int8(rng, (k, n))
    xq[0, :] = -128  # the extreme product: an int8 wrap or a float32
    wq[:, 0] = -128  # accumulation would show in column 0 of row 0
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return xq, wq, scale, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_epilogue_close(got, want, product):
    """``got`` and ``want`` differ at most by how one FMA and two roundings
    of ``product + b`` can differ: ``ulp(product) + ulp(want)``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = (np.spacing(np.abs(np.asarray(product, np.float32)))
             + np.spacing(np.abs(want)))
    bad = np.abs(got.astype(np.float64) - want) > bound
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} outside one "
                           f"rounding of the product")


# --------------------------------------------------------------------------
# matmul_bias_act_int8: the plain version
# --------------------------------------------------------------------------

# (m, k, n): the AlexNet serving shapes at batch 1 and a tall ragged one,
# and the JAX fixtures' ragged K (27, 9, 11)
INT64_SHAPES = [(1, 6400, 8), (32, 4096, 16), (7, 27, 5), (3, 9, 11),
                (5, 11, 3)]


@pytest.mark.parametrize("shape", INT64_SHAPES)
def test_plain_int32_sums_equal_numpy_int64(shape):
    """identity, scale 1, b 0: the plain version returns float32 of the
    exact sum; |acc| reaches 128 * 128 * K (above 2**24 at K >= 1024, so a
    float32 accumulation would round, and int8 products would wrap)."""
    m, k, n = shape
    xq, wq, _, _ = _int8_operands(m, k, n, seed=k)
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    assert want[0, 0] == 128 * 128 * k
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    y = impls.matmul_bias_act_int8_plain(*_t(xq, wq, ones, zeros),
                                         Activation.IDENTITY)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    np.testing.assert_array_equal(y.numpy(), want.astype(np.float32))
    if 128 * 128 * k < 2 ** 24:  # below 2**24 float32 holds the sum itself
        np.testing.assert_array_equal(y.numpy().astype(np.int64), want)


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("shape", INT64_SHAPES)
def test_plain_epilogue_rounds_scale_then_bias(shape, act):
    """act(float32(acc) * scale + b), each step rounded to float32, against
    numpy on the int64 sums."""
    xq, wq, scale, b = _int8_operands(*shape, seed=1)
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    z = (acc * scale).astype(np.float32) + b
    want = np.maximum(z, 0.0) if act == "relu" else z
    y = impls.matmul_bias_act_int8_plain(*_t(xq, wq, scale, b),
                                         Activation(act))
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("shape,tiling", [((16, 24, 16), (16, 16, 24)),
                                          ((8, 64, 32), (8, 16, 16)),
                                          ((32, 128, 64), (16, 32, 32))])
def test_plain_matches_pallas_int8_kernel(shape, tiling, act):
    """The JAX package's ``_mm_bias_act_q8_kernel`` in interpret mode (K
    split over grid steps where the tiling says so) against the port's
    plain version: the same int32 sums, then one FMA (compiled XLA) against
    two roundings (the port)."""
    m, k, n = shape
    xq, wq, scale, b = _int8_operands(m, k, n, seed=5)
    want = np.asarray(jimpls.matmul_bias_act_int8(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
        jnp.asarray(b), JAct(act), tiling, True))
    got = impls.matmul_bias_act_int8(*_t(xq, wq, scale, b), Activation(act))
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    assert_epilogue_close(got.numpy(), want, acc * scale)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    xq, wq, scale, b = _t(*_int8_operands(4, 40, 12, seed=2))
    before = impls.matmul_bias_act_int8.launches
    got = impls.matmul_bias_act_int8(xq, wq, scale, b, Activation.RELU)
    assert impls.matmul_bias_act_int8.launches == before
    assert torch.equal(got, impls.matmul_bias_act_int8_plain(
        xq, wq, scale, b, Activation.RELU))


@pytest.mark.parametrize("case", ["softmax", "shape", "dtype", "scale_dtype",
                                  "vector", "deep_k"])
def test_int8_wrapper_refuses_what_the_kernel_does_not_take(case):
    xq, wq, scale, b = _t(*_int8_operands(4, 16, 8, seed=0))
    act = Activation.IDENTITY
    if case == "softmax":
        act = Activation.SOFTMAX
    elif case == "shape":
        wq = wq[:15]
    elif case == "dtype":
        xq = xq.float()
    elif case == "scale_dtype":
        scale = scale.double()
    elif case == "vector":
        b = b[:7]
    elif case == "deep_k":
        k = impls.INT8_K_MAX + 1
        xq = torch.zeros((1, k), dtype=torch.int8)
        wq = torch.zeros((k, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        impls.matmul_bias_act_int8(xq, wq, scale, b, act)


def test_int8_source_builds_with_the_others_and_matches_its_signature():
    """The CUDA source is one of the library's sources, and its exported
    function takes as many arguments as the ctypes signature declares."""
    assert impls.INT8_SOURCE in impls.SOURCES
    src = (build.CSRC / "matmul_bias_act_int8.cu").read_text()
    for fn, (_, argtypes) in impls._INT8_SIGNATURES.items():
        head = src[src.index(f"int {fn}("):]
        params = head[:head.index(")")].split(",")
        assert len(params) == len(argtypes), fn
    assert "__fmul_rn" in src and "__fadd_rn" in src  # two roundings


# --------------------------------------------------------------------------
# quantize_input and the quantized layers
# --------------------------------------------------------------------------

def _quant_params(k, n, seed):
    rng = np.random.default_rng(seed)
    return {"Wq": _int8(rng, (k, n)),
            "scale": rng.uniform(1e-3, 1e-2, n).astype(np.float32),
            "b": rng.normal(size=n).astype(np.float32),
            "xs": rng.uniform(0.01, 0.05, k).astype(np.float32),
            "xz": rng.uniform(-20, 20, k).round().astype(np.float32)}


def test_quantize_input_equals_jax():
    """Round half to even and the clip at both ends, int8 for int8."""
    rng = np.random.default_rng(3)
    xs = np.full(8, 0.5, np.float32)
    xz = np.zeros(8, np.float32)
    x = rng.normal(scale=40.0, size=(64, 8)).astype(np.float32)
    x[0] = [0.25, 0.75, 1.25, -0.25, -0.75, 100.0, -100.0, 63.75]  # halves
    want = np.asarray(jlq.quantize_input(jnp.asarray(x), jnp.asarray(xs),
                                         jnp.asarray(xz)))
    got = quantize_input(*_t(x, xs, xz))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().min() == -128 and got.numpy().max() == 127


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_quantized_dense_layer_matches_jax(act):
    k, n = 27, 11
    p = _quant_params(k, n, seed=7)
    x = np.random.default_rng(8).normal(size=(6, k)).astype(np.float32)
    jlayer = jlq.QuantizedDenseLayer(n_out=n, activation=JAct(act))
    want, _ = jlayer.forward({kk: jnp.asarray(v) for kk, v in p.items()}, {},
                             jnp.asarray(x))
    layer = QuantizedDenseLayer(n_out=n, activation=Activation(act))
    tp = dict(zip(p, _t(*p.values())))
    got, _ = layer.forward(tp, {}, torch.from_numpy(x))
    # the int32 sums, exactly
    xq = quantize_input(torch.from_numpy(x), tp["xs"], tp["xz"])
    jacc = jax.lax.dot_general(
        jnp.asarray(xq.numpy()), jnp.asarray(p["Wq"]), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(
        (xq.int() @ tp["Wq"].int()).numpy(), np.asarray(jacc))
    assert_epilogue_close(got.numpy(), np.asarray(want),
                          np.asarray(jacc).astype(np.float32) * p["scale"])


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_quantized_conv1x1_layer_matches_jax(stride):
    cin, cout = 9, 7
    p = _quant_params(cin, cout, seed=11)
    x = np.random.default_rng(12).normal(size=(2, 5, 5, cin)).astype(
        np.float32)  # NHWC
    jlayer = jlq.QuantizedConv1x1Layer(n_out=cout, stride=stride,
                                       activation=JAct.RELU)
    want, _ = jlayer.forward({kk: jnp.asarray(v) for kk, v in p.items()}, {},
                             jnp.asarray(x))
    layer = QuantizedConv1x1Layer(n_out=cout, stride=stride,
                                  activation=Activation.RELU)
    tp = dict(zip(p, _t(*p.values())))
    got, _ = layer.forward(tp, {}, torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    side = 3 if stride == (2, 2) else 5
    assert got.shape == np.asarray(want).shape == (2, side, side, cout)
    xq = jlq.quantize_input(jnp.asarray(x[:, ::stride[0], ::stride[1]]),
                            jnp.asarray(p["xs"]), jnp.asarray(p["xz"]))
    acc = np.asarray(xq, np.int64) @ p["Wq"].astype(np.int64)
    assert_epilogue_close(got, np.asarray(want),
                          acc.astype(np.float32) * p["scale"])


@pytest.mark.parametrize("n", [5, 4, 3])
def test_local_response_normalization_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(2, 3, 4, 11)).astype(
        np.float32) * 3.0
    kw = dict(k=2.0, n=n, alpha=1e-2, beta=0.75)
    want, _ = JLRN(**kw).forward({}, {}, jnp.asarray(x))
    got, _ = LocalResponseNormalization(**kw).forward(
        {}, {}, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=0)


# --------------------------------------------------------------------------
# the BN fold (optimize_for_inference of a MultiLayerNetwork)
# --------------------------------------------------------------------------

def _bn_net(kind):
    """A small MLN whose layer 0 absorbs the BN after it (``dense``,
    ``conv``), or a FusedConvBN1x1 to unfuse (``fused``), in both
    packages with the same params and seeded BN statistics."""
    b = (JNNC.builder().seed(4).updater(JSgd(0.1)).weight_init(JWI.XAVIER)
         .list())
    if kind == "dense":
        b.layer(JDense(n_out=12, activation=JAct.IDENTITY))
        b.layer(JBN(activation=JAct.RELU))
        itype = JIT.feed_forward(9)
    elif kind == "conv":
        b.layer(JConv(n_out=6, kernel_size=(3, 3), has_bias=False,
                      convolution_mode=JMode.SAME))
        b.layer(JBN(activation=JAct.TANH))
        itype = JIT.convolutional(5, 5, 3)
    else:
        b.layer(JFused(n_out=6, stride=(2, 2), activation=JAct.RELU))
        itype = JIT.convolutional(5, 5, 3)
    b.layer(JOut(n_out=4, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
    jnet = JMLN(b.set_input_type(itype).build()).init()
    rng = np.random.default_rng(9)
    for key, st in jnet.state.items():
        n = st["mean"].shape[0]
        jnet.state[key] = {"mean": jnp.asarray(rng.normal(0, 0.3, n),
                                               jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, n),
                                              jnp.float32)}
        jnet.params[key] = dict(jnet.params[key],
                                gamma=jnp.asarray(rng.uniform(0.5, 1.5, n),
                                                  jnp.float32),
                                beta=jnp.asarray(rng.normal(0, 0.2, n),
                                                 jnp.float32))
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    return jnet, MultiLayerNetwork(conf, "cpu").set_params(p, s), itype


@pytest.mark.parametrize("kind", ["dense", "conv", "fused"])
def test_bn_fold_matches_jax(kind):
    jnet, net, itype = _bn_net(kind)
    jopt = jiopt.optimize_for_inference(jnet)
    opt = iopt.optimize_for_inference(net)
    assert opt.conf.to_json() == jopt.conf.to_json()
    names = [type(layer).__name__ for layer in opt.conf.layers]
    assert names[0] == ("DenseLayer" if kind == "dense"
                        else "ConvolutionLayer")
    assert not {"BatchNormalization", "FusedConvBN1x1"} & set(names)
    assert opt.conf.layers[0].has_bias
    want_p, _ = params_from_jax(opt.conf, _to_np(jopt.params),
                                _to_np(jopt.state))
    for key in want_p["0"]:
        np.testing.assert_allclose(opt.params["0"][key].numpy(),
                                   want_p["0"][key].numpy(), **FOLD_TOL)
    shape = ((7, itype.size) if kind == "dense"
             else (7, itype.height, itype.width, itype.channels))
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(opt.output(x), np.asarray(jopt.output(x)),
                               **OUT_TOL)
    np.testing.assert_allclose(opt.output(x), net.output(x), **OUT_TOL)


# --------------------------------------------------------------------------
# _quantize_linear, quantize_for_inference, calibrate
# --------------------------------------------------------------------------

def test_quantize_linear_is_the_jax_fold_bit_for_bit():
    rng = np.random.default_rng(2)
    W = rng.normal(size=(37, 13)).astype(np.float32)
    b = rng.normal(size=13).astype(np.float32)
    lo = rng.uniform(-3, 0, 37).astype(np.float32).tolist()
    hi = rng.uniform(0, 3, 37).astype(np.float32).tolist()
    lo[3] = hi[3] = 0.5  # a degenerate range takes the 1e-8 floor
    for got, want in zip(iopt._quantize_linear(W, b, lo, hi),
                         jiopt._quantize_linear(W, b, lo, hi)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _mlp(seed=3, n_in=9, hidden=27, n_out=4):
    """The JAX package's ``tests/test_quant.py::_mlp`` fixture, and the
    port's network on its params."""
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=hidden, activation=JAct.RELU))
            .layer(JOut(n_out=n_out, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(n_in)).build())
    return _pair(JMLN(conf).init())


def _conv_mlp(seed=5, h=4, w=4, c=3, width=11, n_out=3):
    """The JAX package's ``tests/test_quant.py::_conv_mlp`` fixture."""
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(JConv(n_out=width, kernel_size=(1, 1),
                         activation=JAct.RELU))
            .layer(JOut(n_out=n_out, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(h, w, c)).build())
    return _pair(JMLN(conf).init())


def _pair(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    return jnet, MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _batches(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _port_record(jrec):
    """The JAX package's calibration record as a port record."""
    return iopt.CalibrationRecord(**dataclasses.asdict(jrec))


FIXTURES = {"mlp": (_mlp, (16, 9)), "conv_mlp": (_conv_mlp, (8, 4, 4, 3))}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_quantize_for_inference_on_jax_ranges_is_bit_identical(fixture):
    make, shape = FIXTURES[fixture]
    jnet, net = make()
    jrec = jiopt.calibrate(jnet, _batches(shape))
    jq = jiopt.quantize_for_inference(jnet, jrec)
    q = iopt.quantize_for_inference(net, _port_record(jrec))
    assert q.conf.to_json() == jq.conf.to_json()
    assert q.conf.quantization.digest == jrec.digest
    for key in jrec.ranges:
        for name in ("Wq", "scale", "b", "xs", "xz"):
            got = q.params[key][name].numpy()
            want = np.asarray(jq.params[key][name])
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            # the kernel takes row-major operands
            assert q.params[key][name].is_contiguous(), name


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_calibrate_ranges_match_jax(fixture):
    """Ranges within rtol 1e-5 of the JAX package's. The digest hashes the
    same JSON of (scheme, seed, percentile, graph, ranges) in both
    packages, and the two confs' reprs (the graph signature) are equal, so
    the digests are equal exactly when the ranges are: the MLP's quantized
    layer reads the network input, the same bytes in both packages, and
    its digest equals the JAX package's."""
    make, shape = FIXTURES[fixture]
    jnet, net = make()
    batches = _batches(shape)
    jrec = jiopt.calibrate(jnet, batches)
    rec = iopt.calibrate(net, batches)
    assert rec.graph == jrec.graph
    assert sorted(rec.ranges) == sorted(jrec.ranges)
    for key in jrec.ranges:
        for side in ("lo", "hi"):
            np.testing.assert_allclose(rec.ranges[key][side],
                                       jrec.ranges[key][side], rtol=1e-5,
                                       atol=1e-6)
    assert (rec.digest == jrec.digest) == (rec.ranges == jrec.ranges)
    if fixture == "mlp":
        assert rec.digest == jrec.digest
    assert iopt._range_digest(jrec.scheme, jrec.seed, jrec.clip_percentile,
                              jrec.graph, jrec.ranges) == jrec.digest


def test_calibration_is_deterministic():
    """Same set and seed: the same digest and bit-identical params; other
    data or another seed: another digest."""
    _, net = _mlp()
    batches = _batches((16, 9))
    r1, r2 = iopt.calibrate(net, batches), iopt.calibrate(net, batches)
    assert r1 == r2
    q1 = iopt.quantize_for_inference(net, r1)
    q2 = iopt.quantize_for_inference(net, r2)
    for key, vp in q1.params.items():
        for name, v in vp.items():
            assert torch.equal(v, q2.params[key][name]), (key, name)
    assert iopt.calibrate(net, _batches((16, 9), seed=99)).digest != r1.digest
    assert iopt.calibrate(net, batches, seed=7).digest != r1.digest
    assert iopt.lookup_calibration(r1.digest[:8]) == r1


def test_calibrate_takes_tuples_and_uint8_images():
    _, net = _conv_mlp()
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (8, 4, 4, 3), np.uint8) for _ in range(2)]
    floats = [(a.astype(np.float32) / 255.0) for a in imgs]
    r_u8 = iopt.calibrate(net, [(a, None) for a in imgs])
    r_f = iopt.calibrate(net, floats)
    for key in r_f.ranges:
        np.testing.assert_allclose(r_u8.ranges[key]["hi"],
                                   r_f.ranges[key]["hi"], rtol=1e-6)


# --------------------------------------------------------------------------
# refusals (the JAX package's tests/test_quant.py pins the same)
# --------------------------------------------------------------------------

def test_quantize_rejects_mismatched_model():
    _, net = _mlp(hidden=27)
    rec = iopt.calibrate(net, _batches((16, 9)))
    _, other = _mlp(hidden=33)
    with pytest.raises(ValueError, match="recalibrate"):
        iopt.quantize_for_inference(other, rec)


def test_already_quantized_model_is_refused():
    _, net = _mlp()
    rec = iopt.calibrate(net, _batches((16, 9)))
    q = iopt.quantize_for_inference(net, rec)
    with pytest.raises(ValueError, match="already quantized"):
        iopt.calibrate(q, _batches((16, 9)))
    with pytest.raises(ValueError, match="already quantized"):
        iopt.quantize_for_inference(q, rec)


def test_unknown_scheme_is_refused():
    _, net = _mlp()
    with pytest.raises(ValueError, match="unknown quantization scheme"):
        iopt.calibrate(net, _batches((16, 9)), scheme="int4")
    rec = dataclasses.replace(iopt.calibrate(net, _batches((16, 9))),
                              scheme="int4")
    with pytest.raises(ValueError, match="unknown scheme"):
        iopt.quantize_for_inference(net, rec)


def test_no_quantizable_layer_and_empty_set_are_refused():
    conf = (JNNC.builder().seed(1).list()
            .layer(JConv(n_out=4, kernel_size=(3, 3)))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(5, 5, 2)).build())
    _, net = _pair(JMLN(conf).init())
    with pytest.raises(ValueError, match="no quantizable layers"):
        iopt.calibrate(net, _batches((2, 5, 5, 2)))
    _, mlp = _mlp()
    with pytest.raises(ValueError, match="empty calibration set"):
        iopt.calibrate(mlp, [])


def test_a_computation_graph_is_refused():
    graph = ComputationGraph(ResNet50(num_classes=3).conf(), device="cpu")
    with pytest.raises(TypeError, match="MultiLayerNetwork"):
        iopt.calibrate(graph, [])
    with pytest.raises(TypeError, match="MultiLayerNetwork"):
        iopt.quantize_for_inference(graph, None)
