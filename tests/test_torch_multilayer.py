"""The port's MultiLayerNetwork, int8 quantization and serving of whole
networks on the CPU, against the JAX package on the same parameters.

Networks: the zoo's AlexNet configuration at full width (configuration,
JSON and parameter count only), an AlexNet-shaped network at narrow widths
(every AlexNet layer kind: the 11x11/4 TRUNCATE stem, LRN, 3x3/2 max-pools,
SAME convolutions, the automatic flatten, two dropout dense layers and the
softmax head; 99x99x3 input, so the flatten is 2x2x8 and its NHWC order
matters), and the JAX package's ``tests/test_quant.py`` fixtures ``_mlp``
and ``_conv_mlp``. Inputs are made with numpy from a seed.

Tolerances: float32 forwards sum in another order than XLA (rtol 1e-4,
atol 1e-6 on activations and softmax outputs). A quantized network is
compared against the JAX artifact quantized from the same calibration
ranges: its params are bit-identical, but the activations that enter
``quantize_input`` differ by float32 rounding, which can move an int8 value
by one step at a rounding boundary, and XLA contracts the epilogue into an
FMA (``tests/test_torch_quant.py``): softmax outputs within atol 1e-5 (the
narrow AlexNet's differ by 7.5e-9; quantization itself moves them by
1.2e-4).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import ActivationLayer as JActLayer
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import DropoutLayer as JDrop
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionMode as JMode
from deeplearning4j_tpu.conf.layers_cnn import (
    LocalResponseNormalization as JLRN,
)
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.layers_cnn import SubsamplingLayer as JPool
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn import inference_opt as jiopt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.zoo.models import AlexNet as JAlexNet
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.layers import (
    CnnToFeedForwardPreProcessor,
    DenseLayer,
    DropoutLayer,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import ConvolutionLayer
from deeplearning4j_tpu_torch.conf.multilayer import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn import inference_opt as iopt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.batcher import (
    BatchingConfig,
    InferenceEngine,
)
from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
from deeplearning4j_tpu_torch.util.convert import params_from_jax
from deeplearning4j_tpu_torch.zoo import AlexNet

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

F32_TOL = dict(rtol=1e-4, atol=1e-6)
Q_ATOL = 1e-5
IMG = (99, 99, 3)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jnet):
    """The port's network on the JAX network's conf (through JSON) and
    params."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _narrow_alexnet_conf(seed=7):
    """AlexNet's layer list (JAX ``zoo/models.py::AlexNet.conf``) at
    narrow widths on a 99x99x3 input."""
    def conv(n, k):
        return JConv(n_out=n, kernel_size=k, activation=JAct.RELU,
                     convolution_mode=JMode.SAME)

    def pool():
        return JPool(pooling_type=JPT.MAX, kernel_size=(3, 3), stride=(2, 2),
                     convolution_mode=JMode.TRUNCATE)

    return (JNNC.builder().seed(seed).weight_init(JWI.NORMAL).list()
            .layer(JConv(n_out=8, kernel_size=(11, 11), stride=(4, 4),
                         activation=JAct.RELU,
                         convolution_mode=JMode.TRUNCATE))
            .layer(JLRN()).layer(pool())
            .layer(conv(16, (5, 5))).layer(JLRN()).layer(pool())
            .layer(conv(12, (3, 3))).layer(conv(12, (3, 3)))
            .layer(conv(8, (3, 3))).layer(pool())
            .layer(JDense(n_out=24, activation=JAct.RELU, dropout=0.5))
            .layer(JDense(n_out=24, activation=JAct.RELU, dropout=0.5))
            .layer(JOut(n_out=10, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.convolutional(*IMG)).build())


def _images(n, seed, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (n,) + IMG, np.uint8)
    return rng.random((n,) + IMG, dtype=np.float32)


@pytest.fixture(scope="module")
def alexnet():
    """The narrow AlexNet in both packages, f32 and quantized from the JAX
    package's calibration record (4 seeded batches of 8 images)."""
    jnet = JMLN(_narrow_alexnet_conf()).init()
    net = _pair(jnet)
    batches = [_images(8, seed=s) for s in range(4)]
    jrec = jiopt.calibrate(jnet, batches)
    jq = jiopt.quantize_for_inference(jnet, jrec)
    q = iopt.quantize_for_inference(
        net, iopt.CalibrationRecord(**dataclasses.asdict(jrec)))
    return {"jnet": jnet, "net": net, "jq": jq, "q": q, "batches": batches,
            "jrec": jrec}


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def test_alexnet_conf_is_the_jax_packages():
    """Full width: the same JSON both ways, the flatten at index 10 and
    the two quantizable dense layers at 11 (6400 -> 4096) and 12."""
    conf, jconf = AlexNet().conf(), JAlexNet().conf()
    assert conf.to_json() == jconf.to_json()
    assert MultiLayerConfiguration.from_json(jconf.to_json()) == conf
    assert type(jconf).from_json(conf.to_json()) == jconf
    assert isinstance(conf.layers[10], CnnToFeedForwardPreProcessor)
    types = conf.input_types()
    assert (types[11].size, conf.layers[11].n_out) == (6400, 4096)
    assert (types[12].size, conf.layers[12].n_out) == (4096, 4096)
    assert [i for i, (layer, t) in enumerate(zip(conf.layers, types))
            if iopt._quantizable(layer, t)] == [11, 12]


def test_alexnet_param_count_matches_jax():
    """Layer by layer against the JAX package's init shapes (traced, not
    drawn): 50,844,008 params in all."""
    conf, jconf = AlexNet().conf(), JAlexNet().conf()
    key = jax.random.PRNGKey(0)
    want = [sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k, lyr=lyr, t=t: lyr.init(k, t), key)))
        for lyr, t in zip(jconf.layers, jconf.input_types())]
    gen = torch.Generator().manual_seed(0)
    got = [sum(v.numel() for v in lyr.init(gen, t).values())
           if isinstance(lyr, (DenseLayer, ConvolutionLayer)) else 0
           for lyr, t in zip(conf.layers, conf.input_types())]
    assert got == want
    assert sum(got) == 50_844_008


def test_quantized_conf_json_round_trips_between_packages(alexnet):
    jconf, conf = alexnet["jq"].conf, alexnet["q"].conf
    assert conf.to_json() == jconf.to_json()
    assert MultiLayerConfiguration.from_json(jconf.to_json()) == conf
    assert type(jconf).from_json(conf.to_json()) == jconf
    assert conf.quantization.digest == alexnet["jrec"].digest
    assert [type(lyr).__name__ for lyr in conf.layers[11:]] == [
        "QuantizedDenseLayer", "QuantizedDenseLayer", "OutputLayer"]


def test_list_builder_inserts_the_flatten_and_refuses_the_unported():
    b = (NeuralNetConfiguration.builder().list()
         .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
         .layer(DenseLayer(n_out=5)))
    with pytest.raises(ValueError, match="set_input_type"):
        b.build()
    conf = b.set_input_type(InputType.convolutional(5, 5, 2)).build()
    assert [type(lyr).__name__ for lyr in conf.layers] == [
        "ConvolutionLayer", "CnnToFeedForwardPreProcessor", "DenseLayer"]
    assert [lyr.name for lyr in conf.layers] == ["layer0", "layer1",
                                                 "layer2"]
    flat = (NeuralNetConfiguration.builder().list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .set_input_type(InputType.convolutional_flat(5, 5, 2)))
    assert [type(lyr).__name__ for lyr in flat.build().layers] == [
        "FeedForwardToCnnPreProcessor", "ConvolutionLayer"]
    cube = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer(n_out=5))
            .set_input_type(InputType.convolutional_3d(2, 3, 3, 2)))
    assert [type(lyr).__name__ for lyr in cube.build().layers] == [
        "Cnn3DToFeedForwardPreProcessor", "DenseLayer"]


# --------------------------------------------------------------------------
# float32 networks
# --------------------------------------------------------------------------

def test_narrow_alexnet_output_matches_jax(alexnet):
    x = _images(5, seed=10)
    np.testing.assert_allclose(alexnet["net"].output(x),
                               np.asarray(alexnet["jnet"].output(x)),
                               **F32_TOL)


def test_narrow_alexnet_uint8_output_matches_jax(alexnet):
    x = _images(3, seed=11, uint8=True)
    np.testing.assert_allclose(alexnet["net"].output(x),
                               np.asarray(alexnet["jnet"].output(x)),
                               **F32_TOL)


def test_narrow_alexnet_feed_forward_matches_jax_layer_by_layer(alexnet):
    x = _images(2, seed=12)
    got = alexnet["net"].feed_forward(x)
    want = alexnet["jnet"].feed_forward(x)
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"layer {i}")


def test_clone_copies_and_num_params_matches_jax(alexnet):
    net = alexnet["net"]
    other = net.clone()
    assert other.num_params() == net.num_params() == \
        alexnet["jnet"].num_params()
    other.params["0"]["W"].zero_()
    assert net.params["0"]["W"].abs().sum() > 0


# --------------------------------------------------------------------------
# quantized networks
# --------------------------------------------------------------------------

def test_quantized_narrow_alexnet_output_matches_jax(alexnet):
    x = _images(6, seed=13)
    got = alexnet["q"].output(x)
    want = np.asarray(alexnet["jq"].output(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=Q_ATOL)
    # quantization moved the output by far more than the packages differ
    assert np.abs(got - alexnet["net"].output(x)).max() > Q_ATOL / 10


def test_narrow_alexnet_calibration_ranges_match_jax(alexnet):
    """The port's own calibration of the same batches: the ranges of both
    dense layers' inputs within rtol 1e-5 (atol 1e-6) of the JAX record's;
    they read computed activations, so the digests differ unless every
    range is bit-equal."""
    rec = iopt.calibrate(alexnet["net"], alexnet["batches"])
    jrec = alexnet["jrec"]
    assert rec.graph == jrec.graph and sorted(rec.ranges) == ["11", "12"]
    for key in jrec.ranges:
        for side in ("lo", "hi"):
            np.testing.assert_allclose(rec.ranges[key][side],
                                       jrec.ranges[key][side], rtol=1e-5,
                                       atol=1e-6)
    assert (rec.digest == jrec.digest) == (rec.ranges == jrec.ranges)


def test_quantized_params_are_the_jax_artifacts(alexnet):
    for key in ("11", "12"):
        for name in ("Wq", "scale", "b", "xs", "xz"):
            got = alexnet["q"].params[key][name].numpy()
            want = np.asarray(alexnet["jq"].params[key][name])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_routed_quantized_forward_equals_stock_on_cpu(alexnet):
    """use_kernels routes the int8 layers to the wrapper, which runs the
    plain version on the CPU: the same function as the stock forward."""
    q = alexnet["q"]
    routed = MultiLayerNetwork(dataclasses.replace(q.conf, use_kernels=True),
                               "cpu").set_params(q.params, q.state)
    x = _images(4, seed=14)
    np.testing.assert_array_equal(routed.output(x), q.output(x))


def test_jax_quantized_params_convert_with_int8_kept(alexnet):
    """params_from_jax of the JAX artifact: Wq stays int8 [K, N], and the
    port network on them serves what the port's own artifact serves."""
    jq = alexnet["jq"]
    conf = MultiLayerConfiguration.from_json(jq.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jq.params), _to_np(jq.state))
    assert p["11"]["Wq"].dtype == torch.int8
    assert tuple(p["11"]["Wq"].shape) == (32, 24)
    net = MultiLayerNetwork(conf, "cpu").set_params(p, s)
    assert net.params["12"]["Wq"].dtype == torch.int8
    x = _images(3, seed=15)
    np.testing.assert_array_equal(net.output(x), alexnet["q"].output(x))


@pytest.mark.parametrize("fixture", ["mlp", "conv_mlp"])
def test_jax_quant_fixtures_match(fixture):
    """``tests/test_quant.py``'s ``_mlp`` and ``_conv_mlp``: f32 and
    quantized (from the JAX record) outputs against the JAX package's."""
    if fixture == "mlp":
        conf = (JNNC.builder().seed(3).updater(JSgd(0.1))
                .weight_init(JWI.XAVIER).list()
                .layer(JDense(n_out=27, activation=JAct.RELU))
                .layer(JOut(n_out=4, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
                .set_input_type(JIT.feed_forward(9)).build())
        shape = (16, 9)
    else:
        conf = (JNNC.builder().seed(5).updater(JSgd(0.1))
                .weight_init(JWI.XAVIER).list()
                .layer(JConv(n_out=11, kernel_size=(1, 1),
                             activation=JAct.RELU))
                .layer(JOut(n_out=3, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()))
                .set_input_type(JIT.convolutional(4, 4, 3)).build())
        shape = (8, 4, 4, 3)
    jnet = JMLN(conf).init()
    net = _pair(jnet)
    rng = np.random.default_rng(1)
    batches = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jrec = jiopt.calibrate(jnet, batches)
    jq = jiopt.quantize_for_inference(jnet, jrec)
    q = iopt.quantize_for_inference(
        net, iopt.CalibrationRecord(**dataclasses.asdict(jrec)))
    x = batches[0][:5]
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **F32_TOL)
    np.testing.assert_allclose(q.output(x), np.asarray(jq.output(x)),
                               rtol=0, atol=Q_ATOL)
    routed = MultiLayerNetwork(dataclasses.replace(q.conf, use_kernels=True),
                               "cpu").set_params(q.params, q.state)
    np.testing.assert_array_equal(routed.output(x), q.output(x))


# --------------------------------------------------------------------------
# optimize_for_inference of a MultiLayerNetwork
# --------------------------------------------------------------------------

def test_prune_matches_jax():
    """DropoutLayer and an IDENTITY ActivationLayer vanish, dropout fields
    are zeroed; the result is the JAX package's configuration."""
    conf = (JNNC.builder().seed(2).list()
            .layer(JDense(n_out=8, activation=JAct.TANH, dropout=0.8))
            .layer(JDrop(dropout=0.5))
            .layer(JActLayer(activation=JAct.IDENTITY))
            .layer(JDense(n_out=6, activation=JAct.RELU))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(5)).build())
    jnet = JMLN(conf).init()
    net = _pair(jnet)
    opt, jopt = iopt.optimize_for_inference(net), \
        jiopt.optimize_for_inference(jnet)
    assert opt.conf.to_json() == jopt.conf.to_json()
    assert [type(lyr).__name__ for lyr in opt.conf.layers] == [
        "DenseLayer", "DenseLayer", "OutputLayer"]
    assert opt.conf.layers[0].dropout == 0.0
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(opt.output(x), net.output(x), **F32_TOL)
    np.testing.assert_allclose(opt.output(x), np.asarray(jopt.output(x)),
                               **F32_TOL)


@pytest.mark.parametrize("args,kwargs", [
    ((), {}),
    ((), {"fold_bn": False}),
    ((), {"prune": False}),
    ((True,), {}),  # positional: fold_bn, as in the JAX package
    ((True, True, True), {}),
    ((), {"fold_bn": False, "prune": False, "bf16": True}),
], ids=["defaults", "no_fold", "no_prune", "positional_fold",
        "positional_bf16", "keywords_bf16"])
def test_optimize_for_inference_flags_match_jax(args, kwargs):
    """``optimize_for_inference(model, fold_bn, prune, bf16)`` takes the JAX
    package's arguments in its order, each gating its own pass: the
    serving copy's configuration, compute dtype and outputs match the JAX
    package's for an MLN with a foldable BN (seeded running statistics)
    and dropout."""
    conf = (JNNC.builder().seed(6).list()
            .layer(JDense(n_out=8, activation=JAct.IDENTITY))
            .layer(JBN(activation=JAct.RELU))
            .layer(JDrop(dropout=0.5))
            .layer(JDense(n_out=6, activation=JAct.TANH, dropout=0.9))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(5)).build())
    jnet = JMLN(conf).init()
    rng = np.random.default_rng(8)
    jnet.state["1"] = {
        "mean": jax.numpy.asarray(rng.normal(size=8).astype(np.float32)),
        "var": jax.numpy.asarray(rng.uniform(0.5, 2.0, 8).astype(np.float32))}
    net = _pair(jnet)
    opt = iopt.optimize_for_inference(net, *args, **kwargs)
    jopt = jiopt.optimize_for_inference(jnet, *args, **kwargs)
    assert opt.conf.to_json() == jopt.conf.to_json()
    assert opt.conf.compute_dtype == jopt.conf.compute_dtype
    names = [type(lyr).__name__ for lyr in opt.conf.layers]
    fold = kwargs.get("fold_bn", args[0] if args else True)
    prune = kwargs.get("prune", args[1] if len(args) > 1 else True)
    assert ("BatchNormalization" in names) != fold
    assert ("DropoutLayer" in names) != prune
    x = rng.normal(size=(4, 5)).astype(np.float32)
    tol = (dict(rtol=0, atol=2e-2) if opt.conf.compute_dtype == "bfloat16"
           else F32_TOL)
    np.testing.assert_allclose(opt.output(x), np.asarray(jopt.output(x)),
                               **tol)
    np.testing.assert_allclose(opt.output(x), net.output(x), **tol)


def test_dropout_layer_is_inverted_dropout_in_train_only():
    """The layer the prune removes: identity in eval mode; in training the
    same retain-probability mask as a dense layer's input dropout."""
    layer = DropoutLayer(dropout=0.6)
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    y, _ = layer.forward({}, {}, x)
    assert y is x
    got, _ = layer.forward({}, {}, x, train=True,
                           gen=torch.Generator().manual_seed(5))
    want = DenseLayer(n_out=1, dropout=0.6)._dropout_input(
        x, True, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    kept = got != 0
    assert 0.4 < kept.float().mean() < 0.8
    assert torch.allclose(got[kept], x[kept] / 0.6)


def test_a_quantized_artifact_passes_the_pass_untouched(alexnet):
    q = alexnet["q"]
    for bf16 in (False, True):
        out = iopt.optimize_for_inference(q, bf16=bf16)
        assert out is not q and out.conf == q.conf
        assert out.conf.compute_dtype is None
        for key, vp in q.params.items():
            for name, v in vp.items():
                assert torch.equal(out.params[key][name], v)
                assert out.params[key][name].data_ptr() != v.data_ptr()


def test_bf16_policy_serves_close_to_f32(alexnet):
    net = alexnet["net"]
    opt = iopt.optimize_for_inference(net, bf16=True)
    assert opt.conf.compute_dtype == "bfloat16"
    x = _images(2, seed=16)
    got = opt.output(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, net.output(x), rtol=0, atol=2e-2)


# --------------------------------------------------------------------------
# serving a quantized MultiLayerNetwork
# --------------------------------------------------------------------------

def test_engine_serves_the_quantized_network(alexnet):
    q = alexnet["q"]
    with InferenceEngine(q, BatchingConfig(max_batch=8)) as engine:
        assert engine.model.conf == q.conf  # graph_opt left it alone
        warm = engine.warmup()
        assert warm["buckets"] == [1, 2, 4, 8]
        assert warm["forwards"] == 8  # float32 and uint8 per bucket
        for n, seed in ((1, 20), (3, 21), (8, 22)):
            x = _images(n, seed)
            np.testing.assert_allclose(engine.predict(x), q.output(x),
                                       rtol=1e-5, atol=1e-7)
        u8 = _images(3, 23, uint8=True)
        np.testing.assert_allclose(engine.predict(u8), q.output(u8),
                                   rtol=1e-5, atol=1e-7)


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_serves_the_quantized_network_over_http(alexnet):
    q, jq = alexnet["q"], alexnet["jq"]
    server = InferenceServer(q, batching=BatchingConfig(
        max_batch=8, max_delay_ms=30.0, settle_ms=3.0))
    inputs = [_images(2, 30), _images(1, 31, uint8=True), _images(3, 32)]
    results = [None] * len(inputs)
    try:
        server.start(port=0, warmup=True)

        def client(i):
            results[i] = _http(server.port, "/predict",
                               {"inputs": [inputs[i].tolist()]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, (code, raw) in enumerate(results):
            assert code == 200, raw
            got = np.asarray(json.loads(raw)["outputs"][0], np.float32)
            np.testing.assert_allclose(got, q.output(inputs[i]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"request {i}")
            np.testing.assert_allclose(got, np.asarray(jq.output(inputs[i])),
                                       rtol=0, atol=Q_ATOL)
        code, raw = _http(server.port, "/model")
        info = json.loads(raw)
        assert code == 200 and info["type"] == "MultiLayerNetwork"
        assert info["num_params"] == q.num_params()
        code, raw = _http(server.port, "/healthz")
        assert code == 200 and json.loads(raw)["status"] == "ok"
        code, raw = _http(server.port, "/predict",
                          {"inputs": [_images(1, 33)[:, :50].tolist()]})
        assert code == 400
    finally:
        server.stop()
