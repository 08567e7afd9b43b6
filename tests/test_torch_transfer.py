"""Pretrained weights and transfer learning in the port against the JAX
package: ``zoo.pretrained`` (publish, checksums, fetch, ``restore_partial``
with the space-to-depth stem remap) and ``nn.transferlearning``
(``TransferLearning.Builder``, ``FrozenLayer``, ``TransferLearningHelper``).

Networks: the JAX tests' three-layer MLP (4 -> 8 tanh -> 6 relu -> 3),
LeNet at 8x8, a small 7x7-stem graph and its space-to-depth twin, and the
port's ResNet-50 at 32x32; the port's networks start from the JAX
network's params (``params_from_jax``), a layer the builders draw afresh
takes the JAX draw.

Tolerances: params copied by a builder or a zip bit for bit; per-step
losses and the params after SGD steps rtol 1e-5 (atol 1e-7: float32
forwards and backwards summed in other orders than XLA's), after Adam
steps with an absolute floor of 1% of the rate (Adam's first steps move a
weight by about the rate times the sign of its gradient, so a near-zero
gradient rounded the other way moves it by up to twice that); featurized
activations rtol 1e-5, atol 1e-6; the space-to-depth stem against the 7x7
stem 1e-5 relative L2 (the same sums regrouped).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import (
    BatchNormalization as JBN,
)
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu.zoo import pretrained as jzp
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.conf.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.conf.weights import WeightInit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.kernels import routing
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration,
    FrozenLayer,
    TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.util import serializer
from deeplearning4j_tpu_torch.util.convert import params_from_jax, params_to_jax
from deeplearning4j_tpu_torch.zoo import (
    AlexNet,
    LeNet,
    PretrainedType,
    ResNet50,
    restore_partial,
    save_pretrained,
)
from deeplearning4j_tpu_torch.zoo import pretrained as zp

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL, ATOL = 1e-5, 1e-7
ADAM_ATOL = 1e-2 * 1e-2  # 1% of Adam's rate
FEAT_RTOL, FEAT_ATOL = 1e-5, 1e-6
S2D_REL_L2 = 1e-5


@pytest.fixture(autouse=True)
def _cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_HOME", str(tmp_path))
    yield tmp_path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jconf(n_in=4, classes=3, updater=None):
    return (JNNC.builder().seed(12345)
            .updater(updater or JAdam(1e-2))
            .list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JDense(n_out=6, activation=JAct.RELU))
            .layer(JOut(n_out=classes, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(n_in))
            .build())


def _xy(n=48, n_in=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _port_of(jnet, conf=None):
    """The port network on the JAX network's params and state (``conf``:
    the port's own configuration instead of the JAX one's JSON)."""
    conf = conf or MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _jax_params(net):
    return params_to_jax(net.conf, net.params, net.state)[0]


def _assert_params(net, jnet, exact=False, what="", atol=ATOL):
    got = _jax_params(net)
    for k, vp in _np(jnet.params).items():
        for pk, v in vp.items():
            if exact:
                np.testing.assert_array_equal(got[k][pk], v,
                                              err_msg=f"{what} {k}.{pk}")
            else:
                np.testing.assert_allclose(got[k][pk], v, rtol=RTOL,
                                           atol=atol,
                                           err_msg=f"{what} {k}.{pk}")


def _conf_dict(conf):
    return json.loads(conf.to_json())


def _fit_both(net, jnet, x, y, steps):
    losses = [(net.fit_batch(DataSet(x, y)), jnet.fit_batch(JDataSet(x, y)))
              for _ in range(steps)]
    for a, b in losses:
        assert a == pytest.approx(b, rel=RTOL, abs=ATOL)
    return losses


# --------------------------------------------------------------------------
# transfer learning
# --------------------------------------------------------------------------

def test_frozen_layers_do_not_move_and_match_jax():
    x, y = _xy()
    jbase = JMLN(_jconf()).init()
    jbase.fit_batch(JDataSet(x, y))
    base = _port_of(jbase)
    base_flat = base.params_flat().copy()
    jt = (jtl.TransferLearning.Builder(jbase)
          .fine_tune_configuration(jtl.FineTuneConfiguration(
              updater=JSgd(0.1)))
          .set_feature_extractor(1).build())
    t = (TransferLearning.Builder(base)
         .fine_tune_configuration(FineTuneConfiguration(updater=Sgd(0.1)))
         .set_feature_extractor(1).build())
    assert isinstance(t.conf.layers[0], FrozenLayer)
    assert isinstance(t.conf.layers[1], FrozenLayer)
    assert _conf_dict(t.conf) == _conf_dict(jt.conf)
    _assert_params(t, jt, exact=True, what="built")
    frozen = {k: {p: v.clone() for p, v in t.params[k].items()}
              for k in ("0", "1")}
    head = t.params["2"]["W"].clone()
    _fit_both(t, jt, x, y, 5)
    for k in frozen:
        for p, v in frozen[k].items():
            assert torch.equal(t.params[k][p], v), f"{k}.{p} moved"
    assert not torch.allclose(t.params["2"]["W"], head)
    _assert_params(t, jt, what="after 5 steps")
    # the builder copied: training the transferred net leaves the base
    assert np.array_equal(base.params_flat(), base_flat)


def test_transfer_replace_output_matches_jax():
    jbase = JMLN(_jconf(classes=3)).init()
    base = _port_of(jbase)
    w0 = base.params["0"]["W"].clone()
    jt = (jtl.TransferLearning.Builder(jbase).set_feature_extractor(0)
          .remove_output_layer()
          .add_layer(JOut(n_out=5, activation=JAct.SOFTMAX,
                          loss_fn=JMCXENT(), updater=JSgd(0.1)))
          .build())
    t = (TransferLearning.Builder(base).set_feature_extractor(0)
         .remove_output_layer()
         .add_layer(OutputLayer(n_out=5, activation=Activation.SOFTMAX,
                                loss_fn=LossMCXENT(), updater=Sgd(0.1)))
         .build())
    assert torch.equal(t.params["0"]["W"], w0)
    assert _conf_dict(t.conf) == _conf_dict(jt.conf)
    # the new head is each package's own draw: take the JAX one
    t = _port_of(jt, conf=t.conf)
    x, y = _xy(classes=5)
    losses = _fit_both(t, jt, x, y, 11)
    assert losses[-1][0] < losses[0][0]
    # layer 1 trains with the base's Adam(1e-2)
    _assert_params(t, jt, what="after 11 steps", atol=ADAM_ATOL)
    out = t.output(x)
    assert out.shape == (48, 5)
    np.testing.assert_allclose(out, np.asarray(jt.output(x)), rtol=RTOL,
                               atol=1e-6)


def test_n_out_replace_reinits_next_layer():
    jbase = JMLN(_jconf()).init()
    base = _port_of(jbase)
    t = (TransferLearning.Builder(base)
         .n_out_replace(1, 12, WeightInit.XAVIER).build())
    jt = (jtl.TransferLearning.Builder(jbase)
          .n_out_replace(1, 12, JWI.XAVIER).build())
    # the port's dense layout is [nOut, nIn]
    assert tuple(t.params["1"]["W"].shape) == (12, 8)
    assert tuple(t.params["2"]["W"].shape) == (3, 12)
    assert _jax_params(t)["1"]["W"].shape == jt.params["1"]["W"].shape
    assert torch.equal(t.params["0"]["W"], base.params["0"]["W"])
    assert _conf_dict(t.conf) == _conf_dict(jt.conf)


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_helper_featurize_and_fit_match_jax(model):
    if model == "mlp":
        jbase = JMLN(_jconf()).init()
        split, (x, y) = 0, _xy()
    else:
        jbase = JLeNet(num_classes=3, height=8, width=8).init()
        split = 4
        rng = np.random.default_rng(1)
        x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jt = (jtl.TransferLearning.Builder(jbase)
          .fine_tune_configuration(jtl.FineTuneConfiguration(
              updater=JSgd(0.05)))
          .set_feature_extractor(split).build())
    t = _port_of(jt)
    jh, h = jtl.TransferLearningHelper(jt), TransferLearningHelper(t)
    feat, jfeat = h.featurize(DataSet(x, y)), jh.featurize(JDataSet(x, y))
    assert tuple(feat.features.shape) == np.asarray(jfeat.features).shape
    np.testing.assert_allclose(feat.features.numpy(),
                               np.asarray(jfeat.features), rtol=FEAT_RTOL,
                               atol=FEAT_ATOL)
    scores = []
    for _ in range(5):
        h.fit_featurized(feat)
        jh.fit_featurized(jfeat)
        scores.append(h.unfrozen_mln().score())
        assert scores[-1] == pytest.approx(
            float(jh.unfrozen_mln().score_value), rel=RTOL, abs=ATOL)
    assert scores[-1] <= scores[0]
    # the tail's training reached the full network, and only its tail
    _assert_params(t, jt, what="after fit_featurized")
    full, tail = t.output(x), h.output_from_featurized(feat.features)
    np.testing.assert_allclose(full, tail, atol=1e-5)


def test_frozen_prefix_builds_no_autograd_graph():
    jbase = JMLN(_jconf()).init()
    t = (TransferLearning.Builder(_port_of(jbase))
         .set_feature_extractor(1).build())
    x, y = _xy()
    leaves = {k: {p: v.detach().requires_grad_() for p, v in vp.items()}
              for k, vp in t.params.items()}
    h, _ = t._run(leaves, t.state, t._prepare(x), train=True, upto=2)
    assert not h.requires_grad and h.grad_fn is None
    grads, _ = t.compute_gradient_and_score(DataSet(x, y))
    for k in ("0", "1"):  # frozen buckets read 0
        assert all(float(g.abs().sum()) == 0.0 for g in grads[k].values())
    assert float(grads["2"]["W"].abs().sum()) > 0


def test_transferred_net_zips_cross_package(tmp_path):
    jbase = JMLN(_jconf()).init()
    t = (TransferLearning.Builder(_port_of(jbase))
         .set_feature_extractor(0).build())
    p = tmp_path / "port.zip"
    serializer.write_model(t, p)
    j = jser.restore_multi_layer_network(str(p))
    assert type(j.conf.layers[0]).__name__ == "FrozenLayer"
    np.testing.assert_array_equal(np.asarray(j.params_flat()),
                                  t.params_flat())
    jt = (jtl.TransferLearning.Builder(jbase).set_feature_extractor(0)
          .build())
    q = tmp_path / "jax.zip"
    jser.write_model(jt, str(q))
    back = serializer.restore_multi_layer_network(q, device="cpu")
    assert isinstance(back.conf.layers[0], FrozenLayer)
    np.testing.assert_array_equal(back.params_flat(),
                                  np.asarray(jt.params_flat()))


def test_build_keeps_dtype_policy_and_kernels():
    """The JAX builder drops these fields (a reference defect); the port
    keeps them: its configuration is the JAX one with them restored."""
    fields = dict(use_kernels=True, compute_dtype="bfloat16",
                  gradient_checkpointing=True)
    jbase = JMLN(dataclasses.replace(_jconf(), **fields)).init()
    base = _port_of(jbase)
    assert base.conf.use_kernels and base.conf.compute_dtype == "bfloat16"
    t = TransferLearning.Builder(base).set_feature_extractor(0).build()
    jt = jtl.TransferLearning.Builder(jbase).set_feature_extractor(0).build()
    assert not jt.conf.use_kernels and jt.conf.compute_dtype is None
    for k, v in fields.items():
        assert getattr(t.conf, k) == v
    assert _conf_dict(t.conf) == _conf_dict(
        dataclasses.replace(jt.conf, **fields))
    # kernel routing sees the unfrozen dense layer only
    assert [s for s, _, _ in routing.routed_sites(t.conf, 8, mode="cpu")] \
        == ["1"]


def test_build_copies_layer_state():
    """The retained layers' state (BN running statistics) comes along
    with their params (the JAX builder re-initializes it)."""
    conf = (JNNC.builder().seed(3).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=8, activation=JAct.RELU))
            .layer(JBN())
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())
    base = _port_of(JMLN(conf).init())
    x, y = _xy()
    for _ in range(3):
        base.fit_batch(DataSet(x, y))
    t = TransferLearning.Builder(base).set_feature_extractor(1).build()
    for name, v in base.state["1"].items():
        assert torch.equal(t.state["1"][name], v), name
    np.testing.assert_array_equal(t.output(x), base.output(x))


def test_alexnet_fine_tune_routes_fc6_fc7_only():
    """The fine-tune configuration of the card's phase: AlexNet frozen
    through its last pooling layer, a 10-class head, row 1 at fc6 and fc7
    only (the frozen convs run stock)."""
    net = AlexNet().init("cpu")
    net.conf = dataclasses.replace(net.conf, use_kernels=True)
    t = (TransferLearning.Builder(net)
         .fine_tune_configuration(FineTuneConfiguration(
             updater=Adam(1e-4), dropout=0.0, seed=33))
         .set_feature_extractor(9).remove_output_layer()
         .add_layer(OutputLayer(n_out=10, activation=Activation.SOFTMAX,
                                loss_fn=LossMCXENT()))
         .build())
    assert all(isinstance(layer, FrozenLayer) for layer in t.conf.layers[:10])
    assert t.conf.use_kernels
    sites = routing.routed_sites(t.conf, 32, mode="cuda")
    assert [(s, e.m, e.k, e.n, e.act) for s, _, e in sites] == [
        ("11", 32, 6400, 4096, "relu"), ("12", 32, 4096, 4096, "relu")]
    assert t.num_params() == 46_787_978
    assert all(t.conf.layers[i].dropout == 0.0 for i in (11, 12, 13))


# --------------------------------------------------------------------------
# pretrained weights
# --------------------------------------------------------------------------

def _lenet_batch(classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 8, 8, 1)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, 4)])


def test_init_pretrained_round_trip_lenet_both_ways():
    model = LeNet(num_classes=10, height=8, width=8)
    net = model.init("cpu")
    x, y = _lenet_batch()
    net.fit_batch(DataSet(x, y))  # non-trivial weights
    save_pretrained(net, model.model_name, PretrainedType.MNIST)
    assert model.pretrained_available(PretrainedType.MNIST)
    assert not model.pretrained_available(PretrainedType.VGGFACE)
    restored = model.init_pretrained(PretrainedType.MNIST, device="cpu")
    np.testing.assert_array_equal(restored.params_flat(), net.params_flat())
    assert restored.output(x).shape == (4, 10)
    # the JAX package loads the port's artifact, and the port the JAX's
    jmodel = JLeNet(num_classes=10, height=8, width=8)
    jnet = jmodel.init_pretrained(jzp.PretrainedType.MNIST)
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()),
                                  net.params_flat())
    jnet.fit_batch(JDataSet(x, y))
    jzp.save_pretrained(jnet, jmodel.model_name, jzp.PretrainedType.MNIST)
    back = model.init_pretrained(PretrainedType.MNIST, device="cpu")
    np.testing.assert_array_equal(back.params_flat(),
                                  np.asarray(jnet.params_flat()))


def test_init_pretrained_round_trip_resnet50_graph():
    model = ResNet50(num_classes=5, height=32, width=32)
    net = model.init("cpu")
    save_pretrained(net, model.model_name, PretrainedType.IMAGENET)
    restored = model.init_pretrained(PretrainedType.IMAGENET, device="cpu")
    np.testing.assert_array_equal(restored.params_flat(), net.params_flat())


def test_checksum_corruption_detected():
    model = LeNet(num_classes=10, height=8, width=8)
    save_pretrained(model.init("cpu"), model.model_name,
                    PretrainedType.MNIST)
    path = zp.artifact_path(model.model_name, PretrainedType.MNIST)
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum mismatch"):
        model.init_pretrained(PretrainedType.MNIST, device="cpu")
    # the JAX package refuses the same bytes
    with pytest.raises(IOError, match="checksum mismatch"):
        JLeNet(num_classes=10, height=8, width=8).init_pretrained(
            jzp.PretrainedType.MNIST)


def test_pinned_class_checksum_enforced():
    model = LeNet(num_classes=10, height=8, width=8)
    path = save_pretrained(model.init("cpu"), model.model_name,
                           PretrainedType.MNIST)
    model.PRETRAINED_CHECKSUMS = {PretrainedType.MNIST: "0" * 64}
    with pytest.raises(IOError, match="pins"):
        model.init_pretrained(PretrainedType.MNIST, device="cpu")
    model.PRETRAINED_CHECKSUMS = {PretrainedType.MNIST: zp.sha256_of(path)}
    assert model.init_pretrained(PretrainedType.MNIST,
                                 device="cpu").num_params() > 0


def test_unavailable_type_raises():
    model = LeNet(num_classes=10, height=8, width=8)
    with pytest.raises(ValueError, match="no pretrained weights"):
        model.init_pretrained(PretrainedType.VGGFACE, device="cpu")


def test_missing_cache_and_url_message():
    model = LeNet(num_classes=10, height=8, width=8)
    model.PRETRAINED_URLS = {PretrainedType.MNIST: ""}  # available, no URL
    with pytest.raises(FileNotFoundError, match="save_pretrained"):
        model.init_pretrained(PretrainedType.MNIST, device="cpu")


def test_fetch_from_a_file_url(tmp_path):
    """The fetch branch on a local ``file://`` URL: the artifact lands in
    the cache with its sidecar; with no pinned checksum a warning says the
    download is trusted on first use."""
    model = LeNet(num_classes=10, height=8, width=8)
    net = model.init("cpu")
    src = tmp_path / "mirror" / "lenet.zip"
    serializer.write_model(net, src, save_updater=False)
    model.PRETRAINED_URLS = {PretrainedType.MNIST: src.as_uri()}
    with pytest.warns(UserWarning, match="trusted on first use"):
        got = model.init_pretrained(PretrainedType.MNIST, device="cpu")
    np.testing.assert_array_equal(got.params_flat(), net.params_flat())
    path = zp.artifact_path(model.model_name, PretrainedType.MNIST)
    assert path.with_suffix(".zip.sha256").read_text().strip() == \
        zp.sha256_of(src)
    model.PRETRAINED_URLS = {PretrainedType.MNIST: (tmp_path / "gone.zip")
                             .as_uri()}
    path.unlink()
    with pytest.raises(IOError, match="could not fetch"):
        model.init_pretrained(PretrainedType.MNIST, device="cpu")
    assert not path.with_suffix(".zip.part").exists()


def test_restore_partial_feeds_transfer_learning():
    """The workflow: a pretrained backbone, a new head, a fine-tune; the
    key lists are the JAX function's."""
    donor_model = LeNet(num_classes=10, height=8, width=8)
    donor = donor_model.init("cpu")
    path = save_pretrained(donor, donor_model.model_name,
                           PretrainedType.MNIST)
    target = LeNet(num_classes=3, height=8, width=8).init("cpu")
    loaded, skipped = restore_partial(path, target)
    jtarget = JLeNet(num_classes=3, height=8, width=8).init()
    jloaded, jskipped = jzp.restore_partial(path, jtarget)
    assert (loaded, skipped) == (jloaded, jskipped)
    assert skipped == ["6/W", "6/b"]
    assert torch.equal(target.params["0"]["W"], donor.params["0"]["W"])
    tuned = TransferLearning.Builder(target).set_feature_extractor(5).build()
    before = tuned.params["0"]["W"].clone()
    x, y = _lenet_batch(classes=3)
    tuned.fit_batch(DataSet(x, y))
    assert torch.equal(tuned.params["0"]["W"], before)


def _stem_graphs(s2d: bool, classes: int):
    """A 7x7/2 stem conv + BN + max pool + dense head over 16x16x3, or
    its space-to-depth twin (the vertex names of ResNet-50's stem), in
    both packages."""
    from deeplearning4j_tpu.conf import layers_cnn as jcnn
    from deeplearning4j_tpu.conf.graph import LayerVertex as JLV
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.conf import layers_cnn as cnn
    from deeplearning4j_tpu_torch.conf.graph import LayerVertex
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def build(m, nnc, it, lv, dense, out, mcxent):
        g = (nnc.builder().seed(5).updater(m["sgd"](0.1)).graph_builder()
             .add_inputs("input")
             .set_input_types(it.convolutional(16, 16, 3)))
        if s2d:
            g.add_vertex("stem_s2d", lv(layer=m["s2d"](block_size=2)),
                         "input")
            g.add_vertex("stem_pad", lv(layer=m["pad"](padding=(1, 2, 1, 2))),
                         "stem_s2d")
            g.add_layer("stem_conv", m["conv"](
                n_out=8, kernel_size=(4, 4), stride=(1, 1),
                convolution_mode=m["mode"].TRUNCATE), "stem_pad")
        else:
            g.add_layer("stem_conv", m["conv"](
                n_out=8, kernel_size=(7, 7), stride=(2, 2),
                convolution_mode=m["mode"].SAME), "input")
        g.add_layer("stem_bn", m["bn"](), "stem_conv")
        g.add_layer("stem_pool", m["pool"](
            pooling_type=m["pt"].MAX, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=m["mode"].SAME), "stem_bn")
        g.add_layer("fc", dense(n_out=6, activation=m["relu"]), "stem_pool")
        g.add_layer("output", out(n_out=classes, activation=m["softmax"],
                                  loss_fn=mcxent()), "fc")
        return g.set_outputs("output").build()

    jm = dict(sgd=JSgd, s2d=jcnn.SpaceToDepthLayer, pad=jcnn.ZeroPaddingLayer,
              conv=jcnn.ConvolutionLayer, mode=jcnn.ConvolutionMode,
              bn=jcnn.BatchNormalization, pool=jcnn.SubsamplingLayer,
              pt=jcnn.PoolingType, relu=JAct.RELU, softmax=JAct.SOFTMAX)
    pm = dict(sgd=Sgd, s2d=cnn.SpaceToDepthLayer, pad=cnn.ZeroPaddingLayer,
              conv=cnn.ConvolutionLayer, mode=cnn.ConvolutionMode,
              bn=cnn.BatchNormalization, pool=cnn.SubsamplingLayer,
              pt=cnn.PoolingType, relu=Activation.RELU,
              softmax=Activation.SOFTMAX)
    jconf = build(jm, JNNC, JIT, JLV, JDense, JOut, JMCXENT)
    pconf = build(pm, NeuralNetConfiguration, InputType, LayerVertex,
                  DenseLayer, OutputLayer, LossMCXENT)
    return JCG(jconf).init(), ComputationGraph(pconf, "cpu").init()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_restore_partial_remaps_a_7x7_stem_like_jax(tmp_path):
    _, donor = _stem_graphs(s2d=False, classes=10)
    path = tmp_path / "stem7.zip"
    serializer.write_model(donor, path)
    jtarget, target = _stem_graphs(s2d=True, classes=4)
    loaded, skipped = restore_partial(path, target)
    jloaded, jskipped = jzp.restore_partial(str(path), jtarget)
    assert (loaded, skipped) == (jloaded, jskipped)
    assert "stem_conv/W" in loaded
    assert skipped == ["output/W", "output/b"]
    got = params_to_jax(target.conf, target.params, target.state)[0]
    np.testing.assert_array_equal(got["stem_conv"]["W"],
                                  np.asarray(jtarget.params["stem_conv"]["W"]))
    # the rewrite is exact: the stems' pooled activations agree
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    a, b = target.feed_forward(x), donor.feed_forward(x)
    assert _rel_l2(a["stem_pool"], b["stem_pool"]) < S2D_REL_L2


def test_restore_partial_resnet50_s2d_stem_skips_only_the_head(tmp_path):
    donor = ResNet50(num_classes=10, height=32, width=32).init("cpu")
    path = tmp_path / "resnet7.zip"
    serializer.write_model(donor, path)
    model = ResNet50(num_classes=5, height=32, width=32)
    model.stem_space_to_depth = True
    target = model.init("cpu")
    loaded, skipped = restore_partial(path, target)
    assert skipped == ["output/W", "output/b"]
    assert "stem_conv/W" in loaded
    assert len(loaded) == sum(len(v) for v in donor.params.values()) - 2 \
        + sum(len(v) for v in donor.state.values())
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    assert _rel_l2(target.feed_forward(x)["avgpool"],
                   donor.feed_forward(x)["avgpool"]) < S2D_REL_L2


def test_artifact_paths_follow_dl4j_tpu_home(tmp_path):
    assert zp.base_directory() == tmp_path
    assert zp.artifact_path("AlexNet", PretrainedType.IMAGENET) == \
        tmp_path / "models" / "AlexNet_imagenet.zip"
    assert str(zp.artifact_path("LeNet", PretrainedType.MNIST)) == str(
        jzp.artifact_path("LeNet", jzp.PretrainedType.MNIST))
    assert not os.path.exists(tmp_path / "models")
