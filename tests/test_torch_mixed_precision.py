"""The bf16 compute policy (``compute_dtype="bfloat16"``) in the port.

Contract (the JAX package's ``tests/test_mixed_precision.py``): forward
and backward run in bfloat16, while params, updater state, BN statistics,
the loss and every output stay float32. That file's cases are ported here
(its truncated-BPTT case waits for the recurrent layers), and the port is
held against the JAX package under the policy: a small CNN
``MultiLayerNetwork``, a 2-layer causal LM, and ResNet-50 at 32x32 with the
s2d stem and ``fused_conv_bn`` (both ``use_kernels`` routes) — the eval
output, the loss, and one Adam step.

Tolerances are stated in bf16 ulps, ``ULP = 2**-8`` (one rounding of a
float32 result to bfloat16 moves it by up to half of that). Both packages
round every layer's output to bf16 from a float32 accumulation, but not
always at the same places (the JAX package's softmax and layer norm run in
bf16 where torch's widen internally), so each layer may add a rounding the
other package does not. Each bf16 result of the port is therefore held
against a float32 step on the same weights, and may be at most so far from
it as the JAX package's bf16 result is (``FLOOR``):

- the loss: 1.5x as far, plus one ulp of the float32 loss;
- the softmax outputs: 2x as far (largest element), plus 4 ulps of the
  largest output;
- gradients (the Adam step's first moment ``m = 0.1 g``) and BN
  statistics: 1.5x as far by relative L2 over the whole tree plus 4 ulps,
  and 2x per tensor plus 4 ulps;
- the Adam updates: the whole tree only. Adam's first step moves each
  weight by about ``lr * sign(g)``, so one near-zero gradient element
  whose rounding takes the other sign moves a small tensor's update by
  O(1): per-tensor update errors are rounding luck.

A fixed bound cannot serve: in a random ResNet-50, train-mode BN amplifies
rounding. At 32x32 the last stage is one pixel, so its BN normalizes over
the batch alone: at batch 4 the JAX package's bf16 gradient lies 50-85%
from float32's per tensor, and the rule would pass a zeroed tensor; at
batch 16 it lies 15-35%, so the rule catches a zeroed (or sign-flipped)
gradient in every tensor, and a gradient 1.3x too large where the noise is
below about 14% (the head). ``test_the_bf16_rule_catches_a_wrong_gradient``
plants such faults in the port's result and holds that they fail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf import Activation, InputType
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
)
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.conf.updaters import Adam
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, serve_full_f32
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    opt_state_from_jax,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

ULP = 2.0 ** -8
FLOOR = {"loss": (1.5, ULP), "out": (2.0, 4 * ULP),
         "global": (1.5, 4 * ULP), "tensor": (2.0, 4 * ULP)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dtypes(tree):
    if isinstance(tree, dict):
        return {d for v in tree.values() for d in _dtypes(v)}
    return {tree.dtype}


def _assert_f32(net):
    for name in ("params", "state", "opt_state"):
        assert _dtypes(getattr(net, name)) <= {torch.float32}, name


def _rel_l2(a, b, skip=()):
    """(relative L2 distance of tree ``a`` from tree ``b``, per tensor)."""
    num = den = 0.0
    per = {}
    for k in b:
        for p in b[k]:
            x, y = a[k][p].double(), b[k][p].double()
            d2, y2 = float(((x - y) ** 2).sum()), float((y * y).sum())
            num, den = num + d2, den + y2
            if f"{k}.{p}" not in skip:
                per[f"{k}.{p}"] = (d2 / max(y2, 1e-300)) ** 0.5
    return (num / max(den, 1e-300)) ** 0.5, per


def _assert_floor(port, ref, f32, what, skip=(), per_tensor=True):
    """``port`` (the port's bf16 result) no further from ``f32`` than the
    FLOOR rule lets it be, given ``ref`` (the JAX package's bf16 result)."""
    gp, pp = _rel_l2(port, f32, skip)
    gr, pr = _rel_l2(ref, f32, skip)
    (ga, gb), (ta, tb) = FLOOR["global"], FLOOR["tensor"]
    assert gp <= ga * gr + gb, (what, gp, gr)
    for t in pp if per_tensor else ():
        assert pp[t] <= ta * pr[t] + tb, (what, t, pp[t], pr[t])


def _m(opt_state):
    return {k: {p: st["m"] for p, st in vp.items()}
            for k, vp in opt_state.items()}


def jax_like(jconf, net):
    """The JAX network for ``jconf`` holding the port network ``net``'s
    params and state, its updater afresh (``init`` without the eager
    random draws)."""
    jnet = (JGraph if hasattr(jconf, "vertices") else JMLN)(jconf)
    p, s = params_to_jax(net.conf, net.params, net.state)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, p)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, s)
    upd = (jnet._updater_for if hasattr(jconf, "vertices")
           else lambda k: jnet._updater_for(int(k)))
    jnet.opt_state = {k: {pk: upd(k).init_state(v) for pk, v in vp.items()}
                      for k, vp in jnet.params.items()}
    return jnet


# --- the JAX package's cases, on the port -----------------------------------

def _cnn_conf(compute_dtype=None):
    b = (NeuralNetConfiguration.builder().seed(7)
         .updater(Adam(learning_rate=1e-2)))
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    activation=Activation.RELU))
            .layer(BatchNormalization())
            .layer(DenseLayer(n_out=32, activation=Activation.RELU))
            .layer(OutputLayer(n_out=10, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())


def _jax_cnn_conf(compute_dtype=None):
    b = JNNC.builder().seed(7).updater(JAdam(learning_rate=1e-2))
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(JConv(n_out=8, kernel_size=(3, 3), activation=JAct.RELU))
            .layer(JBN())
            .layer(JDense(n_out=32, activation=JAct.RELU))
            .layer(JOut(n_out=10, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())


def _batch(n=16):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 8, 8, 1)).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])


def test_json_round_trip_preserves_compute_dtype():
    conf = _cnn_conf("bfloat16")
    conf2 = MultiLayerConfiguration.from_json(conf.to_json())
    assert conf2.compute_dtype == "bfloat16"
    assert _cnn_conf().compute_dtype is None
    assert conf.to_json() == _jax_cnn_conf("bfloat16").to_json()


def test_bf16_policy_trains_and_keeps_f32_masters():
    net = MultiLayerNetwork(_cnn_conf("bfloat16"), device="cpu").init()
    ds = DataSet(*_batch())
    l0 = net.fit_batch(ds)
    for _ in range(30):
        loss = net.fit_batch(ds)
    assert loss < l0 * 0.7
    _assert_f32(net)
    assert net.output(ds.features).dtype == np.float32


def test_bf16_policy_tracks_f32_training():
    """Same seed and data: the bf16 run follows the float32 run (the JAX
    package's bound: rel 0.25 after 10 steps)."""
    ds = DataSet(*_batch())
    losses = []
    for cd in (None, "bfloat16"):
        net = MultiLayerNetwork(_cnn_conf(cd), device="cpu").init()
        for _ in range(10):
            loss = net.fit_batch(ds)
        losses.append(loss)
    assert losses[1] == pytest.approx(losses[0], rel=0.25)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bf16_policy_computation_graph(use_kernels):
    cfg = ResNet50(num_classes=10, height=32, width=32,
                   updater=Adam(learning_rate=1e-3)).conf()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                              use_kernels=use_kernels)
    g = ComputationGraph(cfg, device="cpu").init()
    rng = np.random.default_rng(0)
    ds = DataSet(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)])
    l0 = g.fit_batch(ds)
    for _ in range(10):
        loss = g.fit_batch(ds)
    assert loss < l0
    _assert_f32(g)
    assert g.output(ds.features).dtype == np.float32


# --- the policy's surface ----------------------------------------------------

def test_every_entry_point_honours_the_policy():
    """fit, fit_batch, score, evaluate, compute_gradient_and_score and
    output, on both network classes: float32 results and masters."""
    x, y = _batch()
    ds = DataSet(x, y)
    mln = MultiLayerNetwork(_cnn_conf("bfloat16"), device="cpu").init()
    graph_conf = dataclasses.replace(
        ResNet50(num_classes=10, height=32, width=32).conf(),
        compute_dtype="bfloat16")
    graph = ComputationGraph(graph_conf, device="cpu").init()
    rng = np.random.default_rng(1)
    gds = DataSet(rng.random((4, 32, 32, 3)).astype(np.float32),
                  np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)])
    for net, d in ((mln, ds), (graph, gds)):
        net.fit(d)
        assert isinstance(net.fit_batch(d), float)
        assert isinstance(net.score(d), float)
        grads, score = net.compute_gradient_and_score(d)
        assert _dtypes(grads) == {torch.float32}
        assert np.isfinite(score)
        assert net.output(d.features).dtype == np.float32
        ev = net.evaluate(d)
        assert 0.0 <= ev.accuracy() <= 1.0
        _assert_f32(net)


def test_cast_params_are_not_cached_across_steps():
    """Training casts the float32 masters anew each step; only the eval
    forward caches its cast, and an update drops it."""
    net = MultiLayerNetwork(_cnn_conf("bfloat16"), device="cpu").init()
    x, y = _batch()
    before = net.output(x)
    cached = net._cast_params
    assert cached is not None
    assert cached["0"]["W"].dtype == torch.bfloat16
    last = str(len(net.conf.layers) - 1)  # the output layer
    assert cached[last]["W"].dtype == torch.float32
    net.fit_batch(DataSet(x, y))
    assert net._cast_params is None
    after = net.output(x)
    assert not np.array_equal(before, after)
    torch.testing.assert_close(net._cast_params["0"]["W"],
                               net.params["0"]["W"].to(torch.bfloat16))


def test_serve_full_f32_keeps_bf16_reductions_in_float32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction)
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = True
        serve_full_f32()
        assert not (torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul
         .allow_bf16_reduced_precision_reduction) = flags


# --- against the JAX package -----------------------------------------------

def _step_both(jconf, pconf, x, y, make_ds):
    """One Adam step of the JAX network and of the port networks (bf16,
    and the float32 reference), from the same weights: returns the
    results of each."""
    pnet = (ComputationGraph if hasattr(pconf, "vertices")
            else MultiLayerNetwork)(pconf, device="cpu").init()
    if hasattr(pconf, "vertices") and "res2a_c_cb" in pnet.params:
        for k, p in pnet.params.items():
            if k.endswith("_c_cb"):
                p["gamma"].fill_(0.1)
    jnet = jax_like(jconf, pnet)
    out = {"jax": {"out": np.asarray(jnet.output(x))}}
    out["jax"]["loss"] = float(jnet.fit_batch(JDataSet(x, y)))
    out["jax"]["params"], out["jax"]["state"] = params_from_jax(
        pconf, _np(jnet.params), _np(jnet.state))
    out["jax"]["m"] = _m(opt_state_from_jax(pconf, _np(jnet.opt_state)))
    out["before"] = {k: {p: v.clone() for p, v in vp.items()}
                     for k, vp in pnet.params.items()}
    routes = {"f32": dataclasses.replace(pconf, compute_dtype=None)}
    routes["bf16"] = pconf
    if hasattr(pconf, "vertices"):
        routes["bf16_kernels"] = dataclasses.replace(pconf, use_kernels=True)
    for name, c in routes.items():
        net = type(pnet)(c, device="cpu").set_params(pnet.params, pnet.state)
        res = {"out": net.output(x)}
        res["loss"] = net.fit_batch(make_ds(x, y))
        res["params"], res["state"] = net.params, net.state
        res["m"] = _m(net.opt_state)
        if name != "f32":
            _assert_f32(net)
            assert res["out"].dtype == np.float32
        out[name] = res
    return out


def _check_against_jax(r, skip=()):
    f32, ref = r["f32"], r["jax"]
    la, lb = FLOOR["loss"]
    oa, ob = FLOOR["out"]
    for name in ("bf16", "bf16_kernels"):
        if name not in r:
            continue
        got = r[name]
        assert abs(got["loss"] - f32["loss"]) <= (
            la * abs(ref["loss"] - f32["loss"]) + lb * abs(f32["loss"])), (
            name, got["loss"], ref["loss"], f32["loss"])
        scale = np.abs(f32["out"]).max()
        assert np.abs(got["out"] - f32["out"]).max() <= (
            oa * np.abs(ref["out"] - f32["out"]).max() + ob * scale), name
        _assert_floor(got["m"], ref["m"], f32["m"], (name, "m"), skip)
        upd, jupd, fupd = ({k: {p: res["params"][k][p] - r["before"][k][p]
                                for p in vp}
                            for k, vp in r["before"].items()}
                           for res in (got, ref, f32))
        _assert_floor(upd, jupd, fupd, (name, "update"), skip,
                      per_tensor=False)
        if f32["state"]:
            _assert_floor(got["state"], ref["state"], f32["state"],
                          (name, "state"))


def test_cnn_mln_bf16_step_matches_jax():
    x, y = _batch()
    r = _step_both(_jax_cnn_conf("bfloat16"), _cnn_conf("bfloat16"), x, y,
                   DataSet)
    # the conv bias feeds BN, which removes each channel's mean: its
    # gradient is 0 in exact arithmetic, rounding noise in both packages
    _check_against_jax(r, skip=("0.b",))
    # this network rounds at the same places in both packages
    assert r["bf16"]["loss"] == pytest.approx(r["jax"]["loss"], rel=ULP)


def test_lm_bf16_step_matches_jax():
    zoo = JTransformer(vocab_size=64, embed_dim=32, n_heads=2, n_layers=2,
                       max_len=16, causal=True, lm_head=True)
    jconf = dataclasses.replace(zoo.conf(), compute_dtype="bfloat16")
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (4, 17))
    x = ids[:, :16].astype(np.float32)
    y = np.eye(64, dtype=np.float32)[ids[:, 1:]]
    r = _step_both(jconf, pconf, x, y, DataSet)
    # a key bias adds the same q . bk to a row's scores, which softmax
    # ignores: its gradient is 0 in exact arithmetic
    _check_against_jax(r, skip=tuple(f"b{i}_attn.bk" for i in range(2)))


@pytest.fixture(scope="module")
def resnet_step():
    """ResNet-50 at 32x32 (s2d stem, ``fused_conv_bn``), batch 16: one Adam
    step of the JAX network and of the port's routes (:func:`_step_both`)."""
    zoo = JResNet50(num_classes=10, height=32, width=32,
                    updater=JAdam(learning_rate=1e-3))
    zoo.stem_space_to_depth = True
    zoo.fused_conv_bn = True
    jconf = dataclasses.replace(zoo.conf(), compute_dtype="bfloat16")
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    rng = np.random.default_rng(0)
    x = rng.random((16, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    return _step_both(jconf, pconf, x, y, DataSet)


def test_resnet50_s2d_fused_bf16_step_matches_jax(resnet_step):
    _check_against_jax(resnet_step)


def _with_m(r, name, scale):
    """``r`` with the port's bf16 first moment of tensor ``name``
    (``key.param``) multiplied by ``scale``."""
    k, p = name.split(".")
    m = {kk: dict(vp) for kk, vp in r["bf16"]["m"].items()}
    m[k][p] = m[k][p] * scale
    return {**r, "bf16": {**r["bf16"], "m": m}}


def test_the_bf16_rule_catches_a_wrong_gradient(resnet_step):
    """Faults planted in the port's bf16 gradient fail the check: the
    noisiest tensor's gradient zeroed, and the head's 1.3x too large. Every
    tensor's noise (the JAX package's distance from float32) leaves room
    to catch a zeroed gradient."""
    r = resnet_step
    _, noise = _rel_l2(r["jax"]["m"], r["f32"]["m"])
    ta, tb = FLOOR["tensor"]
    assert all(1.0 > ta * v + tb for v in noise.values()), max(
        noise.values())
    for name, scale in ((max(noise, key=noise.get), 0.0),
                        ("output.W", 1.3)):
        with pytest.raises(AssertionError):
            _check_against_jax(_with_m(r, name, scale))


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_fused_conv_bn_bf16_statistics_are_float32(stride):
    """FusedConvBN1x1 in train mode under bf16: y is bf16, the statistics
    are formed in float32 from the float32 column sums (the kernel's plain
    version) or from float32 widenings of y (the stock path), never from a
    bf16 mean; both match the JAX layer's running statistics (float32 sums
    of the same bf16 y: 1e-6 relative) and its output (one bf16 ulp)."""
    from deeplearning4j_tpu.conf.layers_cnn import FusedConvBN1x1 as JFused
    from deeplearning4j_tpu_torch.conf.layers_cnn import FusedConvBN1x1

    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 1.0, size=(8, 4, 4, 16)).astype(np.float32)
    w = rng.normal(size=(1, 1, 16, 32)).astype(np.float32) / 4.0
    gamma = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    beta = rng.normal(size=32).astype(np.float32)
    state = {"mean": np.zeros(32, np.float32), "var": np.ones(32, np.float32)}
    jl = JFused(n_out=32, stride=stride, activation=JAct.RELU)
    jp = {"W": jnp.asarray(w, jnp.bfloat16),
          "gamma": jnp.asarray(gamma, jnp.bfloat16),
          "beta": jnp.asarray(beta, jnp.bfloat16)}
    jy, js = jl.forward(jp, jax.tree_util.tree_map(jnp.asarray, state),
                        jnp.asarray(x, jnp.bfloat16), train=True)
    pl = FusedConvBN1x1(n_out=32, stride=stride, activation=Activation.RELU)
    pp = {k: v.to(torch.bfloat16) for k, v in convert_layer_params(
        pl, {"W": w, "gamma": gamma, "beta": beta}).items()}
    ps = {k: torch.from_numpy(v) for k, v in state.items()}
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    for y, s in (pl.forward(pp, ps, xb, train=True),
                 pl.forward_kernel(pp, ps, xb)):
        assert y.dtype == torch.bfloat16
        assert s["mean"].dtype == s["var"].dtype == torch.float32
        for k in ("mean", "var"):
            np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7)
        want = np.asarray(jy.astype(jnp.float32))
        got = y.float().permute(0, 2, 3, 1).numpy()
        assert np.all(np.abs(got - want) <= ULP * np.abs(want) + 1e-6)
