"""The rest of the graph DSL in the port against the JAX package.

Each vertex (``MergeVertex``, ``SubsetVertex``, ``ScaleVertex``,
``ShiftVertex``, ``L2NormalizeVertex``, ``StackVertex``,
``UnstackVertex``, ``ReshapeVertex``, ``PreprocessorVertex``,
``AttentionVertex``) and the layers ``EmbeddingLayer`` and ``LossLayer``:
forward and output type against the JAX class on the same inputs (images
cross as the JAX package's NHWC arrays and the port's logical NCHW
tensors), feature-mask propagation past each vertex, and JSON that
round-trips between the packages for every new class, with
``GraphBuilder.backprop_type`` (a graph configured for truncated BPTT
round-trips; the port's ``fit`` refuses it until the recurrent layers are
ported). ``AttentionVertex`` is held against the JAX vertex with and
without a key mask (the JAX package's
``tests/test_attention_layers.py::test_attention_vertex_forward_and_mask``),
inside a graph against the JAX graph, and on the kernel route (the flash
kernel's plain version on the CPU) against the stock route.

Tolerances: moves and concatenations exactly; arithmetic at float32
rounding (rtol 1e-5, atol 1e-6); attention through other summation orders
at rtol 1e-5, atol 1e-6 (softmax over at most 6 keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import graph as jgraph
from deeplearning4j_tpu.conf import inputs as jit_
from deeplearning4j_tpu.conf import layers as jlayers
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBackprop
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import io as jio
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import Activation, InputType
from deeplearning4j_tpu_torch.conf import graph as pgraph
from deeplearning4j_tpu_torch.conf import layers as players
from deeplearning4j_tpu_torch.conf.graph import (
    AttentionVertex,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT, LossMSE
from deeplearning4j_tpu_torch.conf.multilayer import (
    BackpropType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import io as pio
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    params_from_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL, ATOL = 1e-5, 1e-6
RNG = np.random.default_rng(7)

FF = (InputType.feed_forward(7), jit_.InputType.feed_forward(7), (3, 7))
RNN = (InputType.recurrent(5, timesteps=4),
       jit_.InputType.recurrent(5, timesteps=4), (3, 4, 5))
CNN = (InputType.convolutional(4, 3, 6),
       jit_.InputType.convolutional(4, 3, 6), (2, 4, 3, 6))


def _port_in(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def _port_out(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


# (vertex name, kwargs, [input kind per input])
VERTICES = [
    ("MergeVertex", {}, [FF, FF]),
    ("MergeVertex", {}, [RNN, RNN, RNN]),
    ("MergeVertex", {}, [CNN, CNN]),
    ("SubsetVertex", dict(from_idx=1, to_idx=4), [FF]),
    ("SubsetVertex", dict(from_idx=0, to_idx=2), [RNN]),
    ("SubsetVertex", dict(from_idx=2, to_idx=5), [CNN]),
    ("ScaleVertex", dict(scale_factor=-0.75), [CNN]),
    ("ShiftVertex", dict(shift_factor=1.25), [RNN]),
    ("L2NormalizeVertex", dict(eps=1e-6), [FF]),
    ("L2NormalizeVertex", {}, [CNN]),
    ("StackVertex", {}, [FF, FF, FF]),
    ("StackVertex", {}, [CNN, CNN]),
    ("UnstackVertex", dict(from_idx=1, stack_size=3), [FF]),
    ("UnstackVertex", dict(from_idx=0, stack_size=2), [CNN]),
    ("ReshapeVertex", dict(new_shape=(-1, 72)), [CNN]),
    ("ReshapeVertex", dict(new_shape=(-1, 2, 36)), [CNN]),
    ("ReshapeVertex", dict(new_shape=(-1, 2, 2, 5)), [RNN]),
    ("ReshapeVertex", dict(new_shape=(-1, 4, 3, 6)), [CNN]),
]


@pytest.mark.parametrize("name,kw,kinds", VERTICES,
                         ids=[f"{v[0]}-{i}" for i, v in enumerate(VERTICES)])
def test_vertex_matches_jax(name, kw, kinds):
    pv, jv = getattr(pgraph, name)(**kw), getattr(jgraph, name)(**kw)
    xs = [RNG.normal(size=k[2]).astype(np.float32) for k in kinds]
    if name == "UnstackVertex":  # a batch the stack divides
        xs = [RNG.normal(size=(6,) + k[2][1:]).astype(np.float32)
              for k in kinds]
    want, _ = jv.forward({}, {}, [jnp.asarray(x) for x in xs])
    got, _ = pv.forward({}, {}, [_port_in(x) for x in xs])
    np.testing.assert_allclose(_port_out(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert pv.output_type([k[0] for k in kinds]).__dict__ == \
        jv.output_type([k[1] for k in kinds]).__dict__
    assert serde.to_json(pv) == jserde.to_json(jv)
    assert pv.param_order() == jv.param_order() == []


def test_preprocessor_vertex_matches_jax():
    pv = pgraph.PreprocessorVertex(
        preprocessor=players.CnnToFeedForwardPreProcessor(
            height=4, width=3, channels=6))
    jv = jgraph.PreprocessorVertex(
        preprocessor=jlayers.CnnToFeedForwardPreProcessor(
            height=4, width=3, channels=6))
    x = RNG.normal(size=CNN[2]).astype(np.float32)
    want, _ = jv.forward({}, {}, [jnp.asarray(x)])
    got, _ = pv.forward({}, {}, [_port_in(x)])
    np.testing.assert_array_equal(_port_out(got), np.asarray(want))
    assert pv.output_type([CNN[0]]) == InputType.feed_forward(72)
    back = pgraph.PreprocessorVertex(
        preprocessor=players.FeedForwardToCnnPreProcessor(
            height=4, width=3, channels=6))
    img, _ = back.forward({}, {}, [got])
    np.testing.assert_array_equal(_port_out(img), x)
    assert serde.to_json(pv) == jserde.to_json(jv)


@pytest.mark.parametrize("name,kw", [
    ("MergeVertex", {}), ("SubsetVertex", dict(from_idx=0, to_idx=2)),
    ("ScaleVertex", dict(scale_factor=2.0)),
    ("L2NormalizeVertex", {}), ("ReshapeVertex", dict(new_shape=(-1, 20))),
])
def test_mask_propagation_past_each_vertex_matches_jax(name, kw):
    """A [batch, time] feature mask past a vertex with a sequence input:
    kept where the output keeps the time axis, ended where it does not —
    the JAX package's ``propagate_mask`` decision."""
    pv, jv = getattr(pgraph, name)(**kw), getattr(jgraph, name)(**kw)
    x = RNG.normal(size=RNN[2]).astype(np.float32)
    mask = np.ones((3, 4), np.float32)
    mask[1, 2:] = 0.0
    ins = [x, x] if name == "MergeVertex" else [x]
    y, _ = pv.forward({}, {}, [_port_in(v) for v in ins])
    jy, _ = jv.forward({}, {}, [jnp.asarray(v) for v in ins])
    got = pio.propagate_mask(torch.from_numpy(mask), y, pv)
    want = jio.propagate_mask(jnp.asarray(mask), jy, jv)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- AttentionVertex -----------------------------------------------------------

def _attention_pair(**kw):
    pv, jv = AttentionVertex(**kw), jgraph.AttentionVertex(**kw)
    tq = jit_.InputType.recurrent(3, timesteps=4)
    tk = jit_.InputType.recurrent(5, timesteps=6)
    jp = jv.init(jax.random.PRNGKey(0), [tq, tk, tk])
    return pv, jv, jp, convert_layer_params(pv, jax.tree_util.tree_map(
        np.asarray, jp))


@pytest.mark.parametrize("masked", [False, True])
def test_attention_vertex_matches_jax(masked):
    pv, jv, jp, pp = _attention_pair(n_out=8, n_heads=2)
    q = RNG.normal(size=(2, 4, 3)).astype(np.float32)
    kv = RNG.normal(size=(2, 6, 5)).astype(np.float32)
    ins = [q, kv, kv]
    if masked:
        mask = np.ones((2, 6), np.float32)
        mask[0, 4:] = 0.0
        ins.append(mask)
    want, _ = jv.forward(jp, {}, [jnp.asarray(v) for v in ins])
    got, _ = pv.forward(pp, {}, [torch.from_numpy(v) for v in ins])
    assert got.shape == (2, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    types = [InputType.recurrent(3, timesteps=4),
             InputType.recurrent(5, timesteps=6)] * 2
    assert pv.output_type(types[:1] + types[1:3]) == \
        InputType.recurrent(8, timesteps=4)
    if masked:  # masked keys never reach the output
        kv2 = kv.copy()
        kv2[0, 4:] = 7.0
        got2, _ = pv.forward(pp, {}, [torch.from_numpy(v) for v in
                                      (q, kv2, kv2, ins[3])])
        np.testing.assert_allclose(got2[0].numpy(), got[0].numpy(),
                                   atol=1e-6)


def test_attention_vertex_causal_and_unprojected_match_jax():
    pv, jv, jp, pp = _attention_pair(n_out=6, n_heads=3, causal=True,
                                     head_size=4)
    x = RNG.normal(size=(2, 5, 3)).astype(np.float32)
    kv = RNG.normal(size=(2, 5, 5)).astype(np.float32)
    want, _ = jv.forward(jp, {}, [jnp.asarray(x), jnp.asarray(kv),
                                  jnp.asarray(kv)])
    got, _ = pv.forward(pp, {}, [torch.from_numpy(x), torch.from_numpy(kv),
                                 torch.from_numpy(kv)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    pu = AttentionVertex(n_out=5, n_heads=1, project_input=False)
    ju = jgraph.AttentionVertex(n_out=5, n_heads=1, project_input=False)
    want, _ = ju.forward({}, {}, [jnp.asarray(kv)] * 3)
    got, _ = pu.forward({}, {}, [torch.from_numpy(kv)] * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert pu.init(None, [InputType.recurrent(5)] * 3) == {}


def test_attention_vertex_refuses_streaming_until_rnn_time_step():
    """``rnn_time_step`` is ported: a causal vertex with a streaming window
    builds and round-trips as the JAX package's does (its carry is the
    key/value window); the window without ``causal`` is still refused."""
    v = AttentionVertex(n_out=8, n_heads=2, causal=True, streaming_window=4)
    assert v.streaming_safe() and v.has_carry
    with pytest.raises(ValueError, match="causal"):
        AttentionVertex(n_out=8, n_heads=2, streaming_window=4)
    with pytest.raises(ValueError, match="causal"):
        jgraph.AttentionVertex(n_out=8, n_heads=2, streaming_window=4)
    jv = jgraph.AttentionVertex(n_out=8, n_heads=2, causal=True,
                                streaming_window=4)
    back = serde.from_json(jserde.to_json(jv))
    assert back == v
    assert jserde.from_json(serde.to_json(back)) == jv
    assert {k: tuple(t.shape) for k, t in back.zero_carry(3).items()} == {
        k: tuple(np.shape(t)) for k, t in jv.zero_carry(3).items()}


def _graphs():
    """The same AttentionVertex graph in both packages: queries, keys and
    values from input ``x``, the key mask from input ``mask``, a
    time-distributed softmax head."""
    def build(nnc, it, av, out, act, lossfn):
        return (nnc.builder().seed(5).graph_builder()
                .add_inputs("x", "mask")
                .set_input_types(it.InputType.recurrent(6, timesteps=5),
                                 it.InputType.feed_forward(5))
                .add_vertex("attn", av(n_out=8, n_heads=2, causal=True),
                            "x", "x", "x", "mask")
                .add_layer("out", out(n_out=3, activation=act.SOFTMAX,
                                      loss_fn=lossfn()), "attn")
                .set_outputs("out").build())

    from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
    from deeplearning4j_tpu_torch.conf import inputs as pit

    jconf = build(JNNC, jit_, jgraph.AttentionVertex, jlayers.OutputLayer,
                  JAct, JMCXENT)
    pconf = build(NeuralNetConfiguration, pit, AttentionVertex,
                  players.OutputLayer, Activation, LossMCXENT)
    return jconf, pconf


def test_attention_vertex_graph_matches_jax_on_both_routes(monkeypatch):
    jconf, pconf = _graphs()
    assert pconf.to_json() == jconf.to_json()
    jnet = JGraph(jconf).init()
    p, s = params_from_jax(pconf, jax.tree_util.tree_map(np.asarray,
                                                         jnet.params), {})
    x = RNG.normal(size=(3, 5, 6)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[1, 3:] = 0.0
    want = np.asarray(jnet.output(x, mask))
    calls = []
    real = att.flash_attention

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(att, "flash_attention", spy)
    for use_kernels in (False, True):
        net = ComputationGraph(dataclasses.replace(
            pconf, use_kernels=use_kernels), device="cpu").set_params(p, s)
        np.testing.assert_allclose(net.output(x, mask), want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(net.params_flat(),
                                      np.asarray(jnet.params_flat()))
    # the kernel route sent the vertex's core to the flash kernel
    assert calls == [(3, 2, 5, 4)]


def test_attention_vertex_graph_trains_on_both_routes_alike():
    _, pconf = _graphs()
    x = RNG.normal(size=(3, 5, 6)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[2, 2:] = 0.0
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, (3, 5))]
    mds = MultiDataSet(features=[x, mask], labels=[y])
    nets = [ComputationGraph(dataclasses.replace(pconf, use_kernels=uk),
                             device="cpu").init() for uk in (False, True)]
    nets[1].set_params(nets[0].params, nets[0].state)
    losses = [[n.fit_batch(mds) for _ in range(3)] for n in nets]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[0][-1] < losses[0][0]


# --- EmbeddingLayer, LossLayer ---------------------------------------------------

@pytest.mark.parametrize("ids_shape", [(5,), (5, 1)])
def test_embedding_layer_matches_jax(ids_shape):
    pl = players.EmbeddingLayer(n_in=9, n_out=4, has_bias=True,
                                activation=Activation.TANH)
    jl = jlayers.EmbeddingLayer(n_in=9, n_out=4, has_bias=True,
                                activation=JAct.TANH)
    jp = jl.init(jax.random.PRNGKey(1), jit_.InputType.feed_forward(1))
    jp = dict(jp, b=jnp.asarray(RNG.normal(size=4), jnp.float32))
    pp = convert_layer_params(pl, jax.tree_util.tree_map(np.asarray, jp))
    ids = RNG.integers(0, 9, ids_shape)
    want, _ = jl.forward(jp, {}, jnp.asarray(ids))
    got, _ = pl.forward(pp, {}, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert pl.output_type(InputType.feed_forward(1)) == \
        InputType.feed_forward(4)
    # the gradient of W: a scatter-add of the output gradient into the
    # looked-up rows (a repeated id sums its rows), as jax.grad gives it
    g = RNG.normal(size=(5, 4)).astype(np.float32)
    jg = jax.grad(lambda w: jnp.sum(jl.forward(dict(jp, W=w), {},
                                               jnp.asarray(ids))[0] * g))(
        jp["W"])
    w = pp["W"].clone().requires_grad_()
    y, _ = pl.forward(dict(pp, W=w), {}, torch.from_numpy(ids))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


def test_embedding_layer_raises_on_out_of_range_ids():
    pl = players.EmbeddingLayer(n_in=4, n_out=2)
    p = pl.init(torch.Generator().manual_seed(0),
                InputType.feed_forward(1))
    for bad in ([0, 4], [-1, 2]):
        with pytest.raises((IndexError, RuntimeError)):
            pl.forward(p, {}, torch.tensor(bad))


def test_embedding_ids_reach_the_network_as_integers():
    """Token ids cross as long through a graph and a MultiLayerNetwork,
    also under the bf16 policy (bfloat16 holds integers exactly only to
    256)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1)
            .compute_dtype("bfloat16").list()
            .layer(players.EmbeddingLayer(n_in=1000, n_out=3))
            .layer(players.OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(1)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    ids = np.array([[999], [257]])
    w = net.params["0"]["W"]
    got = net.feed_forward(ids)[0]
    np.testing.assert_array_equal(
        got, w[[999, 257]].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("act,loss", [(Activation.SOFTMAX, LossMCXENT()),
                                      (Activation.IDENTITY, LossMSE())])
def test_loss_layer_matches_jax(act, loss):
    from deeplearning4j_tpu.conf import losses as jlosses

    pl = players.LossLayer(activation=act, loss_fn=loss)
    jl = jlayers.LossLayer(activation=JAct(act.value),
                           loss_fn=getattr(jlosses, type(loss).__name__)())
    x = RNG.normal(size=(4, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 4)]
    want, _ = jl.forward({}, {}, jnp.asarray(x))
    got, _ = pl.forward({}, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        float(pl.score({}, torch.from_numpy(x), torch.from_numpy(y))),
        float(jl.score({}, jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    assert pl.param_order() == [] and pl.regularized_param_keys() == []
    assert serde.to_json(pl) == jserde.to_json(jl)


# --- JSON and backprop_type ---------------------------------------------------------

NEW_CLASSES = [
    ("layers", "EmbeddingLayer", dict(n_in=10, n_out=4, has_bias=True)),
    ("layers", "LossLayer", {}),
    ("layers_cnn", "ZeroPaddingLayer", dict(padding=(1, 2, 1, 2))),
    ("layers_cnn", "SpaceToDepthLayer", dict(block_size=4)),
    ("graph", "MergeVertex", {}),
    ("graph", "SubsetVertex", dict(from_idx=2, to_idx=5)),
    ("graph", "ScaleVertex", dict(scale_factor=0.25)),
    ("graph", "ShiftVertex", dict(shift_factor=-1.0)),
    ("graph", "L2NormalizeVertex", dict(eps=1e-7)),
    ("graph", "StackVertex", {}),
    ("graph", "UnstackVertex", dict(from_idx=1, stack_size=4)),
    ("graph", "ReshapeVertex", dict(new_shape=(-1, 2, 3))),
    ("graph", "AttentionVertex", dict(n_out=16, n_heads=4, head_size=8,
                                      causal=True, attention_impl="flash")),
]


@pytest.mark.parametrize("module,name,kw", NEW_CLASSES,
                         ids=[c[1] for c in NEW_CLASSES])
def test_json_round_trips_between_the_packages(module, name, kw):
    import importlib

    pobj = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.conf.{module}"), name)(**kw)
    jobj = getattr(importlib.import_module(
        f"deeplearning4j_tpu.conf.{module}"), name)(**kw)
    pjs, jjs = serde.to_json(pobj), jserde.to_json(jobj)
    assert pjs == jjs
    assert serde.from_json(jjs) == pobj
    assert jserde.from_json(pjs) == jobj


def _tbptt_graph(nnc, it, dense, out, bp):
    return (nnc.builder().seed(2).graph_builder()
            .add_inputs("in")
            .set_input_types(it.InputType.feed_forward(4))
            .add_layer("d", dense(n_out=3), "in")
            .add_layer("out", out(n_out=2), "d")
            .set_outputs("out")
            .backprop_type(bp.TRUNCATED_BPTT, 7, 5)
            .build())


def test_backprop_type_round_trips_and_fit_refuses_tbptt():
    from deeplearning4j_tpu_torch.conf import inputs as pit

    pconf = _tbptt_graph(NeuralNetConfiguration, pit, players.DenseLayer,
                         players.OutputLayer, BackpropType)
    jconf = _tbptt_graph(JNNC, jit_, jlayers.DenseLayer, jlayers.OutputLayer,
                         JBackprop)
    assert (pconf.backprop_type, pconf.tbptt_fwd_length,
            pconf.tbptt_back_length) == (BackpropType.TRUNCATED_BPTT, 7, 5)
    assert pconf.to_json() == jconf.to_json()
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back.backprop_type is BackpropType.TRUNCATED_BPTT
    # truncated BPTT is ported: a graph whose inputs are all static trains
    # the standard step under a tBPTT conf, as the JAX package's does
    jnet = JGraph(jconf).init()
    p, s = params_from_jax(back, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    net = ComputationGraph(back, device="cpu").set_params(p, s)
    x = RNG.normal(size=(2, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

    jnet.fit(JDataSet(x, y))
    net.fit(DataSet(x, y))
    assert net.iteration == jnet.iteration == 1
    assert net.score() == pytest.approx(float(jnet.score()), rel=1e-5)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=1e-5,
                               atol=1e-6)
