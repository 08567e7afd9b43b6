"""Sequence attention and the sequence refusals in the port against the JAX
package, on the CPU.

- ``LearnedSelfAttentionLayer`` with ``attention_impl="flash"`` against the
  JAX layer, whose core is the Pallas flash kernel in interpret mode
  (forward and its custom-VJP backward), and with ``"reference"``; masked,
  projected and not; its checks, JSON and params conversion; an LSTM +
  learned-attention + ``RnnOutputLayer`` network trained two steps in both
  packages;
- ``RecurrentAttentionLayer``: forward, carries and gradients;
- the streaming ``AttentionVertex`` (``streaming_window > 0``): chunked
  ``forward_with_carry`` against the JAX vertex, the window sliding past
  its length;
- ``GlobalPoolingLayer.forward(mask=)``: each pooling type's masked
  pooling (a row with no valid step included);
- the KV-cached decoder's refusals: pooling, learned-query attention,
  recurrent attention and every carry-bearing vertex.

On the CPU the flash wrapper runs ``flash_attention_plain`` and its
backward ``flash_attention_bwd_plain``; ``chip_smoke.py`` holds the CUDA
kernels to those on the card. Weights are the JAX network's (or drawn
with numpy in the JAX layouts) carried by ``util.convert``.

Tolerances: outputs rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-5
(float32 sums in other orders: the Pallas kernel's 32-wide key blocks
against one softmax); scores rtol 1e-5; params after Adam steps rtol 1e-5
with an absolute floor of 1e-2 of the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_attention as jla
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.graph import AttentionVertex as JAttV
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import GlobalPoolingLayer as JGPool
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.decoding import TransformerDecoder as JDecoder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.graph import (
    AttentionVertex,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.layers_attention import (
    LearnedSelfAttentionLayer,
    RecurrentAttentionLayer,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import GlobalPoolingLayer
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    layer_params_to_jax,
    params_from_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
B, T, N_IN = 3, 20, 5
LENGTHS = (T, 9, 1)
LR = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mask():
    return (np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]).astype(
        np.float32)


def _x(seed=0, f=N_IN):
    return np.random.default_rng(seed).standard_normal((B, T, f)).astype(
        np.float32)


def _jparams(jlayer, seed=1, n_in=N_IN):
    p = jlayer.init(jax.random.PRNGKey(0), JIT.recurrent(n_in, T))
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in p.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


LEARNED = {
    "flash": dict(n_out=8, n_heads=2, head_size=4, n_queries=3,
                  attention_impl="flash"),
    "reference": dict(n_out=8, n_heads=2, head_size=4, n_queries=3,
                      attention_impl="reference"),
    "flash_one_query": dict(n_out=6, n_heads=1, head_size=8, n_queries=1,
                            attention_impl="flash"),
    "unprojected": dict(n_queries=4, project_input=False,
                        attention_impl="flash"),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", sorted(LEARNED))
def test_learned_self_attention_matches_jax(kind, masked):
    """Forward and gradients of sum(y * w) with respect to the params and
    the input; the JAX layer's flash core is its Pallas kernel, run in
    interpret mode."""
    jlayer = jla.LearnedSelfAttentionLayer(**LEARNED[kind])
    layer = serde.from_json(jserde.to_json(jlayer))
    assert isinstance(layer, LearnedSelfAttentionLayer)
    jp = _jparams(jlayer)
    x = _x()
    m = _mask() if masked else None
    y_j, _ = jlayer.forward(_j(jp), {}, jnp.asarray(x),
                            mask=None if m is None else jnp.asarray(m))
    w = np.random.default_rng(2).standard_normal(
        np.shape(y_j)).astype(np.float32)

    def f(p, xx):
        y, _ = jlayer.forward(p, {}, xx, train=True,
                              mask=None if m is None else jnp.asarray(m))
        return jnp.sum(y * jnp.asarray(w))

    gp, gx = jax.grad(f, argnums=(0, 1))(_j(jp), jnp.asarray(x))
    p = {k: v.requires_grad_() for k, v in
         convert_layer_params(layer, jp).items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.forward(p, {}, xt, train=True,
                         mask=None if m is None else torch.tensor(m))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    (y * torch.tensor(w)).sum().backward()
    got = layer_params_to_jax(layer, {k: v.grad for k, v in p.items()})
    for k in gp:
        np.testing.assert_allclose(got[k], np.asarray(gp[k]), err_msg=k,
                                   **GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)


def test_learned_self_attention_flash_goes_through_the_kernel_function():
    """The flash impl runs the autograd Function over the kernel (its
    plain versions on a CPU tensor): the backward reaches
    flash_attention_bwd once a call, the broadcast queries' gradient
    summed over the batch."""
    layer = LearnedSelfAttentionLayer(**LEARNED["flash"])
    p = layer.init(torch.Generator().manual_seed(0), InputType.recurrent(
        N_IN, T))
    p = {k: v.requires_grad_() for k, v in p.items()}
    calls = []
    real = att.flash_attention_bwd

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    att.flash_attention_bwd = spy
    try:
        y, _ = layer.forward(p, {}, torch.tensor(_x()), train=True,
                             mask=torch.tensor(_mask()))
        y.sum().backward()
    finally:
        att.flash_attention_bwd = real
    assert calls == [torch.Size([B, 2, 3, 4])]
    assert tuple(p["Q"].grad.shape) == (3, 8)


def test_learned_self_attention_checks_and_json():
    for kw, match in ((dict(n_queries=2, project_input=False, n_heads=2),
                       "n_heads == 1"),
                      (dict(n_queries=2, project_input=False, head_size=3),
                       "head_size must be")):
        with pytest.raises(ValueError, match=match):
            LearnedSelfAttentionLayer(**kw).init(
                torch.Generator(), InputType.recurrent(N_IN, T))
        with pytest.raises(ValueError, match=match):
            jla.LearnedSelfAttentionLayer(**kw).init(
                jax.random.PRNGKey(0), JIT.recurrent(N_IN, T))
    for kw in LEARNED.values():
        jl = jla.LearnedSelfAttentionLayer(**kw)
        layer = serde.from_json(jserde.to_json(jl))
        assert jserde.from_json(serde.to_json(layer)) == jl
        assert layer.param_order() == jl.param_order()
        assert layer.regularized_param_keys() == jl.regularized_param_keys()
        assert serde.to_dict(layer.output_type(InputType.recurrent(
            N_IN, T))) == jserde.to_dict(jl.output_type(JIT.recurrent(
                N_IN, T)))
        assert not layer.streaming_safe()


def _learned_jconf():
    return (JNNC.builder().seed(4).updater(JAdam(learning_rate=LR)).list()
            .layer(jrnn.LSTM(n_out=8))
            .layer(jla.LearnedSelfAttentionLayer(
                n_out=8, n_heads=2, head_size=4, n_queries=3,
                attention_impl="flash"))
            .layer(jrnn.RnnOutputLayer(n_out=4, activation=JAct.SOFTMAX))
            .set_input_type(JIT.recurrent(N_IN, T)).build())


def test_lstm_with_learned_attention_trains_as_jax():
    """[28]'s model at narrow width: LSTM(8) + the learned-query layer on
    the flash core + RnnOutputLayer, a ragged features mask, one-hot
    [B, 3, 4] labels, two Adam steps in both packages."""
    jconf = _learned_jconf()
    jnet = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    net = MultiLayerNetwork(conf, "cpu").set_params(p, s)
    x, m = _x(5), _mask()
    y = np.eye(4, dtype=np.float32)[
        np.random.default_rng(6).integers(0, 4, (B, 3))]
    np.testing.assert_allclose(net.output(x, fmask=m),
                               np.asarray(jnet.output(x, fmask=m)), **FWD)
    for _ in range(2):
        lj = jnet.fit_batch(JDataSet(x, y, features_mask=m))
        lp = net.fit_batch(DataSet(x, y, features_mask=m))
        assert lp == pytest.approx(lj, rel=1e-5)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=1e-5,
                               atol=1e-2 * LR)


@pytest.mark.parametrize("masked", [False, True])
def test_recurrent_attention_matches_jax(masked):
    jlayer = jla.RecurrentAttentionLayer(n_out=6, n_heads=2)
    layer = serde.from_json(jserde.to_json(jlayer))
    assert isinstance(layer, RecurrentAttentionLayer)
    assert jserde.from_json(serde.to_json(layer)) == jlayer
    jp = _jparams(jlayer, seed=7)
    p = convert_layer_params(layer, jp)
    for k, v in jp.items():  # [in, out] in both packages
        np.testing.assert_array_equal(p[k].numpy(), v)
    x = _x(8)
    m = _mask() if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.tensor(m)
    y_j, _ = jlayer.forward(_j(jp), {}, jnp.asarray(x), mask=jm)
    y, _ = layer.forward(p, {}, torch.tensor(x), mask=tm)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
    # from a nonzero carry: outputs and the final carry
    h0 = np.random.default_rng(9).standard_normal((B, 6)).astype(np.float32)
    yc_j, c_j = jlayer.forward_with_carry(_j(jp), {"h": jnp.asarray(h0)},
                                          jnp.asarray(x), mask=jm)
    yc, c = layer.forward_with_carry(p, {"h": torch.tensor(h0)},
                                     torch.tensor(x), mask=tm)
    np.testing.assert_allclose(yc.numpy(), np.asarray(yc_j), **FWD)
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(c_j["h"]), **FWD)
    # gradients
    w = np.random.default_rng(10).standard_normal(
        np.shape(y_j)).astype(np.float32)
    gp = jax.grad(lambda q: jnp.sum(jlayer.forward(
        q, {}, jnp.asarray(x), mask=jm)[0] * jnp.asarray(w)))(_j(jp))
    pt = {k: v.requires_grad_() for k, v in p.items()}
    yt, _ = layer.forward(pt, {}, torch.tensor(x), mask=tm)
    (yt * torch.tensor(w)).sum().backward()
    for k in gp:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(gp[k]),
                                   err_msg=k, **GRAD)
    assert layer.has_carry and not layer.streaming_safe()


def test_streaming_attention_vertex_matches_jax():
    """The vertex builds (``causal`` still required), streams chunks of 3,
    1 and 4 steps through a 5-step key/value window (sliding past it)
    against the JAX vertex, and its whole-sequence forward is the JAX
    package's; a masked step in a chunk is honoured."""
    with pytest.raises(ValueError, match="causal"):
        AttentionVertex(n_out=8, n_heads=2, streaming_window=4)
    jv = JAttV(n_out=8, n_heads=2, causal=True, streaming_window=5)
    v = serde.from_json(jserde.to_json(jv))
    assert v.streaming_safe() and v.has_carry
    jp = jv.init(jax.random.PRNGKey(1), [JIT.recurrent(N_IN, 8)] * 3)
    jp = {k: (0.5 * np.random.default_rng(11).standard_normal(
        np.shape(a))).astype(np.float32) for k, a in jp.items()}
    p = convert_layer_params(v, jp)
    x = np.random.default_rng(12).standard_normal((B, 8, N_IN)).astype(
        np.float32)
    m = np.ones((B, 8), np.float32)
    m[1, 2] = 0.0
    carry_j = jv.zero_carry(B)
    carry = v.zero_carry(B)
    assert {k: tuple(a.shape) for k, a in carry.items()} == {
        k: tuple(a.shape) for k, a in carry_j.items()}
    for lo, hi in ((0, 3), (3, 4), (4, 8)):
        xs = [x[:, lo:hi]] * 3 + [m[:, lo:hi]]
        y_j, carry_j = jv.forward_with_carry(_j(jp), carry_j,
                                             [jnp.asarray(a) for a in xs])
        y, carry = v.forward_with_carry(p, carry,
                                        [torch.tensor(a) for a in xs])
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
        for k in carry:
            np.testing.assert_allclose(carry[k].numpy(),
                                       np.asarray(carry_j[k]), **FWD)
    full_j, _ = jv.forward(_j(jp), {}, [jnp.asarray(x)] * 3)
    full, _ = v.forward(p, {}, [torch.tensor(x)] * 3)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), **FWD)


@pytest.mark.parametrize("pooling", list(JPT))
def test_global_pooling_masked_matches_jax(pooling):
    jl = JGPool(pooling_type=pooling)
    layer = serde.from_json(jserde.to_json(jl))
    assert isinstance(layer, GlobalPoolingLayer)
    x = _x(13)
    m = _mask()
    m[2] = 0.0  # no valid step: max pools to -inf in both packages
    y_j, _ = jl.forward({}, {}, jnp.asarray(x), mask=jnp.asarray(m))
    y, _ = layer.forward({}, {}, torch.tensor(x), mask=torch.tensor(m))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
    y0, _ = layer.forward({}, {}, torch.tensor(x))
    y0_j, _ = jl.forward({}, {}, jnp.asarray(x))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_j), **FWD)
    assert not getattr(layer, "uses_mask", False)  # as the JAX layer


def _decoder_graph(kind):
    """A one-input graph over token embeddings whose middle vertex is
    ``kind``; the decoder walks the vertices in order and refuses it."""
    from deeplearning4j_tpu.conf.layers import EmbeddingSequenceLayer

    b = (JNNC.builder().seed(1).graph_builder().add_inputs("ids")
         .set_input_types(JIT.recurrent(1, 8))
         .add_layer("emb", EmbeddingSequenceLayer(n_in=16, n_out=8), "ids"))
    if kind == "pool":
        b = b.add_layer("mid", JGPool(), "emb")
    elif kind == "learned":
        b = b.add_layer("mid", jla.LearnedSelfAttentionLayer(
            n_out=8, n_heads=2, n_queries=2), "emb")
    elif kind == "recurrent_attention":
        b = b.add_layer("mid", jla.RecurrentAttentionLayer(
            n_out=8, n_heads=2), "emb")
    elif kind == "lstm":
        b = b.add_layer("mid", jrnn.LSTM(n_out=8), "emb")
    else:  # a streaming AttentionVertex carries its window
        b = b.add_vertex("mid", JAttV(n_out=8, n_heads=2, causal=True,
                                      streaming_window=4),
                         "emb", "emb", "emb")
    head = (JOut(n_out=16, activation=JAct.SOFTMAX) if kind == "pool"
            else jrnn.RnnOutputLayer(n_out=16, activation=JAct.SOFTMAX))
    return b.add_layer("out", head, "mid").set_outputs("out").build()


@pytest.mark.parametrize("kind", ["pool", "learned", "recurrent_attention",
                                  "lstm", "streaming_vertex"])
def test_decoder_refuses_what_jax_refuses(kind):
    jconf = _decoder_graph(kind)
    with pytest.raises(ValueError, match="not supported in the KV-cached"):
        JDecoder(JGraph(jconf).init())
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    with pytest.raises(ValueError, match="not supported in the KV-cached"):
        TransformerDecoder(ComputationGraph(conf, "cpu").init())


def test_learned_attention_graph_output_matches_jax():
    """In a graph the feature mask reaches the learned-query layer as its
    key mask (LayerVertex hands it to a ``uses_mask`` layer)."""
    jconf = (JNNC.builder().seed(2).graph_builder().add_inputs("x")
             .set_input_types(JIT.recurrent(N_IN, T))
             .add_layer("att", jla.LearnedSelfAttentionLayer(
                 n_out=8, n_heads=2, n_queries=3, attention_impl="flash"),
                 "x")
             .add_layer("d", JDense(n_out=4, activation=JAct.TANH), "att")
             .add_layer("out", jrnn.RnnOutputLayer(
                 n_out=3, activation=JAct.SOFTMAX), "d")
             .set_outputs("out").build())
    jnet = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    net = ComputationGraph(conf, "cpu").set_params(p, s)
    x, m = _x(14), _mask()
    np.testing.assert_allclose(
        net.output(x, fmasks=[m]),
        np.asarray(jnet.output(x, fmasks=[m])), **FWD)
