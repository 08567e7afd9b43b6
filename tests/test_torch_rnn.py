"""The port's recurrent layers against the JAX package's, on the CPU.

Every layer of ``conf/layers_rnn.py`` (SimpleRnn, LSTM, GravesLSTM, GRU in
both variants, go_backwards, Bidirectional in each mode and over a
go_backwards layer, LastTimeStep, MaskZeroLayer, RnnOutputLayer,
RnnLossLayer) and ``GravesBidirectionalLSTM``: the same configuration
(carried through the JSON), the same seeded weights (drawn with numpy in
the JAX layouts, every param nonzero, peepholes included, carried by
``util.convert``), the same inputs and masks (none, ALIGN_START,
ALIGN_END, a length-0 row included). Forwards, carries and gradients of
``sum(y * w)`` with respect to the params and the input are compared.

Tolerances: forwards and carries rtol 1e-5, atol 1e-6 (float32 steps of
width 6-8 summed in other orders over at most 12 steps); gradients rtol
1e-4, atol 1e-5 (backward through the same steps, a longer chain of
float32 sums); scores rtol 1e-5. Conversion, the flat params vector and
zips are compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.layers_extra import (
    GravesBidirectionalLSTM as JGBL,
)
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBP
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.regularization import L2Regularization as JL2
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.weights import WeightInit as JWI
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import params as jparams
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import layers_rnn as rnn
from deeplearning4j_tpu_torch.conf.layers import (
    FeedForwardToRnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.conf.regularization import L2Regularization
from deeplearning4j_tpu_torch.conf.updaters import Sgd
from deeplearning4j_tpu_torch.conf.weights import WeightInit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import params as pparams
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    layer_params_to_jax,
    params_from_jax,
    params_to_jax,
)

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
B, T, N_IN = 4, 12, 5
LENGTHS = (T, 5, 1, 0)


def _jax_layers():
    """name -> the JAX layer conf (its port twin comes from the JSON)."""
    return {
        "simple_rnn": jrnn.SimpleRnn(n_out=6),
        "lstm": jrnn.LSTM(n_out=6),
        "lstm_go_backwards": jrnn.LSTM(n_out=6, go_backwards=True),
        "graves_lstm": jrnn.GravesLSTM(n_out=6),
        "gru": jrnn.GRU(n_out=6),
        "gru_reset_after": jrnn.GRU(n_out=6, reset_after=True),
        "simple_rnn_relu": jrnn.SimpleRnn(n_out=6, activation=JAct.RELU),
        **{f"bidirectional_{m.value.lower()}": jrnn.Bidirectional(
            layer=jrnn.LSTM(n_out=4), mode=m)
           for m in jrnn.BidirectionalMode},
        "bidirectional_go_backwards": jrnn.Bidirectional(
            layer=jrnn.GRU(n_out=4, go_backwards=True)),
        "last_time_step": jrnn.LastTimeStep(layer=jrnn.LSTM(n_out=6)),
        "mask_zero": jrnn.MaskZeroLayer(layer=jrnn.GRU(n_out=6)),
        "graves_bidirectional": JGBL(n_out=4),
    }


LAYERS = sorted(_jax_layers())
CARRY_LAYERS = ["simple_rnn", "lstm", "graves_lstm", "gru", "gru_reset_after",
                "last_time_step", "mask_zero"]


def _pair(name):
    jlayer = _jax_layers()[name]
    layer = serde.from_json(jserde.to_json(jlayer))
    return jlayer, layer


def _jparams(jlayer, seed=0):
    """The layer's params in the JAX layouts, every value drawn with numpy
    (peepholes and recurrent biases nonzero)."""
    p = jlayer.init(jax.random.PRNGKey(0), JIT.recurrent(N_IN, T))
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in p.items()}


def _inputs(seed=1, zero_steps=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    if zero_steps:  # MaskZeroLayer's sentinel steps
        x[1, 3] = 0.0
        x[2, 7:9] = 0.0
    return x


def _mask(kind):
    if kind == "none":
        return None
    pos = np.arange(T)[None, :]
    lens = np.asarray(LENGTHS)[:, None]
    m = pos < lens if kind == "start" else pos >= T - lens
    return m.astype(np.float32)


def _jax_forward(jlayer, jp, x, mask):
    y, _ = jlayer.forward({k: jnp.asarray(v) for k, v in jp.items()}, {},
                          jnp.asarray(x), mask=None if mask is None
                          else jnp.asarray(mask))
    return np.asarray(y)


def _forward(layer, p, x, mask):
    y, _ = layer.forward(p, {}, torch.tensor(x),
                         mask=None if mask is None else torch.tensor(mask))
    return y


@pytest.mark.parametrize("mask", ["none", "start", "end"])
@pytest.mark.parametrize("name", LAYERS)
def test_forward_matches_jax(name, mask):
    jlayer, layer = _pair(name)
    jp = _jparams(jlayer)
    x = _inputs(zero_steps=name == "mask_zero")
    m = _mask(mask)
    want = _jax_forward(jlayer, jp, x, m)
    got = _forward(layer, convert_layer_params(layer, jp), x, m)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)


def _port_type():
    from deeplearning4j_tpu_torch.conf.inputs import InputType

    return InputType.recurrent(N_IN, T)


@pytest.mark.parametrize("name", LAYERS)
def test_output_type_matches_jax(name):
    jlayer, layer = _pair(name)
    jt = jlayer.output_type(JIT.recurrent(N_IN, T))
    t = layer.output_type(_port_type())
    assert serde.to_dict(t) == jserde.to_dict(jt)


@pytest.mark.parametrize("name", LAYERS)
def test_gradients_match_jax(name):
    """d sum(y * w) / d(params, x) with the ALIGN_END mask."""
    jlayer, layer = _pair(name)
    jp = _jparams(jlayer, seed=2)
    x = _inputs(seed=3, zero_steps=name == "mask_zero")
    m = _mask("end")
    y_shape = _jax_forward(jlayer, jp, x, m).shape
    w = np.random.default_rng(4).standard_normal(y_shape).astype(np.float32)

    def f(p, xx):
        y, _ = jlayer.forward(p, {}, xx, mask=jnp.asarray(m), train=True)
        return jnp.sum(y * jnp.asarray(w))

    gp, gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    p = {k: v.requires_grad_() for k, v in
         convert_layer_params(layer, jp).items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.forward(p, {}, xt, mask=torch.tensor(m), train=True)
    (y * torch.tensor(w)).sum().backward()
    got = layer_params_to_jax(layer, {k: v.grad for k, v in p.items()})
    for k in gp:
        np.testing.assert_allclose(got[k], np.asarray(gp[k]), err_msg=k,
                                   **GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)


@pytest.mark.parametrize("name", CARRY_LAYERS)
def test_forward_with_carry_matches_jax(name):
    """From a nonzero carry, with the ALIGN_START mask: outputs and the
    final carry (masked steps hold it)."""
    jlayer, layer = _pair(name)
    jp = _jparams(jlayer, seed=5)
    x = _inputs(seed=6, zero_steps=name == "mask_zero")
    m = _mask("start")
    rng = np.random.default_rng(7)
    jc = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in jlayer.zero_carry(B).items()}
    y_j, c_j = jlayer.forward_with_carry(
        {k: jnp.asarray(v) for k, v in jp.items()},
        {k: jnp.asarray(v) for k, v in jc.items()}, jnp.asarray(x),
        mask=jnp.asarray(m))
    y, c = layer.forward_with_carry(
        convert_layer_params(layer, jp),
        {k: torch.tensor(v) for k, v in jc.items()}, torch.tensor(x),
        mask=torch.tensor(m))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
    assert sorted(c) == sorted(c_j)
    for k in c:
        np.testing.assert_allclose(c[k].numpy(), np.asarray(c_j[k]), **FWD)
    assert layer.has_carry and jlayer.has_carry
    zero = layer.zero_carry(B)
    assert {k: tuple(v.shape) for k, v in zero.items()} == {
        k: tuple(v.shape) for k, v in jlayer.zero_carry(B).items()}


@pytest.mark.parametrize("kind", ["none", "start", "end"])
def test_reverse_sequence_and_last_index_match_jax(kind):
    x = _inputs(seed=8)
    m = _mask(kind)
    want = np.asarray(jrnn.reverse_sequence(
        jnp.asarray(x), None if m is None else jnp.asarray(m)))
    got = rnn.reverse_sequence(torch.tensor(x),
                               None if m is None else torch.tensor(m))
    np.testing.assert_array_equal(got.numpy(), want)
    if m is not None:
        np.testing.assert_array_equal(
            rnn._last_valid_index(torch.tensor(m), T).numpy(),
            np.asarray(jrnn._last_valid_index(jnp.asarray(m), T)))


@pytest.mark.parametrize("mask", ["none", "end"])
@pytest.mark.parametrize("head", ["output", "loss"])
def test_rnn_output_and_loss_layers_match_jax(head, mask):
    """Forward and per-step score (labels mask = the feature mask) of
    RnnOutputLayer (W converted to the port's [nOut, nIn]) and
    RnnLossLayer."""
    jlayer = (jrnn.RnnOutputLayer(n_out=N_IN) if head == "output"
              else jrnn.RnnLossLayer())
    layer = serde.from_json(jserde.to_json(jlayer))
    jp = _jparams(jlayer, seed=9) if head == "output" else {}
    p = convert_layer_params(layer, jp)
    x = _inputs(seed=10)
    rng = np.random.default_rng(11)
    labels = np.eye(N_IN, dtype=np.float32)[rng.integers(0, N_IN, (B, T))]
    m = _mask(mask)
    jpp = {k: jnp.asarray(v) for k, v in jp.items()}
    y_j, _ = jlayer.forward(jpp, {}, jnp.asarray(x))
    y, _ = layer.forward(p, {}, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
    s_j = float(jlayer.score(jpp, jnp.asarray(x), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m)))
    s = float(layer.score(p, torch.tensor(x), torch.tensor(labels),
                          None if m is None else torch.tensor(m)))
    assert s == pytest.approx(s_j, rel=1e-5)


@pytest.mark.parametrize("name", LAYERS + ["rnn_output", "rnn_loss"])
def test_json_round_trips_both_ways(name):
    jlayer = {"rnn_output": jrnn.RnnOutputLayer(n_out=3),
              "rnn_loss": jrnn.RnnLossLayer()}.get(name) \
        or _jax_layers()[name]
    layer = serde.from_json(jserde.to_json(jlayer))
    assert type(layer).__name__ == type(jlayer).__name__
    assert serde.to_dict(layer) == jserde.to_dict(jlayer)
    back = jserde.from_json(serde.to_json(layer))
    assert back == jlayer


def test_preprocessors_are_the_identity_and_round_trip():
    from deeplearning4j_tpu.conf import layers as jlayers

    x = torch.tensor(_inputs(seed=12))
    for cls, jcls in ((RnnToFeedForwardPreProcessor,
                       jlayers.RnnToFeedForwardPreProcessor),
                      (FeedForwardToRnnPreProcessor,
                       jlayers.FeedForwardToRnnPreProcessor)):
        pre = serde.from_json(jserde.to_json(jcls()))
        assert type(pre) is cls
        y, _ = pre.forward({}, {}, x)
        assert y is x
        assert jserde.from_json(serde.to_json(pre)) == jcls()


def test_lstm_init_layout_and_forget_bias():
    """Shapes, the forget-gate bias and the param order are the JAX
    package's (GravesLSTM's six tensors, GRU's recurrent bias)."""
    from deeplearning4j_tpu_torch.conf.inputs import InputType

    itype = InputType.recurrent(N_IN, T)
    for jl in (jrnn.LSTM(n_out=6, forget_gate_bias_init=2.5),
               jrnn.GravesLSTM(n_out=6), jrnn.GRU(n_out=6, reset_after=True),
               jrnn.SimpleRnn(n_out=6), JGBL(n_out=4)):
        layer = serde.from_json(jserde.to_json(jl))
        p = layer.init(torch.Generator().manual_seed(0), itype)
        jp = jl.init(jax.random.PRNGKey(0), JIT.recurrent(N_IN, T))
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            k: tuple(np.shape(v)) for k, v in jp.items()}
        assert layer.param_order() == jl.param_order()
        assert layer.regularized_param_keys() == jl.regularized_param_keys()
    p = rnn.LSTM(n_out=6, forget_gate_bias_init=2.5).init(
        torch.Generator().manual_seed(0), itype)
    np.testing.assert_array_equal(p["b"][6:12].numpy(), 2.5)
    np.testing.assert_array_equal(p["b"][:6].numpy(), 0.0)
    assert rnn.GravesLSTM(n_out=6).param_order() == [
        "W", "RW", "b", "pI", "pF", "pO"]


def _mln_jconf(tbptt=False):
    b = (JNNC.builder().seed(3).updater(JAdam(learning_rate=1e-2))
         .weight_init(JWI.XAVIER).list()
         .layer(jrnn.Bidirectional(layer=jrnn.GravesLSTM(n_out=4)))
         .layer(jrnn.GRU(n_out=5, reset_after=True))
         .layer(jrnn.MaskZeroLayer(layer=jrnn.LSTM(n_out=6)))
         .layer(jrnn.RnnOutputLayer(n_out=3, activation=JAct.SOFTMAX)))
    if tbptt:
        b = b.backprop_type(JBP.TRUNCATED_BPTT, fwd=4, back=4)
    return b.set_input_type(JIT.recurrent(N_IN, T)).build()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seq_data(seed=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T))]
    return x, y


def test_params_convert_both_ways_and_flat_vector_matches_jax():
    """Bidirectional's f/b keys, GravesLSTM's six tensors, GRU's rb and a
    wrapper's inner layer carry over as they are; RnnOutputLayer's W is
    transposed; the flat vector is the JAX package's, bit for bit."""
    jnet = JMLN(_mln_jconf()).init()
    conf = MultiLayerConfiguration.from_json(_mln_jconf().to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    assert sorted(p["0"]) == sorted(
        [f"{d}{k}" for d in "fb" for k in ("W", "RW", "b", "pI", "pF",
                                            "pO")])
    assert tuple(p["3"]["W"].shape) == (3, 6)
    net = MultiLayerNetwork(conf, "cpu").set_params(p, s)
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    back, _ = params_to_jax(conf, net.params, net.state)
    for k, vp in _np(jnet.params).items():
        for name, v in vp.items():
            np.testing.assert_array_equal(back[k][name], v)
    x, _ = _seq_data()
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **FWD)


def test_trained_recurrent_zip_restores_in_both_packages(tmp_path):
    """A zip of a net trained with truncated BPTT in the port restores in
    the JAX package (params and counters bit for bit, the same outputs);
    the JAX package's zip of a net it trained restores in the port
    (params, updater state and counters bit for bit) and both train on
    alike. (The JAX package's own restore assigns the updater state in
    the layers' init order while its zip holds the sorted order, so a JAX
    net restored from any zip does not resume Adam right: not held.)"""
    x, y = _seq_data()
    jconf = _mln_jconf(True)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    net = MultiLayerNetwork(conf, "cpu").init()
    net.fit_batch(DataSet(x, y))
    path = tmp_path / "port.zip"
    ser.write_model(net, path)
    restored = jser.restore_multi_layer_network(path)
    np.testing.assert_array_equal(np.asarray(restored.params_flat()),
                                  net.params_flat())
    assert (restored.iteration, restored.epoch) == (
        net.iteration, net.epoch) == (T // 4, 0)
    np.testing.assert_allclose(np.asarray(restored.output(x)), net.output(x),
                               **FWD)

    jnet = JMLN(jconf).init()
    jnet.fit_batch(JDataSet(x, y))
    jpath = tmp_path / "jax.zip"
    jser.write_model(jnet, jpath)
    again = ser.restore_multi_layer_network(jpath, device="cpu")
    np.testing.assert_array_equal(again.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(
        pparams.flatten_state_like(again.conf, again.opt_state),
        jparams.flatten_state_like(_np(jnet.opt_state)))
    assert again.iteration == jnet.iteration == T // 4
    l_port = again.fit_batch(DataSet(x, y))
    l_jax = jnet.fit_batch(JDataSet(x, y))
    assert l_port == pytest.approx(l_jax, rel=1e-5)


def test_builder_defaults_reach_wrapped_layer():
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )

    conf = (NeuralNetConfiguration.builder().seed(1)
            .weight_init(WeightInit.UNIFORM).l2(0.01).list()
            .layer(rnn.Bidirectional(layer=rnn.LSTM(n_out=4)))
            .layer(rnn.LastTimeStep(layer=rnn.GRU(n_out=3)))
            .set_input_type(InputType.recurrent(3, timesteps=5))
            .build())
    for wrapper in conf.layers:
        inner = wrapper.layer
        assert inner.weight_init == WeightInit.UNIFORM
        assert any(isinstance(r, L2Regularization)
                   for r in inner.regularization)
    assert conf.layers[1].has_carry
    jconf = (JNNC.builder().seed(1).weight_init(JWI.UNIFORM).l2(0.01).list()
             .layer(jrnn.Bidirectional(layer=jrnn.LSTM(n_out=4)))
             .layer(jrnn.LastTimeStep(layer=jrnn.GRU(n_out=3)))
             .set_input_type(JIT.recurrent(3, timesteps=5)).build())
    assert serde.to_dict(conf) == jserde.to_dict(jconf)
    assert isinstance(jconf.layers[0].layer.regularization[0], JL2)


def test_wrappers_delegate_training_hyperparams():
    inner = rnn.LSTM(n_out=4, updater=Sgd(learning_rate=0.5),
                     regularization=(L2Regularization(l2=0.1),))
    for wrapper in (rnn.Bidirectional(layer=inner),
                    rnn.LastTimeStep(layer=inner),
                    rnn.MaskZeroLayer(layer=inner)):
        assert wrapper.updater is inner.updater
        assert wrapper.regularization == inner.regularization
        assert wrapper.gradient_normalization == inner.gradient_normalization
    assert rnn.Bidirectional(layer=inner).regularized_param_keys() == [
        "fW", "fRW", "bW", "bRW"]
    assert not rnn.Bidirectional(layer=inner).has_carry
    assert rnn.LastTimeStep(layer=inner).has_carry
    assert not rnn.LastTimeStep(layer=dataclasses.replace(
        rnn.Bidirectional(layer=inner))).has_carry
