"""Truncated BPTT and ``rnn_time_step`` in the port against the JAX
package, on the CPU.

Networks (MultiLayerNetwork and ComputationGraph, small widths: LSTM 8,
GravesLSTM 6, GRU 8, T <= 24) are built from the JAX configuration's JSON
and the JAX network's params (``params_from_jax``), so both packages train
the same function from the same weights on numpy batches drawn from a
seed. Held: every ``fit_batch`` score (the mean of the segment losses),
params after the updates, the iteration counter (one step a segment), the
listeners' calls; ``back < fwd`` (the no-gradient head), the padding of a T
that is not a multiple of the segment (left-aligned tail when ``back <
fwd``), ``go_backwards`` layers' per-segment reset, ``rnn_time_step``
chunks and single steps against the JAX package's, the previous-state API,
the JAX package's refusals, the bf16 case of the JAX package's
``tests/test_mixed_precision.py`` (``test_bf16_policy_tbptt_and_streaming``),
and ``TextGenerationLSTM(layer_size=16, total_unique_characters=11)``
trained and sampled as the slice end to end.

Tolerances: scores rtol 1e-5; params rtol 1e-5 with an absolute floor of
1e-2 of the learning rate (``test_torch_mln_training.py``'s: Adam moves a
weight whose gradient rounds to the other sign 2 lr); streamed outputs
rtol 1e-5, atol 1e-6 (float32 steps summed in other orders). bfloat16:
the first score and the streamed outputs within 2e-2 of the JAX package's
(bf16 rounds at other points in the two frameworks: a few bf16 ulps).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import layers_rnn as jrnn
from deeplearning4j_tpu.conf.graph import AttentionVertex as JAttV
from deeplearning4j_tpu.conf.graph import MergeVertex as JMerge
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.multilayer import BackpropType as JBP
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JCollect,
)
from deeplearning4j_tpu.zoo.models import TextGenerationLSTM as JText
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.util.convert import params_from_jax
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

LR = 1e-2
SCORE_RTOL = 1e-5
PARAMS = dict(rtol=1e-5, atol=1e-2 * LR)
OUT = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 2e-2
N, F_IN, CLASSES = 4, 3, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mln_jconf(fwd, back, t, layers=None, bp=JBP.TRUNCATED_BPTT, **kw):
    b = JNNC.builder().seed(3).updater(JAdam(learning_rate=LR))
    if kw.get("compute_dtype"):
        b = b.compute_dtype(kw["compute_dtype"])
    b = b.list()
    for layer in layers or (jrnn.LSTM(n_out=8), jrnn.GravesLSTM(n_out=6)):
        b = b.layer(layer)
    return (b.layer(jrnn.RnnOutputLayer(n_out=CLASSES,
                                        activation=JAct.SOFTMAX))
            .backprop_type(bp, fwd=fwd, back=back)
            .set_input_type(JIT.recurrent(F_IN, t)).build())


def _mln_pair(jconf):
    """The JAX network and the port's on the same weights (CPU)."""
    jnet = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return jnet, MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _data(t, seed=0, mask=None, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, F_IN)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (n, t))]
    m = None
    if mask is not None:
        lens = np.asarray([t, t - 3, t // 2, 2])[:, None]
        pos = np.arange(t)[None, :]
        m = (pos < lens if mask == "start" else pos >= t - lens)
        m = m.astype(np.float32)
    return x, y, m


def _fit_both(jnet, net, batches):
    for x, y, m in batches:
        lj = jnet.fit_batch(JDataSet(x, y, features_mask=m, labels_mask=m))
        lp = net.fit_batch(DataSet(x, y, features_mask=m, labels_mask=m))
        assert lp == pytest.approx(lj, rel=SCORE_RTOL)
    assert net.iteration == jnet.iteration
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), **PARAMS)


@pytest.mark.parametrize("fwd,back,t,mask", [
    (5, 5, 20, None),       # 4 segments
    (5, 5, 23, "start"),    # the tail right-padded
    (6, 3, 17, "end"),      # back < fwd: the tail left-aligned in its window
    (4, 2, 16, "start"),    # back < fwd, no padding
    (20, 20, 20, None),     # one segment
])
def test_mln_tbptt_matches_jax(fwd, back, t, mask):
    jnet, net = _mln_pair(_mln_jconf(fwd, back, t))
    _fit_both(jnet, net, [_data(t, seed=s, mask=mask) for s in (0, 1)])
    assert net.iteration == 2 * -(-t // fwd)
    assert len(net.last_segment_losses) == -(-t // fwd)


def test_tbptt_one_segment_is_standard_backprop():
    """tBPTT with fwd = back = T trains the standard step's function."""
    x, y, _ = _data(12, seed=2)
    jconf = _mln_jconf(12, 12, 12)
    _, a = _mln_pair(jconf)
    conf_std = dataclasses.replace(a.conf, backprop_type=BackpropType.STANDARD)
    b = MultiLayerNetwork(conf_std, "cpu").set_params(a.params, a.state)
    la, lb = a.fit_batch(DataSet(x, y)), b.fit_batch(DataSet(x, y))
    assert la == pytest.approx(lb, rel=1e-6)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(), rtol=1e-6,
                               atol=1e-7)


def test_tbptt_on_static_features_is_the_standard_step():
    """2-D features under a tBPTT conf train the standard step, as in the
    JAX package."""
    jconf = (JNNC.builder().seed(1).updater(JAdam(learning_rate=LR)).list()
             .layer(JDense(n_out=5, activation=JAct.TANH))
             .layer(jrnn.RnnOutputLayer(n_out=3, activation=JAct.SOFTMAX))
             .backprop_type(JBP.TRUNCATED_BPTT, fwd=4, back=4)
             .set_input_type(JIT.feed_forward(6)).build())
    jnet, net = _mln_pair(jconf)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    _fit_both(jnet, net, [(x, y, None)])
    assert net.iteration == 1


@pytest.mark.parametrize("t", [12, 14])
def test_go_backwards_layers_reset_every_segment(t):
    """A go_backwards LSTM and a Bidirectional GRU under tBPTT: each
    segment restarts them from zeros, as in the JAX package."""
    layers = (jrnn.LSTM(n_out=6, go_backwards=True),
              jrnn.Bidirectional(layer=jrnn.GRU(n_out=4)),
              jrnn.LSTM(n_out=5))
    jnet, net = _mln_pair(_mln_jconf(4, 4, t, layers=layers))
    _fit_both(jnet, net, [_data(t, seed=4, mask="start")])


def test_listeners_see_one_call_a_batch():
    jnet, net = _mln_pair(_mln_jconf(5, 5, 20))
    jc, pc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(pc)
    batches = [_data(20, seed=s) for s in (5, 6)]
    jnet.fit(_jax_iterator(batches))
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y, _ in batches]))
    assert pc.iterations == jc.iterations == [3, 7]
    np.testing.assert_allclose(pc.scores, jc.scores, rtol=SCORE_RTOL)


def _jax_iterator(batches):
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JList,
    )

    return JList([JDataSet(x, y) for x, y, _ in batches])


def test_rnn_time_step_matches_jax():
    """Chunks of 5 and 3 steps, then single 2-D steps: outputs, the
    carries (get / set / clear) and the restart after a clear."""
    jnet, net = _mln_pair(_mln_jconf(5, 5, 20))
    x, _, _ = _data(12, seed=7)
    for sl in (slice(0, 5), slice(5, 8)):
        np.testing.assert_allclose(net.rnn_time_step(x[:, sl]),
                                   np.asarray(jnet.rnn_time_step(x[:, sl])),
                                   **OUT)
    for t in (8, 9):
        got = net.rnn_time_step(x[:, t])
        want = np.asarray(jnet.rnn_time_step(x[:, t]))
        assert got.shape == want.shape == (N, 1, CLASSES)
        np.testing.assert_allclose(got, want, **OUT)
    for i in (0, 1):
        got, want = net.rnn_get_previous_state(i), \
            jnet.rnn_get_previous_state(i)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **OUT)
    assert net.rnn_get_previous_state(2) is None
    # the streamed outputs equal one full forward
    net.rnn_clear_previous_state()
    streamed = np.concatenate([net.rnn_time_step(x[:, :7]),
                               net.rnn_time_step(x[:, 7:])], axis=1)
    np.testing.assert_allclose(streamed, net.output(x), **OUT)
    # a state set from numpy resumes the stream
    saved = {i: {k: v.numpy() for k, v in
                 net.rnn_get_previous_state(i).items()} for i in (0, 1)}
    tail = net.rnn_time_step(x[:, :2])
    net.rnn_clear_previous_state()
    for i, s in saved.items():
        net.rnn_set_previous_state(i, s)
    np.testing.assert_array_equal(net.rnn_time_step(x[:, :2]), tail)


def test_rnn_time_step_with_mask_matches_jax():
    jnet, net = _mln_pair(_mln_jconf(5, 5, 20))
    x, _, m = _data(10, seed=8, mask="end")
    for sl in (slice(0, 6), slice(6, 10)):
        np.testing.assert_allclose(
            net.rnn_time_step(x[:, sl], fmask=m[:, sl]),
            np.asarray(jnet.rnn_time_step(x[:, sl], fmask=m[:, sl])), **OUT)


def _cg_jconf(fwd, back, t):
    return (JNNC.builder().seed(5).updater(JAdam(learning_rate=LR))
            .graph_builder()
            .add_inputs("a", "b")
            .set_input_types(JIT.recurrent(F_IN, t), JIT.recurrent(2, t))
            .add_layer("la", jrnn.LSTM(n_out=8), "a")
            .add_layer("lb", jrnn.GRU(n_out=4, reset_after=True), "b")
            .add_vertex("m", JMerge(), "la", "lb")
            .add_vertex("att", JAttV(n_out=8, n_heads=2, causal=True,
                                     streaming_window=32), "m", "m", "m")
            .add_layer("bi", jrnn.Bidirectional(layer=jrnn.SimpleRnn(
                n_out=4)), "att")
            .add_layer("out", jrnn.RnnOutputLayer(
                n_out=CLASSES, activation=JAct.SOFTMAX), "bi")
            .set_outputs("out")
            .backprop_type(JBP.TRUNCATED_BPTT, fwd=fwd, back=back)
            .build())


def _cg_pair(jconf):
    jnet = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return jnet, ComputationGraph(conf, "cpu").set_params(p, s)


def _cg_data(t, seed, mask=None):
    x, y, m = _data(t, seed=seed, mask=mask)
    b = np.random.default_rng(seed + 100).standard_normal(
        (N, t, 2)).astype(np.float32)
    return [x, b], [y], (None if m is None else [m, m]), \
        (None if m is None else [m])


@pytest.mark.parametrize("fwd,back,t,mask", [
    (4, 4, 12, None), (5, 3, 13, "start"), (12, 12, 12, "end")])
def test_graph_tbptt_matches_jax(fwd, back, t, mask):
    """Two sequence inputs, an LSTM and a GRU merged, a streaming
    AttentionVertex (its key/value window threads across segments), a
    Bidirectional layer (per-segment), a per-step softmax head."""
    jnet, net = _cg_pair(_cg_jconf(fwd, back, t))
    for seed in (0, 1):
        f, lab, fm, lm = _cg_data(t, seed, mask)
        lj = jnet.fit_batch(JMDS(features=f, labels=lab, features_masks=fm,
                                 labels_masks=lm))
        lp = net.fit_batch(MultiDataSet(features=f, labels=lab,
                                        features_masks=fm, labels_masks=lm))
        assert lp == pytest.approx(lj, rel=SCORE_RTOL)
    assert net.iteration == jnet.iteration == 2 * -(-t // fwd)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), **PARAMS)


def test_graph_rnn_time_step_matches_jax():
    """The graph's carries: the LSTM, the GRU and the streaming
    AttentionVertex's window, by vertex name (the Bidirectional vertex
    refuses streaming, so the graph streams without it)."""
    jconf = (JNNC.builder().seed(6).graph_builder()
             .add_inputs("a")
             .set_input_types(JIT.recurrent(F_IN, 12))
             .add_layer("la", jrnn.LSTM(n_out=8), "a")
             .add_vertex("att", JAttV(n_out=8, n_heads=2, causal=True,
                                      streaming_window=6), "la", "la", "la")
             .add_layer("g", jrnn.GRU(n_out=5), "att")
             .add_layer("out", jrnn.RnnOutputLayer(
                 n_out=CLASSES, activation=JAct.SOFTMAX), "g")
             .set_outputs("out").build())
    jnet, net = _cg_pair(jconf)
    x, _, _ = _data(12, seed=9)
    for sl in (slice(0, 4), slice(4, 9)):
        np.testing.assert_allclose(net.rnn_time_step(x[:, sl]),
                                   np.asarray(jnet.rnn_time_step(x[:, sl])),
                                   **OUT)
    np.testing.assert_allclose(net.rnn_time_step(x[:, 9]),
                               np.asarray(jnet.rnn_time_step(x[:, 9])),
                               **OUT)
    for name in ("la", "att", "g"):
        got, want = net.rnn_get_previous_state(name), \
            jnet.rnn_get_previous_state(name)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **OUT)
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state("la") is None


# --- refusals (the JAX package's) -----------------------------------------

def test_sequence_level_labels_are_refused():
    _, net = _mln_pair(_mln_jconf(5, 5, 10))
    x, _, _ = _data(10)
    with pytest.raises(ValueError, match="per-timestep labels"):
        net.fit_batch(DataSet(x, np.eye(CLASSES, dtype=np.float32)[[0] * N]))
    _, g = _cg_pair(_cg_jconf(4, 4, 8))
    f, _, _, _ = _cg_data(8, 0)
    with pytest.raises(ValueError, match="per-timestep labels"):
        g.fit_batch(MultiDataSet(features=f, labels=[
            np.eye(CLASSES, dtype=np.float32)[[0] * N]]))


def test_fused_steps_with_tbptt_are_refused():
    jnet, net = _mln_pair(_mln_jconf(5, 5, 10))
    x, y, _ = _data(10)
    with pytest.raises(ValueError, match="fused_steps"):
        jnet.fit(JDataSet(x, y), fused_steps=2)
    with pytest.raises(ValueError, match="fused_steps"):
        net.fit(DataSet(x, y), fused_steps=2)
    net.fit(DataSet(x, y), fused_steps=1)  # K = 1 is the plain fit
    assert net.iteration == 2


def test_graph_refuses_mismatched_lengths_mixed_inputs_and_masks():
    _, g = _cg_pair(_cg_jconf(4, 4, 8))
    f, lab, _, _ = _cg_data(8, 0)
    with pytest.raises(ValueError, match="time length"):
        g.fit_batch(MultiDataSet(features=[f[0], f[1][:, :6]], labels=lab))
    with pytest.raises(ValueError, match="INPUT rate"):
        g.fit_batch(MultiDataSet(features=f, labels=lab,
                                 labels_masks=[np.ones((N, 5), np.float32)]))
    mixed = (JNNC.builder().seed(1).graph_builder()
             .add_inputs("s", "v")
             .set_input_types(JIT.recurrent(3, 8), JIT.feed_forward(4))
             .add_layer("rnn", jrnn.SimpleRnn(n_out=6), "s")
             .add_layer("d", JDense(n_out=6), "v")
             .add_layer("out", jrnn.RnnOutputLayer(n_out=2), "rnn")
             .set_outputs("out")
             .backprop_type(JBP.TRUNCATED_BPTT, fwd=4, back=4).build())
    _, g = _cg_pair(mixed)
    rng = np.random.default_rng(0)
    s = rng.standard_normal((2, 8, 3)).astype(np.float32)
    v = rng.standard_normal((2, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 8))]
    with pytest.raises(ValueError, match="every network input"):
        g.fit_batch(MultiDataSet(features=[s, v], labels=[y]))


@pytest.mark.parametrize("layer,match", [
    (jrnn.LSTM(n_out=4, go_backwards=True), "go_backwards"),
    (jrnn.Bidirectional(layer=jrnn.LSTM(n_out=4)), "Bidirectional"),
    (jrnn.LastTimeStep(layer=jrnn.Bidirectional(layer=jrnn.LSTM(n_out=4))),
     "Bidirectional"),
])
def test_streaming_refuses_what_jax_refuses(layer, match):
    jconf = _mln_jconf(5, 5, 10, layers=(layer, jrnn.LSTM(n_out=4))) \
        if not isinstance(layer, jrnn.LastTimeStep) else \
        (JNNC.builder().seed(1).list().layer(layer)
         .layer(JDense(n_out=2))
         .set_input_type(JIT.recurrent(3, 5)).build())
    jnet, net = _mln_pair(jconf)
    f = 3 if isinstance(layer, jrnn.LastTimeStep) else F_IN
    x = np.zeros((2, 5, f), np.float32)
    with pytest.raises(RuntimeError, match=match):
        jnet.rnn_time_step(x)
    with pytest.raises(RuntimeError, match=match):
        net.rnn_time_step(x)


def test_streaming_refuses_graves_bidirectional_lstm():
    """``GravesBidirectionalLSTM`` is a Bidirectional layer: the port
    refuses to stream it. (The JAX package's guard matches the class name
    ``Bidirectional`` only and runs the subclass chunk by chunk, whose
    backward direction then sees only each chunk.)"""
    from deeplearning4j_tpu.conf.layers_extra import (
        GravesBidirectionalLSTM as JGBL,
    )

    _, net = _mln_pair(_mln_jconf(5, 5, 10, layers=(JGBL(n_out=4),)))
    with pytest.raises(RuntimeError, match="Bidirectional"):
        net.rnn_time_step(np.zeros((2, 5, F_IN), np.float32))


def test_graph_streaming_refuses_go_backwards():
    jconf = (JNNC.builder().seed(1).graph_builder()
             .add_inputs("a").set_input_types(JIT.recurrent(3, 6))
             .add_layer("r", jrnn.GRU(n_out=4, go_backwards=True), "a")
             .add_layer("out", jrnn.RnnOutputLayer(n_out=2), "r")
             .set_outputs("out").build())
    jnet, net = _cg_pair(jconf)
    x = np.zeros((2, 2, 3), np.float32)
    for model in (jnet, net):
        with pytest.raises(RuntimeError, match="go_backwards"):
            model.rnn_time_step(x)


# --- bf16 and the slice end to end ----------------------------------------

def test_bf16_policy_tbptt_and_streaming():
    """The JAX package's ``test_bf16_policy_tbptt_and_streaming`` on the
    port, held to the JAX package's bf16 run as well: the loss falls over
    20 steps, streaming returns float32, carries live in bf16 and read
    back as float32."""
    jconf = _mln_jconf(5, 5, 20, layers=(jrnn.LSTM(n_out=16),),
                       compute_dtype="bfloat16")
    jnet, net = _mln_pair(jconf)
    rng = np.random.default_rng(0)
    ds = (rng.normal(size=(4, 20, 3)).astype(np.float32),
          np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 20))])
    l0 = net.fit_batch(DataSet(*ds))
    l0_jax = jnet.fit_batch(JDataSet(*ds))
    assert l0 == pytest.approx(l0_jax, rel=BF16_RTOL)
    for _ in range(20):
        loss = net.fit_batch(DataSet(*ds))
    assert loss < l0
    for vp in net.params.values():
        for v in vp.values():
            assert v.dtype == torch.float32
    x = rng.normal(size=(4, 2, 3)).astype(np.float32)
    y = net.rnn_time_step(x)
    assert y.dtype == np.float32 and y.shape == (4, 2, 4)
    assert net._rnn_carries["0"]["h"].dtype == torch.bfloat16
    assert net.rnn_get_previous_state(0)["h"].dtype == torch.float32
    # the same weights streamed by both packages
    jnet2, net2 = _mln_pair(jconf)
    np.testing.assert_allclose(net2.rnn_time_step(x),
                               np.asarray(jnet2.rnn_time_step(x)),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


def test_text_generation_lstm_trained_and_sampled():
    """The zoo's TextGenerationLSTM at narrow width: the same conf JSON as
    the JAX zoo's, tBPTT 10/10 over two batches of T 30 against the JAX
    package, then a 5-character prime and 10 greedy one-character steps
    streamed by both (the same characters, the same outputs), and the
    stream against one full forward."""
    vocab, t = 11, 30
    jzoo = JText(layer_size=16, total_unique_characters=vocab)
    zoo = TextGenerationLSTM(layer_size=16, total_unique_characters=vocab)
    assert zoo.conf().to_json() == jzoo.conf().to_json()
    jconf = dataclasses.replace(jzoo.conf(),
                                backprop_type=JBP.TRUNCATED_BPTT,
                                tbptt_fwd_length=10, tbptt_back_length=10)
    jnet, net = _mln_pair(jconf)
    assert net.num_params() == sum(int(np.size(v)) for vp in
                                   _np(jnet.params).values()
                                   for v in vp.values())
    rng = np.random.default_rng(11)
    eye = np.eye(vocab, dtype=np.float32)
    for _ in range(2):
        chars = rng.integers(0, vocab, (N, t + 1))
        lj = jnet.fit_batch(JDataSet(eye[chars[:, :-1]], eye[chars[:, 1:]]))
        lp = net.fit_batch(DataSet(eye[chars[:, :-1]], eye[chars[:, 1:]]))
        assert lp == pytest.approx(lj, rel=SCORE_RTOL)
    assert net.iteration == jnet.iteration == 6
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=1e-5,
                               atol=1e-2 * 1e-3)
    prime = rng.integers(0, vocab, (N, 5))
    outs, jouts = [net.rnn_time_step(eye[prime])], \
        [np.asarray(jnet.rnn_time_step(eye[prime]))]
    fed = []
    c = outs[-1][:, -1].argmax(-1)
    for _ in range(10):
        fed.append(c)
        outs.append(net.rnn_time_step(eye[c]))
        jouts.append(np.asarray(jnet.rnn_time_step(eye[c])))
        assert (jouts[-1][:, 0].argmax(-1) == outs[-1][:, 0].argmax(-1)).all()
        c = outs[-1][:, 0].argmax(-1)
    streamed = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1), **OUT)
    full = net.output(eye[np.concatenate([prime, np.stack(fed, 1)], 1)])
    assert streamed.shape == (N, 15, vocab)
    np.testing.assert_allclose(streamed, full, **OUT)
