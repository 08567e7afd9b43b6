"""MultiLayerNetwork training in the port against the JAX package.

Networks: the zoo's LeNet at full size (28x28x1, SAME convolutions,
1,256,080 params, Adam) and a two-layer MLP with builder-level l1 and l2
(Nesterovs), both carried into the port through the configuration JSON and
``params_from_jax``; inputs are the seeded synthetic MNIST set or numpy
draws from a seed.

Tolerances: per-step scores rtol 1e-5 (float32 forwards and backwards
summed in other orders than XLA's); params after each step rtol 1e-5 with
an absolute floor of 1e-2 of the learning rate (Adam's first steps move a
weight by about lr times the sign of its gradient, so a near-zero gradient
rounded the other way moves it up to 2 lr: the floor holds it to 1% of
that); updater state and gradients by their relative L2 norm per tensor,
1e-4 (a ReLU input within rounding of 0 takes the other side in the other
package, so elementwise comparisons of gradients are not meaningful).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import ConvolutionLayer as JConv
from deeplearning4j_tpu.conf.layers_cnn import PoolingType as JPT
from deeplearning4j_tpu.conf.layers_cnn import SubsamplingLayer as JPool
from deeplearning4j_tpu.conf.multilayer import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.mnist import (
    MnistDataSetIterator as JMnistIterator,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JCollect,
)
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
from deeplearning4j_tpu_torch.conf.multilayer import (
    BackpropType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.conf.updaters import Adam
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresListener,
    EvaluativeListener,
    PerformanceListener,
    TimeIterationListener,
)
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from deeplearning4j_tpu_torch.util.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.zoo import LeNet

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SCORE_RTOL = 1e-5
L2_RTOL = 1e-4


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet, device="cpu"):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    return MultiLayerNetwork(conf, device).set_params(p, s)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_params(net, jnet, lr, what=""):
    got, _ = params_to_jax(net.conf, net.params, net.state)
    for k, vp in _to_np(jnet.params).items():
        for pk, v in vp.items():
            np.testing.assert_allclose(got[k][pk], v, rtol=1e-5,
                                       atol=1e-2 * lr,
                                       err_msg=f"{what} {k}.{pk}")


def _assert_opt_state(net, jnet, what=""):
    got = opt_state_to_jax(net.conf, net.opt_state)
    for k, vp in _to_np(jnet.opt_state).items():
        for pk, st in vp.items():
            for sk, v in st.items():
                assert _rel_l2(got[k][pk][sk], v) <= L2_RTOL, \
                    f"{what} {k}.{pk}.{sk}"


def _mnist_batches(n, seed=0):
    it = JMnistIterator(batch=64, train=True, num_examples=n, seed=seed)
    return [(ds.features, ds.labels) for ds in it]


@pytest.fixture(scope="module")
def lenet_pair():
    jnet = JLeNet().init()
    return jnet, _port_of(jnet)


def _mlp_jconf(updater=None):
    return (JNNC.builder().seed(11)
            .updater(updater or JNesterovs(learning_rate=0.05, momentum=0.9))
            .l2(1e-3).l1(1e-4).list()
            .layer(JDense(n_out=16, activation=JAct.RELU))
            .layer(JOut(n_out=4, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(10)).build())


def _mlp_batches(steps=3, n=12, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 10)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])
            for _ in range(steps)]


def test_lenet_conf_and_params_match_the_jax_zoo():
    conf = LeNet().conf()
    jconf = JLeNet().conf()
    assert MultiLayerConfiguration.from_json(jconf.to_json()) == conf
    assert conf.to_json() == MultiLayerConfiguration.from_json(
        conf.to_json()).to_json()
    assert LeNet().init("cpu").num_params() == 1_256_080


def test_lenet_fit_batch_matches_jax_step_by_step():
    jnet = JLeNet().init()
    net = _port_of(jnet)
    batches = _mnist_batches(192)
    x0, y0 = batches[0]
    grads, score = net.compute_gradient_and_score(DataSet(x0, y0))
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(x0, y0))
    assert score == pytest.approx(jscore, rel=SCORE_RTOL)
    got, _ = params_to_jax(net.conf, grads, {})
    for k, vp in _to_np(jgrads).items():
        for pk, v in vp.items():
            assert _rel_l2(got[k][pk], v) <= L2_RTOL, f"grad {k}.{pk}"
    for step, (x, y) in enumerate(batches):
        ls = net.fit_batch(DataSet(x, y))
        lj = jnet.fit_batch(JDataSet(x, y))
        assert ls == pytest.approx(lj, rel=SCORE_RTOL), f"step {step}"
        _assert_params(net, jnet, 1e-3, f"step {step}")
        _assert_opt_state(net, jnet, f"step {step}")
        assert net.score() == pytest.approx(ls)
    ds = DataSet(*batches[-1])
    assert net.score(ds) == pytest.approx(
        jnet.score(JDataSet(*batches[-1])), rel=SCORE_RTOL)
    assert net.iteration == jnet.iteration == 3


def test_mlp_with_l1_l2_matches_jax():
    jconf = _mlp_jconf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert len(conf.layers[0].regularization) == 2
    jnet = JMLN(jconf).init()
    net = _port_of(jnet)
    batches = _mlp_batches()
    g, s = net.compute_gradient_and_score(DataSet(*batches[0]))
    jg, js = jnet.compute_gradient_and_score(JDataSet(*batches[0]))
    assert s == pytest.approx(js, rel=SCORE_RTOL)  # regularization included
    got, _ = params_to_jax(conf, g, {})
    for k, vp in _to_np(jg).items():
        for pk, v in vp.items():
            assert _rel_l2(got[k][pk], v) <= L2_RTOL
    for step, (x, y) in enumerate(batches):
        ls, lj = net.fit_batch(DataSet(x, y)), jnet.fit_batch(JDataSet(x, y))
        assert ls == pytest.approx(lj, rel=SCORE_RTOL), f"step {step}"
        _assert_params(net, jnet, 0.05, f"step {step}")
        _assert_opt_state(net, jnet, f"step {step}")
        ds = DataSet(x, y)
        assert net.score(ds) == pytest.approx(jnet.score(JDataSet(x, y)),
                                              rel=SCORE_RTOL)


def test_builder_defaults_and_backprop_type_round_trip():
    conf = (NeuralNetConfiguration.builder().l2(0.5).list()
            .gradient_checkpointing()
            .backprop_type(BackpropType.TRUNCATED_BPTT, 7, 5)
            .layer(LeNet().conf().layers[5])
            .set_input_type(LeNet().conf().layers[4].output_type(None))
            .build())
    back = MultiLayerConfiguration.from_json(conf.to_json())
    assert back == conf
    assert back.backprop_type is BackpropType.TRUNCATED_BPTT
    assert (back.tbptt_fwd_length, back.tbptt_back_length) == (7, 5)
    assert back.gradient_checkpointing
    assert back.layers[0].regularization[0].l2 == 0.5
    # truncated BPTT over 2-D (static) features takes the standard step, as
    # in the JAX package: with this conf's dense last layer both refuse it
    # as no output layer
    jnet = JMLN(JMLC.from_json(conf.to_json())).init()
    x = np.zeros((2, 2450), np.float32)
    y = np.zeros((2, 500), np.float32)
    with pytest.raises(TypeError, match="not an output layer"):
        jnet.fit(JDataSet(x, y))
    with pytest.raises(TypeError, match="not an output layer"):
        MultiLayerNetwork(conf, "cpu").fit(DataSet(x, y))


def test_gradient_checkpointing_trains_identically():
    jconf = _mlp_jconf(JAdam(learning_rate=0.01))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    remat = dataclasses.replace(conf, gradient_checkpointing=True)
    a = MultiLayerNetwork(conf, "cpu").init()
    b = MultiLayerNetwork(remat, "cpu").init()
    for x, y in _mlp_batches():
        assert a.fit_batch(DataSet(x, y)) == b.fit_batch(DataSet(x, y))
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())


def test_fused_steps_train_identically_to_single_steps():
    batches = [DataSet(x, y) for x, y in _mlp_batches(steps=7)]
    conf = MultiLayerConfiguration.from_json(_mlp_jconf().to_json())
    nets = [MultiLayerNetwork(conf, "cpu").init() for _ in range(2)]
    scores = []
    for net, k in zip(nets, (1, 3)):
        collect = CollectScoresListener()
        net.set_listeners(collect)
        net.fit(ListDataSetIterator(batches), epochs=2, fused_steps=k)
        scores.append(collect.scores)
    assert scores[0] == scores[1] and len(scores[0]) == 14
    np.testing.assert_array_equal(nets[0].params_flat(),
                                  nets[1].params_flat())
    assert nets[1].iteration == 14 and nets[1].epoch == 2
    with pytest.raises(ValueError):
        nets[0].fit(ListDataSetIterator(batches), fused_steps=0)


def test_fit_over_mnist_iterator_matches_jax_fit():
    """Two epochs of ``fit`` over the MNIST iterator, step by step. SGD,
    not the zoo's Adam: Adam divides each gradient by its own magnitude,
    so a float32 rounding difference in a near-zero gradient moves that
    weight by up to 2 lr. After these 8 steps at Adam(2e-3), 14,689 of the
    dense layer's 1,225,000 weights differ by more than 1e-3 between the
    packages and the scores by up to 1e-3 relative; under SGD the scores
    stay within 2.2e-6 (Adam's steps are held in the fit_batch test)."""
    jnet = JLeNet(updater=JSgd(learning_rate=0.05)).init()
    net = _port_of(jnet)
    kw = dict(batch=64, train=True, num_examples=256, seed=5)
    jcollect, collect = JCollect(), CollectScoresListener()
    jnet.set_listeners(jcollect)
    net.set_listeners(collect)
    jnet.fit(JMnistIterator(**kw), epochs=2)
    net.fit(MnistDataSetIterator(**kw), epochs=2)
    assert len(collect.scores) == len(jcollect.scores) == 8
    np.testing.assert_allclose(collect.scores, jcollect.scores,
                               rtol=SCORE_RTOL)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch)
    _assert_params(net, jnet, 0.05, "after fit")


def test_evaluate_matches_jax_stats(lenet_pair):
    jnet, net = lenet_pair
    kw = dict(batch=100, train=False, num_examples=300, shuffle=False)
    ev = net.evaluate(MnistDataSetIterator(**kw))
    jev = jnet.evaluate(JMnistIterator(**kw))
    assert ev.stats() == jev.stats()
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    # a DataSet migrated to the network's device evaluates the same
    moved = [ds.migrate("cpu") for ds in MnistDataSetIterator(**kw)]
    assert net.evaluate(ListDataSetIterator(moved)).stats() == ev.stats()


def test_output_batching_params_flat_and_summary(lenet_pair):
    jnet, net = lenet_pair
    x, _ = _mnist_batches(64)[0]
    whole = net.output(x)
    np.testing.assert_allclose(whole, np.asarray(jnet.output(x)), rtol=1e-4,
                               atol=1e-6)
    # chunks of 24 take other CPU convolution kernels than the batch of
    # 64: the same function, rounded differently (1.5e-8 here)
    np.testing.assert_allclose(net.output(x, batch_size=24), whole,
                               rtol=1e-6, atol=1e-7)
    flat = net.params_flat()
    assert flat.dtype == np.float32 and flat.shape == (1_256_080,)
    np.testing.assert_array_equal(flat, np.asarray(jnet.params_flat()))
    twin = LeNet().init("cpu").set_params_flat(flat)
    np.testing.assert_array_equal(twin.output(x), whole)
    with pytest.raises(ValueError, match="setParams"):
        twin.set_params_flat(flat[:-1])
    table = net.summary()
    assert table == jnet.summary()
    assert "Total params: 1,256,080" in table


def test_ff_to_cnn_preprocessor_matches_jax():
    """``InputType.convolutional_flat`` inserts FeedForwardToCnn before the
    first convolution; the flat input keeps the JAX package's NHWC
    element order."""
    jconf = (JNNC.builder().seed(4).list()
             .layer(JConv(n_out=3, kernel_size=(3, 3), activation=JAct.RELU))
             .layer(JPool(pooling_type=JPT.MAX, kernel_size=(2, 2),
                          stride=(2, 2)))
             .layer(JOut(n_out=5, activation=JAct.SOFTMAX))
             .set_input_type(JIT.convolutional_flat(8, 8, 2)).build())
    jnet = JMLN(jconf).init()
    net = _port_of(jnet)
    assert type(net.conf.layers[0]).__name__ == "FeedForwardToCnnPreProcessor"
    x = np.random.default_rng(0).random((3, 128), np.float32)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-7)
    y = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        jnet.fit_batch(JDataSet(x, y)), rel=SCORE_RTOL)


def test_lenet_mnist_learns():
    """The port's copy of ``tests/test_mnist_e2e.py::test_lenet_mnist_learns``
    (2048 synthetic examples, 4 epochs, accuracy > 0.85)."""
    train = MnistDataSetIterator(batch=64, train=True, num_examples=2048)
    test = MnistDataSetIterator(batch=256, train=False, num_examples=512,
                                shuffle=False)
    net = LeNet(updater=Adam(learning_rate=2e-3)).init("cpu")
    net.fit(train, epochs=4)
    ev = net.evaluate(test)
    assert ev.accuracy() > 0.85, ev.stats()


def test_train_step_fault_raises_out_of_fit():
    conf = MultiLayerConfiguration.from_json(_mlp_jconf().to_json())
    net = MultiLayerNetwork(conf, "cpu").init()
    plan = FaultPlan().inject("train.step", on_calls=[2])
    with plan.armed():
        with pytest.raises(InjectedFault):
            net.fit(ListDataSetIterator(
                [DataSet(x, y) for x, y in _mlp_batches()]))
    assert plan.fired("train.step") == 1
    assert net.iteration == 1  # the first step ran, the second raised


def test_listeners_run_during_fit(capsys):
    conf = MultiLayerConfiguration.from_json(_mlp_jconf().to_json())
    net = MultiLayerNetwork(conf, "cpu").init()
    batches = ListDataSetIterator([DataSet(x, y) for x, y in _mlp_batches()])
    perf = PerformanceListener(frequency=1)
    evl = EvaluativeListener(batches, frequency=1)
    net.set_listeners(perf, TimeIterationListener(3, frequency=1), evl)
    net.fit(batches, epochs=2)
    out = capsys.readouterr().out
    assert "batches/sec" in out and "Remaining time" in out
    assert perf.last_examples_per_sec > 0 and net.last_batch_size == 12
    assert evl.last_evaluation is not None
    assert 0.0 <= evl.last_evaluation.accuracy() <= 1.0


def test_scores_stay_on_the_device_until_read():
    conf = MultiLayerConfiguration.from_json(_mlp_jconf().to_json())
    net = MultiLayerNetwork(conf, "cpu").init()
    seen = []

    class Keep(CollectScoresListener):
        def iteration_done(self, model, iteration, epoch, score):
            seen.append(score)

    net.set_listeners(Keep())
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in _mlp_batches()]))
    assert all(isinstance(s, torch.Tensor) and s.ndim == 0 for s in seen)
    assert net.score() == float(seen[-1])


def test_updater_state_from_jax_resumes_training():
    """A JAX MLN takes one Adam step; the port takes its params, Adam m/v
    (``opt_state_from_jax`` on a MultiLayerNetwork's layer-index keys) and
    iteration, and its next step lands where the JAX package's does."""
    from deeplearning4j_tpu_torch.util.convert import opt_state_from_jax

    jnet = JMLN(_mlp_jconf(JAdam(learning_rate=0.01))).init()
    (x0, y0), (x1, y1) = _mlp_batches(steps=2)
    jnet.fit_batch(JDataSet(x0, y0))
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    net = MultiLayerNetwork(conf, "cpu").set_params(
        p, s, opt_state_from_jax(conf, _to_np(jnet.opt_state)))
    net.iteration = jnet.iteration
    fresh = MultiLayerNetwork(conf, "cpu").set_params(p, s)
    fresh.iteration = jnet.iteration
    assert net.fit_batch(DataSet(x1, y1)) == pytest.approx(
        jnet.fit_batch(JDataSet(x1, y1)), rel=SCORE_RTOL)
    fresh.fit_batch(DataSet(x1, y1))
    _assert_params(net, jnet, 0.01, "resumed")
    _assert_opt_state(net, jnet, "resumed")
    assert np.abs(fresh.params_flat() - net.params_flat()).max() > 1e-3
