"""Early stopping in the port against the JAX package's trainer.

Both packages train the JAX tests' three-layer MLP (4 -> 8 tanh -> 6 relu
-> 3, the port's on the JAX network's params) on the same seeded batches
under the same configuration; the results must agree: the termination
reason, the epochs run, the best epoch, ``score_vs_epoch`` and the
termination details (their text exactly, every number in them at rtol
1e-5: float32 losses summed in other orders than XLA's), and the best
model's score. Also: the savers, the conditions' resets and the
NaN-safe score conditions. ``DivergenceTerminationCondition`` is held in
``test_torch_health.py``.
"""

import os
import re

import numpy as np
import pytest

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JArrayIt,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-5
_NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+e[-+]?\d+")


def _jconf(updater=None, classes=3):
    return (JNNC.builder().seed(12345)
            .updater(updater or JAdam(1e-2))
            .list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JDense(n_out=6, activation=JAct.RELU))
            .layer(JOut(n_out=classes, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4))
            .build())


def _xy(n=48, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _pair(updater=None):
    import jax

    jnet = JMLN(_jconf(updater)).init()
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s), jnet


def _its(x, y, batch=16):
    return ArrayDataSetIterator(x, y, batch), JArrayIt(x, y, batch=batch)


def _same_details(a: str, b: str):
    """The same text, every number in it at rtol 1e-5."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    for u, v in zip(_NUM.findall(a), _NUM.findall(b)):
        assert float(u) == pytest.approx(float(v), rel=RTOL), (a, b)


def _same_result(r, jr):
    assert r.termination_reason.value == jr.termination_reason.value
    _same_details(r.termination_details, jr.termination_details)
    assert r.total_epochs == jr.total_epochs
    assert r.best_model_epoch == jr.best_model_epoch
    assert sorted(r.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, v in jr.score_vs_epoch.items():
        assert r.score_vs_epoch[e] == pytest.approx(float(v), rel=RTOL)
    assert r.best_model_score == pytest.approx(float(jr.best_model_score),
                                               rel=RTOL)


def _run_both(updater, make_cfg, x=None, y=None):
    """Fit the pair under the configuration ``make_cfg(port_module,
    validation_iterators)`` builds for each package."""
    if x is None:
        x, y = _xy()
    net, jnet = _pair(updater)
    it, jit_ = _its(x, y)
    vit, jvit = _its(x, y)
    r = es.EarlyStoppingTrainer(make_cfg(es, vit), net, it).fit()
    jr = jes.EarlyStoppingTrainer(make_cfg(jes, jvit), jnet, jit_).fit()
    _same_result(r, jr)
    return r, jr


def test_max_epochs_with_a_local_file_saver_matches_jax(tmp_path):
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(4)],
            score_calculator=m.DataSetLossCalculator(vit),
            model_saver=m.LocalFileModelSaver(
                str(tmp_path / m.__name__.split(".")[0])))

    r, _ = _run_both(JAdam(1e-2), cfg)
    assert r.termination_reason is es.TerminationReason.EPOCH
    assert r.total_epochs == 4 and r.best_model_epoch >= 0
    assert os.path.exists(tmp_path / "deeplearning4j_tpu_torch"
                          / "bestModel.zip")
    best = r.get_best_model()
    assert isinstance(best, MultiLayerNetwork) and best.device.type == "cpu"
    x, y = _xy()
    calc = es.DataSetLossCalculator(ArrayDataSetIterator(x, y, 16))
    assert abs(calc.calculate_score(best) - r.best_model_score) < 1e-4


def test_patience_matches_jax():
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                m.ScoreImprovementEpochTerminationCondition(2),
                m.MaxEpochsTerminationCondition(50)],
            score_calculator=m.DataSetLossCalculator(vit))

    r, _ = _run_both(JSgd(0.0), cfg)  # lr 0: never improves
    assert r.total_epochs < 50
    assert "ScoreImprovement" in r.termination_details


def test_iteration_condition_matches_jax():
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(100)],
            iteration_termination_conditions=[
                m.MaxScoreIterationTerminationCondition(1e-9),
                m.InvalidScoreIterationTerminationCondition()])

    r, _ = _run_both(JAdam(1e-2), cfg)
    assert r.termination_reason is es.TerminationReason.ITERATION


def test_classification_score_and_in_memory_saver_match_jax():
    """Accuracy (negated) as the score, the best model kept in memory and
    rebuilt on the network's device."""
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                m.ScoreImprovementEpochTerminationCondition(1),
                m.MaxEpochsTerminationCondition(6)],
            score_calculator=m.ClassificationScoreCalculator(vit))

    r, jr = _run_both(JAdam(5e-2), cfg)
    best = r.get_best_model()
    assert isinstance(best, MultiLayerNetwork) and best.device.type == "cpu"
    x, y = _xy()
    acc = best.evaluate(ArrayDataSetIterator(x, y, 16)).accuracy()
    assert -acc == pytest.approx(r.best_model_score)
    assert -float(jr.get_best_model().evaluate(
        JArrayIt(x, y, batch=16)).accuracy()) == pytest.approx(
        r.best_model_score)


def test_eval_frequency_respects_patience_like_jax():
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            evaluate_every_n_epochs=3,
            epoch_termination_conditions=[
                m.ScoreImprovementEpochTerminationCondition(1),
                m.MaxEpochsTerminationCondition(30)],
            score_calculator=m.DataSetLossCalculator(vit))

    r, _ = _run_both(JSgd(0.0), cfg)
    # evaluations at epochs 0, 3, 6: patience 1 stops on the third
    assert r.total_epochs == 7
    assert sorted(r.score_vs_epoch) == [0, 3, 6]


def test_score_from_the_network_without_a_calculator_matches_jax():
    def cfg(m, vit):
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(3)])

    r, _ = _run_both(JAdam(1e-2), cfg)
    assert sorted(r.score_vs_epoch) == [0, 1, 2]


def test_validates_config():
    net, _ = _pair()
    x, y = _xy()
    with pytest.raises(ValueError, match="termination"):
        es.EarlyStoppingTrainer(es.EarlyStoppingConfiguration(), net,
                                ArrayDataSetIterator(x, y, 16)).fit()


def test_conditions_reset_between_fits():
    x, y = _xy()
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            es.ScoreImprovementEpochTerminationCondition(1),
            es.MaxEpochsTerminationCondition(10)],
        score_calculator=es.DataSetLossCalculator(
            ArrayDataSetIterator(x, y, 16)))
    totals = []
    for _ in range(2):  # reusing cfg must not carry _best / _bad over
        net, _ = _pair(JSgd(0.0))
        result = es.EarlyStoppingTrainer(
            cfg, net, ArrayDataSetIterator(x, y, 16)).fit()
        totals.append(result.total_epochs)
    assert totals[0] == totals[1] >= 2


def test_score_conditions_stop_on_a_non_finite_score():
    cond = es.ScoreImprovementEpochTerminationCondition(5)
    cond.initialize()
    assert not cond.terminate(0, 1.0)
    assert cond.terminate(1, float("nan"))
    assert "non-finite" in cond.last_reason
    cond.initialize()  # not one bad epoch of the patience window
    for e in range(4):
        assert not cond.terminate(e, 1.0 - 0.1 * e)
    best = es.BestScoreEpochTerminationCondition(0.1)
    best.initialize()
    assert not best.terminate(0, 0.5)
    assert best.terminate(1, float("inf"))
    assert "non-finite" in best.last_reason
    assert best.terminate(2, 0.05) and "reached target" in best.last_reason


def test_iteration_conditions():
    assert es.InvalidScoreIterationTerminationCondition().terminate(
        float("inf"))
    assert not es.MaxScoreIterationTerminationCondition(2.0).terminate(1.5)
    assert es.MaxScoreIterationTerminationCondition(2.0).terminate(2.5)
    cond = es.MaxTimeIterationTerminationCondition(0.0)
    cond.initialize()
    cond.terminate(1.0)
    import time

    time.sleep(0.01)
    assert cond.terminate(1.0)
