"""``resilience/session.py::TrainingSession`` in the port against the JAX
package's.

Networks: the JAX tests' MLP (4 -> 9 relu -> 3 softmax) on six seeded
batches of 8 rows, built from the JAX configuration's JSON on the JAX
network's params, on the CPU. Within the port a killed and resumed run
is held to the uninterrupted run bit for bit (params and updater state,
Adam), as the JAX package holds its own. Across the packages the final
params of the same interrupted session (SGD, so an update is the
gradient times the rate) agree at rtol 1e-5 (float32 sums in other
orders than XLA's), and ``session.json`` has the JAX manifest's keys.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.resilience.faults import FaultPlan as JFaultPlan
from deeplearning4j_tpu.resilience.session import (
    TrainingSession as JTrainingSession,
)
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.resilience import (
    FaultPlan,
    InjectedFault,
    PreemptionError,
    TrainingSession,
)
from deeplearning4j_tpu_torch.telemetry import REGISTRY
from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

RTOL = 1e-5


def _jconf(updater="adam", seed=11):
    upd = JAdam(0.01) if updater == "adam" else JSgd(0.1)
    return (JNNC.builder().seed(seed).updater(upd).list()
            .layer(JDense(n_out=9, activation=JAct.RELU))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())


def _pair(updater="adam"):
    jconf = _jconf(updater)
    jnet = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s), jnet


def _net(updater="adam"):
    return _pair(updater)[0]


def _batches(seed=0, n_batches=6, rows=8):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n_batches)]


def _iterator():
    return ListDataSetIterator([DataSet(x, y) for x, y in _batches()])


def _flat(net):
    return net.params_flat()


def _opt_flat(net):
    return params_util.flatten_state_like(net.conf, net.opt_state)


def _counter(name, **labels):
    key = name + "{" + ",".join(f'{k}="{v}"' for k, v in
                                sorted(labels.items())) + "}"
    return REGISTRY.snapshot(run_collectors=False).get(key, 0.0)


_BASE = {}


def _baseline(epochs=2):
    if epochs not in _BASE:
        net = _net()
        net.fit(_iterator(), epochs=epochs)
        _BASE[epochs] = (_flat(net), _opt_flat(net))
    return _BASE[epochs]


@pytest.mark.parametrize("kill_at", [1, 2, 3, 5, 6, 7, 12])
def test_killed_training_resumes_bit_identical(tmp_path, kill_at):
    """A fault at ``train.step`` call ``kill_at``: the session resumes from
    its last snapshot and ends on the uninterrupted run's params and
    updater state, bit for bit."""
    ref_params, ref_opt = _baseline()
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    before = _counter("dl4j_resumes_total", scope="job")
    plan = FaultPlan(seed=1).inject("train.step", on_calls=[kill_at])
    with plan.armed():
        sess.fit(_iterator(), epochs=2)
    assert plan.fired("train.step") == 1
    assert _counter("dl4j_resumes_total", scope="job") - before == 1
    assert sess.model.epoch == 2 and sess.model.iteration == 12
    np.testing.assert_array_equal(_flat(sess.model), ref_params)
    np.testing.assert_array_equal(_opt_flat(sess.model), ref_opt)


def test_preemption_error_is_resumable(tmp_path):
    ref_params, _ = _baseline()
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    plan = FaultPlan().inject("train.step", on_calls=[4],
                              exc=lambda: PreemptionError("preempted"))
    with plan.armed():
        sess.fit(_iterator(), epochs=2)
    assert sess.restarts == 1
    np.testing.assert_array_equal(_flat(sess.model), ref_params)


def test_a_kernel_error_is_not_resumable(tmp_path):
    """A kernel that fails to build or launch raises RuntimeError: the
    default resumable tuple lets it end the fit, so no resume hides it."""
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    plan = FaultPlan().inject(
        "train.step", on_calls=[2],
        exc=lambda: RuntimeError("matmul_bias_act launch failed"))
    with plan.armed():
        with pytest.raises(RuntimeError, match="launch failed"):
            sess.fit(_iterator(), epochs=1)
    assert sess.restarts == 0


def test_resume_after_process_death_from_directory_alone(tmp_path):
    ref_params, ref_opt = _baseline()
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, max_restarts=0)
    plan = FaultPlan().inject("train.step", on_calls=[3])
    with plan.armed():
        with pytest.raises(InjectedFault):
            sess.fit(_iterator(), epochs=2)
    revived = TrainingSession(None, str(tmp_path),
                              snapshot_every_n_iterations=2, device="cpu")
    model = revived.resume()
    assert model.iteration == 2  # the iter-2 snapshot, not a fresh net
    revived.fit(_iterator(), epochs=2)
    assert revived.model.epoch == 2
    np.testing.assert_array_equal(_flat(revived.model), ref_params)
    np.testing.assert_array_equal(_opt_flat(revived.model), ref_opt)


def test_snapshot_retention_keeps_last_and_digests(tmp_path):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=1, keep_last=2)
    sess.fit(_iterator(), epochs=1)
    snaps = sess.snapshots()
    assert len(snaps) == 2
    assert len(glob.glob(os.path.join(str(tmp_path),
                                      "session_iter*.zip"))) == 2
    assert all(s["digest"] for s in snaps)
    assert glob.glob(os.path.join(str(tmp_path), "*.tmp.*")) == []


def test_resume_skips_corrupt_newest_snapshot(tmp_path):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, keep_last=3)
    sess.fit(_iterator(), epochs=1)
    snaps = sess.snapshots()
    newest = os.path.join(str(tmp_path), snaps[-1]["file"])
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 3)
    model = TrainingSession(None, str(tmp_path), device="cpu").resume()
    assert model.iteration == snaps[-2]["iteration"]


def test_resume_falls_back_to_the_in_memory_snapshot(tmp_path):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    sess.fit(_iterator(), epochs=1)
    for s in sess.snapshots():
        os.remove(os.path.join(str(tmp_path), s["file"]))
    model = sess.resume()
    assert model.iteration == sess._mem_entry["iteration"] == 6


def test_resume_with_nothing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TrainingSession(None, str(tmp_path), device="cpu").resume()


def test_to_epoch_resumes_to_original_budget_not_past_it(tmp_path):
    ref_params, ref_opt = _baseline()
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=3, max_restarts=0)
    plan = FaultPlan().inject("train.step", on_calls=[10])  # epoch 1
    with plan.armed():
        with pytest.raises(InjectedFault):
            sess.fit(_iterator(), epochs=2)
    revived = TrainingSession(None, str(tmp_path),
                              snapshot_every_n_iterations=3, device="cpu")
    assert revived.resume().epoch == 1
    revived.fit(_iterator(), to_epoch=2)
    assert revived.model.epoch == 2
    np.testing.assert_array_equal(_flat(revived.model), ref_params)
    np.testing.assert_array_equal(_opt_flat(revived.model), ref_opt)


def test_max_restarts_bounds_a_deterministic_fault(tmp_path):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, max_restarts=2)
    plan = FaultPlan().inject("train.step", probability=1.0)
    with plan.armed():
        with pytest.raises(InjectedFault):
            sess.fit(_iterator(), epochs=1)
    assert sess.restarts == 2


def test_disarmed_sites_leave_training_untouched(tmp_path):
    REGISTRY.reset()
    ref_params, _ = _baseline(1)
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    sess.fit(_iterator(), epochs=1)
    snap = REGISTRY.snapshot(run_collectors=False)
    assert not any(k.startswith(("dl4j_faults_injected_total",
                                 "dl4j_resumes_total")) for k in snap)
    np.testing.assert_array_equal(_flat(sess.model), ref_params)


def test_manifest_keys_equal_the_jax_manifest(tmp_path):
    TrainingSession(_net(), str(tmp_path / "port"),
                    snapshot_every_n_iterations=2).fit(_iterator())
    jnet = JMLN(_jconf()).init()
    JTrainingSession(jnet, str(tmp_path / "jax"),
                     snapshot_every_n_iterations=2).fit(
        JList([JDataSet(x, y) for x, y in _batches()]))
    port = json.load(open(tmp_path / "port" / "session.json"))
    ref = json.load(open(tmp_path / "jax" / "session.json"))
    assert set(port) == set(ref)
    assert [set(r) for r in port["snapshots"]] == \
        [set(r) for r in ref["snapshots"]]
    assert [r["file"] for r in port["snapshots"]] == \
        [r["file"] for r in ref["snapshots"]]
    assert port["rng_key"] == [0, 11]  # the base seed's two words


def test_resume_refuses_another_seed(tmp_path):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2)
    sess.fit(_iterator())
    m = json.load(open(tmp_path / "session.json"))
    m["rng_key"] = [0, 12]
    json.dump(m, open(tmp_path / "session.json", "w"))
    with pytest.raises(ValueError, match="dropout masks"):
        TrainingSession(None, str(tmp_path), device="cpu").resume()


def test_killed_session_matches_the_jax_session(tmp_path):
    """The same interrupted session in both packages (SGD): the final
    params agree."""
    net, jnet = _pair("sgd")
    sess = TrainingSession(net, str(tmp_path / "port"),
                           snapshot_every_n_iterations=2)
    with FaultPlan(seed=1).inject("train.step", on_calls=[5]).armed():
        sess.fit(_iterator(), epochs=2)
    jsess = JTrainingSession(jnet, str(tmp_path / "jax"),
                             snapshot_every_n_iterations=2)
    with JFaultPlan(seed=1).inject("train.step", on_calls=[5]).armed():
        jsess.fit(JList([JDataSet(x, y) for x, y in _batches()]), epochs=2)
    assert sess.restarts == jsess.restarts == 1
    np.testing.assert_allclose(_flat(sess.model),
                               np.asarray(jsess.model.params_flat()),
                               rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("zero", [False, True])
def test_wrapper_session_resumes_bit_identical(tmp_path, zero):
    """A one-rank exact (or ZeRO) ParallelWrapper under the session: the
    kill and resume end on the uninterrupted wrapper run's bits."""
    kw = dict(prefetch_buffer=0, zero_optimizer=zero)
    if zero:
        kw["gradient_bucket_mb"] = 0
    ref = _net()
    ParallelWrapper(ref, **kw).fit(_iterator(), epochs=2)
    sess = TrainingSession(ParallelWrapper(_net(), **kw), str(tmp_path),
                           snapshot_every_n_iterations=2)
    with FaultPlan().inject("train.step", on_calls=[5]).armed():
        sess.fit(_iterator(), epochs=2)
    model = sess.model.model
    assert sess.restarts == 1 and model.iteration == 12
    np.testing.assert_array_equal(_flat(model), _flat(ref))
    np.testing.assert_array_equal(_opt_flat(model), _opt_flat(ref))


@pytest.mark.parametrize("mode", ["averaging", "threshold"])
def test_session_refuses_the_other_wrapper_modes(tmp_path, mode):
    from deeplearning4j_tpu_torch.parallel import (
        ThresholdAlgorithm,
        TrainingMode,
    )

    kw = ({"training_mode": TrainingMode.AVERAGING} if mode == "averaging"
          else {"threshold_algorithm": ThresholdAlgorithm()})
    with pytest.raises(ValueError, match="exact SHARED_GRADIENTS"):
        TrainingSession(ParallelWrapper(_net(), **kw), str(tmp_path))


def test_snapshot_leaves_training_state_untouched(tmp_path):
    net = _net()
    sess = TrainingSession(net, str(tmp_path))
    before = {k: {pk: v.clone() for pk, v in vp.items()}
              for k, vp in net.params.items()}
    entry = sess.snapshot()
    assert entry["iteration"] == 0 and entry["batch_in_epoch"] == 0
    for k, vp in before.items():
        for pk, v in vp.items():
            assert torch.equal(v, net.params[k][pk])
