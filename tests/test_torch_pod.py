"""``resilience/pod.py`` in the port against the JAX package's: the pod
snapshot layout (per-host ``shard_h{h}.npz`` under the ZeroSpec flat cut,
sha256 in host manifests, the coordinator's commit), restores across pod
shapes, the named ``PodSnapshotIncompleteError`` reasons, host death in an
emulated pod and on two gloo ranks in ZeRO mode.

Networks: the JAX tests' MLP (4 -> 8 tanh -> 3 softmax, Adam) trained one
epoch of six seeded batches in the JAX package; the port's network holds
the same params and updater state (the JAX zip restored in the port), so
the two packages' snapshots of it are compared array for array. A pod
snapshot written by either package restores in the other bit for bit.
The JAX package's host-death test on a ZeRO wrapper session is red in
this environment, so the port's two-rank ZeRO session is held to its own
uninterrupted two-rank run (which the parallel tests hold to the JAX
step).
"""

import glob
import json
import logging
import os

import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.resilience import pod as jpod
from deeplearning4j_tpu.util import params as jparams_util
from deeplearning4j_tpu.util import serializer as jserializer
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import spawn
from deeplearning4j_tpu_torch.resilience import (
    FaultPlan,
    HostDeathError,
    InjectedFault,
    PodConfig,
    PodSnapshotIncompleteError,
    TrainingSession,
    faults,
)
from deeplearning4j_tpu_torch.resilience import pod as pod_mod
from deeplearning4j_tpu_torch.telemetry import REGISTRY
from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util import serializer
from deeplearning4j_tpu_torch.util.convert import params_from_jax
from deeplearning4j_tpu_torch.util.serializer import file_digest

from tests import torch_session_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _clean():
    faults._ACTIVE = None
    REGISTRY.reset()
    yield
    faults._ACTIVE = None
    REGISTRY.reset()


def _jconf(seed=7):
    return (JNNC.builder().seed(seed).updater(JAdam(0.01)).list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())


def _batches(seed=0, n=6, rows=8):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _iterator():
    return ListDataSetIterator([DataSet(x, y) for x, y in _batches()])


def _trained_pair(tmp_path):
    """(port net, JAX net) holding the same trained params and Adam state:
    the JAX net trained an epoch, restored in the port from its zip."""
    jnet = JMLN(_jconf()).init()
    jnet.fit(JList([JDataSet(x, y) for x, y in _batches()]), epochs=1)
    zp = str(tmp_path / "jax.zip")
    jserializer.write_model(jnet, zp)
    return serializer.restore_model(zp, device="cpu"), jnet


def _net():
    """The port's network on a fresh JAX network's params."""
    jnet = JMLN(_jconf()).init()
    conf = MultiLayerConfiguration.from_json(_jconf().to_json())
    p, s = params_from_jax(conf, {k: {pk: np.asarray(v) for pk, v in
                                      vp.items()}
                                  for k, vp in jnet.params.items()}, {})
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _flat(net):
    return net.params_flat()


def _opt_flat(net):
    return params_util.flatten_state_like(net.conf, net.opt_state)


def _jflat(jnet):
    return (np.asarray(jnet.params_flat()),
            np.asarray(jparams_util.flatten_state_like(jnet.opt_state)))


_BASE = {}


def _baseline():
    if not _BASE:
        net = _net()
        net.fit(_iterator(), epochs=2)
        _BASE["ref"] = (_flat(net), _opt_flat(net))
    return _BASE["ref"]


# --------------------------------------------------------------------------
# layout, digests and the two packages' files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_layout_and_shards_equal_the_jax_snapshot(tmp_path, n_hosts):
    net, jnet = _trained_pair(tmp_path)
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    man = pod_mod.write_pod_snapshot(net, d, PodConfig(n_hosts=n_hosts))
    jman = jpod.write_pod_snapshot(jnet, jd, jpod.PodConfig(n_hosts=n_hosts))
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    assert set(man) == set(jman)
    assert man["components"] == jman["components"]
    for key in ("n_hosts", "iteration", "epoch", "batch_in_epoch"):
        assert man[key] == jman[key]
    for h in range(n_hosts):
        a = np.load(os.path.join(d, pod_mod.shard_name(h)))
        b = np.load(os.path.join(jd, pod_mod.shard_name(h)))
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
        hman = json.load(open(os.path.join(d, pod_mod.host_manifest_name(h))))
        for row in hman["shards"]:
            assert file_digest(os.path.join(d, row["file"])) == row["sha256"]
        assert file_digest(os.path.join(
            d, pod_mod.host_manifest_name(h))) == man["hosts"][h]["sha256"]


def test_shards_concatenate_back_to_the_flats(tmp_path):
    net, _ = _trained_pair(tmp_path)
    d = str(tmp_path / "pod")
    pod_mod.write_pod_snapshot(net, d, PodConfig(n_hosts=2))
    ref = _flat(net)
    m = -(-ref.size // 2)
    s0 = np.load(os.path.join(d, "shard_h000.npz"))["coefficients"]
    s1 = np.load(os.path.join(d, "shard_h001.npz"))["coefficients"]
    assert s0.size == s1.size == m
    np.testing.assert_array_equal(np.concatenate([s0, s1])[:ref.size], ref)


def test_a_jax_pod_snapshot_restores_in_the_port_bitwise(tmp_path):
    _, jnet = _trained_pair(tmp_path)
    jd = str(tmp_path / "jax")
    jpod.write_pod_snapshot(jnet, jd, jpod.PodConfig(n_hosts=2))
    net, man = pod_mod.restore_pod_snapshot(jd, PodConfig(n_hosts=2),
                                            device="cpu")
    jp, jo = _jflat(jnet)
    np.testing.assert_array_equal(_flat(net), jp)
    np.testing.assert_array_equal(_opt_flat(net), jo)
    assert net.iteration == jnet.iteration == man["iteration"]


def test_a_port_pod_snapshot_restores_in_the_jax_package_bitwise(tmp_path):
    net, _ = _trained_pair(tmp_path)
    d = str(tmp_path / "port")
    pod_mod.write_pod_snapshot(net, d, PodConfig(n_hosts=2))
    jnet, _ = jpod.restore_pod_snapshot(d, jpod.PodConfig(n_hosts=2))
    jp, jo = _jflat(jnet)
    np.testing.assert_array_equal(jp, _flat(net))
    np.testing.assert_array_equal(jo, _opt_flat(net))


@pytest.mark.parametrize("n_save,n_restore", [(2, 1), (2, 4), (4, 2),
                                              (1, 4), (4, 1)])
def test_restore_across_pod_shapes_bitwise(tmp_path, n_save, n_restore):
    net, _ = _trained_pair(tmp_path)
    d = str(tmp_path / "pod")
    pod_mod.write_pod_snapshot(net, d, PodConfig(n_hosts=n_save))
    restored, _ = pod_mod.restore_pod_snapshot(
        d, PodConfig(n_hosts=n_restore), device="cpu")
    np.testing.assert_array_equal(_flat(restored), _flat(net))
    np.testing.assert_array_equal(_opt_flat(restored), _opt_flat(net))


# --------------------------------------------------------------------------
# the named errors
# --------------------------------------------------------------------------

def _committed(tmp_path):
    net, _ = _trained_pair(tmp_path)
    d = str(tmp_path / "pod_a")
    pod_mod.write_pod_snapshot(net, d, PodConfig(n_hosts=2))
    return d


def _corrupt_shard(d):
    p = os.path.join(d, "shard_h000.npz")
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) // 2)
        f.write(b"\x00corrupt\x00")


def _stale_host(d):
    hpath = os.path.join(d, "host_h001.json")
    hman = json.load(open(hpath))
    hman["iteration"] += 1
    json.dump(hman, open(hpath, "w"))


@pytest.mark.parametrize("damage,reason", [
    (lambda d: os.remove(os.path.join(d, "shard_h001.npz")),
     "missing shard file shard_h001.npz"),
    (_corrupt_shard, "shard digest mismatch"),
    (lambda d: os.remove(os.path.join(d, "manifest.json")),
     "uncommitted coordinator manifest"),
    (_stale_host, "stale coordinator manifest"),
    (lambda d: os.remove(os.path.join(d, "host_h000.json")),
     "missing host manifest host_h000.json"),
], ids=["missing_shard", "corrupt_shard", "uncommitted", "stale",
        "missing_host_manifest"])
def test_damage_raises_its_named_reason(tmp_path, damage, reason):
    d = _committed(tmp_path)
    damage(d)
    with pytest.raises(PodSnapshotIncompleteError) as ei:
        pod_mod.restore_pod_snapshot(d, device="cpu")
    assert reason in ei.value.reason


def test_session_resume_skips_partial_newest_with_reason(tmp_path, caplog):
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, pod=2)
    sess.fit(_iterator(), epochs=1)
    snaps = sess.snapshots()
    assert len(snaps) >= 2 and all(s.get("pod") for s in snaps)
    newest = os.path.join(str(tmp_path), snaps[-1]["file"])
    os.remove(os.path.join(newest, "shard_h000.npz"))
    revived = TrainingSession(None, str(tmp_path), pod=2, device="cpu")
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch.resilience"
                                ".session"):
        model = revived.resume()
    assert model.iteration == snaps[-2]["iteration"]
    assert any("missing shard file shard_h000.npz" in r.getMessage()
               for r in caplog.records)


def test_snapshot_interrupted_mid_shard_write_never_selected(tmp_path):
    ref_params, ref_opt = _baseline()
    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, pod=2,
                           max_restarts=0)
    # one call a shard write: the pre-first-step snapshot is 1, 2; the
    # next one's host 1 is 4, and the retries replay it as 6 and 8
    plan = FaultPlan(seed=3).inject("snapshot.shard_write",
                                    on_calls=[4, 6, 8])
    with plan.armed():
        with pytest.raises(InjectedFault):
            sess.fit(_iterator(), epochs=2)
    assert plan.fired("snapshot.shard_write") == 3
    dirs = sorted(glob.glob(os.path.join(str(tmp_path), "pod_iter*")))
    partial = [p for p in dirs
               if not os.path.exists(os.path.join(p, "manifest.json"))]
    assert len(partial) == 1
    assert not glob.glob(os.path.join(partial[0], "*.tmp.*"))
    with pytest.raises(PodSnapshotIncompleteError):
        pod_mod.verify_pod_snapshot(partial[0])
    revived = TrainingSession(None, str(tmp_path),
                              snapshot_every_n_iterations=2, pod=2,
                              device="cpu")
    assert revived.resume().iteration == 0
    revived.fit(_iterator(), to_epoch=2)
    np.testing.assert_array_equal(_flat(revived.model), ref_params)
    np.testing.assert_array_equal(_opt_flat(revived.model), ref_opt)


# --------------------------------------------------------------------------
# host death
# --------------------------------------------------------------------------

def test_host_death_resumes_bit_identical_and_replays_deterministically(
        tmp_path):
    ref_params, ref_opt = _baseline()
    kill_points = []
    for rep in range(2):
        sess = TrainingSession(_net(), str(tmp_path / f"run{rep}"),
                               snapshot_every_n_iterations=2, pod=2)
        plan = FaultPlan(seed=11).inject(
            "pod.heartbeat", probability=0.12,
            exc=lambda: HostDeathError(host=1), max_fires=1)
        before = REGISTRY.counter("dl4j_resumes_total",
                                  scope="host").snapshot_value()
        with plan.armed():
            sess.fit(_iterator(), epochs=2)
        assert plan.fired("pod.heartbeat") == 1
        kill_points.append(plan.invocations("pod.heartbeat"))
        assert REGISTRY.counter("dl4j_resumes_total", scope="host"
                                ).snapshot_value() - before == 1
        assert sess.model.epoch == 2
        np.testing.assert_array_equal(_flat(sess.model), ref_params)
        np.testing.assert_array_equal(_opt_flat(sess.model), ref_opt)
    assert kill_points[0] == kill_points[1]


def test_host_death_on_a_two_rank_zero_session(tmp_path):
    """Two gloo ranks in ZeRO mode, pod snapshots of two shards: rank 1
    dies at its 4th heartbeat, every rank resumes, and both end on the
    uninterrupted two-rank run's params and updater state, bit for bit."""
    jnet = JMLN(_jconf()).init()
    spec = {"conf_json": _jconf().to_json(),
            "params": {k: {pk: np.asarray(v) for pk, v in vp.items()}
                       for k, vp in jnet.params.items()},
            "state": {}, "batches": _batches(rows=16)}
    out = spawn(ranks.pod_session, 2, (spec, str(tmp_path)),
                backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)
    for r in out:
        assert r["restarts"] == 1 and r["iteration"] == 12
        np.testing.assert_array_equal(r["got"][0], r["ref"][0])
        np.testing.assert_array_equal(r["got"][1], r["ref"][1])
    np.testing.assert_array_equal(out[0]["got"][0], out[1]["got"][0])
    # every snapshot the session kept is a committed two-shard directory
    for name in out[0]["snapshots"]:
        man = pod_mod.verify_pod_snapshot(os.path.join(str(tmp_path), name))
        assert man["n_hosts"] == 2
    # a restore at one rank (pod shape 2 -> 1) equals the gathered params
    newest = os.path.join(str(tmp_path), out[0]["snapshots"][-1])
    net, _ = pod_mod.restore_pod_snapshot(newest, PodConfig(n_hosts=1),
                                          device="cpu")
    np.testing.assert_array_equal(_flat(net), out[0]["got"][0])


def test_pod_series_and_status(tmp_path):
    from deeplearning4j_tpu_torch import resilience

    sess = TrainingSession(_net(), str(tmp_path),
                           snapshot_every_n_iterations=2, pod=2)
    sess.fit(_iterator(), epochs=1)
    pod = resilience.status()["pod"]
    assert pod["hosts"] == 2
    assert pod["series"]["dl4j_pod_snapshot_seconds"]["count"] >= 4
    assert 'dl4j_pod_snapshot_shard_bytes{host="1"}' in pod["series"]


def test_pod_config_checks_its_shape():
    with pytest.raises(ValueError):
        PodConfig(n_hosts=-1)
    with pytest.raises(ValueError):
        PodConfig(n_hosts=2, host_id=2)
    p = PodConfig(n_hosts=3)
    assert p.emulated and list(p.hosts_here()) == [0, 1, 2]
    assert p.is_coordinator and not p.real
