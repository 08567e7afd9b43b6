"""The ModelSerializer zip shared by the port and the JAX package.

A zip written by the JAX package restores in the port, and one written by
the port restores in the JAX package: the same ``params_flat`` bit for bit,
the same flat updater state bit for bit, the same layer state, iteration
and epoch, the same outputs (rtol 1e-4, atol 1e-6: float32 forwards summed
in other orders), and two further steps from the restored networks agree
(scores rtol 1e-5, params rtol 1e-5 with an absolute floor of 1e-2 of the
learning rate, as ``test_torch_mln_training.py`` holds them). Networks:
LeNet (Adam) and a small ComputationGraph (two dense branches summed by an
ElementWiseVertex, Adam). A graph with a batch norm writes the very
arrays the JAX package writes for the same state.

The JAX package restores a BN layer's updater state in its init order
(gamma, beta) while it writes it in the sorted order its train step leaves
it in (beta, gamma), so it swaps the two when it restores its own zip
after training; the port writes and reads the sorted order, so it restores
the JAX package's zips right. The round trips with further steps use
networks without batch norm for that reason.
"""

import io
import json
import os
import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.graph import ElementWiseOp as JEWOp
from deeplearning4j_tpu.conf.graph import ElementWiseVertex as JEW
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_cnn import BatchNormalization as JBN
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.mnist import synthesize
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.util import params as jparams
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from deeplearning4j_tpu_torch.util import params as pparams
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.util.convert import params_to_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SCORE_RTOL = 1e-5
OUT_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-3


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lenet_batches(n=3):
    x, y = synthesize(64 * n, 21)
    return [(x[i:i + 64], y[i:i + 64]) for i in range(0, 64 * n, 64)]


def _graph_jconf(bn=False):
    g = (JNNC.builder().seed(9).updater(JAdam(learning_rate=LR))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.feed_forward(6)))
    g.add_layer("a", JDense(n_out=5, activation=JAct.RELU), "in")
    g.add_layer("b", JDense(n_out=5, activation=JAct.TANH), "in")
    g.add_vertex("sum", JEW(op=JEWOp.ADD), "a", "b")
    last = "sum"
    if bn:
        g.add_layer("bn", JBN(), "sum")
        last = "bn"
    g.add_layer("out", JOut(n_out=3, activation=JAct.SOFTMAX), last)
    g.set_outputs("out")
    return g.build()


def _graph_batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


def _read(path, name):
    with zipfile.ZipFile(path) as z:
        if name.endswith(".json"):
            return json.loads(z.read(name).decode())
        data = io.BytesIO(z.read(name))
        if name.endswith(".npz"):
            npz = np.load(data)
            return {k: npz[k] for k in npz.files}
        return np.load(data)


KINDS = {
    "lenet": (lambda: JLeNet().init(), _lenet_batches,
              ser.restore_multi_layer_network,
              jser.restore_multi_layer_network, MultiLayerNetwork),
    "graph": (lambda: JGraph(_graph_jconf()).init(), _graph_batches,
              ser.restore_computation_graph,
              jser.restore_computation_graph, ComputationGraph),
}


def _jax_trained(kind, steps=2):
    make, batches, *_ = KINDS[kind]
    jnet = make()
    data = batches()
    for x, y in data[:steps]:
        jnet.fit_batch(JDataSet(x, y))
    return jnet, data


def _assert_same_state(net, jnet):
    """The port network and the JAX network hold the same params, updater
    state, layer state and counters, bit for bit."""
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(
        pparams.flatten_state_like(net.conf, net.opt_state),
        jparams.flatten_state_like(_to_np(jnet.opt_state)))
    _, state = params_to_jax(net.conf, {}, net.state)
    for k, vs in _to_np(jnet.state).items():
        for name, v in vs.items():
            np.testing.assert_array_equal(state[k][name], v)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch)


def _continue_both(net, jnet, data):
    x = data[0][0]
    got = net.output(x)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for x, y in data[-2:]:
        ls = net.fit_batch(DataSet(x, y))
        lj = jnet.fit_batch(JDataSet(x, y))
        assert ls == pytest.approx(lj, rel=SCORE_RTOL)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=1e-5,
                               atol=1e-2 * LR)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_zip_restores_in_the_port(kind, tmp_path):
    jnet, data = _jax_trained(kind)
    path = tmp_path / "jax.zip"
    jser.write_model(jnet, path)
    net = KINDS[kind][2](path, device="cpu")
    assert type(net) is KINDS[kind][4]
    _assert_same_state(net, jnet)
    _continue_both(net, jnet, data)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_zip_restores_in_jax(kind, tmp_path):
    jnet, data = _jax_trained(kind)
    jpath, path = tmp_path / "jax.zip", tmp_path / "port.zip"
    jser.write_model(jnet, jpath)
    net = KINDS[kind][2](jpath, device="cpu")
    net.fit_batch(DataSet(*data[2]))  # a step of the port's own
    ser.write_model(net, path)
    back = KINDS[kind][3](path)
    _assert_same_state(net, back)
    restored = ser.restore_model(path, device="cpu")
    assert type(restored) is KINDS[kind][4]
    np.testing.assert_array_equal(restored.params_flat(), net.params_flat())
    _continue_both(net, back, data)


def test_port_writes_the_arrays_the_jax_package_writes(tmp_path):
    """A graph with a batch norm, restored from the JAX package's zip and
    written again by the port: every entry holds the same arrays and the
    same configuration and counters."""
    jnet = JGraph(_graph_jconf(bn=True)).init()
    for x, y in _graph_batches(2):
        jnet.fit_batch(JDataSet(x, y))
    jpath, path = tmp_path / "jax.zip", tmp_path / "port.zip"
    jser.write_model(jnet, jpath)
    ser.write_model(ser.restore_computation_graph(jpath, device="cpu"), path)
    for name in ("coefficients.npy", "updaterState.npy"):
        np.testing.assert_array_equal(_read(path, name), _read(jpath, name))
    a, b = _read(path, "state.npz"), _read(jpath, "state.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert _read(path, "configuration.json") == _read(jpath,
                                                      "configuration.json")
    assert _read(path, "metadata.json") == _read(jpath, "metadata.json")


def test_checkpoint_write_fault_leaves_no_file(tmp_path):
    jnet, _ = _jax_trained("graph", steps=1)
    jser.write_model(jnet, tmp_path / "good.zip")
    port = ser.restore_computation_graph(tmp_path / "good.zip", device="cpu")
    target = tmp_path / "ckpt.zip"
    plan = FaultPlan().inject("checkpoint.write")
    with plan.armed():
        with pytest.raises(InjectedFault):
            ser.write_model(port, target)
    assert plan.fired("checkpoint.write") == 1
    assert sorted(os.listdir(tmp_path)) == ["good.zip"]
    ser.write_model(port, target)  # disarmed: published whole
    assert ser.restore_computation_graph(target, device="cpu").iteration == 1


def test_restore_newest_verified_skips_a_corrupted_zip(tmp_path):
    jnet, data = _jax_trained("graph", steps=1)
    port = ser.restore_computation_graph(
        _write(jnet, tmp_path / "a.zip"), device="cpu")
    older = tmp_path / "older.zip"
    ser.write_model(port, older)
    port.fit_batch(DataSet(*data[1]))
    newer = tmp_path / "newer.zip"
    ser.write_model(port, newer)
    candidates = [(str(older), ser.file_digest(older)),
                  (str(newer), ser.file_digest(newer))]
    with open(newer, "r+b") as f:  # bit rot in the newest checkpoint
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))

    def restore(p):
        return ser.restore_computation_graph(p, device="cpu")

    restored, index, err = ser.restore_newest_verified(candidates, restore)
    assert index == 0 and err is None and restored.iteration == 1
    # a matching digest that still fails to open reports the error
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"not a zip")
    restored, index, err = ser.restore_newest_verified(
        [(str(bad), ser.file_digest(bad))], restore)
    assert restored is None and index == -1 and err is not None


def _write(jnet, path):
    jser.write_model(jnet, path)
    return path


def test_graph_evaluate_summary_fused_steps_match_jax():
    """The ComputationGraph surface this slice adds: ``evaluate``,
    ``summary``, ``params_flat`` against the JAX package, and
    ``fit(fused_steps=K)`` training as K = 1 does."""
    jnet, data = _jax_trained("graph", steps=0)
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JList,
    )
    from deeplearning4j_tpu_torch.conf.graph import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.util.convert import params_from_jax

    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _to_np(jnet.params), _to_np(jnet.state))
    net = ComputationGraph(conf, "cpu").set_params(p, s)
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    assert net.summary() == jnet.summary()
    ev = net.evaluate(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    jev = jnet.evaluate(JList([JDataSet(x, y) for x, y in data]))
    assert ev.stats() == jev.stats()
    twins = [ComputationGraph(conf, "cpu").set_params(p, s)
             for _ in range(2)]
    for twin, k in zip(twins, (1, 2)):
        twin.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]),
                 fused_steps=k)
    np.testing.assert_array_equal(twins[0].params_flat(),
                                  twins[1].params_flat())
    flat = twins[0].params_flat()
    net.set_params_flat(flat)
    np.testing.assert_array_equal(net.params_flat(), flat)
