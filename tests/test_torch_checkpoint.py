"""Checkpointing in the port (``optimize/checkpoint.py``) against the JAX
package.

The JAX package's checkpoint cases of ``tests/test_training_tools.py``
(retention by epochs, saving by iterations, numbering across a restart,
asynchronous checkpoints) run on the port, and:

- a run resumed from a ``CheckpointListener`` zip equals the uninterrupted
  run exactly on the CPU (params, updater state, BN state, scores), for a
  ``MultiLayerNetwork`` and a ``ComputationGraph``;
- a zip written by the port's listener restores in the JAX package, and
  one written by the JAX package's listener restores in the port;
- the in-place update trap: the port updates params in place, so a
  snapshot must be a copy, never a view a later step can reach;
- ``AsyncCheckpointListener``: ``wait``, retention and ``restore_latest``;
- digest verification and the fallback to the newest good zip.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.multilayer import (
    MultiLayerConfiguration as JConf,
)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.checkpoint import (
    CheckpointListener as JCheckpointListener,
)
from deeplearning4j_tpu_torch.conf import Activation, InputType
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.graph import (
    ElementWiseOp,
    ElementWiseVertex,
    LayerVertex,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    GlobalPoolingLayer,
    PoolingType,
    SpaceToDepthLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.conf.updaters import Adam
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ArrayDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.checkpoint import (
    AsyncCheckpointListener,
    CheckpointListener,
    restore_training_state,
    snapshot_training_state,
)
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.util import serializer

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


def _conf(n_in=4, classes=3, bn=False):
    b = (NeuralNetConfiguration.builder().seed(12345)
         .updater(Adam(1e-2)).list()
         .layer(DenseLayer(n_out=8, activation=Activation.TANH)))
    if bn:
        b = b.layer(BatchNormalization())
    return (b.layer(DenseLayer(n_out=6, activation=Activation.RELU))
            .layer(OutputLayer(n_out=classes, activation=Activation.SOFTMAX,
                               loss_fn=LossMCXENT()))
            .set_input_type(InputType.feed_forward(n_in))
            .build())


def _net(**kw):
    return MultiLayerNetwork(_conf(**kw), device="cpu").init()


def _data(n=48, n_in=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return DataSet(x, y)


def _same(a, b):
    """Whether two nested dicts of tensors hold the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


# --- the JAX package's cases -----------------------------------------------

def test_checkpoint_listener_epochs_and_retention(tmp_path):
    net = _net()
    cl = CheckpointListener(str(tmp_path), save_every_n_epochs=1,
                            keep_last=2)
    net.set_listeners(cl)
    ds = _data()
    net.fit(ArrayDataSetIterator(ds.features, ds.labels, 16), epochs=5)
    cps = cl.list_checkpoints()
    assert len(cps) == 2  # retention kept only the last 2
    assert cps[-1].epoch == 4
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["checkpoint.csv"] + [c.filename for c in cps])
    restored = cl.load_checkpoint(device="cpu")
    np.testing.assert_array_equal(restored.params_flat(), net.params_flat())
    # resume continues training (exact resume incl. updater state)
    restored.fit_batch(ds)


def test_checkpoint_listener_iterations(tmp_path):
    net = _net()
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=2)
    net.set_listeners(cl)
    ds = _data()
    for _ in range(6):
        net.fit_batch(ds)
    assert [c.iteration for c in cl.list_checkpoints()] == [1, 3, 5]


def test_checkpoint_numbering_survives_retention_restart(tmp_path):
    net = _net()
    ds = _data()
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                            keep_last=2)
    net.set_listeners(cl)
    for _ in range(5):
        net.fit_batch(ds)
    # restart a new listener in the same directory
    cl2 = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                             keep_last=2)
    net.set_listeners(cl2)
    net.fit_batch(ds)
    nums = [c.number for c in cl2.list_checkpoints()]
    assert len(nums) == len(set(nums))  # no duplicate numbers
    assert max(nums) == 5


def test_async_checkpointing(tmp_path):
    net = _net()
    cl = AsyncCheckpointListener(str(tmp_path / "async"),
                                 save_every_n_iterations=2, max_to_keep=2)
    net.set_listeners(cl)
    ds = _data()
    for _ in range(6):
        net.fit_batch(ds)
    cl.wait()
    assert cl.all_steps() == [3, 5]  # retention kept the last 2
    restored = cl.restore_latest(device="cpu")
    np.testing.assert_array_equal(restored.params_flat(), net.params_flat())
    # counters restored exactly (epoch-keyed schedules depend on this)
    assert restored.iteration == net.iteration
    assert restored.epoch == net.epoch
    assert _same(restored.opt_state, net.opt_state)
    # exact resume: training continues from the restored updater state
    assert restored.fit_batch(ds) == net.fit_batch(ds)


def test_async_checkpoint_is_a_copy_taken_before_the_next_step(tmp_path):
    """The background write reads a host copy made at the listener call:
    the steps that run while it writes never reach the zip."""
    net = _net()
    cl = AsyncCheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                 max_to_keep=5)
    net.set_listeners(cl)
    ds = _data()
    for _ in range(3):
        net.fit_batch(ds)
    at_save = net.params_flat()
    for _ in range(4):  # keeps training while the save may still run
        net.fit_batch(ds)
    cl.wait()
    assert cl.all_steps() == [2, 5]
    back = serializer.restore_model(
        os.path.join(cl.directory, "checkpoint_2.zip"), device="cpu")
    np.testing.assert_array_equal(back.params_flat(), at_save)
    assert back.iteration == 3


# --- exact resume ------------------------------------------------------------

def _resume_matches(tmp_path, make_net, batches, every, load):
    """Train ``make_net()`` over ``batches`` with a CheckpointListener,
    restore the newest zip, train the remaining batches, and compare with
    the uninterrupted run bit for bit."""
    full = make_net()
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=every,
                            keep_last=1)
    collect = CollectScoresListener()
    full.set_listeners(collect, cl)
    full.fit(ListDataSetIterator(batches))
    resumed = load(cl)
    start = resumed.iteration
    assert 0 < start < len(batches)
    rest = CollectScoresListener()
    resumed.set_listeners(rest)
    resumed.fit(ListDataSetIterator(batches[start:]))
    assert rest.scores == collect.scores[start:]
    for name in ("params", "opt_state", "state"):
        assert _same(getattr(resumed, name), getattr(full, name)), name
    assert resumed.iteration == full.iteration


def test_mln_resume_equals_the_uninterrupted_run(tmp_path):
    batches = [_data(n=16, seed=s) for s in range(7)]
    _resume_matches(tmp_path, lambda: _net(bn=True), batches, 3,
                    lambda cl: cl.load_checkpoint(device="cpu"))


def _small_graph_conf():
    """A small graph with the s2d stem, FusedConvBN1x1, BN and a residual
    add (BN running statistics and Adam state to resume)."""
    b = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.convolutional(8, 8, 3)))
    return (b.add_vertex("s2d", LayerVertex(
                layer=SpaceToDepthLayer(block_size=2)), "in")
            .add_vertex("pad", LayerVertex(
                layer=ZeroPaddingLayer(padding=(1, 2, 1, 2))), "s2d")
            .add_layer("conv", ConvolutionLayer(
                n_out=6, kernel_size=(4, 4), has_bias=False,
                convolution_mode=ConvolutionMode.TRUNCATE), "pad")
            .add_layer("bn", BatchNormalization(
                activation=Activation.RELU), "conv")
            .add_layer("cb", FusedConvBN1x1(n_out=6), "bn")
            .add_vertex("add", ElementWiseVertex(op=ElementWiseOp.ADD),
                        "bn", "cb")
            .add_layer("pool", GlobalPoolingLayer(
                pooling_type=PoolingType.AVG), "add")
            .add_layer("out", OutputLayer(
                n_out=5, activation=Activation.SOFTMAX,
                loss_fn=LossMCXENT()), "pool")
            .set_outputs("out").build())


def test_graph_resume_equals_the_uninterrupted_run(tmp_path):
    conf = _small_graph_conf()
    rng = np.random.default_rng(1)
    batches = [DataSet(rng.random((4, 8, 8, 3)).astype(np.float32),
                       np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)])
               for _ in range(5)]
    _resume_matches(tmp_path,
                    lambda: ComputationGraph(conf, device="cpu").init(),
                    batches, 2,
                    lambda cl: cl.load_checkpoint_graph(device="cpu"))


# --- across the packages --------------------------------------------------------

def test_a_port_checkpoint_restores_in_jax(tmp_path):
    net = _net(bn=True)
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=2)
    net.set_listeners(cl)
    ds = _data()
    for _ in range(2):
        net.fit_batch(ds)
    jcl = JCheckpointListener(str(tmp_path), save_every_n_iterations=2)
    assert [c.digest for c in jcl.list_checkpoints()] == \
        [c.digest for c in cl.list_checkpoints()]
    jnet = jcl.load_checkpoint()
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()),
                                  net.params_flat())
    assert jnet.iteration == net.iteration == 2
    np.testing.assert_allclose(np.asarray(jnet.output(ds.features)),
                               net.output(ds.features), rtol=1e-5,
                               atol=1e-7)


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    jconf = JConf.from_json(_conf(bn=True).to_json())
    jnet = JMLN(jconf).init()
    jcl = JCheckpointListener(str(tmp_path), save_every_n_iterations=2)
    jnet.set_listeners(jcl)
    ds = _data()
    jds = JDataSet(ds.features, ds.labels)
    for _ in range(2):
        jnet.fit_batch(jds)
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=2)
    assert cl.verify(cl.last_checkpoint())
    net = cl.load_checkpoint(device="cpu")
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    assert net.iteration == jnet.iteration == 2
    np.testing.assert_allclose(net.output(ds.features),
                               np.asarray(jnet.output(ds.features)),
                               rtol=1e-5, atol=1e-7)
    assert isinstance(net.conf, MultiLayerConfiguration)


# --- the snapshot and the in-place update trap -----------------------------------

def test_a_held_reference_goes_stale_and_the_snapshot_does_not():
    net = _net(bn=True)
    ds = _data()
    net.fit_batch(ds)
    held = net.params["0"]["W"]  # a reference, not a copy
    before = held.clone()
    snap = snapshot_training_state(net)
    net.fit_batch(ds)
    # the update ran in place: the held tensor moved with the params
    assert net.params["0"]["W"] is held
    assert not torch.equal(held, before)
    # the snapshot is a host copy taken before the step
    np.testing.assert_array_equal(snap["params"]["0"]["W"], before.numpy())
    assert snap["iteration"] == 1


def test_restore_training_state_rewinds_exactly():
    net = _net(bn=True)
    ds = _data()
    net.fit_batch(ds)
    snap = snapshot_training_state(net)
    l1 = net.fit_batch(ds)
    p1 = net.params_flat()
    net.fit_batch(ds)
    restore_training_state(net, snap)
    assert net.iteration == 1 and np.isnan(net.score())
    assert net.fit_batch(ds) == l1
    np.testing.assert_array_equal(net.params_flat(), p1)
    # the snapshot stays valid for a second rollback, through the hooks
    net._health_restore(snap)
    assert net.fit_batch(ds) == l1
    again = net._health_snapshot()
    assert again["iteration"] == 2


# --- digests -------------------------------------------------------------------

def test_a_corrupt_newest_zip_falls_back_to_the_last_good_one(tmp_path):
    net = _net()
    cl = CheckpointListener(str(tmp_path), save_every_n_iterations=1)
    net.set_listeners(cl)
    ds = _data()
    net.fit_batch(ds)
    good = net.params_flat()
    net.fit_batch(ds)
    newest = cl.last_checkpoint()
    with open(os.path.join(tmp_path, newest.filename), "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    assert not cl.verify(newest)
    back = cl.load_checkpoint(device="cpu")
    np.testing.assert_array_equal(back.params_flat(), good)
    with pytest.raises(OSError):
        cl.load_checkpoint(newest.number, device="cpu")
    # the listener refuses to run without a frequency
    with pytest.raises(ValueError):
        CheckpointListener(str(tmp_path))
