"""``profiler.py`` in the port against the JAX package's: the NaN / Inf
panic toggle (``torch.autograd`` anomaly mode and a finite check of each
step's loss where the JAX package sets ``jax_debug_nans`` /
``jax_debug_infs``), ``ProfilerListener``'s step times on the same 3-step
fit, and a trace written by ``torch.profiler``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import profiler as jprofiler
from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import profiler, telemetry
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.profiler import (
    OpProfiler,
    ProfilerConfig,
    ProfilerListener,
)
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _reset():
    OpProfiler.get_instance().reset()
    jprofiler.OpProfiler.get_instance().reset()
    yield
    OpProfiler.get_instance().reset()
    jprofiler.OpProfiler.get_instance().reset()
    telemetry.disable()
    telemetry.reset()


def _jconf():
    return (JNNC.builder().seed(1).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=4, activation=JAct.TANH))
            .layer(JOut(n_out=2, activation=JAct.SOFTMAX, loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(3)).build())


def _pair(kind="mln"):
    jconf = _jconf()
    jnet = JMLN(jconf).init()
    p, s = params_from_jax(
        MultiLayerConfiguration.from_json(jconf.to_json()),
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    if kind == "graph":
        g = (JNNC.builder().seed(1).updater(JSgd(0.1)).graph_builder()
             .add_inputs("in")
             .add_layer("d", JDense(n_out=4, activation=JAct.TANH), "in")
             .add_layer("out", JOut(n_out=2, activation=JAct.SOFTMAX,
                                    loss_fn=JMCXENT()), "d")
             .set_outputs("out").set_input_types(JIT.feed_forward(3))
             .build())
        return ComputationGraph(ComputationGraphConfiguration.from_json(
            g.to_json()), "cpu").init(), None
    return MultiLayerNetwork(conf, "cpu").set_params(p, s), jnet


def _xy(bad=False):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    if bad:
        x[0, 0] = np.nan
    return x, y


def test_nan_panic_toggle_matches_the_jax_package():
    """On: a NaN raises in both packages. Off again: both go silently
    NaN."""
    import jax.numpy as jnp

    jprofiler.OpProfiler.get_instance().set_config(
        jprofiler.ProfilerConfig(check_for_nan=True))
    with pytest.raises(FloatingPointError):
        jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
    jprofiler.OpProfiler.get_instance().reset()

    prof = OpProfiler.get_instance()
    prof.set_config(ProfilerConfig(check_for_nan=True))
    assert torch.is_anomaly_enabled()
    net, _ = _pair()
    # anomaly mode finds the NaN in the backward of the NaN loss
    with pytest.raises(RuntimeError, match="returned nan values"):
        net.fit_batch(DataSet(*_xy(bad=True)))
    with pytest.raises(FloatingPointError, match="NaN loss"):
        profiler.check_step(torch.tensor(float("nan")))
    prof.reset()
    assert not torch.is_anomaly_enabled()
    net2, _ = _pair()
    assert np.isnan(net2.fit_batch(DataSet(*_xy(bad=True))))


@pytest.mark.parametrize("kind", ["mln", "graph", "wrapper"])
def test_nan_panic_stops_every_training_path(kind):
    OpProfiler.get_instance().set_config(ProfilerConfig(check_for_nan=True))
    net, _ = _pair("graph" if kind == "graph" else "mln")
    x, y = _xy(bad=True)
    with pytest.raises(RuntimeError, match="returned nan values"):
        if kind == "wrapper":
            ParallelWrapper(net, prefetch_buffer=0).fit(x, y)
        else:
            net.fit_batch(DataSet(x, y))


def test_anomaly_mode_names_the_backward_that_made_a_nan():
    OpProfiler.get_instance().set_config(ProfilerConfig(check_for_nan=True))
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="returned nan"):
        torch.sqrt(x).sum().backward()


def test_inf_panic():
    OpProfiler.get_instance().set_config(ProfilerConfig(check_for_inf=True))
    profiler.check_step(torch.tensor(1.0))
    profiler.check_step(torch.tensor(float("nan")))  # NaN panic is off
    with pytest.raises(FloatingPointError, match="infinite loss"):
        profiler.check_step(torch.tensor(float("inf")), "multilayer", 3)


def test_healthy_steps_pass_under_the_panic():
    OpProfiler.get_instance().set_config(
        ProfilerConfig(check_for_nan=True, check_for_inf=True))
    net, _ = _pair()
    for _ in range(2):
        assert np.isfinite(net.fit_batch(DataSet(*_xy())))


def test_profiler_listener_collects_steps_as_the_jax_one():
    net, jnet = _pair()
    pl, jpl = ProfilerListener(warmup_iterations=1), \
        jprofiler.ProfilerListener(warmup_iterations=1)
    net.set_listeners(pl)
    jnet.set_listeners(jpl)
    x, y = _xy()
    for _ in range(3):
        net.fit_batch(DataSet(x, y))
        jnet.fit_batch(JDataSet(x, y))
    assert len(pl.step_times) == len(jpl.step_times) == 2
    assert pl.mean_step_seconds() > 0
    assert pl.summary().startswith("steps=2 ")
    assert ProfilerListener().summary() == jprofiler.ProfilerListener(
    ).summary()


def test_profiler_listener_feeds_the_step_histogram():
    telemetry.enable()
    net, _ = _pair()
    net.set_listeners(ProfilerListener(warmup_iterations=0))
    for _ in range(3):
        net.fit_batch(DataSet(*_xy()))
    snap = telemetry.REGISTRY.snapshot(run_collectors=False)
    assert snap['dl4j_step_seconds{path="profiler"}']["count"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    prof = OpProfiler.get_instance()
    net, _ = _pair()
    with prof.trace(str(tmp_path / "t")) as d:
        net.fit_batch(DataSet(*_xy()))
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert prof.stop_trace() is None  # a second stop is a no-op


def test_start_trace_restarts_into_the_new_directory(tmp_path):
    prof = OpProfiler.get_instance()
    prof.start_trace(str(tmp_path / "a"))
    prof.start_trace(str(tmp_path / "b"))
    torch.ones(3).sum()
    assert prof.stop_trace() == str(tmp_path / "b")
    assert os.path.exists(tmp_path / "a" / "trace.json")
    assert os.path.exists(tmp_path / "b" / "trace.json")
