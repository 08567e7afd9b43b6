"""The port's fault injection (``resilience/faults.py``, a copy of the JAX
package's), held against the JAX package: one ``FaultPlan(seed).inject(site,
probability=p, max_fires=k)`` fires at the same invocation indices in both
packages, every site of the reference exists, the corrupt action
NaN-poisons a copy of a float numpy array or torch tensor and passes
anything else through, ``active_plan`` names the armed plan, and a scoped
site (``serving.launch:<name>``, ``#canary``) fires only for its tenant.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
)
from deeplearning4j_tpu_torch.telemetry import REGISTRY

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def disarmed():
    faults._ACTIVE = None
    jfaults._ACTIVE = None
    yield
    faults._ACTIVE = None
    jfaults._ACTIVE = None


def _fired(mod, seed, site, n, **inject):
    """1-based invocation indices at which ``site`` raised over ``n``
    calls under ``mod.FaultPlan(seed).inject(site, **inject)``."""
    plan = mod.FaultPlan(seed=seed).inject(site, **inject)
    hits = []
    with plan.armed():
        for i in range(1, n + 1):
            try:
                mod.fault_point(site)
            except mod.InjectedFault as e:
                assert (e.site, e.invocation) == (site, i)
                hits.append(i)
    assert plan.invocations(site) == n
    assert plan.fired(site) == len(hits)
    return hits


def test_sites_are_the_references():
    assert faults.SITES == jfaults.SITES
    assert len(faults.SITES) == 10


@pytest.mark.parametrize("seed,site,p,k", [
    (42, "train.step", 0.3, None),
    (43, "train.step", 0.3, None),
    (7, "serving.launch:resnet#canary", 0.5, None),
    (11, "model.load", 0.2, 3),
    (0, "decode.launch:lm", 0.9, 5),
])
def test_probability_stream_equals_the_jax_packages(seed, site, p, k):
    got = _fired(faults, seed, site, 80, probability=p, max_fires=k)
    want = _fired(jfaults, seed, site, 80, probability=p, max_fires=k)
    assert got == want
    assert 0 < len(got) < 80
    if k is not None:
        assert len(got) == k


def test_on_calls_and_seed_streams():
    assert _fired(faults, 7, "train.step", 5, on_calls=[2, 4]) == [2, 4]
    a = _fired(faults, 42, "train.step", 60, probability=0.3)
    assert a == _fired(faults, 42, "train.step", 60, probability=0.3)
    assert a != _fired(faults, 43, "train.step", 60, probability=0.3)
    with pytest.raises(ValueError, match="not both"):
        FaultPlan().inject("train.step", on_calls=[1], probability=0.5)
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultPlan().inject("train.step", action="explode")


def test_corrupt_action_poisons_a_copy_of_floats_only():
    plan = FaultPlan().inject("train.step", action="corrupt")
    f32 = np.arange(4, dtype=np.float32)
    u8 = np.arange(4, dtype=np.uint8)
    t32 = torch.arange(3, dtype=torch.float32)
    t8 = torch.arange(3, dtype=torch.int8)
    with plan.armed():
        out = faults.fault_point("train.step", f32)
        assert np.isnan(out[0]) and not np.isnan(out[1:]).any()
        assert not np.isnan(f32).any()
        assert faults.fault_point("train.step", u8) is u8
        tout = faults.fault_point("train.step", t32)
        assert isinstance(tout, torch.Tensor)
        assert torch.isnan(tout[0]) and not torch.isnan(tout[1:]).any()
        assert not torch.isnan(t32).any()
        assert faults.fault_point("train.step", t8) is t8
        assert faults.fault_point("train.step") is None
    assert plan.fired("train.step") == 5
    assert REGISTRY.counter("dl4j_faults_injected_total", site="train.step",
                            action="corrupt").value >= 5


def test_disarmed_is_identity_and_active_plan():
    a = np.ones(3, np.float32)
    assert faults.active_plan() is None
    assert faults.fault_point("train.step", a) is a
    p1, p2 = FaultPlan(), FaultPlan()
    with p1.armed():
        assert faults.active_plan() is p1
        with pytest.raises(RuntimeError, match="already armed"):
            p2.arm()
    with p2.armed():
        assert faults.active_plan() is p2
    assert faults.active_plan() is None


def test_scoped_sites_fire_only_for_their_tenant():
    plan = FaultPlan(seed=3).inject("serving.launch:a#canary")
    with plan.armed():
        faults.fault_point("serving.launch:a")
        faults.fault_point("serving.launch")
        with pytest.raises(InjectedFault):
            faults.fault_point("serving.launch:a#canary")
    assert plan.invocations("serving.launch:a") == 1
    assert plan.fired() == 1


def test_corrupted_train_step_batch_reaches_the_network():
    """``train.step``'s corrupt action poisons the batch the port's
    MultiLayerNetwork trains on: the step's score is NaN."""
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=5))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, "cpu").init()
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(6, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
    with FaultPlan().inject("train.step", action="corrupt",
                            max_fires=1).armed():
        net.fit_batch(ds)
    assert np.isnan(net.score())
    net.fit_batch(ds)  # max_fires spent: a clean batch
