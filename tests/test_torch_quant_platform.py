"""Quantized versions on the port's serving platform, held against the JAX
package (the counterparts of ``tests/test_quant.py``'s registry, warmup and
accuracy-arm tests): a quantized version's registry round trip re-verifies
its digest and re-registers its calibration, a tampered zip or
quantization entry is refused, a quantized canary and its promote serve
their first traffic with no new envelope, and a mis-scaled int8 canary
rolls back at the same request index in two seeded runs and in the JAX
package's run.

The int8 artifact crosses the packages: a quantized network written by
either package's ``write_model`` (or ``ModelRegistry.publish``) restores in
the other with the same ``QuantizationSpec`` and digest, ``Wq`` a
C-contiguous int8 ``[K, N]``, and outputs within the port's int8 tolerance
of the writer's (atol 1e-5 on softmax outputs, ``Q_ATOL`` of
``tests/test_torch_multilayer.py``: the two packages' activations may
round one int8 input differently).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn import inference_opt as jiopt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import platform as jplat
from deeplearning4j_tpu.parallel.batcher import BatchingConfig as JBatching
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu_torch.conf.layers_quant import QuantizationSpec
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn import inference_opt as iopt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.parallel.batcher import BatchingConfig
from deeplearning4j_tpu_torch.parallel.platform import (
    CanaryGate,
    ModelIntegrityError,
    ModelPlatform,
    ModelRegistry,
    TenantConfig,
)
from deeplearning4j_tpu_torch.util import serializer
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

Q_ATOL = 1e-5
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_envelopes():
    aot_cache.clear()
    yield


def _jmlp(seed=3, n_in=9, hidden=27, n_out=4):
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=hidden, activation=JAct.RELU))
            .layer(JOut(n_out=n_out, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(n_in)).build())
    return JMLN(conf).init()


def _port(jnet):
    """The port's network on the JAX network's conf and params."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    return MultiLayerNetwork(conf, "cpu").set_params(p, s)


def _batches(n_in, n=3, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, n_in)).astype(np.float32)
            for _ in range(n)]


def _pair(hidden, seed=3):
    """(JAX f32, JAX int8, JAX record, port f32, port int8): the port's
    artifact is quantized from the JAX record, so both carry one spec."""
    jnet = _jmlp(seed=seed, hidden=hidden)
    jrec = jiopt.calibrate(jnet, _batches(9))
    jq = jiopt.quantize_for_inference(jnet, jrec)
    net = _port(jnet)
    q = iopt.quantize_for_inference(
        net, iopt.CalibrationRecord(**dataclasses.asdict(jrec)))
    return jnet, jq, jrec, net, q


def _params_equal(a, b):
    return all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


def _cfg():
    return TenantConfig(batching=BatchingConfig(max_batch=8))


# --------------------------------------------------------------------------
# registry round trip + tamper refusal
# --------------------------------------------------------------------------

def test_registry_roundtrip_reverifies_digest(tmp_path):
    net = MultiLayerNetwork(_port(_jmlp(hidden=34)).conf, "cpu").init()
    rec = iopt.calibrate(net, _batches(9))
    qnet = iopt.quantize_for_inference(net, rec)
    reg = ModelRegistry(tmp_path)
    reg.publish("m", net)
    v = reg.publish("m", qnet)
    ent = reg._read_manifest("m")["versions"][-1]
    assert ent["quantization"] == {"scheme": "int8",
                                   "calibration_digest": rec.digest}
    # a restarted process: no live calibration until load re-registers it
    iopt.clear_calibrations()
    assert iopt.lookup_calibration(rec.digest) is None
    restored, got_v = reg.load("m", v, device="cpu")
    assert got_v == v
    assert _params_equal(restored.params, qnet.params)
    spec = restored.conf.quantization
    assert isinstance(spec, QuantizationSpec) and spec.digest == rec.digest
    live = iopt.lookup_calibration(rec.digest)
    assert live is not None and live.restored
    x = _batches(9, n=1, rows=4)[0]
    np.testing.assert_array_equal(restored.output(x), qnet.output(x))


def test_registry_tamper_refused(tmp_path):
    *_, qnet = _pair(hidden=35)
    reg = ModelRegistry(tmp_path / "a")
    v = reg.publish("m", qnet)
    path = Path(reg._dir("m")) / f"v{v:04d}.zip"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(ModelIntegrityError, match="sha256"):
        reg.load("m", v, retry=None, device="cpu")
    # the zip intact, the manifest's quantization entry swapped for another
    # calibration's digest: refused as a metadata mismatch
    reg2 = ModelRegistry(tmp_path / "b")
    v2 = reg2.publish("m", qnet)
    man = reg2._read_manifest("m")
    man["versions"][-1]["quantization"]["calibration_digest"] = "0" * 64
    with reg2._model_lock("m"):
        reg2._write_manifest_locked("m", man)
    with pytest.raises(ModelIntegrityError, match="quantization metadata"):
        reg2.load("m", v2, retry=None, device="cpu")
    # and an f32 zip under a quantized manifest row
    reg2.publish("m", MultiLayerNetwork(_port(_jmlp(hidden=35)).conf,
                                        "cpu").init())
    man = reg2._read_manifest("m")
    man["versions"][-1]["quantization"] = man["versions"][0]["quantization"]
    with reg2._model_lock("m"):
        reg2._write_manifest_locked("m", man)
    with pytest.raises(ModelIntegrityError, match="quantization metadata"):
        reg2.load("m", retry=None, device="cpu")


# --------------------------------------------------------------------------
# the int8 artifact across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_zip_crosses_packages(tmp_path, writer):
    _, jq, jrec, _, q = _pair(hidden=33)
    path = tmp_path / "q.zip"
    if writer == "jax":
        jser.write_model(jq, path)
    else:
        serializer.write_model(q, path)
    got = serializer.restore_model(path, device="cpu")
    jgot = jser.restore_model(path)
    for spec in (got.conf.quantization, jgot.conf.quantization):
        assert (spec.scheme, spec.digest, spec.seed, spec.clip_percentile) \
            == ("int8", jrec.digest, jrec.seed, jrec.clip_percentile)
    wq = got.params["0"]["Wq"]
    assert wq.dtype == torch.int8 and wq.is_contiguous()
    assert tuple(wq.shape) == (9, 33)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq.params["0"]["Wq"]))
    assert _params_equal(got.params, q.params)
    x = _batches(9, n=1, rows=5, seed=4)[0]
    want = np.asarray(jq.output(x)) if writer == "jax" else q.output(x)
    np.testing.assert_allclose(got.output(x), want, rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(np.asarray(jgot.output(x)), want, rtol=0,
                               atol=Q_ATOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quantized_registry_entry_crosses_packages(tmp_path, writer):
    _, jq, jrec, _, q = _pair(hidden=32)
    if writer == "jax":
        jplat.ModelRegistry(tmp_path).publish("m", jq)
    else:
        ModelRegistry(tmp_path).publish("m", q)
    preg, jreg = ModelRegistry(tmp_path), jplat.ModelRegistry(tmp_path)
    ent = preg._read_manifest("m")["versions"][-1]
    assert ent["quantization"] == {"scheme": "int8",
                                   "calibration_digest": jrec.digest}
    assert preg.digest("m") == jreg.digest("m")
    got, _ = preg.load("m", device="cpu")
    jgot, _ = jreg.load("m")
    assert got.conf.quantization.digest == jgot.conf.quantization.digest \
        == jrec.digest
    x = _batches(9, n=1, rows=3, seed=5)[0]
    np.testing.assert_allclose(got.output(x), np.asarray(jgot.output(x)),
                               rtol=0, atol=Q_ATOL)


# --------------------------------------------------------------------------
# warmup: a quantized deploy serves its first traffic warm
# --------------------------------------------------------------------------

def test_quantized_deploy_warm_zero_recompiles_first_traffic(tmp_path):
    """A quantized canary (and then its promote) serves its FIRST request
    with no new envelope: deploy_canary and promote warm the quantized
    buckets up front. The accuracy arm compares it with the f32 incumbent,
    whose outputs are the JAX package's."""
    jnet, _, _, net, qnet = _pair(hidden=37)
    reg = ModelRegistry(tmp_path)
    reg.publish("m", net)
    reg.publish("m", qnet)
    with ModelPlatform(reg, seed=11, device="cpu") as plat:
        plat.deploy("m", version=1, config=_cfg())
        probe = _batches(9, n=1, rows=2, seed=49)[0]
        np.testing.assert_allclose(plat.engine("m").predict(probe),
                                   np.asarray(jnet.output(probe)), **F32_TOL)
        plat.deploy_canary("m", version=2, fraction=1.0,
                           gate=CanaryGate(min_requests=4,
                                           max_accuracy_delta=0.5))
        miss0 = aot_cache.stats()["misses"]
        for i in range(12):
            plat.predict("m", _batches(9, n=1, rows=2, seed=50 + i)[0])
        assert aot_cache.stats()["misses"] == miss0
        st = plat.stats()["m"]["canary"]
        assert st["accuracy_samples"] > 0
        assert st["accuracy_max_delta"] < 0.5
        r = plat.promote("m")
        assert r["version"] == 2
        miss1 = aot_cache.stats()["misses"]
        for i in range(6):
            x = _batches(9, n=1, rows=2, seed=80 + i)[0]
            np.testing.assert_array_equal(plat.predict("m", x),
                                          qnet.output(x))
        assert aot_cache.stats()["misses"] == miss1


# --------------------------------------------------------------------------
# accuracy-armed canary: deterministic regression rollback
# --------------------------------------------------------------------------

def _corrupted(q, jax_side):
    if jax_side:
        bad = JMLN(q.conf)
        bad.params = {k: dict(v) for k, v in q.params.items()}
        bad.state, bad.opt_state = q.state, {}
        bad.params["0"]["scale"] = q.params["0"]["scale"] * 10.0
        return bad
    bad = MultiLayerNetwork(q.conf, "cpu").set_params(q.params, q.state)
    bad.params["0"]["scale"] = q.params["0"]["scale"] * 10.0
    return bad


def _regression_replay(tmp_path, package, nets):
    jax_side = package == "jax"
    if jax_side:
        reg = jplat.ModelRegistry(tmp_path)
        plat = jplat.ModelPlatform(reg, seed=42)
        cfg = jplat.TenantConfig(batching=JBatching(max_batch=8))
        gate = jplat.CanaryGate(min_requests=5, max_accuracy_delta=0.05)
    else:
        reg = ModelRegistry(tmp_path)
        plat = ModelPlatform(reg, seed=42, device="cpu")
        cfg = _cfg()
        gate = CanaryGate(min_requests=5, max_accuracy_delta=0.05)
    probe = _batches(9, n=1, rows=2, seed=7)[0]
    xs = [_batches(9, n=1, rows=2, seed=200 + i)[0] for i in range(40)]
    try:
        plat.deploy("m", version=1, config=cfg)
        plat.deploy("co", version=1, config=cfg)
        co_bytes = np.asarray(plat.predict("co", probe)).tobytes()
        plat.deploy_canary("m", version=99, model=nets["bad"], fraction=0.5,
                           gate=gate)
        miss0 = aot_cache.stats()["misses"]
        rollback = None
        for x in xs:
            plat.predict("m", x)
            assert np.asarray(plat.predict("co", probe)).tobytes() \
                == co_bytes
            rollback = plat.stats()["m"].get("last_rollback")
            if rollback:
                break
        assert rollback is not None, "accuracy arm never tripped"
        assert "accuracy arm" in rollback["reason"]
        if not jax_side:
            assert aot_cache.stats()["misses"] == miss0
        return rollback["at_request"]
    finally:
        plat.close()


def test_accuracy_regression_rolls_back_deterministically(tmp_path):
    """A mis-scaled int8 canary trips the accuracy arm at the SAME request
    index in two fresh port replays and in the JAX package's, the f32
    co-tenant byte-identical, no new envelope after warmup."""
    jnet, jq, _, net, q = _pair(hidden=38)
    jco = _jmlp(seed=9, hidden=39)
    jreg = jplat.ModelRegistry(tmp_path / "jax")
    jreg.publish("m", jnet)
    jreg.publish("co", jco)
    preg = ModelRegistry(tmp_path / "port")
    preg.publish("m", net)
    preg.publish("co", _port(jco))
    port_nets = {"bad": _corrupted(q, jax_side=False)}
    at = [_regression_replay(tmp_path / "port", "port", port_nets)
          for _ in range(2)]
    at_jax = _regression_replay(tmp_path / "jax", "jax",
                                {"bad": _corrupted(jq, jax_side=True)})
    assert at[0] == at[1] == at_jax
