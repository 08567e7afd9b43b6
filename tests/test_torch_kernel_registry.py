"""The port's kernel registry, per-shape tuner and tuning cache on the CPU,
against the JAX package's (``tests/test_kernels.py``'s registry, tuner and
routing tests, run on the port).

- the autotune of a ``use_kernels`` toy net records its winners and the
  four telemetry series; the tuning digest follows the winner set and
  equals the JAX package's digest for the same winners and version;
- a winner persists across ``bind`` and across a subprocess (bound by
  ``DL4J_TORCH_KERNEL_CACHE``); a corrupt file, a wrong version and a wrong
  digest each raise ``TuningCacheCorruptError`` naming the file, and the
  forward still runs; an illegal hand-edited winner is refused and the
  kernel runs at its default tiling;
- an untuned ``use_kernels`` forward passes no tiling to any wrapper (the
  launchers' default rule, as before the registry) and gives the same
  bits; a retune changes ``cache_tag`` and the next forward's tiling;
  ``cache_tag`` is memoized against the epoch and empty without
  ``use_kernels``;
- ``plan_envelopes(..., mode="cuda")`` gives the JAX package's
  ``plan_envelopes(..., mode="tpu")`` list for ResNet-50 (plain,
  ``fused_conv_bn``, the s2d stem, bf16), LeNet and an int8 AlexNet, and
  ``decoder_envelopes`` the JAX list for a small LM decoder;
- after ``autotune_model`` a CPU forward selects every planned envelope;
  ``GenerationEngine.warmup(autotune_kernels=True)`` returns the JAX
  ``kernels`` dict;
- each candidate rule is held against the launcher's limits, read from the
  ``.cu`` constants, and each wrapper hands its tiling to the launcher (0
  for the default rule) through a stand-in library.

On the CPU every wrapper runs its plain version, so the tuner's times rank
the plain version; the card's sweep is ``chip_smoke.py`` [25].
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import kernels as jkernels
from deeplearning4j_tpu_torch import kernels, telemetry
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
)
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.kernels import impls, registry, routing
from deeplearning4j_tpu_torch.kernels.registry import (
    AttentionEnvelope,
    MatmulEnvelope,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import attention as att

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "deeplearning4j_tpu_torch" / "csrc"


@pytest.fixture(autouse=True)
def _fresh_tuning():
    kernels.TUNING.clear()
    jkernels.TUNING.clear()
    yield
    kernels.TUNING.clear()
    jkernels.TUNING.clear()


def _env(m, k, n, dtype="float32", act="identity", backend="cpu"):
    return MatmulEnvelope(m, k, n, dtype, backend, act)


def _toy_conf(use_kernels=True, width=12, compute_dtype=None):
    """A 1x1 conv (relu), a train-mode fused 1x1 conv + BN and a dense
    layer over 6x6x3 inputs: one site of each float GEMM kernel."""
    b = NeuralNetConfiguration.builder().seed(3).use_kernels(use_kernels)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(1, 1),
                                    convolution_mode=ConvolutionMode.SAME,
                                    activation=Activation.RELU))
            .layer(FusedConvBN1x1(n_out=6, stride=(2, 2)))
            .layer(DenseLayer(n_out=width, activation=Activation.TANH))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(it.Convolutional(6, 6, 3))
            .build())


def _net(use_kernels=True, **kw):
    return MultiLayerNetwork(_toy_conf(use_kernels, **kw), "cpu").init()


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 6, 6, 3)).astype(np.float32)


def _snapshot():
    return telemetry.REGISTRY.snapshot(run_collectors=False)


# ---------------------------------------------------------------------------
# tuner: winners, counters, digests
# ---------------------------------------------------------------------------

def test_registry_has_the_jax_kernel_ids():
    assert kernels.REGISTRY.ids() == jkernels.REGISTRY.ids()
    assert kernels.REGISTRY.ids() == sorted([
        "matmul_bias_act", "matmul_bias_act_int8", "conv_bn_act",
        "flash_attention", "paged_decode_attention"])


def test_autotune_of_a_toy_net_records_winners_and_counters():
    telemetry.reset()
    conf = _toy_conf(width=11)
    res = kernels.autotune_model(conf, 4, trials=1)
    planned = kernels.plan_envelopes(conf, 4)
    assert [(r.kernel_id, r.env_key) for r in res] == [
        (kid, env.key) for kid, env in planned]
    assert {kid for kid, _ in planned} == {"matmul_bias_act", "conv_bn_act"}
    for r, (kid, env) in zip(res, planned):
        win = kernels.TUNING.winner(kid, env.key)
        assert tuple(win["tiling"]) == r.tiling and win["backend"] == "cpu"
        assert r.default == kernels.REGISTRY.get(kid).default_tiling(env)
        assert r.default_ms is not None
    snap = _snapshot()
    for kid in ("matmul_bias_act", "conv_bn_act"):
        n = sum(kid == r.kernel_id for r in res)
        assert snap[f'dl4j_kernel_autotune_trials_total{{kernel="{kid}"}}'] \
            == 2 * n  # two candidate tilings an envelope
        assert snap[f'dl4j_kernel_autotune_winners_total{{kernel="{kid}"}}'] \
            == n
    assert snap["dl4j_kernel_tuning_cache_entries"] == len(planned)
    # a second call skips what is tuned; retune sweeps again
    assert kernels.autotune_model(conf, 4, trials=1) == []
    assert len(kernels.autotune_model(conf, 4, retune=True, trials=1)) \
        == len(planned)
    # the forward resolves every site's winner once: the fourth series
    MultiLayerNetwork(conf, "cpu").init().output(_batch())
    snap = _snapshot()
    selected = {k for k in snap if k.startswith("dl4j_kernel_selected_total")}
    assert any('kernel="matmul_bias_act"' in k for k in selected)
    assert snap["dl4j_kernel_tuning_cache_hits"] >= 2
    assert "dl4j_kernel_tuning_cache_entries" in telemetry.prometheus_text()


def test_tuning_digest_tracks_winner_set():
    d0 = kernels.tuning_digest("matmul_bias_act")
    env = _env(32, 16, 8)
    kernels.TUNING.record("matmul_bias_act", env.key, (64, 64), 1.0)
    d1 = kernels.tuning_digest("matmul_bias_act")
    assert d0 != d1
    kernels.TUNING.record("matmul_bias_act", env.key, (128, 64), 0.9)
    assert kernels.tuning_digest("matmul_bias_act") not in (d0, d1)
    assert kernels.tuning_digest("conv_bn_act") == d0  # empty table


WINNER_TABLES = [
    {},
    {"matmul_bias_act": [("cuda:m100352:k64:n64:float32:identity",
                          (128, 64), 0.123, "cuda")]},
    {"matmul_bias_act_int8": [("cuda:m32:k6400:n4096:int8:relu", (2, 2),
                               0.0213, "cuda"),
                              ("cuda:m32:k4096:n4096:int8:relu", (3, 4),
                               0.0177, "cuda")],
     "paged_decode_attention": [
         ("cuda:b8:h12:tq1:tk1024:d64:float32:c1:m0", (32,), 0.0181, "cuda")],
     "flash_attention": [
         ("cuda:b8:h12:tq1024:tk1024:d64:float32:c1:m1", (64, 64), 0.19,
          "cuda")]},
]


@pytest.mark.parametrize("table", WINNER_TABLES, ids=["empty", "one", "mixed"])
def test_digest_equals_the_jax_packages(table):
    """The same winners and kernel versions give the JAX package's digests
    and the same ``cache_tag`` string."""
    for kid, rows in table.items():
        for key, tiling, ms, backend in rows:
            kernels.TUNING.record(kid, key, tiling, ms, backend=backend)
            jkernels.TUNING.record(kid, key, tiling, ms, backend=backend)
    for kid in kernels.REGISTRY.ids():
        assert kernels.REGISTRY.get(kid).version == \
            jkernels.REGISTRY.get(kid).version
        assert kernels.tuning_digest(kid) == jkernels.tuning_digest(kid)
    assert kernels.REGISTRY.cache_tag() == jkernels.REGISTRY.cache_tag()


def test_winner_persists_across_bind(tmp_path):
    path = str(tmp_path / "tuning.json")
    kernels.set_tuning_cache(path)
    env = _env(32, 16, 8, act="relu")
    res = kernels.autotune(kernels.REGISTRY.get("matmul_bias_act"), env,
                           trials=1)
    blob = json.loads(Path(path).read_text())
    assert sorted(blob) == ["digest", "version", "winners"]
    fresh = kernels.TuningCache().bind(path)
    assert tuple(fresh.winner("matmul_bias_act",
                              env.key)["tiling"]) == res.tiling
    other = kernels.KernelRegistry(cache=fresh)
    for kid in kernels.REGISTRY.ids():
        other.register(kernels.REGISTRY.get(kid))
    assert other.tuning_digest("matmul_bias_act") == \
        kernels.tuning_digest("matmul_bias_act")
    assert other.cache_tag() == kernels.cache_tag()
    # the JAX package reads the same layout
    assert tuple(jkernels.TuningCache().bind(path).winner(
        "matmul_bias_act", env.key)["tiling"]) == res.tiling


def test_winner_persists_across_a_subprocess(tmp_path):
    path = str(tmp_path / "tuning.json")
    kernels.set_tuning_cache(path)
    env = _env(32, 16, 8, act="relu")
    kernels.autotune(kernels.REGISTRY.get("matmul_bias_act"), env, trials=1)
    code = ("import json\n"
            "from deeplearning4j_tpu_torch import kernels\n"
            f"w = kernels.TUNING.winner('matmul_bias_act', {env.key!r})\n"
            "print(json.dumps({'tiling': w['tiling'], 'path': "
            "kernels.TUNING.path, 'digest': "
            "kernels.tuning_digest('matmul_bias_act')}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, DL4J_TORCH_KERNEL_CACHE=path))
    assert out.returncode == 0, out.stderr
    blob = json.loads(out.stdout.strip().splitlines()[-1])
    assert tuple(blob["tiling"]) == tuple(
        kernels.TUNING.winner("matmul_bias_act", env.key)["tiling"])
    assert blob["path"] == path
    assert blob["digest"] == kernels.tuning_digest("matmul_bias_act")


def _corrupt(path, how):
    blob = json.loads(Path(path).read_text())
    if how == "garbage":
        Path(path).write_text("{not json")
        return "unreadable JSON"
    if how == "version":
        blob["version"] = 2
        reason = "version"
    else:
        key = next(iter(blob["winners"]["matmul_bias_act"]))
        blob["winners"]["matmul_bias_act"][key]["tiling"] = [64, 64] \
            if blob["winners"]["matmul_bias_act"][key]["tiling"] != [64, 64] \
            else [128, 64]
        reason = "digest mismatch"
    Path(path).write_text(json.dumps(blob))
    return reason


@pytest.mark.parametrize("how", ["garbage", "version", "digest"])
def test_corrupt_cache_is_refused_by_name_and_the_forward_runs(tmp_path,
                                                               how):
    path = str(tmp_path / "tuning.json")
    conf = _toy_conf(width=13)
    net = MultiLayerNetwork(conf, "cpu").init()
    x = _batch(seed=1)
    want = net.output(x)
    kernels.set_tuning_cache(path)
    kernels.autotune_model(conf, 4, trials=1)
    reason = _corrupt(path, how)
    kernels.TUNING.clear()
    with pytest.raises(kernels.TuningCacheCorruptError) as ei:
        kernels.set_tuning_cache(path)
    assert path in str(ei.value) and reason in str(ei.value)
    assert ei.value.path == path
    assert kernels.TUNING.entries() == 0 and kernels.TUNING.path is None
    for kid, env in kernels.plan_envelopes(conf, 4):
        sel = kernels.REGISTRY.select(kid, env)
        assert not sel.tuned
        assert sel.tiling == kernels.REGISTRY.get(kid).default_tiling(env)
    np.testing.assert_array_equal(net.output(x), want)
    net.fit(x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])


def test_illegal_hand_edited_winner_is_refused_and_runs_the_default():
    env = _env(32, 16, 8)
    kernels.TUNING.record("matmul_bias_act", env.key, (96, 64), 1.0)
    sel = kernels.REGISTRY.select("matmul_bias_act", env)
    assert not sel.tuned and sel.tiling == (64, 64)
    penv = AttentionEnvelope(8, 2, 1, 128, 16, "float32", "cpu")
    kernels.TUNING.record("paged_decode_attention", penv.key, (128,), 1.0)
    sel = kernels.REGISTRY.select("paged_decode_attention", penv)
    assert not sel.tuned and sel.tiling == (64,)
    ienv = _env(32, 4096, 4096, dtype="int8", act="relu")
    for bad in ((0, 2), (2, 3), (2, 16), (9, 1)):  # cfg 0 cannot hold M 32
        kernels.TUNING.record("matmul_bias_act_int8", ienv.key, bad, 1.0)
        sel = kernels.REGISTRY.select("matmul_bias_act_int8", ienv)
        assert not sel.tuned and sel.tiling == (2, 2)
    # the route runs the kernel (here its plain version) at the default
    seen = []
    real = impls.matmul_bias_act

    def spy(x, w, b, act, tiling=None):
        seen.append(tiling)
        return real(x, w, b, act, tiling)

    layer = DenseLayer(n_out=8, activation=Activation.RELU)
    x = torch.randn(32, 16)
    params = {"W": torch.randn(8, 16), "b": torch.randn(8)}
    kernels.TUNING.record("matmul_bias_act", _env(32, 16, 8, act="relu").key,
                          (96, 64), 1.0)
    try:
        impls.matmul_bias_act = spy
        y, _ = routing.maybe_forward(layer, params, {}, x)
    finally:
        impls.matmul_bias_act = real
    assert seen == [None]
    torch.testing.assert_close(y, torch.relu(x @ params["W"].T + params["b"]))


# ---------------------------------------------------------------------------
# the routes: untuned, tuned, retuned
# ---------------------------------------------------------------------------

class _Spies:
    """Wrap the three float wrappers the toy net routes, recording the
    tiling each call passes; ``drop_tiling`` calls the real wrapper as the
    routes called it before the registry (no tiling argument)."""

    def __init__(self, monkeypatch, drop_tiling=False):
        self.calls = []
        for name in ("matmul_bias_act", "matmul_stats"):
            real = getattr(impls, name)

            def spy(*args, _real=real, _name=name, tiling=None):
                if len(args) > (4 if _name == "matmul_bias_act" else 2):
                    *args, tiling = args
                self.calls.append((_name, tiling))
                return _real(*args) if drop_tiling else _real(*args, tiling)

            monkeypatch.setattr(impls, name, spy)


def test_untuned_forward_is_the_forward_before_the_registry(monkeypatch):
    """Untuned, every route passes no tiling (the launchers' default rule)
    and the outputs and gradients are the bits of the same routes calling
    the wrappers as they did before the registry."""
    net = _net(width=14)
    x = _batch(seed=2)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    spies = _Spies(monkeypatch)
    out = net.output(x)
    grads, score = net.compute_gradient_and_score(DataSet(x, y))
    assert sorted(set(spies.calls)) == [("matmul_bias_act", None),
                                        ("matmul_stats", None)]
    monkeypatch.undo()
    _Spies(monkeypatch, drop_tiling=True)
    np.testing.assert_array_equal(net.output(x), out)
    grads2, score2 = net.compute_gradient_and_score(DataSet(x, y))
    assert score2 == score
    for k, gp in grads.items():
        for pk, g in gp.items():
            assert torch.equal(g, grads2[k][pk]), (k, pk)


def test_tuned_forward_passes_the_winners_and_a_retune_changes_them(
        monkeypatch):
    conf = _toy_conf(width=15)
    net = MultiLayerNetwork(conf, "cpu").init()
    x = _batch(seed=3)
    untuned = net.output(x)
    tag0 = kernels.cache_tag(conf)
    kernels.autotune_model(conf, 4, trials=1)
    tag1 = kernels.cache_tag(conf)
    assert tag1 != tag0 and net._ktag() == tag1
    spies = _Spies(monkeypatch)
    np.testing.assert_array_equal(net.output(x), untuned)  # plain on the CPU
    planned = dict((env.key, (kid, env)) for kid, env in
                   kernels.plan_envelopes(conf, 4))
    mm = [env for kid, env in planned.values() if kid == "matmul_bias_act"]
    want = {tuple(kernels.TUNING.winner("matmul_bias_act", e.key)["tiling"])
            for e in mm}
    assert {t for n, t in spies.calls if n == "matmul_bias_act"} == want
    # retune: another candidate recorded for every matmul_bias_act envelope
    for env in mm:
        cur = tuple(kernels.TUNING.winner("matmul_bias_act", env.key)[
            "tiling"])
        other = [c for c in kernels.REGISTRY.get("matmul_bias_act")
                 .candidates(env) if c != cur][0]
        kernels.TUNING.record("matmul_bias_act", env.key, other, 0.1,
                              backend="cpu")
    tag2 = kernels.cache_tag(conf)
    assert tag2 not in (tag0, tag1)
    spies.calls.clear()
    net.output(x)
    assert {t for n, t in spies.calls if n == "matmul_bias_act"} == {
        tuple(kernels.TUNING.winner("matmul_bias_act", e.key)["tiling"])
        for e in mm}


def test_cache_tag_is_memoized_and_empty_without_use_kernels():
    off = _toy_conf(use_kernels=False)
    assert kernels.cache_tag(off) == ""
    assert MultiLayerNetwork(off, "cpu")._ktag() == ""
    on = _toy_conf()
    t1 = kernels.cache_tag(on)
    assert kernels.cache_tag(on) is t1  # the memo, not a new join
    assert t1 == "".join(f":kern:{kid}:{kernels.tuning_digest(kid)}"
                         for kid in kernels.REGISTRY.ids())
    kernels.TUNING.record("conv_bn_act", _env(8, 8, 8).key, (64,), 1.0)
    t2 = kernels.cache_tag(on)
    assert t2 != t1 and kernels.cache_tag(on) is t2


def test_select_is_memoized_per_envelope_against_the_epoch():
    telemetry.reset()
    env = _env(32, 16, 8, act="relu")
    k = kernels.REGISTRY.get("matmul_bias_act")
    a = kernels.REGISTRY.select("matmul_bias_act", env)
    assert a is kernels.REGISTRY.select("matmul_bias_act", env)
    assert not a.tuned and a.tiling == k.default_tiling(env)
    misses = kernels.TUNING.misses
    kernels.REGISTRY.select("matmul_bias_act", env)
    assert kernels.TUNING.misses == misses  # one lookup per epoch
    kernels.TUNING.record("matmul_bias_act", env.key, (128, 64), 1.0)
    b = kernels.REGISTRY.select("matmul_bias_act", env)
    assert b.tuned and b.tiling == (128, 64)
    kernels.REGISTRY.select("matmul_bias_act", env)
    key = ('dl4j_kernel_selected_total{kernel="matmul_bias_act",'
           'shape_bucket="m32_k16_n8"}')
    assert _snapshot()[key] == 1  # once per envelope per epoch
    assert kernels.REGISTRY.select("matmul_bias_act",
                                   _env(32, 16, 8, dtype="float64")) is None


def test_after_autotune_model_a_forward_selects_every_planned_envelope():
    conf = _toy_conf(width=16)
    kernels.autotune_model(conf, 4, trials=1)
    telemetry.reset()
    net = MultiLayerNetwork(conf, "cpu").init()
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    net.output(_batch(seed=4))  # eval: the 1x1 conv and the dense layer
    net.compute_gradient_and_score(DataSet(
        _batch(seed=4), np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]))
    _, memo = kernels.REGISTRY._selected
    snap = _snapshot()
    for kid, env in kernels.plan_envelopes(conf, 4):
        sel = memo[(kid, env)]
        assert sel.tuned and sel.tiling == tuple(
            kernels.TUNING.winner(kid, env.key)["tiling"])
        assert snap[f'dl4j_kernel_selected_total{{kernel="{kid}",'
                    f'shape_bucket="{env.shape_bucket}"}}'] == 1
    assert all(sel.tuned for sel in memo.values() if sel is not None)


def test_attention_routes_select_their_envelopes():
    telemetry.reset()
    fk = kernels.REGISTRY.get("flash_attention")
    env = AttentionEnvelope(2, 2, 16, 16, 8, "float32", "cpu", True, True)
    q, k, v, km = fk.make_inputs(env, seed=3)
    untuned = kernels.maybe_flash_attention(q, k, v, km, causal=True)
    res = kernels.autotune(fk, env, trials=1)
    assert res.tiling == att.flash_tiles(8) == (64, 64)
    assert len(res.trials) == 1  # one candidate: recorded all the same
    out = kernels.maybe_flash_attention(q, k, v, km, causal=True)
    torch.testing.assert_close(out, fk.reference(env)(q, k, v, km))
    assert torch.equal(out, untuned)
    pk = kernels.REGISTRY.get("paged_decode_attention")
    penv = AttentionEnvelope(2, 2, 1, 64, 8, "float32", "cpu")
    assert pk.candidates(penv) == [(64,), (32,), (16,), (8,)]
    kernels.autotune(pk, penv, trials=1)
    args = pk.make_inputs(penv, seed=4)
    torch.testing.assert_close(kernels.maybe_decode_attention(*args),
                               pk.reference(penv)(*args))
    snap = _snapshot()
    for kid in ("flash_attention", "paged_decode_attention"):
        assert any(key.startswith(f'dl4j_kernel_selected_total{{kernel='
                                  f'"{kid}"') for key in snap)
    # an S that min(64, S) does not divide takes the stock read, as before
    s96 = AttentionEnvelope(2, 2, 1, 96, 8, "float32", "cpu")
    assert not pk.supports(s96)


# ---------------------------------------------------------------------------
# planning against the JAX package
# ---------------------------------------------------------------------------

def _matmul_rows(pairs, strip):
    out = []
    for kid, env in pairs:
        key = env.key.split(":", 1)[1] if strip else env.key
        if isinstance(env, (MatmulEnvelope, jkernels.MatmulEnvelope)):
            out.append((kid, env.m, env.k, env.n, env.dtype, env.act, key))
        else:
            out.append((kid, env.b, env.h, env.tq, env.tk, env.d, env.dtype,
                        env.causal, env.masked, key))
    return out


def _resnet(pkg, **flags):
    if pkg == "jax":
        from deeplearning4j_tpu.zoo.graphs import ResNet50
    else:
        from deeplearning4j_tpu_torch.zoo.graphs import ResNet50
    zoo = ResNet50()
    for k, v in flags.items():
        setattr(zoo, k, v)
    return zoo.conf()


def _lenet(pkg):
    if pkg == "jax":
        from deeplearning4j_tpu.zoo.models import LeNet
    else:
        from deeplearning4j_tpu_torch.zoo.models import LeNet
    return LeNet().conf()


def _alexnet_int8(pkg):
    """AlexNet's conf with its hidden dense layers swapped for their int8
    twins, as ``quantize_for_inference`` swaps the calibrated ones."""
    if pkg == "jax":
        from deeplearning4j_tpu.conf import layers as L
        from deeplearning4j_tpu.conf.layers_quant import QuantizedDenseLayer
        from deeplearning4j_tpu.zoo.models import AlexNet
    else:
        from deeplearning4j_tpu_torch.conf import layers as L
        from deeplearning4j_tpu_torch.conf.layers_quant import (
            QuantizedDenseLayer,
        )
        from deeplearning4j_tpu_torch.zoo.models import AlexNet
    conf = AlexNet().conf()
    layers = [QuantizedDenseLayer(name=layer.name,
                                  activation=layer.activation,
                                  n_out=layer.n_out)
              if type(layer) is L.DenseLayer else layer
              for layer in conf.layers]
    assert sum(type(la) is QuantizedDenseLayer for la in layers) == 2
    return dataclasses.replace(conf, layers=tuple(layers))


CONFS = {
    "resnet50": (lambda p: _resnet(p), 32),
    "resnet50_fused": (lambda p: _resnet(p, fused_conv_bn=True), 32),
    "resnet50_s2d_fused_bf16": (lambda p: dataclasses.replace(
        _resnet(p, fused_conv_bn=True, stem_space_to_depth=True),
        compute_dtype="bfloat16"), 16),
    "lenet": (_lenet, 64),
    "alexnet_int8": (_alexnet_int8, 32),
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_plan_envelopes_match_the_jax_package(name):
    make, batch = CONFS[name]
    got = kernels.plan_envelopes(make("torch"), batch, mode="cuda")
    want = jkernels.plan_envelopes(make("jax"), batch, mode="tpu")
    assert got, name
    assert _matmul_rows(got, strip=True) == _matmul_rows(want, strip=True)
    assert all(env.backend == "cuda" for _, env in got)
    if name.startswith("resnet50"):
        kid = "conv_bn_act" if "fused" in name else "matmul_bias_act"
        assert {k for k, _ in got} == {kid} and len(got) == 15


def test_decoder_envelopes_match_the_jax_package():
    from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JLM
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    kw = dict(vocab_size=32, embed_dim=32, n_heads=4, n_layers=2,
              max_len=64, causal=True, lm_head=True, seed=5)
    dec_kw = dict(max_batch=4, kv_bucket_min=16, prompt_bucket_min=4)
    jdec = JLM(**kw).decoder(**dec_kw)
    net = ComputationGraph(TransformerEncoder(**kw).conf(), device="cpu")
    dec = TransformerDecoder(net.init(), max_len=64, **dec_kw)
    got = kernels.decoder_envelopes(dec, mode="cuda")
    want = jkernels.decoder_envelopes(jdec, mode="tpu")
    assert _matmul_rows(got, strip=True) == _matmul_rows(want, strip=True)
    assert [k for k, _ in got].count("paged_decode_attention") == 3
    assert [k for k, _ in got].count("flash_attention") == 5 * 3


def test_warmup_autotune_returns_the_jax_kernels_dict():
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    zoo = TransformerEncoder(vocab_size=32, embed_dim=16, n_heads=2,
                             n_layers=1, max_len=32, causal=True,
                             lm_head=True, seed=6, use_kernels=True)
    net = ComputationGraph(zoo.conf(), device="cpu").init()
    dec = TransformerDecoder(net, max_len=32, max_batch=2, kv_bucket_min=16,
                             prompt_bucket_min=8)
    tag0 = dec._ktag()
    with GenerationEngine(dec, GenerationConfig(max_batch=2, fused_steps=2,
                                                kv_bucket_min=16,
                                                prompt_bucket_min=8)) as eng:
        out = eng.warmup(autotune_kernels=True, trials=1)
        stream = eng.generate([1, 2, 3], max_new_tokens=4)
    assert out["kernels"] == {"enabled": True, "tag": dec._ktag()}
    assert out["kernels"]["tag"] != tag0
    for kid, env in kernels.decoder_envelopes(dec):
        assert kernels.TUNING.winner(kid, env.key) is not None
    assert len(stream) == 4
    assert stream == dec.generate([1, 2, 3], 4)


# ---------------------------------------------------------------------------
# candidate rules against the launchers' limits (read from the sources)
# ---------------------------------------------------------------------------

INT8_SRC = (CSRC / "matmul_bias_act_int8.cu").read_text()
DECODE_SRC = (CSRC / "paged_decode_attention.cu").read_text()
FLASH_SRC = (CSRC / "flash_common.cuh").read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_the_mirrored_constants_are_the_sources():
    tiles = re.search(r"constexpr int kTiles\[\d+\]\[4\] = \{(.*?)\};",
                      INT8_SRC, re.S).group(1)
    rows = tuple(tuple(int(v) for v in r.split(","))
                 for r in re.findall(r"\{([\d,\s]+)\}", tiles))
    assert rows == registry.INT8_TILES
    assert _const(INT8_SRC, "kWarpCols") == registry.INT8_WARP_COLS
    assert _const(INT8_SRC, "kUnit") == registry.INT8_UNIT
    assert _const(INT8_SRC, "kMaxRanks") == registry.INT8_MAX_RANKS
    assert _const(INT8_SRC, "kMinRows") == registry.INT8_MIN_ROWS
    assert _const(INT8_SRC, "kBlocksPerSm") == registry.INT8_BLOCKS_PER_SM
    assert _const(DECODE_SRC, "kMaxPage") == max(registry.PAGE_SWEEP)
    cfgs = dict((int(dp), (int(bq), int(bk))) for dp, bq, bk in re.findall(
        r"struct FlashCfg<(\d+)> \{\s*static constexpr int BQ = (\d+), "
        r"BK = (\d+);", FLASH_SRC))
    assert cfgs == att._FLASH_TILES
    for name in ("matmul_bias_act.cu", "matmul_stats.cu"):
        src = (CSRC / name).read_text()
        inst = set(re.findall(r"launch<T, (\d+), (\d+), \d+, \d+, kFresh>",
                              src))
        assert {(int(a), int(b)) for a, b in inst} == set(registry._GEMM_TILES)


def _launcher_takes_int8(cfg, ranks, m, n):
    """``dl4j_matmul_bias_act_int8``'s own checks on a plan."""
    bm = 8 * registry.INT8_TILES[cfg][2] * registry.INT8_TILES[cfg][1]
    bn = registry.INT8_WARP_COLS * registry.INT8_TILES[cfg][0]
    return (0 <= cfg < len(registry.INT8_TILES)
            and ranks & (ranks - 1) == 0 and 1 <= ranks
            <= registry.INT8_MAX_RANKS and -(-n // bn) <= 65535
            and -(-m // bm) * ranks <= 2 ** 31 - 1)


INT8_SHAPES = [(m, k, n) for m in (1, 8, 16, 32, 33, 64, 3136, 100352)
               for k, n in ((6400, 4096), (4096, 4096), (64, 64), (1001, 75),
                            (2048, 512))]


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_candidates_within_the_launchers_limits(m, k, n):
    from tests.test_torch_int8_mma import plan

    kern = kernels.REGISTRY.get("matmul_bias_act_int8")
    env = _env(m, k, n, dtype="int8", act="relu")
    cands = kern.candidates(env)
    # the default is the launcher's plan at an H100's 132 SMs (off the card)
    assert kern.default_tiling(env) == plan(m, n, k) == cands[0]
    assert len(set(cands)) == len(cands)
    units = -(-k // registry.INT8_UNIT)
    for cfg, ranks in cands:
        assert _launcher_takes_int8(cfg, ranks, m, n)
        assert ranks == 1 or units >= ranks * (
            registry.INT8_MIN_ROWS // registry.INT8_UNIT)
        bm = 8 * registry.INT8_TILES[cfg][2] * registry.INT8_TILES[cfg][1]
        assert cfg >= 3 or bm >= m  # configs 0-2 hold M in one row tile
    assert kern.candidates(env, limit=3) == cands[:3]


@pytest.mark.parametrize("m,n", [(32, 4096), (100352, 64), (1568, 2048),
                                 (64, 500), (6272, 256)])
def test_float_gemm_candidates_and_the_default_rule(m, n):
    for kid, tiles in (("matmul_bias_act", [(128, 64), (64, 64)]),
                       ("conv_bn_act", [(128,), (64,)])):
        kern = kernels.REGISTRY.get(kid)
        env = _env(m, 256, n)
        wide = -(-m // 128) * -(-n // 64) >= 2 * registry.H100_SMS
        assert kern.default_tiling(env) == tiles[0 if wide else 1]
        assert sorted(kern.candidates(env)) == sorted(tiles)
        assert kern.candidates(env)[0] == kern.default_tiling(env)


@pytest.mark.parametrize("s", [1, 4, 8, 16, 32, 48, 64, 128, 1024, 96])
def test_page_candidates_within_kmaxpage(s):
    kern = kernels.REGISTRY.get("paged_decode_attention")
    env = AttentionEnvelope(8, 12, 1, s, 64, "float32", "cuda")
    if s % min(64, s):
        assert not kern.supports(env)
        return
    cands = kern.candidates(env)
    assert cands[0] == (min(64, s),) == kern.default_tiling(env)
    for (p,) in cands:
        assert 1 <= p <= _const(DECODE_SRC, "kMaxPage") and s % p == 0
    if s & (s - 1) == 0 and s >= 8:  # the decoder's buckets: JAX's sweep
        assert cands == [(p,) for p in (64, 32, 16, 8) if p <= s]


@pytest.mark.parametrize("d", [8, 32, 33, 64, 128, 256, 512])
def test_flash_candidate_is_the_head_sizes_flashcfg(d):
    kern = kernels.REGISTRY.get("flash_attention")
    env = AttentionEnvelope(2, 2, 64, 64, d, "bfloat16", "cuda")
    dp = next(p for p in (32, 64, 128, 256, 512) if d <= p)
    assert kern.candidates(env) == [att._FLASH_TILES[dp]]
    assert kern.tiling_ok(env, att._FLASH_TILES[dp])
    assert not kern.tiling_ok(env, (16, 16))


@pytest.mark.parametrize("kid", ["matmul_bias_act", "conv_bn_act",
                                 "matmul_bias_act_int8", "flash_attention",
                                 "paged_decode_attention"])
def test_every_candidate_builds_and_matches_the_plain_version(kid):
    envs = {
        "matmul_bias_act": _env(40, 24, 16, act="gelu"),
        "conv_bn_act": _env(40, 24, 16, dtype="bfloat16"),
        "matmul_bias_act_int8": _env(8, 96, 16, dtype="int8", act="relu"),
        "flash_attention": AttentionEnvelope(2, 2, 16, 16, 8, "float32",
                                             "cpu", True, True),
        "paged_decode_attention": AttentionEnvelope(2, 2, 1, 32, 8,
                                                    "float32", "cpu"),
    }
    kern, env = kernels.REGISTRY.get(kid), envs[kid]
    args = kern.make_inputs(env, seed=1)
    again = kern.make_inputs(env, seed=1)
    for a, b in zip(args, again):
        assert torch.equal(a, b)  # seeded
    ref = kern.reference(env)(*args)
    for tiling in kern.candidates(env):
        got = kern.build(env, tiling)(*args)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)


def test_tuner_keeps_failed_candidates_and_raises_when_all_fail():
    class Flaky(registry.MatmulBiasActKernel):
        kernel_id = "flaky"

        def __init__(self, bad):
            self.bad = bad

        def build(self, env, tiling):
            fn = super().build(env, tiling)
            if tuple(tiling) in self.bad:
                def refused(*args):
                    raise RuntimeError("CUDA error 1")
                return refused
            return fn

    env = _env(16, 8, 8)
    cache = kernels.TuningCache()
    res = kernels.autotune(Flaky({(64, 64)}), env, cache=cache, trials=1)
    assert res.tiling == (128, 64)
    assert [t for t in res.trials if "error" in t][0]["tiling"] == [64, 64]
    assert cache.winner("flaky", env.key)["tiling"] == [128, 64]
    with pytest.raises(RuntimeError, match="every candidate failed"):
        kernels.autotune(Flaky({(64, 64), (128, 64)}), env, cache=cache)
    with pytest.raises(ValueError, match="does not support"):
        kernels.autotune(Flaky(set()), _env(16, 8, 8, dtype="float64"))


# ---------------------------------------------------------------------------
# the wrappers hand their tiling to the launchers
# ---------------------------------------------------------------------------

class _Lib:
    """A stand-in library: records each launcher's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 64 if name == "dl4j_matmul_stats_block_m" else 0
        return fn


def test_wrappers_pass_the_tiling_or_zero(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(impls, "_library", lambda: lib)
    monkeypatch.setattr(impls, "_stats_library", lambda: lib)
    monkeypatch.setattr(impls, "stream", lambda t: 0)
    monkeypatch.setattr(impls.build, "load", lambda name, sig: lib)
    monkeypatch.setattr(impls, "count", lambda *a, **k: None)
    x = torch.zeros((4, 8))
    act = Activation.RELU
    impls._matmul_bias_act_cuda(x, torch.zeros((4, 8)), torch.zeros(4),
                                act, None)
    impls._matmul_bias_act_cuda(x, torch.zeros((4, 8)), torch.zeros(4),
                                act, (128, 64))
    assert [c[1][9:11] for c in lib.calls] == [(0, 0), (128, 64)]
    lib.calls.clear()
    impls._matmul_stats_cuda(x, torch.zeros((4, 8)), None)
    impls._matmul_stats_cuda(x, torch.zeros((4, 8)), (128,))
    names = [c[0] for c in lib.calls]
    assert names == ["dl4j_matmul_stats_block_m", "dl4j_matmul_stats",
                     "dl4j_matmul_stats"]
    assert lib.calls[1][1][9] == 64 and lib.calls[2][1][9] == 128
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        impls._matmul_stats_cuda(x, torch.zeros((4, 8)), (-1,))
    assert impls._int8_tiling_plan((2, 2)) == 34
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        impls._int8_tiling_plan((2, 16))
    lib.calls.clear()
    q = torch.zeros((1, 2, 4, 8))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: False))
    att._flash_cuda(q, q, q, None, True, 1.0, None)
    att._flash_cuda(q, q, q, None, True, 1.0, (64, 64))
    assert [c[1][24:26] for c in lib.calls] == [(0, 0), (64, 64)]
    lib.calls.clear()
    qd, kc = torch.zeros((1, 2, 8)), torch.zeros((1, 64, 2, 8))
    pos = torch.zeros((1,), dtype=torch.int32)
    att._decode_cuda(qd, kc, kc, pos, 1.0, att._page(0, 64))
    att._decode_cuda(qd, kc, kc, pos, 1.0, att._page(16, 64))
    assert [c[1][9] for c in lib.calls] == [0, 16]
    with pytest.raises(ValueError, match="must divide"):
        att._page(0, 96)
