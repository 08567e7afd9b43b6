#!/usr/bin/env python3
"""Phase [29] of ``chip_smoke.py``: the multi-tenant serving platform on one
H100 (``parallel/platform.py``, ``InferenceServer(platform)``,
``parallel/inference.py``), with three full-width tenants on their kernels.

- (a) Registry: in a temporary directory, ``ModelRegistry.publish``
  full-width ResNet-50 v1 and v2 (v2 = v1 with the output layer's bias
  moved by seeded normal(0, 0.5) noise), full-width AlexNet float32 v1 and
  the int8 AlexNet v2 (``calibrate`` on 4 seeded batches of 32, then
  ``quantize_for_inference``, as [16]-[18] make it); the two models'
  versions publish at once. Every version loads back digest-verified onto
  the card, params bit for bit (load seconds a version printed).
- (b) Three tenants on one ``ModelPlatform`` behind
  ``InferenceServer(platform)`` on 127.0.0.1: ``resnet`` (v1,
  ``use_kernels``: row 1, 36 sites a forward), ``alexnet`` (v1, float32:
  row 1 at its two dense layers) and ``lm`` (``deploy_generation``: the
  GPT-2-small-width LM of [11], 12 layers; row 6 on each prefill, row 5 on
  each decode step). ``POST /predict/<model>`` requests (one uint8 each)
  held against the same version's ``use_kernels=False`` forward at [4]'s
  serving tolerance; 8 prompts to ``lm`` held against sequential
  ``generate`` under [11]'s near-tie rule; ``/models``, per-model
  ``/healthz``, a named 404; the launch counts of the traffic; each
  tenant's p50 request latency and images/s (tokens/s for ``lm``).
- (c) Swap: with v2's zip tampered (one byte flipped, the original put
  back after) ``swap`` raises ``ModelIntegrityError`` and v1 keeps
  serving the same bytes. Then ``resnet`` v1 → v2 under traffic from 4
  client threads. Every
  answer equals v1's or v2's stock forward, every coalesced launch (a
  trace's batch id) served one version, every request sent after the swap
  returned gets v2's answer, and no new envelope appears.
- (d) Canary chaos, twice with one seed: ``resnet`` v2 canaried over a
  fresh v1 tenant at fraction 0.5 under ``FaultPlan(seed)`` on
  ``serving.launch:resnet#canary`` (probability 0.9 an attempt); the gate
  (3 consecutive canary failures) rolls back at the same request index in
  both runs, ``alexnet``'s bytes and ``lm``'s stream stay pinned, v1's
  answer after the rollback is its answer from before, no new envelope.
- (e) Quantized canary over the float32 ``alexnet``, with the accuracy arm
  (``max_accuracy_delta``): an int8 version calibrated with clip
  percentile 1.0 (spoiled on purpose) rolls back; the real int8 v2 holds
  over 16 requests, ``promote`` leaves row 4 serving (2 launches a
  forward) within ``INT8_MAX_ULP`` of the int8 stock route.
- (f) ``ParallelInference`` over every CUDA device: sizes 1-33 against the
  stock forward, and no new envelope on a second sweep.

Launch counts: row 1 36 a ``resnet`` forward (plus 2 an ``alexnet`` float32
forward), row 4 2 an int8 ``alexnet`` forward, row 6 12 a prefill, row 5 12
a decode step, each read over its sub-phase's traffic alone.

``python3 chip_platform.py`` builds the kernels and runs [29] alone.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import chip_smoke as cs

PLAT_SEED = 29
PLAT_MAX_BATCH = 8
RESNET = {}   # ResNet50 arguments (full width: 224x224x3, 1000 classes)
ALEXNET = {}  # AlexNet arguments (full width)
BIAS_SHIFT = 0.5  # std of v2's output-bias move
HTTP_SIZES = (1, 2, 1)  # images a request; the second sent as uint8
LATENCY_REQUESTS = 8  # p50 / p95 sample (the script's time limit)
THROUGHPUT = (4, 4, 4)  # clients x requests x images
# each client cycles over its SWAP_INPUTS requests until the swap returns,
# then sends SWAP_AFTER more
SWAP_CLIENTS, SWAP_INPUTS, SWAP_AFTER = 4, 4, 4
CHAOS_FRACTION = 0.5
CHAOS_P = 0.9
CHAOS_FAULT_SEED = 11
CHAOS_FAILURES = 3
CHAOS_REQUESTS = 40
# the accuracy arm's limit on max |int8 canary - f32 incumbent| (softmax
# outputs of a random AlexNet, ~1e-3 each) is set from a held-out probe
# before either canary runs: the geometric mean of the real artifact's
# largest deviation ([17] measured 2.4e-6) and the spoiled one's smallest.
# Clip percentile 1.0 inverts every input range, which pins each int8 input
# near its 99th percentile: the layers' outputs stop depending on the
# image. The two must sit ACC_SEPARATION apart or the phase fails.
SPOILED_CLIP = 1.0
ACC_PROBE = 16
ACC_SEPARATION = 3.0
QUANT_REQUESTS = 16
LM_PROMPTS, LM_MAX_NEW = 8, 16
PI_SIZES = range(1, 34)


def _opener():
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with _opener().open(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _images(rng, n, shape, uint8=False):
    if uint8:
        return rng.integers(0, 256, (n,) + shape, np.uint8)
    return rng.random((n,) + shape, np.float32)


def _stock(net, dev):
    """The ``use_kernels=False`` twin of ``net`` (the same weights)."""
    return type(net)(dataclasses.replace(net.conf, use_kernels=False),
                     dev).set_params(net.params, net.state)


def _batches(model: str) -> int:
    """Shared launches the tenant (engine) ``model`` has served."""
    from deeplearning4j_tpu_torch import telemetry

    return int(telemetry.REGISTRY.counter("dl4j_serving_batches_total",
                                          model=model).value)


def _misses() -> int:
    from deeplearning4j_tpu_torch.optimize import aot_cache

    return aot_cache.stats()["misses"]


def _check_close(got, want, tol, label):
    atol, rtol = tol
    got = np.asarray(got, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: shape {got.shape} (want "
                             f"{want.shape}) or non-finite values")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=label)
    return float(np.abs(got - want).max())


# --------------------------------------------------------------------------
# (a) the registry
# --------------------------------------------------------------------------

def registry_versions(torch, dev, root: Path, smi: str) -> dict:
    """Publish the four versions, load each back on the card, refuse a
    tampered copy."""
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.platform import ModelRegistry
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50
    from deeplearning4j_tpu_torch.zoo.models import AlexNet

    rng = np.random.default_rng(PLAT_SEED)
    rzoo, azoo = ResNet50(**RESNET), AlexNet(**ALEXNET)
    r1 = ComputationGraph(dataclasses.replace(rzoo.conf(), use_kernels=True),
                          device=dev).init()
    cs.randomize_bn(r1, PLAT_SEED)
    r2 = ComputationGraph(r1.conf, device=dev).set_params(r1.params,
                                                         r1.state)
    out = r1.conf.network_outputs[0]
    with torch.no_grad():
        b = r2.params[out]["b"]
        b.add_(torch.from_numpy(rng.normal(0.0, BIAS_SHIFT, tuple(b.shape))
                                .astype(np.float32)).to(b.device))
    a1 = MultiLayerNetwork(dataclasses.replace(azoo.conf(), use_kernels=True),
                           dev).init()
    image = (azoo.height, azoo.width, azoo.channels)
    cal = [rng.random((cs.BATCH,) + image, np.float32)
           for _ in range(cs.INT8_CAL_BATCHES)]
    rec = iopt.calibrate(a1, cal)
    a2 = iopt.quantize_for_inference(a1, rec)
    reg = ModelRegistry(root)
    t_pub = {}

    def publish(name, nets):
        # one model's versions in turn; the two models at once (the
        # registry locks per model, and the zip's deflate and sha256 run
        # outside the interpreter lock)
        for net in nets:
            t0 = time.monotonic()
            v = reg.publish(name, net)
            t_pub[f"{name}/v{v}"] = time.monotonic() - t0

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(publish, "resnet", (r1, r2)),
                    pool.submit(publish, "alexnet", (a1, a2))]:
            fut.result()
    t_pub["wall"] = time.monotonic() - t0
    ent = reg._read_manifest("alexnet")["versions"][-1]
    if ent.get("quantization") != {"scheme": "int8",
                                   "calibration_digest": rec.digest}:
        raise AssertionError(f"alexnet v2's manifest entry: {ent}")
    loads = {}
    for name, v in (("resnet", 1), ("resnet", 2), ("alexnet", 1),
                    ("alexnet", 2)):
        t0 = time.monotonic()
        net, got = reg.load(name, v, device=dev)
        torch.cuda.synchronize()
        loads[f"{name}/v{v}"] = time.monotonic() - t0
        if got != v or net.device.type != torch.device(dev).type:
            raise AssertionError(f"{name} v{v}: loaded v{got} on "
                                 f"{net.device}")
        src = {("resnet", 1): r1, ("resnet", 2): r2, ("alexnet", 1): a1,
               ("alexnet", 2): a2}[(name, v)]
        for k, d in src.params.items():
            for p, t in d.items():
                if not torch.equal(net.params[k][p], t):
                    raise AssertionError(f"{name} v{v}: {k}/{p} differs "
                                         "after the round trip")
        if (name, v) == ("alexnet", 2) \
                and net.conf.quantization.digest != rec.digest:
            raise AssertionError("int8 AlexNet's spec changed in the "
                                 "registry")
        del net
    cs.log(f"[29a] published (two models at once) "
         f"{json.dumps({k: round(x, 2) for k, x in t_pub.items()})} s; "
         f"loaded (digest-verified, on {dev}) "
         f"{json.dumps({k: round(x, 2) for k, x in loads.items()})} s; "
         f"alexnet v2 int8 digest {rec.digest[:16]} [{smi}]")
    return {"reg": reg, "r1": r1, "r2": r2, "a1": a1, "a2": a2, "rec": rec,
            "cal": cal, "image_resnet": (rzoo.height, rzoo.width,
                                         rzoo.channels),
            "image_alexnet": image, "publish_s": t_pub, "load_s": loads}


# --------------------------------------------------------------------------
# (b) three tenants behind InferenceServer(platform)
# --------------------------------------------------------------------------

def _tenant_config():
    from deeplearning4j_tpu_torch.parallel.batcher import BatchingConfig
    from deeplearning4j_tpu_torch.parallel.platform import TenantConfig

    return TenantConfig(batching=BatchingConfig(
        max_batch=PLAT_MAX_BATCH, max_delay_ms=20.0, settle_ms=3.0))


def _lm_engine(plat):
    return plat._gen_tenants["lm"][0]


def _decode_counts(eng) -> tuple:
    st = eng.stats()
    return (sum(st["prefills"].values()),
            sum(st["windows"].values()) * eng.config.fused_steps)


def _p50_ms(fn, reps=LATENCY_REQUESTS) -> tuple:
    """(p50, p95) ms of ``reps`` calls of ``fn`` in turn."""
    lat = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn()
        lat.append((time.monotonic() - t0) * 1e3)
    lat.sort()
    return (statistics.median(lat),
            lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)])


def _latency(plat, name, x_one) -> dict:
    """Where a one-image request's time goes: p50 / p95 of requests in
    turn through ``predict``, their traces' stages (queue wait: submit to
    the launch; batch wait: grouped to launched; launch: the forward and
    its host copy), then images/s of THROUGHPUT's concurrent clients."""
    from deeplearning4j_tpu_torch.telemetry import tracing

    tracing.enable(seed=PLAT_SEED, sample_every=1)
    try:
        p50, p95 = _p50_ms(lambda: plat.predict(name, x_one))
        stages = tracing.stage_breakdown()
    finally:
        tracing.disable()
        tracing.reset()
    clients, reqs, n = THROUGHPUT
    xb = np.repeat(x_one, n, axis=0)

    def client():
        for _ in range(reqs):
            plat.predict(name, xb)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{name}: throughput clients hung")
    wall = time.monotonic() - t0
    return {"p50_ms": p50, "p95_ms": p95,
            "queue_wait_p50_ms": stages["queue_wait"]["p50_ms"],
            "batch_wait_p50_ms": stages["batch_wait"]["p50_ms"],
            "launch_p50_ms": stages["launch"]["p50_ms"],
            "images_per_s": clients * reqs * n / wall}


def serve_tenants(torch, dev, v, smi) -> dict:
    from deeplearning4j_tpu_torch.parallel.generation import GenerationConfig
    from deeplearning4j_tpu_torch.parallel.platform import ModelPlatform
    from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    plat = ModelPlatform(v["reg"], seed=PLAT_SEED, device=dev)
    t0 = time.monotonic()
    deployed = {name: plat.deploy(name, version=1, config=_tenant_config())
                for name in ("resnet", "alexnet")}
    lm_zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                seed=cs.GEN_SEED, **cs.GEN_MODEL)
    gen = plat.deploy_generation(
        "lm", model=lm_zoo, config=GenerationConfig(**cs.GEN_CONFIG))
    torch.cuda.synchronize()
    cs.log(f"[29b] deployed resnet v1 ("
         f"{deployed['resnet']['warmup']['forwards']} warmup forwards), "
         f"alexnet v1 ("
         f"{deployed['alexnet']['warmup']['forwards']}), lm "
         f"({len(gen['warmup']['prompt_buckets'])} prompt x "
         f"{len(gen['warmup']['join_buckets'])} join buckets) in "
         f"{time.monotonic() - t0:.1f} s")
    refs = {"resnet": _stock(v["r1"], dev), "alexnet": _stock(v["a1"], dev)}
    images = {"resnet": v["image_resnet"], "alexnet": v["image_alexnet"]}
    rng = np.random.default_rng(PLAT_SEED + 1)
    lm_eng = _lm_engine(plat)
    prompts = cs.gen_requests(LM_PROMPTS, lm_zoo.vocab_size, PLAT_SEED)

    # ---- the platform's traffic: counts from here on belong to it ----
    cs.reset_launch_counts()
    b0 = {n: _batches(n) for n in refs}
    p0, s0 = _decode_counts(lm_eng)
    server = InferenceServer(plat).start(port=0, host="127.0.0.1")
    worst = {}
    try:
        for name in ("resnet", "alexnet"):
            worst[name] = 0.0
            for i, n in enumerate(HTTP_SIZES):
                x = _images(rng, n, images[name], uint8=(i == 1))
                code, body = _http(server.port, f"/predict/{name}",
                                   {"inputs": [x.tolist()]})
                if code != 200:
                    raise AssertionError(f"/predict/{name}: {code} {body}")
                worst[name] = max(worst[name], _check_close(
                    body["outputs"][0], refs[name].output(x), cs.SERVED_TOL,
                    f"[29b] {name} request {i}"))
        outs = [None] * len(prompts)
        errors = []

        def ask(j):
            try:
                outs[j] = plat.generate("lm", prompts[j],
                                        max_new_tokens=LM_MAX_NEW)
            except Exception as e:  # reported below, never swallowed
                errors.append(f"prompt {j}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=ask, args=(j,))
                   for j in range(len(prompts))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        lm_wall = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"lm generate failed: {errors}")
        code, models = _http(server.port, "/models")
        if code != 200 or sorted(models["models"]) != ["alexnet", "lm",
                                                       "resnet"]:
            raise AssertionError(f"/models: {code} {models}")
        code, health = _http(server.port, "/healthz")
        if code != 200 or health["status"] != "ok" or sorted(
                health["models"]) != ["alexnet", "lm", "resnet"]:
            raise AssertionError(f"/healthz: {code} {health}")
        code, body = _http(server.port, "/predict/ghost",
                           {"inputs": [[0.0]]})
        if code != 404 or body.get("models") != ["alexnet", "resnet"]:
            raise AssertionError(f"/predict/ghost: {code} {body}")
        # one-image requests over HTTP: the JSON parse and the socket on
        # top of predict's time
        http_ms = {}
        for name in ("resnet", "alexnet"):
            body = {"inputs": [_images(rng, 1, images[name]).tolist()]}
            http_ms[name] = _p50_ms(
                lambda: _http(server.port, f"/predict/{name}", body))[0]
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = cs.launch_counts()
    forwards = {n: _batches(n) - b0[n] for n in refs}
    p1, s1 = _decode_counts(lm_eng)
    prefills, steps = p1 - p0, s1 - s0
    # ---- end of the platform's traffic ----
    a_conf = plat.engine("alexnet").model.conf
    want = {
        "matmul_bias_act": 36 * forwards["resnet"]
        + cs.mln_expected_launches(a_conf, forwards["alexnet"]),
        "matmul_bias_act_int8": 0,
        "flash_attention": cs.GEN_MODEL["n_layers"] * prefills,
        "paged_decode_attention": cs.GEN_MODEL["n_layers"] * steps,
    }
    cs.log(f"[29b] traffic: {forwards} forwards, lm {prefills} prefills and "
         f"{steps} decode steps; launches {json.dumps(launches)} (expected "
         f"{json.dumps(want)})")
    if launches != want or not prefills or not steps:
        raise AssertionError(f"[29b] launches {launches} != {want}")
    seq = [lm_eng._dec.generate(p, LM_MAX_NEW) for p in prompts]
    streams = cs.compare_streams(torch, lm_eng._dec, outs, seq, prompts,
                                 "platform lm vs sequential generate",
                                 phase="[29b]")
    tokens = sum(len(o) for o in outs)
    perf = {name: dict(_latency(plat, name, _images(rng, 1, images[name])),
                       http_p50_ms=http_ms[name])
            for name in ("resnet", "alexnet")}
    perf["lm"] = {"tokens_per_s": tokens / lm_wall, "wall_s": lm_wall,
                  "tokens": tokens}
    cs.log(f"[29b] served == use_kernels=False: max |diff| resnet "
         f"{worst['resnet']:.3e}, alexnet {worst['alexnet']:.3e} (tol atol="
         f"{cs.SERVED_TOL[0]} rtol={cs.SERVED_TOL[1]}); lm streams vs "
         f"sequential {streams['identical']}/{len(prompts)} identical")
    for name in ("resnet", "alexnet"):
        p = perf[name]
        cs.log(f"[29b] {name}: one-image request p50 {p['p50_ms']:.2f} ms "
             f"(p95 {p['p95_ms']:.2f}; queue wait "
             f"{p['queue_wait_p50_ms']:.2f}, of it batch wait {p['batch_wait_p50_ms']:.2f}, launch "
             f"{p['launch_p50_ms']:.2f}), over HTTP with JSON "
             f"{p['http_p50_ms']:.2f} ms; {p['images_per_s']:.1f} images/s "
             f"at {THROUGHPUT[0]} clients x {THROUGHPUT[2]} images [{smi}]")
    cs.log(f"[29b] lm: {tokens} tokens for {LM_PROMPTS} prompts in "
         f"{lm_wall:.2f} s, {perf['lm']['tokens_per_s']:.1f} tokens/s [{smi}]")
    probe_lm = prompts[0]
    return {"plat": plat, "refs": refs, "images": images, "rng": rng,
            "launches": launches, "forwards": forwards,
            "decode": {"prefills": prefills, "steps": steps},
            "worst": worst, "streams": streams, "perf": perf,
            "lm_probe": probe_lm, "lm_eng": lm_eng}


# --------------------------------------------------------------------------
# (c) the swap under traffic
# --------------------------------------------------------------------------

def tampered_swap_refused(v, t) -> str:
    """v2's zip tampered (one byte flipped; the original bytes kept and put
    back after): ``swap`` refuses it with ModelIntegrityError, and the
    incumbent v1 keeps serving the same bytes."""
    from deeplearning4j_tpu_torch.parallel.platform import ModelIntegrityError

    plat, reg = t["plat"], v["reg"]
    x = _images(np.random.default_rng(PLAT_SEED + 6), 1,
                t["images"]["resnet"])
    before = np.asarray(plat.predict("resnet", x)).tobytes()
    zp = reg.root / "resnet" / "v0002.zip"
    original = zp.read_bytes()
    blob = bytearray(original)
    blob[len(blob) // 2] ^= 0xFF
    zp.write_bytes(bytes(blob))
    try:
        try:
            plat.swap("resnet", 2)
        except ModelIntegrityError as e:
            refused = str(e)
        else:
            raise AssertionError("[29c] a tampered version was swapped in")
        after = np.asarray(plat.predict("resnet", x)).tobytes()
        if after != before or plat.stats()["resnet"]["version"] != 1:
            raise AssertionError("[29c] the incumbent changed after a "
                                 "refused swap")
    finally:
        zp.write_bytes(original)
    if not reg.verify("resnet", 2):
        raise AssertionError("[29c] v2 did not verify once restored")
    cs.log(f"[29c] tampered v2 refused: {refused}; v1 kept serving the same "
         "bytes")
    return refused


def swap_under_traffic(torch, dev, v, t) -> dict:
    from deeplearning4j_tpu_torch.telemetry import tracing

    plat = t["plat"]
    refused = tampered_swap_refused(v, t)
    ref1, ref2 = t["refs"]["resnet"], _stock(v["r2"], dev)
    shape = t["images"]["resnet"]
    rng = np.random.default_rng(PLAT_SEED + 2)
    inputs = [[_images(rng, 1 + (c + i) % 2, shape)
               for i in range(SWAP_INPUTS)] for c in range(SWAP_CLIENTS)]
    want = {(c, i): (ref1.output(x), ref2.output(x))
            for c, xs in enumerate(inputs) for i, x in enumerate(xs)}
    answers, errors = [], []
    swapped = threading.Event()
    done_at = [None]  # monotonic time the swap returned
    miss0 = _misses()
    tracing.enable(seed=PLAT_SEED, sample_every=1)
    try:
        def client(c):
            try:
                k, after = 0, 0
                while after < SWAP_AFTER:
                    i = k % SWAP_INPUTS
                    k += 1
                    after += swapped.is_set()
                    sent = time.monotonic()
                    y, tr = plat.predict_traced("resnet", inputs[c][i])
                    answers.append((sent, (c, i), y, tr))
            except Exception as e:  # reported below, never swallowed
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SWAP_CLIENTS)]
        for th in threads:
            th.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        plat.swap("resnet", 2)
        done_at[0] = time.monotonic()
        swapped.set()
        swap_s = done_at[0] - t0
        for th in threads:
            th.join(timeout=600)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"[29c] clients failed: {errors}")
    finally:
        tracing.disable()
        tracing.reset()
    by_batch, counts = {}, {1: 0, 2: 0}
    atol, rtol = cs.SERVED_TOL
    for sent, key, y, tr in answers:
        near = [ver for ver, ref in zip((1, 2), want[key])
                if np.allclose(y, ref, rtol=rtol, atol=atol)]
        if len(near) != 1:
            raise AssertionError(f"[29c] an answer matches versions {near}")
        counts[near[0]] += 1
        if sent > done_at[0] and near[0] != 2:
            raise AssertionError("[29c] a request sent after the swap got "
                                 "v1's answer")
        (launch,) = [a for name, _, a in tr.events if name == "launched"]
        by_batch.setdefault(launch["batch"], set()).add(near[0])
    mixed = [b for b, vs in by_batch.items() if len(vs) > 1]
    if mixed:
        raise AssertionError(f"[29c] launches {mixed} served both versions")
    new_envelopes = _misses() - miss0
    if new_envelopes:
        raise AssertionError(f"[29c] the swap added {new_envelopes} "
                             "envelopes")
    if plat.stats()["resnet"]["version"] != 2:
        raise AssertionError("[29c] the tenant does not record v2")
    cs.log(f"[29c] swap v1 -> v2 under {SWAP_CLIENTS} clients: "
         f"{len(answers)} answers (v1 {counts[1]}, v2 {counts[2]}) over "
         f"{len(by_batch)} launches, none mixed, every request after the "
         f"swap v2's; swap {swap_s * 1e3:.1f} ms (load + publish), 0 new "
         f"envelopes [{cs.nvidia_smi_line()}]")
    return {"swap_ms": swap_s * 1e3, "answers": counts,
            "launches": len(by_batch), "ref2": ref2, "refused": refused}


# --------------------------------------------------------------------------
# (d) canary chaos, twice
# --------------------------------------------------------------------------

def _lm_probe(plat, t):
    return plat.generate("lm", t["lm_probe"], max_new_tokens=LM_MAX_NEW)


def canary_chaos(torch, dev, v, t) -> dict:
    from deeplearning4j_tpu_torch.parallel.platform import CanaryGate
    from deeplearning4j_tpu_torch.resilience.faults import FaultPlan

    plat = t["plat"]
    rng = np.random.default_rng(PLAT_SEED + 3)
    x = _images(rng, 1, t["images"]["resnet"])
    xa = _images(rng, 1, t["images"]["alexnet"])
    a_bytes = np.asarray(plat.predict("alexnet", xa)).tobytes()
    lm_stream = _lm_probe(plat, t)
    miss0 = _misses()
    runs = []
    for run in range(2):
        # a fresh v1 tenant and the v2 canary from the versions [29a] held
        # bit-equal to the registry's (two fewer zip loads a run)
        plat.deploy("resnet", version=1, model=v["r1"],
                    config=_tenant_config())
        before = np.asarray(plat.predict("resnet", x)).tobytes()
        plat.deploy_canary("resnet", 2, model=v["r2"],
                           fraction=CHAOS_FRACTION,
                           gate=CanaryGate(
                               max_consecutive_failures=CHAOS_FAILURES))
        plan = FaultPlan(seed=CHAOS_FAULT_SEED).inject(
            "serving.launch:resnet#canary", probability=CHAOS_P)
        sheds, pinned, trip_ms = 0, True, None
        with plan.armed():
            for _ in range(CHAOS_REQUESTS):
                t0 = time.monotonic()
                try:
                    plat.predict("resnet", x)
                except Exception:
                    sheds += 1
                dt = (time.monotonic() - t0) * 1e3
                pinned = pinned and np.asarray(plat.predict(
                    "alexnet", xa)).tobytes() == a_bytes
                if "last_rollback" in plat.stats()["resnet"]:
                    trip_ms = dt
                    break
        rollback = plat.stats()["resnet"].get("last_rollback")
        if rollback is None:
            raise AssertionError(f"[29d] run {run}: the gate never tripped "
                                 f"in {CHAOS_REQUESTS} requests")
        after = np.asarray(plat.predict("resnet", x)).tobytes()
        lm_pinned = _lm_probe(plat, t) == lm_stream
        if not (pinned and lm_pinned and after == before):
            raise AssertionError(
                f"[29d] run {run}: alexnet pinned {pinned}, lm pinned "
                f"{lm_pinned}, v1 restored {after == before}")
        runs.append({"at_request": rollback["at_request"],
                     "canary": rollback["canary"],
                     "reason": rollback["reason"], "sheds": sheds,
                     "fired": plan.fired(), "trip_request_ms": trip_ms})
        cs.log(f"[29d] run {run}: rollback at request "
             f"{rollback['at_request']} ({rollback['reason']}; canary "
             f"{rollback['canary']['requests']} requests, "
             f"{rollback['canary']['failures']} failures; {plan.fired()} "
             f"faults fired, {sheds} sheds); the tripping request "
             f"{trip_ms:.1f} ms with the rollback; alexnet bytes and lm "
             f"stream pinned, v1 restored bit for bit "
             f"[{cs.nvidia_smi_line()}]")
    if runs[0]["at_request"] != runs[1]["at_request"] \
            or runs[0]["canary"] != runs[1]["canary"]:
        raise AssertionError(f"[29d] the two runs differ: {runs}")
    if "consecutive canary failures" not in runs[0]["reason"]:
        raise AssertionError(f"[29d] tripped by {runs[0]['reason']}")
    new_envelopes = _misses() - miss0
    if new_envelopes:
        raise AssertionError(f"[29d] {new_envelopes} new envelopes")
    return {"runs": runs, "new_envelopes": new_envelopes}


# --------------------------------------------------------------------------
# (e) the quantized canary
# --------------------------------------------------------------------------

def quantized_canary(torch, dev, v, t) -> dict:
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.parallel.platform import CanaryGate

    plat = t["plat"]
    rng = np.random.default_rng(PLAT_SEED + 4)
    shape = t["images"]["alexnet"]
    xs = [_images(rng, 1, shape) for _ in range(QUANT_REQUESTS)]
    spoiled = iopt.quantize_for_inference(
        v["a1"], iopt.calibrate(v["a1"], v["cal"],
                                clip_percentile=SPOILED_CLIP))
    probe = _images(rng, ACC_PROBE, shape)
    y32 = v["a1"].output(probe)
    d_real = np.abs(v["a2"].output(probe) - y32).max(axis=1)
    d_spoiled = np.abs(spoiled.output(probe) - y32).max(axis=1)
    limit = float(np.sqrt(d_real.max() * d_spoiled.min()))
    cs.log(f"[29e] probe of {ACC_PROBE} images, max |int8 - f32| per image: "
         f"real calibration {d_real.min():.3e}-{d_real.max():.3e}, spoiled "
         f"{d_spoiled.min():.3e}-{d_spoiled.max():.3e}; accuracy-arm limit "
         f"{limit:.3e}")
    if not d_spoiled.min() > ACC_SEPARATION * d_real.max():
        raise AssertionError("[29e] the spoiled calibration is not "
                             f"{ACC_SEPARATION}x the real one's deviation")
    # the spoiled calibration first: it must roll back
    plat.deploy_canary("alexnet", version=99, model=spoiled,
                       fraction=CHAOS_FRACTION,
                       gate=CanaryGate(max_accuracy_delta=limit))
    spoiled_rb = None
    for x in xs:
        plat.predict("alexnet", x)
        spoiled_rb = plat.stats()["alexnet"].get("last_rollback")
        if spoiled_rb is not None:
            break
    if spoiled_rb is None or "accuracy arm" not in spoiled_rb["reason"]:
        raise AssertionError(f"[29e] the spoiled int8 canary held: "
                             f"{plat.stats()['alexnet']}")
    cs.log(f"[29e] spoiled int8 canary (clip percentile {SPOILED_CLIP}): "
         f"rolled back at request {spoiled_rb['at_request']}: "
         f"{spoiled_rb['reason']}")
    # the real calibration: held, then promoted; counts from here on
    cs.reset_launch_counts()
    b0 = {n: _batches(n) for n in ("alexnet", "alexnet#canary")}
    dep = plat.deploy_canary("alexnet", 2, fraction=CHAOS_FRACTION,
                             gate=CanaryGate(max_accuracy_delta=limit))
    for x in xs:
        plat.predict("alexnet", x)
    st = plat.stats()["alexnet"]
    if "canary" not in st or st["canary"]["accuracy_samples"] == 0:
        raise AssertionError(f"[29e] the int8 canary did not hold or was "
                             f"never sampled: {st}")
    canary = st["canary"]
    canary_fw = dep["warmup"]["forwards"] + _batches("alexnet#canary") \
        - b0["alexnet#canary"]
    f32_fw = _batches("alexnet") - b0["alexnet"]
    t0 = time.monotonic()
    prom = plat.promote("alexnet")
    promote_ms = (time.monotonic() - t0) * 1e3
    b1 = _batches("alexnet")
    ref8 = _stock(v["a2"], dev)
    ulps = 0
    for x in xs[:4]:
        got = plat.predict("alexnet", x)
        ulps = max(ulps, cs._ulps(torch, torch.from_numpy(np.asarray(got)),
                                  torch.from_numpy(ref8.output(x))))
    torch.cuda.synchronize()
    int8_fw = canary_fw + prom["warmup"]["forwards"] + _batches("alexnet") - b1
    launches = cs.launch_counts()
    # the int8 network's routed dense layers are row 4's; the float32
    # incumbent's shadow compares launch row 1
    want = {"matmul_bias_act_int8": 2 * int8_fw,
            "matmul_bias_act": cs.mln_expected_launches(
                t["refs"]["alexnet"].conf, f32_fw)}
    got = {k: launches[k] for k in want}
    cs.log(f"[29e] int8 canary v2: {canary['requests']} requests, "
         f"{canary['accuracy_samples']} shadow compares, max |delta| "
         f"{canary['accuracy_max_delta']:.3e} (limit {limit:.3e}): held; "
         f"promoted in {promote_ms:.1f} ms; {int8_fw} int8 forwards, "
         f"launches {json.dumps(got)} (expected {json.dumps(want)}); "
         f"promoted vs int8 stock route {ulps} ulp (tol {cs.INT8_MAX_ULP}) "
         f"[{cs.nvidia_smi_line()}]")
    if got != want:
        raise AssertionError(f"[29e] launches {got} != {want}")
    if ulps > cs.INT8_MAX_ULP:
        raise AssertionError(f"[29e] promoted int8 route {ulps} ulps from "
                             "the stock route")
    return {"spoiled_rollback": spoiled_rb, "canary": canary,
            "accuracy_limit": limit,
            "probe_delta": {"real_max": float(d_real.max()),
                            "spoiled_min": float(d_spoiled.min())},
            "promote_ms": promote_ms, "int8_forwards": int8_fw,
            "launches": got, "route_max_ulps": ulps}


# --------------------------------------------------------------------------
# (f) ParallelInference
# --------------------------------------------------------------------------

def parallel_inference(torch, dev, v, t, c) -> dict:
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    net = v["r2"]
    # every CUDA device (the given device on a CPU rehearsal)
    pi = ParallelInference(net, devices=None if torch.device(dev).type
                           == "cuda" else [dev])
    ref = c["ref2"]
    rng = np.random.default_rng(PLAT_SEED + 5)
    shape = t["images"]["resnet"]
    cs.reset_launch_counts()
    worst, t0 = 0.0, time.monotonic()
    for n in PI_SIZES:
        x = _images(rng, n, shape)
        worst = max(worst, _check_close(pi.output(x), ref.output(x),
                                        cs.SERVED_TOL, f"[29f] size {n}"))
    torch.cuda.synchronize()
    sweep_s = time.monotonic() - t0
    forwards = sum(pi.workers for _ in PI_SIZES)
    launches = cs.launch_counts()["matmul_bias_act"]
    miss0 = _misses()
    for n in PI_SIZES:
        pi.output(_images(rng, n, shape))
    if _misses() != miss0:
        raise AssertionError("[29f] a second sweep added envelopes")
    if launches != 36 * forwards:
        raise AssertionError(f"[29f] matmul_bias_act launched {launches} "
                             f"times for {forwards} forwards")
    cs.log(f"[29f] ParallelInference over {pi.workers} card(s): sizes "
         f"{PI_SIZES.start}-{PI_SIZES.stop - 1} == use_kernels=False, max "
         f"|diff| {worst:.3e}; {launches} matmul_bias_act launches "
         f"({forwards} forwards); sweep {sweep_s:.2f} s with the stock "
         f"forwards; a second sweep added 0 envelopes")
    return {"workers": pi.workers, "max_abs_err": worst,
            "launches": launches, "forwards": forwards}


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def platform_phase(torch, dev, smi) -> tuple:
    """[29]: returns the ``{"platform": ...}`` line and, per kernel name,
    the platform's launch counts for the kernels line."""
    t_start = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dl4j_platform_") as root:
        v = registry_versions(torch, dev, Path(root), smi)
        t = serve_tenants(torch, dev, v, smi)
        try:
            c = swap_under_traffic(torch, dev, v, t)
            d = canary_chaos(torch, dev, v, t)
            e = quantized_canary(torch, dev, v, t)
            f = parallel_inference(torch, dev, v, t, c)
        finally:
            t["plat"].close()
    wall = time.monotonic() - t_start
    cs.log(f"[29] serving platform in {wall:.1f} s [{smi}]")
    scope = "[29] the serving platform's traffic: "
    rows = {
        "matmul_bias_act": {
            "launches": t["launches"]["matmul_bias_act"] + f["launches"],
            "scope": scope + "[29b] resnet (36 a forward) and alexnet f32 "
                             "(2 a forward) tenants' requests, [29f] "
                             "ParallelInference (36 a forward)",
            "forwards": dict(t["forwards"], parallel_inference=f[
                "forwards"])},
        "matmul_bias_act_int8": {
            "launches": e["launches"]["matmul_bias_act_int8"],
            "scope": scope + "[29e] the int8 alexnet canary's warmup and "
                             "requests, then the promoted tenant's "
                             "(2 a forward)",
            "forwards": e["int8_forwards"]},
        "flash_attention": {
            "launches": t["launches"]["flash_attention"],
            "scope": scope + "[29b] lm's prefills (12 a prefill)",
            "prefills": t["decode"]["prefills"]},
        "paged_decode_attention": {
            "launches": t["launches"]["paged_decode_attention"],
            "scope": scope + "[29b] lm's decode steps (12 a step)",
            "steps": t["decode"]["steps"]},
    }
    line = {
        "card": smi, "seconds": wall,
        "publish_s": v["publish_s"], "load_s": v["load_s"],
        "served_max_abs_err": t["worst"],
        "lm_streams_identical": t["streams"]["identical"],
        "latency": t["perf"], "swap": {k: c[k] for k in (
            "swap_ms", "answers", "launches", "refused")},
        "chaos": d["runs"],
        "quantized": {k: e[k] for k in ("canary", "promote_ms",
                                         "route_max_ulps", "accuracy_limit",
                                         "probe_delta")},
        "spoiled_rollback": e["spoiled_rollback"],
        "parallel_inference": f,
    }
    return line, rows


def main() -> int:
    """The build and [29] alone."""
    import sys

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.kernels import build, impls

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    cs.log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
         f"{time.monotonic() - t0:.1f} s")
    line, rows = platform_phase(torch, dev, smi)
    cs.log(json.dumps({"platform": line, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
