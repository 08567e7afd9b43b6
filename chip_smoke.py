#!/usr/bin/env python3
"""Drive the PyTorch port (``deeplearning4j_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` (nvcc,
   sm_90a) and hold the probe kernel against its plain version;
3. ``matmul_bias_act`` against its plain PyTorch version on the card: the
   15 distinct (M, K, N) of ResNet-50's 36 1x1 convolutions at batch 32
   plus two ragged shapes, float32 and bfloat16, activations identity,
   relu and gelu;
4. the main path: full-width ResNet-50 (224x224x3, 1000 classes, seeded
   weights, ``use_kernels=True``) served by ``InferenceServer`` on
   127.0.0.1 with warmup, concurrent ``/predict`` requests (one uint8),
   ``/model``, ``/healthz`` and ``/metrics``; every response is held
   against ``output`` of the same weights with ``use_kernels=False``, and
   every kernel's launch count is read from this run alone;
5. serving timings (CUDA events, medians) of ``matmul_bias_act`` at the
   path's shapes beside its plain version, ``F.linear`` and the card's
   bound, and the served images/s at batch 32;
6. ``matmul_stats`` against its plain version on the card at the same 15
   shapes plus the two ragged ones, float32 and bfloat16: y, the column
   sums s and sums of squares q, and the backward (dx, dw through the
   autograd Function against autograd of the plain version);
7. the training path: full-width ResNet-50 with ``fused_conv_bn=True``
   (224x224x3, 1000 classes, batch 32, seeded weights and one-hot labels,
   the default Adam(1e-3)) trained by ``ComputationGraph.fit`` over a
   ``ListDataSetIterator`` with ``use_kernels=True``, held against the same
   weights with ``use_kernels=False`` (cuDNN 1x1 convs and one-pass
   statistics): step-1 gradients, per-step losses and the BN running
   statistics after step 1; ``matmul_stats`` launches 36 times per step,
   and the loss falls over 10 steps on the repeated batch. Then the
   default (unfused) ResNet-50 trains 2 steps at batch 8 through
   ``matmul_bias_act`` and its backward, against ``use_kernels=False``;
8. training timings: ``matmul_stats`` per shape beside its plain version,
   ``F.linear`` (the matmul part alone: no single PyTorch call also sums
   the columns) and the bound, and the train step at batch 32, kernel
   route against stock.

Then one ``{"kernels": [...]}`` line with every kernel, the served and
trained throughput lines, and last ``{"ok": true, "device": {...}}``.
Without a CUDA card, or without the repository around it, the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # FFMA / tensor core

# kernel vs plain version on the same inputs: |y - ref| <= atol + rtol*|ref|.
# float32: both accumulate in f32, in different orders (~K * 2**-24 relative
# on sums of K terms; K <= 2048); bfloat16: both round one f32 result to
# bf16, and the f32 results differ in the last bits, so one bf16 ulp (2**-8).
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 8e-3)}
# matmul_stats column statistics: |s - s_ref| <= rtol * sum|y| and
# |q - q_ref| <= rtol * sum(y^2) per column. Against f64 sums of the
# kernel's own y: f32 sums of M <= 100352 terms (per-thread, warp-shuffle
# and per-block trees, then the partials) lose about log2(M) * 2**-24
# relative. Against the plain version (f64 sums of ITS y): float32 the same;
# bfloat16 elements of y may differ by one bf16 ulp (2**-8 relative), so
# the sums by at most 2**-8 of sum|y| and 2 * 2**-8 of sum(y^2).
STATS_RTOL = {"own": 1e-5, "float32": 1e-5, "bfloat16": (4e-3, 8e-3)}
# dx, dw of the autograd Function vs autograd of the plain version, relative
# to the largest |ref|: float32 — the same cuBLAS products of the same f32
# cotangent (computed in f32 vs f64); bfloat16 — the Function rounds the
# cotangent to bf16 before its products (the JAX VJP's cast, 2**-9 relative
# per element), and the two round their products to bf16 (at most one ulp,
# 2**-8, apart): two bf16 ulps bound both.
STATS_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# served ResNet-50 softmax vs the use_kernels=False forward on the card:
# 50 layers of f32 rounding-order differences (kernel vs cuBLAS/cuDNN
# orders, and other cuDNN algorithms at other batch sizes)
SERVED_TOL = (1e-6, 1e-3)
# the 2048-wide pooled features, relative to their largest magnitude
FEATURE_RTOL = 1e-4

# training, kernel route vs use_kernels=False on the same weights and batch.
# The two routes differ only in the 1x1 convs' f32 summation order (kernel
# vs cuDNN) and in the statistics' order; the seeded weights start every
# residual branch's last BN at gamma 0.1 (see condition_residual_bn) so that
# noise is not amplified chaotically by the 50 layers.
# Step-1 gradients: the relative L2 error of the whole gradient, and of each
# tensor. Not elementwise: some tensors' gradients nearly cancel (the beta
# and gamma of a BN whose output passes through a ReLU and a conv into the
# next BN, which removes each channel's mean), so their own largest
# magnitude is small and rounding noise is large beside it; and a ReLU input
# within rounding of 0 takes the other side on the other route. The largest
# error relative to each tensor's max |g| is reported, and held only to
# TRAIN_GRAD_MAXREL, which a wrong gradient (O(1)) exceeds.
TRAIN_GRAD_L2 = {"global": 2e-3, "tensor": 2e-2}
TRAIN_GRAD_MAXREL = 0.25
# BN running statistics after step 1, relative to each vector's largest
# magnitude; per-step losses relative. Adam's first steps move each weight
# by about lr * sign(g), so a near-zero gradient whose sign differs moves
# the routes 2 * lr apart: later losses are held looser than the first.
TRAIN_STATE_RTOL = 1e-4
TRAIN_LOSS_RTOL = (1e-5, 1e-3)  # step 1, later steps
TRAIN_STEPS = 10  # kernel route, one repeated batch: the loss must fall
COMPARE_STEPS = 3  # steps compared with the stock route
UNFUSED_BATCH = 8
RESIDUAL_GAMMA = 0.1

BATCH = 32
ACTS = ("identity", "relu", "gelu")
RAGGED = ((333, 37, 75), (20001, 77, 257))
SOURCE = "deeplearning4j_tpu_torch/csrc/matmul_bias_act.cu"
STATS_SOURCE = "deeplearning4j_tpu_torch/csrc/matmul_stats.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, samples: int = 7) -> float:
    """Median per-call time of ``fn`` on the current stream (CUDA events
    around a loop long enough to hide the event overhead)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, min(100, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(samples):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def matmul_bound_ms(m: int, k: int, n: int, dtype: str):
    """Least time for y = act(x @ w.T + b) on an H100: each input read
    once, the output written once, 2*M*N*K operations at the dtype's peak.
    Returns (ops_ms, bytes_ms)."""
    size = 4 if dtype == "float32" else 2
    nbytes = (m * k + n * k + n + m * n) * size
    return (2.0 * m * n * k / PEAK_OPS_PER_S[dtype] * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def path_shapes(conf, batch: int):
    """(M, K, N) of every 1x1 convolution the routing sends to a kernel
    (matmul_bias_act, or matmul_stats for a FusedConvBN1x1), in
    topological order."""
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        FusedConvBN1x1,
    )

    types = conf.vertex_output_types()
    types.update(zip(conf.network_inputs, conf.input_types))
    vmap = conf.vertex_map()
    out = []
    for name in conf.topo_order():
        layer = getattr(vmap[name].vertex, "layer", None)
        if isinstance(layer, FusedConvBN1x1) or (
                isinstance(layer, ConvolutionLayer)
                and tuple(layer.kernel_size) == (1, 1)):
            t_in, t_out = types[vmap[name].inputs[0]], types[name]
            out.append((batch * t_out.height * t_out.width, t_in.channels,
                        t_out.channels))
    return out


def randomize_bn(net, seed: int) -> None:
    """Seeded BN statistics and affine, as a trained network has them (with
    init's identity BN the random trunk saturates the softmax)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for name, st in net.state.items():
        n = st["mean"].numel()
        p = net.params[name]
        p["gamma"].copy_(torch.empty(n).uniform_(0.1, 0.5, generator=gen))
        p["beta"].copy_(torch.empty(n).normal_(0.0, 0.1, generator=gen))
        st["mean"].copy_(torch.empty(n).normal_(0.0, 0.1, generator=gen))
        st["var"].copy_(torch.empty(n).uniform_(0.5, 1.5, generator=gen))


def condition_residual_bn(net) -> None:
    """Start the last BN of every residual branch (``*_c_bn`` / ``*_c_cb``)
    at gamma 0.1, as the zero-init-residual recipe starts it at 0 (Goyal et
    al. 2017): each bottleneck then begins near the identity, and the
    deep network stops amplifying f32 rounding noise chaotically (with
    gamma 1 a 1e-6 change of the input moves its step-1 gradients by ~2%)."""
    for name, p in net.params.items():
        if name.endswith(("_c_bn", "_c_cb")):
            p["gamma"].fill_(RESIDUAL_GAMMA)


def stats_bound_ms(m: int, k: int, n: int):
    """Least time for (y, sum y, sum y^2) = matmul_stats(x, w) in float32:
    2*M*N*K operations at the FFMA peak; x and w read once, y written
    once. Returns (ops_ms, bytes_ms)."""
    return (2.0 * m * n * k / PEAK_OPS_PER_S["float32"] * 1e3,
            (m * k + n * k + m * n) * 4 / HBM_BYTES_PER_S * 1e3)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def check_probe(torch, impls, dev) -> dict:
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    y = impls.probe(x)
    torch.cuda.synchronize()
    err = float((y - impls.probe_plain(x)).abs().max())
    if err != 0.0:
        raise AssertionError(f"probe kernel differs from x + 1 by {err}")
    log(f"[2] probe kernel == x + 1 on {tuple(x.shape)}")
    return {"x": x, "max_abs_err": err}


def check_matmul(torch, impls, Activation, dev, shapes) -> dict:
    """Kernel vs plain version at every shape/dtype/activation; returns the
    max error per dtype."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = {}
    for (m, k, n) in list(shapes) + list(RAGGED):
        x32 = torch.randn((m, k), generator=gen, device=dev)
        w32 = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        b32 = 0.1 * torch.randn((n,), generator=gen, device=dev)
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            x, w, b = x32.to(tdt), w32.to(tdt), b32.to(tdt)
            atol, rtol = KERNEL_TOL[dtype]
            for act_name in ACTS:
                act = Activation(act_name)
                y = impls.matmul_bias_act(x, w, b, act).float()
                ref = impls.matmul_bias_act_plain(x, w, b, act).float()
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                bad = int(((y - ref).abs() > atol + rtol * ref.abs()).sum())
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if bad or not torch.isfinite(y).all():
                    raise AssertionError(
                        f"matmul_bias_act m={m} k={k} n={n} {dtype} "
                        f"{act_name}: {bad} elements outside atol={atol} "
                        f"rtol={rtol} (max |err| {err})")
        log(f"[3] matmul_bias_act m={m} k={k} n={n}: f32 and bf16 x "
            f"{'/'.join(ACTS)} within tolerance")
    log(f"[3] max |kernel - plain|: float32 {worst['float32']:.3e} "
        f"(tol atol={KERNEL_TOL['float32'][0]} rtol={KERNEL_TOL['float32'][1]}),"
        f" bfloat16 {worst['bfloat16']:.3e} (tol atol="
        f"{KERNEL_TOL['bfloat16'][0]} rtol={KERNEL_TOL['bfloat16'][1]})")
    return worst


def check_matmul_stats(torch, impls, dev, shapes) -> dict:
    """matmul_stats vs its plain version at every shape and dtype: y, the
    column statistics (against the plain version and against f64 sums of
    the kernel's own y), and dx, dw through the autograd Function against
    autograd of the plain version. Returns the worst errors."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    worst = {}

    def note(key, v):
        worst[key] = max(worst.get(key, 0.0), v)

    def col_err(got, ref, scale):
        return float(((got.double() - ref.double()).abs() / scale).max())

    for (m, k, n) in list(shapes) + list(RAGGED):
        x32 = torch.randn((m, k), generator=gen, device=dev)
        w32 = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        gy32 = torch.randn((m, n), generator=gen, device=dev)
        gs32 = torch.randn((n,), generator=gen, device=dev) / math.sqrt(m)
        gq32 = torch.randn((n,), generator=gen, device=dev) / math.sqrt(m)
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            x, w = x32.to(tdt), w32.to(tdt)
            y, s, q = impls.matmul_stats(x, w)
            ry, rs, rq = impls.matmul_stats_plain(x, w)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]
            yf, ryf = y.float(), ry.float()
            bad = int(((yf - ryf).abs() > atol + rtol * ryf.abs()).sum())
            note(f"y_{dtype}", float((yf - ryf).abs().max()))
            if bad or not torch.isfinite(yf).all():
                raise AssertionError(
                    f"matmul_stats y m={m} k={k} n={n} {dtype}: {bad} "
                    f"elements outside atol={atol} rtol={rtol}")
            y64 = y.double()
            abs_sum, sq_sum = y64.abs().sum(0), (y64 * y64).sum(0)
            own_s = col_err(s, y64.sum(0), abs_sum)
            own_q = col_err(q, sq_sum, sq_sum)
            plain_s = col_err(s, rs, abs_sum)
            plain_q = col_err(q, rq, sq_sum)
            tol_s, tol_q = ((STATS_RTOL[dtype],) * 2 if dtype == "float32"
                            else STATS_RTOL[dtype])
            note("stats_own", max(own_s, own_q))
            note(f"stats_{dtype}", max(plain_s, plain_q))
            if max(own_s, own_q) > STATS_RTOL["own"] or plain_s > tol_s \
                    or plain_q > tol_q:
                raise AssertionError(
                    f"matmul_stats sums m={m} k={k} n={n} {dtype}: vs own y "
                    f"{own_s:.2e}/{own_q:.2e} (tol {STATS_RTOL['own']}), vs "
                    f"plain {plain_s:.2e}/{plain_q:.2e} (tol {tol_s}/{tol_q})")
            # the backward, with cotangents on all three outputs
            grads = []
            for fn in (impls.matmul_stats, impls.matmul_stats_plain):
                xl = x.detach().requires_grad_()
                wl = w.detach().requires_grad_()
                outs = fn(xl, wl)
                torch.autograd.backward(
                    outs, (gy32.to(tdt), gs32, gq32))
                grads.append((xl.grad.float(), wl.grad.float()))
            torch.cuda.synchronize()
            for name, got, ref in zip(("dx", "dw"), grads[0], grads[1]):
                err = float((got - ref).abs().max() / ref.abs().max())
                note(f"grad_{dtype}", err)
                if not err <= STATS_GRAD_RTOL[dtype]:
                    raise AssertionError(
                        f"matmul_stats {name} m={m} k={k} n={n} {dtype}: "
                        f"{err:.2e} relative (tol {STATS_GRAD_RTOL[dtype]})")
        log(f"[6] matmul_stats m={m} k={k} n={n}: f32 and bf16 y, s, q, "
            f"dx, dw within tolerance")
        del x32, w32, gy32
    log(f"[6] worst: {json.dumps(worst)} (y tol {KERNEL_TOL}; stats tol "
        f"{STATS_RTOL} of sum|y| / sum y^2; grads {STATS_GRAD_RTOL} of "
        f"max|ref|)")
    return worst


def serve_resnet50(torch, dev, zoo_model, seed: int = 0) -> dict:
    """The main path: ``zoo_model`` (full-width ResNet-50) behind
    InferenceServer."""
    import urllib.request

    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.batcher import BatchingConfig
    from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
    t0 = time.monotonic()
    conf = dataclasses.replace(zoo_model.conf(), use_kernels=True)
    image = (zoo_model.height, zoo_model.width, zoo_model.channels)
    classes = zoo_model.num_classes
    net = ComputationGraph(conf, device=dev).init()
    randomize_bn(net, seed)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    log(f"[4] ResNet-50 {net.num_params():,} params on {dev} "
        f"({time.monotonic() - t0:.1f} s to build)")

    rng = np.random.default_rng(seed)
    sizes = (1, 2, 3, 4, 2, 1, 4, 3)
    inputs = []
    for i, s in enumerate(sizes):
        if i == 3:  # one client sends raw pixels
            inputs.append(rng.integers(0, 256, (s,) + image, np.uint8))
        else:
            inputs.append(rng.random((s,) + image, np.float32))
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def http(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=600) as resp:
            raw = resp.read()
            return resp.status, raw

    # ---- the main path: counts from here on belong to it ----
    impls.matmul_bias_act.launches = 0
    impls.probe.launches = 0
    telemetry.reset()
    server = InferenceServer(net, batching=BatchingConfig(
        max_batch=BATCH, max_delay_ms=50.0, settle_ms=5.0))
    try:
        t0 = time.monotonic()
        warm = server.warmup()
        server.start(port=0, host="127.0.0.1")
        log(f"[4] warmup: {warm['forwards']} forwards over buckets "
            f"{warm['buckets']} in {time.monotonic() - t0:.1f} s; "
            f"serving on 127.0.0.1:{server.port}")
        results = [None] * len(inputs)
        errors = []

        def client(i):
            try:
                code, raw = http("/predict", {"inputs": [inputs[i].tolist()]})
                results[i] = (code, json.loads(raw))
            except Exception as e:  # reported below, never swallowed
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(inputs))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"/predict failed: {errors}")
        log(f"[4] {len(inputs)} concurrent /predict requests "
            f"({sum(sizes)} images) answered in {time.monotonic() - t0:.1f} s")
        code, raw = http("/model")
        model_info = json.loads(raw)
        if code != 200 or model_info.get("num_params") != net.num_params():
            raise AssertionError(f"/model: {code} {model_info}")
        code, raw = http("/healthz")
        health = json.loads(raw)
        if code != 200 or health.get("status") != "ok":
            raise AssertionError(f"/healthz: {code} {health}")
        code, raw = http("/metrics")
        metrics = raw.decode()
        if code != 200 or "dl4j_serving_batches_total" not in metrics:
            raise AssertionError(f"/metrics: {code}")
        batches = int(telemetry.REGISTRY.counter(
            "dl4j_serving_batches_total").value)
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {"matmul_bias_act": impls.matmul_bias_act.launches,
                "probe": impls.probe.launches}
    # ---- end of the main path ----
    forwards = warm["forwards"] + batches
    log(f"[4] launches on the main path: {launches} over {forwards} forwards "
        f"({warm['forwards']} warmup + {batches} served batches)")
    if launches["matmul_bias_act"] != 36 * forwards:
        raise AssertionError(
            f"matmul_bias_act launched {launches['matmul_bias_act']} times, "
            f"expected 36 per forward = {36 * forwards}")
    if launches["probe"] != 1:
        raise AssertionError(f"probe launched {launches['probe']} times on "
                             "the main path, expected 1 (capability check)")

    worst, top1 = 0.0, 0
    for i, x in enumerate(inputs):
        code, body = results[i]
        got = np.asarray(body["outputs"][0], np.float32)
        want = ref.output(x)
        if code != 200 or got.shape != (sizes[i], classes) \
                or not np.isfinite(got).all():
            raise AssertionError(f"request {i}: {code} shape {got.shape}")
        atol, rtol = SERVED_TOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"request {i}")
        if not np.array_equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"request {i}: top-1 differs")
        worst = max(worst, float(np.abs(got - want).max()))
        top1 += sizes[i]
    feats_k = net.feed_forward(inputs[6])["avgpool"]
    feats_r = ref.feed_forward(inputs[6])["avgpool"]
    feat_err = float(np.abs(feats_k - feats_r).max() / np.abs(feats_r).max())
    if not feat_err <= FEATURE_RTOL:
        raise AssertionError(f"pooled features differ by {feat_err:.3e} "
                             f"relative (tol {FEATURE_RTOL})")
    log(f"[4] served outputs == use_kernels=False outputs: max |diff| "
        f"{worst:.3e} (tol atol={SERVED_TOL[0]} rtol={SERVED_TOL[1]}), "
        f"top-1 equal on {top1} images; pooled features rel diff "
        f"{feat_err:.3e} (tol {FEATURE_RTOL})")
    return {"net": net, "ref": ref, "launches": launches,
            "served_max_abs_err": worst, "feature_rel_err": feat_err}


class _FirstStepState:
    """Listener: a copy of every BN running statistic after step 1."""

    def __init__(self):
        self.state = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == 0:
            self.state = {k: {sk: v.clone() for sk, v in vs.items()}
                          for k, vs in model.state.items()}

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _synthetic_batch(zoo_model, batch, seed):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(seed)
    x = rng.random((batch, zoo_model.height, zoo_model.width,
                    zoo_model.channels), np.float32)
    labels = np.eye(zoo_model.num_classes, dtype=np.float32)[
        rng.integers(0, zoo_model.num_classes, batch)]
    return DataSet(x, labels)


def _grad_errors(ga, gb) -> dict:
    """Errors of gradients ``ga`` against ``gb``: the relative L2 error of
    all tensors together and the worst tensors by relative L2 error and by
    max |ga - gb| / max |gb|."""
    l2, maxrel = [], []
    num = den = 0.0
    for k in gb:
        for p in gb[k]:
            a, b = ga[k][p].double(), gb[k][p].double()
            d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
            num, den = num + d2, den + b2
            l2.append(((d2 / max(b2, 1e-300)) ** 0.5, f"{k}.{p}"))
            maxrel.append((float((a - b).abs().max()
                                 / b.abs().max().clamp_min(1e-300)),
                           f"{k}.{p}"))
    return {"global_l2": (num / den) ** 0.5,
            "tensor_l2": sorted(l2, reverse=True)[:4],
            "tensor_maxrel": sorted(maxrel, reverse=True)[:4]}


def _compare_training(torch, net, ref, ds, steps, label) -> dict:
    """Step-1 gradients, the first ``steps`` losses and the BN state after
    step 1 of two graphs on the same weights and batch; the graphs are
    left trained by ``steps`` steps (``net`` through ``fit``)."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    gk, lk = net.compute_gradient_and_score(ds)
    gr, lr = ref.compute_gradient_and_score(ds)
    grad = _grad_errors(gk, gr)
    del gk, gr
    log(f"[{label}] step-1 gradients: {json.dumps(grad)}")
    out = {"grad": grad, "score_kernel": lk, "score_stock": lr}
    scores, firsts = [], []
    for model in (net, ref):
        collect, first = CollectScoresListener(), _FirstStepState()
        model.set_listeners(collect, first)
        model.fit(ListDataSetIterator([ds] * steps))
        model.set_listeners()
        scores.append(collect.scores)
        firsts.append(first.state)
    torch.cuda.synchronize()
    loss_err = [abs(a - b) / abs(b) for a, b in zip(*scores)]
    state_err = max(float((firsts[0][k][sk] - firsts[1][k][sk]).abs().max()
                          / firsts[1][k][sk].abs().max())
                    for k in firsts[1] for sk in firsts[1][k])
    out.update(losses_kernel=scores[0], losses_stock=scores[1],
               loss_rel_err=loss_err, state_rel_err=state_err)
    log(f"[{label}] losses kernel {scores[0]} stock {scores[1]}; BN state "
        f"after step 1 {state_err:.3e}")
    if not (grad["global_l2"] <= TRAIN_GRAD_L2["global"]
            and grad["tensor_l2"][0][0] <= TRAIN_GRAD_L2["tensor"]
            and grad["tensor_maxrel"][0][0] <= TRAIN_GRAD_MAXREL
            and math.isfinite(lk)):
        raise AssertionError(f"[{label}] step-1 gradients differ: {grad} "
                             f"(tol L2 {TRAIN_GRAD_L2}, max-relative "
                             f"{TRAIN_GRAD_MAXREL})")
    if not (loss_err[0] <= TRAIN_LOSS_RTOL[0]
            and max(loss_err) <= TRAIN_LOSS_RTOL[1]
            and all(math.isfinite(v) for v in scores[0])):
        raise AssertionError(f"[{label}] losses differ: {scores[0]} vs "
                             f"{scores[1]} (tol {TRAIN_LOSS_RTOL})")
    if not state_err <= TRAIN_STATE_RTOL:
        raise AssertionError(f"[{label}] BN running statistics after step 1 "
                             f"differ by {state_err:.3e} relative (tol "
                             f"{TRAIN_STATE_RTOL})")
    return out


def train_resnet50(torch, dev, seed: int = 0) -> dict:
    """The training path: full-width ResNet-50, ``fused_conv_bn=True``,
    trained by ``fit`` with ``use_kernels=True`` against
    ``use_kernels=False`` on the same weights."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    t0 = time.monotonic()
    zoo = ResNet50()
    zoo.fused_conv_bn = True
    conf = dataclasses.replace(zoo.conf(), use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    condition_residual_bn(net)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    ds = _synthetic_batch(zoo, BATCH, seed)
    log(f"[7] ResNet-50 fused_conv_bn: {net.num_params():,} params, "
        f"updater {type(conf.updater).__name__}"
        f"({conf.updater.learning_rate}), batch {BATCH} "
        f"({time.monotonic() - t0:.1f} s to build)")
    trial = net.clone()  # the main path trains a copy of the same weights

    # ---- the main path: counts from here on belong to it ----
    for k in (impls.matmul_stats, impls.matmul_bias_act, impls.probe):
        k.launches = 0
    collect = CollectScoresListener()
    trial.set_listeners(collect)
    t0 = time.monotonic()
    trial.fit(ListDataSetIterator([ds] * TRAIN_STEPS))
    torch.cuda.synchronize()
    launches = {"matmul_stats": impls.matmul_stats.launches,
                "matmul_bias_act": impls.matmul_bias_act.launches,
                "probe": impls.probe.launches}
    # ---- end of the main path ----
    losses = collect.scores
    log(f"[7] fit: {TRAIN_STEPS} steps in {time.monotonic() - t0:.1f} s, "
        f"losses {[round(v, 4) for v in losses]}; launches {launches}")
    if launches["matmul_stats"] != 36 * TRAIN_STEPS:
        raise AssertionError(
            f"matmul_stats launched {launches['matmul_stats']} times, "
            f"expected 36 per step = {36 * TRAIN_STEPS}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    del trial

    cmp = _compare_training(torch, net, ref, ds, COMPARE_STEPS, "7")
    log(f"[7] kernel vs stock route: step-1 gradients global L2 "
        f"{cmp['grad']['global_l2']:.3e} (tol {TRAIN_GRAD_L2}), losses "
        f"{cmp['loss_rel_err']} (tol {TRAIN_LOSS_RTOL}), BN state after "
        f"step 1 {cmp['state_rel_err']:.3e} (tol {TRAIN_STATE_RTOL})")
    return {"net": net, "ref": ref, "ds": ds, "launches": launches,
            "losses": losses, **cmp}


def train_unfused(torch, dev, seed: int = 1) -> dict:
    """The default ResNet-50 (unfused 1x1 conv + BN pairs) trained through
    matmul_bias_act and its backward, against use_kernels=False."""
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    zoo = ResNet50()
    conf = dataclasses.replace(zoo.conf(), use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    condition_residual_bn(net)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    ds = _synthetic_batch(zoo, UNFUSED_BATCH, seed)
    impls.matmul_bias_act.launches = 0
    cmp = _compare_training(torch, net, ref, ds, 2, "7 unfused")
    # compute_gradient_and_score and 2 fit steps: 3 forwards of 36 convs
    launches = impls.matmul_bias_act.launches
    if launches != 36 * 3:
        raise AssertionError(f"matmul_bias_act launched {launches} times in "
                             "the unfused run, expected 108")
    log(f"[7] unfused ResNet-50 at batch {UNFUSED_BATCH}, matmul_bias_act "
        f"route vs stock: step-1 gradients global L2 "
        f"{cmp['grad']['global_l2']:.3e}, losses "
        f"{cmp['loss_rel_err']}, BN state {cmp['state_rel_err']:.3e}; "
        f"{launches} launches")
    return {"launches": launches, **cmp}


def time_stats_kernel(torch, impls, F, dev, shapes) -> list:
    """Per-shape timings of matmul_stats at the training path's float32
    shapes."""
    gen = torch.Generator(device=dev).manual_seed(98)
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    rows = []
    for (m, k, n), count in counts.items():
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        err = float((impls.matmul_stats(x, w)[0]
                     - impls.matmul_stats_plain(x, w)[0]).abs().max())
        ops_ms, bytes_ms = stats_bound_ms(m, k, n)
        rows.append({
            "m": m, "k": k, "n": n, "count": count, "max_abs_err": err,
            "ms": cuda_time_ms(lambda: impls.matmul_stats(x, w)),
            "plain_ms": cuda_time_ms(lambda: impls.matmul_stats_plain(x, w)),
            "library_ms": cuda_time_ms(lambda: F.linear(x, w)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        })
        del x, w
    return rows


def train_throughput(torch, trained, smi: str, pairs: int = 5,
                     steps: int = 3) -> dict:
    """Train-step time (host clock around ``fit_batch``, which returns the
    loss and so waits for the card) at batch 32, kernel route and stock
    route in alternating turns."""
    net, ref, ds = trained["net"], trained["ref"], trained["ds"]
    times = {"kernel": [], "stock": []}
    for model in (net, ref):
        model.fit_batch(ds)
    for i in range(pairs):
        order = (("kernel", net), ("stock", ref))
        for side, model in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(steps):
                model.fit_batch(ds)
            times[side].append((time.monotonic() - t0) / steps * 1e3)
    out = {"batch": BATCH, "card": smi, "pairs": pairs,
           "steps_per_sample": steps}
    for side, v in times.items():
        out[f"step_ms_{side}"] = statistics.median(v)
        out[f"images_per_s_{side}"] = BATCH / statistics.median(v) * 1e3
    return out


def time_kernels(torch, impls, Activation, F, dev, shapes) -> list:
    """Per-shape timings of matmul_bias_act at the path's float32 shapes."""
    gen = torch.Generator(device=dev).manual_seed(99)
    act = Activation("identity")  # the path's 1x1 convs feed BN: identity
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    rows = []
    for (m, k, n), count in counts.items():
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        b = torch.zeros((n,), device=dev)
        err = float((impls.matmul_bias_act(x, w, b, act)
                     - impls.matmul_bias_act_plain(x, w, b, act)).abs().max())
        ops_ms, bytes_ms = matmul_bound_ms(m, k, n, "float32")
        rows.append({
            "m": m, "k": k, "n": n, "count": count, "max_abs_err": err,
            "ms": cuda_time_ms(lambda: impls.matmul_bias_act(x, w, b, act)),
            "plain_ms": cuda_time_ms(
                lambda: impls.matmul_bias_act_plain(x, w, b, act)),
            "library_ms": cuda_time_ms(lambda: F.linear(x, w, b)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        })
        del x, w, b
    return rows


def _total(rows, key):
    return sum(r[key] * r["count"] for r in rows)


def stats_report(rows, launches, worst) -> dict:
    ops_ms = sum(stats_bound_ms(r["m"], r["k"], r["n"])[0] * r["count"]
                 for r in rows)
    bytes_ms = sum(stats_bound_ms(r["m"], r["k"], r["n"])[1] * r["count"]
                   for r in rows)
    row = {
        "name": "matmul_stats", "route": "cuda", "source": STATS_SOURCE,
        "replaces": "deeplearning4j_tpu/kernels/impls.py:162",
        "also_replaces": "deeplearning4j_tpu/ops/conv_fused.py:76",
        "launches": launches["matmul_stats"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": _total(rows, "ms"), "plain_ms": _total(rows, "plain_ms"),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": _total(rows, "library_ms"),
        "scope": (f"one ResNet-50 training step at batch {BATCH}: the 36 "
                  "fused 1x1 conv + BN statistics sites (forward), float32; "
                  "library = F.linear, the matmul part alone (no single "
                  "PyTorch call also sums the columns)"),
        "checked": worst,
        "shapes": rows,
    }
    row["max_err"], row["time_ms"] = row["max_abs_err"], row["ms"]
    return row


def kernel_report(rows, launches, worst, probe_row, stats_row) -> dict:
    def total(key):
        return _total(rows, key)

    ops_ms = sum(matmul_bound_ms(r["m"], r["k"], r["n"], "float32")[0]
                 * r["count"] for r in rows)
    bytes_ms = sum(matmul_bound_ms(r["m"], r["k"], r["n"], "float32")[1]
                   * r["count"] for r in rows)
    mm = {
        "name": "matmul_bias_act", "route": "cuda", "source": SOURCE,
        "replaces": "deeplearning4j_tpu/kernels/impls.py:82",
        "launches": launches["matmul_bias_act"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": total("library_ms"),
        "scope": (f"one ResNet-50 forward at batch {BATCH}: the 36 1x1 "
                  "convolutions, float32; library = F.linear"),
        "max_abs_err_checked": worst,
        "shapes": rows,
    }
    mm["max_err"], mm["time_ms"] = mm["max_abs_err"], mm["ms"]
    return {"kernels": [mm, probe_row, stats_row]}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        import torch.nn.functional as F

        from deeplearning4j_tpu_torch.conf.activations import Activation
        from deeplearning4j_tpu_torch.kernels import build, impls
        from deeplearning4j_tpu_torch.zoo.graphs import ResNet50
    except ImportError as e:
        return fail(f"the port is not importable ({e}); run from the root "
                    "of a checkout")
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{count} card(s); cuda:0 = {kind}")
    smi = nvidia_smi_line()
    log(smi)

    # 2. build + probe
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    log(f"[2] nvcc built {', '.join(impls.SOURCES)} in parallel in "
        f"{time.monotonic() - t0:.1f} s")
    for name in impls.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2] ptxas {name}: {line.strip()}")
    probe = check_probe(torch, impls, dev)

    # 3. the serving kernel against its plain version
    shapes = path_shapes(ResNet50().conf(), BATCH)
    if len(shapes) != 36 or len(set(shapes)) != 15:
        return fail(f"expected 36 1x1 convs / 15 distinct shapes, got "
                    f"{len(shapes)} / {len(set(shapes))}")
    worst = check_matmul(torch, impls, Activation, dev, sorted(set(shapes)))

    # 4. the serving path
    served = serve_resnet50(torch, dev, ResNet50())

    # 5. serving timings
    rows = time_kernels(torch, impls, Activation, F, dev, shapes)
    x = probe["x"]
    probe_row = {
        "name": "probe", "route": "cuda", "source": SOURCE,
        "replaces": "deeplearning4j_tpu/kernels/routing.py:82",
        "launches": served["launches"]["probe"],
        "max_abs_err": probe["max_abs_err"],
        "ms": cuda_time_ms(lambda: impls.probe(x)),
        "plain_ms": cuda_time_ms(lambda: impls.probe_plain(x)),
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_time_ms(lambda: torch.add(x, 1.0)),
    }
    probe_row["max_err"], probe_row["time_ms"] = (probe_row["max_abs_err"],
                                                probe_row["ms"])
    for r in rows:
        log(f"[5] m={r['m']} k={r['k']} n={r['n']} x{r['count']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, F.linear "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    served_line = served_throughput(torch, served, smi)
    served_launches = served["launches"]
    del served
    torch.cuda.empty_cache()

    # 6. the training kernel against its plain version
    fused = ResNet50()
    fused.fused_conv_bn = True
    if path_shapes(fused.conf(), BATCH) != shapes:
        return fail("the fused graph's 1x1 sites differ from the unfused")
    stats_worst = check_matmul_stats(torch, impls, dev, sorted(set(shapes)))

    # 7. the training path
    trained = train_resnet50(torch, dev)
    unfused = train_unfused(torch, dev)
    torch.cuda.empty_cache()

    # 8. training timings
    stat_rows = time_stats_kernel(torch, impls, F, dev, shapes)
    for r in stat_rows:
        log(f"[8] matmul_stats m={r['m']} k={r['k']} n={r['n']} "
            f"x{r['count']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, F.linear {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    train_line = train_throughput(torch, trained, smi)
    for key in ("grad", "loss_rel_err", "state_rel_err", "losses"):
        train_line[key] = trained[key]
    train_line["unfused"] = {k: unfused[k] for k in (
        "grad", "loss_rel_err", "state_rel_err", "launches")}

    report = kernel_report(rows, served_launches, worst, probe_row,
                           stats_report(stat_rows, trained["launches"],
                                        stats_worst))
    mm, st = report["kernels"][0], report["kernels"][2]
    log(f"[5] per forward: matmul_bias_act {mm['ms']:.3f} ms, plain "
        f"{mm['plain_ms']:.3f} ms, F.linear {mm['library_ms']:.3f} ms, "
        f"bound {mm['bound_ms']:.3f} ms ({mm['bound_by']}) [{smi}]")
    log(f"[8] per training step: matmul_stats {st['ms']:.3f} ms, plain "
        f"{st['plain_ms']:.3f} ms, F.linear {st['library_ms']:.3f} ms, "
        f"bound {st['bound_ms']:.3f} ms ({st['bound_by']}); train step "
        f"{train_line['step_ms_kernel']:.2f} ms kernel route, "
        f"{train_line['step_ms_stock']:.2f} ms stock [{smi}]")
    log(json.dumps(report))
    log(json.dumps({"served": served_line}))
    log(json.dumps({"trained": train_line}))
    log(f"[8] total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def served_throughput(torch, served, smi: str) -> dict:
    """Images/s at batch 32: through the batching engine (numpy in, numpy
    out) and the forward alone, with and without the kernel."""
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
    )

    net, ref = served["net"], served["ref"]
    t = net.conf.input_types[0]
    x = np.random.default_rng(7).random(
        (BATCH, t.height, t.width, t.channels), np.float32)

    def forward_ms(model, reps=10):
        model.output(x)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            model.output(x)
        return (time.monotonic() - t0) / reps * 1e3

    out = {"batch": BATCH, "card": smi,
           "forward_ms": forward_ms(net),
           "forward_plain_ms": forward_ms(ref)}
    with InferenceEngine(net, BatchingConfig(max_batch=BATCH)) as engine:
        engine.predict(x)
        reps = 20
        t0 = time.monotonic()
        for _ in range(reps):
            engine.predict(x)
        out["engine_images_per_s"] = reps * BATCH / (time.monotonic() - t0)
    out["forward_images_per_s"] = BATCH / out["forward_ms"] * 1e3
    return out


if __name__ == "__main__":
    sys.exit(main())
