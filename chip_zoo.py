#!/usr/bin/env python3
"""Phase [30] of ``chip_smoke.py``: the rest of the graph zoo served at
full width on one H100, with row 1 (``matmul_bias_act``) at every routed
site.

- (a) Each of ``VGG16``, ``VGG19``, ``SqueezeNet``, ``Darknet19``,
  ``UNet``, ``Xception``, ``InceptionResNetV1``, ``TinyYOLO``, ``YOLO2``
  and ``NASNet`` at its zoo defaults (full widths and input size), float32,
  batch 8, seeded weights, seeded batch-norm affines
  (``chip_smoke.randomize_bn``) and running statistics those of a seeded
  batch (``calibrate_bn``): ``use_kernels=True`` against the
  ``use_kernels=False`` twin on the same params, both on ``cuda:0``. Gates:
  the logits (the head's pre-activation: an ``OutputLayer``'s ``W x + b``,
  else the head's input) within the model's ``LOGIT_REL_L2`` as a relative
  L2 (random softmaxes sit near uniform, so the logits are what the routes
  compute differently), and the same logits with row 1's operands rounded
  to TF32 (the kernel without its 3xTF32 split, ``one_pass_row1``) outside
  it; ``matmul_bias_act`` launches per forward, at each (M, K, N,
  activation), equal to the sites ``kernels.routing.routed_sites`` counts
  for the model (in all, the table ``EXPECTED_SITES``, counted from the
  configurations); the output's shape the configuration's output type.
  Reported: forward ms a route (host clock around ``output``,
  synchronised), images/s, peak memory a route.
- (b) YOLO2 (416x416x3, 80 classes) behind ``InferenceServer`` (its
  batching engine, ``max_batch`` 8): 8 concurrent one-image requests
  through ``predict``, each held against the stock route at [4]'s
  tolerance; ``get_predicted_objects`` + ``nms`` on both routes' answers at
  the stock route's 99th-percentile score (class probabilities of a random
  detector sit near 1/80, so no box passes the default 0.5): the same
  (image, class) pairs, boxes and confidences within ``BOX_RTOL``, a box
  whose score lies within ``BOX_RTOL`` of the threshold excepted; 8
  launches a forward over the warmup and the served batches; p50 latency
  of 16 one-image requests in turn.
- (c) Row 1 at the zoo's distinct shapes: VGG's ``fc1`` (M 8, K 25088,
  N 4096) and ``fc2`` (M 8, K 4096, N 4096), SqueezeNet's ``conv10`` (N
  1000), InceptionResNetV1's and YOLO2's largest 1x1 sites (by M*K*N),
  each against its plain version at [3]'s tolerance and timed (CUDA
  events; the profiler's device time) beside ``F.linear`` + the site's
  activation, with the FFMA and 3xTF32 bounds of [5]; the launches at
  each shape are those counted over (a)'s gated forwards.

``python3 chip_zoo.py`` builds the kernels and runs [30] alone;
``python3 chip_zoo.py --spread N`` instead reads (a)'s two logit errors
(the kernel route's and ``one_pass_row1``'s) for every model at N seeds
from ``ZOO_SEED`` on (weights, batch norms and inputs), the readings
``LOGIT_REL_L2`` is set from; ``python3 chip_zoo.py --trace`` instead
traces one forward of each of ``TRACE_MODELS`` on each route: host time a
1x1 conv or dense site (a ``torch.profiler`` CPU range around each),
device time and idle share a forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import threading
import time

import numpy as np

import chip_smoke as cs

ZOO_BATCH = 8
ZOO_SEED = 30
MODELS = ("VGG16", "VGG19", "SqueezeNet", "Darknet19", "UNet", "Xception",
          "InceptionResNetV1", "TinyYOLO", "YOLO2", "NASNet")
# routed sites a forward (plain 1x1 convs and dense layers with an
# elementwise activation), counted from the JAX package's configurations
EXPECTED_SITES = {"VGG16": 2, "VGG19": 2, "SqueezeNet": 17, "Darknet19": 7,
                  "UNet": 1, "Xception": 4, "InceptionResNetV1": 71,
                  "TinyYOLO": 1, "YOLO2": 8, "NASNet": 28}
# kernel route vs stock route, relative L2 of the logits, a model: near
# the geometric mean of the largest reading at 8 seeds and the least with
# one TF32 product a term (``one_pass_row1``), 4x or more from each
# (``python3 chip_zoo.py --spread 8``: the same readings in two processes;
# PERF.md)
LOGIT_REL_L2 = {"VGG16": 2e-5, "VGG19": 2e-5, "SqueezeNet": 8e-5,
                "Darknet19": 2e-4, "UNet": 1e-5, "Xception": 6e-5,
                "InceptionResNetV1": 9e-5, "TinyYOLO": 4e-5,
                "YOLO2": 1e-3, "NASNet": 1.8e-4}
TIMED_FORWARDS = 5
SERVE_REQUESTS = 8
LATENCY_REQUESTS = 16
BOX_QUANTILE = 0.99
BOX_RTOL = 1e-3
TRACE_MODELS = ("SqueezeNet", "InceptionResNetV1")
TRACE_FORWARDS = 5
SITE_RANGE = "zoo::site"


def _row1_launches() -> int:
    return cs.launch_counts()["matmul_bias_act"]


def _output_shape(conf, batch):
    t = conf.vertex_output_types()[conf.network_outputs[0]]
    if hasattr(t, "height"):
        return (batch, t.height, t.width, t.channels)
    return (batch, t.size)


def logits(torch, net, x):
    """The head's pre-activation on the card: the graph run up to the
    output vertex, then an ``OutputLayer``'s ``W x + b`` (the head's input
    for parameter-free heads), float32 [batch, ...]."""
    from deeplearning4j_tpu_torch.conf.layers import OutputLayer

    out = net.conf.network_outputs[0]
    spec = net.conf.vertex_map()[out]
    with torch.inference_mode():
        acts, _ = net._forward(net._fwd_params(), net.state,
                               net._prepare([x]), skip={out})
        h = acts[spec.inputs[0]]
        if spec.vertex.preprocessor is not None:
            h, _ = spec.vertex.preprocessor.forward({}, {}, h)
        if isinstance(spec.vertex.layer, OutputLayer):
            h = spec.vertex.layer.pre_output(net.params[out], h)
        return h.float().reshape(h.shape[0], -1)


def calibrate_bn(torch, net, x) -> None:
    """Every batch norm's running statistics set to one seeded batch's,
    as a trained network's track its inputs: with random statistics each
    BN of a deep plain chain (YOLO2's 22 conv + BN) rescales its input by
    a random factor, the signal fades to the betas, and the outputs stop
    depending on the image. A train-mode forward moves each running value
    to ``decay * old + (1 - decay) * batch``; the batch's is solved back
    out of it."""
    with torch.no_grad():
        _, moved = net._forward(net.params, net.state, net._prepare([x]),
                                train=True)
    vmap = net.conf.vertex_map()
    for name, st in moved.items():
        d = vmap[name].vertex.layer.decay
        for key in ("mean", "var"):
            old = net.state[name][key]
            old.copy_((st[key] - d * old) / (1.0 - d))


def _tf32(torch, t):
    """``t`` (float32) rounded to TF32, 10 mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def one_pass_row1(torch):
    """Row 1's launches take their operands rounded to TF32 inside this
    block: the kernel a dropped 3xTF32 split would leave, one TF32 product
    a term. The control a logit gate must reject."""
    from deeplearning4j_tpu_torch.kernels import impls

    real = impls._matmul_bias_act_cuda

    def one_pass(x, w, b, act, tiling):
        return real(_tf32(torch, x), _tf32(torch, w), b, act, tiling)

    impls._matmul_bias_act_cuda = one_pass
    try:
        yield
    finally:
        impls._matmul_bias_act_cuda = real


def _rel_l2(torch, z, z_ref) -> float:
    return float(torch.linalg.vector_norm(z - z_ref)
                 / torch.linalg.vector_norm(z_ref))


def build_pair(torch, dev, name, seed=ZOO_SEED) -> dict:
    """``name`` at its zoo defaults on both routes (the same params):
    weights from the configuration's seed moved by ``seed - ZOO_SEED``,
    batch norms and the input batch from ``seed``."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    t0 = time.monotonic()
    conf = getattr(zoo, name)().conf()
    conf = dataclasses.replace(conf, use_kernels=True,
                               seed=conf.seed + seed - ZOO_SEED)
    net = ComputationGraph(conf, device=dev).init()
    cs.randomize_bn(net, seed)
    t = conf.input_types[0]
    rng = np.random.default_rng(seed)
    x_cal, x = (rng.random((ZOO_BATCH, t.height, t.width, t.channels),
                           np.float32) for _ in range(2))
    calibrate_bn(torch, net, x_cal)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    return {"conf": conf, "net": net, "ref": ref, "x": x,
            "build_s": time.monotonic() - t0}


def one_pass_rel(torch, pair, z_ref) -> float:
    """The logits' relative L2 with ``one_pass_row1`` against ``z_ref``."""
    with one_pass_row1(torch):
        return _rel_l2(torch, logits(torch, pair["net"], pair["x"]), z_ref)


def _forward_ms(torch, net, x, reps=TIMED_FORWARDS) -> float:
    net.output(x)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        net.output(x)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / reps * 1e3


def _peak_mib(torch, net, x) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net.output(x)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def serve_model(torch, dev, name, smi) -> dict:
    """[30a] one model on both routes."""
    from deeplearning4j_tpu_torch.kernels import impls, routing

    pair = build_pair(torch, dev, name)
    conf, net, ref, x = pair["conf"], pair["net"], pair["ref"], pair["x"]
    t = conf.input_types[0]
    sites = routing.routed_sites(conf, ZOO_BATCH, mode="cuda")
    if len(sites) != EXPECTED_SITES[name]:
        raise AssertionError(f"[30a] {name}: {len(sites)} routed sites, "
                             f"expected {EXPECTED_SITES[name]}")

    # ---- the main path: counts from here on belong to it ----
    cs.reset_launch_counts()
    z = logits(torch, net, x)
    out = net.output(x)
    torch.cuda.synchronize()
    launches = _row1_launches()
    by_shape = dict(impls.matmul_bias_act.shapes)
    # ---- end of the main path ----
    want = {}
    for _, _, e in sites:
        key = (e.m, e.k, e.n, e.act)
        want[key] = want.get(key, 0) + 2
    if launches != 2 * len(sites) or by_shape != want:
        raise AssertionError(f"[30a] {name}: matmul_bias_act launched "
                             f"{launches} times over 2 forwards, by shape "
                             f"{by_shape}; expected {2 * len(sites)}, {want}")
    z_ref = logits(torch, ref, x)
    rel = _rel_l2(torch, z, z_ref)
    rel_one_pass = one_pass_rel(torch, pair, z_ref)
    tol = LOGIT_REL_L2[name]
    if not (math.isfinite(rel) and rel <= tol < rel_one_pass):
        raise AssertionError(f"[30a] {name}: logits differ by relative L2 "
                             f"{rel:.3e}, {rel_one_pass:.3e} with one TF32 "
                             f"product a term (tol {tol}: the first within, "
                             f"the second outside)")
    shape = _output_shape(conf, ZOO_BATCH)
    out_ref = ref.output(x)
    if out.shape != shape or out_ref.shape != shape \
            or not np.isfinite(out).all():
        raise AssertionError(f"[30a] {name}: output shape {out.shape} / "
                             f"{out_ref.shape}, want {shape}, or non-finite")
    row = {
        "model": name, "params": net.num_params(),
        "input": [t.height, t.width, t.channels], "output": list(shape[1:]),
        "routed_sites": len(sites), "launches": launches,
        "launches_per_forward": launches // 2,
        "logit_rel_l2": rel, "logit_rel_l2_one_pass": rel_one_pass,
        "logit_tol": tol, "logit_rms": float(z_ref.pow(2).mean().sqrt()),
        "build_s": pair["build_s"],
        "forward_ms_kernel": _forward_ms(torch, net, x),
        "forward_ms_stock": _forward_ms(torch, ref, x),
        "peak_mib_kernel": _peak_mib(torch, net, x),
        "peak_mib_stock": _peak_mib(torch, ref, x),
        "sites": [(s, e.m, e.k, e.n, e.act) for s, _, e in sites],
        "by_shape": by_shape,
    }
    row["images_per_s_kernel"] = ZOO_BATCH / row["forward_ms_kernel"] * 1e3
    row["images_per_s_stock"] = ZOO_BATCH / row["forward_ms_stock"] * 1e3
    cs.log(f"[30a] {name}: {row['params']:,} params, {len(sites)} routed "
           f"sites ({launches // 2} launches a forward), logits rel L2 "
           f"{rel:.3e} (tol {tol}; one TF32 product a term "
           f"{rel_one_pass:.3e}), output {list(shape)}; forward at batch "
           f"{ZOO_BATCH} {row['forward_ms_kernel']:.2f} ms kernel route "
           f"({row['images_per_s_kernel']:.1f} images/s), "
           f"{row['forward_ms_stock']:.2f} ms stock "
           f"({row['images_per_s_stock']:.1f}); peak "
           f"{row['peak_mib_kernel']:.0f} / {row['peak_mib_stock']:.0f} MiB "
           f"[{smi}]")
    return {"row": row, "net": net, "ref": ref}


def _detections(od, layer, out, threshold):
    return od.nms(od.get_predicted_objects(layer, out, threshold))


def threshold(scores) -> float:
    """The detection threshold: the ``BOX_QUANTILE`` quantile of the
    stock route's anchor scores (confidence times largest class
    probability), or the largest score below the maximum where that many
    anchors share the maximum (a saturated sigmoid and softmax give
    exactly 1.0), so that ``score > threshold`` keeps some."""
    thr = float(np.quantile(scores, BOX_QUANTILE))
    if thr >= scores.max():
        thr = float(scores[scores < scores.max()].max())
    return thr


def serve_yolo2(torch, net, ref, smi) -> dict:
    """[30b] YOLO2 behind InferenceServer."""
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.conf import layers_objdetect as od
    from deeplearning4j_tpu_torch.parallel.batcher import BatchingConfig
    from deeplearning4j_tpu_torch.parallel.serving import InferenceServer

    t = net.conf.input_types[0]
    rng = np.random.default_rng(ZOO_SEED + 1)
    images = [rng.random((1, t.height, t.width, t.channels), np.float32)
              for _ in range(SERVE_REQUESTS)]
    results = [None] * SERVE_REQUESTS
    errors = []

    # ---- the main path: counts from here on belong to it ----
    cs.reset_launch_counts()
    telemetry.reset()
    server = InferenceServer(net, batching=BatchingConfig(
        max_batch=ZOO_BATCH, max_delay_ms=50.0, settle_ms=5.0))
    try:
        warm = server.warmup()
        engine = server.engine

        def client(i):
            try:
                results[i] = engine.predict(images[i])
            except Exception as e:  # reported below, never swallowed
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"[30b] predict failed: {errors}")
        batches = int(telemetry.REGISTRY.counter(
            "dl4j_serving_batches_total").value)
        torch.cuda.synchronize()
        launches = _row1_launches()
        # ---- end of the main path ----
        lat = []
        for i in range(LATENCY_REQUESTS):
            t0 = time.monotonic()
            engine.predict(images[i % SERVE_REQUESTS])
            lat.append((time.monotonic() - t0) * 1e3)
    finally:
        server.stop()
    forwards = warm["forwards"] + batches
    if launches != 8 * forwards:
        raise AssertionError(f"[30b] matmul_bias_act launched {launches} "
                             f"times over {forwards} forwards, expected "
                             f"{8 * forwards}")
    got = np.concatenate([np.asarray(r) for r in results])
    want = np.concatenate([ref.output(im) for im in images])
    atol, rtol = cs.SERVED_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg="[30b] served YOLO2 answers")
    worst = float(np.abs(got - want).max())

    layer = net.conf.vertex_map()[net.conf.network_outputs[0]].vertex.layer
    grid = want.reshape(want.shape[:3] + (layer.n_boxes, -1))
    scores = grid[..., 4] * grid[..., 5:].max(-1)
    thr = threshold(scores)
    det_k = _detections(od, layer, got, thr)
    det_s = _detections(od, layer, want, thr)

    def firm(dets):
        return [o for o in dets
                if abs(o.confidence - thr) > BOX_RTOL * thr]

    k_firm, s_firm = firm(det_k), firm(det_s)
    pairs_k = sorted((o.example, o.predicted_class) for o in k_firm)
    pairs_s = sorted((o.example, o.predicted_class) for o in s_firm)
    if pairs_k != pairs_s or not s_firm:
        raise AssertionError(f"[30b] detections differ: kernel {pairs_k} vs "
                             f"stock {pairs_s}")
    def key(o):
        return (o.example, o.predicted_class, -o.confidence)

    box_err = 0.0
    for a, b in zip(sorted(k_firm, key=key), sorted(s_firm, key=key)):
        va = np.array([a.center_x, a.center_y, a.width, a.height,
                       a.confidence])
        vb = np.array([b.center_x, b.center_y, b.width, b.height,
                       b.confidence])
        err = float((np.abs(va - vb) / np.maximum(np.abs(vb), 1e-6)).max())
        box_err = max(box_err, err)
    if box_err > BOX_RTOL:
        raise AssertionError(f"[30b] boxes differ by {box_err:.3e} relative "
                             f"(tol {BOX_RTOL})")
    p50 = statistics.median(lat)
    cs.log(f"[30b] YOLO2 behind InferenceServer: {SERVE_REQUESTS} one-image "
         f"requests through predict == stock route (max |diff| {worst:.3e}, "
         f"tol atol={atol} rtol={rtol}); {launches} matmul_bias_act launches "
         f"over {forwards} forwards ({warm['forwards']} warmup + {batches} "
         f"served batches); anchor scores min {scores.min():.4e} median "
         f"{np.median(scores):.4e} max {scores.max():.4e} "
         f"({int((scores == scores.max()).sum())} at the max); detections "
         f"at the stock route's {BOX_QUANTILE:.0%} score {thr:.4e}: "
         f"{len(det_s)} after nms "
         f"({len(s_firm)} clear of the threshold), the same (image, class) "
         f"pairs, boxes within {box_err:.3e} relative; p50 latency "
         f"{p50:.2f} ms over {LATENCY_REQUESTS} requests in turn [{smi}]")
    return {"served_max_abs_err": worst, "launches": launches,
            "forwards": forwards, "threshold": thr,
            "detections": len(det_s), "detections_clear": len(s_firm),
            "score_max": float(scores.max()),
            "score_median": float(np.median(scores)),
            "box_rel_err": box_err, "p50_ms": p50,
            "p95_ms": sorted(lat)[math.ceil(0.95 * len(lat)) - 1]}


def zoo_shapes(rows) -> list:
    """(label, M, K, N, activation, sites, launches): VGG16's fc1 and fc2,
    SqueezeNet's conv10, and the largest 1x1 site (by M*K*N) of
    InceptionResNetV1 and of YOLO2; ``sites`` over the ten models,
    ``launches`` those counted at the shape over [30a]'s two gated
    forwards of every model (the VGG shapes: VGG16's and VGG19's)."""
    by = {r["model"]: r for r in rows}
    out = []

    def add(label, model, site):
        s = next(s for s in by[model]["sites"] if s[0] == site)
        key = tuple(s[1:])
        sites = sum(tuple(t[1:]) == key for r in rows for t in r["sites"])
        launches = sum(r["by_shape"].get(key, 0) for r in rows)
        out.append((label,) + key + (sites, launches))

    add("VGG fc1", "VGG16", "fc1")
    add("VGG fc2", "VGG16", "fc2")
    add("SqueezeNet conv10", "SqueezeNet", "conv10")
    for model in ("InceptionResNetV1", "YOLO2"):
        s = max(by[model]["sites"], key=lambda t: (t[1] * t[2] * t[3], t[2]))
        add(f"{model} {s[0]}", model, s[0])
    return out


def time_zoo_shapes(torch, F, dev, shapes, phase="30c") -> list:
    """[30c] row 1 at the zoo's shapes (``phase`` tags the log lines)."""
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import impls

    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)
    atol, rtol = cs.KERNEL_TOL["float32"]
    rows = []
    for label, m, k, n, act_name, sites, launches in shapes:
        act = Activation(act_name)
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        b = 0.1 * torch.randn((n,), generator=gen, device=dev)
        y = impls.matmul_bias_act(x, w, b, act)
        ref = impls.matmul_bias_act_plain(x, w, b, act)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        bad = int(((y - ref).abs() > atol + rtol * ref.abs()).sum())
        if bad or not torch.isfinite(y).all():
            raise AssertionError(f"[{phase}] {label} m={m} k={k} n={n}: {bad} "
                                 f"elements outside atol={atol} rtol={rtol} "
                                 f"(max |err| {err})")

        def library():
            return act.apply(F.linear(x, w, b))

        ops_ms, bytes_ms = cs.matmul_bound_ms(m, k, n, "float32")
        row = {
            "shape": label, "m": m, "k": k, "n": n, "act": act_name,
            "sites": sites, "launches": launches, "max_abs_err": err,
            "ms": cs.cuda_time_ms(lambda: impls.matmul_bias_act(x, w, b,
                                                                act)),
            "device_ms": cs.device_ms(
                lambda: impls.matmul_bias_act(x, w, b, act),
                ("mm_bias_act",)),
            "plain_ms": cs.cuda_time_ms(
                lambda: impls.matmul_bias_act_plain(x, w, b, act)),
            "library_ms": cs.cuda_time_ms(library),
            # every kernel of the library call (GEMM, bias, activation)
            "library_device_ms": sum(cs.device_times(library).values()),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": cs.tc_bound_ms(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        }
        rows.append(row)
        cs.log(f"[{phase}] {label} m={m} k={k} n={n} {act_name}: kernel "
             f"{row['ms']:.4f} ms (device {row['device_ms']}), plain "
             f"{row['plain_ms']:.4f} ms, F.linear + {act_name} "
             f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
             f"({row['bound_by']}, FFMA), {row['bound_tc_ms']:.4f} ms "
             f"(3xTF32); max |kernel - plain| {err:.3e}")
        del x, w, b, y, ref
    return rows


def zoo_phase(torch, F, dev, smi) -> tuple:
    """[30]: returns the ``{"zoo": ...}`` line and row 1's ``zoo`` entry
    for the kernels line."""
    t_start = time.monotonic()
    rows, yolo = [], None
    for name in MODELS:
        served = serve_model(torch, dev, name, smi)
        rows.append(served["row"])
        if name == "YOLO2":
            yolo = serve_yolo2(torch, served["net"], served["ref"], smi)
        del served
        torch.cuda.empty_cache()
    cs.log("[30a] routed sites a forward (expected from the configurations): "
         + ", ".join(f"{r['model']} {r['launches_per_forward']} "
                     f"({EXPECTED_SITES[r['model']]})" for r in rows))
    shape_rows = time_zoo_shapes(torch, F, dev, zoo_shapes(rows))
    wall = time.monotonic() - t_start
    cs.log(f"[30] the zoo in {wall:.1f} s [{smi}]")
    launches = sum(r["launches"] for r in rows) + yolo["launches"]
    row1 = {
        "launches": launches,
        "scope": ("[30]: two gated forwards of each of the ten zoo models "
                  "at batch 8 (its routed 1x1 convs and dense layers) and "
                  "YOLO2's served warmup and batches (8 a forward), as "
                  "counted; shapes: launches as counted at the (M, K, N, "
                  "activation) over [30a]'s gated forwards, times of one "
                  "float32 launch at a time; library = F.linear then the "
                  "activation"),
        "shapes": shape_rows,
    }
    line = {"card": smi, "seconds": wall, "batch": ZOO_BATCH,
            "models": [{k: v for k, v in r.items()
                        if k not in ("sites", "by_shape")} for r in rows],
            "yolo2_served": yolo}
    return line, row1


def spread(torch, dev, n, smi) -> dict:
    """(a)'s two logit errors a model at ``n`` seeds from ``ZOO_SEED``
    on, no gate applied: the readings ``LOGIT_REL_L2`` is set from."""
    out = {}
    for name in MODELS:
        kernel, one_pass = [], []
        for seed in range(ZOO_SEED, ZOO_SEED + n):
            pair = build_pair(torch, dev, name, seed)
            z_ref = logits(torch, pair["ref"], pair["x"])
            kernel.append(_rel_l2(torch, logits(torch, pair["net"],
                                                pair["x"]), z_ref))
            one_pass.append(one_pass_rel(torch, pair, z_ref))
            del pair, z_ref
            torch.cuda.empty_cache()
        out[name] = {"kernel": kernel, "one_pass": one_pass}
        cs.log(f"[30a spread] {name}: logits rel L2 at {n} seeds, kernel "
               f"route {min(kernel):.3e}..{max(kernel):.3e}, one TF32 "
               f"product a term {min(one_pass):.3e}..{max(one_pass):.3e} "
               f"(tol {LOGIT_REL_L2[name]}) [{smi}]")
    return out


@contextlib.contextmanager
def label_sites(torch, kernels: bool):
    """Each routed-site forward (a plain 1x1 conv or a dense layer) inside
    the block runs under the profiler range ``SITE_RANGE``: on the kernel
    route the whole route (envelope, registry selection, reshapes, the
    ctypes launch), on the stock route the layer's forward."""
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.conf.layers_cnn import ConvolutionLayer
    from deeplearning4j_tpu_torch.kernels import routing

    def labelled(real, plain):
        def fn(layer, *args, **kw):
            if not plain(layer):
                return real(layer, *args, **kw)
            with torch.profiler.record_function(SITE_RANGE):
                return real(layer, *args, **kw)
        return fn

    def conv_1x1(layer):
        return (type(layer) is ConvolutionLayer
                and routing._pair(layer.kernel_size) == (1, 1))

    def dense(layer):
        return type(layer) is DenseLayer

    if kernels:
        owners = ((routing, "_route_conv1x1", conv_1x1),
                  (routing, "_route_dense", dense))
    else:
        owners = ((ConvolutionLayer, "forward", conv_1x1),
                  (DenseLayer, "forward", dense))
    saved = [(o, a, getattr(o, a)) for o, a, _ in owners]
    for o, a, plain in owners:
        setattr(o, a, labelled(getattr(o, a), plain))
    try:
        yield
    finally:
        for o, a, real in saved:
            setattr(o, a, real)


def trace(torch, dev, smi) -> dict:
    """Host time a site and a forward's device time on each route."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name in TRACE_MODELS:
        pair = build_pair(torch, dev, name)
        x = pair["x"]
        for route, net in (("kernel", pair["net"]), ("stock", pair["ref"])):
            forward_ms = _forward_ms(torch, net, x)
            device_ms = sum(cs.device_times(lambda: net.output(x),
                                            reps=TRACE_FORWARDS).values())
            with label_sites(torch, route == "kernel"):
                net.output(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    for _ in range(TRACE_FORWARDS):
                        net.output(x)
                    torch.cuda.synchronize()
            sites = [e.cpu_time_total / 1e3 for e in prof.events()
                     if e.name == SITE_RANGE]
            row = {"forward_ms": forward_ms, "device_ms": device_ms,
                   "idle_share": 1.0 - device_ms / forward_ms,
                   "sites_a_forward": len(sites) / TRACE_FORWARDS,
                   "site_host_ms": statistics.median(sites),
                   "sites_host_ms_a_forward": sum(sites) / TRACE_FORWARDS}
            out.setdefault(name, {})[route] = row
            cs.log(f"[30 trace] {name} {route} route: forward "
                   f"{forward_ms:.2f} ms, device {device_ms:.2f} ms (idle "
                   f"{row['idle_share']:.0%}); {row['sites_a_forward']:g} "
                   f"sites a forward, median {row['site_host_ms']:.4f} ms "
                   f"host a site (profiled), "
                   f"{row['sites_host_ms_a_forward']:.2f} ms a forward in "
                   f"sites [{smi}]")
        del pair
        torch.cuda.empty_cache()
    return out


def main() -> int:
    """The build and [30] alone, or ``--spread N``."""
    import argparse
    import sys

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="read (a)'s logit errors at N seeds instead")
    ap.add_argument("--trace", action="store_true",
                    help="trace host time a site on each route instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    cs.log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
           f"{time.monotonic() - t0:.1f} s")
    serve_full_f32()
    if args.spread:
        cs.log(json.dumps({"zoo_spread": spread(torch, dev, args.spread,
                                                smi), "card": smi}))
    if args.trace:
        cs.log(json.dumps({"zoo_trace": trace(torch, dev, smi),
                           "card": smi}))
    if args.spread or args.trace:
        return 0
    line, row1 = zoo_phase(torch, F, dev, smi)
    cs.log(json.dumps({"zoo": line, "row1": row1}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
