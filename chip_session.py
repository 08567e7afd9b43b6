#!/usr/bin/env python3
"""Phase [34] of ``chip_smoke.py``: preemption-safe, monitored training on
one H100, with full-width ResNet-50 (224x224x3, 1000 classes,
``fused_conv_bn``, Adam, batch 32, ``use_kernels``: row 2,
``matmul_stats``, at its 36 sites a step on every rank).

- (a) The 3xTF32 split keeps NaN and infinity: rows 1, 2 and 6-8 on inputs
  holding the NaN CUDA arithmetic makes (0x7fffffff), 0xffffffff, +-inf,
  3.4e38 and FLT_MAX give the NaN and infinity pattern of their plain
  versions, and agree within their tolerances wherever no special value
  reached.
- (b) ``TrainingSession(ParallelWrapper(exact), snapshot_every=2)`` at one
  NCCL rank, 8 steps: a seeded ``FaultPlan`` raises at ``train.step`` on
  step 5, the session resumes, and params, BN state and Adam state after
  step 8 equal an uninterrupted run's bit for bit; a fresh process resumes
  from the directory alone and finishes equal again.
- (c) Two gloo ranks share ``cuda:0`` in ZeRO mode with pod snapshots (two
  shards): a ``HostDeathError`` at ``pod.heartbeat`` on rank 1 and a
  resume end bit-identical to the uninterrupted 2-rank run; a restore at
  one rank (pod shape 2 -> 1) equals the gathered params bitwise; a
  corrupted shard is passed over with its named reason.
- (d) The wrapper's guard modes at NCCL x1 and gloo x2, exact and ZeRO:
  SKIP_STEP with a NaN planted in one rank's shard at step 3 skips the
  step on every rank (params, optimizer and BN state after step 3 equal
  those after step 2 bit for bit), step 4 moves; WARN counts the step;
  no synchronizing call a step under SKIP_STEP at NCCL.
- (e) During (b), a ``StatsListener(frequency=2)`` posts through
  ``RemoteUIStatsStorageRouter`` to a ``UIServer`` on 127.0.0.1:0:
  ``/health`` strict JSON with ``dl4j_resumes_total`` >= 1 (and the pod
  block during (c)), one record per 2 iterations in ``/train/stats.json``,
  the other endpoints 200 and ``/sharding`` 501.
- (f) The legacy solvers on LeNet (row 1 at its dense layer), a synthetic
  MNIST full batch of 256: ``LBFGS``, ``ConjugateGradient`` and
  ``LineGradientDescent`` lower the loss monotonically on both routes,
  and the kernel route's first loss and gradient lie within row 1's
  tolerance of the stock route's.
- (g) ``OpProfiler``'s NaN panic raises on a planted NaN,
  ``ProfilerListener`` reports step times, and a trace file is written.

``python3 chip_session.py`` builds the kernels and runs [34] alone;
``--only a`` runs the named parts (letters, e.g. ``--only ad``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs

SEED = 34
# the special values of (a), as float32 bit patterns: the NaN CUDA
# arithmetic makes, its negative, a host NaN, +-inf, 3.4e38, FLT_MAX
SPECIAL_BITS = (0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0x7F800000, 0xFF800000,
                0x7F7FC99E, 0x7F7FFFFF)
# "elsewhere" in (a): outputs whose plain value is finite and below this
# magnitude, i.e. that no special value reached
UNTOUCHED = 1e6
# (b)-(e): full-width ResNet-50 (``RESNET``: the zoo's defaults), global
# batch 32, one epoch of 8 steps, a snapshot every 2, the train.step fault
# on call 5 (a resume from the iteration-4 snapshot); the pod session of
# (c) takes 6 steps and loses host 1 at its 4th heartbeat
RESNET = {}
BATCH = 32
STEPS = 8
SNAP_EVERY = 2
KILL_AT = 5
POD_STEPS = 6
HEARTBEAT_KILL = 4
STATS_FREQ = 2
POISON_STEP = 3  # (d): the step whose rank-1 rows hold a NaN
GUARD_PAIRS, GUARD_STEPS = 2, 4
SYNC_STEPS = 2
TIMEOUT = 600.0
# (f): LeNet on a synthetic MNIST full batch
LENET_N = 256
LBFGS_ITERS, CG_ITERS, GD_ITERS = 20, 10, 10
# the endpoints (e) reads, all of which answer 200, and /sharding's 501
ENDPOINTS = ("/", "/train/stats.json", "/metrics", "/metrics.json",
             "/platform", "/slo", "/traces", "/analysis", "/health")


def _log(msg: str) -> None:
    cs.log(msg)


def _plant(torch, t, where):
    """Writes SPECIAL_BITS[i] at index ``where(i)`` of ``t`` (float32)."""
    bits = t.view(torch.int32)
    for i, word in enumerate(SPECIAL_BITS):
        bits[where(i)] = word - (1 << 32) if word >= 1 << 31 else word


def _same_pattern(torch, name, got, ref, tol, scale=None) -> dict:
    """NaN where the plain version has NaN, inf of the same sign where it
    has inf, and within ``tol`` (atol, rtol) where it is finite and below
    UNTOUCHED (with ``scale``, within ``rtol * scale`` instead: the column
    statistics' rule). Raises otherwise."""
    got, ref = got.float(), ref.float()
    nan_ok = torch.equal(torch.isnan(got), torch.isnan(ref))
    inf_ok = torch.equal(torch.isinf(got) & (got > 0),
                         torch.isinf(ref) & (ref > 0)) and torch.equal(
        torch.isinf(got) & (got < 0), torch.isinf(ref) & (ref < 0))
    calm = torch.isfinite(ref) & (ref.abs() < UNTOUCHED)
    if scale is None:
        err, bad = cs._within(torch, got[calm], ref[calm], tol)
    else:
        diff = (got[calm] - ref[calm]).abs().double()
        err = float(diff.max()) if diff.numel() else 0.0
        bad = int((diff > tol[1] * scale[calm]).sum())
    big = torch.isfinite(ref) & ~calm
    big_ok = bool(torch.isfinite(got[big]).all())
    out = {"nan": int(torch.isnan(ref).sum()),
           "inf": int(torch.isinf(ref).sum()), "huge_finite": int(big.sum()),
           "calm": int(calm.sum()), "max_abs_err": err}
    if not (nan_ok and inf_ok and bad == 0 and big_ok):
        raise AssertionError(
            f"[34a] {name}: NaN pattern {'same' if nan_ok else 'differs'} "
            f"(kernel {int(torch.isnan(got).sum())}, plain {out['nan']}), "
            f"inf pattern {'same' if inf_ok else 'differs'}, {bad} calm "
            f"outputs outside {tol}, huge finite kept {big_ok}")
    return out


def special_values(torch, dev) -> dict:
    """(a): rows 1, 2 and 6-8 on planted special values against their plain
    versions. Each special value sits at its own row (or head) and its own
    k."""
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = len(SPECIAL_BITS)
    out = {}
    m, k, nn = 256, 1024, 512
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((nn, k), generator=gen, device=dev) / k ** 0.5
    b = torch.randn((nn,), generator=gen, device=dev)
    xs, ws = x.clone(), w.clone()
    _plant(torch, xs, lambda i: (3 * i, 17 + i))
    _plant(torch, ws, lambda i: (5 * i + 1, 200 + i))
    tol = cs.KERNEL_TOL["float32"]
    ident = Activation.IDENTITY
    out["row1_x"] = _same_pattern(
        torch, "row 1, specials in x", impls.matmul_bias_act(xs, w, b, ident),
        impls.matmul_bias_act_plain(xs, w, b, ident), tol)
    out["row1_w"] = _same_pattern(
        torch, "row 1, specials in W", impls.matmul_bias_act(x, ws, b, ident),
        impls.matmul_bias_act_plain(x, ws, b, ident), tol)
    # the kernel's own count of the NaN a row keeps, [33d]'s reading
    out["cuda_nan_rows_kept"] = int(torch.isnan(
        impls.matmul_bias_act(xs, w, b, ident)[0]).sum())
    out["cuda_nan_row_width"] = nn
    if out["cuda_nan_rows_kept"] != nn:
        raise AssertionError(f"[34a] row 1 kept the 0x7fffffff NaN in "
                             f"{out['cuda_nan_rows_kept']} of {nn} outputs")
    srt = cs.STATS_RTOL["float32"]
    for name, (xa, wa) in (("row2_x", (xs, w)), ("row2_w", (x, ws))):
        y, s, q = impls.matmul_stats(xa, wa)
        yr, sr, qr = impls.matmul_stats_plain(xa, wa)
        out[name] = {"y": _same_pattern(torch, f"row 2 y ({name})", y, yr,
                                        tol)}
        # STATS_RTOL's rule: relative to sum|y| and sum(y^2) per column
        y64 = yr.double()
        out[name]["s"] = _same_pattern(torch, f"row 2 s ({name})", s, sr,
                                       (0.0, srt), y64.abs().sum(0))
        out[name]["q"] = _same_pattern(torch, f"row 2 q ({name})", q, qr,
                                       (0.0, srt), (y64 * y64).sum(0))
    # rows 6-8: [2, 12, 256, 64] non-causal; batch 1 clean, batch 0 holds a
    # special at head i (q in the forward, do in the backward) and at head
    # n + i (v in the forward, k in the backward)
    bsz, heads, t, d = 2, 2 * n, 256, 64
    q, kk, v, do = (torch.randn((bsz, heads, t, d), generator=gen,
                                device=dev) for _ in range(4))
    qs, vs = q.clone(), v.clone()
    _plant(torch, qs, lambda i: (0, i, 11 + 3 * i, 5 + i))
    _plant(torch, vs, lambda i: (0, n + i, 7 + 5 * i, 20 + i))
    att_tol = cs.ATTN_TOL["float32"]["o"]
    o_k = att.flash_attention(qs, kk, vs)
    o_p = att.flash_attention_plain(qs, kk, vs)[0]
    out["row6"] = _same_pattern(torch, "row 6 o", o_k, o_p, att_tol)
    o, l, mm = att.flash_attention_plain(q, kk, v)
    dos, ks = do.clone(), kk.clone()
    _plant(torch, dos, lambda i: (0, i, 13 + 3 * i, 9 + i))
    _plant(torch, ks, lambda i: (0, n + i, 3 + 7 * i, 30 + i))
    bwd_tol = cs.ATTN_BWD_TOL["float32"]
    got = att.flash_attention_bwd(q, ks, v, None, o, l, mm, dos)
    ref = att.flash_attention_bwd_plain(q, ks, v, None, o, l, mm, dos)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        out[f"rows7_8_{name}"] = _same_pattern(torch, f"rows 7-8 {name}", g,
                                               r, bwd_tol)
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# helpers shared by the ranks
# --------------------------------------------------------------------------

def _deterministic(torch) -> None:
    """cuDNN's deterministic algorithms: every run of a step the same bits
    (the resumes' and the guards' gates are bitwise)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _digest(*trees) -> str:
    """sha1 of the bits of tensor trees (sorted keys)."""
    import hashlib

    h = hashlib.sha1()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())

    for t in trees:
        walk(t)
    return h.hexdigest()


def _trees_digest(net) -> str:
    return _digest(net.params, net.state, net.opt_state)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().clone()


def _resnet(torch, dev, cfg):
    """The phase's ResNet-50 (fused_conv_bn, use_kernels) on ``dev``, its
    residual BN conditioned as [21] does, and the zoo model."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    zoo = ResNet50(**cfg["model"])
    zoo.fused_conv_bn = True
    conf = dataclasses.replace(zoo.conf(), use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    cs.condition_residual_bn(net)
    return zoo, net


def _fresh(net):
    """A new network of ``net``'s configuration holding its params and
    state (the start of every run of the phase)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ComputationGraph(net.conf, device=net.device).set_params(
        _host(net.params), _host(net.state))


def _batches(cfg, zoo, n, dev=None, rank=0, world=1, plant=None):
    """This rank's rows of ``n`` seeded global batches (on ``dev`` when
    given: a CUDA batch reaches the step without a copy); ``plant``: the
    batch index whose first row of this rank's share becomes NaN."""
    import torch

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import mesh

    out = []
    for t in range(n):
        ds = cs._synthetic_batch(zoo, cfg["batch"], SEED + t)
        lo, hi, _ = mesh.partition_rows(cfg["batch"], rank, world)
        x, y = ds.features[lo:hi].copy(), ds.labels[lo:hi]
        if plant == t:
            x[0] = np.nan
        if dev is not None:
            x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y,
                                                                   device=dev)
        out.append(DataSet(x, y))
    return out


def _iterate(batches):
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )

    return ListDataSetIterator(batches)


def _wrapper(net, mode):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    kw = {"zero_optimizer": True, "gradient_bucket_mb": 0} \
        if mode == "zero" else {}
    return ParallelWrapper(net, prefetch_buffer=0, **kw)


def _get(port, path):
    """(status, body) of a GET on the local UIServer (no proxy)."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _strict(body: bytes):
    def bad(c):
        raise AssertionError(f"[34e] bare {c} literal in strict JSON")

    return json.loads(body.decode(), parse_constant=bad)


def _endpoints(port) -> dict:
    """Every endpoint (e) reads: status codes, /health and the records."""
    out = {"status": {}}
    for path in ENDPOINTS + ("/sharding",):
        code, body = _get(port, path)
        out["status"][path] = code
        if path == "/health":
            out["health"] = _strict(body)
        elif path == "/train/stats.json":
            out["records"] = _strict(body)
        elif path == "/sharding":
            out["sharding"] = json.loads(body.decode())
    return out


class _Timed:
    """Wall ms of each call of a bound method (the card synchronized)."""

    def __init__(self, torch, obj, name):
        self.torch, self.ms = torch, []
        self.real = getattr(obj, name)
        setattr(obj, name, self)

    def __call__(self, *a, **kw):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        t0 = time.monotonic()
        out = self.real(*a, **kw)
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.ms.append((time.monotonic() - t0) * 1e3)
        return out


def _sync_count(torch, pw, batches) -> int:
    """Synchronizing calls over the wrapper's steps on ``batches`` (the
    warnings of ``set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for ds in batches:
                pw._fit_batch(ds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own notice that it is a prototype is no synchronizing call
    found = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    for w in found:
        _log(f"[34d] sync: {str(w.message)[:120]} ({w.filename}:{w.lineno})")
    return len(found)


# --------------------------------------------------------------------------
# (d) the guard modes, on whatever ranks call it
# --------------------------------------------------------------------------

def guard_modes(torch, base, zoo, cfg, rank, world, dev, time_it=False):
    """SKIP_STEP with a NaN in rank 1's rows (rank 0's at one rank) of step
    POISON_STEP, exact and ZeRO: every tree after that step is the step
    before's, bit for bit, and the next step moves; WARN counts it. With
    ``time_it`` (NCCL at one rank) also the synchronizing calls a step and
    the guard's ms a step."""
    from deeplearning4j_tpu_torch.telemetry import health

    out = {}
    bad_rank = 1 if world > 1 else 0
    plant = POISON_STEP - 1 if rank == bad_rank else None
    data = _batches(cfg, zoo, POISON_STEP + 1, dev, rank, world, plant)
    for mode in ("exact", "zero"):
        health.configure("skip_step", flush_every=1000, record_flights=False)
        try:
            net = _fresh(base)
            pw = _wrapper(net, mode)
            pw.fit(_iterate(data[:POISON_STEP - 1]))
            before = _trees_digest(net)
            pw.fit(_iterate(data[POISON_STEP - 1:POISON_STEP]))
            same = _trees_digest(net) == before
            pw.fit(_iterate(data[POISON_STEP:]))
            moved = _trees_digest(net) != before
            rep = health.report()
            res = {"skip_same_bits": same, "next_step_moved": moved,
                   "skipped_steps": rep["skipped_steps"],
                   "nonfinite_steps": rep["nonfinite_steps"]}
            health.configure("warn", flush_every=1000, record_flights=False)
            net = _fresh(base)
            _wrapper(net, mode).fit(_iterate(data[:POISON_STEP]))
            res["warn_nonfinite_steps"] = health.report()["nonfinite_steps"]
            del net, pw
        finally:
            health.disable()
            health.MONITOR.reset()
        out[mode] = res
    if time_it:
        out["timing"] = _guard_timing(torch, base, zoo, cfg, dev)
    return out


def _guard_timing(torch, base, zoo, cfg, dev) -> dict:
    """Exact mode at one NCCL rank: synchronizing calls a step unguarded
    and under SKIP_STEP (batches already on the card), then the guard's
    ms a step, the modes in alternating turns."""
    from deeplearning4j_tpu_torch.telemetry import health

    data = _batches(cfg, zoo, 1 + max(SYNC_STEPS, GUARD_STEPS), dev)
    net = _fresh(base)
    pw = _wrapper(net, "exact")
    out = {"syncs_per_step": {}}
    try:
        for mode in ("none", "skip_step"):
            if mode == "none":
                health.disable()
            else:
                health.configure(mode, flush_every=1000,
                                 record_flights=False)
            pw.fit(_iterate(data[:1]))  # sets the step up for the mode
            out["syncs_per_step"][mode] = _sync_count(
                torch, pw, data[1:1 + SYNC_STEPS]) / SYNC_STEPS
        times = {"none": [], "skip_step": []}
        for i in range(GUARD_PAIRS):
            for mode in (("none", "skip_step") if i % 2 == 0
                         else ("skip_step", "none")):
                if mode == "none":
                    health.disable()
                else:
                    health.configure(mode, flush_every=1000,
                                     record_flights=False)
                pw.fit(_iterate(data[:1]))
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for ds in data[1:1 + GUARD_STEPS]:
                    pw._fit_batch(ds)
                torch.cuda.synchronize()
                times[mode].append((time.monotonic() - t0) / GUARD_STEPS
                                   * 1e3)
    finally:
        health.disable()
        health.MONITOR.reset()
    import statistics

    out["step_ms"] = {m: statistics.median(v) for m, v in times.items()}
    out["guard_ms_per_step"] = (out["step_ms"]["skip_step"]
                                - out["step_ms"]["none"])
    return out


# --------------------------------------------------------------------------
# (b), (d) at NCCL x1 and (e): one rank
# --------------------------------------------------------------------------

def session_rank(rank, world, cfg):
    """(b) the uninterrupted run, the killed-and-resumed session (with
    (e)'s listener, router and server), a session killed for good in
    ``cfg["dead_dir"]`` for the fresh process; (d) at this rank count;
    the listener's cost."""
    import torch

    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.resilience import (
        FaultPlan,
        InjectedFault,
        TrainingSession,
    )
    from deeplearning4j_tpu_torch.ui import (
        RemoteUIStatsStorageRouter,
        StatsListener,
        UIServer,
    )

    _deterministic(torch)
    dev = torch.device(cfg["device"], 0) if cfg["device"] == "cuda" \
        else torch.device("cpu")
    zoo, base = _resnet(torch, dev, cfg)
    data = _batches(cfg, zoo, STEPS)
    out = {}
    # the uninterrupted run; row 2's launches a step
    net = _fresh(base)
    impls.matmul_stats.launches = 0
    _wrapper(net, "exact").fit(_iterate(data))
    out["row2_launches_per_step"] = impls.matmul_stats.launches / STEPS
    ref = _trees_digest(net)
    out["reference_digest"] = ref
    del net
    # the session, listened to by StatsListener -> router -> UIServer
    ui = UIServer()
    port = ui.start(port=0)
    try:
        router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}")
        net = _fresh(base)
        net.set_listeners(StatsListener(router, frequency=STATS_FREQ))
        sess = TrainingSession(_wrapper(net, "exact"), cfg["dir"],
                               snapshot_every_n_iterations=SNAP_EVERY)
        snap_t = _Timed(torch, sess, "snapshot")
        resume_t = _Timed(torch, sess, "resume")
        plan = FaultPlan(seed=SEED).inject("train.step", on_calls=[KILL_AT])
        impls.matmul_stats.launches = 0
        with plan.armed():
            sess.fit(_iterate(data))
        out["session_row2_launches"] = impls.matmul_stats.launches
        model = sess._net
        out["session"] = {
            "restarts": sess.restarts, "fired": plan.fired("train.step"),
            "iteration": model.iteration,
            "same_bits": _trees_digest(model) == ref,
            "snapshot_ms": snap_t.ms, "resume_ms": resume_t.ms,
            "snapshot_mb": max(os.path.getsize(os.path.join(
                cfg["dir"], s["file"])) for s in sess.snapshots()) / 2 ** 20}
        if not router.flush(timeout=60):
            raise AssertionError("[34e] the router did not deliver")
        out["router_dropped"] = router.dropped
        out["endpoints"] = _endpoints(port)
        del model, sess, net
        # the listener's added ms a step: with and without, alternating
        out["listener"] = _listener_cost(torch, base, data, router)
    finally:
        ui.stop()
    # a session that dies for good: the fresh process resumes it
    sess = TrainingSession(_wrapper(_fresh(base), "exact"),
                           cfg["dead_dir"],
                           snapshot_every_n_iterations=SNAP_EVERY,
                           max_restarts=0)
    with FaultPlan(seed=SEED).inject("train.step",
                                     on_calls=[KILL_AT]).armed():
        try:
            sess.fit(_iterate(data))
            raise AssertionError("[34b] the killed session finished")
        except InjectedFault:
            pass
    del sess
    out["guards"] = guard_modes(torch, base, zoo, cfg, rank, world, dev,
                                time_it=cfg["device"] == "cuda")
    return out


def _listener_cost(torch, base, data, router) -> dict:
    import statistics

    from deeplearning4j_tpu_torch.ui import StatsListener

    net = _fresh(base)
    pw = _wrapper(net, "exact")
    listener = StatsListener(router, frequency=STATS_FREQ)
    times = {"none": [], "stats": []}
    for i in range(GUARD_PAIRS):
        for side in (("none", "stats") if i % 2 == 0 else ("stats", "none")):
            net.set_listeners(*([listener] if side == "stats" else []))
            pw.fit(_iterate(data[:1]))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.monotonic()
            pw.fit(_iterate(data[1:1 + GUARD_STEPS]))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            times[side].append((time.monotonic() - t0) / GUARD_STEPS * 1e3)
    router.flush(timeout=60)
    step = {k: statistics.median(v) for k, v in times.items()}
    return {"step_ms": step, "added_ms_per_step": step["stats"]
            - step["none"], "frequency": STATS_FREQ}


def resume_rank(rank, world, cfg):
    """(b)'s fresh process: the killed session's directory alone restores
    the model, and the session finishes the epoch."""
    import torch

    from deeplearning4j_tpu_torch.resilience import TrainingSession

    _deterministic(torch)
    dev = torch.device(cfg["device"], 0) if cfg["device"] == "cuda" \
        else torch.device("cpu")
    t0 = time.monotonic()
    net = TrainingSession(None, cfg["dead_dir"], device=dev).resume()
    resume_ms = (time.monotonic() - t0) * 1e3
    zoo = _zoo(cfg)
    sess = TrainingSession(_wrapper(net, "exact"), cfg["dead_dir"],
                           snapshot_every_n_iterations=SNAP_EVERY)
    sess.resume()
    start = sess._net.iteration
    sess.fit(_iterate(_batches(cfg, zoo, STEPS)), to_epoch=1)
    return {"digest": _trees_digest(sess._net), "resumed_at": start,
            "iteration": sess._net.iteration, "resume_ms": resume_ms}


def _zoo(cfg):
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    return ResNet50(**cfg["model"])


# --------------------------------------------------------------------------
# (c) and (d) at two gloo ranks sharing the card
# --------------------------------------------------------------------------

def pod_rank(rank, world, cfg):
    """(c): the uninterrupted two-rank ZeRO run, then a pod session whose
    rank 1 dies at its HEARTBEAT_KILL-th heartbeat; rank 0 reads /health
    after it. (d) at two ranks."""
    import torch

    from deeplearning4j_tpu_torch.resilience import (
        FaultPlan,
        HostDeathError,
        TrainingSession,
    )
    from deeplearning4j_tpu_torch.ui import UIServer

    _deterministic(torch)
    dev = torch.device(cfg["device"], 0) if cfg["device"] == "cuda" \
        else torch.device("cpu")
    zoo, base = _resnet(torch, dev, cfg)
    data = _batches(cfg, zoo, POD_STEPS, rank=rank, world=world)
    net = _fresh(base)
    _wrapper(net, "zero").fit(_iterate(data))
    ref = _trees_digest(net)
    ref_params = _digest(net.params)
    del net
    sess = TrainingSession(_wrapper(_fresh(base), "zero"), cfg["pod_dir"],
                           snapshot_every_n_iterations=SNAP_EVERY,
                           pod=world)
    snap_t = _Timed(torch, sess, "snapshot")
    resume_t = _Timed(torch, sess, "resume")
    plan = FaultPlan(seed=SEED)
    if rank == 1:
        plan.inject("pod.heartbeat", on_calls=[HEARTBEAT_KILL],
                    exc=lambda: HostDeathError(host=1))
    with plan.armed():
        sess.fit(_iterate(data))
    out = {"same_bits": _trees_digest(sess._net) == ref,
           "params_digest": ref_params, "restarts": sess.restarts,
           "iteration": sess._net.iteration,
           "snapshots": [s["file"] for s in sess.snapshots()],
           "snapshot_ms": snap_t.ms, "resume_ms": resume_t.ms}
    del sess
    if rank == 0:
        ui = UIServer()
        port = ui.start(port=0)
        try:
            code, body = _get(port, "/health")
        finally:
            ui.stop()
        out["health_status"] = code
        out["health"] = _strict(body)
    out["guards"] = guard_modes(torch, base, zoo, cfg, rank, world, dev)
    return out


# --------------------------------------------------------------------------
# (f) the legacy solvers, (g) the profiler: in this process
# --------------------------------------------------------------------------

def legacy_solvers(torch, dev, smi) -> dict:
    """(f): LeNet (row 1 at its dense layer on the kernel route) on a
    synthetic MNIST full batch, each solver on both routes from the same
    params: the loss history never rises and ends below its start; the
    kernel route's first loss and gradient against the stock route's."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import legacy

    it = MnistDataSetIterator(batch=LENET_N, train=True,
                              num_examples=LENET_N, seed=SEED)
    if not it.synthetic:
        raise AssertionError("[34f] MNIST resolved to files, not the seeded "
                             "synthetic set")
    ds = next(iter(it))
    kernel = cs._lenet_net(torch, dev, True)
    p0, s0 = _host(kernel.params), _host(kernel.state)

    def net(use_kernels):
        conf = dataclasses.replace(kernel.conf, use_kernels=use_kernels)
        return MultiLayerNetwork(conf, dev).set_params(_host(p0),
                                                       _host(s0))

    # the first loss and gradient of both routes
    first = {}
    for route, uk in (("kernel", True), ("stock", False)):
        _, vg, x0, _ = legacy._flat_loss_fn(net(uk), ds)
        first[route] = vg(x0)
    atol, rtol = cs.KERNEL_TOL["float32"]
    (lk, gk), (ls, gs) = first["kernel"], first["stock"]
    grad_err, grad_bad = cs._within(torch, gk, gs, (atol, rtol))
    out = {"loss_kernel": float(lk), "loss_stock": float(ls),
           "grad_max_abs_err": grad_err, "grad_outside_tol": grad_bad,
           "solvers": {}}
    if abs(float(lk) - float(ls)) > atol + rtol * abs(float(ls)) \
            or grad_bad:
        raise AssertionError(f"[34f] first loss {float(lk)} / {float(ls)}, "
                             f"{grad_bad} gradient elements outside "
                             f"{(atol, rtol)}")
    for name, iters in (("LBFGS", LBFGS_ITERS),
                        ("ConjugateGradient", CG_ITERS),
                        ("LineGradientDescent", GD_ITERS)):
        for route, uk in (("kernel", True), ("stock", False)):
            solver = getattr(legacy, name)(max_iterations=iters)
            n = net(uk)
            impls.matmul_bias_act.launches = 0
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.monotonic()
            final = solver.optimize(n, ds)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3
            h = solver.history
            row = {"iterations": len(h) - 1, "loss_first": h[0],
                   "loss_final": final,
                   "ms_per_iteration": ms / max(len(h) - 1, 1),
                   "row1_launches": impls.matmul_bias_act.launches}
            if any(b > a for a, b in zip(h, h[1:])) or not final < h[0]:
                raise AssertionError(f"[34f] {name} on the {route} route: "
                                     f"the loss rose or did not fall: {h}")
            if uk and row["row1_launches"] == 0 and dev.type == "cuda":
                raise AssertionError(f"[34f] {name}: row 1 never launched")
            out["solvers"].setdefault(name, {})[route] = row
    return out


def profiler_checks(torch, dev, tmp) -> dict:
    """(g): the NaN panic on a planted NaN (LeNet, kernel route),
    ProfilerListener's step times, a trace file."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.profiler import (
        OpProfiler,
        ProfilerConfig,
        ProfilerListener,
    )

    rng = np.random.default_rng(SEED)
    x = rng.random((64, 28, 28, 1), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    net = cs._lenet_net(torch, dev, True)
    prof = OpProfiler.get_instance()
    listener = ProfilerListener(warmup_iterations=1)
    net.set_listeners(listener)
    out = {}
    try:
        prof.set_config(ProfilerConfig(check_for_nan=True))
        for _ in range(5):
            net.fit_batch(DataSet(x, y))
        net.set_listeners()
        bad = x.copy()
        bad[0, 0, 0, 0] = np.nan
        try:
            net.fit_batch(DataSet(bad, y))
            raise AssertionError("[34g] the NaN panic did not raise")
        except (RuntimeError, FloatingPointError) as e:
            out["panic"] = f"{type(e).__name__}: {str(e)[:100]}"
        prof.reset()
        with prof.trace(os.path.join(tmp, "trace")) as d:
            net.fit_batch(DataSet(x, y))
        path = os.path.join(d, "trace.json")
        out["trace_mb"] = os.path.getsize(path) / 2 ** 20
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out["trace_device_events"] = sum(
            1 for e in events if e.get("cat") == "kernel")
    finally:
        prof.reset()
        net.set_listeners()
    out["profiler_listener"] = listener.summary()
    out["step_times_ms"] = [t * 1e3 for t in listener.step_times]
    if len(listener.step_times) < 3:
        raise AssertionError("[34g] ProfilerListener recorded "
                             f"{len(listener.step_times)} steps")
    return out


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def _check(cond, msg, failures):
    if not cond:
        failures.append(msg)
        _log(f"[34] FAILED: {msg}")


def session_phase(torch, dev, smi, parts="abcdefg", cfg=None) -> dict:
    """[34]: returns the ``{"session": ...}`` line. ``cfg`` shrinks it for
    a rehearsal on the CPU (``device``, ``model``, ``batch``,
    ``backend``)."""
    import logging
    import tempfile

    from deeplearning4j_tpu_torch.parallel import spawn

    cfg = {"device": dev.type, "model": dict(RESNET), "batch": BATCH,
           "backend": "nccl" if dev.type == "cuda" else "gloo",
           **(cfg or {})}
    line = {"card": smi}
    failures = []
    t_start = time.monotonic()
    if "a" in parts:
        t0 = time.monotonic()
        line["special_values"] = special_values(torch, dev)
        sv = line["special_values"]
        _log(f"[34a] rows 1, 2, 6-8 keep the plain versions' NaN and inf "
             f"pattern on 0x7fffffff, 0xffffffff, 0x7fc00000, +-inf, 3.4e38, "
             f"FLT_MAX; row 1 keeps the CUDA NaN in "
             f"{sv['cuda_nan_rows_kept']} of {sv['cuda_nan_row_width']} "
             f"outputs ({time.monotonic() - t0:.1f} s) [{smi}]")
    with tempfile.TemporaryDirectory(prefix="dl4j_session_") as tmp:
        cfg.update(dir=os.path.join(tmp, "session"),
                   dead_dir=os.path.join(tmp, "dead"),
                   pod_dir=os.path.join(tmp, "pod"))
        if parts.strip("afg"):
            _session_runs(torch, dev, smi, cfg, line, failures, spawn,
                          logging)
        if "f" in parts:
            t0 = time.monotonic()
            line["legacy"] = legacy_solvers(torch, dev, smi)
            lg = line["legacy"]
            rows = "; ".join(
                f"{name} " + ", ".join(
                    f"{route} {r['loss_first']:.4f} -> {r['loss_final']:.4f}"
                    f" in {r['iterations']} it, {r['ms_per_iteration']:.1f} "
                    f"ms/it" for route, r in v.items())
                for name, v in lg["solvers"].items())
            _log(f"[34f] LeNet full batch {LENET_N}: first loss kernel "
                 f"{lg['loss_kernel']:.6f} / stock {lg['loss_stock']:.6f}, "
                 f"gradient max |err| {lg['grad_max_abs_err']:.3e}; {rows} "
                 f"({time.monotonic() - t0:.1f} s) [{smi}]")
        if "g" in parts:
            line["profiler"] = profiler_checks(torch, dev, tmp)
            pg = line["profiler"]
            _log(f"[34g] NaN panic: {pg['panic']}; {pg['profiler_listener']}"
                 f"; trace {pg['trace_mb']:.2f} MiB with "
                 f"{pg['trace_device_events']} device kernels [{smi}]")
    line["seconds"] = time.monotonic() - t_start
    _log(f"[34] total {line['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"[34] {len(failures)} gate(s) failed: "
                             + "; ".join(failures))
    return line


def _session_runs(torch, dev, smi, cfg, line, failures, spawn, logging):
    """(b)-(e): the ranks, their gates and their lines."""
    from deeplearning4j_tpu_torch.resilience import TrainingSession
    from deeplearning4j_tpu_torch.resilience import pod as pod_mod

    t0 = time.monotonic()
    (a,) = spawn(session_rank, 1, (cfg,), backend=cfg["backend"],
                 device=cfg["device"], timeout=TIMEOUT)
    (b,) = spawn(resume_rank, 1, (cfg,), backend=cfg["backend"],
                 device=cfg["device"], timeout=TIMEOUT)
    ses = a["session"]
    _check(ses["same_bits"] and ses["restarts"] == 1 and ses["fired"] == 1
           and ses["iteration"] == STEPS,
           f"[34b] the resumed session: {ses}", failures)
    _check(b["digest"] == a["reference_digest"] and b["iteration"] == STEPS
           and b["resumed_at"] == KILL_AT - 1,
           f"[34b] the fresh process: {b}", failures)
    _check(a["row2_launches_per_step"] == (36 if cfg["device"] == "cuda"
                                           else 0),
           f"[34b] row 2 launches a step {a['row2_launches_per_step']}",
           failures)
    line["session"] = {"rank": {k: v for k, v in a.items()
                                if k not in ("endpoints",)},
                       "fresh_process": b}
    _log(f"[34b] TrainingSession(ParallelWrapper exact, {cfg['backend']} x1),"
         f" {STEPS} steps at batch {cfg['batch']}, killed at train.step call "
         f"{KILL_AT}: resumed bit-identical {ses['same_bits']}; a fresh "
         f"process resumed at iteration {b['resumed_at']} bit-identical "
         f"{b['digest'] == a['reference_digest']}; snapshot ms "
         f"{[round(v, 1) for v in ses['snapshot_ms']]} of "
         f"{ses['snapshot_mb']:.1f} MiB, resume ms "
         f"{[round(v, 1) for v in ses['resume_ms']]} (fresh process "
         f"{b['resume_ms']:.1f}); row 2 launches a step "
         f"{a['row2_launches_per_step']:.0f} [{smi}]")
    # (e)
    ep = a["endpoints"]
    iters = sorted(r["iteration"] for r in ep["records"])
    resumes = sum(v for k, v in ep["health"]["resilience"]["counters"].items()
                  if k.startswith("dl4j_resumes_total"))
    _check(all(ep["status"][p] == 200 for p in ENDPOINTS)
           and ep["status"]["/sharding"] == 501
           and "sharding/plan.py" in ep["sharding"]["waits_for"],
           f"[34e] endpoint status {ep['status']}", failures)
    _check(iters == list(range(0, STEPS, STATS_FREQ)),
           f"[34e] records at iterations {iters}", failures)
    _check(resumes >= 1 and a["router_dropped"] == 0,
           f"[34e] /health resumes {resumes}, router dropped "
           f"{a['router_dropped']}", failures)
    line["ui"] = {"status": ep["status"], "record_iterations": iters,
                  "resumes_total": resumes, "listener": a["listener"],
                  "health_status": ep["health"]["status"]}
    _log(f"[34e] UIServer on 127.0.0.1: {ep['status']}; records at "
         f"iterations {iters}; /health strict JSON, dl4j_resumes_total "
         f"{resumes}; StatsListener(frequency={STATS_FREQ}) adds "
         f"{a['listener']['added_ms_per_step']:.2f} ms a step "
         f"({a['listener']['step_ms']}) [{smi}]")
    # (c)
    out = spawn(pod_rank, 2, (cfg,), backend="gloo", device=cfg["device"],
                timeout=TIMEOUT)
    for r, res in enumerate(out):
        _check(res["same_bits"] and res["restarts"] == 1
               and res["iteration"] == POD_STEPS,
               f"[34c] rank {r}: {res}", failures)
    h = out[0]["health"]
    host_resumes = h["resilience"]["counters"].get(
        'dl4j_resumes_total{scope="host"}', 0)
    _check(out[0]["health_status"] == 200 and "pod" in h["resilience"]
           and host_resumes >= 1,
           f"[34c] /health after the pod session: resilience "
           f"{h['resilience']}", failures)
    # a restore at one rank (pod shape 2 -> 1) equals the gathered params
    snaps = out[0]["snapshots"]
    newest = os.path.join(cfg["pod_dir"], snaps[-1])
    t1 = time.monotonic()
    net, _ = pod_mod.restore_pod_snapshot(newest, pod_mod.PodConfig(
        n_hosts=1), device=dev)
    restore_ms = (time.monotonic() - t1) * 1e3
    same_21 = _digest(net.params) == out[0]["params_digest"]
    del net
    _check(same_21, "[34c] the restore at one rank differs from the "
                    "gathered params", failures)
    # a corrupted shard is passed over with its named reason
    shard = os.path.join(newest, pod_mod.shard_name(1))
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        f.write(b"\x00corrupt\x00")
    reasons = []

    class _Catch(logging.Handler):
        def emit(self, record):
            reasons.append(record.getMessage())

    log = logging.getLogger("deeplearning4j_tpu_torch.resilience.session")
    handler = _Catch(level=logging.WARNING)
    log.addHandler(handler)
    try:
        fallback = TrainingSession(None, cfg["pod_dir"], pod=1,
                                   device=dev).resume()
    finally:
        log.removeHandler(handler)
    fell_back_to = fallback.iteration
    del fallback
    _check(any("shard digest mismatch" in m for m in reasons)
           and fell_back_to < POD_STEPS,
           f"[34c] the corrupted shard: reasons {reasons}, restored "
           f"iteration {fell_back_to}", failures)
    line["pod"] = {"ranks": [{k: v for k, v in res.items()
                              if k not in ("health", "guards")}
                             for res in out],
                   "restore_2_to_1_same_bits": same_21,
                   "restore_2_to_1_ms": restore_ms,
                   "corrupt_shard_reason": reasons,
                   "fell_back_to_iteration": fell_back_to,
                   "health_pod": h["resilience"].get("pod")}
    _log(f"[34c] two gloo ranks on {cfg['device']}, ZeRO, pod snapshots of "
         f"2 shards, host 1 dead at heartbeat {HEARTBEAT_KILL}: resumed "
         f"bit-identical {[r['same_bits'] for r in out]}; snapshot ms "
         f"{[round(v, 1) for v in out[0]['snapshot_ms']]}, resume ms "
         f"{[round(v, 1) for v in out[0]['resume_ms']]}; restore 2 -> 1 "
         f"bitwise {same_21} in {restore_ms:.1f} ms; a corrupted shard "
         f"passed over ({reasons[:1]}), fell back to iteration "
         f"{fell_back_to}; /health pod block hosts "
         f"{h['resilience']['pod']['hosts']} [{smi}]")
    # (d)
    guards = {f"{cfg['backend']}_x1": a["guards"], "gloo_x2": [
        res["guards"] for res in out]}
    for where, sets in (("x1", [a["guards"]]), ("x2", guards["gloo_x2"])):
        for r, g in enumerate(sets):
            for mode in ("exact", "zero"):
                res = g[mode]
                _check(res["skip_same_bits"] and res["next_step_moved"]
                       and res["skipped_steps"] == 1
                       and res["warn_nonfinite_steps"] >= 1,
                       f"[34d] {where} rank {r} {mode}: {res}", failures)
    timing = a["guards"].get("timing")
    if timing is not None:
        _check(timing["syncs_per_step"]["skip_step"] == 0,
               f"[34d] synchronizing calls a step under SKIP_STEP "
               f"{timing['syncs_per_step']}", failures)
    line["guards"] = guards
    _log(f"[34d] SKIP_STEP with a NaN in one rank's rows at step "
         f"{POISON_STEP}, exact and ZeRO, {cfg['backend']} x1 and gloo x2: "
         f"every rank's trees the step before's bit for bit, step "
         f"{POISON_STEP + 1} moved; WARN counted it; "
         + (f"synchronizing calls a step {timing['syncs_per_step']}, guard "
            f"{timing['guard_ms_per_step']:.2f} ms a step "
            f"({timing['step_ms']})" if timing else "no timing on the CPU")
         + f" ({time.monotonic() - t0:.1f} s for (b)-(e)) [{smi}]")


def main() -> int:
    """The build and [34] alone (or the parts ``--only`` names)."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="abcdefg",
                    help="the parts of [34] to run, as letters")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    _log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    _log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
         f"{time.monotonic() - t0:.1f} s")
    serve_full_f32()
    line = session_phase(torch, dev, smi, parts=args.only)
    _log(json.dumps({"session": line}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
