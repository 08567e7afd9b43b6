#!/usr/bin/env python3
"""Phase [35] of ``chip_smoke.py``: staged and data-parallel training
completed, on one H100.

- [35a] Full-width ResNet-50 (``fused_conv_bn``, ``use_kernels``, Adam,
  batch 32 of 224x224x3 float32: 19.3 MB a batch) trains ``RING_STEPS``
  steps through ``fit`` from a host ``ListDataSetIterator`` fed by a
  depth-2 ``DeviceRingIterator``, and through ``fit(fused_steps=2)`` (a
  K-stacking ring), each against ``fit`` on batches placed on the card
  beforehand, bit for bit (cuDNN's deterministic algorithms), and so
  does ``AsyncDataSetIterator(device_put=True)`` (the worker thread
  stages); 36
  ``matmul_stats`` launches a step over each run. Reported: step ms from
  pre-placed batches, through the ring and from the host without it; the
  ring's host-to-device copy ms (pinned, copy stream) and host staging ms
  a batch; from ``torch.profiler`` over each run, the copies' overlap with
  the step's kernels and the idle share; peak memory. Step ms from the
  ring, ``fused_steps=2`` and the host without the ring in alternating
  turns. Held: batches of ``POOL_SHAPES`` shapes through one stager grow
  the page-locked pool by at most ``POOL_BOUND`` largest batches.
- [35b] ``ingest.device_put`` armed once: the retry stages the batch and
  the params keep the same bits; armed past ``INGEST_RETRY``'s attempts:
  ``fit`` raises. A ``TrainingSession`` over the ring killed at
  ``train.step`` call ``KILL_AT`` resumes to the same bits, and the
  resume's fast-forward stages none of the batches it skips (the ring's
  staged count).
- [35c] ``ParallelWrapper`` with truncated BPTT: the full-width
  ``TextGenerationLSTM`` (``LSTM(256)`` x 2, 47 characters), tBPTT 50/50,
  batch 32 at T 200, as [27]. The exact mode at one NCCL rank the same
  bits as ``fit_batch``; two gloo ranks sharing ``cuda:0`` (16 rows each):
  exact against ``fit_batch`` at 32 rows at [27]'s gates, back 25 < fwd
  50 at T 230 the same way, the threshold mode (fixed and adaptive tau)
  and averaging run and report their losses, and the planted control
  (each rank's own gradients, no exchange) must miss the gates. This path
  runs no kernel.
- [35d] An MoE net in the exact mode without ``expert_parallel``: [32]'s
  GPT-2-small-width 8-expert LM (top-2, capacity 1.25) at full depth, one
  NCCL rank, the same bits as ``fit_batch`` with rows 6-8 launched 12
  times a step each; two gloo ranks at 2 layers (4 rows each) against
  one-rank ``fit_batch`` on the 8 rows: the loss and the updates at [7]'s
  step-1 limits, the routing flips gated as [32] gates them, and no
  capacity decision differs where no flip reached; the control (each rank
  routes its own tokens alone: its own capacity, queue and aux loss) must
  miss. Reported: both updates' distance from the float64 one-rank
  update, a rank's warm step ms and expert-buffer rows against one rank
  on all rows.
- [35e] ``InferenceEngine(ParallelInference(resnet50))`` with two
  replicas on ``cuda:0``: the bucket ladder aligned to the 2 workers,
  every launch's rows a multiple of 2, answers against ``output``, row 1
  36 times a replica's forward; AlexNet's ``calibrate`` under enabled
  telemetry records one ``quant_calibrate`` span a batch, and the int8
  forward launches row 4 twice.
- [35f] The paths only the CPU had run: ``TextGenerationLSTM`` under
  ``compute_dtype="bfloat16"`` (its segment losses and params held by the
  bf16 rule against the card's float32 run, the port's CPU bf16 run the
  yardstick); UNet (``CnnLossLayer``, per-pixel ``LossBinaryXENT``) and
  YOLO2 (the YOLOv2 loss) at their zoo sizes, ``ZOO_TRAIN_STEPS`` SGD
  steps through ``fit`` on both routes (step 1 at [7]'s gates or, where
  float32 itself strays farther, by the float64 rule of ``grad_rule``,
  which a planted fault and the TF32 control must fail; row 1's
  launches counted against ``routed_sites``); Xception and NASNet one
  training step a route: ms, peak memory and the depthwise convolutions'
  share of device time.

``python3 chip_ingest.py`` builds the kernels and runs [35] alone
(``--only abcdef`` picks parts, ``--only ""`` none); ``--spread N`` first
reads YOLO2's step-1 gradient distances from float64 at N seeds (the
float64 rule's readings); ``--ab TREE`` first times ``fit(fused_steps=2)``
and the host feed in TREE (an unpacked parent commit) and here, one
process each: TREE, here, here, TREE.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import tempfile
import time

import numpy as np

import chip_moe
import chip_sequence
import chip_session
import chip_smoke as cs

SEED = 35
RESNET = {}       # ResNet50's arguments (full width: 224x224x3, 1000 classes)
ALEXNET = {}      # AlexNet's arguments (full width)
ZOO_ARGS = {"UNet": {}, "YOLO2": {}, "Xception": {}, "NASNet": {}}
RING_STEPS = 4  # the script's time limit bounds the depth
RING_BATCH = 32
FUSED_K = 2
TIMING_TURNS = 1  # turns of the four feeds' timed fits (the time limit)
POOL_SHAPES = 40  # batch shapes staged through one stager
# the page-locked pool's growth over them, in largest batches: the caching
# host allocator's power-of-two size classes (2.03 read on an H100)
POOL_BOUND = 4.0
KILL_AT = 4       # the train.step call the session is killed at
SNAP_EVERY = 3
FAULT_CALL = 3    # the ingest.device_put call that fails once
TIMEOUT = 900.0
TBPTT_LOSS_RTOL = chip_sequence.TEXT_LOSS_RTOL
TBPTT_STATE_RTOL = chip_sequence.TEXT_STATE_RTOL
TEXT_ZOO = {}     # TextGenerationLSTM's arguments (full width: 47 chars)
TEXT_BATCH = chip_sequence.TEXT_BATCH
TEXT_T = chip_sequence.TEXT_T
TEXT_SEG = chip_sequence.TEXT_SEG
TEXT_BACK = chip_sequence.TEXT_BACK
TEXT_T_RAGGED = chip_sequence.TEXT_T_RAGGED
TEXT_FITS = chip_sequence.TEXT_FITS
MOE_GLOO_LAYERS = 2
MOE_GLOO_BATCH = 8
MOE_TIMED_STEPS = 3
MOE_LR = 0.1
PI_WORKERS = 2
PI_MAX_BATCH = 8
PI_SIZES = (1, 3, 5, 8)
PI_RTOL = 1e-4    # the served (BN-folded) copy against output, relative L2
CAL_BATCHES = 2
BF16_FITS = 1
ZOO_TRAIN = {"UNet": 8, "YOLO2": 8}  # batch a step
ZOO_TRAIN_STEPS = 3
DW_BATCH = 8      # Xception / NASNet


def _log(msg: str) -> None:
    cs.log(msg)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _check(cond, msg, failures) -> None:
    if not cond:
        failures.append(msg)
        _log(f"[35] FAILED: {msg}")


# --------------------------------------------------------------------------
# [35a] ResNet-50 from the ring
# --------------------------------------------------------------------------

def _resnet_batches(torch, zoo, dev=None):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    out = []
    for t in range(RING_STEPS):
        ds = cs._synthetic_batch(zoo, RING_BATCH, SEED + t)
        if dev is not None:
            ds = DataSet(torch.as_tensor(ds.features, device=dev),
                         torch.as_tensor(ds.labels, device=dev))
        out.append(ds)
    return out


def _intervals(torch, prof):
    """(copies, kernels) of a profile's device events, in µs: host-to-
    device copies and every other device event."""
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if span[1] > span[0]:
            (copies if "HtoD" in e.name else kernels).append(span)
    return copies, kernels


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(copies, kernels) -> float:
    """µs of host-to-device copy time during which a kernel ran."""
    busy = _union(kernels)
    total = 0.0
    for a, b in copies:
        for c, d in busy:
            if d <= a:
                continue
            if c >= b:
                break
            total += min(b, d) - max(a, c)
    return total


def _profiled_fit(torch, net, make_iter, fused=None) -> dict:
    """One ``fit`` under ``torch.profiler``: wall ms a step, the device's
    busy ms and idle share over the run, host-to-device copies (count, ms)
    and the ms of them that overlapped a kernel."""
    from torch.profiler import ProfilerActivity, profile

    it = make_iter()
    _sync(torch)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        net.fit(it, fused_steps=fused)
        _sync(torch)
        wall = (time.monotonic() - t0) * 1e3
    copies, kernels = _intervals(torch, prof)
    busy = sum(b - a for a, b in _union(copies + kernels)) / 1e3
    copy_ms = sum(b - a for a, b in copies) / 1e3
    over = _overlap(copies, kernels) / 1e3
    return {"wall_ms_per_step": wall / RING_STEPS,
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "h2d_copies": len(copies), "h2d_ms": copy_ms,
            "h2d_overlapped_ms": over,
            "h2d_overlap_share": over / copy_ms if copy_ms else 0.0}


def _timed_fit(torch, net, make_iter, fused=None) -> float:
    """ms a step of one ``fit`` over ``make_iter()`` (``RING_STEPS``
    steps, synchronized before and after)."""
    it = make_iter()
    _sync(torch)
    t0 = time.monotonic()
    net.fit(it, fused_steps=fused)
    _sync(torch)
    return (time.monotonic() - t0) * 1e3 / RING_STEPS


def _step_times(torch, net, variants) -> dict:
    """{variant: median ms a step} over ``TIMING_TURNS`` turns, the
    variants in alternating order (host timings drift over a process)."""
    times = {name: [] for name in variants}
    names = list(variants)
    for i in range(TIMING_TURNS):
        for name in (names if i % 2 == 0 else names[::-1]):
            make, fused = variants[name]
            times[name].append(_timed_fit(torch, net, make, fused))
    return {name: float(np.median(v)) for name, v in times.items()}


def _pinned_pool(torch, dev) -> dict:
    """Batches of ``POOL_SHAPES`` sizes (``[n, 3, 64, 64]`` float32, n =
    1..POOL_SHAPES) through one stager, each copy landed before the next:
    the caching host allocator's page-locked bytes (``allocated_bytes``:
    active and cached blocks) grown over them, against the largest
    batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.prefetch import _Stager

    def pool():
        return torch.cuda.host_memory_stats().get(
            "allocated_bytes.current", 0)

    stager = _Stager(dev)
    before = pool()
    largest = 0
    for n in range(1, POOL_SHAPES + 1):
        ds = DataSet(np.ones((n, 3, 64, 64), np.float32),
                     np.ones((n, 10), np.float32))
        largest = max(largest, ds.features.nbytes + ds.labels.nbytes)
        stager.stage(ds)
        stager.wait()
    grown = pool() - before
    return {"shapes": POOL_SHAPES, "largest_batch_bytes": largest,
            "pool_grown_bytes": grown, "of_largest": grown / largest}


def _host_staging_ms(torch, dev, batches) -> float:
    """Median host ms to stage one batch (the copy into page-locked
    memory and the copies' issue), over distinct batches."""
    from deeplearning4j_tpu_torch.datasets.prefetch import _Stager

    stager = _Stager(dev)
    stager.stage(batches[0])
    stager.wait()
    times = []
    for ds in batches[1:]:
        t0 = time.monotonic()
        stager.stage(ds)
        times.append((time.monotonic() - t0) * 1e3)
        stager.wait()
    return float(np.median(times))


def _ab_child() -> dict:
    """One process of :func:`fused_ab`, in whichever checkout supplies
    the package: ResNet-50 as [35a] builds it, ms a step of ``fit(
    fused_steps=2)`` and of ``fit`` from the host batches, alternating."""
    import torch

    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import build, impls

    dev = torch.device("cuda", 0)
    build.build_all(impls.SOURCES)
    chip_session._deterministic(torch)
    zoo, base = chip_session._resnet(torch, dev, {"model": RESNET})
    host = _resnet_batches(torch, zoo)
    net = chip_session._fresh(base)
    net.fit(ListDataSetIterator(host[:2]))  # warm the allocator
    return _step_times(torch, net, {
        "fused2": (lambda: ListDataSetIterator(host), FUSED_K),
        "host": (lambda: ListDataSetIterator(host), None)})


def fused_ab(tree, smi) -> dict:
    """``--ab TREE``: :func:`_ab_child` in TREE (the parent's checkout,
    its package and chip scripts, this file's code), here, here and in
    TREE again, one process each (the kernels' builds copied to TREE)."""
    import os
    import shutil
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(tree)
    shutil.copytree(os.path.join(here, "deeplearning4j_tpu_torch", "_build"),
                    os.path.join(tree, "deeplearning4j_tpu_torch", "_build"),
                    dirs_exist_ok=True)
    code = ("import runpy, sys; sys.argv = ['chip_ingest.py', "
            f"'--ab-child']; runpy.run_path({os.path.abspath(__file__)!r}, "
            "run_name='__main__')")
    runs = []
    for label, cwd in (("parent", tree), ("change", here), ("change", here),
                       ("parent", tree)):
        p = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                           capture_output=True, text=True, timeout=TIMEOUT)
        got = [ln for ln in p.stdout.splitlines()
               if ln.startswith("AB_RESULT ")]
        if p.returncode or not got:
            raise RuntimeError(f"the A/B process in {cwd} failed: "
                               f"{p.stderr[-3000:]}")
        runs.append({"tree": label, **json.loads(got[-1][len("AB_RESULT "):])})
        _log(f"[35a A/B] {json.dumps(runs[-1])} [{smi}]")
    out = {"card": smi, "runs": runs}
    for label in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == label]
        out[label] = {k: float(np.mean([r[k] for r in mine]))
                      for k in ("fused2", "host")}
    _log(f"[35a A/B] fit(fused_steps={FUSED_K}) ms a step: parent "
         f"{out['parent']['fused2']:.2f} (host feed {out['parent']['host']:.2f})"
         f", change {out['change']['fused2']:.2f} (host feed "
         f"{out['change']['host']:.2f}) [{smi}]")
    return out


def ring_resnet(torch, dev, smi, line, failures) -> dict:
    """[35a] (see the module docstring). Returns the runs' state for
    [35b]."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.prefetch import (
        AsyncDataSetIterator,
        DeviceRingIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls

    chip_session._deterministic(torch)
    zoo, base = chip_session._resnet(torch, dev, {"model": RESNET})
    host = _resnet_batches(torch, zoo)
    placed = _resnet_batches(torch, zoo, dev)
    fresh = chip_session._fresh
    digest = chip_session._trees_digest

    def ring():
        return DeviceRingIterator(ListDataSetIterator(host), device=dev)

    out = {"card": smi, "batch": RING_BATCH, "steps": RING_STEPS,
           "batch_mb": host[0].features.nbytes / 1e6}
    # the reference: batches placed on the card beforehand
    ref = fresh(base)
    torch.cuda.reset_peak_memory_stats()
    ref.fit(ListDataSetIterator(placed))
    _sync(torch)
    want = digest(ref)
    out["peak_mib_placed"] = torch.cuda.max_memory_allocated() / 2 ** 20
    del ref
    # ---- the main path: the ring at K = 1, then K = 2 ----
    runs = {}
    def staged_by_worker():
        return AsyncDataSetIterator(ListDataSetIterator(host), queue_size=2,
                                    device_put=True, device=dev)

    for name, make, fused in (("ring", ring, None),
                              ("fused2", lambda: ListDataSetIterator(host),
                               FUSED_K),
                              ("async_device_put", staged_by_worker, None)):
        net = fresh(base)
        impls.matmul_stats.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        net.fit(make(), fused_steps=fused)
        _sync(torch)
        runs[name] = {"ms_per_step": (time.monotonic() - t0) * 1e3
                      / RING_STEPS,
                      "launches": impls.matmul_stats.launches,
                      "same_bits": digest(net) == want,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
        _check(runs[name]["same_bits"], f"[35a] {name}: not the pre-placed "
               "run's bits", failures)
        _check(runs[name]["launches"] == 36 * RING_STEPS,
               f"[35a] {name}: {runs[name]['launches']} matmul_stats "
               f"launches, expected {36 * RING_STEPS}", failures)
        del net
    # ---- end of the main path ----
    out["runs"] = runs
    # timings: pre-placed, ring, fused ring, host without the ring
    net = fresh(base)
    net.fit(ListDataSetIterator(placed[:2]))  # warm the allocator
    out["step_ms"] = _step_times(torch, net, {
        "placed": (lambda: ListDataSetIterator(placed), None),
        "ring": (ring, None),
        "fused2": (lambda: ListDataSetIterator(host), FUSED_K),
        "host_no_ring": (lambda: ListDataSetIterator(host), None)})
    out["profile"] = {
        "ring": _profiled_fit(torch, net, ring),
        "fused2": _profiled_fit(torch, net,
                                lambda: ListDataSetIterator(host), FUSED_K),
        "host_no_ring": _profiled_fit(torch, net,
                                      lambda: ListDataSetIterator(host))}
    out["peak_mib_ring"] = runs["ring"]["peak_mib"]
    del net
    p = out["profile"]
    nbytes = sum(ds.features.nbytes + ds.labels.nbytes for ds in host)
    out["staging"] = {
        "host_ms": _host_staging_ms(torch, dev, host),
        "copy_ms": p["ring"]["h2d_ms"] / RING_STEPS,
        "gb_per_s": (nbytes / p["ring"]["h2d_ms"] / 1e6
                     if p["ring"]["h2d_ms"] else 0.0)}
    out["pinned_pool"] = _pinned_pool(torch, dev)
    _check(out["pinned_pool"]["of_largest"] <= POOL_BOUND,
           f"[35a] the page-locked pool grew {out['pinned_pool']}", failures)
    sm = out["step_ms"]
    _log(f"[35a] ResNet-50 fused_conv_bn, batch {RING_BATCH} "
         f"({out['batch_mb']:.1f} MB a batch), {RING_STEPS} steps: the ring "
         f"and fused_steps={FUSED_K} (and the worker thread's staging) the "
         f"pre-placed bits: {runs['ring']['same_bits']} / "
         f"{runs['fused2']['same_bits']} / "
         f"{runs['async_device_put']['same_bits']}; "
         f"matmul_stats {runs['ring']['launches']} / "
         f"{runs['fused2']['launches']} launches; step ms (median of "
         f"{TIMING_TURNS} alternating turns) placed {sm['placed']:.2f}, ring "
         f"{sm['ring']:.2f}, fused2 {sm['fused2']:.2f}, host without the "
         f"ring {sm['host_no_ring']:.2f} (the first runs: ring "
         f"{runs['ring']['ms_per_step']:.2f}, fused2 "
         f"{runs['fused2']['ms_per_step']:.2f}) [{smi}]")
    _log(f"[35a] staging a batch: copy {out['staging']['copy_ms']:.3f} ms "
         f"device ({out['staging']['gb_per_s']:.1f} GB/s), host "
         f"{out['staging']['host_ms']:.3f} ms; profiled: ring "
         f"{p['ring']['h2d_copies']} copies, {p['ring']['h2d_ms']:.2f} ms, "
         f"{p['ring']['h2d_overlap_share']:.2%} under kernels, idle "
         f"{p['ring']['idle_share']:.2%}; fused2 "
         f"{p['fused2']['h2d_copies']} copies, "
         f"{p['fused2']['h2d_overlap_share']:.2%} under kernels, idle "
         f"{p['fused2']['idle_share']:.2%}; host without the ring "
         f"{p['host_no_ring']['h2d_overlap_share']:.2%} under kernels, idle "
         f"{p['host_no_ring']['idle_share']:.2%}; peak MiB ring "
         f"{out['peak_mib_ring']:.0f}, placed {out['peak_mib_placed']:.0f}"
         f"; page-locked pool grown {out['pinned_pool']['pool_grown_bytes']}"
         f" B over {POOL_SHAPES} batch shapes "
         f"({out['pinned_pool']['of_largest']:.2f}x the largest batch)")
    return {"zoo": zoo, "base": base, "host": host, "want": want,
            "line": out}


# --------------------------------------------------------------------------
# [35b] the fault site and the session's resume
# --------------------------------------------------------------------------

def ring_faults(torch, dev, smi, state, failures) -> dict:
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.prefetch import DeviceRingIterator
    from deeplearning4j_tpu_torch.resilience import (
        FaultPlan,
        InjectedFault,
        TrainingSession,
    )
    from deeplearning4j_tpu_torch.telemetry import REGISTRY

    base, host, want = state["base"], state["host"], state["want"]
    fresh, digest = chip_session._fresh, chip_session._trees_digest
    key = 'dl4j_retries_total{op="ingest.device_put"}'
    out = {"card": smi}

    def retries():
        return REGISTRY.snapshot(run_collectors=False).get(key, 0.0)

    net = fresh(base)
    before = retries()
    plan = FaultPlan().inject("ingest.device_put", on_calls=[FAULT_CALL])
    with plan.armed():
        net.fit(DeviceRingIterator(ListDataSetIterator(host), device=dev))
    _sync(torch)
    out["once"] = {"fired": plan.fired("ingest.device_put"),
                   "retries": retries() - before,
                   "same_bits": digest(net) == want}
    _check(out["once"] == {"fired": 1, "retries": 1.0, "same_bits": True},
           f"[35b] one staging fault: {out['once']}", failures)
    net = fresh(base)
    calls = [FAULT_CALL, FAULT_CALL + 1, FAULT_CALL + 2]
    raised = None
    with FaultPlan().inject("ingest.device_put", on_calls=calls).armed():
        try:
            net.fit(DeviceRingIterator(ListDataSetIterator(host), device=dev))
        except InjectedFault as e:
            raised = type(e).__name__
    out["past_retry"] = {"raised": raised, "iteration": net.iteration}
    _check(raised == "InjectedFault", f"[35b] past the retry: {raised}",
           failures)
    del net
    # the session over the ring, killed and resumed
    ring = DeviceRingIterator(ListDataSetIterator(host), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        sess = TrainingSession(fresh(base), tmp,
                               snapshot_every_n_iterations=SNAP_EVERY)
        t0 = time.monotonic()
        with FaultPlan(seed=1).inject("train.step",
                                      on_calls=[KILL_AT]).armed():
            sess.fit(ring, epochs=1)
        _sync(torch)
        seconds = time.monotonic() - t0
        same = digest(sess.model) == want
    # the killed pass staged its batches up to one past the killed step;
    # the resumed pass skips the steps of the newest snapshot unstaged
    skipped = (KILL_AT - 1) // SNAP_EVERY * SNAP_EVERY
    first = min(KILL_AT + 1, RING_STEPS)
    expect = first + RING_STEPS - skipped
    out["session"] = {"restarts": sess.restarts, "same_bits": same,
                      "staged": ring.staged_count, "expected": expect,
                      "skipped_unstaged": skipped, "seconds": seconds}
    _check(same and sess.restarts == 1 and ring.staged_count == expect,
           f"[35b] session over the ring: {out['session']}", failures)
    _log(f"[35b] one ingest.device_put fault: {out['once']}; past "
         f"INGEST_RETRY: {out['past_retry']}; session killed at step "
         f"{KILL_AT}: resumed {same and 'bit for bit' or 'OFF'}, "
         f"{ring.staged_count} batches staged ({first} before the kill, "
         f"{RING_STEPS - skipped} after; {skipped} skipped unstaged; "
         f"expected {expect}) in {seconds:.1f} s [{smi}]")
    return out


# --------------------------------------------------------------------------
# [35c] / [35d] the ranks
# --------------------------------------------------------------------------

def _text_conf(fwd, back):
    from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    return dataclasses.replace(
        TextGenerationLSTM(**TEXT_ZOO).conf(),
        backprop_type=BackpropType.TRUNCATED_BPTT, tbptt_fwd_length=fwd,
        tbptt_back_length=back)


def _text_batches(n, t, seed):
    """``n`` DataSets of ``TEXT_BATCH`` one-hot sequences of ``t``
    characters and their next characters ([27]'s Markov stream)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    vocab = TEXT_ZOO.get("total_unique_characters", 47)
    chars = chip_sequence.markov_text(n * TEXT_BATCH, t + 1, vocab, seed)
    out = []
    for i in range(n):
        c = chars[i * TEXT_BATCH:(i + 1) * TEXT_BATCH]
        out.append(DataSet(chip_sequence.one_hot(c[:, :-1], vocab),
                           chip_sequence.one_hot(c[:, 1:], vocab)))
    return out


def _text_net(conf, dev):
    """The network on ``dev`` with the configuration's seeded weights (drawn
    on the CPU: the same on every rank and device)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    seed = MultiLayerNetwork(conf, "cpu").init()
    return MultiLayerNetwork(conf, dev).set_params(seed.params, seed.state)


def _part(ds, rank, world):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import mesh

    lo, hi, _ = mesh.partition_rows(ds.features.shape[0], rank, world)
    return DataSet(ds.features[lo:hi], ds.labels[lo:hi])


def _seg_errors(a, b) -> float:
    a, b = (np.asarray(v.detach().float().cpu().numpy(), np.float64)
            for v in (a, b))
    return float((np.abs(a - b) / np.abs(b)).max())


def _tbptt_run(torch, dev, conf, batches, rank, world, wrapper_kw=None,
               exchange=True):
    """``ParallelWrapper`` (or, without ``exchange``, this rank's own
    ``fit_batch``: the control) over this rank's rows of ``batches``:
    (net, every batch's segment losses)."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = _text_net(conf, dev)
    segs = []
    if not exchange:
        for ds in batches:
            net.fit_batch(_part(ds, rank, world))
            segs.append(net.last_segment_losses)
        return net, segs
    pw = ParallelWrapper(net, prefetch_buffer=0, **(wrapper_kw or {}))
    for ds in batches:
        pw.fit(ListDataSetIterator([_part(ds, rank, world)]))
        segs.append(net.last_segment_losses)
    return net, segs


def _tbptt_ref(torch, dev, conf, batches):
    net = _text_net(conf, dev)
    segs = []
    for ds in batches:
        net.fit_batch(ds)
        segs.append(net.last_segment_losses)
    return net, segs


def _tbptt_compare(torch, got, ref) -> dict:
    (net, segs), (rnet, rsegs) = got, ref
    loss = max(_seg_errors(a, b) for a, b in zip(segs, rsegs))
    state = max(list(chip_sequence._tree_errors(net.params,
                                                rnet.params).values())
                + list(chip_sequence._tree_errors(net.opt_state,
                                                  rnet.opt_state).values()))
    bits = (all(torch.equal(a, b) for a, b in zip(segs, rsegs))
            and chip_session._digest(net.params, net.opt_state)
            == chip_session._digest(rnet.params, rnet.opt_state))
    return {"worst_segment_loss_rel": loss, "worst_state_rel_l2": state,
            "same_bits": bits, "iterations": [net.iteration, rnet.iteration],
            "passes": (loss <= TBPTT_LOSS_RTOL and state <= TBPTT_STATE_RTOL
                       and net.iteration == rnet.iteration)}


def tbptt_rank(torch, dev, rank, world) -> dict:
    """[35c] on this rank."""
    from deeplearning4j_tpu_torch.parallel import (
        AdaptiveThresholdAlgorithm,
        ThresholdAlgorithm,
        TrainingMode,
    )

    conf = _text_conf(TEXT_SEG, TEXT_SEG)
    batches = _text_batches(TEXT_FITS, TEXT_T, SEED)
    out = {}
    exact = _tbptt_run(torch, dev, conf, batches, rank, world)
    ref = _tbptt_ref(torch, dev, conf, batches) if rank == 0 else None
    if rank == 0:
        out["exact"] = _tbptt_compare(torch, exact, ref)
    if world == 1:
        return out
    del exact
    ctl = _tbptt_run(torch, dev, conf, batches, rank, world, exchange=False)
    if rank == 0:
        out["control"] = _tbptt_compare(torch, ctl, ref)
    del ctl, ref
    conf_c = _text_conf(TEXT_SEG, TEXT_BACK)
    batches_c = _text_batches(TEXT_FITS, TEXT_T_RAGGED, SEED + 1)
    back = _tbptt_run(torch, dev, conf_c, batches_c, rank, world)
    if rank == 0:
        out["back_lt_fwd"] = _tbptt_compare(
            torch, back, _tbptt_ref(torch, dev, conf_c, batches_c))
    del back
    for name, kw in (
            ("threshold_fixed",
             {"threshold_algorithm": ThresholdAlgorithm(1e-3)}),
            ("threshold_adaptive",
             {"threshold_algorithm": AdaptiveThresholdAlgorithm(1e-3)}),
            ("averaging", {"training_mode": TrainingMode.AVERAGING,
                           "averaging_frequency": 4})):
        t0 = time.monotonic()
        net, segs = _tbptt_run(torch, dev, conf, batches, rank, world, kw)
        _sync(torch)
        if rank == 0:
            out[name] = {"losses": [float(s.mean()) for s in segs],
                         "iteration": net.iteration,
                         "seconds": time.monotonic() - t0}
        del net
    return out


def _moe_conf(layers, seed=chip_moe.MOE_SEED):
    from deeplearning4j_tpu_torch.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    kw = dict(chip_moe.MOE_MODEL, n_layers=layers)
    return TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                              seed=seed, updater=Sgd(learning_rate=MOE_LR),
                              **kw).conf()


def _moe_full_bits(torch, dev) -> dict:
    """One NCCL rank: the exact-mode step of the full-depth LM against
    ``fit_batch``, and rows 6-8's launches over the wrapper's step."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    model = chip_moe.MOE_MODEL
    conf = _moe_conf(model["n_layers"])
    ds = cs.lm_dataset(torch, dev, model["vocab_size"], cs.LM_BATCH,
                       model["max_len"], cs.LM_SEED)
    net = ComputationGraph(conf, device=dev).init()
    p0 = {k: {p: v.detach().clone() for p, v in vp.items()}
          for k, vp in net.params.items()}
    s0 = {k: {p: v.detach().clone() for p, v in vp.items()}
          for k, vp in net.state.items()}
    pw = ParallelWrapper(net, prefetch_buffer=0)
    att.flash_attention.launches = 0
    att.flash_attention_bwd.dq_launches = 0
    att.flash_attention_bwd.dkv_launches = 0
    t0 = time.monotonic()
    pw.fit(DataSet(ds.features, ds.labels))
    _sync(torch)
    ms = (time.monotonic() - t0) * 1e3
    launches = {"flash_attention": att.flash_attention.launches,
                "flash_attention_bwd_dq": att.flash_attention_bwd.dq_launches,
                "flash_attention_bwd_dkv":
                    att.flash_attention_bwd.dkv_launches}
    got = (pw.score_value, chip_session._digest(net.params))
    del pw, net
    torch.cuda.empty_cache()
    ref = ComputationGraph(conf, device=dev).set_params(p0, s0)
    del p0, s0
    loss = ref.fit_batch(ds)
    _sync(torch)
    same = got == (loss, chip_session._digest(ref.params))
    del ref
    torch.cuda.empty_cache()
    return {"same_bits": same, "loss": got[0], "ref_loss": loss,
            "launches": launches, "step_ms": ms,
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}


def _kept_mismatch(torch, ra, rb, primary) -> list:
    """Per layer: the (token, expert) choices both routes made whose
    capacity decision (kept or dropped) differs, where no primary flip
    happened in any layer."""
    if any(primary):
        return [None] * len(ra)
    out = []
    for (pa, ka, keep_a), (pb, kb, keep_b) in zip(ra, rb):
        same = (ka == kb)
        out.append(int(((keep_a != keep_b) & same).sum()))
    return out


def _moe_gloo(torch, dev, rank, world, control: bool, memo: dict) -> dict:
    """Two gloo ranks, 2 layers: this rank's exact-mode step; rank 0 also
    the one-rank ``fit_batch`` on every row (once, kept in ``memo``) and
    the comparison. ``control``: each rank routes its own tokens alone."""
    from deeplearning4j_tpu_torch.comms import global_batch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    model = chip_moe.MOE_MODEL
    conf = _moe_conf(MOE_GLOO_LAYERS)
    full = cs.lm_dataset(torch, dev, model["vocab_size"], MOE_GLOO_BATCH,
                         model["max_len"], cs.LM_SEED)
    rows = MOE_GLOO_BATCH // world
    part = DataSet(full.features[rank * rows:(rank + 1) * rows],
                   full.labels[rank * rows:(rank + 1) * rows])
    net = ComputationGraph(conf, device=dev).init()
    p0 = {k: {p: v.detach().clone() for p, v in vp.items()}
          for k, vp in net.params.items()} if rank == 0 else None
    pw = ParallelWrapper(net, prefetch_buffer=0)
    real = global_batch.gather_rows
    if control:
        global_batch.gather_rows = lambda t: (t, 0)
    try:
        with chip_moe.record_routes() as ra:
            t0 = time.monotonic()
            pw.fit(part)
            _sync(torch)
            ms = (time.monotonic() - t0) * 1e3
    finally:
        global_batch.gather_rows = real
    out = {"loss": pw.score_value, "step_ms": ms,
           "digest": chip_session._digest(net.params)}
    if rank != 0:
        return out
    if "ref" not in memo:
        ref = ComputationGraph(conf, device=dev).init()
        s0 = {k: {p: v.detach().clone() for p, v in vp.items()}
              for k, vp in ref.state.items()}
        with chip_moe.record_routes() as rb:
            ref_loss = ref.fit_batch(full)
        _sync(torch)
        memo["ref"] = (ref, ref_loss, rb)
        memo["f64"] = _f64_update(torch, conf, dev, p0, s0, full)
    ref, ref_loss, rb = memo["ref"]
    n, total = ra[0][0].shape[0], rb[0][0].shape[0]
    if n != total:  # the control routed this rank's tokens alone
        rb = [tuple(t[:n] for t in entry) for entry in rb]
    diff = chip_moe.routing_diff(torch, ra, rb, MOE_GLOO_BATCH * n // total)
    num = den = 0.0
    worst = ("", 0.0)
    for k in ref.params:
        for p in ref.params[k]:
            a = (net.params[k][p] - p0[k][p]).double()
            b = (ref.params[k][p] - p0[k][p]).double()
            d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
            if p not in cs.LM_ZERO_GRADS:
                rel = (d2 / max(b2, 1e-300)) ** 0.5
                if rel > worst[1]:
                    worst = (f"{k}.{p}", rel)
            num, den = num + d2, den + b2
    kept = _kept_mismatch(torch, ra, rb, diff["primary"])
    lim = cs.TRAIN_GRAD_L2
    out["update_vs_f64"] = {
        "ranks": _update_dist(net.params, p0, memo["f64"]),
        "one_rank": _update_dist(ref.params, p0, memo["f64"])}
    out.update(ref_loss=ref_loss,
               loss_rel_err=abs(out["loss"] - ref_loss) / abs(ref_loss),
               update_global_l2=(num / den) ** 0.5, update_worst=worst,
               flips=diff["flips"], primary=diff["primary"],
               kept_mismatch=kept, dropped=diff["dropped"],
               routes=[len(ra), len(rb)])
    out["passes"] = bool(
        out["loss_rel_err"] <= cs.TRAIN_LOSS_RTOL[0]
        and out["update_global_l2"] <= lim["global"]
        and worst[1] <= lim["tensor"]
        and sum(diff["primary"]) <= chip_moe.MOE_MAX_PRIMARY_FLIPS
        and all(k in (None, 0) for k in kept)
        and len(ra) == len(rb) == MOE_GLOO_LAYERS)
    return out


def _f64_update(torch, conf, dev, p0, s0, ds) -> dict:
    """The one-rank ``fit_batch`` update of ``ds`` from ``p0`` / ``s0`` in
    float64 on the stock route: {layer: {param: update}}."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    c64 = dataclasses.replace(conf, dtype="float64", compute_dtype=None,
                              use_kernels=False)
    to64 = lambda t: {k: {p: v.double() for p, v in vp.items()}  # noqa
                      for k, vp in t.items()}
    n64 = ComputationGraph(c64, device=dev).set_params(to64(p0), to64(s0))
    n64.fit_batch(ds)
    return {k: {p: n64.params[k][p] - p0[k][p].double() for p in vp}
            for k, vp in p0.items()}


def _update_dist(params, p0, u64) -> float:
    """Global relative L2 of the update ``params - p0`` against ``u64``."""
    num = den = 0.0
    for k in u64:
        for p, b in u64[k].items():
            a = (params[k][p] - p0[k][p]).double()
            num += float(((a - b) ** 2).sum())
            den += float((b * b).sum())
    return (num / den) ** 0.5


def _moe_scaling(torch, dev, rank, world) -> dict:
    """[35d]'s cost at two gloo ranks: this rank's exact-mode step (warm,
    median of ``MOE_TIMED_STEPS``) and its expert buffers' rows a step
    (experts x capacity, summed over the layers); rank 0 also the one-rank
    ``fit_batch`` on every row. The ranks share ``cuda:0`` and run beside
    the parent's other parts: their ms are the shared card's."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, expert

    model = chip_moe.MOE_MODEL
    conf = _moe_conf(MOE_GLOO_LAYERS)
    full = cs.lm_dataset(torch, dev, model["vocab_size"], MOE_GLOO_BATCH,
                         model["max_len"], cs.LM_SEED)
    rows = MOE_GLOO_BATCH // world
    part = DataSet(full.features[rank * rows:(rank + 1) * rows],
                   full.labels[rank * rows:(rank + 1) * rows])

    def timed(step):
        step()  # warm
        _sync(torch)
        ms = []
        for _ in range(MOE_TIMED_STEPS):
            expert.reset_stats()
            t0 = time.monotonic()
            step()
            _sync(torch)
            ms.append((time.monotonic() - t0) * 1e3)
        return {"step_ms": float(np.median(ms)),
                "expert_rows": expert.stats()["expert_rows"]}

    pw = ParallelWrapper(ComputationGraph(conf, device=dev).init(),
                         prefetch_buffer=0)
    out = timed(lambda: pw.fit(part))
    if rank == 0:
        one = ComputationGraph(conf, device=dev).init()
        out["one_rank"] = timed(lambda: one.fit_batch(full))
    return out


def exact_rank(rank, world, backend, parts, overrides=None,
               device="cuda"):
    """One rank of [35c] / [35d] (``parts``: the letters to run).
    ``overrides`` ({"module.NAME": value}) and ``device`` "cpu" rehearse it
    at a small size without a card (a rank is a fresh interpreter)."""
    import importlib

    import torch

    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32

    for key, value in (overrides or {}).items():
        mod, name = key.rsplit(".", 1)
        setattr(importlib.import_module(mod), name, value)
    serve_full_f32()
    chip_session._deterministic(torch)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    out = {}
    if "c" in parts:
        t0 = time.monotonic()
        out["tbptt"] = tbptt_rank(torch, dev, rank, world)
        out["tbptt_seconds"] = time.monotonic() - t0
    if "d" in parts:
        t0 = time.monotonic()
        if world == 1:
            out["moe"] = _moe_full_bits(torch, dev)
        else:
            memo = {}
            out["moe"] = _moe_gloo(torch, dev, rank, world, False, memo)
            out["moe_control"] = _moe_gloo(torch, dev, rank, world, True,
                                           memo)
            out["moe_scaling"] = _moe_scaling(torch, dev, rank, world)
        out["moe_seconds"] = time.monotonic() - t0
    return out


def start_ranks(parts, overrides=None, device="cuda"):
    """Start [35c] / [35d]'s two process groups at once, one NCCL rank and
    two gloo ranks on ``cuda:0``, each from a thread of this process (so
    the parent's other parts run meanwhile); :func:`finish_ranks` joins
    them. ``overrides`` / ``device``: see :func:`exact_rank`; on the CPU
    the one rank runs over gloo."""
    import threading

    from deeplearning4j_tpu_torch.parallel.launch import spawn

    one = (dict(backend="gloo", device="cpu") if device == "cpu" else {})
    jobs = {"nccl": (1, ("nccl", parts, overrides, device), one),
            "gloo": (2, ("gloo", parts, overrides, device),
                     dict(backend="gloo", device=device))}
    out = {}

    def run(name, world, args, kw):
        try:
            out[name] = spawn(exact_rank, world, args, timeout=TIMEOUT,
                              **kw)
        except BaseException as e:  # re-raised by finish_ranks
            out[name] = e

    threads = [threading.Thread(target=run, args=(name,) + job,
                                daemon=True) for name, job in jobs.items()]
    for t in threads:
        t.start()
    return threads, out, time.monotonic()


def across_ranks(torch, smi, parts, failures, overrides=None,
                 device="cuda") -> dict:
    """[35c] and [35d] (see :func:`start_ranks`)."""
    return finish_ranks(start_ranks(parts, overrides, device), smi, parts,
                        failures)


def finish_ranks(handle, smi, parts, failures) -> dict:
    """Wait for :func:`start_ranks`' ranks and hold their results."""
    threads, results, t0 = handle
    for t in threads:
        t.join()
    for r in results.values():
        if isinstance(r, BaseException):
            raise r
    nccl, gloo = results["nccl"][0], results["gloo"]
    out = {"nccl": nccl, "gloo": gloo[0], "seconds": time.monotonic() - t0}
    if "c" in parts:
        t, tn = gloo[0]["tbptt"], nccl["tbptt"]
        _check(tn["exact"]["same_bits"],
               f"[35c] NCCL x1 exact tBPTT: {tn['exact']}", failures)
        for name in ("exact", "back_lt_fwd"):
            _check(t[name]["passes"], f"[35c] gloo x2 {name}: {t[name]}",
                   failures)
        _check(not t["control"]["passes"],
               f"[35c] the no-exchange control passed: {t['control']}",
               failures)
        for name in ("threshold_fixed", "threshold_adaptive", "averaging"):
            _check(all(math.isfinite(v) for v in t[name]["losses"]),
                   f"[35c] {name}: {t[name]}", failures)
        _log(f"[35c] TextGenerationLSTM tBPTT through ParallelWrapper: NCCL "
             f"x1 exact the fit_batch bits: {tn['exact']['same_bits']}; gloo "
             f"x2 exact worst segment loss rel "
             f"{t['exact']['worst_segment_loss_rel']:.3e}, state rel L2 "
             f"{t['exact']['worst_state_rel_l2']:.3e} (<= {TBPTT_LOSS_RTOL} "
             f"/ {TBPTT_STATE_RTOL}); back < fwd at T {TEXT_T_RAGGED}: "
             f"{t['back_lt_fwd']['worst_segment_loss_rel']:.3e} / "
             f"{t['back_lt_fwd']['worst_state_rel_l2']:.3e}; control "
             f"{t['control']['worst_segment_loss_rel']:.3e} / "
             f"{t['control']['worst_state_rel_l2']:.3e}: "
             f"{'caught' if not t['control']['passes'] else 'MISSED'}; "
             f"threshold fixed {t['threshold_fixed']['losses']}, adaptive "
             f"{t['threshold_adaptive']['losses']}, averaging "
             f"{t['averaging']['losses']} [{smi}]")
    if "d" in parts:
        mn, m, mc = nccl["moe"], gloo[0]["moe"], gloo[0]["moe_control"]
        sc = gloo[0]["moe_scaling"]
        _check(mn["same_bits"], f"[35d] NCCL x1 exact MoE: {mn}", failures)
        layers = chip_moe.MOE_MODEL["n_layers"]
        _check(all(v == layers for v in mn["launches"].values()),
               f"[35d] rows 6-8 launches {mn['launches']}, expected "
               f"{layers} each", failures)
        _check(m["passes"], f"[35d] gloo x2 exact MoE: {m}", failures)
        _check(not mc["passes"], f"[35d] the per-rank capacity control "
               f"passed: {mc}", failures)
        _check(len({r["moe"]["digest"] for r in gloo}) == 1,
               "[35d] the gloo ranks' params differ", failures)
        _log(f"[35d] MoE LM exact mode: NCCL x1 full depth the fit_batch "
             f"bits: {mn['same_bits']}, launches {mn['launches']}, step "
             f"{mn['step_ms']:.1f} ms; gloo x2 ({MOE_GLOO_LAYERS} layers): "
             f"loss rel {m['loss_rel_err']:.2e}, updates global L2 "
             f"{m['update_global_l2']:.3e}, worst {m['update_worst']}, "
             f"flips {m['flips']} (primary {m['primary']}), capacity "
             f"decisions differing {m['kept_mismatch']}; control loss rel "
             f"{mc['loss_rel_err']:.2e}, updates {mc['update_global_l2']:.3e},"
             f" capacity decisions differing {mc['kept_mismatch']}: "
             f"{'caught' if not mc['passes'] else 'MISSED'}; updates' "
             f"float64 distance ranks {m['update_vs_f64']['ranks']:.3e}, one "
             f"rank {m['update_vs_f64']['one_rank']:.3e}; warm step "
             f"rank 0 {sc['step_ms']:.1f} ms, expert rows {sc['expert_rows']}"
             f" (one rank on all rows {sc['one_rank']['step_ms']:.1f} ms, "
             f"{sc['one_rank']['expert_rows']}) [{smi}]")
    return out


# --------------------------------------------------------------------------
# [35e] the platform's leftovers
# --------------------------------------------------------------------------

def platform_leftovers(torch, dev, smi, failures) -> dict:
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
        bucket_rows,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50
    from deeplearning4j_tpu_torch.zoo.models import AlexNet

    out = {"card": smi}
    zoo = ResNet50(**RESNET)
    net = ComputationGraph(dataclasses.replace(zoo.conf(), use_kernels=True),
                           device=dev).init()
    cs.randomize_bn(net, SEED)
    pi = ParallelInference(net, devices=[dev] * PI_WORKERS)
    launched = []
    with InferenceEngine(pi, BatchingConfig(max_batch=PI_MAX_BATCH)) as eng:
        real = type(eng.model)._run

        def spy(self, xs):
            launched.append(int(xs[0].shape[0]))
            return real(self, xs)

        type(eng.model)._run = spy
        errs = []
        impls.matmul_bias_act.launches = 0
        try:
            for n in PI_SIZES:
                x = np.random.default_rng(SEED + n).random(
                    (n, zoo.height, zoo.width, zoo.channels), np.float32)
                got = eng.predict(x)
                want = net.output(x)
                errs.append(float(np.linalg.norm(got - want)
                                  / np.linalg.norm(want)))
        finally:
            type(eng.model)._run = real
        row1 = impls.matmul_bias_act.launches
        buckets = eng.buckets()
    expect_rows = [bucket_rows(n, PI_WORKERS) for n in PI_SIZES]
    # each launch: one forward a replica through the engine, and the
    # reference output once a request
    expect_row1 = 36 * (PI_WORKERS * len(PI_SIZES) + len(PI_SIZES))
    out["parallel_inference"] = {
        "workers": PI_WORKERS, "buckets": buckets, "launch_rows": launched,
        "expected_rows": expect_rows, "rel_l2": errs,
        "row1_launches": row1, "row1_expected": expect_row1}
    _check(launched == expect_rows and all(r % PI_WORKERS == 0
                                           for r in launched),
           f"[35e] launch rows {launched}, expected {expect_rows}", failures)
    _check(max(errs) <= PI_RTOL, f"[35e] answers off: {errs}", failures)
    _check(row1 == expect_row1, f"[35e] row 1 {row1} launches, expected "
           f"{expect_row1}", failures)
    del net, pi
    torch.cuda.empty_cache()
    # AlexNet's calibration under the span registry, then row 4
    az = AlexNet(**ALEXNET)
    alex = MultiLayerNetwork(dataclasses.replace(az.conf(),
                                                 use_kernels=True),
                             device=dev).init()
    rng = np.random.default_rng(SEED)
    cal = [rng.random((32, az.height, az.width, az.channels), np.float32)
           for _ in range(CAL_BATCHES)]
    telemetry.reset()
    telemetry.enable()
    try:
        rec = iopt.calibrate(alex, cal)
        spans = [e for e in telemetry.events()
                 if e["name"] == "quant_calibrate"]
    finally:
        telemetry.disable()
    q = iopt.quantize_for_inference(alex, rec)
    impls.matmul_bias_act_int8.launches = 0
    y = q.output(cal[0])
    _sync(torch)
    out["quant_calibrate"] = {
        "spans": len(spans), "batches": CAL_BATCHES,
        "span_ms": [e["duration_ns"] / 1e6 for e in spans],
        "row4_launches": impls.matmul_bias_act_int8.launches,
        "finite": bool(np.isfinite(y).all()), "shape": list(y.shape)}
    _check(len(spans) == CAL_BATCHES and
           out["quant_calibrate"]["row4_launches"] == 2
           and out["quant_calibrate"]["finite"],
           f"[35e] calibrate: {out['quant_calibrate']}", failures)
    del alex, q
    _log(f"[35e] InferenceEngine(ParallelInference(ResNet-50), "
         f"{PI_WORKERS} replicas on cuda:0): buckets {buckets}, launch rows "
         f"{launched} (expected {expect_rows}), answers rel L2 "
         f"{max(errs):.2e} (<= {PI_RTOL}), row 1 {row1} launches; AlexNet "
         f"calibrate: {len(spans)} quant_calibrate spans for "
         f"{CAL_BATCHES} batches, int8 forward "
         f"{out['quant_calibrate']['row4_launches']} row 4 launches "
         f"[{smi}]")
    return out


# --------------------------------------------------------------------------
# [35f] the paths only the CPU had run
# --------------------------------------------------------------------------

def bf16_text(torch, dev, smi, failures) -> dict:
    """``TextGenerationLSTM`` under the bf16 policy on the card, against
    the card's float32 run, the port's CPU bf16 run the yardstick: the bf16
    rule of [22]-[23] (the card's bf16 at most ``BF16_LOSS_FLOOR[0]`` x as
    far from float32 as the yardstick, plus 4 bf16 ulps, for the segment
    losses and the params)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = _text_conf(TEXT_SEG, TEXT_SEG)
    bconf = dataclasses.replace(conf, compute_dtype="bfloat16")
    seed_net = MultiLayerNetwork(conf, "cpu").init()
    p0, s0 = seed_net.params, seed_net.state
    batches = _text_batches(BF16_FITS, TEXT_T, SEED + 2)
    runs = {}
    for name, c, d in (("f32", conf, dev), ("bf16", bconf, dev),
                       ("bf16_cpu", bconf, "cpu")):
        net = MultiLayerNetwork(c, d).set_params(p0, s0)
        t0 = time.monotonic()
        segs = []
        for ds in batches:
            net.fit_batch(ds)
            segs.append(net.last_segment_losses.float().cpu().numpy())
        _sync(torch)
        runs[name] = {"net": net, "segs": np.concatenate(segs),
                      "seconds": time.monotonic() - t0}
    f32 = runs["f32"]
    a, b = cs.BF16_LOSS_FLOOR

    def dist(x):
        return float(np.abs(x - f32["segs"]).max()
                     / np.abs(f32["segs"]).max())

    def pdist(net):
        return max(chip_sequence._tree_errors(net.params,
                                              f32["net"].params).values())

    loss_card, loss_cpu = dist(runs["bf16"]["segs"]), dist(
        runs["bf16_cpu"]["segs"])
    p_card, p_cpu = pdist(runs["bf16"]["net"]), pdist(runs["bf16_cpu"]["net"])
    sa, sb = cs.BF16_STATE_FLOOR
    out = {"card": smi, "segments": len(f32["segs"]),
           "losses_f32": f32["segs"].tolist(),
           "losses_bf16": runs["bf16"]["segs"].tolist(),
           "loss_dist": [loss_card, loss_cpu],
           "params_dist": [p_card, p_cpu],
           "seconds": {k: v["seconds"] for k, v in runs.items()}}
    out["passes"] = (loss_card <= a * loss_cpu + b
                     and p_card <= sa * p_cpu + sb
                     and dist(runs["bf16"]["segs"]) <= cs.BF16_TRACK_RTOL)
    _check(out["passes"], f"[35f] bf16 TextGenerationLSTM: {out}", failures)
    _log(f"[35f] TextGenerationLSTM bf16 on the card: segment losses "
         f"{loss_card:.3e} from float32 (the CPU bf16 run {loss_cpu:.3e}; "
         f"rule {a}x + {b:.2e}), params rel L2 {p_card:.3e} ({p_cpu:.3e}; "
         f"{sa}x + {sb:.2e}); {out['seconds']} s [{smi}]")
    return out


def _yolo_labels(conf, batch, rng):
    """YOLOv2 labels ``[b, H, W, 4 + C]``: two boxes an image, corners in
    grid units at random cells, a class one-hot."""
    name = conf.network_outputs[0]
    layer = conf.vertex_map()[name].vertex.layer
    t = conf.vertex_output_types()[conf.vertex_map()[name].inputs[0]]
    h, w = t.height, t.width
    c = layer._classes(t.channels)
    y = np.zeros((batch, h, w, 4 + c), np.float32)
    for i in range(batch):
        for _ in range(2):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            x1, y1 = cx + rng.uniform(-0.4, 0.2), cy + rng.uniform(-0.4, 0.2)
            y[i, cy, cx, :4] = [x1, y1, x1 + rng.uniform(0.5, 2.5),
                                y1 + rng.uniform(0.5, 2.5)]
            y[i, cy, cx, 4 + rng.integers(0, c)] = 1.0
    return y


NO_LIMIT = {"global": math.inf, "tensor": math.inf}
# the float64 rule (PERF.md): the kernel route's step-1 gradient at
# most F64_RULE[0] x as far from the float64 gradient as the stock
# route's, plus F64_RULE[1], over all tensors and tensor by tensor
# (``--spread 6`` on an H100 80GB HBM3 at 700 W, seeds 35-40: the kernel
# route 0.845-1.049x, the TF32 control 8.94-17.75x; a tensor's excess
# over 2x the stock route's at most 1.85e-5, the control's 0.216-0.262)
F64_RULE = (1.5, 1e-6)
F64_TENSOR_RULE = (2.0, 1e-4)
F64_FAULT_SCALE = 1.3  # the planted fault: one tensor's gradient x 1.3


def _f64_grads(torch, conf, net, ds):
    """Step-1 gradients of ``net``'s params and state in float64 (the
    stock route), on ``net``'s device."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    c64 = dataclasses.replace(conf, dtype="float64", compute_dtype=None,
                              use_kernels=False)
    to64 = lambda t: {k: {p: v.double() for p, v in vp.items()}  # noqa
                      for k, vp in t.items()}
    n64 = ComputationGraph(c64, device=net.device).set_params(
        to64(net.params), to64(net.state))
    g, _ = n64.compute_gradient_and_score(ds)
    del n64
    return g


def grad_rule(torch, conf, net, ref, ds, label, failures) -> dict:
    """Step-1 gradients of the kernel route against the stock route: within
    [7]'s fixed limits, or else by the float64 rule (each route against
    the float64 gradient: the kernel route no farther than ``F64_RULE`` /
    ``F64_TENSOR_RULE`` allow), with two controls the rule must catch: a
    planted fault (the tensor of the largest float64 norm scaled by
    ``F64_FAULT_SCALE``) and the TF32 control (``chip_zoo.one_pass_row1``:
    row 1 without its 3xTF32 split)."""
    import chip_zoo

    gk, _ = net.compute_gradient_and_score(ds)
    gs, _ = ref.compute_gradient_and_score(ds)
    err = cs._grad_errors(gk, gs)
    lim = cs.TRAIN_GRAD_L2
    fixed = (err["global_l2"] <= lim["global"]
             and err["tensor_l2"][0][0] <= lim["tensor"]
             and err["tensor_maxrel"][0][0] <= cs.TRAIN_GRAD_MAXREL)
    out = {"kernel_vs_stock": cs._summary(err), "fixed_limits": fixed,
           "held_by": "[7]'s limits"}
    if not fixed:
        g64 = _f64_grads(torch, conf, ref, ds)
        ek, es = cs._grad_errors(gk, g64), cs._grad_errors(gs, g64)

        def holds(e):
            tk, ts = cs._per_tensor(e), cs._per_tensor(es)
            worst = max(tk[t] - F64_TENSOR_RULE[0] * ts[t] for t in tk)
            return (e["global_l2"] <= F64_RULE[0] * es["global_l2"]
                    + F64_RULE[1] and worst <= F64_TENSOR_RULE[1]), worst

        ok, worst = holds(ek)
        big = max(g64, key=lambda k: max(float(v.double().norm())
                                         for v in g64[k].values()))
        planted = {k: {p: v * (F64_FAULT_SCALE if k == big else 1.0)
                       for p, v in vp.items()} for k, vp in gk.items()}
        caught = not holds(cs._grad_errors(planted, g64))[0]
        with chip_zoo.one_pass_row1(torch):
            gc, _ = net.compute_gradient_and_score(ds)
        ec = cs._grad_errors(gc, g64)
        control_ok, control_worst = holds(ec)
        out.update(held_by="the float64 rule", kernel_vs_f64=cs._summary(ek),
                   stock_vs_f64=cs._summary(es), rule_holds=ok,
                   worst_tensor_excess=worst, planted=big,
                   planted_caught=caught,
                   control_vs_f64=cs._summary(ec),
                   control_tensor_excess=control_worst,
                   control_caught=not control_ok)
        _check(ok and caught and not control_ok,
               f"[{label}] step-1 gradients: {out}", failures)
        del g64
    _log(f"[{label}] step-1 gradients held by {out['held_by']}: "
         f"{json.dumps(out, default=str)}")
    return out


def _zoo_case(torch, dev, name, seed):
    """``(conf, kernel-route net, stock-route net, batch)`` of ``name`` at
    its zoo size and ``ZOO_TRAIN`` batch, SGD(1e-3): weights from the
    configuration's seed moved by ``seed - SEED``, batch norms, inputs and
    labels from ``seed``."""
    from deeplearning4j_tpu_torch import zoo as pzoo
    from deeplearning4j_tpu_torch.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    batch = ZOO_TRAIN[name]
    conf = getattr(pzoo, name)(updater=Sgd(learning_rate=1e-3),
                               **ZOO_ARGS[name]).conf()
    conf = dataclasses.replace(conf, use_kernels=True,
                               seed=conf.seed + seed - SEED)
    net = ComputationGraph(conf, device=dev).init()
    cs.randomize_bn(net, seed)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    t = conf.input_types[0]
    rng = np.random.default_rng(seed)
    x = rng.random((batch, t.height, t.width, t.channels), np.float32)
    if name == "UNet":
        y = (rng.random((batch, t.height, t.width, 1)) > 0.5).astype(
            np.float32)
    else:
        y = _yolo_labels(conf, batch, rng)
    return conf, net, ref, DataSet(x, y)


def f64_spread(torch, dev, smi, n) -> dict:
    """``--spread N``: YOLO2's step-1 gradients at ``N`` seeds from
    ``SEED`` on, each route's and the TF32 control's (``chip_zoo.
    one_pass_row1``) distance from the float64 gradient: the readings
    ``F64_RULE`` and ``F64_TENSOR_RULE`` are set from."""
    import chip_zoo

    rows = []
    for seed in range(SEED, SEED + n):
        conf, net, ref, ds = _zoo_case(torch, dev, "YOLO2", seed)
        gk, _ = net.compute_gradient_and_score(ds)
        gs, _ = ref.compute_gradient_and_score(ds)
        with chip_zoo.one_pass_row1(torch):
            gc, _ = net.compute_gradient_and_score(ds)
        g64 = _f64_grads(torch, conf, ref, ds)
        es = cs._grad_errors(gs, g64)
        ts = cs._per_tensor(es)
        row = {"seed": seed, "stock_vs_f64": es["global_l2"],
               "kernel_vs_stock": cs._grad_errors(gk, gs)["global_l2"]}
        for label, g in (("kernel", gk), ("control", gc)):
            e = cs._grad_errors(g, g64)
            tk = cs._per_tensor(e)
            row[label] = {
                "vs_f64": e["global_l2"],
                "ratio": e["global_l2"] / es["global_l2"],
                "tensor_excess": max(tk[t] - F64_TENSOR_RULE[0] * ts[t]
                                     for t in tk),
                "tensor_ratio": max(tk[t] / max(ts[t], 1e-30) for t in tk)}
        rows.append(row)
        _log(f"[35f spread] YOLO2 seed {seed}: {json.dumps(row)}")
        del net, ref, g64
        torch.cuda.empty_cache()
    out = {"card": smi, "seeds": rows,
           "kernel_ratio_max": max(r["kernel"]["ratio"] for r in rows),
           "control_ratio_min": min(r["control"]["ratio"] for r in rows)}
    _log(f"[35f spread] YOLO2 ratio to the stock route's float64 distance:"
         f" kernel route max {out['kernel_ratio_max']:.4f}, TF32 control "
         f"min {out['control_ratio_min']:.4f} [{smi}]")
    return out


def zoo_fit(torch, dev, smi, failures) -> dict:
    """UNet and YOLO2 through ``fit`` on both routes, ``ZOO_TRAIN_STEPS``
    SGD steps (step 1 at [7]'s gates), row 1 counted."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls, routing
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    out = {}
    for name, batch in ZOO_TRAIN.items():
        t0 = time.monotonic()
        conf, net, ref, ds = _zoo_case(torch, dev, name, SEED)
        t = conf.input_types[0]
        sites = len(routing.routed_sites(conf, batch, mode="cuda"))
        # ---- the main path: the kernel route's fit ----
        trial = ComputationGraph(conf, device=dev).set_params(net.params,
                                                              net.state)
        collect = CollectScoresListener()
        trial.set_listeners(collect)
        impls.matmul_bias_act.launches = 0
        trial.fit(ListDataSetIterator([ds] * ZOO_TRAIN_STEPS))
        _sync(torch)
        launches = impls.matmul_bias_act.launches
        # ---- end of the main path ----
        del trial
        # step 1 on both routes: the gradients by [7]'s limits or the
        # float64 rule, the loss and BN state at [7]'s gates; then the
        # stock route's remaining steps (the routes part later: reported)
        grads = grad_rule(torch, conf, net, ref, ds, f"35f {name}",
                          failures)
        cmp = cs._compare_training(torch, net, ref, ds, 1, f"35f {name}",
                                   grad_tol=NO_LIMIT, maxrel=math.inf)
        stock = CollectScoresListener()
        ref.set_listeners(stock)
        ref.fit(ListDataSetIterator([ds] * (ZOO_TRAIN_STEPS - 1)))
        cmp["losses_kernel"] = collect.scores
        cmp["losses_stock"] = cmp["losses_stock"] + stock.scores
        out[name] = {"batch": batch, "routed_sites": sites,
                     "row1_launches": launches,
                     "row1_expected": sites * ZOO_TRAIN_STEPS,
                     "losses": cmp["losses_kernel"],
                     "losses_stock": cmp["losses_stock"],
                     "loss_rel_err": cmp["loss_rel_err"],
                     "grad": grads,
                     "seconds": time.monotonic() - t0}
        _check(launches == sites * ZOO_TRAIN_STEPS,
               f"[35f] {name}: row 1 {launches} launches, expected "
               f"{sites} x {ZOO_TRAIN_STEPS}", failures)
        _log(f"[35f] {name} at {t.height}x{t.width}x{t.channels}, batch "
             f"{batch}, {ZOO_TRAIN_STEPS} SGD steps through fit: losses "
             f"{[round(v, 5) for v in cmp['losses_kernel']]} (stock "
             f"{[round(v, 5) for v in cmp['losses_stock']]}), step 1 held at "
             f"{grads['held_by']} (grad global L2 "
             f"{grads['kernel_vs_stock']['global_l2']:.2e}); "
             f"row 1 {launches} launches = {sites} sites x "
             f"{ZOO_TRAIN_STEPS} [{smi}]")
        del net, ref
        torch.cuda.empty_cache()
    return out


def depthwise_steps(torch, dev, smi, failures) -> dict:
    """Xception and NASNet: one training step a route, its ms, peak memory
    and the depthwise convolutions' share of device time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch import zoo as pzoo
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    out = {}
    for name in ("Xception", "NASNet"):
        zm = getattr(pzoo, name)(**ZOO_ARGS[name])
        conf = dataclasses.replace(zm.conf(), use_kernels=True)
        base = ComputationGraph(conf, device=dev).init()
        cs.randomize_bn(base, SEED)
        ds = cs._synthetic_batch(zm, DW_BATCH, SEED)
        row = {"batch": DW_BATCH}
        for route in ("kernel", "stock"):
            c = dataclasses.replace(conf, use_kernels=route == "kernel")
            net = ComputationGraph(c, device=dev).set_params(base.params,
                                                             base.state)
            loss = net.fit_batch(ds)  # the step compared; warms cuDNN
            torch.cuda.reset_peak_memory_stats()
            _sync(torch)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                net.fit_batch(ds)
                _sync(torch)
                ms = (time.monotonic() - t0) * 1e3
            total = dw = dw_bwd = 0.0
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                total += e.device_time
                low = e.name.lower()
                if "depthwise" in low or "dwconv" in low:
                    dw += e.device_time
                    if "backward" in low or "grad" in low:
                        dw_bwd += e.device_time
            row[route] = {"loss": loss, "step_ms": ms,
                          "device_ms": total / 1e3,
                          "depthwise_share": dw / total if total else 0.0,
                          "depthwise_backward_share":
                              dw_bwd / total if total else 0.0,
                          "peak_mib": torch.cuda.max_memory_allocated()
                          / 2 ** 20}
            del net
        row["loss_rel_err"] = abs(row["kernel"]["loss"] - row["stock"][
            "loss"]) / abs(row["stock"]["loss"])
        _check(all(math.isfinite(row[r]["loss"]) for r in ("kernel",
                                                           "stock")),
               f"[35f] {name}: {row}", failures)
        out[name] = row
        _log(f"[35f] {name} batch {DW_BATCH}, one training step: kernel "
             f"{row['kernel']['step_ms']:.1f} ms, stock "
             f"{row['stock']['step_ms']:.1f} ms; depthwise share of device "
             f"time {row['kernel']['depthwise_share']:.1%} (backward "
             f"{row['kernel']['depthwise_backward_share']:.1%}); peak MiB "
             f"{row['kernel']['peak_mib']:.0f}; first loss rel "
             f"{row['loss_rel_err']:.2e} [{smi}]")
        del base
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def ingest_phase(torch, dev, smi, parts="abcdef") -> tuple:
    """[35]: the ``{"ingest": ...}`` line and the kernels line's
    ``ingest`` entries (row: launches and scope). Raises if a gate
    failed."""
    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32

    serve_full_f32()
    t_start = time.monotonic()
    failures = []
    line = {"card": smi, "part_seconds": {}}
    rows = {}
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    t_part = [time.monotonic()]

    def part_done(name):
        now = time.monotonic()
        line["part_seconds"][name] = now - t_part[0]
        t_part[0] = now

    ranks = None
    try:
        state = None
        if "a" in parts or "b" in parts:
            state = ring_resnet(torch, dev, smi, line, failures)
            line["ring"] = state["line"]
            rows["matmul_stats"] = {
                "launches": state["line"]["runs"]["ring"]["launches"],
                "scope": (f"[35a]: full-width ResNet-50 fused_conv_bn fed "
                          f"by a depth-2 DeviceRingIterator, {RING_STEPS} "
                          f"steps at batch {RING_BATCH} (36 a step)")}
            part_done("a")
        # the ranks run while [35b], [35e] and [35f]'s gated parts do; the
        # timed parts ([35a] above, the depthwise steps below) run alone
        if "c" in parts or "d" in parts:
            ranks = start_ranks(parts)
        if "b" in parts:
            line["faults"] = ring_faults(torch, dev, smi, state, failures)
            part_done("b")
        del state
        torch.cuda.empty_cache()
        if "e" in parts:
            line["platform"] = platform_leftovers(torch, dev, smi, failures)
            pi = line["platform"]
            rows["matmul_bias_act"] = {
                "launches": pi["parallel_inference"]["row1_launches"],
                "scope": ("[35e]: ResNet-50 behind InferenceEngine("
                          "ParallelInference), 2 replicas on cuda:0, and "
                          "the reference outputs")}
            rows["matmul_bias_act_int8"] = {
                "launches": pi["quant_calibrate"]["row4_launches"],
                "scope": "[35e]: AlexNet int8 after calibrate, one forward"}
            torch.cuda.empty_cache()
            part_done("e")
        if "f" in parts:
            line["bf16_text"] = bf16_text(torch, dev, smi, failures)
            part_done("f_bf16")
            line["zoo_fit"] = zoo_fit(torch, dev, smi, failures)
            part_done("f_zoo")
            zl = line["zoo_fit"]
            if "matmul_bias_act" in rows:
                rows["matmul_bias_act"]["zoo_fit"] = {
                    k: v["row1_launches"] for k, v in zl.items()}
            else:
                rows["matmul_bias_act"] = {
                    "launches": sum(v["row1_launches"] for v in zl.values()),
                    "scope": "[35f]: UNet and YOLO2 through fit"}
            torch.cuda.empty_cache()
        if ranks is not None:
            across = finish_ranks(ranks, smi, parts, failures)
            ranks = None
            line["across_ranks"] = across
            part_done("cd_after_b_e_f")
            if "d" in parts:
                for k, n in across["nccl"]["moe"]["launches"].items():
                    rows[k] = {"launches": n, "scope": (
                        "[35d]: the 8-expert GPT-2-small-width LM's "
                        "exact-mode step at one NCCL rank, 8 x 1024 tokens")}
        if "f" in parts:
            line["depthwise"] = depthwise_steps(torch, dev, smi, failures)
            part_done("f_depthwise")
            torch.cuda.empty_cache()
    finally:
        if ranks is not None:  # a part above raised: wait for the ranks
            for t in ranks[0]:
                t.join()
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic
    line["seconds"] = time.monotonic() - t_start
    line["failures"] = failures
    _log(f"[35] staged and data-parallel training in {line['seconds']:.1f} s"
         f" (by part {json.dumps(line['part_seconds'])}) [{smi}]")
    if failures:
        raise AssertionError(f"[35] {len(failures)} gate(s) failed: "
                             f"{failures}")
    return line, rows


def main() -> int:
    """The build and [35] alone (or the parts ``--only`` names)."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="abcdef",
                    help="the parts of [35] to run, as letters")
    ap.add_argument("--spread", type=int, default=0,
                    help="first read YOLO2's step-1 gradient distances "
                         "from float64 at N seeds (F64_RULE's readings)")
    ap.add_argument("--ab", default=None, metavar="TREE",
                    help="first time fit(fused_steps=2) in TREE (the "
                         "parent's checkout) and here, in alternating "
                         "processes: TREE, here, here, TREE")
    ap.add_argument("--ab-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ab_child:
        print("AB_RESULT " + json.dumps(_ab_child()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.kernels import build, impls

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    _log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    _log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
         f"{time.monotonic() - t0:.1f} s")
    if args.spread:
        _log(json.dumps({"spread": f64_spread(torch, dev, smi,
                                              args.spread)}))
    if args.ab:
        _log(json.dumps({"fused_ab": fused_ab(args.ab, smi)}))
    if args.only:
        line, rows = ingest_phase(torch, dev, smi, parts=args.only)
        _log(json.dumps({"ingest": line, "rows": rows}, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
