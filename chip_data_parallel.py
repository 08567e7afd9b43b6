#!/usr/bin/env python3
"""Phase [26] of ``chip_smoke.py``: data-parallel training of full-width
ResNet-50 (``fused_conv_bn``, ``use_kernels``, Adam(1e-3), global batch
32) through ``ParallelWrapper.fit`` on one H100.

- [26a] NCCL at ``torch.cuda.device_count()`` ranks: exact mode and
  bucketed exact at ``gradient_bucket_mb=25``, 2 steps each, held after
  every step against ``ComputationGraph.fit`` on the same global batches
  in one process at [7]'s training gates (step-1 gradients, every loss,
  the BN state after step 1); the largest differences of params, BN state
  and updater state after each step are printed (at one rank the same
  bits are expected); the wrapper's step time beside plain ``fit``'s.
- [26b] two gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on one
  card), 16 rows a rank: exact mode against ``fit`` at batch 32, and the
  planted control, per-rank BN statistics, which must break the same
  gates; bucketed exact at 25 and 0 MB the same bits, the kernel route
  within [7]'s gates of ``use_kernels=False``; ZeRO the same bits as
  bucketed exact (params, BN state and the gathered Adam state), its peak
  memory against exact's, and a ``CheckpointListener`` zip written mid-fit
  that restores, in one process, to the gathered state; threshold (fixed
  tau 1e-3 and adaptive), kernel route against stock by the share of
  flipped messages and the params outside them; averaging every 2 steps
  over 2 steps, the replicas the same bits after the average, kernel
  against stock at [7]'s gates. With 2 cards or more the [26b] set runs
  over NCCL as well, one rank a card.

Every rank is a process of ``parallel.launch.spawn`` (the ``spawn`` start
method, a process-group timeout and a join timeout: a rank that dies or
hangs fails the phase) and runs cuDNN's deterministic algorithms, so a
run repeats its bits. The parent builds the kernels before any rank
starts. Reported, not gated: step ms per mode and route (at [26b] two
ranks share the SMs: not a scaling figure), exchange bytes a step beside
the telemetry counters, collective ms (CUDA events around one exchange of
a gradient-sized tree), host-staged gloo collectives, step 1's peak
memory through its gradient pass and after it. ``matmul_stats`` launches
per rank per step are gated at 36.

``python3 chip_data_parallel.py --trace`` runs the phase alone and adds,
on the card, a census of the CUDA storages Python holds at the end of
step 1's gradient pass (exact, bucketed, ZeRO) and a ``torch.profiler``
trace of each rank's step: [26a] plain ``fit``, exact, and exact with the
global-batch collectives that one rank skips; [26b] bucketed against
exact (wall and device ms, launches, the host ops that grew).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import math
import statistics
import tempfile
import time
import warnings

import chip_smoke as cs

DP_BATCH = 32
# steps a mode, and the averaging modes' (one average, at step 2): the
# script's time limit bounds the depth
DP_STEPS = 2
DP_AVG_STEPS = 2
DP_AVG_FREQ = 2
DP_BUCKET_MB = 25
DP_TAU = 1e-3
DP_SEED = 26
DP_TIMEOUT = 900.0
# threshold encoding is discontinuous: a rounding difference between the
# routes turns an element's message from 0 into ±tau (or back) where the
# weighted gradient sits at tau. The share of this rank's step-1 messages
# allowed to differ between the routes; elsewhere the step-1 params must
# be the same bits (the same shared message, params and Adam state in)
THRESHOLD_FLIP_SHARE = 1e-3
RESNET_PARAM_BYTES = 102_228_128  # 25,557,032 float32 params

B25 = {"gradient_bucket_mb": DP_BUCKET_MB}
# (mode, route, wrapper kwargs, comparison): "fit" = against
# ComputationGraph.fit at the global batch (rank 0); ("route", base) =
# [7]'s gates against the kernel route's run ``base``; ("flips", base) =
# the threshold comparison against ``base``; ("bits", base) = the same
# bits as ``base``
NCCL_MODES = (("exact", "kernel", {}, "fit"),
              ("bucketed25", "kernel", B25, "fit"))
GLOO_MODES = (
    ("exact", "kernel", {}, "fit"),
    ("control", "kernel", {"per_rank_bn": True}, "fit"),
    ("bucketed25", "kernel", B25, None),
    ("bucketed0", "kernel", {"gradient_bucket_mb": 0}, ("bits", "bucketed25")),
    ("bucketed25_stock", "stock", B25, ("route", "bucketed25")),
    ("zero", "kernel", {"zero_optimizer": True, **B25},
     ("bits", "bucketed25")),
    ("threshold_fixed", "kernel", {"threshold": "fixed"}, None),
    ("threshold_fixed_stock", "stock", {"threshold": "fixed"},
     ("flips", "threshold_fixed")),
    ("threshold_adaptive", "kernel", {"threshold": "adaptive"}, None),
    ("threshold_adaptive_stock", "stock", {"threshold": "adaptive"},
     ("flips", "threshold_adaptive")),
    ("averaging", "kernel", {"averaging": True}, None),
    ("averaging_stock", "stock", {"averaging": True},
     ("route", "averaging")),
)


def _needs(modes, name):
    """What the runs after ``name`` compare it by."""
    return {cmp[0] for _, _, _, cmp in modes
            if isinstance(cmp, tuple) and cmp[1] == name}


def _log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# the rank side
# --------------------------------------------------------------------------

def _host(tree):
    """A host copy of a tensor tree."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _digest(*trees) -> str:
    """sha1 of the bits of tensor trees (sorted keys)."""
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


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max((_max_diff(a[k], b[k]) for k in b), default=0.0)
    return float((a.double() - b.double()).abs().max())


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return all(_same_bits(a[k], b[k]) for k in b)
    return bool(a.equal(b))


def _first_moment(opt):
    """Adam's m after step 1 is (1 - beta1) times the step-1 gradient."""
    return {k: {pk: st["m"] for pk, st in vp.items()} for k, vp in opt.items()}


def _gates(ga, gb, sa, sb, la, lb) -> dict:
    """[7]'s training gates between two runs: the step-1 gradients (by the
    first moments), the BN state after step 1, every step's loss."""
    err = cs._summary(cs._grad_errors(ga, gb))
    state = cs._state_err(sa, sb)
    loss = [abs(a - b) / abs(b) for a, b in zip(la, lb)]
    ok = (err["global_l2"] <= cs.TRAIN_GRAD_L2["global"]
          and err["tensor_l2"][0][0] <= cs.TRAIN_GRAD_L2["tensor"]
          and err["tensor_maxrel"][0][0] <= cs.TRAIN_GRAD_MAXREL
          and state <= cs.TRAIN_STATE_RTOL
          and loss[0] <= cs.TRAIN_LOSS_RTOL[0]
          and max(loss) <= cs.TRAIN_LOSS_RTOL[1]
          and all(math.isfinite(v) for v in la))
    return {"ok": bool(ok), "grad_global_l2": err["global_l2"],
            "grad_tensor_l2": err["tensor_l2"][0],
            "grad_tensor_maxrel": err["tensor_maxrel"][0],
            "state_rel_err": state, "loss_rel_err": loss}


class _Steps:
    """Listener: each step's wall time (the card synchronized; the
    listener's own copies excluded), score and replica digest, host copies
    of the trees (every step, or step 1 only) and a step-1 callback."""

    def __init__(self, torch, pw=None, keep_all=False, keep_first=False,
                 on_first=None):
        self.torch, self.pw = torch, pw
        self.keep_all, self.keep_first = keep_all, keep_first
        self.on_first = on_first
        self.times, self.scores, self.replicas, self.trees = [], [], [], []
        self.t0 = None
        self.peak1_mb = None

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def on_epoch_start(self, model, epoch):
        self._sync()
        self.t0 = time.perf_counter()

    def on_epoch_end(self, model, epoch):
        pass

    def iteration_done(self, model, iteration, epoch, score):
        self._sync()
        self.times.append(time.perf_counter() - self.t0)
        if iteration == 0 and self.torch.cuda.is_available():
            # step 1's peak: later steps of a mode may hold a checkpoint's
            # gathered trees (ZeRO) or the comparisons' copies
            self.peak1_mb = self.torch.cuda.max_memory_allocated() / 2 ** 20
        self.scores.append(float(score))
        pw = self.pw
        if pw is not None and pw.training_mode.value == "averaging":
            self.replicas.append(_digest(pw._params))
        if self.keep_all or (self.keep_first and iteration == 0):
            # the model's live trees (an averaging replica's own)
            self.trees.append((_host(model.params), _host(model.state),
                               _host(model.opt_state)))
        if iteration == 0 and self.on_first is not None:
            self.on_first(model)
        self._sync()
        self.t0 = time.perf_counter()


class _GatheredDigest:
    """Listener after a CheckpointListener: the digest of the trees the
    save just gathered, at the iteration it saved."""

    def __init__(self, every):
        self.every, self.digest, self.iteration = every, None, None

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def iteration_done(self, model, iteration, epoch, score):
        if (iteration + 1) % self.every == 0 and self.digest is None:
            self.digest = _digest(model.params, model.state, model.opt_state)
            self.iteration = iteration


@contextlib.contextmanager
def _per_rank_bn(on: bool):
    """The planted control: batch-norm statistics over this rank's rows
    only (the per-shard modes' semantics) while the loss stays global."""
    from deeplearning4j_tpu_torch.comms import global_batch

    real = global_batch.batch_moments, global_batch.global_sums
    if on:
        global_batch.batch_moments = lambda x32, axes: (
            x32.mean(dim=axes), (x32 * x32).mean(dim=axes))
        global_batch.global_sums = lambda s, q, m: (s, q, m)
    try:
        yield
    finally:
        global_batch.batch_moments, global_batch.global_sums = real


def run_ranks(rank, world, cfg):
    """One rank of [26a] / [26b]: every mode of ``cfg["modes"]`` in one
    process group. Returns plain numbers for the parent to gate and
    print."""
    import torch

    from deeplearning4j_tpu_torch import comms, telemetry
    from deeplearning4j_tpu_torch.comms import scheduler
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.checkpoint import (
        CheckpointListener,
    )
    from deeplearning4j_tpu_torch.parallel import (
        AdaptiveThresholdAlgorithm,
        ParallelWrapper,
        ThresholdAlgorithm,
        TrainingMode,
    )
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel import wrapper as wrapper_mod
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    on_card = cfg["device"] == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    # cuDNN's deterministic algorithms, as [21] and [22] take them: under
    # the defaults the conv backward's sums vary from run to run, so two
    # runs of one mode (or of two modes with the same arithmetic) would
    # not give the same bits
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    zoo = ResNet50(**cfg.get("model", {}))
    zoo.fused_conv_bn = True
    conf_k = dataclasses.replace(zoo.conf(), use_kernels=True)
    nets = {"kernel": ComputationGraph(conf_k, device=dev).init()}
    cs.condition_residual_bn(nets["kernel"])
    p0, s0 = _host(nets["kernel"].params), _host(nets["kernel"].state)
    nets["stock"] = ComputationGraph(
        dataclasses.replace(conf_k, use_kernels=False),
        device=dev).set_params(p0, s0)
    batch = cfg["batch"]
    glob = [cs._synthetic_batch(zoo, batch, DP_SEED + t)
            for t in range(max(DP_STEPS, DP_AVG_STEPS))]
    lo, hi, _ = mesh_mod.partition_rows(batch, rank, world)
    parts = [DataSet(ds.features[lo:hi], ds.labels[lo:hi]) for ds in glob]

    # the threshold modes' step-1 messages, signs as int8
    enc_log = {}
    real_encode = wrapper_mod.encode_tree

    def recording_encode(grads, residual, tau):
        enc, res, sp = real_encode(grads, residual, tau)
        enc_log.setdefault("step1", torch.cat(
            [e.reshape(-1).sign().to(torch.int8)
             for e in scheduler.tree_leaves(enc)]))
        return enc, res, sp

    wrapper_mod.encode_tree = recording_encode
    kept, out = {}, {}
    for mode, route, kw, cmp in cfg["modes"]:
        net = nets[route]
        net.set_params(p0, s0)
        net.iteration = net.epoch = 0
        kw = dict(kw)
        steps = DP_STEPS
        if kw.pop("averaging", False):
            kw["training_mode"] = TrainingMode.AVERAGING
            kw["averaging_frequency"] = DP_AVG_FREQ
            steps = DP_AVG_STEPS
        thr = kw.pop("threshold", None)
        if thr is not None:
            kw["threshold_algorithm"] = (
                ThresholdAlgorithm(DP_TAU) if thr == "fixed"
                else AdaptiveThresholdAlgorithm(DP_TAU))
        per_rank_bn = kw.pop("per_rank_bn", False)
        if per_rank_bn:
            steps = 1  # the control fails at step 1
        pw = ParallelWrapper(net, prefetch_buffer=0, **kw)
        needs = _needs(cfg["modes"], mode)
        res = {"route": route, "steps": steps}
        if on_card:
            _split_peak(torch, pw, res,
                        census=cfg.get("trace") and mode in (
                            "exact", "bucketed25", "zero"))
        on_first = None
        if isinstance(cmp, tuple) and cmp[0] == "flips":
            base = kept[cmp[1]]

            def on_first(model, base=base, res=res):
                mine = enc_log["step1"]
                differ = (mine != base["enc"]).to(torch.float32)
                res["flip_share"] = float(differ.mean())
                scheduler.all_reduce(differ, pw.group)  # any rank's flip
                agree = differ == 0
                p_k = torch.cat([v.reshape(-1) for _, vp in
                                 sorted(base["params1"].items())
                                 for _, v in sorted(vp.items())])
                p_s = torch.cat([v.detach().reshape(-1).cpu() for _, vp in
                                 sorted(model.params.items())
                                 for _, v in sorted(vp.items())])
                same = p_k == p_s
                res["shared_flip_share"] = float((~agree).float().mean())
                res["params_differ_outside_flips"] = int(
                    (~same & agree.cpu()).sum())
        rec = _Steps(torch, pw, keep_all=(cmp == "fit" and rank == 0),
                     keep_first=("flips" in needs or (rank == 0 and (
                         "route" in needs
                         or (isinstance(cmp, tuple) and cmp[0] == "route")))),
                     on_first=on_first)
        listeners = []
        if mode == "zero":
            zip_dir = tempfile.mkdtemp(prefix="dp_ckpt_")
            ckpt = CheckpointListener(zip_dir, save_every_n_iterations=2)
            gathered = _GatheredDigest(2)
            listeners = [ckpt, gathered]
        # rec first: the zip's write lands in step 3's time, not step 2's
        net.set_listeners(rec, *listeners)
        enc_log.clear()
        telemetry.reset()
        telemetry.enable()
        if on_card:
            gc.collect()  # earlier modes' cyclic garbage off the card
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res["base_mb"] = torch.cuda.memory_allocated() / 2 ** 20
        impls.matmul_stats.launches = 0
        # ---- this mode's main path: the launch count belongs to it ----
        with _per_rank_bn(per_rank_bn):
            pw.fit(ListDataSetIterator(parts[:steps]))
        res["launches"] = impls.matmul_stats.launches
        # ---- end of the main path ----
        metrics = telemetry.REGISTRY.snapshot(run_collectors=False)
        telemetry.disable()
        net.set_listeners()
        ms = [t * 1e3 for t in rec.times]
        res.update(
            scores=rec.scores, step_ms=ms,
            # steady steps: after step 1, without ZeRO's checkpoint write
            steady_ms=statistics.median((ms[1:2] if mode == "zero"
                                         else ms[1:]) or ms),
            param_bytes=sum(v.numel() * v.element_size()
                            for vp in net.params.values()
                            for v in vp.values()),
            # step 1's peak: through its gradient pass, and after it (the
            # exchange and the update)
            peak_mb=max(res.get("peak_backward_mb") or 0.0,
                        rec.peak1_mb or 0.0) if on_card else None,
            peak_exchange_mb=rec.peak1_mb,
            digest=_digest(net.params, net.state, net.opt_state),
            replicas=rec.replicas,
            taus=[] if pw._tau is None else [float(pw._tau)],
            bytes={k: v for k, v in metrics.items()
                   if k.startswith(("dl4j_collective_bytes_total",
                                    "dl4j_collective_ops_total"))})
        if "flips" in needs:
            kept[mode] = {"enc": enc_log["step1"],
                          "params1": rec.trees[0][0]}
        if mode == "zero" and rank == 0:
            saved = ckpt.last_checkpoint()
            restored = ckpt.load_checkpoint_graph(saved.number, device=dev)
            res["zip_iteration"] = saved.iteration
            res["zip_restores"] = gathered.digest == _digest(
                restored.params, restored.state, restored.opt_state)
            del restored
        if cmp == "fit" and rank == 0:
            ref = ComputationGraph(net.conf, device=dev).set_params(p0, s0)
            ref_rec = _Steps(torch, keep_all=True)
            ref.set_listeners(ref_rec)
            ref.fit(ListDataSetIterator(glob[:steps]))
            ref.set_listeners()
            ref_trees = ref_rec.trees
            res["fit_step_ms"] = [t * 1e3 for t in ref_rec.times]
            res["fit_scores"] = ref_rec.scores
            res["per_step"] = [{
                "params": _max_diff(a[0], b[0]),
                "state": _max_diff(a[1], b[1]),
                "opt": _max_diff(a[2], b[2]),
                "same_bits": (_same_bits(a[0], b[0]) and _same_bits(a[1], b[1])
                              and _same_bits(a[2], b[2]))}
                for a, b in zip(rec.trees, ref_trees)]
            res["gates"] = _gates(
                _first_moment(rec.trees[0][2]),
                _first_moment(ref_trees[0][2]), rec.trees[0][1],
                ref_trees[0][1], rec.scores, ref_rec.scores)
            del ref, ref_trees
        if rec.trees and cmp != "fit":
            kept.setdefault(mode, {})["first"] = rec.trees[0]
            kept[mode]["scores"] = rec.scores
        if isinstance(cmp, tuple) and cmp[0] == "route" and rank == 0:
            base = kept[cmp[1]]
            res["gates"] = _gates(
                _first_moment(base["first"][2]),
                _first_moment(rec.trees[0][2]), base["first"][1],
                rec.trees[0][1], base["scores"], rec.scores)
        rec.trees.clear()
        out[mode] = res
    wrapper_mod.encode_tree = real_encode
    profile = (_profile(torch, cfg["profile"], nets["kernel"], p0, s0, glob,
                        parts) if on_card and cfg.get("profile") else None)
    return {"rank": rank, "world": world, "modes": out, "profile": profile,
            "collective_ms": _exchange_ms(torch, nets["kernel"].params,
                                          dev),
            "comms": comms.stats()}


def _split_peak(torch, pw, res, census=False):
    """Step 1's peak memory split at the end of its gradient pass: what is
    allocated as the pass starts, the peak through it and what it leaves
    allocated (with ``census``, the storages Python holds then) go into
    ``res``, and the peak counter restarts for the exchange and the
    update."""
    real = pw._gradients

    def gradients(*args, **kwargs):
        if "before_backward_mb" not in res:
            res["before_backward_mb"] = torch.cuda.memory_allocated() / 2 ** 20
        out = real(*args, **kwargs)
        if "peak_backward_mb" not in res:
            torch.cuda.synchronize()
            res["peak_backward_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
            res["after_backward_mb"] = torch.cuda.memory_allocated() / 2 ** 20
            if census:
                res["live_after_backward"] = _live_storages(torch)
            torch.cuda.reset_peak_memory_stats()
        return out

    pw._gradients = gradients


def _live_storages(torch, floor_mib=1.0):
    """The CUDA storages that Python tensors hold now, of at least
    ``floor_mib``: their total MiB and the largest, by size, as
    ``[MiB, count, a shape viewing one]`` (storages held only by C++, such
    as an autograd graph's saved tensors, are not seen)."""
    seen, sizes = set(), {}
    with warnings.catch_warnings():  # deprecated module proxies warn
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects() if torch.is_tensor(o)]
    for obj in tensors:
        if not obj.is_cuda:
            continue
        st = obj.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        mib = st.nbytes() / 2 ** 20
        if mib >= floor_mib:
            key = round(mib, 1)
            n, shape = sizes.get(key, (0, tuple(obj.shape)))
            sizes[key] = (n + 1, shape)
    top = sorted(sizes.items(), key=lambda kv: -kv[0] * kv[1][0])[:8]
    return {"mib": sum(k * n for k, (n, _) in sizes.items()),
            "top": [[k, n, list(shape)] for k, (n, shape) in top]}


@contextlib.contextmanager
def _forced_global_batch():
    """Exact mode's global-batch collectives at one rank, where the
    wrapper skips them (every sum is the identity there): the cost they
    had."""
    from deeplearning4j_tpu_torch.comms import global_batch as gb

    real = gb.global_batch

    @contextlib.contextmanager
    def forced(group, local_rows, global_rows):
        token = gb._ACTIVE.set(gb.GlobalBatch(group, 0, 1, int(local_rows),
                                              int(global_rows)))
        try:
            yield
        finally:
            gb._ACTIVE.reset(token)

    gb.global_batch = forced
    try:
        yield
    finally:
        gb.global_batch = real


def _trace(torch, run, steps):
    """``run(k)`` trains k steps: its CUDA-synced wall ms a step, then one
    ``torch.profiler`` trace of ``steps`` more: device ms a step (kernel
    durations summed), kernel launches, the kernels with the most device
    time, and the ops with the most host (self CPU) time a step."""
    from torch.profiler import ProfilerActivity, profile

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / steps * 1e3
    kernels, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.device_time > 0:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time
            launches += 1
    cpu = {e.key: e.self_cpu_time_total / steps / 1e3
           for e in prof.key_averages()}
    calls = {e.key: e.count / steps for e in prof.key_averages()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "traced_wall_ms": traced,
            "device_ms": sum(kernels.values()) / steps / 1e3,
            "launches_per_step": launches / steps,
            "top_kernels": [[n[:60], us / steps / 1e3] for n, us in top],
            "cpu_ms": cpu, "calls": calls,
            "nccl_device_ms": sum(us for n, us in kernels.items()
                                  if "nccl" in n.lower()) / steps / 1e3}


def _profile(torch, variants, net, p0, s0, glob, parts):
    """One trace a variant on the kernel route: ``fit`` (plain
    ``fit`` on the global batch), ``exact``, ``exact_forced`` (exact with
    the global-batch collectives a one-rank run skips) and ``bucketed25``
    through ``ParallelWrapper.fit``. Host-op differences against the
    first variant are summarized by the parent."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net.set_params(p0, s0)
    net.set_listeners()
    out = {}
    for name in variants:
        if name == "fit":
            def run(k):
                net.fit(ListDataSetIterator(glob[:k]))
        else:
            kw = {"gradient_bucket_mb": DP_BUCKET_MB} if name == \
                "bucketed25" else {}
            pw = ParallelWrapper(net, prefetch_buffer=0, **kw)

            def run(k, pw=pw):
                pw.fit(ListDataSetIterator(parts[:k]))
        if name == "exact_forced":
            with _forced_global_batch():
                out[name] = _trace(torch, run, DP_STEPS)
        else:
            out[name] = _trace(torch, run, DP_STEPS)
    return out


def _profile_line(tag, prof, smi):
    """Print each variant's wall, device and launch figures, and the host
    ops whose time a step grew the most against the first variant; return
    the figures without the per-op tables (None without a trace)."""
    if not prof:
        return None
    names = list(prof)
    base = prof[names[0]]
    for name in names:
        v = prof[name]
        _log(f"[{tag}] profile {name}: wall {v['wall_ms']:.2f} ms a step "
             f"(traced {v['traced_wall_ms']:.2f}), device "
             f"{v['device_ms']:.2f} ms (NCCL kernels "
             f"{v['nccl_device_ms']:.2f}), {v['launches_per_step']:.0f} "
             f"kernel launches, top kernels "
             f"{[[n, round(ms, 3)] for n, ms in v['top_kernels'][:3]]} "
             f"[{smi}]")
        if name == names[0]:
            continue
        grew = sorted(((v["cpu_ms"][k] - base["cpu_ms"].get(k, 0.0), k)
                       for k in v["cpu_ms"]), reverse=True)[:8]
        _log(f"[{tag}] profile {name} - {names[0]}: host ms a step by op "
             + ", ".join(f"{k} {d:+.2f} ({v['calls'][k] - base['calls'].get(k, 0):+.0f} calls)"
                         for d, k in grew))
    return {n: {k: v for k, v in prof[n].items()
                if k not in ("cpu_ms", "calls")} for n in names}


def _exchange_ms(torch, params, dev):
    """CUDA-event ms (median of 3) of one exchange of a gradient-sized
    tree: the all-reduce fused and at 25 MB buckets, ZeRO's reduce-scatter
    and all-gather at 25 MB."""
    from deeplearning4j_tpu_torch import comms
    from deeplearning4j_tpu_torch.sharding import ZeroSpec

    sched = comms.scheduler
    n, r = sched.world_of(), sched.rank_of()
    grads = {k: {pk: torch.zeros_like(v) for pk, v in vp.items()}
             for k, vp in params.items()}
    spec = ZeroSpec(grads, n)
    flat, slices = spec.flat_padded(grads), spec.local_slices(grads, r)
    b25 = DP_BUCKET_MB * 2 ** 20
    cases = {
        "all_reduce_fused": lambda: comms.exchange(grads, "all_reduce"),
        "all_reduce_25mb": lambda: comms.exchange(grads, "all_reduce",
                                                  bucket_bytes=b25),
        "reduce_scatter_25mb": lambda: comms.exchange(
            flat, "reduce_scatter", bucket_bytes=b25),
        "all_gather_25mb": lambda: comms.exchange(
            slices, "all_gather", bucket_bytes=b25,
            full_sizes=spec.padded_sizes),
    }
    out = {}
    for name, fn in cases.items():
        fn()
        times = []
        for _ in range(3):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


# --------------------------------------------------------------------------
# the parent: spawn, gate, print
# --------------------------------------------------------------------------

def _median_after_first(ms):
    return statistics.median(ms[1:]) if len(ms) > 1 else ms[0]


def _check(cond, msg, failures):
    """Note a failed gate; the phase raises once everything is printed."""
    if not cond:
        _log(f"[26] FAIL: {msg}")
        failures.append(msg)


def _report_fit(tag, res, smi):
    ps = res["per_step"]
    _log(f"[{tag}] vs ComputationGraph.fit at the global batch, per step: "
         + "; ".join(f"step {i + 1}: params {d['params']:.3e}, BN state "
                     f"{d['state']:.3e}, updater state {d['opt']:.3e}"
                     f"{' (same bits)' if d['same_bits'] else ''}"
                     for i, d in enumerate(ps)))
    g = res["gates"]
    _log(f"[{tag}] [7]'s gates: step-1 gradients global L2 "
         f"{g['grad_global_l2']:.3e} (tol {cs.TRAIN_GRAD_L2['global']}), "
         f"worst tensor {g['grad_tensor_l2']}, max-relative "
         f"{g['grad_tensor_maxrel']}; BN state after step 1 "
         f"{g['state_rel_err']:.3e} (tol {cs.TRAIN_STATE_RTOL}); losses "
         f"{[f'{v:.3e}' for v in g['loss_rel_err']]} (tol "
         f"{cs.TRAIN_LOSS_RTOL}): {'pass' if g['ok'] else 'FAIL'}")
    _log(f"[{tag}] step ms (median after step 1): wrapper "
         f"{_median_after_first(res['step_ms']):.2f}, plain fit "
         f"{_median_after_first(res['fit_step_ms']):.2f} [{smi}]")


def _bytes_per_step(res, op):
    key = f'dl4j_collective_bytes_total{{op="{op}"}}'
    return res["bytes"].get(key, 0.0) / res["steps"]


def _gate_launches(tag, results, mode, cfg, failures):
    if cfg["device"] != "cuda":
        return  # the CPU runs the kernels' plain versions: no launches
    for r in results:
        res = r["modes"][mode]
        want = 36 * res["steps"]
        _check(res["launches"] == want,
               f"{tag} {mode}: rank {r['rank']} launched matmul_stats "
               f"{res['launches']} times, expected {want}", failures)


def nccl_set(torch, smi, world, cfg, failures):
    """[26a]: exact and bucketed exact over NCCL, against fit."""
    from deeplearning4j_tpu_torch.parallel import spawn

    t0 = time.monotonic()
    # a CPU rehearsal has no NCCL: gloo takes its place there
    # the trace: plain fit, exact, and exact with the global-batch
    # collectives that one rank skips (at more ranks the [26b] set traces)
    profile = (("fit", "exact", "exact_forced")
               if world == 1 and cfg.get("trace") else None)
    results = spawn(run_ranks, world,
                    ({**cfg, "modes": NCCL_MODES, "profile": profile},),
                    backend="nccl" if cfg["device"] == "cuda" else "gloo",
                    device=cfg["device"], timeout=DP_TIMEOUT)
    r0 = results[0]["modes"]
    line = {"ranks": world, "seconds": time.monotonic() - t0, "modes": {}}
    for mode in ("exact", "bucketed25"):
        res = r0[mode]
        _report_fit(f"26a {mode}", res, smi)
        _check(res["gates"]["ok"], f"26a {mode} fails [7]'s gates: "
               f"{res['gates']}", failures)
        _gate_launches("26a", results, mode, cfg, failures)
        line["modes"][mode] = {
            "gates": res["gates"], "per_step": res["per_step"],
            "step_ms": _median_after_first(res["step_ms"]),
            "fit_step_ms": _median_after_first(res["fit_step_ms"]),
            "bytes_per_step": _bytes_per_step(res, "grad_psum"),
            "launches_per_rank": [r["modes"][mode]["launches"]
                                  for r in results],
            "peak_mb": res["peak_mb"]}
    line["collective_ms"] = results[0]["collective_ms"]
    _log(f"[26a] NCCL x {world}: collective ms {line['collective_ms']} "
         f"[{smi}]")
    line["profile"] = _profile_line("26a", results[0]["profile"], smi)
    return line


def gloo_set(torch, smi, world, cfg, failures, backend="gloo",
             tag="26b"):
    """[26b]: every mode over ``world`` ranks (two gloo ranks sharing
    cuda:0 on one card)."""
    from deeplearning4j_tpu_torch.parallel import spawn

    t0 = time.monotonic()
    # the trace: bucketed exact (per-rank BN statistics, no global-batch
    # collectives) against exact, the same ranks and rows
    results = spawn(run_ranks, world,
                    ({**cfg, "modes": GLOO_MODES,
                      "profile": (("bucketed25", "exact")
                                  if cfg.get("trace") else None)},),
                    backend=backend, device=cfg["device"],
                    timeout=DP_TIMEOUT)
    modes = [r["modes"] for r in results]
    r0 = modes[0]
    line = {"ranks": world, "backend": backend,
            "seconds": time.monotonic() - t0, "modes": {}}
    # exact against fit, and the planted control
    _report_fit(f"{tag} exact", r0["exact"], smi)
    _check(r0["exact"]["gates"]["ok"],
           f"{tag} exact fails [7]'s gates: {r0['exact']['gates']}",
           failures)
    _gate_launches(tag, results, "exact", cfg, failures)
    ctl = r0["control"]["gates"]
    _log(f"[{tag}] planted control, per-rank BN statistics: step-1 "
         f"gradients global L2 {ctl['grad_global_l2']:.3e}, BN state "
         f"{ctl['state_rel_err']:.3e}, loss {ctl['loss_rel_err']}: "
         f"{'caught' if not ctl['ok'] else 'NOT caught'}")
    _check(not ctl["ok"], f"{tag}: per-rank BN statistics pass the exact "
           f"gates: the gates do not see the BN semantics", failures)
    # bits across bucket sizes and ZeRO, per rank
    for m in modes:
        _check(m["bucketed0"]["digest"] == m["bucketed25"]["digest"],
               f"{tag}: gradient_bucket_mb 0 and {DP_BUCKET_MB} differ",
               failures)
        _check(m["zero"]["digest"] == m["bucketed25"]["digest"],
               f"{tag}: ZeRO differs from bucketed exact", failures)
    _check(r0["zero"]["zip_restores"] and r0["zero"]["zip_iteration"] == 1,
           f"{tag}: the mid-fit ZeRO zip does not restore to the gathered "
           f"state ({r0['zero'].get('zip_iteration')})", failures)
    same = [(m["bucketed0"]["digest"] == m["bucketed25"]["digest"],
             m["zero"]["digest"] == m["bucketed25"]["digest"]) for m in modes]
    _log(f"[{tag}] per rank, bucketed exact {DP_BUCKET_MB} MB and 0 MB the "
         f"same bits / ZeRO ({DP_BUCKET_MB} MB buckets) the bucketed bits "
         f"(params, BN state, gathered Adam state): {same}; the "
         f"CheckpointListener zip of iteration "
         f"{r0['zero'].get('zip_iteration')} restores to the gathered "
         f"state: {r0['zero'].get('zip_restores')}")
    for mode, base in (("bucketed25_stock", "bucketed25"),
                       ("averaging_stock", "averaging")):
        g = r0[mode]["gates"]
        _log(f"[{tag}] {base} kernel vs stock route: step-1 gradients "
             f"global L2 {g['grad_global_l2']:.3e}, worst tensor "
             f"{g['grad_tensor_l2']}, BN state {g['state_rel_err']:.3e}, "
             f"losses {[f'{v:.3e}' for v in g['loss_rel_err']]}: "
             f"{'pass' if g['ok'] else 'FAIL'}")
        _check(g["ok"], f"{tag} {base}: kernel vs stock fails [7]'s gates",
               failures)
    # threshold: flipped messages, the params outside them
    for mode in ("threshold_fixed", "threshold_adaptive"):
        stock = f"{mode}_stock"
        for m in modes:
            s = m[stock]
            _check(s["flip_share"] <= THRESHOLD_FLIP_SHARE,
                   f"{tag} {mode}: {s['flip_share']:.3e} of the messages "
                   f"flip between the routes (<= {THRESHOLD_FLIP_SHARE})",
                   failures)
            _check(s["params_differ_outside_flips"] == 0,
                   f"{tag} {mode}: {s['params_differ_outside_flips']} "
                   f"params differ where every rank's message agrees",
                   failures)
        lk, ls = r0[mode]["scores"], r0[stock]["scores"]
        loss = [abs(a - b) / abs(b) for a, b in zip(lk, ls)]
        _check(loss[0] <= cs.TRAIN_LOSS_RTOL[0]
               and max(loss) <= cs.TRAIN_LOSS_RTOL[1],
               f"{tag} {mode}: losses {lk} vs {ls}", failures)
        _log(f"[{tag}] {mode}: messages flipped kernel vs stock "
             f"{[m[stock]['flip_share'] for m in modes]} per rank (any "
             f"rank: {r0[stock]['shared_flip_share']:.3e}; <= "
             f"{THRESHOLD_FLIP_SHARE}), params outside them the same bits, "
             f"losses {[f'{v:.3e}' for v in loss]}; tau kernel "
             f"{r0[mode]['taus']} stock {r0[stock]['taus']}")
    # averaging: the replicas after each average
    for mode in ("averaging", "averaging_stock"):
        reps = [m[mode]["replicas"] for m in modes]
        for step in range(DP_AVG_STEPS):
            same = len({r[step] for r in reps}) == 1
            if (step + 1) % DP_AVG_FREQ == 0:
                _check(same, f"{tag} {mode}: replicas differ after the "
                       f"average of step {step + 1}", failures)
        agree = [s + 1 for s in range(DP_AVG_STEPS)
                 if len({r[s] for r in reps}) == 1]
        _log(f"[{tag}] {mode}: replicas the same bits after steps {agree}")
    # reported: step ms, bytes, memory, collectives, host stages
    for mode in r0:
        res = r0[mode]
        op = ("threshold_psum" if mode.startswith("threshold")
              else "grad_reduce_scatter" if mode == "zero"
              else "average" if mode.startswith("averaging")
              else "grad_psum")
        line["modes"][mode] = {
            "route": res["route"],
            "step_ms": res["steady_ms"],
            "bytes_per_step": _bytes_per_step(res, op),
            "peak_mb_rank": [m[mode]["peak_mb"] for m in modes],
            "peak_backward_mb_rank": [m[mode].get("peak_backward_mb")
                                      for m in modes],
            "after_backward_mb_rank": [m[mode].get("after_backward_mb")
                                       for m in modes],
            "before_backward_mb_rank": [m[mode].get("before_backward_mb")
                                        for m in modes],
            "peak_exchange_mb_rank": [m[mode].get("peak_exchange_mb")
                                      for m in modes],
            "base_mb_rank": [m[mode].get("base_mb") for m in modes],
            "launches_per_rank": [m[mode]["launches"] for m in modes]}
        if "gates" in res:
            line["modes"][mode]["gates"] = res["gates"]
    grad_bytes = r0["exact"]["param_bytes"]
    _check(grad_bytes == RESNET_PARAM_BYTES or cfg["model"],
           f"{tag}: ResNet-50's gradients are {grad_bytes} bytes, expected "
           f"{RESNET_PARAM_BYTES}", failures)
    for mode in ("exact", "bucketed25", "threshold_fixed"):
        got = line["modes"][mode]["bytes_per_step"]
        _check(got == grad_bytes,
               f"{tag} {mode}: telemetry counts {got} bytes a step, the "
               f"gradients are {grad_bytes}", failures)
    line["gradient_bytes"] = grad_bytes
    _log(f"[{tag}] step ms per mode (median after step 1; {world} ranks "
         f"share the card's SMs: not a scaling figure): "
         + ", ".join(f"{k} {v['step_ms']:.1f}"
                     for k, v in line["modes"].items()) + f" [{smi}]")
    _log(f"[{tag}] exchange bytes a step: "
         + ", ".join(f"{k} {v['bytes_per_step']:.0f}"
                     for k, v in line["modes"].items()))
    peak = {k: v["peak_mb_rank"] for k, v in line["modes"].items()}
    if cfg["device"] == "cuda":
        # step 1's peak, and what was allocated before the mode's fit
        # (both routes' nets: params, updater state); the last rank keeps
        # no copies for the comparisons
        base = {k: v["base_mb_rank"] for k, v in line["modes"].items()}
        line["zero_peak_saving_mb"] = peak["exact"][-1] - peak["zero"][-1]
        rise = {k: [p - b for p, b in zip(peak[k], base[k])] for k in peak}
        line["zero_rise_saving_mb"] = rise["exact"][-1] - rise["zero"][-1]
        _log(f"[{tag}] step-1 peak MiB per rank: {peak}; allocated before "
             f"the fit: {base}; ZeRO's peak below exact's on rank "
             f"{world - 1} by {line['zero_peak_saving_mb']:.1f} MiB, its "
             f"rise over the allocation before the fit by "
             f"{line['zero_rise_saving_mb']:.1f} MiB")
        for mode in ("exact", "bucketed25", "zero"):
            v = line["modes"][mode]
            _log(f"[{tag}] {mode} step 1 MiB per rank: allocated as the "
                 f"gradient pass starts {v['before_backward_mb_rank']}, "
                 f"peak through it {v['peak_backward_mb_rank']}, allocated "
                 f"after it {v['after_backward_mb_rank']}, peak after it "
                 f"(exchange, update) {v['peak_exchange_mb_rank']}"
                 + (f"; rank 0's Python-held storages after the pass: "
                    f"{r0[mode]['live_after_backward']}"
                    if "live_after_backward" in r0[mode] else ""))
    line["profile"] = _profile_line(tag, results[0]["profile"], smi)
    line["collective_ms"] = results[0]["collective_ms"]
    line["comms"] = [r["comms"] for r in results]
    _log(f"[{tag}] collective ms (CUDA events, one gradient-sized exchange): "
         f"{line['collective_ms']}; host-staged gloo collectives per rank: "
         f"{[r['comms']['host_staged'] for r in results]} [{smi}]")
    return line


def data_parallel_phase(torch, smi, cfg=None):
    """[26] on the card (``cfg`` shrinks it for a rehearsal on the CPU).
    Returns the ``{"data_parallel": ...}`` line and row 2's entry for the
    kernels line."""
    cfg = {"device": "cuda", "batch": DP_BATCH, "model": {}, "trace": False,
           **(cfg or {})}
    world = torch.cuda.device_count() if cfg["device"] == "cuda" else 1
    t0 = time.monotonic()
    failures = []
    line = {"card": smi, "batch": cfg["batch"]}
    line["nccl"] = nccl_set(torch, smi, world, cfg, failures)
    line["gloo_shared_card"] = gloo_set(torch, smi, 2, cfg, failures)
    if world >= 2:
        line["nccl_multi"] = gloo_set(torch, smi, world, cfg, failures,
                                      backend="nccl", tag="26b nccl")
    else:
        _log(f"[26] [26b]'s set over NCCL not run: {world} card here, and "
             f"NCCL refuses two ranks on one card")
    line["seconds"] = time.monotonic() - t0
    row = {"launches_per_rank_per_step": 36,
           "scope": (f"[26]: ResNet-50 fused_conv_bn trained through "
                     f"ParallelWrapper.fit, global batch {cfg['batch']}: "
                     f"NCCL x {world} (exact, bucketed), gloo x 2 on "
                     f"cuda:0 (every mode)"),
           "launches": {
               "nccl_exact_per_rank": line["nccl"]["modes"]["exact"][
                   "launches_per_rank"],
               "gloo_exact_per_rank": line["gloo_shared_card"]["modes"][
                   "exact"]["launches_per_rank"]}}
    _log(f"[26] total {line['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"[26] {len(failures)} gate(s) failed: "
                             + "; ".join(failures))
    return line, row


def main() -> int:
    """The phase alone: the card, the kernels' build, [26]; with
    ``--trace``, the profiler traces and the storage census too."""
    import json
    import sys

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.kernels import build, impls

    smi = cs.nvidia_smi_line()
    _log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    _log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
         f"{time.monotonic() - t0:.1f} s")
    line, row = data_parallel_phase(
        torch, smi, {"trace": "--trace" in sys.argv[1:]})
    _log(json.dumps({"data_parallel": line, "matmul_stats": row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
