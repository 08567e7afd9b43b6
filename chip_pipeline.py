#!/usr/bin/env python3
"""Phase [37] of ``chip_smoke.py``: pipeline-parallel training
(``parallel.pipeline.PipelineParallelWrapper``) on one H100.

NCCL puts one rank on a card, so the stages are gloo ranks sharing
``cuda:0`` (``parallel.launch.spawn``: one process group of four for the
whole phase), their hand-offs staged through the host.

- [37a] The GPT-2-small-width LM of [14] (``cs.GEN_MODEL``: 12 layers, d
  768, 12 heads, ff 3072, vocab 50257; float32, ``use_kernels``, Adam) at
  data 1 x pipeline 2 (ranks 0 and 1; 2 and 3 wait) with ``n_micro=4``, ``LM_STEPS`` steps of 8 x 1024
  tokens (``cs.lm_dataset``, no masks: the wrapper refuses them) under
  GPipe, then under 1F1B, each held against one-rank ``fit_batch`` on the
  same batches (rank 0 runs it first while rank 1 waits): every step's
  loss within ``LM_LOSS_RTOL``, the step-1 gradients (``cs.LM_GRAD_L2``
  global, ``cs.LM_GRAD_MAXREL`` per tensor; ``bk``'s, 0 in exact
  arithmetic, skipped) and Adam's moments after step 1
  (``cs.TRAIN_STATE_RTOL``), gathered from the stages through the
  wrapper's gradient hook; 1F1B against GPipe at the same gates. Rows 6-8
  launch once a microbatch for each attention layer of the rank's stage.
  The control (every stage skips the last microbatch's backward) must
  miss the gates. Reported: step ms per schedule beside one rank's, the
  hand-offs a step (sends, bytes, wall ms), host-staged operations, and
  each rank's peak MiB under both schedules at M 4 (the gated runs) and
  M 8 (2-row microbatches, one step).
- [37b] LeNet (``MultiLayerNetwork``, ``use_kernels``, Adam) at data 2 x
  pipeline 2 on four gloo ranks, M 4, ``LENET_STEPS`` steps of 64 through
  ``fit`` against one-rank ``fit_batch`` at [7]'s step-1 gradient gates
  and ``cs.TRAIN_LOSS_RTOL``; row 1 runs on the dense layer's stage once a
  microbatch at (8, 2450, 500, relu); after ``fit`` (its ``write_back``)
  every rank holds the same params.

``python3 chip_pipeline.py`` builds the kernels and runs [37] alone. To
rehearse on the CPU: ``pipeline_phase(torch, torch.device("cpu"), smi,
overrides={...}, device="cpu")`` with a small ``LM`` and batches (the
launch counts are not held there: the wrappers count nothing on the
CPU).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import chip_smoke as cs
from chip_sharding import (
    _clone_tree,
    _digest,
    _grad_gates,
    _lenet_batches,
    _log,
    _losses_ok,
    _state_errors,
    _sync,
)

LM = dict(cs.GEN_MODEL)   # GPT-2 small's widths, 12 layers
LM_BATCH = cs.LM_BATCH    # 8 rows of 1024 tokens
LM_STEPS = 3
N_MICRO = 4
PEAK_MICRO = 8            # the peak-memory runs: 2-row microbatches
# microbatched against one batch: the same float32 sums in another order
LM_LOSS_RTOL = 1e-5
LENET_BATCH = 64
LENET_STEPS = 3
TIMEOUT = 600.0






def _mib(torch, dev, what: str) -> float:
    if dev.type != "cuda":
        return 0.0
    fn = (torch.cuda.max_memory_allocated if what == "peak"
          else torch.cuda.memory_allocated)
    return fn() / 2 ** 20




def _gather_stages(torch, pw, mine: dict, like) -> dict:
    """Every stage's entries of a {key: tree} dict on the pipeline's stage
    0 (``like(key)``: a tree of that key's shapes there); one flat
    point-to-point message a stage."""
    from deeplearning4j_tpu_torch.comms import scheduler

    m = pw.mesh
    if pw.n_stages == 1:
        return dict(mine)
    out = dict(mine) if pw.stage == 0 else {}
    for s in range(1, pw.n_stages):
        keys = list(pw.stage_keys[s]) + (
            [pw._head_key] if s == pw.n_stages - 1 else [])
        keys = [k for k in keys if k in pw.model.params]
        if pw.stage == s:
            leaves = scheduler.tree_leaves({k: mine[k] for k in keys})
            flat = torch.cat([t.detach().reshape(-1).float()
                              for t in leaves])
            scheduler.p2p([(m.stage_rank(0), flat)], [])
        elif pw.stage == 0:
            tree = {k: like(k) for k in keys}
            leaves, spec = scheduler.tree_flatten(tree)
            flat = torch.empty(sum(t.numel() for t in leaves),
                               device=leaves[0].device)
            scheduler.p2p([], [(m.stage_rank(s), flat)])
            got, off = [], 0
            for t in leaves:
                got.append(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()
            out.update(scheduler.tree_unflatten(spec, got))
    return out






def _fresh(base):
    """A network with ``base``'s configuration, params and state (copied
    on its device) and a fresh updater: what ``init`` gives, without
    drawing the weights again."""
    return type(base)(base.conf, device=base.device).set_params(
        base.params, base.state)


def _reference(torch, base, dev, batches) -> dict:
    """One-rank ``fit_batch`` on the batches from ``base``'s weights: the
    step-1 gradients, every loss, Adam's state after step 1, step ms."""
    ref = _fresh(base)
    grads, _ = ref.compute_gradient_and_score(batches[0])
    losses, opt1, step_ms = [], None, []
    for ds in batches:
        _sync(torch, dev)
        t0 = time.monotonic()
        losses.append(ref.fit_batch(ds))
        step_ms.append((time.monotonic() - t0) * 1e3)
        if opt1 is None:
            opt1 = _clone_tree(ref.opt_state)
    return {"grads": grads, "losses": losses, "opt1": opt1,
            "step_ms": step_ms}


def _held(ref, run, loss_rtol) -> dict:
    """A run's gates against a reference run (both on rank 0)."""
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               ref["losses"])]
    grad = _grad_gates(run["grads"], ref["grads"], cs.LM_GRAD_L2["global"],
                       cs.LM_GRAD_MAXREL)
    opt = _state_errors(run["opt1"], ref["opt1"], cs.LM_ZERO_GRADS)
    return {"loss_rel": rel, "loss_ok": all(r <= loss_rtol for r in rel),
            "grad": grad, "opt1": opt,
            "opt_ok": opt["worst"][0] <= cs.TRAIN_STATE_RTOL}


def _train(torch, dev, net, mesh, batches, schedule, n_micro, gather=True):
    """``n_micro`` microbatches a step of ``schedule`` over ``batches``
    (``fit_batch`` each): losses, step ms, hand-offs, peak MiB; on the
    first stage with ``gather`` the step-1 gradients and Adam state of
    every stage."""
    from deeplearning4j_tpu_torch.comms import scheduler
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallelWrapper,
    )

    pw = PipelineParallelWrapper(net, n_micro=n_micro, mesh=mesh,
                                 schedule=schedule)
    cap = {}

    def hook(grads):
        if "grads" not in cap:
            cap["grads"] = _clone_tree(grads)

    pw._on_grads = hook
    staged0 = dict(scheduler.stats()["host_staged"])
    # what earlier runs left in reference cycles goes now, not while this
    # run's peak is read
    gc.collect()
    _sync(torch, dev)
    base = _mib(torch, dev, "now")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, steps = [], [], []
    for i, ds in enumerate(batches):
        _sync(torch, dev)
        t0 = time.monotonic()
        losses.append(pw.fit_batch(ds))
        _sync(torch, dev)
        step_ms.append((time.monotonic() - t0) * 1e3)
        steps.append(dict(pw.last_step))
        if i == 0:
            cap["opt1"] = _clone_tree(pw._opt)
    peak = _mib(torch, dev, "peak")
    staged = {k: v - staged0.get(k, 0)
              for k, v in scheduler.stats()["host_staged"].items()}
    out = {"losses": losses, "step_ms": step_ms, "steps": steps,
           "host_staged": staged, "peak_mib": peak,
           "peak_over_base_mib": peak - base,
           "stage_keys": [list(k) for k in pw.stage_keys],
           "crossings": [list(c) for c in pw._crossings]}
    if gather:
        m = net
        out["grads"] = _gather_stages(
            torch, pw, cap["grads"],
            lambda k: {p: torch.empty_like(v) for p, v in m.params[k].items()})
        out["opt1"] = _gather_stages(
            torch, pw, cap["opt1"],
            lambda k: {p: {s: torch.empty_like(v) for s, v in
                           m._layer_updater(k)[1].init_state(v).items()}
                       for p, v in m.params[k].items()})
    return out


def _skip_last_backward():
    """The control: every stage drops the last microbatch's backward (no
    hand-off either side, so the ranks stay matched)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallelWrapper,
    )

    real = PipelineParallelWrapper._bwd_op

    def bwd(self, m):
        if m == self.n_micro - 1:
            self._live.pop(m)
            return
        real(self, m)

    PipelineParallelWrapper._bwd_op = bwd
    return real


def lm_rank(torch, dev, rank, card, mesh, pair) -> dict:
    """[37a] on this rank of ``mesh`` (data 1 x pipeline 2 over the
    subgroup ``pair``): the reference (rank 0, while rank 1 waits), GPipe,
    1F1B, the control, the peak-memory runs."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallelWrapper,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    marks = [("start", time.monotonic())]
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=cs.GEN_SEED, **LM)
    base = ComputationGraph(zoo.conf(), device=dev).init()
    t = LM["max_len"]
    batches = [cs.lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH, t,
                             cs.LM_SEED + i) for i in range(LM_STEPS)]
    marks.append(("init", time.monotonic()))
    ref = _reference(torch, base, dev, batches) if rank == 0 else None
    _sync(torch, dev)
    dist.barrier(group=pair)
    marks.append(("reference", time.monotonic()))
    out = {"stage": mesh.stage}
    runs = {}
    for schedule in ("gpipe", "1f1b"):
        net = _fresh(base)
        cs._reset_attention_launches(att)
        # ---- the main path: counts from here on belong to it ----
        run = _train(torch, dev, net, mesh, batches, schedule, N_MICRO)
        _sync(torch, dev)
        run["launches"] = cs._attention_launches(att)
        # ---- end of the main path ----
        attn = sum(1 for k in run["stage_keys"][mesh.stage]
                   if k.endswith("_attn"))
        run["attention_layers"] = attn
        runs[schedule] = run
        marks.append((schedule, time.monotonic()))
        if schedule == "gpipe":
            gpipe_net = net
        else:
            del net
    for schedule, run in runs.items():
        out[schedule] = {k: v for k, v in run.items()
                         if k not in ("grads", "opt1")}
    if rank == 0:
        for schedule in ("gpipe", "1f1b"):
            out[schedule]["held"] = _held(ref, runs[schedule], LM_LOSS_RTOL)
        out["1f1b"]["vs_gpipe"] = _held(runs["gpipe"], runs["1f1b"],
                                        LM_LOSS_RTOL)
        out["one_rank_step_ms"] = ref["step_ms"]
        out["ref_losses"] = ref["losses"]
    for run in runs.values():
        run.pop("grads", None)
        run.pop("opt1", None)
    if card:
        torch.cuda.empty_cache()
    # the control: the last microbatch's backward dropped on every stage
    real = _skip_last_backward()
    try:
        cnet = _fresh(base)
        crun = _train(torch, dev, cnet, mesh, batches[:1], "gpipe", N_MICRO)
    finally:
        PipelineParallelWrapper._bwd_op = real
    marks.append(("control", time.monotonic()))
    if rank == 0:
        held = _held(ref, crun, LM_LOSS_RTOL)
        out["control"] = {"loss_rel": held["loss_rel"],
                          "grad": held["grad"],
                          "caught": not (held["loss_ok"]
                                         and held["grad"]["ok"])}
    del cnet, crun, ref, base
    if card:
        torch.cuda.empty_cache()
    # the peak at 2-row microbatches, M 8, one step a schedule
    big = [cs.lm_dataset(torch, dev, zoo.vocab_size,
                         LM_BATCH * PEAK_MICRO // N_MICRO, t, cs.LM_SEED)]
    out["peak_m8"] = {}
    for schedule in ("gpipe", "1f1b"):
        if card:
            torch.cuda.empty_cache()
        run = _train(torch, dev, gpipe_net, mesh, big, schedule, PEAK_MICRO,
                     gather=False)
        out["peak_m8"][schedule] = {
            "peak_mib": run["peak_mib"],
            "peak_over_base_mib": run["peak_over_base_mib"],
            "step_ms": run["step_ms"][0],
            "max_in_flight": run["steps"][0]["max_in_flight"]}
    marks.append(("peak_m8", time.monotonic()))
    out["marks"] = marks
    del gpipe_net, big, batches
    return out






def _lenet_conf():
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    return dataclasses.replace(LeNet().conf(), use_kernels=True)


def _warm_lenet(torch, dev) -> None:
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_lenet_conf(), device=dev).init()
    net.fit_batch(_lenet_batches(torch, dev, 1,
                                 LENET_BATCH // N_MICRO // 2)[0])
    _sync(torch, dev)


def lenet_rank(torch, dev, rank, card) -> dict:
    """[37b] on this rank: LeNet at data 2 x pipeline 2 through ``fit``
    against one rank's ``fit_batch`` (rank 0 compares)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallelWrapper,
    )

    marks = [("start", time.monotonic())]
    conf = _lenet_conf()
    batches = _lenet_batches(torch, dev, LENET_STEPS, LENET_BATCH)
    base = MultiLayerNetwork(conf, device=dev).init()
    ref = _reference(torch, base, dev, batches) if rank == 0 else None
    _sync(torch, dev)
    dist.barrier()
    marks.append(("reference", time.monotonic()))
    mesh = mesh_mod.single_host_mesh(data=2, pipeline=2)
    marks.append(("mesh", time.monotonic()))
    net = _fresh(base)
    pw = PipelineParallelWrapper(net, n_micro=N_MICRO, mesh=mesh)
    cap, scores = {}, []
    pw._on_grads = lambda g: cap.setdefault("grads", _clone_tree(g))
    step = pw.fit_batch
    pw.fit_batch = lambda ds: scores.append(step(ds)) or scores[-1]
    impls.matmul_bias_act.launches = 0
    impls.matmul_bias_act.shapes.clear()
    # ---- the main path: counts from here on belong to it ----
    pw.fit(ListDataSetIterator(batches))
    _sync(torch, dev)
    launches = impls.matmul_bias_act.launches
    mm_shapes = dict(impls.matmul_bias_act.shapes)
    # ---- end of the main path ----
    marks.append(("fit", time.monotonic()))
    grads = None
    if mesh.data_rank == 0:
        grads = _gather_stages(
            torch, pw, cap["grads"],
            lambda k: {p: torch.empty_like(v)
                       for p, v in net.params[k].items()})
    out = {"stage": mesh.stage, "data_rank": mesh.data_rank,
           "row1_launches": launches,
           "row1_shapes": {str(k): v for k, v in mm_shapes.items()},
           "digest": _digest(net.params), "scores": scores,
           "stage_keys": [list(k) for k in pw.stage_keys], "marks": marks}
    if rank == 0:
        ok, rel = _losses_ok(scores, ref["losses"])
        out.update(loss_rel=rel, loss_ok=ok,
                   grad=_grad_gates(grads, ref["grads"],
                                    cs.TRAIN_GRAD_L2["global"],
                                    cs.TRAIN_GRAD_MAXREL))
    return out




def _parts(marks, t0) -> dict:
    """Seconds between a rank's marks, the first from ``t0``."""
    out, last = {}, t0
    for name, t in marks:
        out[name] = round(t - last, 2)
        last = t
    return out


def pipeline_rank(rank, world, overrides=None, device="cuda"):
    """One rank of [37] (one process group of four, so [37b] pays no
    second start-up): [37a] on ranks 0 and 1 while 2 and 3 wait, then
    [37b] on all four. ``overrides`` ({"module.NAME": value}) and
    ``device`` "cpu" rehearse it at a small size without a card."""
    import importlib

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod

    for key, value in (overrides or {}).items():
        mod, name = key.rsplit(".", 1)
        setattr(importlib.import_module(mod), name, value)
    serve_full_f32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = device == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if card
           else torch.device("cpu"))
    # [37a]'s grid: data 1 x pipeline 2 over ranks 0 and 1 (every rank
    # creates the subgroup); its data axis of one rank reduces nothing
    pair = dist.new_group([0, 1])
    out = {}
    if rank < 2:
        mesh = mesh_mod.Mesh(data=1, data_rank=0, pipeline=2,
                             pipeline_rank=rank, pipeline_group=pair)
        out["lm"] = lm_rank(torch, dev, rank, card, mesh, pair)
        if card:
            torch.cuda.empty_cache()
    else:
        # meanwhile the other two ranks pay their first CUDA work (cuDNN,
        # cuBLAS, the kernel library) on one LeNet step of [37b]'s
        # microbatch shape, outside every count and timing of [37]
        _warm_lenet(torch, dev)
    dist.barrier()
    out["lenet"] = lenet_rank(torch, dev, rank, card)
    return out


def pipeline_phase(torch, dev, smi, overrides=None, device="cuda") -> tuple:
    """[37]: the ``{"pipeline": ...}`` line and the kernels line's
    ``pipeline`` entries. Raises if a gate failed."""
    from deeplearning4j_tpu_torch.parallel.launch import spawn

    t_start = time.monotonic()
    ranks = spawn(pipeline_rank, 4, (overrides, device), timeout=TIMEOUT,
                  backend="gloo", device=device)
    lm = [r["lm"] for r in ranks[:2]]
    ln = [r["lenet"] for r in ranks]
    # seconds by part on rank 0 (the clock is the host's, shared by the
    # processes), the spawn to the rank's start first
    t_lenet = lm[0]["marks"][-1][1]
    t_lm = t_lenet - t_start
    parts = {"37a": _parts(lm[0]["marks"], t_start),
             "37b": _parts(ln[0]["marks"], t_lenet)}
    card = device == "cuda"
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    r0, r1 = lm
    for schedule in ("gpipe", "1f1b"):
        h = r0[schedule]["held"]
        check(h["loss_ok"], f"[37a] {schedule} losses {h['loss_rel']} "
                            f"outside {LM_LOSS_RTOL}")
        check(h["grad"]["ok"], f"[37a] {schedule} step-1 gradients "
                               f"{h['grad']}")
        check(h["opt_ok"], f"[37a] {schedule} Adam state after step 1 "
                           f"{h['opt1']}")
    v = r0["1f1b"]["vs_gpipe"]
    check(v["loss_ok"] and v["grad"]["ok"] and v["opt_ok"],
          f"[37a] 1F1B vs GPipe {v}")
    check(r0["control"]["caught"], f"[37a] the skipped-backward control "
                                   f"passed: {r0['control']}")
    for rank, r in enumerate(lm):
        for schedule in ("gpipe", "1f1b"):
            run = r[schedule]
            want = run["attention_layers"] * N_MICRO * LM_STEPS
            check(r["stage"] == rank, f"[37a] rank {rank} on stage "
                                      f"{r['stage']}")
            if card:
                for name, n in run["launches"].items():
                    check(n == want, f"[37a] rank {rank} {schedule}: {name} "
                                     f"launched {n} times, expected "
                                     f"{run['attention_layers']} x "
                                     f"{N_MICRO} x {LM_STEPS}")
            check(max(st["max_in_flight"] for st in run["steps"])
                  <= (N_MICRO if schedule == "gpipe" else 2 - rank),
                  f"[37a] rank {rank} {schedule} in flight "
                  f"{[st['max_in_flight'] for st in run['steps']]}")
    g0, g1 = r0["gpipe"], r1["gpipe"]
    o0, o1 = r0["1f1b"], r1["1f1b"]
    hg, ho = g0["held"], o0["held"]
    _log(f"[37a] GPT-2-small-width LM ({LM['n_layers']} layers) at data 1 "
         f"x pipeline 2, n_micro {N_MICRO}, {LM_STEPS} Adam steps of "
         f"{LM_BATCH} x {LM['max_len']}: stages {g0['stage_keys']} "
         f"(boundary 1 carries {g0['crossings'][1]}); losses GPipe "
         f"{[round(s, 6) for s in g0['losses']]}, 1F1B "
         f"{[round(s, 6) for s in o0['losses']]} vs one-rank fit_batch "
         f"{[round(s, 6) for s in r0['ref_losses']]} (rel {hg['loss_rel']} / "
         f"{ho['loss_rel']}, tol {LM_LOSS_RTOL}); step-1 gradients global "
         f"L2 {hg['grad']['global_l2']:.3e} / {ho['grad']['global_l2']:.3e},"
         f" worst max-rel {hg['grad']['worst_maxrel']} / "
         f"{ho['grad']['worst_maxrel']} (tol {cs.LM_GRAD_L2['global']}, "
         f"{cs.LM_GRAD_MAXREL}); Adam after step 1 worst "
         f"{hg['opt1']['worst']} / {ho['opt1']['worst']} (tol "
         f"{cs.TRAIN_STATE_RTOL}); 1F1B vs GPipe: loss rel "
         f"{v['loss_rel']}, gradients {v['grad']['global_l2']:.3e}, Adam "
         f"{v['opt1']['worst']}; control caught: {r0['control']['caught']} "
         f"(loss rel {r0['control']['loss_rel']}, gradients "
         f"{r0['control']['grad']['global_l2']:.3e})")
    _log(f"[37a] step ms GPipe {[round(s, 1) for s in g0['step_ms']]} "
         f"(rank 1 {[round(s, 1) for s in g1['step_ms']]}), 1F1B "
         f"{[round(s, 1) for s in o0['step_ms']]} (rank 1 "
         f"{[round(s, 1) for s in o1['step_ms']]}) against one rank's "
         f"fit_batch {[round(s, 1) for s in r0['one_rank_step_ms']]}; "
         f"hand-offs a step (rank 0 / rank 1, the last step): GPipe "
         f"{g0['steps'][-1]} / {g1['steps'][-1]}, 1F1B {o0['steps'][-1]} / "
         f"{o1['steps'][-1]}; host-staged over GPipe's fit "
         f"{g0['host_staged']} / {g1['host_staged']}; rows 6-8 launches "
         f"GPipe {g0['launches']} / {g1['launches']}, 1F1B "
         f"{o0['launches']} / {o1['launches']} ({g0['attention_layers']} / "
         f"{g1['attention_layers']} attention layers a stage) [{smi}]")
    _log(f"[37a] peak MiB a rank (over the rank's resident MiB before the "
         f"run): M {N_MICRO} GPipe {g0['peak_mib']:.0f} "
         f"({g0['peak_over_base_mib']:.0f}) / {g1['peak_mib']:.0f} "
         f"({g1['peak_over_base_mib']:.0f}), 1F1B {o0['peak_mib']:.0f} "
         f"({o0['peak_over_base_mib']:.0f}) / {o1['peak_mib']:.0f} "
         f"({o1['peak_over_base_mib']:.0f}); M {PEAK_MICRO} (2-row "
         f"microbatches) GPipe "
         f"{r0['peak_m8']['gpipe']['peak_mib']:.0f} "
         f"({r0['peak_m8']['gpipe']['peak_over_base_mib']:.0f}) / "
         f"{r1['peak_m8']['gpipe']['peak_mib']:.0f} "
         f"({r1['peak_m8']['gpipe']['peak_over_base_mib']:.0f}), 1F1B "
         f"{r0['peak_m8']['1f1b']['peak_mib']:.0f} "
         f"({r0['peak_m8']['1f1b']['peak_over_base_mib']:.0f}) / "
         f"{r1['peak_m8']['1f1b']['peak_mib']:.0f} "
         f"({r1['peak_m8']['1f1b']['peak_over_base_mib']:.0f}); M "
         f"{PEAK_MICRO} step ms GPipe "
         f"{r0['peak_m8']['gpipe']['step_ms']:.1f}, 1F1B "
         f"{r0['peak_m8']['1f1b']['step_ms']:.1f} ({t_lm:.1f} s) [{smi}]")
    b0 = ln[0]
    check(b0["loss_ok"], f"[37b] LeNet losses {b0['loss_rel']}")
    check(b0["grad"]["ok"], f"[37b] LeNet step-1 gradients {b0['grad']}")
    check(len({r["digest"] for r in ln}) == 1,
          "[37b] the ranks' params differ after write_back")
    dense = [k for k in b0["stage_keys"][1]]
    mb_rows = LENET_BATCH // N_MICRO // 2
    want = {str((mb_rows, 2450, 500, "relu")): N_MICRO * LENET_STEPS}
    for rank, r in enumerate(ln):
        if not card:
            break
        exp = want if r["stage"] == 1 else {}
        n = sum(exp.values())
        check(r["row1_shapes"] == exp and r["row1_launches"] == n,
              f"[37b] rank {rank} (stage {r['stage']}) row 1 launches "
              f"{r['row1_launches']} by shape {r['row1_shapes']}, "
              f"expected {exp}")
    _log(f"[37b] LeNet at data 2 x pipeline 2, n_micro {N_MICRO}, "
         f"{LENET_STEPS} Adam steps of {LENET_BATCH} through fit: stages "
         f"{b0['stage_keys']}; losses "
         f"{[round(x, 6) for x in b0['scores']]} rel {b0['loss_rel']} "
         f"(tol {cs.TRAIN_LOSS_RTOL}); step-1 "
         f"gradients global L2 {b0['grad']['global_l2']:.3e}, worst "
         f"max-rel {b0['grad']['worst_maxrel']} (tol "
         f"{cs.TRAIN_GRAD_L2['global']}, {cs.TRAIN_GRAD_MAXREL}); row 1 "
         f"launches by rank {[r['row1_launches'] for r in ln]} "
         f"{[r['row1_shapes'] for r in ln]} (the dense layer {dense} on "
         f"stage 1); every rank's params after write_back the same: "
         f"{len({r['digest'] for r in ln}) == 1} [{smi}]")
    line = {"card": smi, "seconds": time.monotonic() - t_start,
            "lm": {"gpipe": g0, "1f1b": o0, "rank1_gpipe": g1,
                   "rank1_1f1b": o1, "control": r0["control"],
                   "one_rank_step_ms": r0["one_rank_step_ms"],
                   "ref_losses": r0["ref_losses"],
                   "peak_m8": [r0["peak_m8"], r1["peak_m8"]],
                   "seconds": t_lm},
            "lenet": {k: b0[k] for k in ("loss_rel", "grad", "scores",
                                         "stage_keys")},
            "lenet_row1": [(r["row1_launches"], r["row1_shapes"])
                           for r in ln],
            "failures": failures}
    rows = {"matmul_bias_act": {
        "launches": [r["row1_launches"] for r in ln],
        "scope": (f"[37b]: LeNet's dense layer on pipeline stage 1 at data "
                  f"2 x pipeline 2, {LENET_STEPS} steps of {LENET_BATCH}, "
                  f"n_micro {N_MICRO}: once a microbatch at "
                  f"({mb_rows}, 2450, 500, relu), by rank")}}
    for name in g0["launches"]:
        rows[name] = {"launches": {
            "gpipe": [g0["launches"][name], g1["launches"][name]],
            "1f1b": [o0["launches"][name], o1["launches"][name]]},
            "scope": (f"[37a]: the GPT-2-small-width LM at data 1 x "
                      f"pipeline 2, {LM_STEPS} steps of {LM_BATCH} x "
                      f"{LM['max_len']} a schedule, n_micro {N_MICRO}: "
                      f"once a microbatch for each attention layer of the "
                      f"stage, by rank")}
    line["seconds_by_part"] = parts
    _log(f"[37] pipeline in {line['seconds']:.1f} s, by part on rank 0 "
         f"{json.dumps(parts)} [{smi}]")
    if failures:
        raise AssertionError(f"[37] {len(failures)} gate(s) failed: "
                             f"{failures}")
    return line, rows


def main() -> int:
    """The build and [37] alone."""
    import torch

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
    line, rows = pipeline_phase(torch, dev, smi)
    _log(json.dumps({"pipeline": line, "rows": rows}, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
