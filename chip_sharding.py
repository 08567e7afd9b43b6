#!/usr/bin/env python3
"""Phase [36] of ``chip_smoke.py``: the sharding subsystem with tensor and
sequence parallelism, on one H100.

NCCL puts one rank on a card, so the tensor-parallel runs are two gloo
ranks sharing ``cuda:0`` (``parallel.launch.spawn``), their model-axis
collectives staged through the host; after them this process joins a
one-rank NCCL group (nothing else on the card while a step is timed).

- [36a] The GPT-2-small-width LM of [14] (``cs.GEN_MODEL``: 12 layers, d
  768, 12 heads, ff 3072, vocab 50257; float32, ``use_kernels``, Adam)
  trains ``LM_STEPS`` + 1 steps at 8 x 1024 tokens in one ``fit`` through
  ``ParallelWrapper(partition_rules=zoo.rules.plan_for(transformer_rules(),
  data=1, model=2))``, held against one-rank ``fit_batch`` on the same
  batches at [14]'s gates over the first ``LM_STEPS``: every step's loss
  (``TRAIN_LOSS_RTOL``), the
  step-1 gradients (``LM_GRAD_L2`` global, ``LM_GRAD_MAXREL`` per tensor)
  and Adam's moments after step 1 (``TRAIN_STATE_RTOL`` of each tensor's
  largest magnitude); ``bk``'s gradient is 0 in exact arithmetic and is
  skipped, as [14] skips it. The control (each rank keeps its
  row-parallel partial sums: ``parallel.tensor.reduce_from`` the
  identity) must miss them. Each rank holds half of every ``Wq/Wk/Wv`` and
  ``ff1`` by rows and of every ``Wo`` and ``ff2`` by columns, ``embed/W``
  split on d, ``output/W`` whole (demoted: 50257 is odd), by shape and by
  ``plan.explain``; its param and Adam bytes equal the plan's accounting;
  rows 6-8 run 12 times a step a rank at [8, 6, 1024, 64]. Reported:
  the gated steps' ms (no timer inside), host-staged operations over the
  fit, and the last step's ms with its model-axis collectives' ms, bytes
  and calls (a synchronize on each side of each).
  One NCCL rank trains a ``model=1`` plan on the LM at ``NCCL_LAYERS``
  layers the same bits as ``fit_batch``.
- [36b] LeNet under ``lenet_rules`` at data 1 x model 2, ``LENET_STEPS``
  Adam steps at batch 64 against one-rank ``fit_batch`` at [7]'s step-1
  gradient gates and ``TRAIN_LOSS_RTOL``; row 1 runs on the dense layer's
  half (64 x 2450 -> 250, relu) once a step a rank. Then
  ``publish_to_engine`` into an ``InferenceEngine`` answering
  ``ENGINE_REQUESTS`` requests, each equal to the gathered network's
  ``output``, and ``reshard_training_state`` onto a 2 x 1 wrapper, bit for
  bit the host route (the gathered trees through the 2 x 1 wrapper's
  set-up).
- [36c] ``ring_attention`` across the two ranks (``sequence`` 2) at
  ``RING`` = [8, 12, 1024, 64], causal, with a ragged key mask, against
  one-rank ``reference_attention`` at ``ATTN_TOL`` (o) and
  ``ATTN_BWD_TOL`` (dq, dk, dv); then ``tp_block_apply`` at GPT-2 widths
  over ``model`` 2 against one rank at ``BLOCK_TOL``.

``python3 chip_sharding.py`` builds the kernels and runs [36] alone. To
rehearse on the CPU: ``sharding_phase(torch, torch.device("cpu"), smi,
overrides={...}, device="cpu")`` with small ``LM`` / ``RING`` / ``BLOCK``
(the launch counts are not held there: the wrappers count nothing on the
CPU).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

import chip_smoke as cs

SEED = 36
LM = dict(cs.GEN_MODEL)   # GPT-2 small's widths, 12 layers
LM_BATCH = cs.LM_BATCH    # 8 rows of 1024 tokens
LM_STEPS = 3
NCCL_LAYERS = 2           # the one-rank NCCL check's depth
LENET_BATCH = 64
LENET_STEPS = 4
ENGINE_REQUESTS = 8
RING = (8, 12, 1024, 64)  # B, H, T, D
RING_LENGTHS = (1024, 1000, 777, 512, 333, 129, 64, 1)
# the Megatron block at GPT-2 widths, batch 8 x T 256
BLOCK = dict(d_model=768, n_heads=12, d_ff=3072, batch=8, t=256)
# tp_block_apply over two ranks vs one: the same float32 math, the row-
# parallel products summed over two partials (768- and 3072-term dot
# products split in two): a few float32 ulps of |y| ~ 1-10
BLOCK_TOL = (1e-4, 1e-5)  # atol, rtol
TIMEOUT = 600.0


def _log(msg: str) -> None:
    cs.log(msg)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _state_errors(got, ref, skip=()) -> dict:
    """Adam's moments: the largest |got - ref| of each tensor relative to
    its largest |ref|; the worst tensor."""
    worst = (0.0, "")
    for k in ref:
        for p, st in ref[k].items():
            if p in skip:
                continue
            for s, b in st.items():
                a = got[k][p][s].double()
                b = b.double()
                err = float((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-300))
                worst = max(worst, (err, f"{k}.{p}.{s}"))
    return {"worst": worst}


def _losses_ok(got, ref) -> tuple:
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    ok = all(r <= (cs.TRAIN_LOSS_RTOL[0] if i == 0 else cs.TRAIN_LOSS_RTOL[1])
             for i, r in enumerate(rel))
    return ok, rel


class _Capture:
    """A listener: the step's score and time; after step 1 the gathered
    step-1 gradients (``pw._plan_update`` spied) and updater state, the
    local shapes and bytes; over step ``timed`` alone the collective
    timer."""

    def __init__(self, torch, dev, pw, timed=None):
        self.torch, self.dev, self.pw, self.timed = torch, dev, pw, timed
        self.scores, self.stamps, self.grads, self.opt1 = [], [], None, None
        self.local = None
        self.timer = None
        real = pw._plan_update

        def spy(grads, *a):
            if self.grads is None:
                self.grads = _clone_tree(grads)
            return real(grads, *a)

        pw._plan_update = spy

    def on_epoch_start(self, *a):
        pass

    def on_epoch_end(self, *a):
        pass

    def iteration_done(self, model, iteration, epoch, score):
        torch = self.torch
        _sync(torch, self.dev)
        self.stamps.append(time.monotonic())
        self.scores.append(float(score))
        if len(self.scores) == 1:
            self.local = {
                k: {p: tuple(v.shape) for p, v in vp.items()}
                for k, vp in model.params.items()}
            self.local_bytes = (
                sum(v.numel() * v.element_size()
                    for vp in model.params.values() for v in vp.values()),
                sum(v.numel() * v.element_size()
                    for vp in model.opt_state.values()
                    for st in vp.values() for v in st.values()))
            self.grads = self.pw._gather_tree(self.grads, self.pw._pspecs)
            self.opt1 = self.pw._gather_tree(model.opt_state,
                                             self.pw._ospecs)
        if self.timed is not None and len(self.scores) == self.timed - 1:
            self.timer = _CollectiveTimer(torch, self.dev)
        elif self.timer is not None and len(self.scores) == self.timed:
            self.timer.stop()
        _sync(torch, self.dev)
        self.stamps[-1] = (self.stamps[-1], time.monotonic())


class _CollectiveTimer:
    """Wall ms and bytes of every model-axis collective (the Megatron
    operators' all-reduce and all-gather), a synchronize on each side; a
    collective called inside another (the host-staged all-gather calls
    itself on host tensors) counts once, as the outer call."""

    def __init__(self, torch, dev):
        from deeplearning4j_tpu_torch.comms import scheduler

        self.torch, self.dev, self.sched = torch, dev, scheduler
        self.ms, self.bytes, self.calls = 0.0, 0, 0
        self.depth = 0
        self.real = (scheduler.all_reduce, scheduler.all_gather)

        def timed(fn, nbytes):
            def run(*a, **kw):
                if self.depth:
                    return fn(*a, **kw)
                self.depth += 1
                try:
                    _sync(torch, dev)
                    t0 = time.monotonic()
                    out = fn(*a, **kw)
                    _sync(torch, dev)
                finally:
                    self.depth -= 1
                self.ms += (time.monotonic() - t0) * 1e3
                self.bytes += nbytes(*a)
                self.calls += 1
                return out
            return run

        scheduler.all_reduce = timed(
            self.real[0], lambda t, *a: t.numel() * t.element_size())
        scheduler.all_gather = timed(
            self.real[1], lambda out, *a: out.numel() * out.element_size())

    def stop(self):
        self.sched.all_reduce, self.sched.all_gather = self.real


def _grad_gates(grads, ref, l2, maxrel) -> dict:
    err = cs._grad_errors(grads, ref, skip=cs.LM_ZERO_GRADS)
    worst = err["tensor_maxrel"][0] if err["tensor_maxrel"] else (0.0, "")
    return {"global_l2": err["global_l2"], "worst_maxrel": worst,
            "ok": err["global_l2"] <= l2 and worst[0] <= maxrel}


def _reference(torch, conf, dev, batches, steps=None) -> dict:
    """One-rank ``fit_batch`` on the batches: the step-1 gradients, every
    loss, Adam's state after step 1."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    cls = ComputationGraph if hasattr(conf, "vertex_map") \
        else MultiLayerNetwork
    ref = cls(conf, device=dev).init()
    grads, _ = ref.compute_gradient_and_score(batches[0])
    losses, opt1, step_ms = [], None, []
    for ds in batches[:steps]:
        _sync(torch, dev)
        t0 = time.monotonic()
        losses.append(ref.fit_batch(ds))
        step_ms.append((time.monotonic() - t0) * 1e3)
        if opt1 is None:
            opt1 = _clone_tree(ref.opt_state)
    return {"grads": grads, "losses": losses, "opt1": opt1,
            "step_ms": step_ms}


def lm_rank(torch, dev, rank, card) -> dict:
    """[36a] on this rank: the reference (rank 0, while rank 1 waits), the
    tensor-parallel fit and the control."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import routing
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, tensor
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
    from deeplearning4j_tpu_torch.comms import scheduler
    from deeplearning4j_tpu_torch.zoo import rules as zr
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=cs.GEN_SEED, **LM)
    conf = zoo.conf()
    t = LM["max_len"]
    # the gated steps, then one whose collectives are timed
    batches = [cs.lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH, t,
                             cs.LM_SEED + i) for i in range(LM_STEPS + 1)]
    ref = (_reference(torch, conf, dev, batches, LM_STEPS) if rank == 0
           else None)
    _sync(torch, dev)
    dist.barrier()
    mesh = mesh_mod.single_host_mesh(data=1, model=2)
    plan = zr.plan_for(zr.transformer_rules(), mesh=mesh)
    net = ComputationGraph(conf, device=dev).init()
    accounting = (plan.param_bytes_per_device(net),
                  plan.opt_bytes_per_device(net))
    pw = ParallelWrapper(net, mesh=mesh, partition_rules=plan,
                         prefetch_buffer=0)
    cap = _Capture(torch, dev, pw, timed=LM_STEPS + 1)
    net.set_listeners(cap)
    shapes = []
    real_flash = routing.maybe_flash_attention

    def spy(q, *a, **kw):
        shapes.append(tuple(q.shape))
        return real_flash(q, *a, **kw)

    routing.maybe_flash_attention = spy
    cs._reset_attention_launches(att)
    scheduler.reset()
    _sync(torch, dev)
    t0 = time.monotonic()
    try:
        # ---- the main path: counts from here on belong to it ----
        pw.fit(ListDataSetIterator(batches))
        _sync(torch, dev)
        launches = cs._attention_launches(att)
        # ---- end of the main path ----
    finally:
        routing.maybe_flash_attention = real_flash
    wall = time.monotonic() - t0
    ends = [b for _, b in cap.stamps]
    starts = [t0] + ends[:-1]
    step_ms = [(a - s) * 1e3 for s, (a, _) in zip(starts, cap.stamps)]
    timer = cap.timer
    rows = {r["path"]: r for r in plan.explain(fmt="json")["params"]}
    out = {
        "scores": cap.scores[:LM_STEPS], "step_ms": step_ms[:LM_STEPS],
        "wall_s": wall,
        "launches": launches, "flash_shapes": sorted(set(shapes)),
        "flash_calls": len(shapes),
        "local_shapes": {k: cap.local[k] for k in (
            "embed", "b0_attn", "b0_ff1", "b0_ff2", "output")},
        "local_bytes": cap.local_bytes, "plan_bytes": accounting,
        "explain": {p: [rows[p]["spec"], bool(rows[p].get("demoted"))]
                    for p in ("b0_attn/Wq", "b0_attn/Wo", "b0_ff1/W",
                              "b0_ff2/W", "embed/W", "output/W")},
        "collective_ms": timer.ms, "collective_bytes": timer.bytes,
        "collective_calls": timer.calls, "timed_step_ms": step_ms[LM_STEPS],
        "host_staged": scheduler.stats()["host_staged"],
        "digest": _digest(net.params),
    }
    if rank == 0:
        ok, rel = _losses_ok(cap.scores[:LM_STEPS], ref["losses"])
        out["ref_losses"] = ref["losses"]
        out["one_rank_step_ms"] = ref["step_ms"]
        out["loss_rel"] = rel
        out["loss_ok"] = ok
        out["grad"] = _grad_gates(cap.grads, ref["grads"],
                                  cs.LM_GRAD_L2["global"], cs.LM_GRAD_MAXREL)
        out["opt1"] = _state_errors(cap.opt1, ref["opt1"], cs.LM_ZERO_GRADS)
    del pw, net, cap, timer
    if card:
        torch.cuda.empty_cache()
    # the control: no reduce of the row-parallel partial sums
    real_reduce = tensor.reduce_from
    tensor.reduce_from = lambda x, group: x
    try:
        cnet = ComputationGraph(conf, device=dev).init()
        cpw = ParallelWrapper(cnet, mesh=mesh, partition_rules=plan,
                              prefetch_buffer=0)
        ccap = _Capture(torch, dev, cpw)
        cnet.set_listeners(ccap)
        cpw.fit(batches[0])
    finally:
        tensor.reduce_from = real_reduce
    if rank == 0:
        ok, rel = _losses_ok(ccap.scores, ref["losses"][:1])
        grad = _grad_gates(ccap.grads, ref["grads"],
                           cs.LM_GRAD_L2["global"], cs.LM_GRAD_MAXREL)
        out["control"] = {"loss_rel": rel, "grad": grad,
                          "caught": not (ok and grad["ok"])}
    del cpw, cnet, ccap, ref
    return out


def _digest(tree) -> str:
    """sha1 of a tensor tree's bits (leaves in sorted-key order)."""
    import hashlib

    from deeplearning4j_tpu_torch.comms import scheduler

    h = hashlib.sha1()
    for t in scheduler.tree_leaves(tree):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _lenet_batches(torch, dev, n, b):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n):
        x = rng.random((b, 28, 28, 1), np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
        out.append(DataSet(torch.tensor(x, device=dev),
                           torch.tensor(y, device=dev)))
    return out


def lenet_rank(torch, dev, rank, card) -> dict:
    """[36b] on this rank: LeNet at 1 x 2 against one rank, the publish and
    the reshard onto 2 x 1."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.comms.reshard import (
        publish_to_engine,
        reshard_training_state,
    )
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
    )
    from deeplearning4j_tpu_torch.zoo import rules as zr
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    conf = dataclasses.replace(LeNet().conf(), use_kernels=True)
    batches = _lenet_batches(torch, dev, LENET_STEPS, LENET_BATCH)
    ref = _reference(torch, conf, dev, batches) if rank == 0 else None
    _sync(torch, dev)
    dist.barrier()
    mesh = mesh_mod.single_host_mesh(data=1, model=2)
    plan = zr.plan_for(zr.lenet_rules(), mesh=mesh)
    net = MultiLayerNetwork(conf, device=dev).init()
    pw = ParallelWrapper(net, mesh=mesh, partition_rules=plan,
                         prefetch_buffer=0)
    cap = _Capture(torch, dev, pw)
    net.set_listeners(cap)
    impls.matmul_bias_act.launches = 0
    impls.matmul_bias_act.shapes.clear()
    # ---- the main path: counts from here on belong to it ----
    pw.fit(ListDataSetIterator(batches))
    _sync(torch, dev)
    launches = impls.matmul_bias_act.launches
    mm_shapes = dict(impls.matmul_bias_act.shapes)
    # ---- end of the main path ----
    out = {"scores": cap.scores, "row1_launches": launches,
           "row1_shapes": {str(k): v for k, v in mm_shapes.items()},
           "local_shapes": {k: cap.local[k] for k in ("0", "5", "6")}}
    if rank == 0:
        ok, rel = _losses_ok(cap.scores, ref["losses"])
        out.update(loss_rel=rel, loss_ok=ok,
                   grad=_grad_gates(cap.grads, ref["grads"],
                                    cs.TRAIN_GRAD_L2["global"],
                                    cs.TRAIN_GRAD_MAXREL))
    # publish from the live slices into a serving engine
    net.set_listeners()
    pw._setup()  # the slices again, as mid-fit
    params = pw._gather_tree(net.params, pw._pspecs)
    opt = pw._gather_tree(net.opt_state, pw._ospecs)
    whole = MultiLayerNetwork(conf, device=dev).init()
    whole.set_params(params, net.state, opt)
    rng = np.random.default_rng(SEED + 1)
    xs = rng.random((ENGINE_REQUESTS, 28, 28, 1), np.float32)
    want = whole.output(xs)
    engine = InferenceEngine(MultiLayerNetwork(conf, device=dev).init(),
                             BatchingConfig(max_batch=8))
    try:
        publish_to_engine(pw, engine)
        got = np.stack([np.asarray(engine.predict(xs[i:i + 1]))[0]
                        for i in range(ENGINE_REQUESTS)])
    finally:
        engine.close()
    out["publish_max_abs"] = float(np.abs(got - want).max())
    out["publish_ok"] = bool(np.allclose(got, want, rtol=1e-5, atol=1e-6))
    # reshard onto data 2 x model 1 against the host route
    m21 = mesh_mod.single_host_mesh(data=2)
    host = ParallelWrapper(whole, mesh=m21, prefetch_buffer=0)
    host._setup()
    dst = ParallelWrapper(net, mesh=m21, prefetch_buffer=0)
    _sync(torch, dev)
    t0 = time.monotonic()
    reshard_training_state(pw, dst)
    dst._setup()
    _sync(torch, dev)
    out["reshard_ms"] = (time.monotonic() - t0) * 1e3
    out["reshard_bits"] = (
        _digest((dst.model.params, dst.model.opt_state))
        == _digest((whole.params, whole.opt_state)))
    return out


def ring_rank(torch, dev, rank, card) -> dict:
    """[36c] on this rank: ring attention at sequence 2 and the Megatron
    block at model 2, each against one rank (rank 0 compares)."""
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops.ring import ring_attention
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel import tensor

    b, h, t, d = RING
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device=dev)
                   for _ in range(4))
    steps = t - 1 - torch.arange(t, device=dev)[None, :]
    km = (steps < torch.tensor(RING_LENGTHS, device=dev)[:, None]).float()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    seq = mesh_mod.single_host_mesh(sequence=2)
    _sync(torch, dev)
    t0 = time.monotonic()
    o = ring_attention(*leaves, seq, km, causal=True)
    o.backward(do)
    _sync(torch, dev)
    out = {"ring_ms": (time.monotonic() - t0) * 1e3}
    if rank == 0:
        refs = [x.clone().requires_grad_() for x in (q, k, v)]
        ro = att.reference_attention(*refs, km, True)
        ro.backward(do)
        errs = {}
        ok = True
        for name, got, want, tol in (
                ("o", o.detach(), ro.detach(), cs.ATTN_TOL["float32"]["o"]),
                ("dq", leaves[0].grad, refs[0].grad,
                 cs.ATTN_BWD_TOL["float32"]),
                ("dk", leaves[1].grad, refs[1].grad,
                 cs.ATTN_BWD_TOL["float32"]),
                ("dv", leaves[2].grad, refs[2].grad,
                 cs.ATTN_BWD_TOL["float32"])):
            err, bad = cs._within(torch, got, want, tol)
            errs[name] = err
            ok = ok and not bad
        out.update(ring_errors=errs, ring_ok=ok)
        del refs, ro
    del leaves, o, q, k, v, do
    # the Megatron block
    bk = BLOCK
    params = tensor.tp_block_init(SEED, bk["d_model"], bk["n_heads"],
                                  bk["d_ff"])
    params = {n: p.to(dev) for n, p in params.items()}
    x = torch.randn((bk["batch"], bk["t"], bk["d_model"]), generator=gen,
                    device=dev)
    mesh = mesh_mod.single_host_mesh(model=2)
    with torch.no_grad():
        got = tensor.tp_block_apply(tensor.shard_tp_params(params, mesh), x,
                                    bk["n_heads"], mesh)
        if rank == 0:
            want = tensor.tp_block_apply(params, x, bk["n_heads"])
            err, bad = cs._within(torch, got, want, BLOCK_TOL)
            out.update(block_err=err, block_ok=not bad)
    return out


def nccl_bits(torch, dev) -> dict:
    """One NCCL rank: a ``model=1`` plan on the LM at ``NCCL_LAYERS``
    layers against ``fit_batch``, bit for bit."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import rules as zr
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    model = dict(LM, n_layers=NCCL_LAYERS)
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=cs.GEN_SEED, **model)
    conf = zoo.conf()
    batches = [cs.lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH,
                             model["max_len"], cs.LM_SEED + i)
               for i in range(2)]
    ref = ComputationGraph(conf, device=dev).init()
    ref_losses = [ref.fit_batch(ds) for ds in batches]
    net = ComputationGraph(conf, device=dev).init()
    plan = zr.plan_for(zr.transformer_rules(), model=1)
    pw = ParallelWrapper(net, partition_rules=plan, prefetch_buffer=0)
    pw.fit(ListDataSetIterator(batches))
    return {"bits_equal": _digest(net.params) == _digest(ref.params),
            "loss": pw.score_value, "ref_loss": ref_losses[-1]}


def sharding_rank(rank, world, backend, overrides=None, device="cuda"):
    """One rank of [36]: the NCCL one-rank check, or [36a]-[36c] on one of
    the two gloo ranks. ``overrides`` ({"module.NAME": value}) and
    ``device`` "cpu" rehearse it at a small size without a card."""
    import importlib

    import torch

    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32

    for key, value in (overrides or {}).items():
        mod, name = key.rsplit(".", 1)
        setattr(importlib.import_module(mod), name, value)
    serve_full_f32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = device == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if card
           else torch.device("cpu"))
    if world == 1:
        return {"nccl": nccl_bits(torch, dev)}
    out = {}
    for name, fn in (("lm", lm_rank), ("lenet", lenet_rank),
                     ("ring", ring_rank)):
        t0 = time.monotonic()
        out[name] = fn(torch, dev, rank, card)
        out[name]["seconds"] = time.monotonic() - t0
        if card:
            torch.cuda.empty_cache()
    return out


def _start(overrides, device):
    """The two gloo ranks on ``cuda:0``, then the one NCCL rank in this
    process (on the CPU over gloo)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh
    from deeplearning4j_tpu_torch.parallel.launch import free_port, spawn

    out = {"gloo": spawn(sharding_rank, 2, ("gloo", overrides, device),
                         timeout=TIMEOUT, backend="gloo", device=device)}
    mesh.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0,
        backend="nccl" if device == "cuda" else "gloo", device=device,
        timeout=TIMEOUT)
    try:
        out["nccl"] = [sharding_rank(0, 1, "nccl", overrides, device)]
    finally:
        dist.destroy_process_group()
    return out


def sharding_phase(torch, dev, smi, overrides=None, device="cuda") -> tuple:
    """[36]: the ``{"sharding": ...}`` line and the kernels line's
    ``sharding`` entries. Raises if a gate failed."""
    t_start = time.monotonic()
    res = _start(overrides, device)
    r0, r1 = res["gloo"]
    nccl = res["nccl"][0]["nccl"]
    card = device == "cuda"
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    lm, lm1 = r0["lm"], r1["lm"]
    n_layers = LM["n_layers"]
    check(lm["loss_ok"], f"[36a] losses {lm['loss_rel']} outside "
                         f"{cs.TRAIN_LOSS_RTOL}")
    check(lm["grad"]["ok"], f"[36a] step-1 gradients {lm['grad']}")
    check(lm["opt1"]["worst"][0] <= cs.TRAIN_STATE_RTOL,
          f"[36a] Adam state after step 1 {lm['opt1']}")
    check(lm["control"]["caught"], f"[36a] the no-reduce control passed: "
                                   f"{lm['control']}")
    check(lm["digest"] == lm1["digest"], "[36a] the ranks' params differ")
    d, e = LM["embed_dim"], LM["embed_dim"]
    ff = 4 * d
    want_shapes = {"b0_attn": {"Wq": (e // 2, d), "Wo": (d, e // 2)},
                   "b0_ff1": {"W": (ff // 2, d)}, "b0_ff2": {"W": (d, ff // 2)},
                   "embed": {"W": (LM["vocab_size"], d // 2)},
                   "output": {"W": (LM["vocab_size"], d)}}
    for k, want in want_shapes.items():
        for p, shape in want.items():
            check(tuple(lm["local_shapes"][k][p]) == shape,
                  f"[36a] {k}/{p} local shape {lm['local_shapes'][k][p]}, "
                  f"expected {shape}")
    ex = lm["explain"]
    check(ex["b0_attn/Wq"][0] == "PartitionSpec(None, 'model')"
          and ex["b0_attn/Wo"][0] == "PartitionSpec('model', None)"
          and ex["output/W"][1], f"[36a] explain rows {ex}")
    check(tuple(lm["local_bytes"]) == tuple(lm["plan_bytes"]),
          f"[36a] local bytes {lm['local_bytes']} vs the plan's "
          f"{lm['plan_bytes']}")
    if card:
        want_shape = (LM_BATCH, LM["n_heads"] // 2, LM["max_len"],
                      LM["embed_dim"] // LM["n_heads"])
        for name, n in lm["launches"].items():
            check(n == n_layers * (LM_STEPS + 1),
                  f"[36a] {name} launched {n} times, expected "
                  f"{n_layers} x {LM_STEPS + 1}")
        check(lm["flash_shapes"] == [want_shape],
              f"[36a] flash shapes {lm['flash_shapes']}")
    check(nccl["bits_equal"], f"[36a] NCCL model=1 plan vs fit_batch: "
                              f"{nccl}")
    _log(f"[36a] GPT-2-small-width LM ({n_layers} layers) at data 1 x model "
         f"2, {LM_STEPS} Adam steps of {LM_BATCH} x {LM['max_len']}: losses "
         f"{[round(s, 6) for s in lm['scores']]} vs one-rank fit_batch "
         f"{[round(s, 6) for s in lm['ref_losses']]} (rel {lm['loss_rel']}, "
         f"tol {cs.TRAIN_LOSS_RTOL}); step-1 gradients global L2 "
         f"{lm['grad']['global_l2']:.3e}, worst max-rel "
         f"{lm['grad']['worst_maxrel']} (tol {cs.LM_GRAD_L2['global']}, "
         f"{cs.LM_GRAD_MAXREL}); Adam state after step 1 worst "
         f"{lm['opt1']['worst']} (tol {cs.TRAIN_STATE_RTOL}); control "
         f"caught: {lm['control']['caught']} (loss rel "
         f"{lm['control']['loss_rel']}, grad {lm['control']['grad']})")
    _log(f"[36a] a rank holds {lm['local_bytes'][0]:,} param and "
         f"{lm['local_bytes'][1]:,} Adam bytes (the plan: "
         f"{lm['plan_bytes'][0]:,} / {lm['plan_bytes'][1]:,}); rows 6-8 "
         f"launches {json.dumps(lm['launches'])} at {lm['flash_shapes']}; "
         f"step ms {[round(s, 1) for s in lm['step_ms']]} (rank 1 "
         f"{[round(s, 1) for s in lm1['step_ms']]}; one rank's fit_batch "
         f"{[round(s, 1) for s in lm['one_rank_step_ms']]}); host-staged "
         f"{lm['host_staged']} over the fit; step {LM_STEPS + 1} "
         f"{lm['timed_step_ms']:.1f} ms (rank 1 "
         f"{lm1['timed_step_ms']:.1f}) with its model-axis collectives "
         f"timed: {lm['collective_calls']} calls, "
         f"{lm['collective_ms']:.1f} ms (rank 1 {lm1['collective_ms']:.1f}), "
         f"{lm['collective_bytes']:,} bytes [{smi}]")
    _log(f"[36a] NCCL one rank, model=1 plan at {NCCL_LAYERS} layers: the "
         f"same bits as fit_batch: {nccl['bits_equal']} (loss "
         f"{nccl['loss']:.6f} / {nccl['ref_loss']:.6f})")
    ln = r0["lenet"]
    check(ln["loss_ok"], f"[36b] LeNet losses {ln['loss_rel']}")
    check(ln["grad"]["ok"], f"[36b] LeNet step-1 gradients {ln['grad']}")
    check(ln["publish_ok"], f"[36b] published answers off by "
                            f"{ln['publish_max_abs']}")
    check(ln["reshard_bits"] and r1["lenet"]["reshard_bits"],
          "[36b] reshard_training_state differs from the host route")
    if card:
        want = {str((LENET_BATCH, 2450, 250, "relu")): LENET_STEPS}
        check(ln["row1_shapes"] == want and ln["row1_launches"] == LENET_STEPS,
              f"[36b] row 1 launches {ln['row1_launches']} by shape "
              f"{ln['row1_shapes']}, expected {want}")
    _log(f"[36b] LeNet under lenet_rules at data 1 x model 2, {LENET_STEPS} "
         f"steps of {LENET_BATCH}: losses {ln['loss_rel']} rel (tol "
         f"{cs.TRAIN_LOSS_RTOL}), step-1 gradients global L2 "
         f"{ln['grad']['global_l2']:.3e}, worst max-rel "
         f"{ln['grad']['worst_maxrel']}; row 1 {ln['row1_launches']} "
         f"launches {ln['row1_shapes']}; local shapes "
         f"{ln['local_shapes']}; published {ENGINE_REQUESTS} answers max "
         f"|err| {ln['publish_max_abs']:.2e}; reshard 1x2 -> 2x1 the host "
         f"route's bits: {ln['reshard_bits']} ({ln['reshard_ms']:.1f} ms)")
    rg = r0["ring"]
    check(rg["ring_ok"], f"[36c] ring attention errors {rg['ring_errors']}")
    check(rg["block_ok"], f"[36c] tp_block_apply error {rg['block_err']}")
    _log(f"[36c] ring_attention at {list(RING)} causal, masked, over 2 "
         f"ranks vs one-rank reference_attention: max |err| "
         f"{json.dumps(rg['ring_errors'])} (tol {cs.ATTN_TOL['float32']['o']}"
         f", {cs.ATTN_BWD_TOL['float32']}); forward + backward "
         f"{rg['ring_ms']:.1f} ms; tp_block_apply at {json.dumps(BLOCK)} "
         f"over model 2 vs one rank: max |err| {rg['block_err']:.2e} (tol "
         f"{BLOCK_TOL})")
    line = {"card": smi, "seconds": time.monotonic() - t_start,
            "lm": {k: lm[k] for k in (
                "scores", "ref_losses", "loss_rel", "grad", "opt1",
                "control", "step_ms", "one_rank_step_ms", "collective_ms",
                "collective_bytes", "collective_calls", "timed_step_ms",
                "host_staged", "local_bytes",
                "plan_bytes", "launches", "flash_shapes", "explain")},
            "lm_rank1_step_ms": lm1["step_ms"],
            "lm_rank1_timed_step_ms": lm1["timed_step_ms"],
            "lm_rank1_collective_ms": lm1["collective_ms"], "nccl": nccl,
            "lenet": {k: ln[k] for k in (
                "loss_rel", "grad", "row1_launches", "row1_shapes",
                "publish_max_abs", "reshard_bits", "reshard_ms")},
            "ring": rg, "failures": failures}
    rows = {"matmul_bias_act": {
        "launches": ln["row1_launches"],
        "scope": (f"[36b]: LeNet's dense layer on its 250-column half at "
                  f"data 1 x model 2, {LENET_STEPS} steps of "
                  f"{LENET_BATCH}, one rank")}}
    for name, n in lm["launches"].items():
        rows[name] = {"launches": n, "scope": (
            f"[36a]: the GPT-2-small-width LM at data 1 x model 2, "
            f"{LM_STEPS + 1} steps of {LM_BATCH} x {LM['max_len']}, one "
            f"rank: "
            f"its local heads at {lm['flash_shapes']}")}
    _log(f"[36] sharding in {line['seconds']:.1f} s [{smi}]")
    if failures:
        raise AssertionError(f"[36] {len(failures)} gate(s) failed: "
                             f"{failures}")
    return line, rows


def main() -> int:
    """The build and [36] alone."""
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
    line, rows = sharding_phase(torch, dev, smi)
    _log(json.dumps({"sharding": line, "rows": rows}, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
