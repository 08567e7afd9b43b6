#!/usr/bin/env python3
"""Phase [32] of ``chip_smoke.py``: the mixture-of-experts transformer on
one H100, on the flash kernels (rows 6-8), one rank and experts across
ranks.

The model is ``TransformerEncoder(lm_head=True, causal=True,
use_kernels=...)`` at ``GEN_MODEL``'s widths (vocab 50257, 768 wide, 12
heads, 12 layers, ``max_len`` 1024) with ``moe_experts=8, moe_top_k=2``
(Mixtral-8x7B's routing: 8 experts, 2 a token), capacity factor 1.25 and
3072 hidden units an expert (the JAX package's defaults), seeded; the
micro-batch is [14]'s 8 x 1024 seeded tokens, so 2560 slots an expert a
layer. float32, TF32 off.

- (a) One rank: ``fit`` for 3 steps on each route (``use_kernels`` True
  and False) from the same params, Adam(1e-3). Routing is discrete: a
  difference of ~1e-6 between the routes' attention can flip a token whose
  2nd and 3rd router probabilities lie that close, and a flip moves that
  token's output by O(1), and through the causal attention every later
  token of its row in the layers after. So a forward on each route
  records every layer's routing (``parallel.expert.route``): the (token,
  expert) assignments that differ between the routes, layer by layer,
  with the smallest 2nd / 3rd probability margin; the primary flips (at
  tokens no earlier flip reached) are gated at ``MOE_MAX_PRIMARY_FLIPS``,
  and the logits of the clean tokens (no flip reached them) within
  ``MOE_LOGIT_REL_L2``, with the flash forward's operands rounded to TF32
  (the control) outside it. Then step-1 gradients (``MOE_GRAD_L2``), the
  losses (aux included) at [7]'s loss limits and the params after the
  steps (``MOE_PARAM_REL_L2``, all tensors together); rows 6, 7 and 8
  launch exactly 12 times a step each over the kernel route's fit alone;
  the loss falls there. One ``output`` a route: softmax rows of the
  batch's shape summing to 1, 12 flash launches on the kernel route.
  Reported: step ms and tokens/s a route, peak memory, each layer's
  dropped-choice share and the aux loss.
- (b) Experts across ranks, ``ParallelWrapper(expert_parallel=True)`` at
  2 layers (full width), ``aux_weight`` 0 and capacity factor 4.0 (=
  E / top_k: no token can drop, the JAX package's own condition for EP to
  equal one device), SGD: two gloo ranks sharing ``cuda:0`` (4 experts a
  rank, 4 rows each) against one-rank ``fit_batch`` on the card (the
  loss at [7]'s step-1 limit, each param's update at [7]'s gradient
  limits), every rank ending with the same params; and NCCL at one rank,
  equal to ``fit_batch`` bit for bit. Reported: step ms, the all-to-all
  bytes a step, the host-staged collectives, and whether this gloo build
  takes CUDA tensors for all-to-all.

``python3 chip_moe.py`` builds the kernels and runs [32] alone;
``python3 chip_moe.py --spread N`` instead reads (a)'s route errors and
flips at N seeds, the readings its limits are set from.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import time

import numpy as np

import chip_layers
import chip_smoke as cs

MOE_MODEL = dict(cs.GEN_MODEL, moe_experts=8, moe_top_k=2)
MOE_SEED = 32
MOE_STEPS = 3
# kernel route against stock, set from --spread readings (PERF.md)
# (``--spread`` on an H100 80GB HBM3 at 700 W, seeds 32-37: primary flips
# 1, 0, 0, 0, 0, 0 against 12-18 with the flash operands in TF32; the
# clean tokens' logits 1.3e-6 against 2.9e-4; step-1 gradients' global
# L2 2.2e-4 to 5.2e-4, 8.6e-3 with seed 32's 20 flips, the worst tensor
# 1.4e-3, 2.7e-2; params 3.0e-4 to 5.8e-4, 2.9e-3)
MOE_MAX_PRIMARY_FLIPS = 4   # flips at tokens nothing earlier reached
MOE_LOGIT_REL_L2 = 2e-5     # logits of the tokens nothing reached
MOE_GRAD_L2 = {"global": 3e-2, "tensor": 1e-1}
MOE_PARAM_REL_L2 = 1e-2     # all params together after the 3 Adam steps
EP_LAYERS = 2
EP_WORLD = 2
EP_BATCH = 8
EP_LR = 0.1
EP_TIMEOUT = 600.0


def _log(msg: str) -> None:
    cs.log(msg)


# --------------------------------------------------------------------------
# (a) one rank
# --------------------------------------------------------------------------

@contextlib.contextmanager
def record_routes():
    """Every ``expert.route`` call inside the block appends (probs, kidx,
    keep) to the list it yields, in call order: one entry an MoE layer and
    forward."""
    from deeplearning4j_tpu_torch.parallel import expert

    real, seen = expert.route, []

    def route(probs, top_k, capacity):
        out = real(probs, top_k, capacity)
        seen.append((probs.detach(), out[0].detach(), out[3].detach()))
        return out

    expert.route = route
    try:
        yield seen
    finally:
        expert.route = real


def routing_diff(torch, ra, rb, rows: int) -> dict:
    """Layer by layer: the (token, expert) assignments of ``ra`` absent
    from ``rb``; those at tokens nothing earlier reached (primary); the
    smallest 2nd / 3rd probability margin of ``rb``; the dropped-choice
    share of ``ra``; and the tokens nothing reached (clean). A token is
    reached where its assignments or its kept choices differ: through the
    causal attention that reaches the rest of its row in the layers after,
    and a flip moves every later token's place in its experts' capacity
    queues, so a kept choice can drop (or a dropped one be kept) in any
    row after it."""
    flips, primary, margins, dropped = [], [], [], []
    reached = None
    for (pa, ka, keep_a), (pb, kb, keep_b) in zip(ra, rb):
        sa = torch.zeros_like(pa, dtype=torch.bool).scatter_(1, ka, True)
        sb = torch.zeros_like(pb, dtype=torch.bool).scatter_(1, kb, True)
        kept_a = torch.zeros_like(sa).scatter_(1, ka, keep_a)
        kept_b = torch.zeros_like(sb).scatter_(1, kb, keep_b)
        diff = (sa & ~sb).sum(1).view(rows, -1)
        moved = (diff > 0) | (kept_a != kept_b).any(1).view(rows, -1)
        if reached is None:
            reached = torch.zeros_like(moved)
        flips.append(int(diff.sum()))
        primary.append(int(diff[~reached].sum()))
        reached = torch.cummax((reached | moved).int(), dim=1).values.bool()
        top = torch.topk(pb, 3, dim=1).values
        margins.append(float((top[:, 1] - top[:, 2]).min()))
        dropped.append(float((~keep_a).float().mean()))
    return {"flips": flips, "primary": primary, "margin": margins,
            "dropped": dropped, "clean": ~reached.reshape(-1)}


def moe_pair(torch, dev, seed=MOE_SEED):
    """The MoE LM on the kernel route and the same weights on the stock
    route, and [14]'s batch."""
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=seed, **MOE_MODEL)
    net, ref = cs._route_pair(torch, dev, zoo)
    ds = cs.lm_dataset(torch, dev, zoo.vocab_size, cs.LM_BATCH,
                       MOE_MODEL["max_len"], cs.LM_SEED)
    return net, ref, ds


def _lm_logits(torch, m, ds):
    """The LM head's pre-activation on every token, ``[B*T, vocab]``, and
    each MoE layer's routing on the way."""
    with record_routes() as seen, torch.inference_mode():
        acts, _ = m._forward(m._fwd_params(), m.state,
                             m._prepare([ds.features]), skip={"output"})
        z = m.conf.vertex_map()["output"].vertex.layer.pre_output(
            m.params["output"], acts["final_ln"])
    return z.reshape(-1, z.shape[-1]), seen


@contextlib.contextmanager
def one_pass_flash(torch):
    """The flash forward's q, k, v rounded to TF32 inside this block: the
    kernel a dropped 3xTF32 split would leave. The control the logit gate
    must reject."""
    import chip_zoo
    from deeplearning4j_tpu_torch.ops import attention as att

    real = att._flash_cuda

    def one_pass(q, k, v, *rest, **kw):
        return real(*(chip_zoo._tf32(torch, t) for t in (q, k, v)), *rest,
                    **kw)

    att._flash_cuda = one_pass
    try:
        yield
    finally:
        att._flash_cuda = real


def _clean_logits(torch, za, zb, clean) -> float:
    a, b = za[clean].double(), zb[clean].double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def route_errors(torch, net, ref, ds) -> dict:
    """One forward a route: the routing differences, the logits of the
    clean tokens, and the same with the flash forward's operands rounded
    to TF32 (the control)."""
    rows = ds.features.shape[0]
    zk, rk = _lm_logits(torch, net, ds)
    zs, rs = _lm_logits(torch, ref, ds)
    diff = routing_diff(torch, rk, rs, rows)
    clean = diff.pop("clean")
    diff["tokens_clean"] = int(clean.sum())
    diff["tokens"] = int(clean.numel())
    diff["logit_rel_l2_clean"] = _clean_logits(torch, zk, zs, clean)
    del zk
    with one_pass_flash(torch):
        zc, rc = _lm_logits(torch, net, ds)
    ctl = routing_diff(torch, rc, rs, rows)
    diff["one_pass"] = {"flips": sum(ctl["flips"]),
                        "primary": sum(ctl["primary"]),
                        "tokens_clean": int(ctl["clean"].sum()),
                        "logit_rel_l2_clean": _clean_logits(
                            torch, zc, zs, ctl["clean"])}
    return diff


def train_errors(torch, net, ref, ds, count=False) -> dict:
    """Step-1 gradients, ``MOE_STEPS`` fit losses and the params after
    them, kernel route against stock; with ``count``, rows 6-8's launches
    over the kernel route's fit alone."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    (gk, lk), (gr, lr) = (m.compute_gradient_and_score(ds)
                          for m in (net, ref))
    grad = cs._grad_errors(gk, gr, cs.LM_ZERO_GRADS)
    del gk, gr
    torch.cuda.empty_cache()
    scores, launches = [], None
    for m in (net, ref):
        collect = CollectScoresListener()
        m.set_listeners(collect)
        if m is net and count:
            # ---- the main path: counts from here on belong to it ----
            cs._reset_attention_launches(att)
        m.fit(ListDataSetIterator([ds] * MOE_STEPS))
        torch.cuda.synchronize()
        if m is net and count:
            launches = cs._attention_launches(att)
            # ---- end of the main path ----
        m.set_listeners()
        scores.append(collect.scores)
    # bk's gradient is 0 in exact arithmetic: Adam moves it by noise
    keep = {k: {p: v for p, v in vp.items() if p not in cs.LM_ZERO_GRADS}
            for k, vp in ref.params.items()}
    params = chip_layers.param_errors(torch, net.params, keep)
    aux = {k: float(st["__aux_loss__"]) for k, st in net.state.items()
           if "__aux_loss__" in st}
    return {"grad": grad, "score_kernel": lk, "score_stock": lr,
            "losses_kernel": scores[0], "losses_stock": scores[1],
            "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(*scores)],
            "params": params, "aux": aux, "launches": launches}


def _step_ms(torch, net, ds, steps=2) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        net.fit_batch(ds)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / steps * 1e3


def serve_once(torch, net, ref, ds) -> dict:
    """One ``output`` a route: softmax rows of the right shape summing to
    1, the flash forward launched once a layer on the kernel route."""
    from deeplearning4j_tpu_torch.ops import attention as att

    cs._reset_attention_launches(att)
    out = net.output(ds.features)
    launches = att.flash_attention.launches
    out_ref = ref.output(ds.features)
    want = (cs.LM_BATCH, MOE_MODEL["max_len"], MOE_MODEL["vocab_size"])
    sums = out.sum(-1, dtype=np.float64)
    if out.shape != want or out_ref.shape != want \
            or not np.isfinite(out).all() or np.abs(sums - 1).max() > 1e-3 \
            or launches != MOE_MODEL["n_layers"]:
        raise AssertionError(f"[32a] output: shape {out.shape} / "
                             f"{out_ref.shape} (want {want}), row sums "
                             f"{sums.min()}..{sums.max()}, flash launched "
                             f"{launches} times")
    return {"shape": list(out.shape), "flash_launches": launches,
            "max_abs_diff": float(np.abs(out - out_ref).max())}


def train_moe(torch, dev, smi) -> dict:
    """(a) the MoE LM on one rank."""
    n_layers, t = MOE_MODEL["n_layers"], MOE_MODEL["max_len"]
    t0 = time.monotonic()
    net, ref, ds = moe_pair(torch, dev)
    build_s = time.monotonic() - t0
    routes = route_errors(torch, net, ref, ds)
    ctl = routes["one_pass"]
    _log(f"[32a] MoE LM {json.dumps(MOE_MODEL)}: {net.num_params():,} "
         f"params ({build_s:.1f} s to build); a forward on each route: "
         f"assignments differing by layer {routes['flips']}, primary "
         f"{routes['primary']} (smallest 2nd / 3rd margin "
         f"{min(routes['margin']):.3e}); logits of the "
         f"{routes['tokens_clean']} / {routes['tokens']} clean tokens rel L2 "
         f"{routes['logit_rel_l2_clean']:.3e} (tol {MOE_LOGIT_REL_L2}; flash "
         f"operands in TF32: {ctl['logit_rel_l2_clean']:.3e} over "
         f"{ctl['tokens_clean']}, {ctl['primary']} primary flips); dropped "
         f"choices by layer {[round(v, 4) for v in routes['dropped']]}")
    if sum(routes["primary"]) > MOE_MAX_PRIMARY_FLIPS or not (
            routes["logit_rel_l2_clean"] <= MOE_LOGIT_REL_L2
            < ctl["logit_rel_l2_clean"]):
        raise AssertionError(f"[32a] routes differ: {routes} (tol "
                             f"{MOE_MAX_PRIMARY_FLIPS} primary flips; clean "
                             f"logits {MOE_LOGIT_REL_L2}, the control "
                             f"outside it)")
    served = serve_once(torch, net, ref, ds)
    _log(f"[32a] output on each route: {served['shape']}, softmax rows "
         f"summing to 1, {served['flash_launches']} flash launches on the "
         f"kernel route, max |kernel - stock| {served['max_abs_diff']:.3e}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = train_errors(torch, net, ref, ds, count=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    for name, n in err["launches"].items():
        if n != n_layers * MOE_STEPS:
            raise AssertionError(f"[32a] {name} launched {n} times over "
                                 f"{MOE_STEPS} steps, expected {n_layers} a "
                                 f"step")
    losses = err["losses_kernel"]
    finite = all(math.isfinite(v) for v in losses)
    if not (finite and losses[-1] < losses[0]):
        raise AssertionError(f"[32a] the loss did not fall: {losses}")
    cs._check_fixed("32a", err["grad"], MOE_GRAD_L2, cs.TRAIN_GRAD_MAXREL,
                    err["loss_rel_err"], (losses, err["losses_stock"]),
                    finite, 0.0)
    par = err["params"]
    if not par["global"] <= MOE_PARAM_REL_L2:
        raise AssertionError(f"[32a] params after {MOE_STEPS} steps differ: "
                             f"{par} (tol {MOE_PARAM_REL_L2})")
    tokens = cs.LM_BATCH * t
    row = {"params": net.num_params(), "build_s": build_s,
           "routing": routes, "output": served, "grad": cs._summary(err["grad"]),
           "losses_kernel": losses, "losses_stock": err["losses_stock"],
           "loss_rel_err": err["loss_rel_err"], "params": par,
           "aux_after_steps": err["aux"], "launches": err["launches"],
           "peak_mib": peak, "step_ms_kernel": _step_ms(torch, net, ds),
           "step_ms_stock": _step_ms(torch, ref, ds)}
    for route in ("kernel", "stock"):
        row[f"tokens_per_s_{route}"] = tokens / row[f"step_ms_{route}"] * 1e3
    _log(f"[32a] fit {MOE_STEPS} steps: losses kernel {losses} stock "
         f"{err['losses_stock']} (rel {err['loss_rel_err']}); step-1 "
         f"gradients global L2 {err['grad']['global_l2']:.3e} (tol "
         f"{MOE_GRAD_L2}); params {par['global']:.3e} (tol "
         f"{MOE_PARAM_REL_L2}; worst tensor {par['worst']}); launches "
         f"{json.dumps(err['launches'])}; aux "
         f"loss after the steps {sum(err['aux'].values()):.4e}; step "
         f"{row['step_ms_kernel']:.1f} ms kernel route "
         f"({row['tokens_per_s_kernel']:.0f} tokens/s), "
         f"{row['step_ms_stock']:.1f} ms stock "
         f"({row['tokens_per_s_stock']:.0f} tokens/s); peak {peak:.0f} MiB "
         f"(both routes' nets, Adam state and the comparison) [{smi}]")
    del net, ref, ds
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# (b) experts across ranks
# --------------------------------------------------------------------------

def ep_conf(model):
    """``model`` at 2 layers, capacity factor 4.0, no aux loss, SGD."""
    from deeplearning4j_tpu_torch.conf.layers_moe import MoELayer
    from deeplearning4j_tpu_torch.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    kw = dict(model, n_layers=EP_LAYERS, moe_capacity_factor=4.0)
    conf = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                              seed=MOE_SEED, updater=Sgd(learning_rate=EP_LR),
                              **kw).conf()
    for spec in conf.vertices:
        layer = getattr(spec.vertex, "layer", None)
        if isinstance(layer, MoELayer):
            layer.aux_weight = 0.0
    return conf


def _digest(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        for p in sorted(params[k]):
            h.update(params[k][p].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _gloo_cuda_all_to_all(torch) -> str:
    """Whether this gloo build takes CUDA tensors for all-to-all (every
    rank tries the same call; an unsupported device raises on each)."""
    import torch.distributed as dist

    x = torch.ones(dist.get_world_size(), 4, device="cuda")
    out = torch.empty_like(x)
    try:
        dist.all_to_all_single(out, x)
    except Exception as e:  # reported: the port stages it through the host
        return f"refused: {type(e).__name__}: {str(e)[:120]}"
    torch.cuda.synchronize()
    return "taken"


def ep_rank(rank, world, backend, model, device="cuda"):
    """One rank of (b) on ``model``'s widths: an expert-parallel step
    (gated) and a second one (timed) on this rank's rows; rank 0 also runs
    one-rank ``fit_batch`` on the whole batch and compares. ``device``
    "cpu" rehearses it without a card."""
    import torch

    from deeplearning4j_tpu_torch.comms import scheduler
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        serve_full_f32,
    )
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, expert

    serve_full_f32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card \
        else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    conf = ep_conf(model)
    net = ComputationGraph(conf, device=dev).init()
    full = cs.lm_dataset(torch, dev, model["vocab_size"], EP_BATCH,
                         model["max_len"], cs.LM_SEED)
    rows = EP_BATCH // world
    part = DataSet(full.features[rank * rows:(rank + 1) * rows],
                   full.labels[rank * rows:(rank + 1) * rows])
    p0 = {k: {p: v.detach().clone() for p, v in vp.items()}
          for k, vp in net.params.items()} if rank == 0 else None
    pw = ParallelWrapper(net, expert_parallel=True, prefetch_buffer=0)
    scheduler.reset()
    expert.reset_stats()
    pw.fit(part)
    sync()
    out = {"loss": pw.score_value, "digest": _digest(net.params),
           "exchanged_step1": expert.stats(),
           "host_staged": scheduler.stats()["host_staged"]}
    if rank == 0:
        ref = ComputationGraph(conf, device=dev).init()
        ref_loss = ref.fit_batch(full)
        sync()
        upd = {}
        num = den = 0.0
        bits = True
        for k in ref.params:
            for p in ref.params[k]:
                if p in cs.LM_ZERO_GRADS:  # 0 in exact arithmetic: noise
                    bits = bits and torch.equal(net.params[k][p],
                                                ref.params[k][p])
                    continue
                a = (net.params[k][p] - p0[k][p]).double()
                b = (ref.params[k][p] - p0[k][p]).double()
                d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
                num, den = num + d2, den + b2
                upd[f"{k}.{p}"] = (d2 / max(b2, 1e-300)) ** 0.5
                bits = bits and torch.equal(net.params[k][p], ref.params[k][p])
        worst = max(upd.items(), key=lambda kv: kv[1])
        out.update(ref_loss=ref_loss,
                   loss_rel_err=abs(out["loss"] - ref_loss) / abs(ref_loss),
                   update_global_l2=(num / den) ** 0.5, update_worst=worst,
                   bits_equal=bits and out["loss"] == ref_loss)
        del ref, p0
    expert.reset_stats()
    sync()
    t0 = time.monotonic()
    pw.fit(part)
    sync()
    out["step_ms"] = (time.monotonic() - t0) * 1e3
    out["exchanged_step2"] = expert.stats()
    if card:
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    if backend == "gloo" and card:
        out["gloo_cuda_all_to_all"] = _gloo_cuda_all_to_all(torch)
    return out


def experts_across_ranks(torch, smi) -> dict:
    """(b): two gloo ranks sharing the card, then NCCL at one rank."""
    from deeplearning4j_tpu_torch.parallel.launch import spawn

    t0 = time.monotonic()
    gloo = spawn(ep_rank, EP_WORLD, ("gloo", MOE_MODEL), backend="gloo",
                 device="cuda", timeout=EP_TIMEOUT)
    nccl = spawn(ep_rank, 1, ("nccl", MOE_MODEL), timeout=EP_TIMEOUT)[0]
    wall = time.monotonic() - t0
    r0 = gloo[0]
    same = len({r["digest"] for r in gloo}) == 1
    lim = cs.TRAIN_GRAD_L2
    tensor_ok = r0["update_worst"][1] <= lim["tensor"]
    ok = (r0["loss_rel_err"] <= cs.TRAIN_LOSS_RTOL[0]
          and r0["update_global_l2"] <= lim["global"] and tensor_ok and same
          and math.isfinite(r0["loss"]))
    _log(f"[32b] experts across {EP_WORLD} gloo ranks on cuda:0 "
         f"({MOE_MODEL['moe_experts'] // EP_WORLD} experts, "
         f"{EP_BATCH // EP_WORLD} rows a rank, {EP_LAYERS} layers): loss "
         f"{r0['loss']:.6f} vs one-rank fit_batch {r0['ref_loss']:.6f} (rel "
         f"{r0['loss_rel_err']:.2e}, tol {cs.TRAIN_LOSS_RTOL[0]}); updates "
         f"global L2 {r0['update_global_l2']:.3e}, worst {r0['update_worst']}"
         f" (tol {lim}); ranks' params the same bits: {same}; step "
         f"{[round(r['step_ms'], 1) for r in gloo]} ms; all-to-all "
         f"{r0['exchanged_step2']} a step a rank; host-staged "
         f"{r0['host_staged']}; gloo CUDA all-to-all: "
         f"{r0['gloo_cuda_all_to_all']} [{smi}]")
    _log(f"[32b] NCCL at one rank: loss {nccl['loss']:.6f}, fit_batch "
         f"{nccl['ref_loss']:.6f}, the same bits: {nccl['bits_equal']}; step "
         f"{nccl['step_ms']:.1f} ms [{smi}]")
    if not ok:
        raise AssertionError(f"[32b] expert-parallel step off: {r0}, ranks "
                             f"alike {same}")
    if not nccl["bits_equal"]:
        raise AssertionError(f"[32b] NCCL one-rank EP differs from "
                             f"fit_batch: {nccl}")
    return {"gloo": gloo, "nccl": nccl, "seconds": wall,
            "ranks_same_bits": same}


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def moe_phase(torch, dev, smi) -> tuple:
    """[32]: returns the ``{"moe": ...}`` line and rows 6-8's ``moe``
    entries for the kernels line."""
    t_start = time.monotonic()
    one = train_moe(torch, dev, smi)
    across = experts_across_ranks(torch, smi)
    wall = time.monotonic() - t_start
    _log(f"[32] the MoE transformer in {wall:.1f} s [{smi}]")
    scope = ("[32a]: the GPT-2-small-width 8-expert MoE LM's kernel-route "
             f"fit, {MOE_STEPS} steps at {cs.LM_BATCH} x "
             f"{MOE_MODEL['max_len']} tokens, as counted ("
             f"{MOE_MODEL['n_layers']} a step)")
    names = {"flash_attention": "flash_attention",
             "flash_attention_bwd_dq": "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv": "flash_attention_bwd_dkv"}
    rows = {names[k]: {"launches": n, "scope": scope}
            for k, n in one["launches"].items()}
    line = {"card": smi, "seconds": wall, "model": MOE_MODEL,
            "one_rank": one,
            "expert_parallel": {
                "gloo_rank0": across["gloo"][0],
                "gloo_step_ms": [r["step_ms"] for r in across["gloo"]],
                "nccl": across["nccl"], "seconds": across["seconds"],
                "ranks_same_bits": across["ranks_same_bits"]}}
    return line, rows


def spread(torch, dev, n, smi) -> dict:
    """(a)'s route errors and flips at ``n`` seeds from ``MOE_SEED`` on,
    no gate applied: the readings its limits are set from."""
    out = []
    for seed in range(MOE_SEED, MOE_SEED + n):
        net, ref, ds = moe_pair(torch, dev, seed)
        routes = route_errors(torch, net, ref, ds)
        err = train_errors(torch, net, ref, ds)
        row = {"seed": seed, "flips": routes["flips"],
               "primary": routes["primary"],
               "margin": min(routes["margin"]),
               "logit_rel_l2_clean": routes["logit_rel_l2_clean"],
               "tokens_clean": routes["tokens_clean"],
               "one_pass": routes["one_pass"],
               "grad": cs._summary(err["grad"]),
               "loss_rel_err": err["loss_rel_err"],
               "losses": err["losses_kernel"], "params": err["params"]}
        out.append(row)
        _log(f"[32 spread] {json.dumps(row)} [{smi}]")
        del net, ref, ds
        torch.cuda.empty_cache()
    return {"runs": out}


def main() -> int:
    """The build and [32] alone, or ``--spread N``."""
    import argparse
    import sys

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="read (a)'s errors at N seeds instead")
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
    if args.spread:
        _log(json.dumps({"moe_spread": spread(torch, dev, args.spread, smi),
                         "card": smi}))
        return 0
    line, rows = moe_phase(torch, dev, smi)
    _log(json.dumps({"moe": line, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
