#!/usr/bin/env python3
"""Phases [27] and [28] of ``chip_smoke.py``: the sequence layers on one
H100.

[27] Path A, the zoo's ``TextGenerationLSTM`` at full width (47
characters, ``LSTM(256)`` x 2, softmax ``RnnOutputLayer``, Adam(1e-3),
XAVIER; 848,687 params, seeded) trained by ``MultiLayerNetwork.fit_batch``
with truncated BPTT (fwd = back = 50) on a seeded order-2 Markov character
stream (batch 32, T 200, one-hot features, next-character labels), then
sampled with ``rnn_time_step``:

- (a) the card against the port's CPU run on the same params and batches
  (TF32 off): the standard forward at T 200, every segment's loss of two
  tBPTT ``fit_batch`` calls (4 segments each), params and Adam state
  after them;
- (b) tBPTT with one segment (fwd = back = T) against ``STANDARD`` on the
  card;
- (c) back 25 < fwd 50 at T 230 (the tail padded before its real steps) against the CPU
  as in (a);
- (d) the planted control: the same fit with the carries zeroed at every
  segment must miss (a)'s gates;
- (e) a 40-character prime, then 200 greedy one-character
  ``rnn_time_step`` steps for 32 streams: the streamed softmax outputs
  against one ``output`` over the generated sequence, and
  ``rnn_get_previous_state`` / ``rnn_clear_previous_state`` /
  ``rnn_set_previous_state`` mid-stream resuming bit for bit;
- (f) ms and kernel launches a segment and the idle share
  (``torch.profiler``), generated characters/s, peak memory.

[28] Path B, sequence attention on the flash kernels (rows 6-8):

- (a) is in ``chip_smoke.py``'s [9] and [13]: the kernels against their
  plain versions at ``SEQ_ATTN_CASES`` (B 32, H 4, Tq 8 and 1, Tk 512,
  D 64, non-causal, ragged key mask with lengths in [256, 512]), float32
  and bfloat16;
- (b) ``[LSTM(256), LearnedSelfAttentionLayer(n_out=256, n_heads=4,
  head_size=64, n_queries=8, attention_impl="flash"), RnnOutputLayer(47)]``
  over ``InputType.recurrent(47, 512)``, batch 32, the ragged features
  mask, one-hot [32, 8, 47] labels, Adam(1e-3): three steps (gradients by
  ``compute_gradient_and_score``, per tensor and over all, the key bias's
  zero gradient in the latter only; then ``fit_batch``) against the same
  weights with ``attention_impl="reference"`` on the card; one forward,
  one dq and one dk/dv launch a step; ``output`` launches the forward
  once;
- (c) ``RecurrentAttentionLayer(n_out=256, n_heads=4)``, batch 8, T 128,
  masked: forward and gradients on the card against the port's CPU run;
- (d) rows 6-8 at (a)'s geometry: CUDA events, device time, the bound,
  the plain version and masked SDPA (its autograd for the backward).

``python3 chip_sequence.py`` builds the kernels and runs [28a], [27] and
[28] alone.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

import chip_smoke as cs

TEXT_BATCH = 32
TEXT_T = 200
TEXT_SEG = 50
TEXT_BACK = 25
TEXT_T_RAGGED = 230  # not a multiple of TEXT_SEG: a padded tail segment
TEXT_PRIME = 40
TEXT_GEN = 200
TEXT_RESUME_AT = 100
TEXT_SEED = 27
TEXT_FITS = 2
TEXT_PROFILE_FITS = 2
# card against the CPU, float32 with TF32 off: the same float32 function
# summed in other orders (cuBLAS against MKL) over 200 steps of two tanh
# LSTMs; the outputs by relative L2 (softmax outputs ~1/47), each segment's
# loss elementwise, params and Adam state per tensor by relative L2 after
# 8 Adam steps (near-zero gradients whose sign flips move a weight 2 lr:
# the L2 over a tensor stays small)
TEXT_OUT_RTOL = 1e-5
TEXT_LOSS_RTOL = 1e-5
TEXT_STATE_RTOL = 1e-4
# tBPTT with one segment against STANDARD on the card: the same kernels on
# the same operands; the masked loss reduces in another order
TEXT_ONE_SEG_RTOL = 1e-6
TEXT_STREAM_RTOL = 1e-5

SEQ_MODEL = dict(n_in=47, t=512, lstm=256, n_out=256, n_heads=4,
                 head_size=64, n_queries=8)
SEQ_BATCH = 32
SEQ_STEPS = 3
SEQ_SEED = 28
# flash against the reference core on the card: float32, the kernel's
# online softmax and 3xTF32 products against one materialized softmax
# (ATTN_TOL 2e-5 per element), through an LSTM over 512 steps
SEQ_LOSS_RTOL = 1e-5
SEQ_GRAD_RTOL = 1e-4
# the key projection's bias has a gradient of exactly 0 (it adds one
# constant to a query's scores, which softmax ignores): rounding noise on
# both sides, held in the global error only (chip_smoke's LM_ZERO_GRADS)
SEQ_ZERO_GRADS = ("bk",)
RATT = dict(n_out=256, n_heads=4, batch=8, t=128, n_in=47)
RATT_RTOL = 1e-5


def _rel(a, b) -> float:
    """|a - b| / |b| (L2) of two tensors or arrays, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / (den if den > 0 else 1.0)


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree_errors(a, b, prefix="") -> dict:
    """{path: relative L2} of every tensor of two nested dicts."""
    out = {}
    for k in b:
        if isinstance(b[k], dict):
            out.update(_tree_errors(a[k], b[k], f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _rel(_host(a[k]), _host(b[k]))
    return out


def markov_text(n: int, length: int, vocab: int, seed: int) -> np.ndarray:
    """``[n, length]`` int64 characters of a seeded order-2 Markov chain
    over ``vocab`` symbols (sparse transition rows, Dirichlet 0.1)."""
    rng = np.random.default_rng(seed)
    cum = rng.dirichlet(np.full(vocab, 0.1), size=(vocab, vocab)).cumsum(-1)
    chars = np.empty((n, length), np.int64)
    chars[:, :2] = rng.integers(0, vocab, (n, 2))
    for t in range(2, length):
        u = rng.random(n)[:, None]
        nxt = (u > cum[chars[:, t - 2], chars[:, t - 1]]).sum(-1)
        chars[:, t] = np.minimum(nxt, vocab - 1)
    return chars


def one_hot(chars, vocab: int) -> np.ndarray:
    return np.eye(vocab, dtype=np.float32)[chars]


def text_batches(n_batches: int, t: int, vocab: int, seed: int):
    """DataSets of ``TEXT_BATCH`` sequences of ``t`` one-hot characters
    and their next characters."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    chars = markov_text(n_batches * TEXT_BATCH, t + 1, vocab, seed)
    out = []
    for i in range(n_batches):
        c = chars[i * TEXT_BATCH:(i + 1) * TEXT_BATCH]
        out.append(DataSet(one_hot(c[:, :-1], vocab),
                           one_hot(c[:, 1:], vocab)))
    return out


def _text_conf(fwd=None, back=None):
    from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    conf = TextGenerationLSTM().conf()
    if fwd is None:
        return conf
    return dataclasses.replace(conf,
                               backprop_type=BackpropType.TRUNCATED_BPTT,
                               tbptt_fwd_length=fwd, tbptt_back_length=back)


def _pair(torch, dev, conf, params, state):
    """The network on the card and on the CPU from the same params."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    card = MultiLayerNetwork(conf, dev).set_params(params, state)
    cpu = MultiLayerNetwork(conf, "cpu").set_params(params, state)
    return card, cpu


def _fit_against_cpu(torch, card, cpu, batches, label) -> dict:
    """``fit_batch`` on both over ``batches``: every segment's loss
    elementwise, then params and Adam state per tensor."""
    seg_err = []
    for ds in batches:
        card.fit_batch(ds)
        cpu.fit_batch(ds)
        a, b = (_host(n.last_segment_losses) for n in (card, cpu))
        seg_err.append([float(e) for e in np.abs(a - b) / np.abs(b)])
    torch.cuda.synchronize()
    p_err = _tree_errors(card.params, cpu.params)
    o_err = _tree_errors(card.opt_state, cpu.opt_state)
    worst_loss = max(max(e) for e in seg_err)
    worst_state = max(list(p_err.values()) + list(o_err.values()))
    return {"label": label, "segments": [len(e) for e in seg_err],
            "segment_loss_rel": seg_err, "worst_loss_rel": worst_loss,
            "worst_state_rel_l2": worst_state,
            "passes": (worst_loss <= TEXT_LOSS_RTOL
                       and worst_state <= TEXT_STATE_RTOL),
            "iterations": [card.iteration, cpu.iteration]}


def _zeroed_carries(net):
    """The planted control: ``net``'s tBPTT segments start from zero
    carries (the carry threading cut)."""
    backward = net._backward

    def run(*args, carries=None, **kw):
        if carries is not None:
            for k, c in carries.items():
                carries[k] = {n: t.new_zeros(t.shape) for n, t in c.items()}
        return backward(*args, carries=carries, **kw)

    net._backward = run
    return net


def _sample(torch, net, prime, vocab, resume_at=None):
    """Greedy sampling: the prime through ``rnn_time_step``, then
    ``TEXT_GEN`` one-character steps; with ``resume_at`` the carries are
    read, cleared and set back before that step. Returns (streamed outputs
    [B, prime + gen, vocab], the characters fed after the prime, seconds
    of the generation loop)."""
    net.rnn_clear_previous_state()
    outs = [net.rnn_time_step(one_hot(prime, vocab))]
    c = outs[-1][:, -1].argmax(-1)
    fed = []
    t0 = time.monotonic()
    for i in range(TEXT_GEN):
        if i == resume_at:
            states = {j: net.rnn_get_previous_state(j) for j in (0, 1)}
            net.rnn_clear_previous_state()
            for j, s in states.items():
                net.rnn_set_previous_state(j, s)
        y = net.rnn_time_step(one_hot(c, vocab))  # [B, 1, vocab]
        outs.append(y)
        fed.append(c)
        c = y[:, 0].argmax(-1)
    seconds = time.monotonic() - t0
    return np.concatenate(outs, axis=1), np.stack(fed, axis=1), seconds


def text_generation(torch, dev, smi) -> dict:
    """[27] (see the module docstring)."""
    from deeplearning4j_tpu_torch.conf.multilayer import BackpropType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t_start = time.monotonic()
    vocab = 47
    conf = _text_conf(TEXT_SEG, TEXT_SEG)
    seed_net = MultiLayerNetwork(conf, "cpu").init()
    p0, s0 = seed_net.params, seed_net.state
    n_params = seed_net.num_params()
    batches = text_batches(TEXT_FITS, TEXT_T, vocab, TEXT_SEED)
    line = {"card": smi, "params": n_params, "batch": TEXT_BATCH,
            "t": TEXT_T, "tbptt": [TEXT_SEG, TEXT_SEG]}
    failures = []

    # (a) the card against the CPU
    card, cpu = _pair(torch, dev, conf, p0, s0)
    x = batches[0].features
    out_err = _rel(card.output(x), cpu.output(x))
    line["forward_rel_l2"] = out_err
    if out_err > TEXT_OUT_RTOL:
        failures.append(f"(a) forward rel L2 {out_err} > {TEXT_OUT_RTOL}")
    a = _fit_against_cpu(torch, card, cpu, batches, "a")
    line["a"] = a
    if not a["passes"] or a["segments"] != [TEXT_T // TEXT_SEG] * TEXT_FITS:
        failures.append(f"(a) card vs CPU: {a}")
    cs.log(f"[27a] TextGenerationLSTM ({n_params:,} params, B {TEXT_BATCH}, "
         f"T {TEXT_T}, tBPTT {TEXT_SEG}/{TEXT_SEG}): forward rel L2 "
         f"{out_err:.3e} (<= {TEXT_OUT_RTOL}); {TEXT_FITS} fit_batch x "
         f"{a['segments'][0]} segments, worst segment loss rel "
         f"{a['worst_loss_rel']:.3e} (<= {TEXT_LOSS_RTOL}), params and "
         f"Adam state worst rel L2 {a['worst_state_rel_l2']:.3e} (<= "
         f"{TEXT_STATE_RTOL})")

    # (d) the planted control: zeroed carries must miss (a)'s gates
    ctl = _zeroed_carries(MultiLayerNetwork(conf, dev).set_params(p0, s0))
    ref = MultiLayerNetwork(conf, "cpu").set_params(p0, s0)
    d = _fit_against_cpu(torch, ctl, ref, batches, "d")
    line["d_control"] = d
    if d["passes"]:
        failures.append(f"(d) the zeroed-carry control passed (a)'s gates: "
                        f"{d}")
    cs.log(f"[27d] planted control (carries zeroed every segment): worst "
         f"segment loss rel {d['worst_loss_rel']:.3e}, state rel L2 "
         f"{d['worst_state_rel_l2']:.3e}: "
         f"{'caught' if not d['passes'] else 'MISSED'}")
    del ctl, ref

    # (b) one segment is standard backprop
    one = _text_conf(TEXT_T, TEXT_T)
    std = dataclasses.replace(one, backprop_type=BackpropType.STANDARD)
    nets = [MultiLayerNetwork(c, dev).set_params(p0, s0) for c in (one, std)]
    losses = [n.fit_batch(batches[0]) for n in nets]
    b_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    b_state = max(_tree_errors(nets[0].params, nets[1].params).values())
    line["b"] = {"loss_rel": b_loss, "params_rel_l2": b_state,
                 "segments": len(nets[0].last_segment_losses)}
    if b_loss > TEXT_ONE_SEG_RTOL or b_state > TEXT_ONE_SEG_RTOL \
            or line["b"]["segments"] != 1:
        failures.append(f"(b) one-segment tBPTT vs STANDARD: {line['b']}")
    cs.log(f"[27b] tBPTT {TEXT_T}/{TEXT_T} (one segment) vs STANDARD on the "
         f"card: loss rel {b_loss:.3e}, params rel L2 {b_state:.3e} (<= "
         f"{TEXT_ONE_SEG_RTOL})")
    del nets

    # (c) back < fwd with the tail padded before its real steps
    conf_c = _text_conf(TEXT_SEG, TEXT_BACK)
    card_c, cpu_c = _pair(torch, dev, conf_c, p0, s0)
    c = _fit_against_cpu(torch, card_c, cpu_c,
                         text_batches(TEXT_FITS, TEXT_T_RAGGED, vocab,
                                      TEXT_SEED + 1), "c")
    line["c"] = c
    want = -(-TEXT_T_RAGGED // TEXT_SEG)
    if not c["passes"] or c["segments"] != [want] * TEXT_FITS:
        failures.append(f"(c) back < fwd card vs CPU: {c}")
    cs.log(f"[27c] tBPTT {TEXT_SEG}/{TEXT_BACK} at T {TEXT_T_RAGGED} "
         f"(padded to {want * TEXT_SEG}, {want} segments): worst "
         f"segment loss rel {c['worst_loss_rel']:.3e}, state rel L2 "
         f"{c['worst_state_rel_l2']:.3e}")
    del card_c, cpu_c, cpu

    # (e) sampling with rnn_time_step
    prime = markov_text(TEXT_BATCH, TEXT_PRIME, vocab, TEXT_SEED + 2)
    streamed, fed, seconds = _sample(torch, card, prime, vocab)
    full = card.output(one_hot(np.concatenate([prime, fed], axis=1), vocab))
    stream_err = _rel(streamed, full)
    resumed, fed2, _ = _sample(torch, card, prime, vocab, TEXT_RESUME_AT)
    bits = bool(np.array_equal(resumed, streamed)
                and np.array_equal(fed, fed2))
    chars_per_s = TEXT_BATCH * TEXT_GEN / seconds
    line["e"] = {"streams": TEXT_BATCH, "prime": TEXT_PRIME,
                 "generated": TEXT_GEN, "stream_rel_l2": stream_err,
                 "resume_bits": bits, "chars_per_s": chars_per_s,
                 "step_ms": seconds / TEXT_GEN * 1e3,
                 "distinct_chars": int(len(np.unique(fed)))}
    if stream_err > TEXT_STREAM_RTOL or not bits:
        failures.append(f"(e) sampling: {line['e']}")
    cs.log(f"[27e] {TEXT_BATCH} streams, {TEXT_PRIME}-character prime + "
         f"{TEXT_GEN} greedy rnn_time_step steps: streamed vs one output "
         f"rel L2 {stream_err:.3e} (<= {TEXT_STREAM_RTOL}); get / clear / "
         f"set at step {TEXT_RESUME_AT} resumes bit for bit: {bits}; "
         f"{chars_per_s:.1f} characters/s ({seconds / TEXT_GEN * 1e3:.3f} "
         f"ms a step) [{smi}]")

    # (f) times
    ds = batches[0]
    n_seg = TEXT_T // TEXT_SEG
    prof = cs._profile_steps(torch, card, ds, TEXT_PROFILE_FITS)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(TEXT_PROFILE_FITS):
        card.fit_batch(ds)
    torch.cuda.synchronize()
    untraced = (time.monotonic() - t0) / TEXT_PROFILE_FITS / n_seg * 1e3
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card.fit_batch(ds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = cs.cuda_time_ms(lambda: card.output(ds.features), samples=3)
    line["f"] = {
        "segment_ms": untraced,
        "segment_ms_traced": prof["wall_ms"] / n_seg,
        "segment_device_ms": prof["device_ms"] / n_seg,
        "launches_per_segment": prof["kernel_launches_per_step"] / n_seg,
        "idle_share": prof["idle_share"],
        "top": prof["top"], "host_top": prof["host_top"],
        "peak_mib": peak / 2 ** 20, "peak_above_params_mib":
            (peak - base) / 2 ** 20,
        "forward_ms_t200": fwd_ms,
        "chars_per_s": chars_per_s}
    f = line["f"]
    cs.log(f"[27f] a tBPTT segment (B {TEXT_BATCH} x {TEXT_SEG} steps): "
         f"{f['segment_ms']:.2f} ms wall ({f['segment_ms_traced']:.2f} "
         f"under the profiler), {f['segment_device_ms']:.2f} ms device, "
         f"{f['launches_per_segment']:.0f} kernel launches, idle "
         f"{f['idle_share']:.1%} (traced); forward at T {TEXT_T} "
         f"{fwd_ms:.2f} ms; peak {f['peak_mib']:.1f} MiB "
         f"({f['peak_above_params_mib']:.1f} above the resident state); "
         f"{chars_per_s:.1f} characters/s [{smi}]")
    cs.log(f"[27f] device top: {prof['top']}; host top: {prof['host_top']}")
    line["seconds"] = time.monotonic() - t_start
    if failures:
        raise AssertionError("[27] " + "; ".join(failures))
    return line


# --------------------------------------------------------------------------
# [28] sequence attention
# --------------------------------------------------------------------------

def seq_mask(torch, gen, dev, b, tk):
    """A float [B, Tk] length mask with lengths drawn in [Tk/2, Tk]."""
    lengths = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device=dev)
    return (torch.arange(tk, device=dev)[None, :] < lengths[:, None]).float()


def _seq_conf(impl):
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        LearnedSelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_rnn import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.conf.updaters import Adam

    m = SEQ_MODEL
    return (NeuralNetConfiguration.builder().seed(SEQ_SEED)
            .updater(Adam(learning_rate=1e-3)).list()
            .layer(LSTM(n_out=m["lstm"]))
            .layer(LearnedSelfAttentionLayer(
                n_out=m["n_out"], n_heads=m["n_heads"],
                head_size=m["head_size"], n_queries=m["n_queries"],
                attention_impl=impl))
            .layer(RnnOutputLayer(n_out=m["n_in"],
                                  activation=Activation.SOFTMAX,
                                  loss_fn=LossMCXENT()))
            .set_input_type(InputType.recurrent(m["n_in"], m["t"]))
            .build())


def _seq_batch(seed):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    m = SEQ_MODEL
    rng = np.random.default_rng(seed)
    chars = markov_text(SEQ_BATCH, m["t"], m["n_in"], seed)
    lengths = rng.integers(m["t"] // 2, m["t"] + 1, SEQ_BATCH)
    lengths[0] = m["t"]
    mask = (np.arange(m["t"])[None, :] < lengths[:, None]).astype(np.float32)
    labels = one_hot(rng.integers(0, m["n_in"], (SEQ_BATCH,
                                                 m["n_queries"])), m["n_in"])
    return DataSet(one_hot(chars, m["n_in"]), labels, features_mask=mask)


def seq_model(torch, dev, att) -> dict:
    """[28b] the LSTM + LearnedSelfAttentionLayer model, flash against the
    reference core on the card."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    flash = MultiLayerNetwork(_seq_conf("flash"), dev).init()
    ref = MultiLayerNetwork(_seq_conf("reference"), dev).set_params(
        flash.params, flash.state)
    ds = _seq_batch(SEQ_SEED)
    out = {"steps": [], "launches_per_step": []}
    failures = []
    for step in range(SEQ_STEPS):
        g_f, s_f = flash.compute_gradient_and_score(ds)
        g_r, s_r = ref.compute_gradient_and_score(ds)
        grad = cs._grad_errors(g_f, g_r, skip=SEQ_ZERO_GRADS)
        cs._reset_attention_launches(att)
        l_f = flash.fit_batch(ds)
        torch.cuda.synchronize()
        launches = cs._attention_launches(att)
        l_r = ref.fit_batch(ds)
        loss_rel = abs(l_f - l_r) / abs(l_r)
        worst, name = grad["tensor_l2"][0]
        worst = max(worst, grad["global_l2"])
        out["steps"].append({"loss": [l_f, l_r], "loss_rel": loss_rel,
                             "score_rel": abs(s_f - s_r) / abs(s_r),
                             "grad_global_rel_l2": grad["global_l2"],
                             "grad_worst_rel_l2": worst,
                             "grad_worst": name})
        out["launches_per_step"].append(launches)
        if loss_rel > SEQ_LOSS_RTOL or worst > SEQ_GRAD_RTOL:
            failures.append(f"step {step + 1}: {out['steps'][-1]}")
        if any(n != 1 for n in launches.values()):
            failures.append(f"step {step + 1} launches {launches}")
    cs._reset_attention_launches(att)
    y = flash.output(ds.features, fmask=ds.features_mask)
    torch.cuda.synchronize()
    out["output_launches"] = cs._attention_launches(att)
    y_ref = ref.output(ds.features, fmask=ds.features_mask)
    out["output_rel_l2"] = _rel(y, y_ref)
    if out["output_launches"] != {"flash_attention": 1,
                                  "flash_attention_bwd_dq": 0,
                                  "flash_attention_bwd_dkv": 0}:
        failures.append(f"output launches {out['output_launches']}")
    if out["output_rel_l2"] > SEQ_LOSS_RTOL or y.shape != (
            SEQ_BATCH, SEQ_MODEL["n_queries"], SEQ_MODEL["n_in"]):
        failures.append(f"output {y.shape} rel {out['output_rel_l2']}")
    out["params"] = flash.num_params()
    if failures:
        raise AssertionError("[28b] " + "; ".join(failures))
    return out


def recurrent_attention(torch, dev) -> dict:
    """[28c] RecurrentAttentionLayer's forward and gradients, the card
    against the CPU."""
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        RecurrentAttentionLayer,
    )

    r = RATT
    layer = RecurrentAttentionLayer(n_out=r["n_out"], n_heads=r["n_heads"])
    gen = torch.Generator().manual_seed(SEQ_SEED)
    params = layer.init(gen, InputType.recurrent(r["n_in"], r["t"]))
    rng = np.random.default_rng(SEQ_SEED)
    x = torch.tensor(rng.normal(size=(r["batch"], r["t"], r["n_in"])),
                     dtype=torch.float32)
    lengths = rng.integers(r["t"] // 2, r["t"] + 1, r["batch"])
    mask = torch.tensor(np.arange(r["t"])[None, :] < lengths[:, None],
                        dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(r["batch"], r["t"], r["n_out"])),
                     dtype=torch.float32)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = {k: v.to(d).requires_grad_() for k, v in params.items()}
        xi = x.to(d).requires_grad_()
        y, _ = layer.forward(p, {}, xi, mask=mask.to(d))
        grads = torch.autograd.grad((y * w.to(d)).sum(), [xi] + list(
            p.values()))
        res[name] = (y, dict(zip(["x"] + list(p), grads)))
    errs = {"y": _rel(_host(res["card"][0]), _host(res["cpu"][0]))}
    errs.update({f"d{k}": _rel(_host(res["card"][1][k]),
                               _host(res["cpu"][1][k]))
                 for k in res["cpu"][1]})
    worst = max(errs.values())
    if worst > RATT_RTOL:
        raise AssertionError(f"[28c] RecurrentAttentionLayer card vs CPU: "
                             f"{errs} (> {RATT_RTOL})")
    return {"rel_l2": errs, "worst": worst}


def _seq_bound_ms(b, h, tq, tk, d, products, tq_tensors, tk_tensors,
                  vectors, size):
    """(operations ms, bytes ms) of one launch at [B, H, Tq | Tk, D],
    non-causal, every key counted: ``products`` matrix products of
    2·B·H·Tq·Tk·D at the FFMA peak (float32) or the bf16 tensor-core
    peak; ``tq_tensors`` / ``tk_tensors`` [B, H, Tq | Tk, D] operands
    read or written once, ``vectors`` f32 [B, H, Tq] rows, the f32 key
    mask once."""
    peak = cs.PEAK_OPS_PER_S["float32" if size == 4 else "bfloat16"]
    ops = products * 2.0 * b * h * tq * tk * d
    nbytes = ((tq_tensors * tq + tk_tensors * tk) * b * h * d * size
              + vectors * b * h * tq * 4 + b * tk * 4)
    return ops / peak * 1e3, nbytes / cs.HBM_BYTES_PER_S * 1e3


def _bound_fields(ops_ms, bytes_ms):
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def time_seq_attention(torch, F, att, dev, launches) -> dict:
    """[28d] rows 6-8 at the layer's geometry (``cs.SEQ_ATTN_CASES``),
    float32: CUDA events around the wrapper, device time, the bound, the
    plain version, masked SDPA (its autograd for the backward rows, dq,
    dk and dv together)."""
    gen = torch.Generator(device=dev).manual_seed(SEQ_SEED + 1)
    rows = {"flash_attention": [], "flash_attention_bwd_dq": [],
            "flash_attention_bwd_dkv": []}
    for b, h, tq, tk, d in cs.SEQ_ATTN_CASES:
        q = torch.randn((b, h, tq, d), generator=gen, device=dev)
        k, v = (torch.randn((b, h, tk, d), generator=gen, device=dev)
                for _ in range(2))
        do = torch.randn((b, h, tq, d), generator=gen, device=dev)
        km = seq_mask(torch, gen, dev, b, tk)
        keep = (km > 0)[:, None, None, :]
        sm = 1.0 / math.sqrt(d)
        o, l, m = att.flash_attention(q, k, v, km, False, return_stats=True)
        ops = att.bwd_operands(q, k, v, km, o, l, m, do)
        dq, di = att._flash_dq_cuda(*ops, False, sm)
        dk, dv = att._flash_dkv_cuda(*ops[:4], l, m, di, do, False, sm)
        ref = att.flash_attention_bwd_plain(q, k, v, km, o, l, m, do, False)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_o = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
        bwd_plain = cs.cuda_time_ms(lambda: att.flash_attention_bwd_plain(
            q, k, v, km, o, l, m, do, False))
        bwd_lib = cs.cuda_time_ms(lambda: torch.autograd.grad(
            lib_o, leaves, do, retain_graph=True))
        geo = {"b": b, "h": h, "tq": tq, "tk": tk, "d": d}

        def fwd():
            return att.flash_attention(q, k, v, km, False)

        rows["flash_attention"].append({
            **geo, "max_abs_err": float(
                (o - att.flash_attention_plain(q, k, v, km, False)[0])
                .abs().max()),
            "ms": cs.cuda_time_ms(fwd),
            "device_ms": cs.device_ms(fwd, ["fwd_kernel"]),
            "plain_ms": cs.cuda_time_ms(
                lambda: att.flash_attention_plain(q, k, v, km, False)),
            "library_ms": cs.cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=keep)),
            **_bound_fields(*_seq_bound_ms(b, h, tq, tk, d, 2, 2, 2, 2, 4))})

        def dq_fn():
            return att._flash_dq_cuda(*ops, False, sm)

        def dkv_fn():
            return att._flash_dkv_cuda(*ops[:4], l, m, di, do, False, sm)

        # dq: s, dp and ds . k; reads q, do, o, k, v, l, m; writes dq, di
        rows["flash_attention_bwd_dq"].append({
            **geo, "max_abs_err": float((dq - ref[0]).abs().max()),
            "ms": cs.cuda_time_ms(dq_fn),
            "device_ms": cs.device_ms(dq_fn, ["dq_kernel"]),
            "plain_ms": bwd_plain, "library_ms": bwd_lib,
            **_bound_fields(*_seq_bound_ms(b, h, tq, tk, d, 3, 4, 2, 3, 4))})
        # dk / dv: s, dp, ds^T . q and p^T . do; reads q, do, k, v, l, m,
        # di; writes dk, dv
        rows["flash_attention_bwd_dkv"].append({
            **geo, "max_abs_err": max(float((g - r).abs().max())
                                      for g, r in zip((dk, dv), ref[1:])),
            "ms": cs.cuda_time_ms(dkv_fn),
            "device_ms": cs.device_ms(dkv_fn, ["dkv_kernel"]),
            "plain_ms": bwd_plain, "library_ms": bwd_lib,
            **_bound_fields(*_seq_bound_ms(b, h, tq, tk, d, 4, 2, 4, 3, 4))})
    for name, rs in rows.items():
        for r in rs:
            r["launches_on_path"] = launches.get(name)
    return rows


def sequence_attention(torch, F, att, dev, smi) -> tuple:
    """[28] (b)-(d); (a) runs in chip_smoke's [9] and [13]. Returns (the
    ``{"sequence_attention": ...}`` line, {kernel: rows at the layer's
    geometry})."""
    t0 = time.monotonic()
    model = seq_model(torch, dev, att)
    s = model["steps"]
    cs.log(f"[28b] LSTM(256) + LearnedSelfAttentionLayer(256, 4 heads x 64, "
         f"8 queries, flash) + RnnOutputLayer(47), {model['params']:,} "
         f"params, B {SEQ_BATCH} x T {SEQ_MODEL['t']} ragged mask: "
         f"{SEQ_STEPS} steps flash vs reference, worst loss rel "
         f"{max(x['loss_rel'] for x in s):.3e} (<= {SEQ_LOSS_RTOL}), worst "
         f"gradient rel L2 {max(x['grad_worst_rel_l2'] for x in s):.3e} "
         f"(<= {SEQ_GRAD_RTOL}); launches a step "
         f"{model['launches_per_step'][0]}; output launches "
         f"{model['output_launches']}")
    ratt = recurrent_attention(torch, dev)
    cs.log(f"[28c] RecurrentAttentionLayer(256, 4 heads), B {RATT['batch']} "
         f"x T {RATT['t']} masked: card vs CPU worst rel L2 "
         f"{ratt['worst']:.3e} (<= {RATT_RTOL})")
    rows = time_seq_attention(torch, F, att, dev,
                              model["launches_per_step"][0])
    for name, rs in rows.items():
        for r in rs:
            cs.log(f"[28d] {name} B={r['b']} H={r['h']} Tq={r['tq']} "
                 f"Tk={r['tk']} D={r['d']} masked: kernel {r['ms']:.4f} ms "
                 f"(device {r['device_ms']}), plain {r['plain_ms']:.4f}, "
                 f"masked SDPA {r['library_ms']:.4f}, bound "
                 f"{r['bound_ms']:.5f} ({r['bound_by']}, FFMA) [{smi}]")
    line = {"card": smi, "model": model, "recurrent_attention": ratt,
            "seconds": time.monotonic() - t0}
    return line, rows


def main() -> int:
    """The build, [28a] (the kernel checks at the layer's geometry), [27]
    and [28] alone."""
    import json
    import sys

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.ops import attention as att

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    t0 = time.monotonic()
    build.build_all(impls.SOURCES)
    cs.log(f"[2] nvcc built {', '.join(impls.SOURCES)} in "
         f"{time.monotonic() - t0:.1f} s")
    cs.check_flash(torch, att, dev, cases=(), suffix=False)
    cs.check_flash_bwd(torch, att, dev, cases=())
    text = text_generation(torch, dev, smi)
    seq, rows = sequence_attention(torch, F, att, dev, smi)
    cs.log(json.dumps({"trained_text_lstm": text}))
    cs.log(json.dumps({"sequence_attention": seq, "rows": rows}))
    cs.log(f"[28] total {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
