#!/usr/bin/env python3
"""Drive the PyTorch port (``deeplearning4j_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` (nvcc,
   sm_90a), print each kernel's registers and spills as ptxas reports
   them, and hold the probe kernel against its plain version;
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
8. training timings: ``matmul_stats`` per shape (CUDA events around the
   wrapper, and the kernel's device time from ``torch.profiler``) beside
   its plain version, ``F.linear`` (the matmul part alone: no single
   PyTorch call also sums the columns), the stock composite that computes
   the same function (``F.linear``, then ``y.sum(0)`` and
   ``(y*y).sum(0)``) and the bound, and the train step at batch 32, kernel
   route against stock;
9. ``flash_attention`` against its plain version on the card: every
   (join bucket 1/2/4/8, prompt bucket 8..1024) at 12 heads x 64, causal
   with a prompt-length mask (a length-0 padding row included), ragged T
   333 and 1000, one bidirectional unmasked case, Tq < Tk, and head sizes
   32, 33 (rows off 16 bytes) and 128 (the tensor-core kernel) and 256
   (the FFMA kernel); float32 and bfloat16; o, l and m, every row finite,
   a fully masked row included; a CUDA input that requires grad gets its
   gradient from the backward kernels;
10. ``paged_decode_attention`` against its plain version at 8 rows x 12
   heads, head sizes 64 (the path's), 32, 128 and 256, each cache length
   of the KV ladder (64..1024), positions 0, 63, 64, S-1 and S (the whole
   cache) among them; float32 and bfloat16; position -1 gives zeros, and a
   row decoded alone gives the same bits as inside a batch;
11. the generation path: a causal LM at GPT-2 small's widths (vocab 50257,
   768 wide, 12 heads, 12 layers, max_len 1024, seeded weights, float32,
   ``use_kernels=True``) served by ``GenerationEngine(max_batch=8,
   fused_steps=4, kv_bucket_min=64, prompt_bucket_min=8)``: 16 greedy
   requests (prompts of 5-896 seeded tokens, 32 new tokens, one with an
   eos_id); the kernels' launches counted over the engine run alone (12
   flash per prefill, 12 paged per decode step); every stream held against
   sequential ``TransformerDecoder.generate`` and against a
   ``use_kernels=False`` decoder on the same weights (identical, or parting
   only at a near tie of the reference's logits), and prefill logits
   against the stock route;
12. generation timings: both attention kernels at the engine run's shapes
   (the decode kernel's device time from ``torch.profiler`` beside its
   CUDA-event time, which a launch this short leaves to the wrapper's host
   work) beside their plain versions, SDPA and the bound, and the engine's
   tokens/s, TTFT and per-token latency, kernel route against stock;
13. the flash backward kernels (dq, dk/dv) against
   ``flash_attention_bwd_plain`` on the card: 8 x 1024 causal unmasked and
   masked, ragged T 333 and 1000, 8 x 512 bidirectional masked, Tq < Tk,
   head sizes 32, 64 and 128 (the tensor-core kernels) and 256 (the FFMA
   kernels); float32 and bfloat16; a length-0 mask row
   leaves every gradient finite; the whole Function against float64
   autograd of ``reference_attention``;
14. the transformer's training path: the GPT-2-small-width LM (seeded
   weights, float32, Adam(1e-3)) trained by ``fit`` with
   ``use_kernels=True`` on 8 x 1024 seeded tokens with one-hot next-token
   labels built on the card: 12 flash, 12 dq and 12 dk/dv launches per
   step over the fit alone, the loss falls over 5 steps, and step-1
   gradients and 3 losses agree with ``use_kernels=False``; then a batch
   with a ragged length mask as features and labels mask, and the
   bidirectional classifier (2 layers, T 512, masked), 2 steps each
   against the stock route;
15. training timings: the dq and dk/dv kernels at 8 x 1024 beside the plain
   backward, SDPA's backward and the bound at the FFMA and at the 3xTF32
   tensor-core rate; the LM train step, kernel route
   against stock in alternating turns (ms per step, tokens/s);
16. ``matmul_bias_act_int8`` against its plain version on the card: AlexNet's
   two quantized dense layers (K x N = 6400 x 4096 and 4096 x 4096) at
   every serving bucket M = 1..32, the 15 ResNet-50 1x1 shapes (the
   ``QuantizedConv1x1Layer`` path at large M) and two ragged shapes, seeded
   int8 over -128..127; the int32 sums (identity, scale 1, bias 0) bit for
   bit, identity and relu within 1 ulp;
17. the int8 serving path: full-width AlexNet (224x224x3, 1000 classes,
   seeded float32 weights, ``use_kernels=True``) through ``calibrate`` (4
   seeded batches of 32 synthetic images) and ``quantize_for_inference``,
   served by ``InferenceServer(max_batch=32)`` with warmup, concurrent
   ``/predict`` requests (one uint8), ``/model``, ``/healthz`` and
   ``/metrics``; ``matmul_bias_act_int8`` launches twice per forward,
   counted over the serving run alone; every response held against the
   same artifact with ``use_kernels=False``; calibrating twice gives the
   same digest and bit-identical params; the int8 output's deviation from
   the float32 AlexNet printed, not gated;
18. int8 timings: the kernel at both sites and every bucket beside its
   plain version, ``torch._int_mm`` and the bound (weights read from device
   memory), and served images/s at batch 32 for the int8 kernel route, the
   int8 stock route and the float32 AlexNet, in turns.

Then one ``{"kernels": [...]}`` line with every kernel, the served,
trained, generated, trained_lm and served_int8 lines, and last
``{"ok": true, "device": {...}}``. The whole run takes a few minutes on an H100, the
parallel build included.
Without a CUDA card, or without the repository around it, the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12,  # FFMA / tensor core
                  "int8": 1979e12,  # dense int8 tensor core
                  # float32-accurate products on the tensor cores through the
                  # 3xTF32 split: three TF32 MMAs (495e12) a product
                  "tf32x3": 165e12}

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

# the generation slice: a causal LM at GPT-2 small's published widths
# (huggingface.co/openai-community/gpt2 config.json: n_embd 768, n_head 12,
# n_layer 12, n_positions 1024, vocab_size 50257), seeded random weights,
# float32, served by GenerationEngine with use_kernels
GEN_MODEL = dict(vocab_size=50257, embed_dim=768, n_heads=12, n_layers=12,
                 max_len=1024)
GEN_HEAD_DIM = 64
DECODE_HEAD_DIMS = (GEN_HEAD_DIM, 32, 128, 256)  # [10]: the path's, then others
GEN_CONFIG = dict(max_batch=8, fused_steps=4, kv_bucket_min=64,
                  prompt_bucket_min=8)
GEN_PROMPT_LADDER = (8, 16, 32, 64, 128, 256, 512, 1024)
GEN_JOIN_LADDER = (1, 2, 4, 8)
GEN_KV_LADDER = (64, 128, 256, 512, 1024)
GEN_REQUESTS = 16
GEN_MAX_NEW = 32
GEN_PROMPT_RANGE = (5, 896)
GEN_EOS_REQUEST = 3  # this request stops at an eos_id (its 6th token)
GEN_SEED = 0
# flash_attention vs its plain version on the same inputs, per output:
# float32 — o: both sum <= 1024 products p.v in f32 in other orders (the
# kernel's running-max rescaling vs one softmax), |p v| <= |v| ~ 1; l: a sum
# of <= 1024 terms in [0, 1]; m: one 64-term dot product, scaled. bfloat16 —
# the kernel rounds p to bf16 against its running max, the plain version
# against the final max, and o rounds once to bf16 (2**-8): a bf16 ulp of
# |o| plus the p roundings; l and m come from the same widened inputs as in
# float32.
ATTN_TOL = {
    "float32": {"o": (2e-5, 1e-4), "l": (1e-5, 1e-4), "m": (2e-5, 1e-5)},
    "bfloat16": {"o": (2e-2, 2e-2), "l": (1e-5, 1e-4), "m": (2e-5, 1e-5)},
}
# paged_decode_attention vs its plain version: p stays f32 in both;
# float32 sums of <= 1024 products in other orders; bfloat16 one rounding
# of o (a bf16 ulp, 2**-8, of |o|, doubled for the f32 difference under it)
DECODE_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (8e-3, 8e-3)}
# logits of the 12-layer model, kernel route vs stock route (flash vs
# cuBLAS + softmax attention, paged vs masked full-cache decode), float32;
# greedy streams may diverge only where the reference's top-2 gap is below
# twice this (two logits each within it can swap)
GEN_LOGIT_ATOL = 5e-4
FLASH_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
DECODE_SOURCE = "deeplearning4j_tpu_torch/csrc/paged_decode_attention.cu"
FLASH_BWD_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu"

# [13] the backward kernels vs flash_attention_bwd_plain on the same (q, k, v,
# mask, o, l, m, do), per element |got - ref| <= atol + rtol |ref|. float32:
# dq, dk, dv are f32 sums of <= 1024 products (ds k, ds q, p do) of magnitude
# <= ~1 in other orders (<= 1024 * 2**-24 ~ 6e-5 of the sum of |terms|, ~2e-6
# typical), and both recompute p from s = q . k formed in other orders (~1e-6
# relative); bfloat16: both round p and ds to bf16 before their products, and
# a p or ds computed in another order can round to the neighbouring bf16 (one
# ulp, 2**-8 relative, of one term), and the outputs round once to bf16 (one
# ulp of |ref|): a few bf16 ulps.
ATTN_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the whole Function (kernel forward and backward, float32) vs autograd of
# reference_attention in float64 on the card: the float32 sums' error above,
# with the f64 side exact to f32's eyes
ATTN_GRAD_F64_TOL = (1e-4, 1e-4)

# [14] the training path of the transformer: the generation slice's LM
# (GEN_MODEL at full depth, seeded weights, float32, the zoo's default
# Adam(1e-3)) trained by fit on one micro-batch of 8 x 1024 seeded tokens with
# one-hot next-token labels built on the card (GPT-2 trained on 512 sequences a
# step: the micro-batch is the cut). Kernel route (flash forward, dq and dk/dv
# kernels) vs use_kernels=False (materialized scores) on the same weights.
# The routes compute one float32 function in other summation orders
# (attention ~1e-6 relative, [13]); the pre-LN residual blocks do not amplify
# that as a deep BN ResNet does, so the gradients are held 20x tighter than
# TRAIN_GRAD_L2. Each block's key bias bk has a gradient of exactly 0 (a key
# bias adds the same q . bk to every score of a row, which softmax ignores):
# rounding noise on both routes, held in the global error only. Losses as
# TRAIN_LOSS_RTOL (Adam's sign steps move near-zero gradients 2 lr apart).
LM_BATCH = 8
LM_SEED = 11
LM_TRAIN_STEPS = 5  # kernel route, one repeated batch: the loss must fall
LM_GRAD_L2 = {"global": 1e-4, "tensor": 1e-3}
LM_GRAD_MAXREL = 1e-2
LM_ZERO_GRADS = ("bk",)
# the masked batch: one length per row, as features_mask and labels_mask
# (left padding, see lm_dataset)
LM_MASK_LENGTHS = (1024, 1000, 777, 512, 333, 129, 64, 1)
# the bidirectional classifier (causal=False, GlobalPoolingLayer AVG, which
# pools unmasked in a graph, as the JAX package's does): GPT-2 small's widths,
# depth cut to 2 to keep the run short, T 512, masked, 2 classes
CLS_MODEL = dict(vocab_size=50257, embed_dim=768, n_heads=12, n_layers=2,
                 max_len=512)
CLS_LENGTHS = (512, 500, 389, 256, 167, 65, 32, 1)


# [16]-[18] int8 serving: full-width AlexNet (zoo defaults: 224x224x3, 1000
# classes) calibrated on 4 seeded batches of 32 synthetic images, quantized,
# and served at max_batch 32; its dense layers 11 (6400 -> 4096) and 12
# (4096 -> 4096) run matmul_bias_act_int8, 2 launches per forward.
INT8_SOURCE = "deeplearning4j_tpu_torch/csrc/matmul_bias_act_int8.cu"
INT8_SITES = ((6400, 4096), (4096, 4096))  # (K, N) of layers 11 and 12
INT8_BUCKETS = (1, 2, 4, 8, 16, 32)  # the serving buckets up to max_batch
# M, K and N off every tile; (3, 1001, 75) splits K over an 8-block cluster
INT8_RAGGED = ((333, 27, 75), (20001, 77, 257), (3, 1001, 75))
INT8_CAL_BATCHES = 4
INT8_SEED = 0
# int8 kernel vs its plain version on the same int8 inputs: the int32 sums
# are exact on both sides, and both round float32(acc) * scale, then + b,
# then apply identity or relu (exact): bit-equal; at most 1 ulp is allowed
# and every ulp counted. The identity / scale 1 / bias 0 case compares the
# sums themselves, bit for bit.
INT8_MAX_ULP = 1
# served int8 softmax vs the same artifact's use_kernels=False output on the
# same request: the server pads requests into shared launches, cuDNN may
# pick another algorithm at another batch size, and a float32 conv output
# that moves by rounding can move one int8 input by one step. The two
# routes on one batch are held to INT8_MAX_ULP besides.
INT8_SERVED_TOL = (1e-6, 1e-3)
# the kernel's CUDA function (split K and epilogue in the one launch)
INT8_KERNEL_NAMES = ("mma_int8_kernel",)


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


def device_times(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` by CUDA kernel (or copy) name, from
    ``torch.profiler``: host time between launches excluded, unlike
    ``cuda_time_ms`` where the card waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total",
                     getattr(event, "cuda_time_total", 0.0))
        if us > 0:
            out[event.key] = out.get(event.key, 0.0) + us / reps / 1e3
    return out


def device_ms(fn, kernels):
    """Device time per call of ``fn`` in the kernels whose names contain
    one of ``kernels``; None when the profiler recorded none."""
    total = sum(ms for name, ms in device_times(fn).items()
                if any(k in name for k in kernels))
    return total or None


def device_breakdown(fn, top: int = 8) -> dict:
    """Device time per call of ``fn`` in all its kernels and copies, and
    the ``top`` kernels by time (names cut to 80 characters)."""
    times = device_times(fn, reps=5)
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    return {"device_ms": sum(times.values()),
            "top": [(name[:80], ms) for name, ms in ranked[:top]]}


def tc_bound_ms(ops_ms: float, bytes_ms: float) -> float:
    """The bound of float32-accurate work on the tensor cores (3xTF32):
    the operations, timed at the FFMA peak in ``ops_ms``, at the 3xTF32
    rate instead, or the bytes if they take longer. Every float32 row
    carries it beside its FFMA ``bound_ms``, one yardstick for the kernels
    that moved onto the tensor cores and those that did not."""
    return max(ops_ms * PEAK_OPS_PER_S["float32"] / PEAK_OPS_PER_S["tf32x3"],
               bytes_ms)


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


_TYPES = {"f": "float", "i": "int", "b": "bool", "a": "int8", "h": "uint8",
          "__nv_bfloat16": "bf16"}


def kernel_name(mangled: str) -> str:
    """A CUDA entry function's name with its template arguments, e.g.
    ``mma_dq_kernel<float,64>``, from the Itanium-mangled symbol ptxas
    reports (the anonymous namespace dropped)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, names = m.end(), []
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        names.append(mangled[pos:pos + int(n)])
        pos += int(n)
    if not names:
        return mangled
    args = []
    if mangled[pos:pos + 1] == "I":
        pos += 1
        while pos < len(mangled) and mangled[pos] != "E":
            c = mangled[pos]
            if c == "L":  # a literal: L <type> <value> E
                end = mangled.index("E", pos)
                args.append(mangled[pos + 2:end])
                pos = end + 1
            elif c.isdigit():
                n = re.match(r"\d+", mangled[pos:]).group()
                name = mangled[pos + len(n):pos + len(n) + int(n)]
                args.append(_TYPES.get(name, name))
                pos += len(n) + int(n)
            else:
                args.append(_TYPES.get(c, c))
                pos += 1
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in an ``nvcc -Xptxas -v`` report."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), *spill))
            fn = None
    return out


# each kernel row's CUDA source (the build's name) and the prefixes of its
# entry functions' names, for the ptxas rows of the kernels line
PTXAS_OF = {
    "matmul_bias_act": ("matmul_bias_act", ("mm_bias_act_kernel",)),
    "probe": ("matmul_bias_act", ("probe_kernel",)),
    "matmul_stats": ("matmul_stats", ("tc_stats_kernel",)),
    "flash_attention": ("flash_attention", ("",)),
    "paged_decode_attention": ("paged_decode_attention",
                               ("cluster_decode_kernel",)),
    "flash_attention_bwd_dq": ("flash_attention_bwd", ("mma_dq", "ffma_dq")),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                ("mma_dkv", "ffma_dkv")),
    "matmul_bias_act_int8": ("matmul_bias_act_int8", ("mma_int8_kernel",)),
}


def ptxas_rows(logs: dict, source: str, prefix: str) -> list:
    """The ptxas registers and spills of the entry functions of
    ``csrc/<source>.cu`` whose names start with ``prefix``, for a kernel's
    row in the kernels line."""
    return [{"kernel": fn, "registers": regs, "spill_stores": stores,
             "spill_loads": loads}
            for fn, regs, stores, loads in logs.get(source, ())
            if fn.startswith(prefix)]


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
                worst[f"{dtype}_of_tol"] = max(
                    worst.get(f"{dtype}_of_tol", 0.0),
                    float(((y - ref).abs() / (atol + rtol * ref.abs())).max()))
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
        f"{KERNEL_TOL['bfloat16'][0]} rtol={KERNEL_TOL['bfloat16'][1]}); the "
        f"largest |kernel - plain| / (atol + rtol |plain|): float32 "
        f"{worst['float32_of_tol']:.3f}, bfloat16 "
        f"{worst['bfloat16_of_tol']:.3f}")
    return worst


def stats_errors(torch, got, ref, dtype: str) -> tuple:
    """[6]'s measures of matmul_stats' ``(y, s, q)`` against the plain
    version's: y's largest |error| and its elements outside KERNEL_TOL (or
    not finite), and the statistics' largest error per column relative to
    sum|y| (s) and sum(y^2) (q), against the plain version and against f64
    sums of the kernel's own y. Returns (errors, whether all hold)."""
    (y, s, q), (ry, rs, rq) = got, ref
    atol, rtol = KERNEL_TOL[dtype]
    yf, ryf = y.float(), ry.float()
    bad = int(((yf - ryf).abs() > atol + rtol * ryf.abs()).sum())
    bad += int((~torch.isfinite(yf)).sum())
    y64 = y.double()
    abs_sum, sq_sum = y64.abs().sum(0), (y64 * y64).sum(0)

    def col_err(got_, ref_, scale):
        return float(((got_.double() - ref_.double()).abs() / scale).max())

    errs = {"y": float((yf - ryf).abs().max()), "y_outside": bad,
            "own_s": col_err(s, y64.sum(0), abs_sum),
            "own_q": col_err(q, sq_sum, sq_sum),
            "plain_s": col_err(s, rs, abs_sum),
            "plain_q": col_err(q, rq, sq_sum)}
    tol_s, tol_q = ((STATS_RTOL[dtype],) * 2 if dtype == "float32"
                    else STATS_RTOL[dtype])
    ok = (bad == 0 and max(errs["own_s"], errs["own_q"]) <= STATS_RTOL["own"]
          and errs["plain_s"] <= tol_s and errs["plain_q"] <= tol_q)
    return errs, ok


def check_matmul_stats(torch, impls, dev, shapes) -> dict:
    """matmul_stats vs its plain version at every shape and dtype: y, the
    column statistics (against the plain version and against f64 sums of
    the kernel's own y), and dx, dw through the autograd Function against
    autograd of the plain version. Returns the worst errors."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    worst = {}

    def note(key, v):
        worst[key] = max(worst.get(key, 0.0), v)

    for (m, k, n) in list(shapes) + list(RAGGED):
        x32 = torch.randn((m, k), generator=gen, device=dev)
        w32 = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        gy32 = torch.randn((m, n), generator=gen, device=dev)
        gs32 = torch.randn((n,), generator=gen, device=dev) / math.sqrt(m)
        gq32 = torch.randn((n,), generator=gen, device=dev) / math.sqrt(m)
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            x, w = x32.to(tdt), w32.to(tdt)
            got = impls.matmul_stats(x, w)
            ref = impls.matmul_stats_plain(x, w)
            torch.cuda.synchronize()
            errs, ok = stats_errors(torch, got, ref, dtype)
            note(f"y_{dtype}", errs["y"])
            note("stats_own", max(errs["own_s"], errs["own_q"]))
            note(f"stats_{dtype}", max(errs["plain_s"], errs["plain_q"]))
            if not ok:
                raise AssertionError(
                    f"matmul_stats m={m} k={k} n={n} {dtype}: {errs} (y tol "
                    f"{KERNEL_TOL[dtype]}; stats tol {STATS_RTOL})")
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


def _grad_errors(ga, gb, skip=()) -> dict:
    """Errors of gradients ``ga`` against ``gb``: the relative L2 error of
    all tensors together and the worst tensors by relative L2 error and by
    max |ga - gb| / max |gb|. ``skip``: param names (``bk``) whose gradient
    is zero in exact arithmetic, so rounding noise on both sides: counted
    in the global error only."""
    l2, maxrel = [], []
    num = den = 0.0
    for k in gb:
        for p in gb[k]:
            a, b = ga[k][p].double(), gb[k][p].double()
            d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
            num, den = num + d2, den + b2
            if p in skip:
                continue
            l2.append(((d2 / max(b2, 1e-300)) ** 0.5, f"{k}.{p}"))
            maxrel.append((float((a - b).abs().max()
                                 / b.abs().max().clamp_min(1e-300)),
                           f"{k}.{p}"))
    return {"global_l2": (num / den) ** 0.5,
            "tensor_l2": sorted(l2, reverse=True)[:4],
            "tensor_maxrel": sorted(maxrel, reverse=True)[:4]}


def _compare_training(torch, net, ref, ds, steps, label,
                      grad_tol=TRAIN_GRAD_L2, maxrel=TRAIN_GRAD_MAXREL,
                      skip=()) -> dict:
    """Step-1 gradients, the first ``steps`` losses and the BN state after
    step 1 (if the graphs have any) of two graphs on the same weights and
    batch; the graphs are left trained by ``steps`` steps (``net`` through
    ``fit``). ``grad_tol``, ``maxrel``, ``skip``: the gradient limits and
    the params left out of the per-tensor ones (:func:`_grad_errors`)."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    gk, lk = net.compute_gradient_and_score(ds)
    gr, lr = ref.compute_gradient_and_score(ds)
    grad = _grad_errors(gk, gr, skip)
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
    state_err = max((float((firsts[0][k][sk] - firsts[1][k][sk]).abs().max()
                           / firsts[1][k][sk].abs().max())
                     for k in firsts[1] for sk in firsts[1][k]), default=0.0)
    out.update(losses_kernel=scores[0], losses_stock=scores[1],
               loss_rel_err=loss_err, state_rel_err=state_err)
    log(f"[{label}] losses kernel {scores[0]} stock {scores[1]}"
        + (f"; BN state after step 1 {state_err:.3e}" if firsts[1] else ""))
    if not (grad["global_l2"] <= grad_tol["global"]
            and grad["tensor_l2"][0][0] <= grad_tol["tensor"]
            and grad["tensor_maxrel"][0][0] <= maxrel
            and math.isfinite(lk)):
        raise AssertionError(f"[{label}] step-1 gradients differ: {grad} "
                             f"(tol L2 {grad_tol}, max-relative {maxrel})")
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


def stock_stats(F, x, w):
    """Row 2's function from stock PyTorch calls: ``F.linear``, then the
    column sums of y and of y * y."""
    y = F.linear(x, w)
    return y, y.sum(0), (y * y).sum(0)


def time_stats_kernel(torch, impls, F, dev, shapes) -> list:
    """Per-shape timings of matmul_stats at the training path's float32
    shapes, beside ``F.linear`` (the product alone) and the stock composite
    that computes the same function (``stock_stats``)."""
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
            "composite_ms": cuda_time_ms(lambda: stock_stats(F, x, w)),
            "device_ms": device_ms(lambda: impls.matmul_stats(x, w),
                                   ["stats_kernel"]),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
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
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
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
        "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": _total(rows, "library_ms"),
        "composite_ms": _total(rows, "composite_ms"),
        "device_ms": (None if any(r["device_ms"] is None for r in rows)
                      else _total(rows, "device_ms")),
        "scope": (f"one ResNet-50 training step at batch {BATCH}: the 36 "
                  "fused 1x1 conv + BN statistics sites (forward), float32; "
                  "library = F.linear, the matmul part alone (no single "
                  "PyTorch call also sums the columns); composite = "
                  "F.linear, y.sum(0) and (y*y).sum(0), the same function"),
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
        "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": total("library_ms"),
        "scope": (f"one ResNet-50 forward at batch {BATCH}: the 36 1x1 "
                  "convolutions, float32; library = F.linear"),
        "max_abs_err_checked": worst,
        "shapes": rows,
    }
    mm["max_err"], mm["time_ms"] = mm["max_abs_err"], mm["ms"]
    return {"kernels": [mm, probe_row, stats_row]}


# ---------------------------------------------------------------------------
# the generation slice: attention kernels and the GPT-2-small-width LM
# ---------------------------------------------------------------------------

def flash_cases():
    """(B, Tq, Tk, D, causal, masked) of [9]: every (join bucket, prompt
    bucket) of the generation path (12 heads x 64, causal, with the
    prompt-length mask), two ragged T, one bidirectional unmasked case,
    Tq < Tk, and head sizes 32 and 128 (the tensor-core kernel's other
    variants), 33 (rows off 16 bytes: element loads, odd-width stores) and
    256 (the FFMA kernel). Every masked case with B >= 2 has a fully
    masked row."""
    cases = [(b, t, t, GEN_HEAD_DIM, True, True) for b in GEN_JOIN_LADDER
             for t in GEN_PROMPT_LADDER]
    return cases + [(8, 333, 333, 64, True, True),
                    (8, 1000, 1000, 64, True, True),
                    (2, 256, 256, 64, False, False),
                    (4, 200, 333, 64, True, True),
                    (2, 256, 256, 32, True, True),
                    (2, 256, 256, 128, True, True),
                    (2, 100, 100, 33, True, True),
                    (2, 256, 256, 256, True, True)]


def _attention_inputs(torch, gen, dev, b, t, masked, dtype, tk=None,
                      d=GEN_HEAD_DIM):
    """q [B, 12, T, D], k, v [B, 12, Tk, D] (Tk = T unless given) and a
    float [B, Tk] length mask (the last row of a join group of 2 or more
    has length 0, as padding rows do), or None."""
    tk = t if tk is None else tk
    h = GEN_MODEL["n_heads"]
    q = torch.randn((b, h, t, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, h, tk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    km = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen, device=dev)
        if b >= 2:
            lengths[-1] = 0
        km = (torch.arange(tk, device=dev)[None, :]
              < lengths[:, None]).float()
    return q, k, v, km


def _within(torch, got, ref, tol):
    atol, rtol = tol
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()) if diff.numel() else 0.0, \
        int((diff > atol + rtol * ref.float().abs()).sum())


def check_flash(torch, att, dev) -> dict:
    """flash_attention vs flash_attention_plain on the card at every case
    of :func:`flash_cases`, float32 and bfloat16: o, l and m on the rows
    with a valid key, and every row finite. Also: a CUDA input that
    requires grad gets its gradient through the backward kernels."""
    gen = torch.Generator(device=dev).manual_seed(2024)
    worst = {}
    for b, tq, tk, d, causal, masked in flash_cases():
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            q, k, v, km = _attention_inputs(torch, gen, dev, b, tq, masked,
                                            tdt, tk=tk, d=d)
            o, l, m = att.flash_attention(q, k, v, km, causal,
                                          return_stats=True)
            ro, rl, rm = att.flash_attention_plain(q, k, v, km, causal)
            torch.cuda.synchronize()
            if not (torch.isfinite(o.float()).all() and torch.isfinite(l).all()
                    and torch.isfinite(m).all()):
                raise AssertionError(f"flash_attention B={b} Tq={tq} Tk={tk} "
                                     f"D={d} {dtype}: non-finite output")
            rows = (km.sum(-1) > 0) if km is not None else \
                torch.ones(b, dtype=torch.bool, device=dev)
            for key, got, ref in (("o", o[rows], ro[rows]),
                                  ("l", l[rows], rl[rows]),
                                  ("m", m[rows], rm[rows])):
                tol = ATTN_TOL[dtype][key]
                err, bad = _within(torch, got, ref, tol)
                worst[f"{dtype}.{key}"] = max(worst.get(f"{dtype}.{key}", 0.0),
                                              err)
                if bad:
                    raise AssertionError(
                        f"flash_attention B={b} Tq={tq} Tk={tk} D={d} "
                        f"causal={causal} {dtype} {key}: {bad} elements "
                        f"outside atol={tol[0]} rtol={tol[1]} (max |err| "
                        f"{err})")
        zero = "" if not masked or b < 2 else ", a fully masked row finite"
        log(f"[9] flash_attention B={b} Tq={tq} Tk={tk} D={d} "
            f"causal={causal} masked={masked}: f32 and bf16 o, l, m within "
            f"tolerance{zero}")
    # a CUDA input that requires grad gets its gradient from the kernels
    q = torch.randn((1, 2, 8, 64), device=dev, requires_grad=True)
    before = att.flash_attention_bwd.dq_launches
    g, = torch.autograd.grad(att.flash_attention(q, q, q, None, True).sum(),
                             (q,))
    torch.cuda.synchronize()
    if att.flash_attention_bwd.dq_launches != before + 1 \
            or not torch.isfinite(g).all():
        raise AssertionError("flash_attention's gradient did not come from "
                             "the backward kernels")
    log("[9] a CUDA input that requires grad gets its gradient from the "
        "backward kernels")
    log(f"[9] worst |kernel - plain|: {json.dumps(worst)} (tol "
        f"{json.dumps(ATTN_TOL)})")
    return worst


def flash_bwd_cases():
    """(B, Tq, Tk, D, causal, masked) of [13]: the training path's shape
    (8 x 1024, 12 heads x 64, causal) unmasked and with a ragged length
    mask, ragged T 333 and 1000, 8 x 512 bidirectional and masked, Tq < Tk,
    and head sizes 32, 128 and 256 (the FFMA kernels' route)."""
    return [(8, 1024, 1024, 64, True, False), (8, 1024, 1024, 64, True, True),
            (8, 333, 333, 64, True, True), (8, 1000, 1000, 64, True, True),
            (8, 512, 512, 64, False, True), (4, 200, 333, 64, True, True),
            (2, 256, 256, 32, True, True), (2, 256, 256, 128, True, True),
            (2, 256, 256, 256, True, True)]


def _bwd_inputs(torch, gen, dev, b, tq, tk, d, masked, zero_row=False):
    """f32 q [B, 12, Tq, D], k, v [B, 12, Tk, D], do like q, and a [B, Tk]
    length mask (lengths >= 1, or the last row of length 0), or None."""
    h = GEN_MODEL["n_heads"]
    q = torch.randn((b, h, tq, d), generator=gen, device=dev)
    k, v = (torch.randn((b, h, tk, d), generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn((b, h, tq, d), generator=gen, device=dev)
    km = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen, device=dev)
        if zero_row:
            lengths[-1] = 0
        km = (torch.arange(tk, device=dev)[None, :]
              < lengths[:, None]).float()
    return q, k, v, do, km


def check_flash_bwd(torch, att, dev) -> dict:
    """[13] flash_attention_bwd (the dq and dk/dv kernels) vs
    flash_attention_bwd_plain on the card, at every case of
    :func:`flash_bwd_cases`, float32 and bfloat16, on the kernel forward's
    o, l, m; a length-0 row leaves every gradient finite; then the whole
    Function (kernel forward and backward) vs autograd of
    reference_attention in float64."""
    gen = torch.Generator(device=dev).manual_seed(2026)
    worst = {}
    for b, tq, tk, d, causal, masked in flash_bwd_cases():
        q32, k32, v32, do32, km = _bwd_inputs(torch, gen, dev, b, tq, tk, d,
                                              masked)
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
            o, l, m = att.flash_attention(q, k, v, km, causal,
                                          return_stats=True)
            got = att.flash_attention_bwd(q, k, v, km, o, l, m, do, causal)
            ref = att.flash_attention_bwd_plain(q, k, v, km, o, l, m, do,
                                                causal)
            torch.cuda.synchronize()
            for key, g, r in zip(("dq", "dk", "dv"), got, ref):
                err, bad = _within(torch, g, r, ATTN_BWD_TOL[dtype])
                worst[f"{dtype}.{key}"] = max(
                    worst.get(f"{dtype}.{key}", 0.0), err)
                if bad or not torch.isfinite(g.float()).all():
                    raise AssertionError(
                        f"flash_attention_bwd B={b} Tq={tq} Tk={tk} D={d} "
                        f"causal={causal} masked={masked} {dtype} {key}: {bad}"
                        f" elements outside {ATTN_BWD_TOL[dtype]} (max |err| "
                        f"{err})")
        log(f"[13] flash_attention_bwd B={b} Tq={tq} Tk={tk} D={d} "
            f"causal={causal} masked={masked}: f32 and bf16 dq, dk, dv "
            f"within tolerance")
    # a length-0 row: finite gradients (its ds is not 0; not compared)
    q32, k32, v32, do32, km = _bwd_inputs(torch, gen, dev, 4, 256, 256, 64,
                                          True, zero_row=True)
    for tdt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
        o, l, m = att.flash_attention(q, k, v, km, True, return_stats=True)
        grads = att.flash_attention_bwd(q, k, v, km, o, l, m, do, True)
        torch.cuda.synchronize()
        if not all(torch.isfinite(g.float()).all() for g in grads):
            raise AssertionError(f"a length-0 row gave non-finite gradients "
                                 f"({tdt})")
    log("[13] a length-0 mask row: every gradient finite (f32 and bf16)")
    # the Function, kernel forward and backward, vs float64 autograd
    for b, tq, tk, d, causal, masked in flash_bwd_cases()[1::3]:
        q, k, v, do, km = _bwd_inputs(torch, gen, dev, b, tq, tk, d, masked)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(att.flash_attention(*leaves, km, causal),
                                  leaves, do)
        leaves = [t.double().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(att.reference_attention(
            *leaves, None if km is None else km.double(), causal), leaves,
            do.double())
        torch.cuda.synchronize()
        for key, g, r in zip(("dq", "dk", "dv"), got, ref):
            err, bad = _within(torch, g.double(), r, ATTN_GRAD_F64_TOL)
            worst[f"f64.{key}"] = max(worst.get(f"f64.{key}", 0.0), err)
            if bad:
                raise AssertionError(
                    f"flash_attention gradient vs float64 autograd B={b} "
                    f"Tq={tq} Tk={tk} D={d} causal={causal} {key}: {bad} "
                    f"elements outside {ATTN_GRAD_F64_TOL} (max |err| {err})")
        log(f"[13] flash_attention Function B={b} Tq={tq} Tk={tk} D={d} "
            f"causal={causal}: dq, dk, dv vs float64 autograd of "
            f"reference_attention within tolerance")
    log(f"[13] worst |kernel - reference|: {json.dumps(worst)} (tol "
        f"{json.dumps(ATTN_BWD_TOL)}; f64 {ATTN_GRAD_F64_TOL})")
    return worst


def decode_positions(torch, gen, dev, s: int):
    """Positions of [10] at cache length S: 0, 63, 64, S - 1, one past
    S - 1 (the whole cache is attended), and three seeded ones."""
    fixed = torch.tensor([0, 63, 64, s - 1, s], device=dev)
    return torch.cat([fixed, torch.randint(0, s, (3,), generator=gen,
                                           device=dev)]).to(torch.int32)


def check_decode(torch, att, dev) -> dict:
    """paged_decode_attention vs its plain version at B 8, H 12, each head
    size of DECODE_HEAD_DIMS (the path's 64 first; the cluster kernel has
    a variant per padded head size) and each cache length of the KV ladder,
    float32 and bfloat16; then a negative position (zeros) and one row
    decoded alone and inside a batch of 8 (the same bits: the split of a
    row's pages depends on its position only)."""
    gen = torch.Generator(device=dev).manual_seed(2025)
    worst = {}
    h = GEN_MODEL["n_heads"]

    def check(label, o, ref, dtype):
        torch.cuda.synchronize()
        err, bad = _within(torch, o, ref, DECODE_TOL[dtype])
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        if bad or not torch.isfinite(o.float()).all():
            raise AssertionError(
                f"paged_decode_attention {label} {dtype}: {bad} elements "
                f"outside {DECODE_TOL[dtype]} (max |err| {err})")

    for d in DECODE_HEAD_DIMS:
        for s in GEN_KV_LADDER:
            pos = decode_positions(torch, gen, dev, s)
            for dtype, tdt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
                q = torch.randn((8, h, d), generator=gen, device=dev).to(tdt)
                kc, vc = (torch.randn((8, s, h, d), generator=gen,
                                      device=dev).to(tdt) for _ in range(2))
                check(f"D={d} S={s}", att.paged_decode_attention(q, kc, vc, pos),
                      att.paged_decode_attention_plain(q, kc, vc, pos), dtype)
            log(f"[10] paged_decode_attention D={d} S={s} positions "
                f"{pos.tolist()}: f32 and bf16 within tolerance")
    s, d = GEN_KV_LADDER[-1], GEN_HEAD_DIM
    pos = torch.tensor([-1, 700, 0, s], dtype=torch.int32, device=dev)
    q = torch.randn((4, h, d), generator=gen, device=dev)
    kc, vc = (torch.randn((4, s, h, d), generator=gen, device=dev)
              for _ in range(2))
    o = att.paged_decode_attention(q, kc, vc, pos)
    check("negative position", o, att.paged_decode_attention_plain(
        q, kc, vc, pos), "float32")
    if not bool((o[0] == 0).all()):
        raise AssertionError("paged_decode_attention: a negative position "
                             "did not give zeros")
    alone = att.paged_decode_attention(q[1:2], kc[1:2], vc[1:2], pos[1:2])
    if not torch.equal(alone, o[1:2]):
        raise AssertionError("paged_decode_attention: a row decoded alone "
                             "differs from the same row in a batch")
    log(f"[10] position -1 gives zeros; a row at position 700 decoded alone "
        f"and in a batch of 4: identical bits")
    log(f"[10] worst |kernel - plain|: {json.dumps(worst)} (tol "
        f"{json.dumps(DECODE_TOL)})")
    return worst


def gen_requests(n: int, vocab: int, seed: int):
    """Seeded prompts (lengths in GEN_PROMPT_RANGE)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(GEN_PROMPT_RANGE[0], GEN_PROMPT_RANGE[1] + 1, n)
    return [[int(t) for t in rng.integers(0, vocab, int(n_))]
            for n_ in lengths]


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def compare_streams(torch, ref_dec, got, ref, prompts, label) -> dict:
    """Greedy streams: identical, or the first divergence at a step where
    the reference's top-2 logit gap (its own prefill of the prompt and the
    tokens before that step) is below 2 * GEN_LOGIT_ATOL; the gap is
    printed. Otherwise the run fails."""
    out = {"identical": 0, "near_ties": []}
    for j, (g, r, p) in enumerate(zip(got, ref, prompts)):
        i = _first_divergence(g, r)
        if i is None:
            out["identical"] += 1
            continue
        seq = list(p) + list(r[:i])
        with torch.inference_mode():
            logits, _ = ref_dec._run_prompt(
                ref_dec.params,
                torch.tensor([seq], device=ref_dec.device),
                torch.tensor([len(seq)], device=ref_dec.device))
        top2 = torch.topk(logits[0].float(), 2).values
        gap = float(top2[0] - top2[1])
        log(f"[11] {label}: request {j} diverges at step {i}: reference "
            f"top-2 logit gap {gap:.3e} (limit {2 * GEN_LOGIT_ATOL:.1e})")
        if gap >= 2 * GEN_LOGIT_ATOL:
            raise AssertionError(f"{label}: request {j} diverges at step {i}"
                                 f" with a top-2 gap of {gap:.3e}")
        out["near_ties"].append({"request": j, "step": i, "gap": gap})
    return out


def _engine_run(torch, dec, prompts, max_new, eos=None):
    """One engine over the requests, all submitted at once: outputs and
    the host-clock latencies."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    eos = eos or {}
    with GenerationEngine(dec, GenerationConfig(**GEN_CONFIG)) as eng:
        t0 = time.monotonic()
        reqs = [eng.submit(p, max_new_tokens=max_new, eos_id=eos.get(j))
                for j, p in enumerate(prompts)]
        outs = [eng.result(r) for r in reqs]
        wall = time.monotonic() - t0
        stats = eng.stats()
    ttft = sorted((r.t_first - r.t0) * 1e3 for r in reqs)
    per_tok = sorted((r.t_done - r.t_first) / (len(r.out) - 1) * 1e3
                     for r in reqs if len(r.out) > 1)
    return outs, {
        "wall_s": wall, "tokens": sum(len(o) for o in outs),
        "tokens_per_s": sum(len(o) for o in outs) / wall,
        "ttft_ms_p50": statistics.median(ttft),
        "ttft_ms_p95": ttft[min(len(ttft) - 1,
                                math.ceil(0.95 * len(ttft)) - 1)],
        "token_ms_p50": statistics.median(per_tok),
    }, stats


def serve_gpt2(torch, dev, model_kw=None, n_requests=GEN_REQUESTS,
               max_new=GEN_MAX_NEW) -> dict:
    """[11] The generation path: the causal LM at GPT-2 small's widths
    (seeded random weights, float32, use_kernels) served by
    GenerationEngine; launch counts read from the engine run alone; the
    streams held against sequential TransformerDecoder.generate and
    against a use_kernels=False decoder on the same weights; prefill
    logits held against the stock route."""
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    model_kw = dict(model_kw or GEN_MODEL)
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=GEN_SEED, **model_kw)
    t0 = time.monotonic()
    net = zoo.init(device=dev)
    n_params = net.num_params()
    dec_kw = {k: GEN_CONFIG[k] for k in ("max_batch", "kv_bucket_min",
                                         "prompt_bucket_min")}
    dec = TransformerDecoder(net, max_len=zoo.max_len, **dec_kw)
    stock = TransformerDecoder(net, max_len=zoo.max_len, **dec_kw)
    stock.use_kernels = False
    log(f"[11] causal LM {json.dumps(model_kw)}: {n_params:,} params on "
        f"{dev}, built in {time.monotonic() - t0:.1f} s")
    prompts = gen_requests(n_requests, zoo.vocab_size, GEN_SEED)
    # request GEN_EOS_REQUEST stops at its own 6th greedy token
    probe_out = dec.generate(prompts[GEN_EOS_REQUEST], 6)
    eos = {GEN_EOS_REQUEST: probe_out[5]}
    t0 = time.monotonic()
    warm = dec.warmup(fused_steps=(GEN_CONFIG["fused_steps"],))
    stock.warmup(fused_steps=(GEN_CONFIG["fused_steps"],))
    log(f"[11] warmup: {len(warm['prompt_buckets'])} prompt x "
        f"{len(warm['join_buckets'])} join buckets, "
        f"{len(warm['kv_buckets'])} kv buckets per route in "
        f"{time.monotonic() - t0:.1f} s")

    # the main path: counts from this engine run alone
    for fn in (att.flash_attention, att.paged_decode_attention):
        fn.launches = 0
    outs, timing, stats = _engine_run(torch, dec, prompts, max_new, eos)
    torch.cuda.synchronize()
    launches = {"flash_attention": att.flash_attention.launches,
                "paged_decode_attention": att.paged_decode_attention.launches}
    n_layers = model_kw["n_layers"]
    prefills = sum(stats["prefills"].values())
    steps = sum(stats["windows"].values()) * GEN_CONFIG["fused_steps"]
    log(f"[11] engine: {len(prompts)} requests, {timing['tokens']} tokens in "
        f"{timing['wall_s']:.2f} s; {prefills} prefills "
        f"{json.dumps(stats['prefills'])}, {steps} decode steps "
        f"(windows {json.dumps(stats['windows'])}); launches "
        f"{json.dumps(launches)}")
    if launches["flash_attention"] != n_layers * prefills:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"{n_layers} per prefill x {prefills}")
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged_decode_attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} per step x {steps}")
    for j, o in enumerate(outs):
        want = max_new if j not in eos else None
        if (want is not None and len(o) != want) or not all(
                0 <= t < zoo.vocab_size for t in o):
            raise AssertionError(f"request {j}: {len(o)} tokens {o[:8]}...")
    j = GEN_EOS_REQUEST
    if outs[j][-1] != eos[j] or eos[j] in outs[j][:-1]:
        raise AssertionError(f"request {j} did not stop at eos {eos[j]}: "
                             f"{outs[j]}")

    # the same requests sequentially, kernel route and stock route
    seq = [dec.generate(p, max_new, eos_id=eos.get(i))
           for i, p in enumerate(prompts)]
    ref = [stock.generate(p, max_new, eos_id=eos.get(i))
           for i, p in enumerate(prompts)]
    engine_vs_seq = compare_streams(torch, dec, outs, seq, prompts,
                                    "engine vs sequential generate")
    kernel_vs_stock = compare_streams(torch, stock, seq, ref, prompts,
                                      "kernel route vs use_kernels=False")
    # prefill logits, kernel route vs stock route, on the first join group
    group = prompts[:GEN_CONFIG["max_batch"]]
    tp = max(len(p) for p in group)
    batch = torch.zeros((len(group), tp), dtype=torch.long, device=dev)
    for i, p in enumerate(group):
        batch[i, :len(p)] = torch.tensor(p, device=dev)
    lengths = torch.tensor([len(p) for p in group], device=dev)
    with torch.inference_mode():
        lk, _ = dec._run_prompt(dec.params, batch, lengths)
        ls, _ = stock._run_prompt(stock.params, batch, lengths)
    logit_err = float((lk - ls).abs().max())
    log(f"[11] prefill logits, kernel vs stock route ({len(group)} prompts "
        f"padded to {tp}): max |diff| {logit_err:.3e} (tol "
        f"{GEN_LOGIT_ATOL}); streams: engine vs sequential "
        f"{engine_vs_seq['identical']}/{len(prompts)} identical, kernel vs "
        f"stock {kernel_vs_stock['identical']}/{len(prompts)} identical")
    if not logit_err <= GEN_LOGIT_ATOL:
        raise AssertionError(f"prefill logits differ by {logit_err}")
    return {"net": net, "dec": dec, "stock": stock, "prompts": prompts,
            "max_new": max_new, "params": n_params, "launches": launches,
            "stats": stats, "timing": timing, "logit_err": logit_err,
            "engine_vs_sequential": engine_vs_seq,
            "kernel_vs_stock": kernel_vs_stock}


def flash_bound_ms(b, h, t, d, causal, size):
    """(operations ms, bytes ms) of one flash forward: 4·B·H·T²·D (half
    causal) at the f32 FFMA peak; q, k, v read and o written once."""
    ops = 4.0 * b * h * t * t * d * (0.5 if causal else 1.0)
    return (ops / PEAK_OPS_PER_S["float32"] * 1e3,
            4 * b * h * t * d * size / HBM_BYTES_PER_S * 1e3)


def decode_bound_ms(pos, s, h, d, size, page=64):
    """(operations ms, bytes ms) of one paged decode step: 4·H·(pos+1)·D
    per row; the live K and V pages read once (and q, o)."""
    live = [min(int(p), s - 1) + 1 for p in pos]
    ops = sum(4.0 * h * n * d for n in live)
    pages = sum((n - 1) // page + 1 for n in live)
    nbytes = (2 * pages * page * h * d + 2 * len(live) * h * d) * size
    return (ops / PEAK_OPS_PER_S["float32"] * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def _weighted(rows, key):
    n = sum(r["count"] for r in rows)
    return sum(r[key] * r["count"] for r in rows) / n


def time_attention(torch, F, att, dev, stats, n_layers) -> tuple:
    """[12] Per-shape timings of both kernels at the geometries the engine
    ran (counts from its stats): kernel, plain version, SDPA, bound."""
    gen = torch.Generator(device=dev).manual_seed(77)
    h, d = GEN_MODEL["n_heads"], GEN_HEAD_DIM
    flash_rows, decode_rows = [], []
    for key, n in stats["prefills"].items():
        tp, bp = (int(v) for v in key.split("x"))
        q, k, v, km = _attention_inputs(torch, gen, dev, bp, tp, True,
                                        torch.float32)
        keep = (torch.ones((tp, tp), dtype=torch.bool, device=dev).tril()
                [None, None] & (km > 0)[:, None, None, :])
        err = float((att.flash_attention(q, k, v, km, True)
                     - att.flash_attention_plain(q, k, v, km, True)[0])
                    [km.sum(-1) > 0].abs().max())
        ops_ms, bytes_ms = flash_bound_ms(bp, h, tp, d, True, 4)
        flash_rows.append({
            "b": bp, "t": tp, "count": n * n_layers, "max_abs_err": err,
            "ms": cuda_time_ms(lambda: att.flash_attention(q, k, v, km,
                                                           True)),
            "plain_ms": cuda_time_ms(
                lambda: att.flash_attention_plain(q, k, v, km, True)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=keep)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        del q, k, v, km, keep
    for key, n in stats["windows"].items():
        s = int(key)
        pos = torch.randint(s // 2, s, (8,), generator=gen,
                            device=dev).to(torch.int32)
        q = torch.randn((8, h, d), generator=gen, device=dev)
        kc, vc = (torch.randn((8, s, h, d), generator=gen, device=dev)
                  for _ in range(2))
        live = (torch.arange(s, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], kc.permute(0, 2, 1, 3), \
            vc.permute(0, 2, 1, 3)
        err = float((att.paged_decode_attention(q, kc, vc, pos)
                     - att.paged_decode_attention_plain(q, kc, vc, pos))
                    .abs().max())
        ops_ms, bytes_ms = decode_bound_ms(pos.tolist(), s, h, d, 4)
        decode_rows.append({
            "s": s, "positions": pos.tolist(),
            "count": n * GEN_CONFIG["fused_steps"] * n_layers,
            "max_abs_err": err,
            "ms": cuda_time_ms(
                lambda: att.paged_decode_attention(q, kc, vc, pos)),
            "device_ms": device_ms(
                lambda: att.paged_decode_attention(q, kc, vc, pos),
                ["decode"]),
            "plain_ms": cuda_time_ms(
                lambda: att.paged_decode_attention_plain(q, kc, vc, pos)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       attn_mask=live)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        del q, kc, vc, live, qs, ks, vs
    return flash_rows, decode_rows


def attention_report(rows, launches, worst, name, source, replaces,
                     scope) -> dict:
    row = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": _weighted(rows, "ms"), "plain_ms": _weighted(rows, "plain_ms"),
        "bound_ms": _weighted(rows, "bound_ms"),
        "bound_tc_ms": _weighted(rows, "bound_tc_ms"),
        "bound_by": max(("operations", "bytes"), key=lambda k: sum(
            r["count"] for r in rows if r["bound_by"] == k)),
        "library_ms": _weighted(rows, "library_ms"),
        "scope": scope, "checked": worst, "shapes": rows,
    }
    if all(r.get("device_ms") is not None for r in rows):
        row["device_ms"] = _weighted(rows, "device_ms")
    row["max_err"], row["time_ms"] = row["max_abs_err"], row["ms"]
    return row


def generation_throughput(torch, served, smi: str) -> dict:
    """Generated tokens/s, TTFT p50/p95 and per-token latency through the
    engine, kernel route and stock route in turns (kernel, stock, stock,
    kernel); medians of each route's two runs."""
    runs = {"kernel": [], "stock": []}
    for side in ("kernel", "stock", "stock", "kernel"):
        dec = served["dec"] if side == "kernel" else served["stock"]
        _, timing, _ = _engine_run(torch, dec, served["prompts"],
                                   served["max_new"])
        runs[side].append(timing)
    out = {"model": dict(GEN_MODEL, params=served["params"]),
           "config": GEN_CONFIG, "requests": len(served["prompts"]),
           "max_new_tokens": served["max_new"], "card": smi,
           "launches": served["launches"],
           "prefills": served["stats"]["prefills"],
           "windows": served["stats"]["windows"],
           "prefill_logit_max_abs_diff": served["logit_err"],
           "engine_vs_sequential": served["engine_vs_sequential"],
           "kernel_vs_stock": served["kernel_vs_stock"]}
    for side, v in runs.items():
        for key in ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p95",
                    "token_ms_p50"):
            out[f"{key}_{side}"] = statistics.median(r[key] for r in v)
    return out


# ---------------------------------------------------------------------------
# the transformer's training slice: the LM through fit, the backward kernels
# ---------------------------------------------------------------------------

def lm_dataset(torch, dev, vocab, b, t, seed, lengths=None, classes=0):
    """A seeded batch built on the card: token ids [B, T] with one-hot
    next-token labels [B, T, vocab] (or, with ``classes``, one-hot class
    labels [B, classes]); with ``lengths``, the [B, T] length mask as the
    features mask and (for the LM) the labels mask. The LM's valid steps
    sit at each row's end (left padding): a causal row never sees the keys
    after it, so only then do valid rows meet padded keys, and rows before
    a row's start have no valid key at all. The classifier's sit at the
    start."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, vocab, (b, t + 1), generator=gen, device=dev)
    if classes:
        y = torch.zeros((b, classes), device=dev)
        y[torch.arange(b, device=dev),
          torch.randint(0, classes, (b,), generator=gen, device=dev)] = 1.0
    else:
        y = torch.zeros((b, t, vocab), device=dev)
        y.scatter_(2, ids[:, 1:, None], 1.0)
    mask = None
    if lengths is not None:
        steps = torch.arange(t, device=dev)[None, :]
        if not classes:
            steps = t - 1 - steps
        mask = (steps < torch.tensor(lengths, device=dev)[:, None]).float()
    return DataSet(ids[:, :t].contiguous(), y, features_mask=mask,
                   labels_mask=None if classes else mask)


def _attention_launches(att) -> dict:
    return {"flash_attention": att.flash_attention.launches,
            "flash_attention_bwd_dq": att.flash_attention_bwd.dq_launches,
            "flash_attention_bwd_dkv": att.flash_attention_bwd.dkv_launches}


def _reset_attention_launches(att) -> None:
    att.flash_attention.launches = 0
    att.flash_attention_bwd.dq_launches = 0
    att.flash_attention_bwd.dkv_launches = 0


def _route_pair(torch, dev, zoo):
    """The zoo model's graph on the kernel route and the same weights on
    the stock route (use_kernels=False)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = dataclasses.replace(zoo.conf(), use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    return net, ref


def _compare_lm(torch, att, net, ref, ds, steps, label, n_layers) -> dict:
    """:func:`_compare_training` at the LM limits; the kernel route's
    compute_gradient_and_score and ``steps`` fit steps launch each
    attention kernel n_layers times per forward / backward."""
    _reset_attention_launches(att)
    cmp = _compare_training(torch, net, ref, ds, steps, label,
                            grad_tol=LM_GRAD_L2, maxrel=LM_GRAD_MAXREL,
                            skip=LM_ZERO_GRADS)
    launches = _attention_launches(att)
    if any(n != n_layers * (steps + 1) for n in launches.values()):
        raise AssertionError(f"[{label}] launches {launches}, expected "
                             f"{n_layers} x {steps + 1} of each")
    return {"launches": launches, **cmp}


def train_gpt2(torch, dev) -> dict:
    """[14] The training path: the GPT-2-small-width LM trained by ``fit``
    with ``use_kernels=True``; launch counts over the fit alone; step-1
    gradients and per-step losses against the stock route; then a masked
    batch (the key-mask path of all three kernels through the graph's
    feature masks) and the bidirectional classifier (the non-causal path),
    each 2 steps against the stock route."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    n_layers, t = GEN_MODEL["n_layers"], GEN_MODEL["max_len"]
    t0 = time.monotonic()
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=GEN_SEED, **GEN_MODEL)
    net, ref = _route_pair(torch, dev, zoo)
    ds = lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH, t, LM_SEED)
    log(f"[14] causal LM {json.dumps(GEN_MODEL)}: {net.num_params():,} "
        f"params, updater {type(net.conf.updater).__name__}"
        f"({net.conf.updater.learning_rate}), batch {LM_BATCH} x {t} tokens "
        f"({time.monotonic() - t0:.1f} s to build)")
    trial = net.clone()  # the main path trains a copy of the same weights

    # ---- the main path: counts from here on belong to it ----
    _reset_attention_launches(att)
    collect = CollectScoresListener()
    trial.set_listeners(collect)
    t0 = time.monotonic()
    trial.fit(ListDataSetIterator([ds] * LM_TRAIN_STEPS))
    torch.cuda.synchronize()
    launches = _attention_launches(att)
    # ---- end of the main path ----
    losses = collect.scores
    log(f"[14] fit: {LM_TRAIN_STEPS} steps in {time.monotonic() - t0:.1f} "
        f"s, losses {[round(v, 4) for v in losses]}; launches "
        f"{json.dumps(launches)}")
    for name, n in launches.items():
        if n != n_layers * LM_TRAIN_STEPS:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{n_layers} per step = "
                                 f"{n_layers * LM_TRAIN_STEPS}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    del trial

    cmp = _compare_lm(torch, att, net, ref, ds, COMPARE_STEPS, "14",
                      n_layers)
    log(f"[14] kernel vs stock route: step-1 gradients global L2 "
        f"{cmp['grad']['global_l2']:.3e} (tol {LM_GRAD_L2}), losses "
        f"{cmp['loss_rel_err']} (tol {TRAIN_LOSS_RTOL})")

    mnet, mref = _route_pair(torch, dev, zoo)
    mds = lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH, t, LM_SEED + 1,
                     lengths=LM_MASK_LENGTHS)
    masked = _compare_lm(torch, att, mnet, mref, mds, 2, "14 masked",
                         n_layers)
    del mnet, mref, mds
    log(f"[14] masked batch (lengths {LM_MASK_LENGTHS} as features and "
        f"labels mask): step-1 gradients global L2 "
        f"{masked['grad']['global_l2']:.3e}, losses {masked['loss_rel_err']}"
        f"; launches {json.dumps(masked['launches'])}")

    czoo = TransformerEncoder(causal=False, use_kernels=True, seed=GEN_SEED,
                              **CLS_MODEL)
    cnet, cref = _route_pair(torch, dev, czoo)
    cds = lm_dataset(torch, dev, czoo.vocab_size, LM_BATCH,
                     CLS_MODEL["max_len"], LM_SEED + 2, lengths=CLS_LENGTHS,
                     classes=czoo.num_classes)
    cls = _compare_lm(torch, att, cnet, cref, cds, 2, "14 classifier",
                      CLS_MODEL["n_layers"])
    del cnet, cref, cds
    log(f"[14] bidirectional classifier {json.dumps(CLS_MODEL)}, masked "
        f"(lengths {CLS_LENGTHS}): step-1 gradients global L2 "
        f"{cls['grad']['global_l2']:.3e}, losses {cls['loss_rel_err']}; "
        f"launches {json.dumps(cls['launches'])}")
    torch.cuda.empty_cache()
    return {"net": net, "ref": ref, "ds": ds, "params": net.num_params(),
            "launches": launches, "losses": losses, "compare": cmp,
            "masked": masked, "classifier": cls}


def flash_bwd_bound_ms(b, h, t, d, products, operands):
    """(operations ms, bytes ms) of one causal backward kernel at
    [B, H, T, D] float32: ``products`` matrix products of 2·B·H·T²·D·½
    operations at the FFMA peak; ``operands`` [B, H, T, D] tensors read or
    written once, plus the [B, H, T] row vectors (l, m, di: 3)."""
    ops = products * 2.0 * b * h * t * t * d * 0.5
    nbytes = (operands * b * h * t * d + 3 * b * h * t) * 4
    return (ops / PEAK_OPS_PER_S["float32"] * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def time_flash_bwd(torch, F, att, dev) -> list:
    """[15] The dq and dk/dv kernels at the training path's shape ([8, 12,
    1024, 64] float32, causal, no mask), each alone, beside the plain
    backward, SDPA's backward (autograd through
    F.scaled_dot_product_attention against its saved forward; both rows
    at once) and the bound."""
    gen = torch.Generator(device=dev).manual_seed(78)
    b, h, t, d = LM_BATCH, GEN_MODEL["n_heads"], GEN_MODEL["max_len"], \
        GEN_HEAD_DIM
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device=dev)
                   for _ in range(4))
    sm = 1.0 / math.sqrt(d)
    o, l, m = att.flash_attention(q, k, v, None, True, return_stats=True)
    ops = att.bwd_operands(q, k, v, None, o, l, m, do)
    dq, di = att._flash_dq_cuda(*ops, True, sm)
    dk, dv = att._flash_dkv_cuda(*ops[:4], l, m, di, do, True, sm)
    ref = att.flash_attention_bwd_plain(q, k, v, None, o, l, m, do, True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    lib_o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    plain_ms = cuda_time_ms(
        lambda: att.flash_attention_bwd_plain(q, k, v, None, o, l, m, do,
                                              True))
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(lib_o, leaves, do, retain_graph=True))
    rows = []
    for name, ms, got, want, products, operands in (
            ("flash_attention_bwd_dq",
             cuda_time_ms(lambda: att._flash_dq_cuda(*ops, True, sm)),
             (dq,), ref[:1], 3, 6),
            ("flash_attention_bwd_dkv",
             cuda_time_ms(lambda: att._flash_dkv_cuda(*ops[:4], l, m, di, do,
                                                      True, sm)),
             (dk, dv), ref[1:], 4, 6)):
        ops_ms, bytes_ms = flash_bwd_bound_ms(b, h, t, d, products, operands)
        rows.append({
            "name": name, "b": b, "t": t, "ms": ms,
            "max_abs_err": max(float((g - w).abs().max())
                               for g, w in zip(got, want)),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    return rows


def flash_bwd_report(rows, launches, worst) -> list:
    out = []
    for r, line in zip(rows, ("deeplearning4j_tpu/ops/attention.py:420",
                              "deeplearning4j_tpu/ops/attention.py:450")):
        row = {
            "name": r["name"], "route": "cuda", "source": FLASH_BWD_SOURCE,
            "replaces": line, "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_tc_ms": r["bound_tc_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "scope": ("one launch (one layer's backward attention) at the "
                      "LM training step's shape, float32, 8 x 12 heads x "
                      "1024 x 64, causal; plain_ms and library_ms are the "
                      "whole backward (dq, dk and dv together: the plain "
                      "version, and torch.autograd.grad through "
                      "F.scaled_dot_product_attention)"),
            "checked": worst}
        row["max_err"], row["time_ms"] = row["max_abs_err"], row["ms"]
        out.append(row)
    return out


def lm_train_throughput(torch, trained, smi: str, pairs: int = 3,
                        steps: int = 2) -> dict:
    """The LM train step at 8 x 1024 tokens (host clock around
    ``fit_batch``, which returns the loss and so waits for the card),
    kernel route and stock route in alternating turns: ms per step and
    tokens/s."""
    net, ref, ds = trained["net"], trained["ref"], trained["ds"]
    tokens = LM_BATCH * GEN_MODEL["max_len"]
    times = {"kernel": [], "stock": []}
    for i in range(pairs):
        order = (("kernel", net), ("stock", ref))
        for side, model in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(steps):
                model.fit_batch(ds)
            times[side].append((time.monotonic() - t0) / steps * 1e3)
    out = {"model": dict(GEN_MODEL, params=trained["params"]),
           "batch": LM_BATCH, "tokens_per_step": tokens, "card": smi,
           "pairs": pairs, "steps_per_sample": steps,
           "launches": trained["launches"], "losses": trained["losses"]}
    for side, v in times.items():
        out[f"step_ms_{side}"] = statistics.median(v)
        out[f"tokens_per_s_{side}"] = tokens / statistics.median(v) * 1e3
    for key in ("compare", "masked", "classifier"):
        out[key] = {k: trained[key][k] for k in (
            "grad", "loss_rel_err", "launches", "losses_kernel",
            "losses_stock")}
    return out


# ---------------------------------------------------------------------------
# the int8 serving slice: matmul_bias_act_int8 and full-width AlexNet
# ---------------------------------------------------------------------------

def int8_bound_ms(m: int, k: int, n: int):
    """Least time for y = act(int32(xq @ wq) * scale + b) on an H100: xq,
    wq (int8), scale and b (f32) read once, y (f32) written once; 2*M*N*K
    operations at the dense int8 tensor-core peak. Returns (ops_ms,
    bytes_ms)."""
    nbytes = m * k + k * n + 2 * n * 4 + m * n * 4
    return (2.0 * m * n * k / PEAK_OPS_PER_S["int8"] * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def _int8_operands(torch, gen, dev, m, k, n):
    """Seeded int8 operands over -128..127 (row 0 of xq and column 0 of wq
    at -128: the largest sum, 128 * 128 * K) and float32 scale and bias."""
    xq = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    xq[0] = -128
    wq[:, 0] = -128
    scale = torch.empty(n, device=dev).uniform_(1e-4, 1e-2, generator=gen)
    b = torch.randn(n, generator=gen, device=dev)
    return xq, wq, scale, b


def _ulps(torch, got, ref) -> int:
    """The largest distance in float32 ulps between ``got`` and ``ref``
    (0 = bit-equal; +0 and -0 are equal)."""
    if torch.equal(got, ref):
        return 0
    g = got.contiguous().view(torch.int32).long()
    r = ref.contiguous().view(torch.int32).long()
    # map the sign-magnitude bit patterns onto one ordered integer line
    g = torch.where(g < 0, -(g & 0x7FFFFFFF), g)
    r = torch.where(r < 0, -(r & 0x7FFFFFFF), r)
    return int((g - r).abs().max())


def check_int8(torch, impls, Activation, dev, resnet_shapes) -> dict:
    """[16] matmul_bias_act_int8 vs its plain version: the two AlexNet
    sites at every serving bucket, the ResNet-50 1x1 shapes (the
    QuantizedConv1x1Layer path at large M) and two ragged shapes; the
    exact int32 sums (identity, scale 1, bias 0) bit for bit, identity
    and relu within INT8_MAX_ULP."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    shapes = ([(m, k, n) for (k, n) in INT8_SITES for m in INT8_BUCKETS]
              + sorted(set(resnet_shapes)) + list(INT8_RAGGED))
    worst = {"max_abs_err": 0.0, "max_ulps": 0, "shapes": len(shapes)}
    for (m, k, n) in shapes:
        xq, wq, scale, b = _int8_operands(torch, gen, dev, m, k, n)
        ones = torch.ones(n, device=dev)
        zeros = torch.zeros(n, device=dev)
        ident = Activation("identity")
        y = impls.matmul_bias_act_int8(xq, wq, ones, zeros, ident)
        ref = impls.matmul_bias_act_int8_plain(xq, wq, ones, zeros, ident)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(
                f"matmul_bias_act_int8 m={m} k={k} n={n}: the int32 sums "
                f"differ from the plain version's (max |err| "
                f"{float((y - ref).abs().max())})")
        if float(ref[0, 0]) != float(128 * 128 * k):
            raise AssertionError("the -128 row and column did not meet")
        for act_name in ("identity", "relu"):
            act = Activation(act_name)
            y = impls.matmul_bias_act_int8(xq, wq, scale, b, act)
            ref = impls.matmul_bias_act_int8_plain(xq, wq, scale, b, act)
            torch.cuda.synchronize()
            ulps = _ulps(torch, y, ref)
            err = float((y - ref).abs().max())
            worst["max_ulps"] = max(worst["max_ulps"], ulps)
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            if ulps > INT8_MAX_ULP or not torch.isfinite(y).all():
                raise AssertionError(
                    f"matmul_bias_act_int8 m={m} k={k} n={n} {act_name}: "
                    f"{ulps} ulps from the plain version (max {INT8_MAX_ULP})")
        log(f"[16] matmul_bias_act_int8 m={m} k={k} n={n}: int32 sums "
            f"bit-equal; identity and relu within {INT8_MAX_ULP} ulp")
        del xq, wq, scale, b, y, ref
    log(f"[16] {len(shapes)} shapes: max |kernel - plain| "
        f"{worst['max_abs_err']:.3e}, max {worst['max_ulps']} ulp "
        f"(tol {INT8_MAX_ULP} ulp)")
    return worst


def serve_alexnet_int8(torch, dev, seed: int = INT8_SEED) -> dict:
    """[17] The int8 serving path: full-width AlexNet (seeded float32
    weights, use_kernels) calibrated and quantized, then served by
    InferenceServer; every response held against the same artifact with
    use_kernels=False, matmul_bias_act_int8 launched twice per forward."""
    import urllib.request

    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.batcher import BatchingConfig
    from deeplearning4j_tpu_torch.parallel.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo.models import AlexNet

    t0 = time.monotonic()
    zoo = AlexNet()
    image = (zoo.height, zoo.width, zoo.channels)
    net = MultiLayerNetwork(dataclasses.replace(zoo.conf(), use_kernels=True),
                            dev).init()
    f32 = MultiLayerNetwork(dataclasses.replace(net.conf, use_kernels=False),
                            dev).set_params(net.params, net.state)
    log(f"[17] AlexNet {net.num_params():,} params on {dev} "
        f"({time.monotonic() - t0:.1f} s to build)")

    rng = np.random.default_rng(seed)
    cal = [rng.random((BATCH,) + image, np.float32)
           for _ in range(INT8_CAL_BATCHES)]
    t0 = time.monotonic()
    rec = iopt.calibrate(net, cal)
    q = iopt.quantize_for_inference(net, rec)
    t_quant = time.monotonic() - t0
    rec2 = iopt.calibrate(net, cal)
    q2 = iopt.quantize_for_inference(net, rec2)
    if rec2.digest != rec.digest or rec2.ranges != rec.ranges:
        raise AssertionError("calibrating twice on the same batches gave "
                             f"{rec.digest[:12]} and {rec2.digest[:12]}")
    for key, vp in q.params.items():
        for name, v in vp.items():
            if not torch.equal(v, q2.params[key][name]):
                raise AssertionError(f"quantized params differ between two "
                                     f"calibrations: layer {key} {name}")
    del q2
    names = [type(layer).__name__ for layer in q.conf.layers]
    if names[11:] != ["QuantizedDenseLayer", "QuantizedDenseLayer",
                      "OutputLayer"] or "Quantized" in "".join(names[:11]):
        raise AssertionError(f"unexpected quantized layers: {names}")
    log(f"[17] calibrate ({INT8_CAL_BATCHES} batches of {BATCH}) + "
        f"quantize_for_inference in {t_quant:.1f} s; digest "
        f"{rec.digest[:16]} twice, params bit-identical; layers 11, 12 -> "
        f"QuantizedDenseLayer (Wq {tuple(q.params['11']['Wq'].shape)}, "
        f"{tuple(q.params['12']['Wq'].shape)} int8)")
    ref = MultiLayerNetwork(dataclasses.replace(q.conf, use_kernels=False),
                            dev).set_params(q.params, q.state)

    sizes = (1, 2, 3, 4, 2, 1, 4, 3)
    inputs = []
    for i, size in enumerate(sizes):
        if i == 3:  # one client sends raw pixels
            inputs.append(rng.integers(0, 256, (size,) + image, np.uint8))
        else:
            inputs.append(rng.random((size,) + image, np.float32))
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def http(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=600) as resp:
            return resp.status, resp.read()

    # ---- the int8 serving path: counts from here on belong to it ----
    impls.matmul_bias_act_int8.launches = 0
    impls.matmul_bias_act.launches = 0
    telemetry.reset()
    server = InferenceServer(q, batching=BatchingConfig(
        max_batch=BATCH, max_delay_ms=50.0, settle_ms=5.0))
    try:
        t0 = time.monotonic()
        warm = server.warmup()
        server.start(port=0, host="127.0.0.1")
        log(f"[17] warmup: {warm['forwards']} forwards over buckets "
            f"{warm['buckets']} in {time.monotonic() - t0:.1f} s; serving "
            f"on 127.0.0.1:{server.port}")
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
        log(f"[17] {len(inputs)} concurrent /predict requests "
            f"({sum(sizes)} images, one uint8) answered in "
            f"{time.monotonic() - t0:.1f} s")
        code, raw = http("/model")
        info = json.loads(raw)
        if (code != 200 or info.get("type") != "MultiLayerNetwork"
                or info.get("num_params") != q.num_params()):
            raise AssertionError(f"/model: {code} {info}")
        code, raw = http("/healthz")
        health = json.loads(raw)
        if code != 200 or health.get("status") != "ok":
            raise AssertionError(f"/healthz: {code} {health}")
        code, raw = http("/metrics")
        if code != 200 or "dl4j_serving_batches_total" not in raw.decode():
            raise AssertionError(f"/metrics: {code}")
        batches = int(telemetry.REGISTRY.counter(
            "dl4j_serving_batches_total").value)
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {"matmul_bias_act_int8": impls.matmul_bias_act_int8.launches,
                "matmul_bias_act": impls.matmul_bias_act.launches}
    # ---- end of the int8 serving path ----
    forwards = warm["forwards"] + batches
    log(f"[17] launches on the int8 serving path: {launches} over "
        f"{forwards} forwards ({warm['forwards']} warmup + {batches} served "
        "batches)")
    if launches["matmul_bias_act_int8"] != 2 * forwards:
        raise AssertionError(
            f"matmul_bias_act_int8 launched "
            f"{launches['matmul_bias_act_int8']} times, expected 2 per "
            f"forward = {2 * forwards}")

    worst, route_ulps = 0.0, 0
    for i, x in enumerate(inputs):
        code, body = results[i]
        got = np.asarray(body["outputs"][0], np.float32)
        want = ref.output(x)
        if code != 200 or got.shape != (sizes[i], zoo.num_classes) \
                or not np.isfinite(got).all():
            raise AssertionError(f"request {i}: {code} shape {got.shape}")
        atol, rtol = INT8_SERVED_TOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"request {i}")
        worst = max(worst, float(np.abs(got - want).max()))
        # the kernel route and the stock route on the same batch
        route_ulps = max(route_ulps, _ulps(torch, torch.from_numpy(
            q.output(x)), torch.from_numpy(want)))
    if route_ulps > INT8_MAX_ULP:
        raise AssertionError(f"the kernel route's output is {route_ulps} "
                             f"ulps from the stock route's on one batch")
    x = np.concatenate([a for a in inputs if a.dtype == np.float32])
    y8, y32 = ref.output(x), f32.output(x)
    dev_f32 = float(np.abs(y8 - y32).max())
    top1 = float((y8.argmax(-1) == y32.argmax(-1)).mean())
    log(f"[17] served outputs vs use_kernels=False on the same artifact: max "
        f"|diff| {worst:.3e} (tol atol={INT8_SERVED_TOL[0]} "
        f"rtol={INT8_SERVED_TOL[1]}); kernel vs stock route on one batch: "
        f"{route_ulps} ulp (tol {INT8_MAX_ULP}); int8 vs f32 AlexNet (not "
        f"gated: random weights give a near-uniform softmax): max |diff| "
        f"{dev_f32:.3e}, top-1 agreement {top1:.3f} on {len(x)} images")
    return {"q": q, "ref": ref, "f32": f32, "launches": launches,
            "served_max_abs_err": worst, "route_max_ulps": route_ulps,
            "int8_vs_f32_max_abs": dev_f32, "int8_vs_f32_top1": top1,
            "digest": rec.digest}


def _int_mm_takes(torch, xq, wq) -> bool:
    """Whether ``torch._int_mm`` takes these operands (it refuses M <= 16)."""
    try:
        torch._int_mm(xq, wq)
    except RuntimeError:
        return False
    return True


def time_int8(torch, impls, Activation, dev) -> list:
    """[18] matmul_bias_act_int8 at the two AlexNet sites for every serving
    bucket, beside its plain version, torch._int_mm (the int32 product
    alone) and the bound. Each launch reads the next of several copies of
    wq (more than 150 MB in all), so the weights come from device memory
    as they do in a forward, not from the 50 MB L2. ``ms`` is the CUDA-event
    time per call (the wrapper's host work included where the card waits
    for it), ``device_ms`` the profiler's device time of the kernel's
    launches alone."""
    gen = torch.Generator(device=dev).manual_seed(77)
    act = Activation("relu")  # AlexNet's dense layers
    rows = []
    for (k, n) in INT8_SITES:
        copies = max(2, -(-150 * 2 ** 20 // (k * n)))
        xq, wq, scale, b = _int8_operands(torch, gen, dev, BATCH, k, n)
        wqs = [wq] + [torch.randint(-128, 128, (k, n), generator=gen,
                                    device=dev, dtype=torch.int8)
                      for _ in range(copies - 1)]
        for m in INT8_BUCKETS:
            x = xq[:m].contiguous()
            turn = itertools.count()
            err = float((impls.matmul_bias_act_int8(x, wq, scale, b, act)
                         - impls.matmul_bias_act_int8_plain(
                             x, wq, scale, b, act)).abs().max())
            lib_ms = None
            if _int_mm_takes(torch, x, wq):
                lib_ms = cuda_time_ms(
                    lambda: torch._int_mm(x, wqs[next(turn) % copies]))
            ops_ms, bytes_ms = int8_bound_ms(m, k, n)
            rows.append({
                "m": m, "k": k, "n": n, "max_abs_err": err,
                "ms": cuda_time_ms(lambda: impls.matmul_bias_act_int8(
                    x, wqs[next(turn) % copies], scale, b, act)),
                "device_ms": device_ms(
                    lambda: impls.matmul_bias_act_int8(
                        x, wqs[next(turn) % copies], scale, b, act),
                    INT8_KERNEL_NAMES),
                "plain_ms": cuda_time_ms(
                    lambda: impls.matmul_bias_act_int8_plain(
                        x, wqs[next(turn) % copies], scale, b, act)),
                "library_ms": lib_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            })
            rows[-1]["host_ms"] = host_ms(rows[-1])
        del xq, wq, wqs, scale, b
    return rows


def host_ms(row):
    """The wrapper's host work per call that the card waits for: the
    CUDA-event time less the kernel's device time (None without it)."""
    if row["device_ms"] is None:
        return None
    return row["ms"] - row["device_ms"]


def int8_report(rows, launches, worst) -> dict:
    """The kernels-line entry: one served forward at batch 32, the two
    sites summed."""
    main = [r for r in rows if r["m"] == BATCH]
    ops_ms = sum(int8_bound_ms(r["m"], r["k"], r["n"])[0] for r in main)
    bytes_ms = sum(int8_bound_ms(r["m"], r["k"], r["n"])[1] for r in main)
    lib = [r["library_ms"] for r in main]
    row = {
        "name": "matmul_bias_act_int8", "route": "cuda",
        "source": INT8_SOURCE,
        "replaces": "deeplearning4j_tpu/kernels/impls.py:248",
        "launches": launches["matmul_bias_act_int8"],
        "max_abs_err": worst["max_abs_err"],
        "ms": sum(r["ms"] for r in main),
        "device_ms": (None if any(r["device_ms"] is None for r in main)
                      else sum(r["device_ms"] for r in main)),
        "host_ms": (None if any(r["host_ms"] is None for r in main)
                    else sum(r["host_ms"] for r in main)),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "scope": (f"one AlexNet forward at batch {BATCH}: the two quantized "
                  "dense layers (32 x 6400 x 4096 and 32 x 4096 x 4096, "
                  "relu), weights read from device memory; library = "
                  "torch._int_mm, the int32 product alone"),
        "checked": worst,
        "shapes": rows,
    }
    row["max_err"], row["time_ms"] = row["max_abs_err"], row["ms"]
    return row


def int8_served_throughput(torch, served, smi: str, reps: int = 20) -> dict:
    """Batch 32 for the int8 kernel route, the int8 stock route and the
    float32 AlexNet, in turns (kernel, stock, f32, f32, stock, kernel):
    images/s through the batching engine (numpy in and out, the 19 MB
    host-to-device copy included), the forward alone on a batch already on
    the card (CUDA events), and each route's forward by kernel (device
    time, ``torch.profiler``)."""
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
    )

    routes = {"int8_kernel": served["q"], "int8_stock": served["ref"],
              "f32": served["f32"]}
    t = served["f32"].conf.input_type
    x = np.random.default_rng(7).random(
        (BATCH, t.height, t.width, t.channels), np.float32)
    order = ("int8_kernel", "int8_stock", "f32", "f32", "int8_stock",
             "int8_kernel")
    out = {"batch": BATCH, "card": smi}
    forward = {name: [] for name in routes}
    with torch.inference_mode():
        x_dev = routes["f32"]._prepare(x)
        for name in order:
            model = routes[name]
            forward[name].append(cuda_time_ms(
                lambda: model._forward(model._fwd_params(), x_dev), samples=3))
        for name, model in routes.items():
            out[f"profile_{name}"] = device_breakdown(
                lambda: model._forward(model._fwd_params(), x_dev))
    engines = {name: InferenceEngine(model, BatchingConfig(max_batch=BATCH))
               for name, model in routes.items()}
    rates = {name: [] for name in routes}
    try:
        for engine in engines.values():
            engine.predict(x)
        for name in order:
            t0 = time.monotonic()
            for _ in range(reps):
                engines[name].predict(x)
            rates[name].append(reps * BATCH / (time.monotonic() - t0))
    finally:
        for engine in engines.values():
            engine.close()
    for name in routes:
        out[f"forward_ms_{name}"] = statistics.mean(forward[name])
        out[f"forward_ms_{name}_turns"] = forward[name]
        out[f"images_per_s_{name}"] = statistics.mean(rates[name])
        out[f"images_per_s_{name}_turns"] = rates[name]
    return out


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
        from deeplearning4j_tpu_torch.nn.graph import serve_full_f32
        from deeplearning4j_tpu_torch.ops import attention as att
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
    ptxas = {name: ptxas_report(build.build_log(name))
             for name in impls.SOURCES}
    for name in impls.SOURCES:
        for fn, regs, stores, loads in ptxas[name]:
            log(f"[2] ptxas {name} {fn}: {regs} registers, {stores} bytes "
                f"spill stores, {loads} bytes spill loads")
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
        "bound_tc_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_time_ms(lambda: torch.add(x, 1.0)),
    }
    probe_row["max_err"], probe_row["time_ms"] = (probe_row["max_abs_err"],
                                                probe_row["ms"])
    for r in rows:
        log(f"[5] m={r['m']} k={r['k']} n={r['n']} x{r['count']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, F.linear "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, FFMA), {r['bound_tc_ms']:.4f} ms (3xTF32)")
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
            f"stock composite {r['composite_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, FFMA), "
            f"{r['bound_tc_ms']:.4f} ms (3xTF32)")
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
        f"bound {mm['bound_ms']:.3f} ms ({mm['bound_by']}, FFMA), "
        f"{mm['bound_tc_ms']:.3f} ms (3xTF32); ptxas "
        f"{json.dumps(ptxas_rows(ptxas, impls.SOURCE, 'mm_bias_act'))} "
        f"[{smi}]")
    log(f"[8] per training step: matmul_stats {st['ms']:.3f} ms, plain "
        f"{st['plain_ms']:.3f} ms, F.linear {st['library_ms']:.3f} ms, "
        f"stock composite {st['composite_ms']:.3f} ms, kernel device time "
        f"{st['device_ms']} ms, bound "
        f"{st['bound_ms']:.3f} ms ({st['bound_by']}, FFMA), "
        f"{st['bound_tc_ms']:.3f} ms (3xTF32); ptxas "
        f"{json.dumps(ptxas_rows(ptxas, 'matmul_stats', 'tc_stats'))}; "
        f"train step "
        f"{train_line['step_ms_kernel']:.2f} ms kernel route, "
        f"{train_line['step_ms_stock']:.2f} ms stock [{smi}]")
    del trained, unfused
    torch.cuda.empty_cache()

    # 9. flash attention against its plain version
    serve_full_f32()
    flash_worst = check_flash(torch, att, dev)

    # 10. paged decode attention against its plain version
    decode_worst = check_decode(torch, att, dev)

    # 11. the generation path
    gen = serve_gpt2(torch, dev)

    # 12. generation timings
    n_layers = GEN_MODEL["n_layers"]
    flash_rows, decode_rows = time_attention(torch, F, att, dev,
                                             gen["stats"], n_layers)
    for r in flash_rows:
        log(f"[12] flash_attention B={r['b']} T={r['t']} x{r['count']}: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, FFMA), {r['bound_tc_ms']:.4f} ms (3xTF32)")
    for r in decode_rows:
        log(f"[12] paged_decode_attention S={r['s']} x{r['count']}: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']} ms), plain "
            f"{r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    report["kernels"] += [
        attention_report(
            flash_rows, gen["launches"], flash_worst, "flash_attention",
            FLASH_SOURCE, "deeplearning4j_tpu/ops/attention.py:363",
            "one launch (one layer's prefill attention), float32, B x 12 "
            "heads x T x 64, causal with the prompt-length mask, averaged "
            "over the engine run's launches by (join bucket B, prompt "
            "bucket T); library = F.scaled_dot_product_attention with the "
            "boolean causal + key mask"),
        attention_report(
            decode_rows, gen["launches"], decode_worst,
            "paged_decode_attention", DECODE_SOURCE,
            "deeplearning4j_tpu/ops/attention.py:119",
            "one launch (one layer's decode step), float32, 8 rows x 12 "
            "heads x 64 against [8, S, 12, 64] caches, seeded positions in "
            "[S/2, S), averaged over the engine run's launches by KV bucket "
            "S; library = F.scaled_dot_product_attention with a boolean "
            "live-slot mask"),
    ]
    gen_line = generation_throughput(torch, gen, smi)
    fl, pd = report["kernels"][3], report["kernels"][4]
    log(f"[12] per launch: flash_attention {fl['ms']:.4f} ms (plain "
        f"{fl['plain_ms']:.4f}, SDPA {fl['library_ms']:.4f}, bound "
        f"{fl['bound_ms']:.4f} {fl['bound_by']}); paged_decode_attention "
        f"{pd['ms']:.4f} ms (device {pd.get('device_ms')}, plain "
        f"{pd['plain_ms']:.4f}, SDPA "
        f"{pd['library_ms']:.4f}, bound {pd['bound_ms']:.4f} "
        f"{pd['bound_by']}) [{smi}]")
    log(f"[12] engine, {gen_line['requests']} requests x "
        f"{gen_line['max_new_tokens']} tokens: kernel route "
        f"{gen_line['tokens_per_s_kernel']:.1f} tokens/s (TTFT p50 "
        f"{gen_line['ttft_ms_p50_kernel']:.1f} ms), stock "
        f"{gen_line['tokens_per_s_stock']:.1f} tokens/s (TTFT p50 "
        f"{gen_line['ttft_ms_p50_stock']:.1f} ms) [{smi}]")
    del gen
    torch.cuda.empty_cache()

    # 13. the flash backward kernels against their plain version
    bwd_worst = check_flash_bwd(torch, att, dev)

    # 14. the transformer's training path
    trained_lm = train_gpt2(torch, dev)

    # 15. training timings of the transformer
    bwd_rows = time_flash_bwd(torch, F, att, dev)
    report["kernels"] += flash_bwd_report(bwd_rows, trained_lm["launches"],
                                          bwd_worst)
    lm_line = lm_train_throughput(torch, trained_lm, smi)
    del trained_lm
    for r in bwd_rows:
        log(f"[15] {r['name']} B={r['b']} T={r['t']}: kernel {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, FFMA), "
            f"{r['bound_tc_ms']:.4f} ms (3xTF32 tensor cores); whole "
            f"backward: plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms [{smi}]")
    log(f"[15] LM train step at {LM_BATCH} x {GEN_MODEL['max_len']} tokens: "
        f"kernel route {lm_line['step_ms_kernel']:.1f} ms "
        f"({lm_line['tokens_per_s_kernel']:.0f} tokens/s), stock "
        f"{lm_line['step_ms_stock']:.1f} ms "
        f"({lm_line['tokens_per_s_stock']:.0f} tokens/s) [{smi}]")
    torch.cuda.empty_cache()

    # 16. the int8 kernel against its plain version
    int8_worst = check_int8(torch, impls, Activation, dev, shapes)

    # 17. the int8 serving path
    served8 = serve_alexnet_int8(torch, dev)

    # 18. int8 timings
    int8_rows = time_int8(torch, impls, Activation, dev)
    for r in int8_rows:
        lib = ("refused" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"[18] matmul_bias_act_int8 m={r['m']} k={r['k']} n={r['n']}: "
            f"kernel {r['ms']:.4f} ms (device {r['device_ms']} ms, host work "
            f"{r['host_ms']} ms), plain {r['plain_ms']:.4f} ms, "
            f"torch._int_mm {lib}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    q8 = int8_report(int8_rows, served8["launches"], int8_worst)
    report["kernels"].append(q8)
    int8_line = int8_served_throughput(torch, served8, smi)
    for key in ("served_max_abs_err", "route_max_ulps", "int8_vs_f32_max_abs",
                "int8_vs_f32_top1", "digest", "launches"):
        int8_line[key] = served8[key]
    del served8
    log(f"[18] per forward at batch {BATCH}: matmul_bias_act_int8 "
        f"{q8['ms']:.4f} ms (2 sites; device time {q8['device_ms']} ms, "
        f"host work {q8['host_ms']} ms), plain {q8['plain_ms']:.4f} ms, "
        f"torch._int_mm {q8['library_ms']} ms, bound {q8['bound_ms']:.4f} ms "
        f"({q8['bound_by']}) [{smi}]")
    log(f"[18] AlexNet served at batch {BATCH}: int8 kernel route "
        f"{int8_line['images_per_s_int8_kernel']:.1f} images/s, int8 stock "
        f"{int8_line['images_per_s_int8_stock']:.1f}, f32 "
        f"{int8_line['images_per_s_f32']:.1f}; forward on the card "
        f"{int8_line['forward_ms_int8_kernel']:.3f} / "
        f"{int8_line['forward_ms_int8_stock']:.3f} / "
        f"{int8_line['forward_ms_f32']:.3f} ms [{smi}]")
    for name in ("int8_kernel", "int8_stock", "f32"):
        prof = int8_line[f"profile_{name}"]
        log(f"[18] {name} forward, device time {prof['device_ms']:.3f} ms: "
            + "; ".join(f"{k} {v:.3f}" for k, v in prof["top"]))
    for row in report["kernels"]:
        source, prefixes = PTXAS_OF[row["name"]]
        row["ptxas"] = [r for prefix in prefixes
                        for r in ptxas_rows(ptxas, source, prefix)]
    # row 4's registers and spills by kernel variant, as the others' ptxas
    q8["registers"] = {r["kernel"]: r["registers"] for r in q8["ptxas"]}
    q8["spills"] = {r["kernel"]: r["spill_stores"] + r["spill_loads"]
                    for r in q8["ptxas"]}
    log(json.dumps(report))
    log(json.dumps({"served": served_line}))
    log(json.dumps({"trained": train_line}))
    log(json.dumps({"generated": gen_line}))
    log(json.dumps({"trained_lm": lm_line}))
    log(json.dumps({"served_int8": int8_line}))
    log(f"[18] total {time.monotonic() - t_start:.1f} s")
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
